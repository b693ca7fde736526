"""Batched multi-radius (R, c)-NN query processing (paper Secs. 2.3, 5.4).

For each radius R in (1, c, c^2, ...):
  1. hash the query into L buckets (Step 1 of Fig. 10 = hash-table read);
  2. walk each non-empty bucket's block chain, ``block_objs`` entries per
     read (Step 2 = bucket block reads), fingerprint-filtering object infos,
     until S candidates are collected;
  3. distance-check the candidates against the DRAM-resident database
     (Step 3), merge them into the running top-k (dedup by id), and mark the
     query done when k results lie within c*R.

One entry point over the plans of one single-device index:

    engine = SearchEngine(index)   # index: E2LSHoS, E2LSHIndex or ExternalIndex
    res = engine.query(qs, plan="fused")

* ``plan="fused"`` — the production plan. A hash stage hashes the batch for
  the whole radius schedule in one ``lsh_hash`` launch and looks up every
  bucket's size and chain head in two gathers; a probe stage then runs the
  radius loop: per radius one ``bucket_probe`` launch reads every chain
  block row, an S-budget scan and a compact append build the candidate
  buffer, and one ``l2_distance_gathered`` launch computes its distances.
  The loop leaves early when every query is done, which costs one
  ``done.all()`` device->host sync per radius (at most r): PyTorch runs
  eagerly, and without the sync every batch would pay for all r radii.
* ``plan="oracle"`` — the reference: every radius run with done-masking,
  per-radius plain hashing and a dense gather over the CSR view. Simple,
  obviously correct, and the parity target of the fused plan.
* ``plan="host"`` — the oracle's radius step, one call and one host sync per
  radius for the early exit: the pre-fusion host-driven loop, kept as a
  baseline of dispatch overhead. Same results as the oracle.

Over an ``ExternalIndex`` (``repro_torch.storage.load_external``: block rows
on disk, hash tables resident on the device):

* ``plan="external"`` — hashing and table lookups on the device, the chain
  walk on the host through the block store, the distance fold back on the
  device with the next rung's reads prefetched under it
  (``repro_torch.storage.external``). Equal to ``plan="fused"`` on a spilled
  copy of the same index, bit for bit;
* ``plan="sharded_external"`` — the same plan over block rows striped across
  per-shard files (``repro_torch.storage.sharded``).

Masked rows (``valid=False``, a serving queue's padding) are inert: they
start done, probe nothing, count zero I/O and report ``found=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .index import IndexArrays
from .probabilities import LSHParams
from ..kernels.bucket_probe.ops import INVALID, bucket_probe
from ..kernels.dispatch import resolve_device
from ..kernels.l2_distance.ops import l2_distance_gathered
from ..kernels.l2_distance.ref import l2_distance_gathered_ref
from ..kernels.lsh_hash.ops import lsh_hash_all_radii
from ..kernels.lsh_hash.ref import lsh_hash_ref

__all__ = ["QueryConfig", "QueryResult", "SearchEngine", "fused_plan_body",
           "host_plan_body", "oracle_plan_body", "hash_stage", "table_lookup",
           "probe_stage"]


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    """Static query-plan parameters."""

    L: int
    m: int
    u: int
    fp_bits: int
    w: float
    c: float
    radii: tuple          # full schedule
    S: int                # candidate cap per radius
    block_objs: int       # entries per storage block read
    k: int = 1
    max_chain: int = 4    # chain-walk steps per radius
    sbuf: int = 0         # oracle candidate buffer width (0 -> derived)
    collect_probe_sizes: bool = False  # record probed bucket sizes (Fig. 3)

    def __post_init__(self):
        if self.sbuf == 0:
            object.__setattr__(self, "sbuf", max(128, -(-self.S // 128) * 128))

    def replace(self, *, s_cap: Optional[int] = None,
                block_objs: Optional[int] = None, **changes) -> "QueryConfig":
        """Derived plans: ``s_cap`` re-derives the candidate buffer width,
        ``block_objs`` the chain depth (so narrower chunks still cover S)."""
        if s_cap is not None:
            changes.update(S=int(s_cap), sbuf=0)
        if block_objs is not None and block_objs != self.block_objs:
            S = int(changes.get("S", self.S))
            changes.update(block_objs=int(block_objs),
                           max_chain=max(1, -(-S // int(block_objs)) + 1))
        return dataclasses.replace(self, **changes)

    @staticmethod
    def from_params(p: LSHParams, *, k: int = 1, max_chain: int = 0,
                    collect_probe_sizes: bool = False) -> "QueryConfig":
        if max_chain <= 0:
            # enough steps to reach S candidates even through partial blocks
            max_chain = max(1, min(8, -(-p.S // p.block_objs) + 1))
        return QueryConfig(
            L=p.L, m=p.m, u=p.u, fp_bits=p.fp_bits, w=p.w, c=p.c,
            radii=tuple(p.radii), S=p.S, block_objs=p.block_objs, k=k,
            max_chain=max_chain, collect_probe_sizes=collect_probe_sizes)


@dataclasses.dataclass
class QueryResult:
    ids: torch.Tensor             # [Q, k] int32 (INVALID if unfound)
    dists: torch.Tensor           # [Q, k] float32 (Euclidean, inf if unfound)
    found: torch.Tensor           # [Q] bool: (R, c)-NN succeeded at some radius
    radii_searched: torch.Tensor  # [Q] int32
    nio_table: torch.Tensor       # [Q] int32 hash-table reads (non-empty buckets)
    nio_blocks: torch.Tensor      # [Q] int32 bucket-block reads
    cands_checked: torch.Tensor   # [Q] int32 distance computations
    probe_sizes: Optional[torch.Tensor] = None  # [Q, r, L] int32 (-1 unprobed)

    @property
    def nio(self) -> torch.Tensor:
        """Total I/O count per query, N_io (paper Sec. 4.3)."""
        return self.nio_table + self.nio_blocks

    def slice_rows(self, lo: int, hi: int) -> "QueryResult":
        """Rows [lo, hi) as a standalone result (masked rows are inert, so a
        slice of a padded batch is the per-request result)."""
        return QueryResult(**{
            f.name: None if getattr(self, f.name) is None else getattr(self, f.name)[lo:hi]
            for f in dataclasses.fields(QueryResult)})

    def rows_agree(self, other: "QueryResult", *, tol: float = 2e-4) -> np.ndarray:
        """Per-row parity with another plan's result, a bool [Q] on the host:
        integer fields exact, dists allclose at ``tol``. Two ids that differ
        at a position still agree when their distances agree within ``tol``
        (a tie ranked the other way)."""
        ok = np.ones(self.ids.shape[0], bool)
        for name in ("found", "radii_searched", "nio_table", "nio_blocks", "cands_checked"):
            ok &= getattr(self, name).cpu().numpy() == getattr(other, name).cpu().numpy()
        da, db = self.dists.cpu().numpy(), other.dists.cpu().numpy()
        close = np.isclose(da, db, rtol=tol, atol=tol) | (np.isinf(da) & np.isinf(db))
        same_id = self.ids.cpu().numpy() == other.ids.cpu().numpy()
        return ok & close.all(axis=1) & (same_id | close).all(axis=1)

    @staticmethod
    def concat_rows(parts: "list[QueryResult]") -> "QueryResult":
        """Stitch row slices back into one result, on the host."""
        if len(parts) == 1:
            return parts[0]

        def cat(vs):
            if any(v is None for v in vs):
                return None
            return torch.cat([v.cpu() for v in vs], dim=0)

        return QueryResult(**{f.name: cat([getattr(p, f.name) for p in parts])
                              for f in dataclasses.fields(QueryResult)})


def _append_candidates(buf_id, count, flat_id, flat_ok, S: int):
    """Compact-append fingerprint matches into the candidate buffer
    (truncated at S). Entries that do not fit go to one extra dump column
    that is sliced off: the scatter counterpart of the reference's
    ``mode="drop"``."""
    Q, sbuf = buf_id.shape
    ok = flat_ok.to(torch.int32)
    pos = count[:, None] + torch.cumsum(ok, dim=1, dtype=torch.int32) - ok
    keep = flat_ok & (pos < S)
    pos_w = torch.where(keep, pos, sbuf).to(torch.int64)
    wide = torch.cat([buf_id, buf_id.new_full((Q, 1), INVALID)], dim=1)
    wide.scatter_(1, pos_w, flat_id)
    count = torch.clamp(count + ok.sum(dim=1, dtype=torch.int32), max=S)
    return wide[:, :sbuf], count


def _gather_distances(ix: IndexArrays, queries, qnorm2, buf_id, distance_fn):
    """Step 3: distances of the candidate buffer against the DRAM tier,
    masked to inf on empty slots and clamped at 0."""
    valid = buf_id != INVALID
    safe_id = torch.where(valid, buf_id, 0).to(torch.int64)
    coords = ix.db[safe_id]                                   # [Q, SBUF, d]
    xn2 = ix.db_norm2[safe_id]
    d2 = distance_fn(queries, coords, xn2, qnorm2)
    return torch.where(valid, torch.clamp(d2, min=0.0), torch.inf)


def _probe_radius(ix: IndexArrays, queries, qnorm2, t: int, radius: float,
                  cfg: QueryConfig, active_q):
    """One (R, c)-NN probe for every query in the batch (ORACLE plan), over
    the CSR view. Returns (cand_id [Q, SBUF], cand_d2 [Q, SBUF], stats)."""
    Q = queries.shape[0]
    L, BLK, S, SBUF = cfg.L, cfg.block_objs, cfg.S, cfg.sbuf
    dev = queries.device
    bucket, qfp = lsh_hash_ref(queries, ix.a[t], ix.b[t], ix.rm[t],
                               w_r=cfg.w * radius, u=cfg.u, fp_bits=cfg.fp_bits)
    flat = (torch.arange(L, device=dev, dtype=torch.int64)[None, :] << cfg.u) + bucket
    off = ix.table_off[t].reshape(-1)[flat]                   # [Q, L]
    cnt = ix.table_cnt[t].reshape(-1)[flat]
    nonempty = (cnt > 0) & active_q[:, None]

    buf_id = torch.full((Q, SBUF), INVALID, dtype=torch.int32, device=dev)
    count = torch.zeros((Q,), dtype=torch.int32, device=dev)
    blocks_read = torch.zeros((Q,), dtype=torch.int32, device=dev)
    slots = torch.arange(BLK, device=dev, dtype=torch.int32)
    for step in range(cfg.max_chain):
        # a chunk is read iff the bucket still has entries at this depth and
        # the query's S budget is not exhausted (paper: stop mid-bucket at S)
        active = nonempty & (cnt > step * BLK) & (count < S)[:, None]
        blocks_read = blocks_read + active.sum(dim=1, dtype=torch.int32)
        idx = (off + step * BLK)[:, :, None] + slots[None, None, :]
        ok_read = active[:, :, None] & ((step * BLK + slots)[None, None, :] < cnt[:, :, None])
        idx_safe = torch.where(ok_read, idx, 0).to(torch.int64)
        eid = ix.entries_id[idx_safe]
        ok = ok_read & (ix.entries_fp[idx_safe] == qfp[:, :, None])
        buf_id, count = _append_candidates(
            buf_id, count, eid.reshape(Q, L * BLK), ok.reshape(Q, L * BLK), S)

    d2 = _gather_distances(ix, queries, qnorm2, buf_id, l2_distance_gathered_ref)
    stats = dict(nio_table=nonempty.sum(dim=1, dtype=torch.int32),
                 nio_blocks=blocks_read, cands=count)
    if cfg.collect_probe_sizes:
        stats["probe_sizes"] = torch.where(nonempty, cnt, -1)
    return buf_id, d2, stats


def _fused_sbuf(cfg: QueryConfig) -> int:
    """Candidate-buffer width of the fused probe: S rounded up to 8. Slots
    past S never hold a candidate, so results are the same for any width
    >= S; the reference's 128-lane padding is TPU layout only."""
    return max(8, -(-cfg.S // 8) * 8)


def _probe_radius_fused(ix: IndexArrays, queries, qnorm2, cnt, head, qfp,
                        cfg: QueryConfig, active_q):
    """One (R, c)-NN probe on the block store (FUSED plan).

    ``cnt``/``head``/``qfp`` [Q, L] come from the hash stage. Step 2 reads
    every chain step's block rows through ONE bucket_probe launch, then folds
    the oracle's sequential ``count < S`` read gate back in with a scan over
    chain depth. Candidates, their order and the I/O counts equal
    ``_probe_radius``'s: the block rows hold the CSR chunks' entries,
    flattened in the oracle's (step, l, slot) order.
    """
    Q = queries.shape[0]
    L, BLK, S, C = cfg.L, cfg.block_objs, cfg.S, cfg.max_chain
    BLKp = ix.ids_blocks.shape[1]
    dev = queries.device
    nonempty = (cnt > 0) & active_q[:, None]

    # chunk c of bucket (q, l) is row head + c; chunks past the chain end and
    # masked queries read the empty spare row 0
    steps = torch.arange(C, device=dev, dtype=torch.int32)
    readable = nonempty[:, None, :] & (cnt[:, None, :] > steps[None, :, None] * BLK)
    rows = torch.where(readable, head[:, None, :] + steps[None, :, None], 0)
    qfp_rep = qfp.to(torch.int32)[:, None, :].expand(Q, C, L)
    filt = bucket_probe(rows.reshape(-1).to(torch.int32).contiguous(),
                        qfp_rep.reshape(-1).contiguous(),
                        ix.ids_blocks, ix.fps_blocks)         # [Q*C*L, BLKp]
    match = filt.view(Q, C, L * BLKp)
    hit = match != INVALID

    # replay the oracle's per-step S-budget gate: chunks at depth c are read
    # iff the count entering step c is below S (count only grows)
    m_all = hit.sum(dim=2, dtype=torch.int32)                 # [Q, C]
    count = torch.zeros((Q,), dtype=torch.int32, device=dev)
    gates = []
    for c in range(C):
        gate = count < S
        gates.append(gate)
        count = torch.clamp(count + torch.where(gate, m_all[:, c], 0), max=S)
    step_active = torch.stack(gates, dim=1)                   # [Q, C]
    blocks_read = (readable & step_active[:, :, None]).sum(dim=(1, 2), dtype=torch.int32)

    buf_id = torch.full((Q, _fused_sbuf(cfg)), INVALID, dtype=torch.int32, device=dev)
    flat_ok = hit & step_active[:, :, None]
    buf_id, count = _append_candidates(
        buf_id, torch.zeros((Q,), dtype=torch.int32, device=dev),
        match.reshape(Q, C * L * BLKp), flat_ok.reshape(Q, C * L * BLKp), S)

    d2 = _gather_distances(ix, queries, qnorm2, buf_id, l2_distance_gathered)
    stats = dict(nio_table=nonempty.sum(dim=1, dtype=torch.int32),
                 nio_blocks=blocks_read, cands=count)
    if cfg.collect_probe_sizes:
        stats["probe_sizes"] = torch.where(nonempty, cnt, -1)
    return buf_id, d2, stats


def _merge_topk(best_id, best_d2, new_id, new_d2, k: int):
    """Merge a candidate set into the running top-k with id dedup. Both sorts
    are stable (INVALID = 2^31-1 sorts last), as jnp.argsort is."""
    ids = torch.cat([best_id, new_id], dim=1)
    d2 = torch.cat([best_d2, new_d2], dim=1)
    order = torch.sort(ids, dim=1, stable=True).indices
    ids_s = torch.gather(ids, 1, order)
    d2_s = torch.gather(d2, 1, order)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    dup &= ids_s != INVALID
    d2_s = torch.where(dup, torch.inf, d2_s)
    order2 = torch.sort(d2_s, dim=1, stable=True).indices[:, :k]
    out_d2 = torch.gather(d2_s, 1, order2)
    out_id = torch.gather(ids_s, 1, order2)
    return torch.where(torch.isinf(out_d2), INVALID, out_id), out_d2


def _update_state(state, cid, cd2, st, t: int, thresh2, cfg: QueryConfig):
    """Fold one radius' probe results into the running state (done-masked)."""
    best_id, best_d2, done, radii_searched, nio_t, nio_b, cands, probe_sizes = state
    active_q = ~done
    new_id, new_d2 = _merge_topk(best_id, best_d2, cid, cd2, cfg.k)
    # queries already done keep their results (the paper reports at the first
    # successful radius)
    best_id = torch.where(done[:, None], best_id, new_id)
    best_d2 = torch.where(done[:, None], best_d2, new_d2)
    within = (best_d2 <= thresh2).sum(dim=1) >= cfg.k
    radii_searched = radii_searched + active_q.to(torch.int32)
    nio_t = nio_t + st["nio_table"]
    nio_b = nio_b + st["nio_blocks"]
    cands = cands + st["cands"]
    if cfg.collect_probe_sizes:
        probe_sizes = probe_sizes.clone()
        probe_sizes[:, t, :] = torch.where(active_q[:, None], st["probe_sizes"], -1)
    done = done | (within & active_q)
    return best_id, best_d2, done, radii_searched, nio_t, nio_b, cands, probe_sizes


def _init_state(Q: int, cfg: QueryConfig, device, valid=None):
    """Fresh per-query search state. Masked rows start done, which makes them
    inert everywhere downstream (``active_q = ~done`` gates the probes, the
    I/O counters, the probe trace and the early exit)."""
    r = len(cfg.radii)
    i32 = dict(dtype=torch.int32, device=device)
    probe_sizes = (torch.full((Q, r, cfg.L), -1, **i32) if cfg.collect_probe_sizes
                   else torch.zeros((0,), **i32))
    done0 = (torch.zeros((Q,), dtype=torch.bool, device=device) if valid is None
             else ~valid)
    return (torch.full((Q, cfg.k), INVALID, **i32),
            torch.full((Q, cfg.k), torch.inf, dtype=torch.float32, device=device),
            done0, torch.zeros((Q,), **i32), torch.zeros((Q,), **i32),
            torch.zeros((Q,), **i32), torch.zeros((Q,), **i32), probe_sizes)


def _result_from_state(state, cfg: QueryConfig, valid=None) -> QueryResult:
    best_id, best_d2, done, radii_searched, nio_t, nio_b, cands, probe_sizes = state
    return QueryResult(
        ids=best_id, dists=torch.sqrt(best_d2),
        found=done if valid is None else done & valid,
        radii_searched=radii_searched, nio_table=nio_t, nio_blocks=nio_b,
        cands_checked=cands,
        probe_sizes=probe_sizes if cfg.collect_probe_sizes else None)


def _prep_queries(queries):
    queries = queries.to(torch.float32).contiguous()
    return queries, (queries * queries).sum(dim=-1)


# A lone query is dispatched as a masked batch of two, as the reference does
# (there XLA lowers Q=1 as a matvec whose accumulation order differs from the
# batched gemm). Keeping it here keeps every batch shape on one code path and
# a Q=1 result identical to the same row in a padded serving batch.
_MIN_DISPATCH_Q = 2


def _pad_min_q(queries, valid):
    """Pad a sub-minimum batch with masked rows. Returns (queries, valid,
    real_Q)."""
    Q = queries.shape[0]
    if Q >= _MIN_DISPATCH_Q:
        return queries, valid, Q
    pad = _MIN_DISPATCH_Q - Q
    queries = torch.cat([queries, queries.new_zeros((pad,) + tuple(queries.shape[1:]))])
    v = (torch.ones((Q,), dtype=torch.bool, device=queries.device) if valid is None
         else valid)
    valid = torch.cat([v, torch.zeros((pad,), dtype=torch.bool, device=queries.device)])
    return queries, valid, Q


def _thresholds(cfg: QueryConfig, device) -> torch.Tensor:
    return torch.tensor([(cfg.c * float(rad)) ** 2 for rad in cfg.radii],
                        dtype=torch.float32, device=device)


# --------------------------------------------------------------------------
# Plan bodies
# --------------------------------------------------------------------------

def oracle_plan_body(ix: IndexArrays, queries: torch.Tensor, cfg: QueryConfig,
                     valid=None) -> QueryResult:
    """Reference ORACLE plan: every radius with done-masking, CSR gathers,
    plain hashing and distances. Every other plan must match it."""
    queries, valid, realQ = _pad_min_q(queries, valid)
    queries, qnorm2 = _prep_queries(queries)
    state = _init_state(queries.shape[0], cfg, queries.device, valid)
    thresh2 = _thresholds(cfg, queries.device)
    for t, radius in enumerate(cfg.radii):
        cid, cd2, st = _probe_radius(ix, queries, qnorm2, t, float(radius), cfg,
                                     ~state[2])
        state = _update_state(state, cid, cd2, st, t, thresh2[t], cfg)
    return _result_from_state(state, cfg, valid).slice_rows(0, realQ)


def host_plan_body(ix: IndexArrays, queries: torch.Tensor, cfg: QueryConfig,
                   valid=None) -> QueryResult:
    """HOST plan: the oracle's radius step, one call plus one device->host
    sync per radius to leave once every query is done. Radii after that
    change nothing in the oracle (every row is done, so nothing is probed or
    counted), so the results are the oracle's."""
    queries, valid, realQ = _pad_min_q(queries, valid)
    queries, qnorm2 = _prep_queries(queries)
    state = _init_state(queries.shape[0], cfg, queries.device, valid)
    thresh2 = _thresholds(cfg, queries.device)
    for t, radius in enumerate(cfg.radii):
        cid, cd2, st = _probe_radius(ix, queries, qnorm2, t, float(radius), cfg,
                                     ~state[2])
        state = _update_state(state, cid, cd2, st, t, thresh2[t], cfg)
        if bool(state[2].all()):
            break
    return _result_from_state(state, cfg, valid).slice_rows(0, realQ)


def table_lookup(ix: IndexArrays, bucket_all: torch.Tensor, cfg: QueryConfig):
    """Bucket sizes and chain-head rows for every (radius, query, table) in
    two gathers. bucket_all [r, Q, L] -> (cnt_all, head_all) [r, Q, L]."""
    r = len(cfg.radii)
    dev = bucket_all.device
    tl = (torch.arange(r, device=dev, dtype=torch.int64)[:, None, None] * cfg.L
          + torch.arange(cfg.L, device=dev, dtype=torch.int64)[None, None, :])
    flat = (tl << cfg.u) + bucket_all.to(torch.int64)
    return ix.table_cnt.reshape(-1)[flat], ix.blocks_head.reshape(-1)[flat]


def hash_stage(ix: IndexArrays, queries: torch.Tensor, cfg: QueryConfig):
    """Step 1 for the whole schedule: one lsh_hash launch hashes every radius,
    then the table lookups. queries [Q, d] float32 -> (cnt_all, head_all,
    qfp_all) [r, Q, L]."""
    bucket_all, qfp_all = lsh_hash_all_radii(
        queries, ix.a, ix.b, ix.rm, w=cfg.w, radii=cfg.radii, u=cfg.u,
        fp_bits=cfg.fp_bits)
    cnt_all, head_all = table_lookup(ix, bucket_all, cfg)
    return cnt_all, head_all, qfp_all


def probe_stage(ix: IndexArrays, queries, qnorm2, cnt_all, head_all, qfp_all,
                cfg: QueryConfig, valid=None):
    """Steps 2-3, radius by radius, until every query is done. Returns the
    final search state."""
    state = _init_state(queries.shape[0], cfg, queries.device, valid)
    thresh2 = _thresholds(cfg, queries.device)
    for t in range(len(cfg.radii)):
        if bool(state[2].all()):  # one host sync per radius: early exit
            break
        cid, cd2, st = _probe_radius_fused(
            ix, queries, qnorm2, cnt_all[t], head_all[t], qfp_all[t], cfg, ~state[2])
        state = _update_state(state, cid, cd2, st, t, thresh2[t], cfg)
    return state


def fused_plan_body(ix: IndexArrays, queries: torch.Tensor, cfg: QueryConfig,
                    valid=None) -> QueryResult:
    """FUSED plan: the hash stage, then the probe stage over the block store
    the build emitted."""
    if ix.block_objs != cfg.block_objs:
        raise ValueError(
            f"IndexArrays blockified at block_objs={ix.block_objs} but the "
            f"query plan wants {cfg.block_objs}; re-blockify with "
            "IndexArrays.with_block_objs (SearchEngine does this)")
    queries, valid, realQ = _pad_min_q(queries, valid)
    queries, qnorm2 = _prep_queries(queries)
    cnt_all, head_all, qfp_all = hash_stage(ix, queries, cfg)
    state = probe_stage(ix, queries, qnorm2, cnt_all, head_all, qfp_all, cfg, valid)
    return _result_from_state(state, cfg, valid).slice_rows(0, realQ)


_PLANS = {"fused": fused_plan_body, "host": host_plan_body,
          "oracle": oracle_plan_body}


# --------------------------------------------------------------------------
# The facade
# --------------------------------------------------------------------------

class SearchEngine:
    """One query entry point over the plans of one index.

    ``index`` is an ``E2LSHoS`` facade, an ``E2LSHIndex`` or an
    ``ExternalIndex`` (``repro_torch.storage``; a striped one serves
    ``plan="sharded_external"``). ``device`` (None -> cuda) is where an
    in-memory index's plans run; the index moves there if it lies elsewhere.
    An external index runs on the device it was loaded on. Re-blockified
    layouts for the ``block_objs`` timing knob are memoized.
    """

    PLANS = tuple(_PLANS)
    EXTERNAL_PLANS = ("external",)
    SHARDED_EXTERNAL_PLANS = ("sharded_external",)

    def __init__(self, index, *, device=None):
        if hasattr(index, "index") and hasattr(index, "tier"):  # E2LSHoS
            index = index.index
        self.params: LSHParams = index.params
        self._external = None
        if hasattr(index, "store") and hasattr(index, "blocks_head"):
            # an ExternalIndex: its block rows live on disk behind the
            # BlockStore, its resident tensors on the device it was loaded on
            if device is not None and torch.device(device).type != index.device.type:
                raise ValueError(f"the external index lies on {index.device}; "
                                 f"load it with load_external(..., device={device!r})")
            self.device = index.device
            self._external = index
            self._external_striped = hasattr(index, "num_shards")
            return
        self.device = resolve_device(device)
        base = index.arrays.to(self.device)
        self._base_block_objs = base.block_objs
        self._by_block_objs = {base.block_objs: base}

    @property
    def plans(self) -> tuple:
        if self._external is not None:
            return (self.SHARDED_EXTERNAL_PLANS if self._external_striped
                    else self.EXTERNAL_PLANS)
        return self.PLANS

    @property
    def default_plan(self) -> str:
        return self.plans[0]

    @property
    def external(self):
        """The engine's ``ExternalIndex`` (None for an in-memory engine):
        ``.last_plan_stats`` (the last call's instrumentation),
        ``.plan_totals`` (the accumulating roll-up) and ``.store`` (the I/O
        ledger)."""
        return self._external

    def arrays(self, block_objs: Optional[int] = None) -> IndexArrays:
        """The index tensors, re-blockified (and memoized) on demand."""
        if self._external is not None:
            raise ValueError(
                "an external index keeps its block rows on disk; there is no "
                "in-memory IndexArrays to serve. Use plan=\"external\" (the "
                "BlockStore streams the rows), or load the whole index with "
                f"repro_torch.storage.load_arrays({self._external.path!r})")
        bo = int(block_objs or self._base_block_objs)
        if bo not in self._by_block_objs:
            self._by_block_objs[bo] = (
                self._by_block_objs[self._base_block_objs].with_block_objs(bo))
        return self._by_block_objs[bo]

    def config(self, *, k: int = 1, collect_probe_sizes: bool = False,
               s_cap: Optional[int] = None, max_chain: int = 0,
               block_objs: Optional[int] = None) -> QueryConfig:
        cfg = QueryConfig.from_params(self.params, k=k, max_chain=max_chain,
                                      collect_probe_sizes=collect_probe_sizes)
        return cfg.replace(s_cap=s_cap, block_objs=block_objs)

    def _as_queries(self, queries) -> torch.Tensor:
        if not torch.is_tensor(queries):
            queries = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
        return queries.to(self.device, torch.float32)

    def _as_valid(self, valid):
        if valid is None:
            return None
        if not torch.is_tensor(valid):
            valid = torch.from_numpy(np.asarray(valid, dtype=bool))
        return valid.to(self.device, torch.bool)

    def _resolve(self, plan: Optional[str], *, k: int = 1,
                 block_objs: Optional[int] = None, **kw):
        """(run, target, cfg) of one plan: the plan body, the index it runs
        over (re-blockified IndexArrays, or the ExternalIndex) and its
        config. An external index's block size is fixed at spill time; its
        plan rejects any other ``block_objs``."""
        plan = plan or self.default_plan
        if plan not in self.plans:
            kind = "an external" if self._external is not None else "an in-memory"
            raise ValueError(f"unknown plan {plan!r} for {kind} index; expected "
                             f"one of {self.plans}")
        if self._external is not None:
            if self._external_striped:
                from ..storage.sharded import sharded_external_plan as run
            else:
                from ..storage.external import external_plan as run
            bo = self._external.block_objs if block_objs is None else block_objs
            return run, self._external, self.config(k=k, block_objs=bo, **kw)
        cfg = self.config(k=k, block_objs=block_objs, **kw)
        return (_PLANS[plan], self.arrays(cfg.block_objs if plan == "fused" else None),
                cfg)

    def query(self, queries, *, plan: Optional[str] = None, k: int = 1,
              s_cap: Optional[int] = None, block_objs: Optional[int] = None,
              collect_probe_sizes: bool = False, valid=None) -> QueryResult:
        """Run a query batch under the selected plan (None: "fused" for an
        in-memory index, "external" for an external one).

        valid: optional [Q] bool mask for padded serving batches — masked rows
        are inert and the unmasked rows match an unpadded dispatch.
        """
        run, target, cfg = self._resolve(plan, k=k, s_cap=s_cap, block_objs=block_objs,
                                         collect_probe_sizes=collect_probe_sizes)
        return run(target, self._as_queries(queries), cfg, self._as_valid(valid))

    def make_plan_fn(self, *, plan: Optional[str] = None, k: int = 1,
                     masked: bool = False, **kw):
        """(cfg, fn): a QueryConfig plus a closure pinned to one plan, with the
        config and the (re-blockified) index resolved once.

        masked=False: ``fn(queries) -> QueryResult``;
        masked=True:  ``fn(queries, valid) -> QueryResult``."""
        run, target, cfg = self._resolve(plan, k=k, **kw)
        if masked:
            def fn(queries, valid):
                return run(target, self._as_queries(queries), cfg, self._as_valid(valid))
        else:
            def fn(queries):
                return run(target, self._as_queries(queries), cfg)
        return cfg, fn

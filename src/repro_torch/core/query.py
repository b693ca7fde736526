"""Batched multi-radius (R, c)-NN query processing (paper Secs. 2.3, 5.4).

For each radius R in (1, c, c^2, ...):
  1. hash the query into L buckets (Step 1 of Fig. 10 = hash-table read);
  2. walk each non-empty bucket's block chain, ``block_objs`` entries per
     read (Step 2 = bucket block reads), fingerprint-filtering object infos,
     until S candidates are collected;
  3. distance-check the candidates against the DRAM-resident database
     (Step 3), merge them into the running top-k (dedup by id), and mark the
     query done when k results lie within c*R (the radius fold).

One entry point over the plans of one single-device index:

    engine = SearchEngine(index)   # index: E2LSHoS, E2LSHIndex or ExternalIndex
    res = engine.query(qs, plan="fused")

* ``plan="fused"`` — the production plan. A hash stage hashes the batch for
  the whole radius schedule and looks up every bucket's size and chain head
  in one ``lsh_hash`` launch (the lookup is the kernel's epilogue); a probe
  stage then runs the radius loop: per radius one ``probe_append`` launch
  reads the chain block rows under the S budget and appends the fingerprint
  matches to the candidate buffer, one ``l2_distance_by_id`` launch gathers
  the candidates' rows and computes their distances, and one ``topk_merge``
  launch folds them into the running top-k and the counters in place
  (``_update_state``; on the CPU its plain version ``topk_merge_ref``).
  The loop leaves early when every query is done, which costs one
  ``done.all()`` device->host sync per radius (at most r): PyTorch runs
  eagerly, and without the sync every batch would pay for all r radii.
* ``plan="oracle"`` — the reference: every radius run with done-masking,
  per-radius plain hashing, a dense gather over the CSR view and the plain
  fold ``topk_merge_ref`` on every device. Simple, obviously correct, and
  the parity target of the fused plan.
* ``plan="host"`` — the oracle's radius step, one call and one host sync per
  radius for the early exit: the pre-fusion host-driven loop, kept as a
  baseline of dispatch overhead. Same results as the oracle.

Over a ``ShardedIndexArrays`` (``repro_torch.core.distributed``: the
database range-partitioned, one sub-index per shard under a shared family),
or over each rank's ``LocalShard`` of one across ``torch.distributed``
ranks (``SearchEngine(local, group=layout)``; every rank calls):

* ``plan="sharded"`` — the fused plan body per shard, the shards' top-k
  merged as the reference's all-gather merge does;
* ``plan="oracle"`` — the oracle body per shard through the same merge (the
  parity target of the sharded plan).

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

Every ``SearchEngine.query`` call counts in ``e2lsh_query_calls_total{plan}``
and, with tracing on, opens the root ``query`` span (plan, k) that the
storage tier's spans hang from, with ``query.upload`` (the batch's copy to
the device) under it. The fused plan's stages add ``query.hash`` (also under
the external plan's set-up), ``query.init`` and, per radius ``t``,
``query.sync``, ``query.probe`` and ``query.merge``. ``make_plan_fn``'s
closures over one index dispatch the plan body directly and record no root
span and no count, as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .index import IndexArrays
from .probabilities import LSHParams
from ..kernels.bucket_probe.ops import INVALID, probe_append
from ..kernels.bucket_probe.ref import append_candidates
from ..kernels.dispatch import resolve_device
from ..kernels.l2_distance.ops import l2_distance_by_id
from ..kernels.l2_distance.ref import l2_distance_by_id_ref
from ..kernels.lsh_hash.ops import index_hash_pack, lsh_hash_lookup
from ..kernels.lsh_hash.ref import lsh_hash_ref, table_lookup_ref
from ..kernels.topk_merge.ops import topk_merge
from ..kernels.topk_merge.ref import topk_merge_ref
from ..telemetry import get_registry, get_tracer

__all__ = ["QueryConfig", "QueryResult", "SearchEngine", "fused_plan_body",
           "host_plan_body", "oracle_plan_body", "hash_stage", "table_lookup",
           "probe_stage"]

_QUERY_CALLS = get_registry().counter(
    "e2lsh_query_calls_total", "SearchEngine.query calls",
    labelnames=("plan",))


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

    def cpu(self) -> "QueryResult":
        """The whole result on the host in ONE device-to-host copy (a serving
        tick pays one sync, not one per field)."""
        if self.ids.device.type == "cpu":
            return self
        return self._unpacked(self._packed().cpu())

    def _packed(self) -> torch.Tensor:
        """Every field side by side, bit for bit, in one int32 [Q, cols]
        tensor on the result's device: ``dists`` as its float32 bit pattern,
        ``found`` as 0/1, ``probe_sizes`` flattened per row."""
        cols = []
        for f in dataclasses.fields(QueryResult):
            v = getattr(self, f.name)
            if v is not None:
                v = v.view(torch.int32) if v.dtype == torch.float32 else v.to(torch.int32)
                cols.append(v.reshape(v.shape[0], -1))
        return torch.cat(cols, dim=1)

    def _unpacked(self, packed: torch.Tensor) -> "QueryResult":
        """``_packed``'s inverse, shaped and typed after this result."""
        out, lo = {}, 0
        for f in dataclasses.fields(QueryResult):
            v = getattr(self, f.name)
            if v is None:
                out[f.name] = None
                continue
            width = v[0].numel() if v.dim() > 1 else 1
            part = packed[:, lo:lo + width].reshape(v.shape)
            lo += width
            out[f.name] = (part.view(torch.float32) if v.dtype == torch.float32
                           else part.to(v.dtype))
        return QueryResult(**out)

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


def _probe_radius(ix: IndexArrays, queries, qnorm2, t: int, radius: float,
                  cfg: QueryConfig, active_q):
    """One (R, c)-NN probe for every query in the batch (ORACLE plan), over
    the CSR view. Returns (cand_id [Q, SBUF], cand_d2 [Q, SBUF], cnt [Q, L],
    blocks_read [Q], count [Q]): the fold's inputs."""
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
        buf_id, count = append_candidates(
            buf_id, count, eid.reshape(Q, L * BLK), ok.reshape(Q, L * BLK), S)

    d2 = l2_distance_by_id_ref(queries, buf_id, ix.db, ix.db_norm2, qnorm2)
    return buf_id, d2, cnt, blocks_read, count


def _fused_sbuf(cfg: QueryConfig) -> int:
    """Candidate-buffer width of the fused probe: S rounded up to 8. Slots
    past S never hold a candidate, so results are the same for any width
    >= S; the reference's 128-lane padding is TPU layout only."""
    return max(8, -(-cfg.S // 8) * 8)


def _probe_radius_fused(ix: IndexArrays, queries, qnorm2, cnt, head, qfp,
                        cfg: QueryConfig, active_q):
    """One (R, c)-NN probe on the block store (FUSED plan).

    ``cnt``/``head``/``qfp`` [Q, L] come from the hash stage. Step 2 is one
    ``probe_append`` launch: every chain step's block rows read under the
    oracle's sequential ``count < S`` gate, their fingerprint matches
    appended in the oracle's (step, l, slot) order; step 3 is one
    ``l2_distance_by_id`` launch over the buffer's ids. Candidates, their
    order and the I/O counts equal ``_probe_radius``'s: the block rows hold
    the CSR chunks' entries. Returns (buf_id, d2, blocks_read, count); the
    fold counts the hash-table reads from ``cnt``.
    """
    buf_id, count, blocks_read = probe_append(
        cnt, head, qfp, active_q, ix.ids_blocks, ix.fps_blocks, block_objs=cfg.block_objs,
        max_chain=cfg.max_chain, S=cfg.S, sbuf=_fused_sbuf(cfg))
    d2 = l2_distance_by_id(queries, buf_id, ix.db, ix.db_norm2, qnorm2)
    return buf_id, d2, blocks_read, count


def _update_state(state, cid, cd2, cnt, blocks_read, count, t: int, thresh2: float):
    """Fold one radius' probe results into the running state (done-masked)
    and return it: the fused and external plans' fold. ``topk_merge``
    dispatches by device: on the card one launch of the ``topk_merge`` kernel
    updates the state in place, on the CPU its plain version
    ``topk_merge_ref`` returns a new one. The oracle and host plans call the
    plain version directly, so they stay the fused plan's independent parity
    target on the card."""
    return topk_merge(state, cid, cd2, cnt, blocks_read, count, t=t, thresh2=thresh2)


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


def _thresholds(cfg: QueryConfig) -> tuple:
    """(c R_t)^2 for each radius, rounded to float32 (as the reference's
    ``jnp.float32``) and held on the host: the fold takes it as an argument,
    so no copy to the device and no sync."""
    return tuple(float(np.float32((cfg.c * float(rad)) ** 2)) for rad in cfg.radii)


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
    thresh2 = _thresholds(cfg)
    for t, radius in enumerate(cfg.radii):
        probed = _probe_radius(ix, queries, qnorm2, t, float(radius), cfg, ~state[2])
        state = topk_merge_ref(state, *probed, t=t, thresh2=thresh2[t])
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
    thresh2 = _thresholds(cfg)
    for t, radius in enumerate(cfg.radii):
        probed = _probe_radius(ix, queries, qnorm2, t, float(radius), cfg, ~state[2])
        state = topk_merge_ref(state, *probed, t=t, thresh2=thresh2[t])
        if bool(state[2].all()):
            break
    return _result_from_state(state, cfg, valid).slice_rows(0, realQ)


def table_lookup(ix: IndexArrays, bucket_all: torch.Tensor, cfg: QueryConfig):
    """Bucket sizes and chain-head rows for every (radius, query, table) in
    two gathers. bucket_all [r, Q, L] -> (cnt_all, head_all) [r, Q, L].
    The plain lookup: :func:`hash_stage` does it in the hash kernel's
    epilogue, and is held to this over the plain hashes."""
    return table_lookup_ref(ix.table_cnt, ix.blocks_head, bucket_all, u=cfg.u)


def hash_stage(ix: IndexArrays, queries: torch.Tensor, cfg: QueryConfig):
    """Step 1 for the whole schedule: ``lsh_hash_lookup`` hashes every radius
    and reads each bucket's size and chain head from the index's tables, in
    one ``lsh_hash`` launch on the card (the plain version, equal to
    :func:`table_lookup` over the plain hashes, on the CPU); the kernel reads
    the index's hash pack, built at its first batch. queries [Q, d] float32
    -> (cnt_all, head_all, qfp_all) [r, Q, L] int32, contiguous (the probe
    kernel reads each radius' [Q, L] rows). With tracing on, the stage is
    the ``query.hash`` span."""
    with get_tracer().span("query.hash"):
        return lsh_hash_lookup(queries, index_hash_pack(ix, w=cfg.w, radii=cfg.radii),
                               ix.table_cnt, ix.blocks_head, u=cfg.u, fp_bits=cfg.fp_bits)


def probe_stage(ix: IndexArrays, queries, qnorm2, cnt_all, head_all, qfp_all,
                cfg: QueryConfig, valid=None):
    """Steps 2-3, radius by radius, until every query is done. Returns the
    final search state.

    With tracing on, the stage records ``query.init`` (the state and the
    thresholds) and, for each radius ``t``, ``query.sync`` (the host blocked
    on the early-exit read), ``query.probe`` (``probe_append`` and
    ``l2_distance_by_id``) and ``query.merge`` (the fold, one ``topk_merge``
    launch on the card), each carrying ``t``. No attribute reads the
    device."""
    tracer = get_tracer()
    with tracer.span("query.init"):
        state = _init_state(queries.shape[0], cfg, queries.device, valid)
        thresh2 = _thresholds(cfg)
    for t in range(len(cfg.radii)):
        with tracer.span("query.sync", t=t):
            done = bool(state[2].all())  # one host sync per radius: early exit
        if done:
            break
        with tracer.span("query.probe", t=t):
            cid, cd2, blocks_read, count = _probe_radius_fused(
                ix, queries, qnorm2, cnt_all[t], head_all[t], qfp_all[t], cfg, ~state[2])
        with tracer.span("query.merge", t=t):
            state = _update_state(state, cid, cd2, cnt_all[t], blocks_read, count, t,
                                  thresh2[t])
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

    ``index`` is an ``E2LSHoS`` facade, an ``E2LSHIndex``, a
    ``ShardedIndexArrays`` (``repro_torch.core.distributed``: plans
    "sharded" and "oracle"), this rank's ``LocalShard`` with ``group=`` its
    ``RankLayout`` (the same plans across ranks: every rank of the layout
    makes every call, and each rank's registry counts it) or an
    ``ExternalIndex`` (``repro_torch.storage``; a striped one serves
    ``plan="sharded_external"``). ``device`` (None -> cuda) is where an
    in-memory index's plans run; the index moves there if it lies
    elsewhere. An external index runs on the device it was loaded on.
    Re-blockified layouts for the ``block_objs`` timing knob are memoized
    (per shard on a sharded index).
    """

    PLANS = tuple(_PLANS)
    SHARDED_PLANS = ("sharded", "oracle")
    EXTERNAL_PLANS = ("external",)
    SHARDED_EXTERNAL_PLANS = ("sharded_external",)

    def __init__(self, index, *, device=None, group=None):
        if hasattr(index, "index") and hasattr(index, "tier"):  # E2LSHoS
            index = index.index
        self.params: LSHParams = index.params
        self._external = self._sharded = None
        self.group = group          # the RankLayout of a LocalShard, else None
        if (group is not None) != (hasattr(index, "num_shards")
                                   and hasattr(index, "shard_offset")):
            raise ValueError("group= goes with a LocalShard (the rank's part of a "
                             "sharded index), and a LocalShard needs it")
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
        if hasattr(index, "num_shards"):      # ShardedIndexArrays or LocalShard
            base = self._sharded = index.to(self.device)
        else:
            base = index.arrays.to(self.device)
        self._base_block_objs = base.block_objs
        self._by_block_objs = {base.block_objs: base}

    @property
    def plans(self) -> tuple:
        if self._external is not None:
            return (self.SHARDED_EXTERNAL_PLANS if self._external_striped
                    else self.EXTERNAL_PLANS)
        return self.SHARDED_PLANS if self._sharded is not None else self.PLANS

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

    def arrays(self, block_objs: Optional[int] = None):
        """The index tensors, re-blockified (and memoized) on demand; on a
        sharded engine the per-shard ``IndexArrays`` list, every shard
        re-blockified (on a rank's engine, its shard's ``IndexArrays``)."""
        if self._external is not None:
            raise ValueError(
                "an external index keeps its block rows on disk; there is no "
                "in-memory IndexArrays to serve. Use plan=\"external\" (the "
                "BlockStore streams the rows), or load the whole index with "
                f"repro_torch.storage.load_arrays({self._external.path!r})")
        ix = self._layout(block_objs)
        return ix.arrays if self._sharded is not None else ix

    def _layout(self, block_objs: Optional[int]):
        """The in-memory index (IndexArrays, or ShardedIndexArrays with every
        shard re-blockified) at ``block_objs``, memoized."""
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
                 block_objs: Optional[int] = None,
                 s_cap_per_shard: Optional[int] = None, **kw):
        """(run, target, cfg) of one plan: the plan body, the index it runs
        over (re-blockified IndexArrays, the sharded index, or the
        ExternalIndex) and its config. An external index's block size is
        fixed at spill time; its plan rejects any other ``block_objs``. On a
        sharded index ``cfg`` is the schedule before the per-shard budget
        (``sharded_query_result`` derives that)."""
        plan = plan or self.default_plan
        if plan not in self.plans:
            kind = ("an external" if self._external is not None else
                    "a sharded" if self._sharded is not None else "an in-memory")
            raise ValueError(f"unknown plan {plan!r} for {kind} index; expected "
                             f"one of {self.plans}")
        if self._sharded is not None:
            if kw.get("collect_probe_sizes"):
                raise ValueError("collect_probe_sizes is not supported under the "
                                 "sharded plans")
            if kw.get("max_chain"):
                raise ValueError("max_chain override is not supported under the "
                                 "sharded plans (the per-shard schedule is derived "
                                 "from the index params)")
            unknown = set(kw) - {"s_cap", "collect_probe_sizes", "max_chain"}
            if unknown:
                raise TypeError(f"unexpected plan kwargs {sorted(unknown)}")
            from .distributed import sharded_query_result
            s_cap = kw.get("s_cap")
            local = "fused" if plan == "sharded" else "oracle"

            def run(sharded, queries, cfg, valid=None):
                return sharded_query_result(
                    sharded, queries, k=k, s_cap=s_cap, s_cap_per_shard=s_cap_per_shard,
                    local_plan=local, valid=valid, group=self.group)
            return (run, self._layout(block_objs),
                    self.config(k=k, s_cap=s_cap, block_objs=block_objs))
        if s_cap_per_shard is not None:
            if self._external is not None:
                raise ValueError("s_cap_per_shard only applies to the in-memory "
                                 "sharded plans (the striped external plan keeps "
                                 "the global S budget, which is what makes it "
                                 "bit-exact with fused)")
            raise ValueError("s_cap_per_shard only applies to sharded plans; use "
                             "s_cap for a single-device index")
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
              collect_probe_sizes: bool = False,
              s_cap_per_shard: Optional[int] = None, valid=None) -> QueryResult:
        """Run a query batch under the selected plan (None: "fused" for an
        in-memory index, "sharded" for a sharded one, "external" for an
        external one).

        s_cap_per_shard: the sharded plans' per-shard candidate budget
        (default ``max(4k, ceil(S / num_shards))``); any other index raises.
        valid: optional [Q] bool mask for padded serving batches — masked rows
        are inert and the unmasked rows match an unpadded dispatch.
        """
        plan = plan or self.default_plan
        _QUERY_CALLS.inc(plan=plan)
        tracer = get_tracer()
        with tracer.span("query", plan=plan, k=k):  # a no-op when tracing is off
            run, target, cfg = self._resolve(plan, k=k, s_cap=s_cap, block_objs=block_objs,
                                             collect_probe_sizes=collect_probe_sizes,
                                             s_cap_per_shard=s_cap_per_shard)
            with tracer.span("query.upload"):
                queries, valid = self._as_queries(queries), self._as_valid(valid)
            return run(target, queries, cfg, valid)

    def make_plan_fn(self, *, plan: Optional[str] = None, k: int = 1,
                     masked: bool = False, **kw):
        """(cfg, fn): a QueryConfig plus a closure pinned to one plan, with the
        config and the (re-blockified) index resolved once.

        masked=False: ``fn(queries) -> QueryResult``;
        masked=True:  ``fn(queries, valid) -> QueryResult``.

        On a sharded index the unmasked closure goes through ``query`` (and
        so counts its calls), as the reference's does."""
        run, target, cfg = self._resolve(plan, k=k, **kw)
        if masked:
            def fn(queries, valid):
                return run(target, self._as_queries(queries), cfg, self._as_valid(valid))
        elif self._sharded is not None:
            plan = plan or self.default_plan

            def fn(queries):
                return self.query(queries, plan=plan, k=k, s_cap=kw.get("s_cap"),
                                  block_objs=kw.get("block_objs"),
                                  s_cap_per_shard=kw.get("s_cap_per_shard"))
        else:
            def fn(queries):
                return run(target, self._as_queries(queries), cfg)
        return cfg, fn

"""The ``plan="external"`` execution plan: E2LSHoS run from storage.

The paper's headline configuration (Secs. 5-6): hash tables, family params
and the DRAM tier stay resident on the device, bucket block rows live on
disk, and a query batch alternates device compute with host block fetches:

  1. **Setup (device).** ``core.query.hash_stage`` — the fused plan's own
     call: one ``lsh_hash`` launch hashes the whole radius schedule and, in
     its epilogue, looks up every ``(t, q, l)`` bucket's size and chain head,
     so external and fused hash identically on the card. The three [r, Q, L]
     results then come to the host once per batch (one ``.cpu()`` each).
  2. **Chain walk (host, per radius rung).** Block rows are fetched through
     the pluggable :class:`~repro_torch.storage.blockstore.BlockStore`,
     batched per chain step so the async backends see deep queues, and
     fingerprint-filtered with the oracle's round-robin append semantics
     (S-cap gating per step, ``(l, slot)`` flat order). The store's logical
     ``reads`` ledger is the measured N_io that must equal the Eq. 6/7
     replay.
  3. **Fold (device, per rung).** The rung's candidate buffer, counters and
     bucket sizes go up in one pinned, non-blocking copy; the
     ``l2_distance_by_id`` kernel gathers the candidates' rows by id and
     computes their distances, and the fused plan's ``_update_state`` folds
     them into the top-k and the counters: one ``topk_merge`` launch on the
     card, its plain version ``topk_merge_ref`` on the CPU. The fold
     holds no host sync (no ``.item()``, ``bool()`` or ``.cpu()`` on device
     data), so its launches return at once and the host **prefetches the
     next rung's chain heads** under it — the fetch/compute overlap of
     Eq. 7's ``max(T_compute, T_storage)`` — before it blocks on the rung's
     ``done`` flags. A sync inside the fold would make ``overlap_ms`` 0.

Parity contract: on a spilled copy of an index, ``plan="external"`` (any
backend) equals ``plan="fused"`` on every ``QueryResult`` field, bit for
bit: the hashes come from the same launch, the host walk replicates the
oracle's integer candidate selection, and the fold uses the fused plan's
buffer width (``_fused_sbuf``) and distance kernel.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Optional

import numpy as np
import torch

from ..core.index import IndexStats
from ..core.probabilities import LSHParams
from ..core.query import (QueryConfig, QueryResult, _fused_sbuf, _init_state, _pad_min_q,
                          _prep_queries, _result_from_state, _thresholds, _update_state,
                          hash_stage)
from ..kernels.l2_distance.ops import l2_distance_by_id
from ..telemetry import get_registry, get_tracer
from .blockstore import BlockStore, StoreStats

__all__ = ["ExternalIndex", "ExternalPlanStats", "ExternalPlanTotals",
           "RungStats", "external_plan", "external_probe_stage"]

_INVALID = np.int32(2**31 - 1)


@dataclasses.dataclass
class ExternalPlanTotals:
    """ACCUMULATING roll-up of every external-plan call on one index — the
    concurrency-safe counterpart of ``last_plan_stats`` (which is per-call
    and overwritten by design): under a BatchQueue every tick's stats fold
    in here instead of clobbering each other. ``snapshot()``/``since()``
    bracket a window the way ``StoreStats`` does; the telemetry registry
    reads these totals live."""

    calls: int = 0
    queries: int = 0
    nio_blocks: int = 0             # logical block reads (== io.reads sums)
    prefetch_rows: int = 0
    setup_ms: float = 0.0
    total_ms: float = 0.0
    fetch_ms: float = 0.0
    compute_wait_ms: float = 0.0
    overlap_ms: float = 0.0
    # per rung POSITION t (bounded by the radius schedule length)
    rung_blocks: dict = dataclasses.field(default_factory=dict)
    rung_entered: dict = dataclasses.field(default_factory=dict)

    _SCALARS = ("calls", "queries", "nio_blocks", "prefetch_rows", "setup_ms",
                "total_ms", "fetch_ms", "compute_wait_ms", "overlap_ms")

    def add(self, ps: "ExternalPlanStats") -> None:
        self.calls += 1
        self.queries += ps.queries
        self.nio_blocks += ps.io.reads
        self.setup_ms += ps.setup_ms
        self.total_ms += ps.total_ms
        for r in ps.rungs:
            self.prefetch_rows += r.prefetch_rows
            self.fetch_ms += r.fetch_ms
            self.compute_wait_ms += r.compute_wait_ms
            self.overlap_ms += r.overlap_ms
            self.rung_blocks[r.t] = (self.rung_blocks.get(r.t, 0)
                                     + r.blocks_fetched)
            self.rung_entered[r.t] = self.rung_entered.get(r.t, 0) + 1

    def snapshot(self) -> "ExternalPlanTotals":
        return dataclasses.replace(self, rung_blocks=dict(self.rung_blocks),
                                   rung_entered=dict(self.rung_entered))

    def since(self, base: "ExternalPlanTotals") -> "ExternalPlanTotals":
        out = ExternalPlanTotals(**{
            f: getattr(self, f) - getattr(base, f) for f in self._SCALARS})
        for name in ("rung_blocks", "rung_entered"):
            mine, theirs = getattr(self, name), getattr(base, name)
            d = {t: v - theirs.get(t, 0) for t, v in mine.items()}
            setattr(out, name, {t: v for t, v in d.items() if v})
        return out

    def as_dict(self) -> dict:
        d = {f: getattr(self, f) for f in self._SCALARS}
        d["rung_blocks"] = dict(self.rung_blocks)
        d["rung_entered"] = dict(self.rung_entered)
        return d


# totals accumulate under one module lock (ticks already serialize at the
# queue; this guards direct multi-threaded engine use)
_TOTALS_LOCK = threading.Lock()


@dataclasses.dataclass(eq=False)      # identity semantics: telemetry weak-set
class ExternalIndex:
    """A spilled index opened for external-memory querying: resident hash
    tables + DRAM tier, block rows behind a :class:`BlockStore`. Built by
    ``repro_torch.storage.load_external``; served by ``SearchEngine(ext)`` under
    ``plan="external"``."""

    params: LSHParams
    a: torch.Tensor            # hash family [r, L, m, d], on the device
    b: torch.Tensor
    rm: torch.Tensor           # int32 bit patterns of the uint32 multipliers
    blocks_head: torch.Tensor  # [r, L, 2^u] first block row per bucket
    table_cnt: torch.Tensor    # [r, L, 2^u] bucket sizes
    db: torch.Tensor           # DRAM tier [n, d]
    db_norm2: torch.Tensor
    block_objs: int
    lane_pad: int
    blkp: int                 # padded block-row width of the spilled store
    store: BlockStore
    path: str
    stats: Optional[IndexStats] = None
    last_plan_stats: Optional["ExternalPlanStats"] = None
    # the accumulating ledger every external_plan call folds into (never
    # overwritten — the BatchQueue-safe stat surface; see ExternalPlanTotals)
    plan_totals: ExternalPlanTotals = dataclasses.field(
        default_factory=ExternalPlanTotals)
    # chain steps of the NEXT rung pushed into the store's queue while the
    # device fold runs (Eq. 7 overlap). 1 = chain heads only; deeper values
    # keep an async backend's queue full across the rung boundary.
    prefetch_depth: int = 1
    # probe-trace row histogram (block row -> times walked), accumulated by
    # external_plan when enabled — the serving queue's cache-warming signal
    collect_row_hist: bool = False
    row_hist: Optional[dict] = None

    def __post_init__(self):
        self._retired = False
        _LIVE_EXTERNAL.add(self)

    @property
    def backend(self) -> str:
        return self.store.name

    @property
    def device(self) -> torch.device:
        return self.db.device

    def record_probe_rows(self, rows) -> None:
        """Fold one chain step's block rows into the probe-trace histogram."""
        if self.row_hist is None:
            self.row_hist = {}
        h = self.row_hist
        uniq, counts = np.unique(np.asarray(rows, np.int64).ravel(),
                                 return_counts=True)
        for g, c in zip(uniq.tolist(), counts.tolist()):
            h[g] = h.get(g, 0) + c

    def hot_rows(self, top: Optional[int] = None) -> np.ndarray:
        """The most-walked block rows, hottest first (empty until a plan ran
        with ``collect_row_hist``); ties keep the order rows were first walked."""
        if not self.row_hist:
            return np.zeros((0,), dtype=np.int64)
        rows = sorted(self.row_hist, key=self.row_hist.get, reverse=True)
        if top is not None:
            rows = rows[:int(top)]
        return np.asarray(rows, dtype=np.int64)

    def warm_cache(self, top: Optional[int] = 1024) -> int:
        """Prefetch the hottest probe-trace rows into the store's cache
        arena (each shard's own arena when the store is striped). Advisory:
        prefetch never touches the logical ``reads`` ledger. Returns the
        number of rows pushed."""
        rows = self.hot_rows(top)
        if rows.size:
            self.store.prefetch(rows)
        return int(rows.size)

    def close(self) -> None:
        self.store.close()
        _retire_external(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- registry glue: live indices + retired totals ---------------------------
_LIVE_EXTERNAL: "weakref.WeakSet" = weakref.WeakSet()
_RETIRED_TOTALS: dict = {}          # backend -> ExternalPlanTotals
_RETIRED_EXT_LOCK = threading.Lock()


def _retire_external(ext: "ExternalIndex") -> None:
    if getattr(ext, "_retired", True):
        return
    ext._retired = True
    _LIVE_EXTERNAL.discard(ext)
    with _RETIRED_EXT_LOCK:
        agg = _RETIRED_TOTALS.setdefault(ext.backend, ExternalPlanTotals())
        snap = ext.plan_totals.snapshot()
        for f in ExternalPlanTotals._SCALARS:
            setattr(agg, f, getattr(agg, f) + getattr(snap, f))
        for name in ("rung_blocks", "rung_entered"):
            mine = getattr(agg, name)
            for t, v in getattr(snap, name).items():
                mine[t] = mine.get(t, 0) + v


def _collect_external_metrics() -> dict:
    """Registry collector: the per-backend ExternalPlanTotals roll-up —
    call/query counts, the fetch/compute/overlap time split of the Eq. 6/7
    decomposition, and per-rung-position block counts."""
    with _RETIRED_EXT_LOCK:
        groups = {b: t.snapshot() for b, t in _RETIRED_TOTALS.items()}
    for ext in list(_LIVE_EXTERNAL):
        agg = groups.setdefault(ext.backend, ExternalPlanTotals())
        with _TOTALS_LOCK:
            snap = ext.plan_totals.snapshot()
        for f in ExternalPlanTotals._SCALARS:
            setattr(agg, f, getattr(agg, f) + getattr(snap, f))
        for name in ("rung_blocks", "rung_entered"):
            mine = getattr(agg, name)
            for t, v in getattr(snap, name).items():
                mine[t] = mine.get(t, 0) + v
    helps = dict(
        calls="external-plan calls",
        queries="real query rows served by the external plan",
        nio_blocks="logical block reads (measured N_io)",
        prefetch_rows="next-rung rows pushed to the cache",
        setup_ms="device setup + schedule transfer time",
        total_ms="end-to-end external-plan time",
        fetch_ms="host chain-walk time (block fetch + filter)",
        compute_wait_ms="host wait on the device fold after prefetch",
        overlap_ms="host prefetch time hidden under device compute",
    )
    out = {}
    for f in ExternalPlanTotals._SCALARS:
        out[f"e2lsh_external_{f}_total"] = dict(
            type="counter", help=helps[f],
            samples=[dict(labels={"backend": b}, value=getattr(t, f))
                     for b, t in sorted(groups.items())])
    for name, help_ in (("rung_blocks", "block reads per rung position"),
                        ("rung_entered", "times each rung position ran")):
        samples = []
        for b, tot in sorted(groups.items()):
            for t, v in sorted(getattr(tot, name).items()):
                samples.append(dict(labels={"backend": b, "t": str(t)},
                                    value=v))
        out[f"e2lsh_external_{name}_total"] = dict(
            type="counter", help=help_, samples=samples)
    return out


get_registry().register_collector(_collect_external_metrics,
                                  name="storage.external")


@dataclasses.dataclass
class RungStats:
    """One radius rung's fetch/compute overlap record."""

    t: int                  # radius index
    active_queries: int
    blocks_fetched: int     # logical block reads this rung
    fetch_ms: float         # host chain walk (block fetches + filtering)
    prefetch_rows: int      # next-rung rows pushed to the cache
    compute_wait_ms: float  # host wait on the device fold AFTER prefetching
    overlap_ms: float       # host prefetch time hidden under device compute


@dataclasses.dataclass
class ExternalPlanStats:
    """Per-call instrumentation of the external plan (the measured side of
    the Eq. 6/7 validation)."""

    backend: str
    queries: int
    rungs: list                     # [RungStats]
    io: StoreStats                  # store ledger DELTA for this call
    nio_blocks_counted: int         # sum of QueryResult.nio_blocks
    setup_ms: float = 0.0
    total_ms: float = 0.0

    @property
    def measured_nio_blocks(self) -> int:
        """Logical block reads the store served for this call — must equal
        ``nio_blocks_counted`` (and the io_count replay) exactly."""
        return self.io.reads

    @property
    def cache_hit_rate(self) -> float:
        return self.io.hit_rate

    @property
    def fetch_ms_total(self) -> float:
        return sum(r.fetch_ms for r in self.rungs)

    @property
    def compute_wait_ms_total(self) -> float:
        return sum(r.compute_wait_ms for r in self.rungs)

    @property
    def overlap_ms_total(self) -> float:
        return sum(r.overlap_ms for r in self.rungs)

    def as_dict(self) -> dict:
        return dict(
            backend=self.backend, queries=self.queries,
            measured_nio_blocks=self.measured_nio_blocks,
            nio_blocks_counted=self.nio_blocks_counted,
            cache_hit_rate=self.cache_hit_rate,
            device_reads=self.io.device_reads,
            prefetch_reads=self.io.prefetch_reads,
            setup_ms=self.setup_ms, total_ms=self.total_ms,
            fetch_ms_total=self.fetch_ms_total,
            compute_wait_ms_total=self.compute_wait_ms_total,
            overlap_ms_total=self.overlap_ms_total,
            rungs=[dataclasses.asdict(r) for r in self.rungs],
        )


# --------------------------------------------------------------------------
# Device side: the fold of one rung
# --------------------------------------------------------------------------

def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without a host sync: staged in pinned memory
    and copied non-blocking on the current stream (the caching host
    allocator keeps the staging buffer alive until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type != "cuda":
        return t
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.copy_(t)
    return pinned.to(dev, non_blocking=True)


def _fold(ext: "ExternalIndex", queries, qnorm2, state, buf_id, blocks_read, count,
          cnt_t, t: int, thresh2: float):
    """Step 3 for one rung: the fused plan's distance epilogue and state
    fold over host-fetched candidates. The candidate buffer, the two
    per-query counters and the rung's bucket sizes go up as one
    [Q, sbuf + 2 + L] int32 array in one copy; the distance kernel and the
    fold (``_update_state``: the ``topk_merge`` kernel on the card, which
    counts the non-empty buckets and writes the probe trace from the sizes;
    ``topk_merge_ref`` on the CPU) read its column slices in place."""
    sb = buf_id.shape[1]
    up = _upload(np.concatenate([buf_id, blocks_read[:, None], count[:, None], cnt_t],
                                axis=1).astype(np.int32, copy=False), queries.device)
    buf = up[:, :sb]
    d2 = l2_distance_by_id(queries, buf, ext.db, ext.db_norm2, qnorm2)
    return _update_state(state, buf, d2, up[:, sb + 2:], up[:, sb], up[:, sb + 1], t,
                         thresh2)


# --------------------------------------------------------------------------
# Host chain walk: the oracle's integer candidate selection, block rows
# served by the BlockStore instead of a device gather.
# --------------------------------------------------------------------------

def _append_candidates_np(buf_id, count, flat_id, flat_ok, S):
    """NumPy mirror of kernels.bucket_probe.ref.append_candidates (exact
    integer math)."""
    ok = flat_ok.astype(np.int32)
    pos = count[:, None] + np.cumsum(ok, axis=1) - ok
    keep = flat_ok & (pos < S)
    qi, ci = np.nonzero(keep)
    buf_id[qi, pos[qi, ci]] = flat_id[qi, ci]
    count = np.minimum(count + ok.sum(axis=1, dtype=np.int32), S)
    return buf_id, count.astype(np.int32)


def _walk_rung_host(store: BlockStore, cnt, head, qfp, active_q,
                    cfg: QueryConfig, blkp: int, sbuf: int, record=None):
    """One rung's chain walk. Fetches are batched per chain step (every
    still-active bucket's step-j row in ONE read_rows call — the deep queue
    the aio backend fans out), gated by the S budget exactly like the
    oracle: a chunk is read iff the bucket still has entries at this depth
    AND the query's candidate count entering the step is below S.
    ``record(rows)``, when given, sees each step's block rows before they are
    read (the probe trace). Returns (buf_id, count, blocks_read)."""
    Q, L = cnt.shape
    BLK, S = cfg.block_objs, cfg.S
    nonempty = (cnt > 0) & active_q[:, None]
    buf_id = np.full((Q, sbuf), _INVALID, dtype=np.int32)
    count = np.zeros((Q,), dtype=np.int32)
    blocks_read = np.zeros((Q,), dtype=np.int32)
    slots = np.arange(blkp)
    for step in range(cfg.max_chain):
        active = nonempty & (cnt > step * BLK) & (count < S)[:, None]
        if not active.any():
            break
        qi, li = np.nonzero(active)
        step_rows = head[qi, li] + step
        if record is not None:
            record(step_rows)
        ids_rows, fps_rows = store.read_rows(step_rows)
        blocks_read += active.sum(axis=1, dtype=np.int32)
        # fingerprint filter (padding slots hold fp=-1 / id=INVALID, so the
        # match test alone reproduces bucket_probe_ref's semantics), scattered
        # back to the oracle's (l, slot) flat order before the append
        ok = (fps_rows == qfp[qi, li][:, None]) & (ids_rows != _INVALID)
        flat_id = np.full((Q, L * blkp), _INVALID, dtype=np.int32)
        flat_ok = np.zeros((Q, L * blkp), dtype=bool)
        cols = li[:, None] * blkp + slots[None, :]
        flat_id[qi[:, None], cols] = ids_rows
        flat_ok[qi[:, None], cols] = ok
        buf_id, count = _append_candidates_np(buf_id, count, flat_id,
                                              flat_ok, S)
    return buf_id, count, blocks_read


# --------------------------------------------------------------------------
# The plan
# --------------------------------------------------------------------------

def _prefetch_next(ext: "ExternalIndex", cnt_next, head_next, active_q,
                   cfg: QueryConfig) -> int:
    """Push the next rung's first ``prefetch_depth`` chain-step rows of the
    still-active queries into the store's queue. Returns the rows pushed."""
    nxt = (cnt_next > 0) & active_q[:, None]
    depth = max(1, int(ext.prefetch_depth))
    nxt_cnt = cnt_next[nxt]
    nxt_head = head_next[nxt]
    rows = [nxt_head]
    for j in range(1, min(depth, cfg.max_chain)):
        deeper = nxt_cnt > j * cfg.block_objs
        if not deeper.any():
            break
        rows.append(nxt_head[deeper] + j)
    rows = np.concatenate(rows) if len(rows) > 1 else rows[0]
    if rows.size:
        ext.store.prefetch(rows)
    return int(rows.size)


def external_probe_stage(ext: "ExternalIndex", queries, qnorm2, cnt_np, head_np,
                         qfp_np, cfg: QueryConfig, valid=None):
    """Steps 2-3, rung by rung, over the hash stage's [r, Q, L] results on
    the host (a test may pass the reference's). Returns (state, [RungStats])."""
    tracer = get_tracer()
    dev = queries.device
    Q = queries.shape[0]
    r = len(cfg.radii)
    sbuf = _fused_sbuf(cfg)
    state = _init_state(Q, cfg, dev, valid)
    thresh2 = _thresholds(cfg)
    done_np = state[2].cpu().numpy()
    qfp_np = np.asarray(qfp_np).astype(np.int64)
    rungs = []
    for t in range(r):
        if done_np.all():
            break
        active_q = ~done_np
        rsp = tracer.begin("external.rung", t=t, radius=float(cfg.radii[t]),
                           active=int(active_q.sum()))
        blocks_read = np.zeros((Q,), dtype=np.int32)
        n_prefetch = 0
        try:
            t0 = time.perf_counter()
            buf_id, count, blocks_read = _walk_rung_host(
                ext.store, cnt_np[t], head_np[t], qfp_np[t], active_q, cfg,
                ext.blkp, sbuf,
                record=ext.record_probe_rows if ext.collect_row_hist else None)
            t1 = time.perf_counter()
            # launch the fold (returns at once) ...
            with tracer.span("external.fold_dispatch", t=t):
                state = _fold(ext, queries, qnorm2, state, buf_id, blocks_read, count,
                              cnt_np[t], t, thresh2[t])
            # ... and hide the next rung's chain reads under it
            if t + 1 < r:
                n_prefetch = _prefetch_next(ext, cnt_np[t + 1], head_np[t + 1],
                                            active_q, cfg)
            t2 = time.perf_counter()
            with tracer.span("external.fold_wait", t=t):
                done_np = state[2].cpu().numpy()   # blocks on the fold
            t3 = time.perf_counter()
            rungs.append(RungStats(
                t=t, active_queries=int(active_q.sum()),
                blocks_fetched=int(blocks_read.sum()),
                fetch_ms=(t1 - t0) * 1e3, prefetch_rows=n_prefetch,
                overlap_ms=(t2 - t1) * 1e3, compute_wait_ms=(t3 - t2) * 1e3))
        finally:
            rsp.set(blocks_fetched=int(blocks_read.sum()), prefetch_rows=n_prefetch)
            rsp.end()
    return state, rungs


def external_plan(ext: "ExternalIndex", queries, cfg: QueryConfig,
                  valid=None) -> QueryResult:
    """Run a query batch from storage. Semantics identical to
    ``plan="fused"``; the block store is the only data source for bucket
    rows. Records per-call instrumentation on ``ext.last_plan_stats`` and
    folds it into ``ext.plan_totals``."""
    if cfg.block_objs != ext.block_objs:
        raise ValueError(
            f"spilled store is laid out at block_objs={ext.block_objs} but "
            f"the query plan wants {cfg.block_objs}; re-spill the index at "
            "the desired block size (the on-disk layout cannot be repacked "
            "in place)")
    t_start = time.perf_counter()
    io_base = ext.store.stats.snapshot()
    tracer = get_tracer()
    root = tracer.begin("plan.external", backend=ext.backend)
    try:
        dev = ext.device
        if not torch.is_tensor(queries):
            queries = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
        queries = queries.to(dev, torch.float32)
        if valid is not None:
            if not torch.is_tensor(valid):
                valid = torch.from_numpy(np.asarray(valid, dtype=bool))
            valid = valid.to(dev, torch.bool)
        queries, valid, realQ = _pad_min_q(queries, valid)
        with tracer.span("external.setup"):
            queries, qnorm2 = _prep_queries(queries)
            cnt_all, head_all, qfp_all = hash_stage(ext, queries, cfg)
            # the chain-walk plan comes to the host once for the whole schedule
            cnt_np, head_np, qfp_np = (x.cpu().numpy()
                                       for x in (cnt_all, head_all, qfp_all))
        setup_ms = (time.perf_counter() - t_start) * 1e3
        state, rungs = external_probe_stage(ext, queries, qnorm2, cnt_np, head_np,
                                            qfp_np, cfg, valid)
        res = _result_from_state(state, cfg, valid).slice_rows(0, realQ)
        ps = ExternalPlanStats(
            backend=ext.backend, queries=realQ, rungs=rungs,
            io=ext.store.stats.since(io_base),
            nio_blocks_counted=int(res.nio_blocks.sum()),
            setup_ms=setup_ms, total_ms=(time.perf_counter() - t_start) * 1e3)
        ext.last_plan_stats = ps
        with _TOTALS_LOCK:       # accumulate, never overwrite (queue-safe)
            ext.plan_totals.add(ps)
        root.set(queries=realQ, rungs=len(rungs), nio_blocks=ps.io.reads)
        return res
    finally:
        root.end()

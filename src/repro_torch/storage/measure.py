"""Measured sync-vs-async harness: run the REAL backends on a spilled
index and put the numbers next to the Eq. 6/7 model.

This is the measurement half of the paper's Fig. 4-8/11 story — the repo
can *model* T_sync/T_async (core.storage) and now also measures both
disciplines on the same index and the same query batch:

* ``mmap``  — synchronous QD1 block reads (Sec. 6.5's slow baseline),
* ``aio``   — thread-pool pread fan-out (the portable async emulation),
* ``uring`` — io_uring wave submission + O_DIRECT (the paper's actual
  design, where the kernel/filesystem supports it),

and reports the measured slowdown, cache hit rate, and measured N_io
(which must equal the Eq. 6/7 replay). Every timed batch ends in a
``torch.cuda.synchronize()`` on the index's device, so a time includes the
device work it launched.

Measurement discipline (the cold-cache methodology of docs/storage.md):

* **Timing** is best-of-k: a warmup pass builds and warms every cache,
  then each backend is timed ``repeats`` times and the MINIMUM is the
  published number (min/median/max all reported). Single-run comparisons
  on a page-cached spill wobble 1.2-1.5x run to run — best-of-k is what
  makes the sync-vs-async assertion stable on a noisy box.
* **cache_mode="warm"** (default) times repeat traffic on a warm page
  cache + warm store cache: the request-handling comparison, safe
  everywhere.
* **cache_mode="cold"** re-opens the store before every timed repeat
  (empty user-level cache) and drops the spill's page-cache pages
  (``posix_fadvise(DONTNEED)``) so demand reads hit the device — the
  measured latency is storage latency, not DRAM. ``cold_effective``
  reports the page-cache residency actually achieved (``mincore``): on
  filesystems where fadvise cannot evict (e.g. tmpfs) the number says so
  instead of silently publishing DRAM reads as device reads. The
  ``uring`` backend adds O_DIRECT on top: demand reads bypass the page
  cache entirely, cold by construction.

Model-vs-measured caveat (recorded in the output): the model's device
constants are the paper's SSDs (Table 2); the harness runs on whatever
backs the spill path, so the RATIO of the two is the meaningful
comparison, not the absolute microseconds.
"""
from __future__ import annotations

import ctypes
import mmap as _mmap
import os
import statistics
import time

import numpy as np
import torch

from ..core.storage import (DEVICES, INTERFACES, StorageConfig, model_qd_sweep,
                            t_async, t_sync)
from .format import load_external, read_header

__all__ = ["measure_backends", "heavy_bucket_workload", "qd_sweep",
           "drop_page_cache", "page_cache_residency",
           "DEFAULT_MODEL_CONFIG", "HEAVY_SPEC", "SWEEP_QDS"]

DEFAULT_MODEL_CONFIG = StorageConfig(DEVICES["cssd"], 4,
                                     INTERFACES["io_uring"])

# The canonical I/O-heavy measurement shape (the paper's storage-bound
# regime): few heavy clusters -> big buckets, deep S budget -> long chains,
# so the I/O discipline dominates what can differ between backends.
HEAVY_SPEC = dict(n=12000, d=8, centers=6, max_L=24, s_cap=512,
                  queries=128, qd=32)

# default queue-depth axis of the measured sweep (paper Fig. 11 runs
# 1..128; the useful knee on one consumer device sits well below that)
SWEEP_QDS = (1, 2, 4, 8, 16, 32)


# --------------------------------------------------------------------------
# Page-cache control (the cache-defeating knobs)
# --------------------------------------------------------------------------

def drop_page_cache(path) -> bool:
    """Ask the kernel to evict ``path``'s page-cache pages
    (``POSIX_FADV_DONTNEED``, no privileges needed). Returns False where
    the call is unsupported; whether pages actually LEFT the cache is what
    :func:`page_cache_residency` reports (tmpfs, for one, keeps them)."""
    if not hasattr(os, "posix_fadvise"):
        return False
    fd = os.open(os.fspath(path), os.O_RDONLY)
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        return True
    except OSError:
        return False
    finally:
        os.close(fd)


def page_cache_residency(path, offset: int = 0, length: int = None) -> float:
    """Fraction of ``path``'s byte range currently resident in the page
    cache (``mincore``). The honesty meter of cold-cache mode: 0.0 means
    demand reads will hit the device, ~1.0 means they will hit DRAM."""
    path = os.fspath(path)
    size = os.path.getsize(path)
    if length is None:
        length = size - offset
    length = max(0, min(length, size - offset))
    if length == 0:
        return 0.0
    page = _mmap.PAGESIZE
    # mincore wants a page-aligned mapping; map the containing page range
    astart = (offset // page) * page
    alen = offset + length - astart
    npages = -(-alen // page)
    with open(path, "rb") as f:
        try:
            # MAP_PRIVATE read-write so ctypes can take the address; pages
            # stay shared with the page cache until written (never here)
            mm = _mmap.mmap(f.fileno(), alen, flags=_mmap.MAP_PRIVATE,
                            prot=_mmap.PROT_READ | _mmap.PROT_WRITE,
                            offset=astart)
        except (ValueError, OSError):
            return float("nan")
    try:
        vec = (ctypes.c_ubyte * npages)()
        addr = ctypes.addressof(ctypes.c_char.from_buffer(mm))
        libc = ctypes.CDLL(None, use_errno=True)
        if libc.mincore(ctypes.c_void_p(addr), ctypes.c_size_t(alen),
                        vec) != 0:
            return float("nan")
        resident = sum(v & 1 for v in vec)
        return resident / npages
    finally:
        # the ctypes from_buffer export pins the mmap (close() would raise
        # BufferError); drop both references and let GC release them
        vec = None
        mm = None


# --------------------------------------------------------------------------
# Workload + timing
# --------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def heavy_bucket_workload(spec: dict = None, *, seed: int = 1, device=None):
    """Build the clustered heavy-bucket dataset + index of ``spec``
    (defaults: HEAVY_SPEC) on ``device`` (None -> cuda). Returns (E2LSHoS
    index, queries [Q, d])."""
    from ..core.e2lshos import E2LSHoS

    spec = dict(HEAVY_SPEC, **(spec or {}))
    rng = np.random.default_rng(seed)
    n, d, Q = spec["n"], spec["d"], spec["queries"]
    centers = rng.normal(size=(spec["centers"], d)).astype(np.float32)
    db = (centers[rng.integers(0, spec["centers"], n)]
          + 0.12 * rng.normal(size=(n, d))).astype(np.float32)
    qs = (db[rng.choice(n, Q, replace=False)]
          + 0.04 * rng.normal(size=(Q, d))).astype(np.float32)
    s = float(np.median(np.linalg.norm(db - db.mean(0), axis=1))) / 3
    idx = E2LSHoS.build(db / s, gamma=0.7, s_scale=2.0,
                        max_L=spec["max_L"], seed=seed, device=device)
    return idx, qs / s


def _time_backend(path, queries, *, backend: str, qd: int, k: int,
                  s_cap, repeats: int, warmup: int = 1,
                  cache_mode: str = "warm", direct: bool = True,
                  block_objs: int = None, prefetch_depth: int = 1,
                  device=None) -> dict:
    """Best-of-k timing of one backend on one spilled index.

    ``cache_mode="cold"``: the store is re-opened (empty user cache) and
    the spill's page-cache pages dropped before EVERY timed repeat, so each
    repeat pays demand I/O; ``cold_effective`` records the post-drop
    residency of the blocks section (1 - this is how cold the run really
    was). ``warm``: one store serves warmup + all repeats. Each timed
    repeat ends in a device synchronize.
    """
    from ..core.query import SearchEngine

    if cache_mode not in ("warm", "cold"):
        raise ValueError(f"unknown cache_mode {cache_mode!r}")
    cold = cache_mode == "cold"
    hdr = read_header(path)
    blocks_off = hdr.blocks_offset
    blocks_len = int(hdr.sections["blocks"]["nbytes"])
    kw = {} if block_objs is None else dict(block_objs=int(block_objs))

    def open_engine():
        # NOTE: the store cache stays enabled in cold mode — within one
        # batch, caching + prefetch are the async discipline being measured;
        # what cold mode defeats is residual state BETWEEN repeats (re-open
        # resets the user cache, fadvise/O_DIRECT handle the page cache)
        ext = load_external(path, backend=backend, qd=qd, direct=direct,
                            prefetch_depth=prefetch_depth, device=device)
        engine = SearchEngine(ext)
        _, fn = engine.make_plan_fn(plan="external", k=k, s_cap=s_cap, **kw)
        return ext, engine, fn

    ext, engine, fn = open_engine()
    times, cold_resid = [], []
    try:
        for _ in range(max(1, warmup)):
            res = fn(queries)                  # load kernels, warm every cache
        for _ in range(repeats):
            if cold:
                ext.close()
                ext, engine, fn = open_engine()
                drop_page_cache(path)
                cold_resid.append(
                    page_cache_residency(path, blocks_off, blocks_len))
            t0 = time.perf_counter()
            res = fn(queries)
            _sync(ext.device)
            times.append(time.perf_counter() - t0)
        ps = engine.external.last_plan_stats
        store = ext.store
        best = min(times)
        return dict(
            backend=ps.backend,
            requested_backend=backend,
            o_direct=bool(getattr(store, "o_direct", False)),
            fallback_reason=getattr(store, "fallback_reason", None),
            cache_mode=cache_mode,
            cold_effective=(1.0 - float(np.nanmean(cold_resid))
                            if cold_resid else None),
            t_batch_ms=best * 1e3,
            t_batch_ms_median=statistics.median(times) * 1e3,
            t_batch_ms_max=max(times) * 1e3,
            t_query_us=best / queries.shape[0] * 1e6,
            t_query_us_median=(statistics.median(times)
                               / queries.shape[0] * 1e6),
            measured_nio_blocks=ps.measured_nio_blocks,
            nio_mean=float(res.nio.float().mean()),
            cache_hit_rate=ps.cache_hit_rate,
            device_reads=ps.io.device_reads,
            prefetch_reads=ps.io.prefetch_reads,
            fetch_ms=ps.fetch_ms_total,
            compute_wait_ms=ps.compute_wait_ms_total,
            result=res,
        )
    finally:
        ext.close()


def _fused_t_compute(idx, queries, *, k: int, s_cap, repeats: int) -> float:
    """Best-of seconds per query of the in-memory fused plan on the index's
    device (the Eq. 6/7 model's T_compute)."""
    from ..core.query import SearchEngine

    dev = idx.arrays.device
    _, fused = SearchEngine(idx, device=dev).make_plan_fn(plan="fused", k=k,
                                                          s_cap=s_cap)
    fused(queries)
    _sync(dev)
    times = []
    for _ in range(max(3, repeats)):
        t0 = time.perf_counter()
        fused(queries)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return min(times) / queries.shape[0]


def _resolve_async_backend(requested=None) -> str:
    """The async side of a measurement: ``uring`` when the box can run it,
    else the ``aio`` emulation — resolved EXPLICITLY (not via make_store's
    silent fallback) so reports name what was actually measured."""
    if requested is not None:
        return requested
    from .uring import probe_io_uring
    return "uring" if probe_io_uring()[0] else "aio"


def measure_backends(index, queries, *, spill_path, k: int = 1,
                     s_cap=None, qd: int = 16, repeats: int = 5,
                     warmup: int = 1, cache_mode: str = "warm",
                     async_backend: str = None,
                     model_config: StorageConfig = DEFAULT_MODEL_CONFIG,
                     t_compute: float = None) -> dict:
    """Spill ``index`` (an E2LSHoS / E2LSHIndex) to ``spill_path``, run the
    query batch through the mmap (sync) and the async backend (``uring``
    where available, else ``aio``), and return measured + modeled numbers
    side by side. Timings are best-of-``repeats`` after ``warmup`` passes;
    ``cache_mode="cold"`` engages the cache-defeating methodology (module
    docstring).

    ``t_compute`` (seconds/query) feeds the Eq. 6/7 model; when None it is
    measured from the in-memory fused plan on the same batch.
    """
    idx = index.index if hasattr(index, "index") else index
    idx.spill(spill_path)
    queries = np.asarray(queries, dtype=np.float32)
    async_backend = _resolve_async_backend(async_backend)

    if t_compute is None:
        t_compute = _fused_t_compute(idx, queries, k=k, s_cap=s_cap,
                                     repeats=repeats)

    common = dict(k=k, s_cap=s_cap, repeats=repeats, warmup=warmup,
                  cache_mode=cache_mode, device=idx.arrays.device)
    sync = _time_backend(spill_path, queries, backend="mmap", qd=1, **common)
    async_ = _time_backend(spill_path, queries, backend=async_backend,
                           qd=qd, **common)
    # the two disciplines read the same logical blocks — the ledger the
    # model consumes is identical by construction
    assert sync["measured_nio_blocks"] == async_["measured_nio_blocks"], (
        sync["measured_nio_blocks"], async_["measured_nio_blocks"])

    nio = sync["nio_mean"]
    model_sync_s = t_sync(t_compute, nio, model_config)
    model_async_s = t_async(t_compute, nio, model_config)
    measured_slowdown = sync["t_query_us"] / async_["t_query_us"]
    for d in (sync, async_):
        d.pop("result")
    return dict(
        queries=int(queries.shape[0]),
        qd=qd,
        cache_mode=cache_mode,
        async_backend=async_["backend"],
        t_compute_us=t_compute * 1e6,
        sync=sync,
        async_=async_,
        measured_slowdown_sync_vs_async=measured_slowdown,
        model=dict(
            config=model_config.name,
            t_sync_us=model_sync_s * 1e6,
            t_async_us=model_async_s * 1e6,
            slowdown_sync_vs_async=model_sync_s / model_async_s,
        ),
        model_vs_measured_slowdown_ratio=(
            (model_sync_s / model_async_s) / measured_slowdown),
    )


# --------------------------------------------------------------------------
# The measured QD x block-size sweep (paper Figs. 4-8 / 11, from data)
# --------------------------------------------------------------------------

def qd_sweep(index, queries, *, spill_path, qds=SWEEP_QDS, k: int = 1,
             s_cap=None, repeats: int = 5, warmup: int = 1,
             cache_mode: str = "cold", async_backend: str = None,
             block_objs_list=None, prefetch_depth: int = 2,
             model_config: StorageConfig = DEFAULT_MODEL_CONFIG,
             t_compute: float = None) -> dict:
    """Measure T_async as a function of queue depth (and optionally block
    size) against the fixed T_sync baseline — the paper's IOPS-requirement
    curves (Figs. 4-8) reproduced from measured data.

    Per block size: the index is (re-)spilled at that ``block_objs``, the
    sync baseline (``mmap`` QD1) is timed best-of-k, then the async
    backend is timed at every ``qd``. Each point reports best/median/max
    latency, measured IOPS (logical block reads per second of wall time),
    the measured sync/async ratio, and the Eq. 6/7 model evaluated AT THAT
    queue depth (``t_async_at_qd``) and the same measured N_io.
    ``cache_mode="cold"`` (default here, unlike ``measure_backends``) is
    what makes the QD axis mean device queue depth rather than page-cache
    copy bandwidth.
    """
    import pathlib

    idx = index.index if hasattr(index, "index") else index
    queries = np.asarray(queries, dtype=np.float32)
    async_backend = _resolve_async_backend(async_backend)
    spill_path = pathlib.Path(spill_path)
    native_bo = int(idx.arrays.block_objs)
    bos = [native_bo] if not block_objs_list else [int(b)
                                                  for b in block_objs_list]

    if t_compute is None:
        t_compute = _fused_t_compute(idx, queries, k=k, s_cap=s_cap,
                                     repeats=repeats)

    curves = []
    for bo in bos:
        if bo == native_bo:
            path = spill_path
            idx.spill(path)
        else:
            from .format import spill_index
            path = spill_path.with_suffix(f".bo{bo}")
            spill_index(path, idx.arrays.with_block_objs(bo),
                        params=idx.params, stats=idx.stats)
        common = dict(k=k, s_cap=s_cap, repeats=repeats, warmup=warmup,
                      cache_mode=cache_mode, block_objs=bo,
                      prefetch_depth=prefetch_depth, device=idx.arrays.device)
        sync = _time_backend(path, queries, backend="mmap", qd=1, **common)
        sync.pop("result")
        nio = sync["nio_mean"]
        nio_total = sync["measured_nio_blocks"]
        model = model_qd_sweep(t_compute, nio, model_config, qds)
        points = []
        for qd, mq in zip(qds, model):
            p = _time_backend(path, queries, backend=async_backend, qd=qd,
                              **common)
            p.pop("result")
            assert p["measured_nio_blocks"] == nio_total, (
                "logical N_io changed across the sweep: "
                f"{p['measured_nio_blocks']} != {nio_total}")
            p.update(
                qd=int(qd),
                iops_measured=nio_total / (p["t_batch_ms"] / 1e3),
                slowdown_sync_vs_async=(sync["t_query_us"]
                                        / p["t_query_us"]),
                model_t_async_us=mq["t_async_us"],
                model_slowdown_sync_vs_async=mq["slowdown_sync_vs_async"],
                model_device_iops=mq["device_iops"],
            )
            points.append(p)
        curves.append(dict(
            block_objs=bo,
            block_bytes=2 * read_header(path).blkp * 4,
            nio_per_query=nio,
            measured_nio_blocks=nio_total,
            sync=sync,
            iops_sync=nio_total / (sync["t_batch_ms"] / 1e3),
            points=points,
        ))
    return dict(
        queries=int(queries.shape[0]),
        qds=[int(q) for q in qds],
        cache_mode=cache_mode,
        async_backend=async_backend,
        t_compute_us=t_compute * 1e6,
        model_config=model_config.name,
        curves=curves,
    )

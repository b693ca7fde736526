"""Pluggable block-store backends: where bucket block reads actually go.

The external query plan asks one question per chain rung: "give me these
block rows" (each row = one paper block: ids + fingerprints of up to
``block_objs`` object infos). The backends answer it with the I/O
disciplines the paper compares:

* ``mem``  — the block store lives in RAM (current in-memory behavior; the
  parity oracle for the external plan).
* ``mmap`` — memory-mapped file, one synchronous read per block in request
  order: queue depth 1, every read blocks before the next is issued. This
  is the paper's Sec. 6.5 slow baseline — T_sync of Eq. 6.
* ``aio``  — asynchronous *emulation*: a batch of block reads is
  deduplicated against a clock page cache and the misses are spread across
  a ``qd``-wide pread thread pool (paper Table 3 / Fig. 11's QD128 lane —
  T_async of Eq. 7 — approximated with one syscall per read through the
  page cache). Portable everywhere.
* ``uring`` — the real thing (:mod:`repro_torch.storage.uring`): misses are
  submitted to the kernel through io_uring in waves of ``qd`` — one
  syscall per wave, ``qd`` reads in flight at the device — with O_DIRECT
  file access where the filesystem allows it, so demand reads bypass the
  page cache and measured latency is device latency. Gated by
  :func:`repro_torch.storage.uring.capabilities`; ``make_store`` falls back to
  ``aio`` when the kernel or filesystem can't do it.

``aio`` and ``uring`` share one cache/accounting engine
(:class:`CachedBlockStore`) and differ ONLY in how a miss batch reaches
the device — which is exactly the variable the paper's sync-vs-async
comparison isolates. Every backend counts the same ledger
(:class:`StoreStats`): ``reads`` is the *logical* block-read count — the
measured N_io the Eq. 6/7 validation compares against
``io_count.replay_probe_trace`` — while ``device_reads``/``cache_hits``/
``prefetch_reads`` describe where those reads were served. Duplicate rows
inside one batch coalesce in the cache (counted as hits): that is
precisely the page-cache effect the paper's mmap discussion describes,
and it never changes the logical count.

Env override: ``REPRO_STORE_BACKEND=mem|mmap|aio|uring`` forces every
``make_store`` call onto one backend regardless of what the caller asked
for, so any test or CLI entry point can be pinned to a backend without
threading a flag through it. It picks a storage backend only: it never
changes which device or kernel runs.
"""
from __future__ import annotations

import dataclasses
import mmap
import os
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..telemetry import get_registry, get_tracer

__all__ = ["StoreStats", "BlockStore", "MemBlockStore", "MmapBlockStore",
           "CachedBlockStore", "AioBlockStore", "make_store", "BACKENDS",
           "STORE_BACKEND_ENV", "store_backend_env"]

BACKENDS = ("mem", "mmap", "aio", "uring")

STORE_BACKEND_ENV = "REPRO_STORE_BACKEND"


def store_backend_env() -> Optional[str]:
    """The forced backend from ``REPRO_STORE_BACKEND``, or None. Unknown
    values raise here (a typo'd lane must fail loudly, not silently run the
    default backend)."""
    forced = os.environ.get(STORE_BACKEND_ENV, "").strip().lower()
    if not forced:
        return None
    if forced not in BACKENDS:
        raise ValueError(
            f"{STORE_BACKEND_ENV}={forced!r} is not a block-store backend; "
            f"expected one of {BACKENDS}")
    return forced


@dataclasses.dataclass
class StoreStats:
    """Cumulative I/O ledger of one store (see module docstring)."""

    reads: int = 0            # logical block reads requested (measured N_io)
    device_reads: int = 0     # demand reads served by the backing store
    cache_hits: int = 0       # reads served from the page cache
    prefetch_reads: int = 0   # speculative reads issued by prefetch()
    read_batches: int = 0     # read_rows() calls

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / self.reads if self.reads else 0.0

    def snapshot(self) -> "StoreStats":
        return dataclasses.replace(self)

    def since(self, base: "StoreStats") -> "StoreStats":
        return StoreStats(**{f.name: getattr(self, f.name) - getattr(base, f.name)
                             for f in dataclasses.fields(StoreStats)})

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        return d


class BlockStore:
    """Backend protocol. ``read_rows(rows) -> (ids [G, BLKp], fps [G, BLKp])``
    int32; row indices address the interleaved ``blocks`` section (row 0 is
    the guaranteed-empty spare). ``prefetch(rows)`` is advisory and must not
    change the logical ``reads`` count.

    Backends implement ``_read_rows_impl``/``_prefetch_impl``; the public
    entry points here are the telemetry seam — when tracing is on, every
    read batch becomes one ``store.read`` span whose ``rows`` attribute is
    the LEDGER delta (so span sums tie out against measured N_io exactly),
    and every prefetch a ``store.prefetch`` span on the speculative lane.
    Live stores feed the metrics registry through a weak-set collector;
    ``close()`` folds the final ledger into the per-backend retired totals
    so registry counters stay monotonic across store lifetimes.
    """

    name: str = "base"
    blkp: int
    nb: int

    def __init__(self):
        self.stats = StoreStats()
        self.telemetry_labels: dict = {}
        self._retired = False
        _LIVE_STORES.add(self)

    def _read_rows_impl(self, rows: np.ndarray):
        raise NotImplementedError

    def _prefetch_impl(self, rows: np.ndarray) -> None:  # advisory no-op
        return None

    def read_rows(self, rows: np.ndarray):
        tr = get_tracer()
        if not tr.enabled:
            return self._read_rows_impl(rows)
        st = self.stats
        r0, h0, d0 = st.reads, st.cache_hits, st.device_reads
        with tr.span("store.read", backend=self.name,
                     **self.telemetry_labels) as sp:
            out = self._read_rows_impl(rows)
            sp.set(rows=st.reads - r0, cache_hits=st.cache_hits - h0,
                   device_reads=st.device_reads - d0)
        return out

    def prefetch(self, rows: np.ndarray) -> None:
        tr = get_tracer()
        if not tr.enabled:
            return self._prefetch_impl(rows)
        p0 = self.stats.prefetch_reads
        with tr.span("store.prefetch", backend=self.name,
                     **self.telemetry_labels) as sp:
            out = self._prefetch_impl(rows)
            sp.set(rows=self.stats.prefetch_reads - p0)
        return out

    def close(self) -> None:
        _retire_store(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- registry glue: live stores + retired ledgers --------------------------
_LIVE_STORES: "weakref.WeakSet" = weakref.WeakSet()
_RETIRED_STATS: dict = {}           # (backend, shard) -> StoreStats totals
_RETIRED_LOCK = threading.Lock()

_STORE_COUNTER_HELP = {
    "reads": "logical block reads (measured N_io)",
    "device_reads": "demand reads served by the backing device",
    "cache_hits": "reads served from the store page cache",
    "prefetch_reads": "speculative reads on the prefetch lane",
    "read_batches": "read_rows() batches",
}


def _retire_store(st: "BlockStore") -> None:
    """Fold a closing store's ledger into the per-backend retired totals
    (idempotent), so registry counters survive the object."""
    if getattr(st, "_retired", True):
        return
    st._retired = True
    _LIVE_STORES.discard(st)
    key = (st.name, st.telemetry_labels.get("shard"))
    with _RETIRED_LOCK:
        agg = _RETIRED_STATS.setdefault(key, StoreStats())
        for f in dataclasses.fields(StoreStats):
            setattr(agg, f.name,
                    getattr(agg, f.name) + getattr(st.stats, f.name))


def _collect_store_metrics() -> dict:
    """Registry collector: per-(backend, shard) StoreStats roll-up over
    live stores + retired totals. The ledgers stay the source of truth —
    this is a read-only window, so ``reads == device_reads + cache_hits``
    holds in the registry iff it holds in the ledgers."""
    with _RETIRED_LOCK:
        groups = {k: s.snapshot() for k, s in _RETIRED_STATS.items()}
    for st in list(_LIVE_STORES):
        key = (st.name, st.telemetry_labels.get("shard"))
        agg = groups.setdefault(key, StoreStats())
        snap = st.stats.snapshot()
        for f in dataclasses.fields(StoreStats):
            setattr(agg, f.name, getattr(agg, f.name) + getattr(snap, f.name))
    out = {}
    for field, help_ in _STORE_COUNTER_HELP.items():
        samples = []
        for (backend, shard), agg in sorted(
                groups.items(), key=lambda kv: (kv[0][0], kv[0][1] or "")):
            labels = {"backend": backend}
            if shard is not None:
                labels["shard"] = shard
            samples.append(dict(labels=labels, value=getattr(agg, field)))
        out[f"e2lsh_store_{field}_total"] = dict(
            type="counter", help=help_, samples=samples)
    return out


get_registry().register_collector(_collect_store_metrics,
                                  name="storage.blockstore")


class MemBlockStore(BlockStore):
    """The block store in RAM — the external plan's parity oracle (identical
    semantics to the in-memory plans, same counters as the disk backends)."""

    name = "mem"

    def __init__(self, blocks: np.ndarray):
        super().__init__()
        assert blocks.ndim == 3 and blocks.shape[1] == 2, blocks.shape
        self._blocks = np.ascontiguousarray(blocks, dtype=np.int32)
        self.nb, _, self.blkp = blocks.shape

    def _read_rows_impl(self, rows):
        rows = np.asarray(rows, dtype=np.int64).ravel()
        out = self._blocks[rows]
        self.stats.reads += int(rows.size)
        self.stats.device_reads += int(rows.size)
        self.stats.read_batches += 1
        return out[:, 0], out[:, 1]


class MmapBlockStore(BlockStore):
    """Synchronous memory-mapped reads at queue depth 1 (paper Sec. 6.5).

    Each requested block is copied out of the mapping one at a time, in
    request order — read, wait, read — so a rung's fetch time is the serial
    sum of per-block read+request costs: the T_sync discipline of Eq. 6.
    No user-level cache (the kernel page cache is the only one), matching
    the paper's mmap comparison point.
    """

    name = "mmap"

    def __init__(self, path, offset: int, nb: int, blkp: int):
        super().__init__()
        self.nb, self.blkp = int(nb), int(blkp)
        self._mm = np.memmap(path, dtype=np.int32, mode="r",
                             offset=int(offset), shape=(self.nb, 2, self.blkp))
        # chain reads are random: tell the kernel so readahead doesn't
        # prefetch neighbors and quietly turn the QD1 baseline into a
        # sequential scan on a cold cache (no-op for already-cached pages)
        try:
            self._mm._mmap.madvise(mmap.MADV_RANDOM)
        except (AttributeError, OSError, ValueError):
            pass

    def _read_rows_impl(self, rows):
        rows = np.asarray(rows, dtype=np.int64).ravel()
        out = np.empty((rows.size, 2, self.blkp), dtype=np.int32)
        for i, g in enumerate(rows):        # strictly sequential: QD1
            out[i] = self._mm[int(g)]
        self.stats.reads += int(rows.size)
        self.stats.device_reads += int(rows.size)
        self.stats.read_batches += 1
        return out[:, 0], out[:, 1]

    def close(self):
        self._mm = None
        _retire_store(self)


class CachedBlockStore(BlockStore):
    """The shared async-backend engine: clock page cache + miss batching +
    in-flight prefetch joining + the StoreStats ledger.

    A batch of block reads resolves in three phases: (1) one VECTORIZED
    cache lookup — the cache is a preallocated ``[cap, 2, BLKp]`` arena
    with a row->slot map, so a warm batch is a single numpy gather, not a
    per-row walk (duplicates inside the batch coalesce; each saved device
    read counts as a hit); (2) unique misses go to the device through the
    subclass hooks; (3) results land in the arena under the clock policy.
    ``prefetch`` issues the same device path without blocking; in-flight
    prefetches are joined (not re-read) when a demand read wants the same
    rows.

    Subclass hooks: ``_read_chunk(rows) -> {row: [2, BLKp]}`` performs the
    actual device reads for one chunk, and ``_device_chunks(rows)`` splits
    a miss batch into the chunks the device path wants (``aio``: one chunk
    per pool worker; ``uring``: one chunk, the ring is the fan-out).
    ``workers`` sizes the submitter pool.
    """

    def __init__(self, nb: int, blkp: int, *, qd: int,
                 cache_rows: Optional[int] = None, workers: int = None):
        super().__init__()
        if qd <= 0:
            raise ValueError(f"queue depth must be positive, got {qd}")
        self.nb, self.blkp = int(nb), int(blkp)
        self.qd = int(qd)
        cap = (max(1024, self.nb // 8) if cache_rows is None
               else int(cache_rows))
        self.cache_rows = cap = max(0, min(cap, self.nb))
        # clock-cache arena: slot_of[row] -> slot (-1 = not cached)
        self._arena = np.empty((cap, 2, self.blkp), dtype=np.int32)
        self._slot_of = np.full((self.nb,), -1, dtype=np.int64)
        self._row_of = np.full((cap,), -1, dtype=np.int64)
        self._ref = np.zeros((cap,), dtype=bool)
        self._size = 0
        self._hand = 0
        self._lock = threading.Lock()
        self._inflight: dict = {}       # row -> Future of its prefetch chunk
        self._pool = ThreadPoolExecutor(
            max_workers=self.qd if workers is None else int(workers),
            thread_name_prefix=f"{self.name}-blockstore")

    # -- device hooks (subclasses) ------------------------------------------
    def _read_chunk(self, rows: np.ndarray) -> dict:
        raise NotImplementedError

    def _device_chunks(self, rows: np.ndarray) -> list:
        """Split a miss batch into device-path chunks (default: one chunk
        per pool worker, up to ``qd``)."""
        return np.array_split(rows, min(self.qd, rows.size))

    def _fan_out(self, rows: np.ndarray) -> list:
        return [self._pool.submit(self._read_chunk, c)
                for c in self._device_chunks(rows)]

    # -- clock arena (callers hold the lock) --------------------------------
    def _alloc_slot(self) -> int:
        cap = self.cache_rows
        if self._size < cap:
            s = self._size
            self._size += 1
            return s
        while self._ref[self._hand]:              # second chance
            self._ref[self._hand] = False
            self._hand = (self._hand + 1) % cap
        s = self._hand
        self._hand = (self._hand + 1) % cap
        old = self._row_of[s]
        if old >= 0:
            self._slot_of[old] = -1
        return s

    def _insert(self, g: int, data: np.ndarray) -> None:
        if self.cache_rows == 0:
            return
        s = self._slot_of[g]
        if s < 0:
            s = self._alloc_slot()
            self._row_of[s] = g
            self._slot_of[g] = s
        self._arena[s] = data
        self._ref[s] = True

    # -- the protocol -------------------------------------------------------
    def _read_rows_impl(self, rows):
        rows = np.asarray(rows, dtype=np.int64).ravel()
        G = int(rows.size)
        out = np.empty((G, 2, self.blkp), dtype=np.int32)
        with self._lock:
            self.stats.reads += G
            self.stats.read_batches += 1
            slots = self._slot_of[rows]
            hit = slots >= 0
            if hit.any():                         # ONE gather for the batch
                hs = slots[hit]
                out[hit] = self._arena[hs]
                self._ref[hs] = True
            miss_rows = np.unique(rows[~hit])
            waits = [(int(g), self._inflight[int(g)]) for g in miss_rows
                     if int(g) in self._inflight]
            wait_set = {g for g, _ in waits}
            need = np.asarray([g for g in miss_rows
                               if int(g) not in wait_set], dtype=np.int64)
            futures = self._fan_out(need) if need.size else []
        got = {}
        for fut in futures:
            got.update(fut.result())
        if waits:                        # join in-flight prefetch chunks
            with get_tracer().span("store.prefetch_join", backend=self.name,
                                   rows=len(waits)):
                for g, fut in waits:
                    got[g] = fut.result()[g]
        if got:
            with self._lock:
                for g in need:
                    self._insert(int(g), got[int(g)])
                self.stats.device_reads += int(need.size)
                self.stats.cache_hits += G - int(need.size)
            for i in np.nonzero(~hit)[0]:
                out[i] = got[int(rows[i])]
        else:
            with self._lock:
                self.stats.cache_hits += G
        return out[:, 0], out[:, 1]

    def _prefetch_impl(self, rows) -> None:
        rows = np.unique(np.asarray(rows, dtype=np.int64).ravel())
        if rows.size == 0 or self.cache_rows == 0:
            return

        def land(fut, chunk):
            try:
                got = fut.result()
            except Exception:
                got = {}
            with self._lock:
                for g in chunk:
                    v = got.get(int(g))
                    if v is not None:
                        self._insert(int(g), v)
                    self._inflight.pop(int(g), None)

        with self._lock:
            cached = self._slot_of[rows] >= 0
            todo = [int(g) for g in rows[~cached]
                    if int(g) not in self._inflight]
            if not todo:
                return
            self.stats.prefetch_reads += len(todo)
            submitted = []
            for chunk in self._device_chunks(np.asarray(todo, np.int64)):
                fut = self._pool.submit(self._read_chunk, chunk)
                for g in chunk:
                    self._inflight[int(g)] = fut
                submitted.append((fut, chunk))
        # register callbacks OUTSIDE the lock: a fast (page-cached) read can
        # complete before add_done_callback is reached, in which case the
        # callback runs inline in THIS thread — land() takes the lock, which
        # would self-deadlock on the non-reentrant lock if still held
        for fut, chunk in submitted:
            fut.add_done_callback(lambda f, c=chunk: land(f, c))

    def close(self):
        self._pool.shutdown(wait=True)
        _retire_store(self)


class AioBlockStore(CachedBlockStore):
    """Asynchronous pread fan-out (the portable io_uring *emulation*): a
    miss batch splits across ``qd`` pread workers — request-level
    parallelism through the page cache, one syscall per read. Everything
    else (cache, prefetch, ledger) is the shared CachedBlockStore engine.
    The ``uring`` backend replaces exactly this hook with real kernel
    queueing."""

    name = "aio"

    def __init__(self, path, offset: int, nb: int, blkp: int, *,
                 qd: int = 16, cache_rows: Optional[int] = None):
        self._base = int(offset)
        self._stride = 2 * int(blkp) * 4
        self._fd = os.open(os.fspath(path), os.O_RDONLY)
        super().__init__(nb, blkp, qd=qd, cache_rows=cache_rows)

    def _read_chunk(self, rows: np.ndarray) -> dict:
        out = {}
        for g in rows:
            buf = os.pread(self._fd, self._stride,
                           self._base + int(g) * self._stride)
            if len(buf) != self._stride:
                raise IOError(f"short read at block row {int(g)}")
            out[int(g)] = np.frombuffer(buf, np.int32).reshape(2, self.blkp)
        return out

    def close(self):
        super().close()
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


def make_store(backend: str, path, hdr, *, qd: int = 16,
               cache_rows: Optional[int] = None, direct: bool = True,
               strict: bool = False) -> BlockStore:
    """Build a backend over a spilled file's ``blocks`` section.

    ``backend="uring"`` goes through the runtime capability probe
    (:func:`repro_torch.storage.uring.capabilities`) and falls back to the
    ``aio`` thread pool when io_uring is unavailable (same contract, so
    every caller keeps working); the returned store then carries
    ``fallback_from="uring"`` and a ``fallback_reason``. ``strict=True``
    raises instead (measurement lanes must not silently measure the
    emulation). ``direct=False`` keeps the uring backend on buffered reads
    even where O_DIRECT would work (see docs/storage.md on cache-defeating
    measurement). ``REPRO_STORE_BACKEND`` overrides ``backend`` for every
    call (see module docstring).
    """
    if backend not in BACKENDS:
        # validate the caller's choice BEFORE the env override so a typo'd
        # backend fails loudly even inside a forced lane
        raise ValueError(f"unknown block-store backend {backend!r}; expected "
                         f"one of {BACKENDS}")
    forced = store_backend_env()
    if forced is not None:
        backend = forced
    if backend == "mem":
        from .format import _read_section
        return MemBlockStore(np.asarray(_read_section(path, hdr, "blocks")))
    if backend == "mmap":
        return MmapBlockStore(path, hdr.blocks_offset, hdr.nb, hdr.blkp)
    if backend == "uring":
        from .uring import UringBlockStore, UringUnavailable
        try:
            return UringBlockStore(path, hdr.blocks_offset, hdr.nb, hdr.blkp,
                                   qd=qd, cache_rows=cache_rows,
                                   direct=direct)
        except UringUnavailable as e:
            if strict:
                raise
            import warnings
            warnings.warn(f"uring block store unavailable ({e}); falling "
                          "back to the aio thread-pool backend",
                          RuntimeWarning, stacklevel=2)
            store = AioBlockStore(path, hdr.blocks_offset, hdr.nb, hdr.blkp,
                                  qd=qd, cache_rows=cache_rows)
            store.fallback_from = "uring"
            store.fallback_reason = str(e)
            return store
    return AioBlockStore(path, hdr.blocks_offset, hdr.nb, hdr.blkp,
                         qd=qd, cache_rows=cache_rows)

"""Serving front ends: ``BatchQueue`` over the E2LSHoS query engine, and
``ServeEngine``, LM decoding with a retrieval hook.

``BatchQueue`` is the dynamic micro-batching request queue for the ANN
workload (the paper's serving story at "millions of users" scale): callers
submit arbitrary-size query batches, the queue assembles them into fixed batch-shape *ticks* (pad
+ mask to a small ladder of shapes warmed up at startup), dispatches ONE plan
call per tick, and scatters per-request ``QueryResult``s back with the
padding rows dropped. Queued results are bit for bit what calling the plan
directly on each request gives — the queue's parity contract.

On the card a tick's plan call launches the port's CUDA kernels (``lsh_hash``,
``probe_append`` and ``l2_distance_by_id`` under ``plan="fused"``; ``lsh_hash``
and ``l2_distance_by_id`` under ``plan="external"``) on the calling thread's
current stream: the background loop's thread uses the default stream and
opens no other, and whole ticks are serialized. A tick's dispatch time covers
the device's completion (one stream sync), and its result comes to the host
in one transfer (``QueryResult.cpu``).

Over a multi-rank engine (``SearchEngine(local_shard, group=layout)``, the
sharded plan across ``torch.distributed`` ranks) the layout's leader owns
the queue: each tick it broadcasts the padded batch and its mask to the
other ranks and makes the one masked plan call; every other rank runs
``BatchQueue.follow``, which receives the same broadcast and makes the same
call, until the leader's ``close()`` sends the stop sentinel. Each rank
issues its collectives from one thread at a time, in the same order.

``ServeEngine`` (the port of the reference's, ``src/repro/serving/engine.py``)
runs batched LM prefill and greedy decode over ``repro_torch.models.Model``
with an optional retrieval hook (kNN-LM style: each decode step's logits
query an E2LSHoS index, and neighbour ids ride alongside the tokens). The
hook from ``make_retrieval_fn`` closes over the fused plan, so each step
launches ``lsh_hash`` once and ``probe_append`` and ``l2_distance_by_id``
once per radius.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.query import QueryResult, SearchEngine
from ..kernels.dispatch import resolve_device
from ..models.model import Model
from ..telemetry import get_registry, get_tracer

__all__ = ["BatchQueue", "DeadlineExceeded", "QueryTicket", "TickStats",
           "ServeEngine", "GenerationResult"]


def _sync(device: torch.device) -> None:
    """Wait for the work queued on ``device``'s current stream (a no-op on
    the CPU, where every call has finished when it returns)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


# --------------------------------------------------------------------------
# Dynamic micro-batching over the query plans
# --------------------------------------------------------------------------

def _send_tick(layout, dev: torch.device, queries=None, valid=None) -> None:
    """Leader side of a tick across ranks: the row count (-1: stop), then the
    rows with the mask as a last column, broadcast over the layout."""
    rows = -1 if queries is None else queries.shape[0]
    dist.broadcast(torch.tensor([rows], dtype=torch.int64, device=dev), layout.leader,
                   group=layout.group)
    if queries is not None:
        dist.broadcast(torch.cat([queries, valid.to(torch.float32)[:, None]], dim=1),
                       layout.leader, group=layout.group)


def _receive_tick(layout, dev: torch.device, d: int):
    """Follower side of ``_send_tick``: (queries [Q, d], valid [Q]), or None
    at the stop sentinel."""
    head = torch.empty((1,), dtype=torch.int64, device=dev)
    dist.broadcast(head, layout.leader, group=layout.group)
    rows = int(head[0])
    if rows < 0:
        return None
    body = torch.empty((rows, d + 1), dtype=torch.float32, device=dev)
    dist.broadcast(body, layout.leader, group=layout.group)
    return body[:, :d].contiguous(), body[:, d] > 0


class DeadlineExceeded(RuntimeError):
    """A queued request's deadline expired before its tick could serve it;
    the QoS router shed it (fail-fast at pack time) instead of spending
    tick rows on a result nobody is waiting for."""


@dataclasses.dataclass
class TickStats:
    """One tick's dispatch record (the serving observability surface)."""

    tick: int            # ordinal
    shape: int           # batch shape dispatched (ladder rung)
    rows: int            # real query rows served
    segments: int        # request segments packed into the tick
    pad_rows: int        # masked padding rows (shape - rows)
    occupancy: float     # rows / shape
    dispatch_ms: float   # wall time of the single plan dispatch, to device completion
    shed: int = 0        # tickets shed (DeadlineExceeded) at this tick's pack


@dataclasses.dataclass
class _Pending:
    """One enqueued request segment awaiting a tick."""

    ticket: "QueryTicket"
    seg_idx: int
    seg: np.ndarray            # [b, d]
    priority: int              # 0 = highest; strict across classes
    deadline: Optional[float]  # absolute time.monotonic(), None = none
    seq: int                   # submission order (the FIFO tiebreaker)


class QueryTicket:
    """Per-request handle. A request larger than ``max_batch`` is split into
    segments that spill across consecutive ticks; the ticket reassembles the
    full ``QueryResult`` (row order preserved) once every segment landed."""

    def __init__(self, n_segments: int, *, priority: int = 0,
                 deadline: Optional[float] = None,
                 submit_t: Optional[float] = None):
        self._parts: list = [None] * n_segments
        self._remaining = n_segments
        self._lock = threading.Lock()   # segments may land from racing ticks
        self._event = threading.Event()
        self._result: Optional[QueryResult] = None
        self._error: Optional[BaseException] = None
        self.priority = int(priority)
        self.deadline = deadline            # absolute monotonic, or None
        self.submit_t = (time.monotonic() if submit_t is None
                         else float(submit_t))
        self._qos_logged = False            # one QoS record per ticket

    def _deliver(self, seg_idx: int, part: QueryResult) -> None:
        with self._lock:
            self._parts[seg_idx] = part
            self._remaining -= 1
            if self._remaining > 0:
                return
            self._result = QueryResult.concat_rows(self._parts)
            self._parts = []
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        """A tick's dispatch died: resolve the ticket with the error so
        waiters raise instead of hanging forever."""
        with self._lock:
            self._error = exc
            self._parts = []
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> QueryResult:
        """Block until served (drive ticks via BatchQueue.tick()/drain() or a
        running background loop). Raises ``DeadlineExceeded`` if the QoS
        router shed the request, RuntimeError if the serving tick's dispatch
        failed."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                "queued request not served yet — call BatchQueue.tick()/"
                "drain(), or start() the background tick loop")
        if self._error is not None:
            if isinstance(self._error, DeadlineExceeded):
                raise self._error
            raise RuntimeError(
                f"queued request failed in its serving tick: {self._error!r}"
            ) from self._error
        return self._result


class BatchQueue:
    """Dynamic micro-batching request queue in front of ``SearchEngine``,
    with a QoS-aware tick packer.

    Requests (arbitrary per-caller batch sizes) are packed into ticks of at
    most ``max_batch`` rows, padded + masked up to the smallest rung of the
    batch-shape ``ladder``, and served by ONE masked plan dispatch per tick
    (``SearchEngine.make_plan_fn(masked=True)``, the typed seam built for
    this layer). Padding rows are provably inert (core.query mask
    contract), so the scattered-back per-request results are bit-exact with
    direct per-request dispatch.

    **Pack order (QoS).** ``submit(..., priority=, deadline_ms=)`` attaches
    a priority class (0 = highest, strict across classes) and an optional
    deadline; within a class, segments pack earliest-deadline-first (EDF;
    deadline-less segments last, FIFO by submission order — so all-default
    traffic reduces exactly to the original FIFO packer). Packing stops at
    the first segment that does not fit (head-of-line: nothing behind the
    head jumps the line; oversize requests spill to later ticks unchanged).

    **Load shedding.** A segment whose deadline has already expired at pack
    time is shed: its ticket fails fast with :class:`DeadlineExceeded`
    (sibling segments of the ticket drop with it) instead of occupying tick
    rows. Shed counts ride on ``TickStats.shed`` / ``stats_summary()``.

    **Adaptive ladder.** With ``adaptive_ladder=True`` the packer keeps a
    windowed occupancy histogram from the tick log and stops packing at the
    preferred rung (the smallest ladder shape covering the window's p90
    rows) instead of always filling toward ``max_batch`` — unless a waiting
    segment's deadline slack is inside ~2 tick periods, in which case the
    packer fills for it (latency beats shape reuse).

    **Cache warming.** With ``warm_cache_rows=N`` over an external engine,
    the plan's probe-trace row histogram is collected and the background
    loop prefetches the N hottest block rows into the store cache (each
    shard's own clock arena under ``plan="sharded_external"``) whenever the
    queue goes idle — advisory, never counted in the logical read ledger.

    The ladder is warmed up at construction: every rung runs the whole
    radius schedule once, which loads every kernel library of the plan,
    builds the index's hash pack and fills the caching allocator, so no
    steady-state tick pays for any of them (the tests assert that no kernel
    loads after it). ``dispatch_count`` counts real plan dispatches — the
    test probe for "one dispatch per tick".

    The queue runs on its engine's device: ``BatchQueue(index)`` builds a
    ``SearchEngine`` on the card (and raises without one); pass an engine
    built with ``device="cpu"`` to serve on the host.

    **Across ranks.** Over an engine with ``group=`` (a ``RankLayout``) the
    queue is built on the layout's leader only, while every other rank of
    the layout runs ``BatchQueue.follow(engine, plan=, k=)``; ``close()``
    (after the last tick) releases them. Each tick is then one broadcast of
    its rows plus the one collective plan call on every rank.

    Drive it synchronously (``tick()`` / ``drain()`` / ``query()``) or run
    the background loop (``start()``/``stop()``), which fires a tick every
    ``tick_us`` microseconds while requests are pending and services
    back-to-back full ticks immediately under queue pressure.
    """

    @staticmethod
    def resolve_ladder(ladder: Sequence[int],
                       max_batch: Optional[int] = None) -> tuple:
        """Normalize a batch-shape ladder: positive rungs, sorted, deduped,
        trimmed to max_batch — which is always itself a rung (it is the
        largest shape a tick dispatches)."""
        rungs = sorted({int(s) for s in ladder if int(s) > 0})
        if not rungs and max_batch is None:
            raise ValueError(f"empty batch-shape ladder {ladder!r}")
        if max_batch is not None:
            if int(max_batch) <= 0:
                raise ValueError(f"max_batch must be positive, got {max_batch}")
            rungs = [s for s in rungs if s <= int(max_batch)]
            if not rungs or rungs[-1] != int(max_batch):
                rungs.append(int(max_batch))
        return tuple(rungs)

    def __init__(self, index, *, plan: Optional[str] = None, k: int = 1,
                 ladder: Sequence[int] = (8, 32, 128),
                 max_batch: Optional[int] = None, tick_us: float = 200.0,
                 warmup: bool = True, adaptive_ladder: bool = False,
                 window: int = 64, warm_cache_rows: int = 0, **plan_kw):
        self.engine: SearchEngine = (
            index if isinstance(index, SearchEngine) else SearchEngine(index))
        self.ladder: tuple = self.resolve_ladder(ladder, max_batch)
        self.max_batch: int = self.ladder[-1]
        self.tick_us = float(tick_us)
        self.adaptive_ladder = bool(adaptive_ladder)
        self.window = int(window)
        self.warm_cache_rows = int(warm_cache_rows)
        self.plan = plan or self.engine.default_plan
        self.cfg, self._fn = self.engine.make_plan_fn(
            plan=self.plan, k=k, masked=True, **plan_kw)
        self._layout = self.engine.group   # a RankLayout: this rank leads
        self._closed = False
        if self._layout is not None:
            if dist.get_rank() != self._layout.leader:
                raise ValueError(
                    f"rank {dist.get_rank()} is not the layout's leader "
                    f"({self._layout.leader}): it runs BatchQueue.follow(engine, ...)")
            self._fn = self._leading(self._fn)
        self._d = int(self.engine.params.d)
        self._pending: deque = deque()   # _Pending segments awaiting a tick
        self._lock = threading.Lock()        # guards _pending / _seq
        self._serve_lock = threading.Lock()  # serializes whole ticks
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._seq = 0                    # submission counter (FIFO tiebreak)
        self._qos_pending = 0            # pending segments with QoS attrs
        # one lock owns every stats surface below: tick commits
        # (dispatch_count + tick_log row land atomically), QoS records,
        # stats_summary() reads, and reset_stats() — the window-vs-reset
        # race fix (a summary can never see a cleared log with a stale
        # dispatch count, or iterate tick_log mid-clear)
        self._stats_lock = threading.Lock()
        self.dispatch_count = 0          # the one-dispatch-per-tick probe
        self.tick_log: list = []         # TickStats per tick
        self.qos_log: list = []          # one dict per deadline/priority ticket
        self.shed_count = 0              # tickets shed with DeadlineExceeded
        self._warmed_at = -1             # dispatch_count at last cache warm
        _LIVE_QUEUES.add(self)           # telemetry collector (module foot)
        ext = self.engine.external
        if self.warm_cache_rows > 0 and ext is not None:
            ext.collect_row_hist = True  # feed warm_cache() the probe trace
        if warmup:
            self.warmup()

    # -- across ranks -------------------------------------------------------
    def _leading(self, fn):
        """The masked plan call on the leader of a multi-rank engine: the
        tick's rows go to the other ranks first, then every rank calls."""
        layout, dev = self._layout, self.engine.device

        def lead(queries, valid):
            if self._closed:
                raise RuntimeError("the queue is closed: its follower ranks have left")
            queries = queries.to(dev, torch.float32)
            valid = valid.to(dev, torch.bool)
            _send_tick(layout, dev, queries, valid)
            return fn(queries, valid)
        return lead

    @staticmethod
    def follow(engine: SearchEngine, *, plan: Optional[str] = None, k: int = 1,
               **plan_kw) -> int:
        """Run on every rank of a multi-rank engine but the leader, while the
        leader's queue (same ``plan``, ``k`` and plan keywords) serves: each
        tick's rows arrive by broadcast and this rank makes the same masked
        plan call. Returns the number of calls once the leader closes."""
        layout = engine.group
        if layout is None or dist.get_rank() == layout.leader:
            raise ValueError("follow() runs on the non-leading ranks of a multi-rank engine")
        _, fn = engine.make_plan_fn(plan=plan, k=k, masked=True, **plan_kw)
        d, calls = int(engine.params.d), 0
        while (tick := _receive_tick(layout, engine.device, d)) is not None:
            fn(*tick)
            calls += 1
        return calls

    def close(self) -> None:
        """Stop the background loop (draining what is pending); on a queue
        over ranks, also release the follower ranks. No tick runs after."""
        self.stop()
        if self._layout is not None and not self._closed:
            _send_tick(self._layout, self.engine.device)
        self._closed = True

    # -- warm-up --------------------------------------------------------------
    def warmup(self, rungs: Optional[Sequence[int]] = None) -> None:
        """Run every ladder rung (or those of ``rungs``) once up front (not
        counted by the dispatch probe). The dummy rows are live (valid) far-away points that match
        nothing, so every plan runs its WHOLE radius schedule here: the first
        call of each kernel loads its library (and builds it if needed), the
        index's hash pack is built, and the caching allocator holds every
        rung's buffers before the first real tick."""
        dev = self.engine.device
        for shape in self.ladder if rungs is None else rungs:
            self._fn(torch.full((shape, self._d), 1e6, dtype=torch.float32, device=dev),
                     torch.ones((shape,), dtype=torch.bool, device=dev))
            _sync(dev)

    def shape_for(self, rows: int) -> int:
        """Smallest ladder rung holding `rows` (rows <= max_batch)."""
        for s in self.ladder:
            if s >= rows:
                return s
        raise ValueError(f"{rows} rows exceed max_batch={self.max_batch}")

    # -- request side -------------------------------------------------------
    def submit(self, queries, *, priority: int = 0,
               deadline_ms: Optional[float] = None) -> QueryTicket:
        """Enqueue one request ([b, d] or [d]); returns its ticket. Requests
        wider than max_batch are segmented; the tail spills to later ticks.

        ``priority`` (0 = highest) ranks strictly across classes in the tick
        packer; ``deadline_ms`` is a relative budget from now — segments
        still unserved when it expires are shed with ``DeadlineExceeded``
        instead of dispatched. A ticket's segments share one deadline."""
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[1] != self._d:
            raise ValueError(f"expected [b, {self._d}] queries, got {q.shape}")
        if q.shape[0] == 0:
            raise ValueError("empty request")
        if priority < 0:
            raise ValueError(f"priority must be >= 0, got {priority}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be positive, got {deadline_ms}")
        now = time.monotonic()
        deadline = None if deadline_ms is None else now + deadline_ms * 1e-3
        segs = [q[i:i + self.max_batch]
                for i in range(0, q.shape[0], self.max_batch)]
        ticket = QueryTicket(len(segs), priority=priority, deadline=deadline,
                             submit_t=now)
        with self._lock:
            for i, s in enumerate(segs):
                self._pending.append(_Pending(
                    ticket=ticket, seg_idx=i, seg=s, priority=int(priority),
                    deadline=deadline, seq=self._seq))
                self._seq += 1
            if priority != 0 or deadline is not None:
                self._qos_pending += len(segs)
        return ticket

    def query(self, queries, *, timeout: float = 600.0) -> QueryResult:
        """Synchronous convenience: submit + (if no loop is running) drain."""
        ticket = self.submit(queries)
        if self._thread is None:
            self.drain()
        return ticket.result(timeout=timeout)

    # -- tick side ----------------------------------------------------------
    def _record_qos(self, ticket: QueryTicket, *, now: float,
                    shed: bool) -> None:
        """One QoS record per ticket, at resolution (served or shed)."""
        if ticket._qos_logged:
            return
        ticket._qos_logged = True
        deadline_ms = (None if ticket.deadline is None
                       else (ticket.deadline - ticket.submit_t) * 1e3)
        hit = (not shed) and (ticket.deadline is None
                              or now <= ticket.deadline)
        with self._stats_lock:
            self.qos_log.append(dict(
                priority=ticket.priority,
                latency_ms=(now - ticket.submit_t) * 1e3,
                deadline_ms=deadline_ms, hit=bool(hit), shed=bool(shed)))

    def _target_rows(self) -> int:
        """Adaptive ladder: smallest rung covering the window's p90 rows —
        the packer's soft fill target (max_batch stays the hard cap)."""
        if not self.adaptive_ladder:
            return self.max_batch
        with self._stats_lock:           # _lock -> _stats_lock (fixed order)
            recent = [t.rows for t in self.tick_log[-self.window:]]
        if not recent:
            return self.max_batch
        p90 = float(np.percentile(recent, 90))
        for s in self.ladder:
            if s >= p90:
                return s
        return self.max_batch

    def tick(self) -> Optional[TickStats]:
        """Serve one tick: shed expired segments, pack the live ones in QoS
        order (strict priority, EDF within class, FIFO tiebreak) up to
        max_batch rows, pad + mask to the smallest ladder rung, dispatch
        ONCE, scatter back. Returns None (no dispatch) when nothing packed.
        Thread-safe: whole ticks are serialized (concurrent callers — e.g.
        several synchronous query() drains — each serve complete ticks,
        never interleave one)."""
        with self._serve_lock:
            tr = get_tracer()
            root = tr.begin("serve.tick", plan=self.plan)
            try:
                return self._tick_locked(tr, root)
            finally:
                root.end()

    def _tick_locked(self, tr, root) -> Optional[TickStats]:
        """The tick body, under ``_serve_lock`` with its root span open."""
        now = time.monotonic()
        urgent_s = 2.0 * self.tick_us * 1e-6   # slack beating shape reuse
        psp = tr.begin("tick.pack")
        with self._lock:
            shed_tickets: dict = {}
            target = self._target_rows()
            batch, rows = [], 0
            if self._qos_pending == 0:
                # fast path — no priorities, no deadlines pending: the
                # deque IS the pack order (seq), so the original O(batch)
                # FIFO popleft packer applies; the backlog is never
                # scanned or sorted (this is the high-arrival serving
                # regime the queued-vs-direct bench measures)
                while self._pending:
                    e = self._pending[0]
                    if e.ticket.done():   # an earlier tick failed it
                        self._pending.popleft()
                        continue
                    nrows = e.seg.shape[0]
                    if rows + nrows > self.max_batch:
                        break   # head-of-line: the head spills
                    if batch and rows + nrows > target:
                        break   # adaptive soft stop (nothing is urgent)
                    batch.append(self._pending.popleft())
                    rows += nrows
            else:
                live = []
                for e in self._pending:
                    if e.ticket.done():   # sibling shed / tick failure
                        continue
                    if e.deadline is not None and e.deadline <= now:
                        shed_tickets[id(e.ticket)] = e.ticket
                        continue
                    live.append(e)
                live.sort(key=lambda e: (
                    e.priority,
                    e.deadline if e.deadline is not None else float("inf"),
                    e.seq))
                spilled = []
                for i, e in enumerate(live):
                    nrows = e.seg.shape[0]
                    if rows + nrows > self.max_batch:
                        # strict head-of-line: nothing behind the first
                        # non-fitting segment jumps the line
                        spilled = live[i:]
                        break
                    if (batch and rows + nrows > target
                            and not (e.deadline is not None
                                     and e.deadline - now < urgent_s)):
                        spilled = live[i:]
                        break   # adaptive soft stop at the preferred rung
                    batch.append(e)
                    rows += nrows
                # unpacked segments return in submission order so the
                # next tick's sort sees the same FIFO tiebreak
                self._pending = deque(sorted(spilled, key=lambda e: e.seq))
                self._qos_pending = sum(
                    1 for e in self._pending
                    if e.priority != 0 or e.deadline is not None)
        n_shed = len(shed_tickets)
        if not batch and not n_shed:
            psp.cancel()          # idle poll: keep the span ring quiet
        else:
            psp.set(segments=len(batch), rows=rows, shed=n_shed)
            psp.end()
        for t in shed_tickets.values():
            with self._stats_lock:
                self.shed_count += 1
            budget_ms = (t.deadline - t.submit_t) * 1e3
            t._fail(DeadlineExceeded(
                f"request shed: {budget_ms:.1f}ms deadline expired "
                f"{(now - t.deadline) * 1e3:.1f}ms before its tick"))
            self._record_qos(t, now=now, shed=True)
        if not batch:
            if not n_shed:
                root.cancel()     # nothing happened; drop the empty tick
            return None
        shape = self.shape_for(rows)
        qs = np.zeros((shape, self._d), dtype=np.float32)
        qs[:rows] = np.concatenate([e.seg for e in batch], axis=0)
        valid = np.zeros((shape,), dtype=bool)
        valid[:rows] = True
        dev = self.engine.device
        t0 = time.perf_counter()
        try:
            with tr.span("tick.dispatch", shape=shape, rows=rows):
                res = self._fn(torch.from_numpy(qs).to(dev),
                               torch.from_numpy(valid).to(dev))
                _sync(dev)    # dispatch_ms covers the device's completion
        except Exception as e:
            # the popped segments can never be re-served at this point:
            # fail their tickets (waiters raise instead of hanging) and
            # surface the error to whoever drove the tick
            for p in batch:
                p.ticket._fail(e)
            raise
        dispatch_ms = (time.perf_counter() - t0) * 1e3
        _DISPATCH_MS.observe(dispatch_ms, plan=self.plan)
        root.set(shape=shape, rows=rows, segments=len(batch))
        # ONE device->host transfer for the whole tick; the per-segment
        # scatter is then host views (per-segment device slicing, or one
        # copy per field, costs more than the dispatch at high request counts)
        with tr.span("tick.scatter", segments=len(batch)):
            host = res.cpu()
            done_t = time.monotonic()
            lo = 0
            for p in batch:
                hi = lo + p.seg.shape[0]
                p.ticket._deliver(p.seg_idx, host.slice_rows(lo, hi))
                lo = hi
                if p.ticket.done():
                    self._record_qos(p.ticket, now=done_t, shed=False)
        # atomic stats commit: a concurrent stats_summary() can never
        # see the new dispatch count without its tick row (or vice versa)
        with self._stats_lock:
            self.dispatch_count += 1
            stats = TickStats(
                tick=len(self.tick_log), shape=shape, rows=rows,
                segments=len(batch), pad_rows=shape - rows,
                occupancy=rows / shape, dispatch_ms=dispatch_ms,
                shed=n_shed,
            )
            self.tick_log.append(stats)
        return stats

    def drain(self) -> int:
        """Tick until the queue is empty; returns ticks run."""
        n = 0
        while self.tick() is not None:
            n += 1
        return n

    @property
    def depth(self) -> int:
        """Pending rows not yet served."""
        with self._lock:
            return sum(e.seg.shape[0] for e in self._pending)

    # -- cache warming ------------------------------------------------------
    def warm_cache(self, top: Optional[int] = None) -> int:
        """Prefetch the hottest probe-trace rows into the external store's
        cache (per-shard arenas under a striped store). Advisory: prefetches
        ride the ledger's ``prefetch_reads`` lane, never logical ``reads``.
        Returns rows warmed (0 when not an external engine / no trace)."""
        ext = self.engine.external
        if ext is None:
            return 0
        n = top if top is not None else self.warm_cache_rows
        if n <= 0:
            return 0
        return ext.warm_cache(top=n)

    # -- background loop ----------------------------------------------------
    def start(self) -> "BatchQueue":
        """Run the tick loop on a daemon thread (tick every tick_us while
        idle-ish; full ticks are followed immediately under pressure)."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    st = self.tick()
                except Exception:
                    # the affected tickets were failed inside tick(); keep
                    # the loop alive for the next batch instead of dying
                    # silently with requests still flowing in
                    st = None
                if st is None or st.rows < self.max_batch:
                    if (st is None and self.warm_cache_rows > 0
                            and self.dispatch_count != self._warmed_at):
                        # idle: re-warm the store cache from the probe trace
                        # (once per dispatch generation — the histogram only
                        # changes when ticks actually ran)
                        self._warmed_at = self.dispatch_count
                        self.warm_cache()
                    self._stop.wait(self.tick_us * 1e-6)

        self._thread = threading.Thread(
            target=loop, name="batch-queue-tick", daemon=True)
        self._thread.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        if drain:
            self.drain()

    def __enter__(self) -> "BatchQueue":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- observability ------------------------------------------------------
    def stats_summary(self, window: Optional[int] = None) -> dict:
        """Aggregate tick stats: occupancy, pad waste, dispatch p50/p99,
        the ladder-rung histogram, and the QoS block (shed counts +
        deadline hit rates, overall and per priority class).

        ``window=N`` restricts the tick aggregates to the last N ticks (the
        sliding view the adaptive packer sees); the default is cumulative.
        The QoS block and dispatch/shed counters are always cumulative —
        they describe tickets, which have no tick alignment.

        When the engine serves an external index, the block store's
        cumulative I/O ledger rides along as ``external_store``, tagged
        with the resolved backend (and the fallback that produced it — the
        serve-startup provenance line), plus per-shard ledgers when the
        store is striped."""
        if window is not None and window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        # one consistent cut of every stats surface: tick rows, the dispatch
        # counter, and the QoS log are copied under the same lock tick()
        # commits under, so a concurrent reset_stats() (or a tick landing
        # mid-summary) can never tear the view
        with self._stats_lock:
            log = list(self.tick_log)
            dispatches = self.dispatch_count
            qlog = list(self.qos_log)
            shed = self.shed_count
        if window is not None:
            log = log[-window:]
        if not log:
            out = dict(ticks=0, dispatches=dispatches, rows_served=0)
        else:
            dms = np.asarray([t.dispatch_ms for t in log])
            slots = sum(t.shape for t in log)
            rows = sum(t.rows for t in log)
            rung_hist = {int(s): 0 for s in self.ladder}
            for t in log:
                rung_hist[int(t.shape)] = rung_hist.get(int(t.shape), 0) + 1
            out = dict(
                ticks=len(log),
                dispatches=dispatches,
                rows_served=rows,
                segments=sum(t.segments for t in log),
                occupancy_mean=float(np.mean([t.occupancy for t in log])),
                pad_waste=float((slots - rows) / slots),
                p50_dispatch_ms=float(np.percentile(dms, 50)),
                p99_dispatch_ms=float(np.percentile(dms, 99)),
                rung_hist=rung_hist,
            )
        out["qos"] = self._qos_summary(qlog, shed)
        ext = self.engine.external
        if ext is not None:
            store = ext.store
            es = store.stats.as_dict()
            es["backend"] = store.name
            es["fallback_from"] = getattr(store, "fallback_from", None)
            es["fallback_reason"] = getattr(store, "fallback_reason", None)
            shards = getattr(store, "num_shards", None)
            if shards is not None:
                es["num_shards"] = int(shards)
                es["per_shard"] = [s.as_dict()
                                   for s in store.per_shard_stats()]
            out["external_store"] = es
        return out

    def _qos_summary(self, qlog: Optional[list] = None,
                     shed: Optional[int] = None) -> dict:
        """Cumulative QoS roll-up. Hit rates are computed over
        deadline-bearing tickets only (a deadline-less ticket can't miss).
        Callers that already hold a consistent cut pass it in; bare calls
        take one under the stats lock."""
        if qlog is None:
            with self._stats_lock:
                qlog, shed = list(self.qos_log), self.shed_count
        tracked = [r for r in qlog if r["deadline_ms"] is not None]
        out = dict(shed=shed, tickets=len(qlog), tracked=len(tracked))
        if tracked:
            out["deadline_hit_rate"] = float(
                np.mean([r["hit"] for r in tracked]))
        by_class: dict = {}
        for pri in sorted({r["priority"] for r in qlog}):
            rows = [r for r in qlog if r["priority"] == pri]
            trk = [r for r in rows if r["deadline_ms"] is not None]
            cls = dict(tickets=len(rows), tracked=len(trk),
                       shed=sum(1 for r in rows if r["shed"]),
                       p99_latency_ms=float(np.percentile(
                           [r["latency_ms"] for r in rows], 99)))
            if trk:
                cls["hit_rate"] = float(np.mean([r["hit"] for r in trk]))
            by_class[int(pri)] = cls
        out["by_class"] = by_class
        return out

    def reset_stats(self) -> None:
        """Clear the tick log, QoS log, and counters in one atomic step
        w.r.t. concurrent ``tick()`` commits and ``stats_summary()`` readers
        (the window-vs-reset race regression test drives all three at
        once). The registry's process-lifetime counters are NOT touched —
        use ``telemetry.reset()`` to re-baseline those."""
        with self._stats_lock:
            self.tick_log.clear()
            self.qos_log.clear()
            self.dispatch_count = 0
            self.shed_count = 0
            self._warmed_at = -1


# -- registry collector over the live queues' ledgers -----------------------
# TickStats / the QoS log stay the source of truth; the collector is a
# window onto them (grouped by plan — replicas of one plan sum into one
# series, Prometheus-style). Queues are weakly held: a gc'd queue's series
# disappear, which the registry's baseline clamp tolerates.
_LIVE_QUEUES: "weakref.WeakSet[BatchQueue]" = weakref.WeakSet()
_DISPATCH_MS = get_registry().histogram(
    "e2lsh_serve_dispatch_ms",
    "wall time of one fused tick dispatch (ms)", labelnames=("plan",))


def _collect_queue_metrics() -> dict:
    cuts = []
    for q in list(_LIVE_QUEUES):
        depth = q.depth                       # takes q._lock; NEVER nest it
        with q._stats_lock:                   # inside the stats lock
            cuts.append(dict(
                plan=q.plan, depth=depth, log=list(q.tick_log),
                dispatches=q.dispatch_count, shed=q.shed_count,
                qlog=list(q.qos_log)))
    by_plan: dict = {}
    for c in cuts:
        by_plan.setdefault(c["plan"], []).append(c)

    counters = dict(ticks=[], dispatches=[], rows=[], pad_rows=[],
                    segments=[], shed=[])
    gauges = dict(queue_depth=[], occupancy_mean=[], deadline_hit_rate=[])
    rungs, cls_tickets, cls_shed, cls_hit = [], [], [], []
    for plan, group in sorted(by_plan.items()):
        lab = dict(plan=plan)
        log = [t for c in group for t in c["log"]]
        qlog = [r for c in group for r in c["qlog"]]
        counters["ticks"].append(dict(labels=lab, value=len(log)))
        counters["dispatches"].append(dict(
            labels=lab, value=sum(c["dispatches"] for c in group)))
        counters["rows"].append(dict(
            labels=lab, value=sum(t.rows for t in log)))
        counters["pad_rows"].append(dict(
            labels=lab, value=sum(t.pad_rows for t in log)))
        counters["segments"].append(dict(
            labels=lab, value=sum(t.segments for t in log)))
        counters["shed"].append(dict(
            labels=lab, value=sum(c["shed"] for c in group)))
        gauges["queue_depth"].append(dict(
            labels=lab, value=sum(c["depth"] for c in group)))
        if log:
            gauges["occupancy_mean"].append(dict(
                labels=lab,
                value=float(np.mean([t.occupancy for t in log]))))
        tracked = [r for r in qlog if r["deadline_ms"] is not None]
        if tracked:
            gauges["deadline_hit_rate"].append(dict(
                labels=lab,
                value=float(np.mean([r["hit"] for r in tracked]))))
        shape_hist: dict = {}
        for t in log:
            shape_hist[int(t.shape)] = shape_hist.get(int(t.shape), 0) + 1
        rungs.extend(dict(labels=dict(plan=plan, shape=str(s)), value=n)
                     for s, n in sorted(shape_hist.items()))
        for pri in sorted({r["priority"] for r in qlog}):
            rows = [r for r in qlog if r["priority"] == pri]
            trk = [r for r in rows if r["deadline_ms"] is not None]
            plab = dict(plan=plan, priority=str(int(pri)))
            cls_tickets.append(dict(labels=plab, value=len(rows)))
            cls_shed.append(dict(
                labels=plab, value=sum(1 for r in rows if r["shed"])))
            if trk:
                cls_hit.append(dict(
                    labels=plab,
                    value=float(np.mean([r["hit"] for r in trk]))))

    helps = dict(
        ticks="serving ticks dispatched",
        dispatches="fused plan dispatches (one per tick)",
        rows="real query rows served",
        pad_rows="masked padding rows dispatched",
        segments="request segments packed",
        shed="tickets shed with DeadlineExceeded",
    )
    out = {f"e2lsh_serve_{k}_total": dict(type="counter", help=helps[k],
                                          samples=v)
           for k, v in counters.items()}
    out["e2lsh_serve_queue_depth"] = dict(
        type="gauge", help="pending rows not yet served",
        samples=gauges["queue_depth"])
    out["e2lsh_serve_occupancy_mean"] = dict(
        type="gauge", help="mean tick occupancy (rows / shape)",
        samples=gauges["occupancy_mean"])
    out["e2lsh_serve_deadline_hit_rate"] = dict(
        type="gauge",
        help="deadline hit rate over deadline-bearing tickets",
        samples=gauges["deadline_hit_rate"])
    out["e2lsh_serve_rung_ticks_total"] = dict(
        type="counter", help="ticks dispatched at each compiled batch shape",
        samples=rungs)
    out["e2lsh_serve_class_tickets_total"] = dict(
        type="counter", help="resolved tickets per priority class",
        samples=cls_tickets)
    out["e2lsh_serve_class_shed_total"] = dict(
        type="counter", help="shed tickets per priority class",
        samples=cls_shed)
    out["e2lsh_serve_class_hit_rate"] = dict(
        type="gauge", help="deadline hit rate per priority class",
        samples=cls_hit)
    return out


get_registry().register_collector(_collect_queue_metrics,
                                  name="serving.batch_queue")


# --------------------------------------------------------------------------
# LM serving with the retrieval hook
# --------------------------------------------------------------------------


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor                        # [B, steps] int32
    logits_last: torch.Tensor                   # [B, vocab]
    neighbors: Optional[torch.Tensor] = None    # [B, steps, k] retrieval ids


class ServeEngine:
    def __init__(self, model: Model, params, *, max_seq: int = 4096,
                 cache_dtype=torch.bfloat16, retrieval_fn: Optional[Callable] = None,
                 device=None):
        """retrieval_fn(hidden [B, V]) -> (ids [B, k], dists [B, k]).

        ``device`` (None -> cuda; raises without a GPU unless "cpu") must be
        the model's."""
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"the model lives on {model.device}, the engine on {dev}")
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.cache_dtype = cache_dtype
        self.retrieval_fn = retrieval_fn
        self.device = dev

    @staticmethod
    def make_retrieval_fn(index, *, k: int = 8, device=None) -> Callable:
        """Retrieval hook closing over the fused query plan.

        ``index`` is an ``E2LSHoS`` (or anything ``SearchEngine`` accepts),
        served on ``device`` (None -> cuda; raises without a GPU unless
        "cpu"). The hook casts the hidden state to float32 and scales each
        row to unit norm (floor 1e-9), as the datastore's rows are."""
        _, query_fn = SearchEngine(index, device=device).make_plan_fn(plan="fused", k=k)

        def retrieval_fn(hidden):
            h = hidden.float()
            h = h / torch.clamp_min(torch.linalg.vector_norm(h, dim=1, keepdim=True), 1e-9)
            res = query_fn(h)
            return res.ids, res.dists

        return retrieval_fn

    def generate(self, batch: dict, *, steps: int = 16) -> GenerationResult:
        """Prefill ``batch`` ({"tokens": [B, T]}, + "frames" for encdec),
        then ``steps`` greedy decode steps; with a retrieval hook, each
        step's logits probe the index."""
        B = batch["tokens"].shape[0]
        cache = self.model.init_cache(B, self.max_seq, self.cache_dtype)
        logits, cache = self.model.prefill(self.params, batch, cache)
        toks = []
        neigh = [] if self.retrieval_fn is not None else None
        cur = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        for _ in range(steps):
            toks.append(cur)
            logits, cache = self.model.decode_step(self.params, cur, cache)
            if self.retrieval_fn is not None:
                # kNN-LM hook: the index lives in the logits space
                ids, _ = self.retrieval_fn(logits[:, 0])
                neigh.append(ids)
            cur = logits[:, 0].argmax(dim=-1).to(torch.int32)[:, None]
        return GenerationResult(
            tokens=torch.cat(toks, dim=1),
            logits_last=logits[:, 0],
            neighbors=torch.stack(neigh, dim=1) if neigh else None,
        )

"""Zero-dependency span tracer for the query/storage/serving stack.

A :class:`Span` is one timed region with attributes — ``span("external.rung",
t=2)`` as a context manager for synchronous regions, explicit
``begin()``/``end()`` for regions that don't nest lexically (async I/O
waves, tick sections that decide mid-flight whether they happened at all).
Spans carry a parent id (thread-local stack), so an exported trace
reconstructs the full tree: tick pack -> masked dispatch -> per-rung chain
walk -> block-store read waves -> distance fold.

Overhead discipline (a sampling rate and a hard off-switch):

* **Disabled** (the default): ``span()``/``begin()`` return the shared
  no-op span — one attribute load and one call on the hot path, nothing
  allocated, nothing recorded. ``REPRO_TELEMETRY=off`` is the hard kill
  switch: ``configure(enabled=True)`` cannot override it.
* **Sampling**: the record/drop decision is made once per span *tree* at
  the root and inherited by every child, so a sampled trace is always
  internally complete (a rung span never loses its read spans to the
  coin flip). ``sampling=1.0`` records everything — the setting the
  trace-vs-ledger consistency tests pin.
* The ring buffer is a ``deque(maxlen=capacity)``: appends are GIL-atomic
  (no lock on the record path) and memory is bounded by construction.

Timestamps are ``time.perf_counter_ns()`` (monotonic, ns); exporters
convert to chrome-trace microseconds. With ``record_function=True`` each
recorded span also opens a ``torch.profiler.record_function`` range, so host
spans line up with the kernels they launched inside a ``torch.profiler``
timeline; it annotates only when asked.
"""
from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from itertools import count
from typing import Optional

__all__ = ["Span", "Tracer", "get_tracer", "span", "TELEMETRY_ENV",
           "telemetry_forced_off"]

TELEMETRY_ENV = "REPRO_TELEMETRY"


def telemetry_forced_off() -> bool:
    """The hard off-switch: ``REPRO_TELEMETRY=off|0|false`` wins over any
    programmatic ``configure(enabled=True)``."""
    return (os.environ.get(TELEMETRY_ENV, "").strip().lower()
            in ("off", "0", "false", "disabled"))


class _NoopSpan:
    """Shared do-nothing span: the disabled tracer's entire hot path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def end(self):
        return None

    def cancel(self):
        return None


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed region. ``sid``/``parent`` link the tree; ``tid`` is the
    recording thread; ``ts_ns`` is perf_counter_ns at begin, ``dur_ns`` is
    filled at end (None while open)."""

    __slots__ = ("name", "sid", "parent", "tid", "ts_ns", "dur_ns", "attrs",
                 "sampled", "_tracer", "_attached", "_prof_ctx")

    def __init__(self, name: str, sid: int, parent: Optional[int], tid: int,
                 attrs: dict, sampled: bool, tracer: "Tracer",
                 attached: bool):
        self.name = name
        self.sid = sid
        self.parent = parent
        self.tid = tid
        self.attrs = attrs
        self.sampled = sampled
        self._tracer = tracer
        self._attached = attached
        self._prof_ctx = None
        self.dur_ns = None
        self.ts_ns = 0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self) -> None:
        self._tracer._finish(self)

    def cancel(self) -> None:
        """End the span without recording it (e.g. an idle tick that packed
        nothing — begun before the outcome was known)."""
        self.sampled = False
        self.end()

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def as_dict(self) -> dict:
        return dict(name=self.name, sid=self.sid, parent=self.parent,
                    tid=self.tid, ts_us=self.ts_ns / 1e3,
                    dur_us=(self.dur_ns or 0) / 1e3, attrs=dict(self.attrs))


class Tracer:
    """Span factory + bounded ring buffer (see module docstring)."""

    def __init__(self, *, enabled: bool = False, sampling: float = 1.0,
                 capacity: int = 65536, record_function: bool = False):
        self._enabled = bool(enabled) and not telemetry_forced_off()
        self._sampling = float(sampling)
        self._ring: deque = deque(maxlen=int(capacity))
        self._seq = count(1)
        self._tls = threading.local()
        self._record_function = bool(record_function)

    # -- configuration ------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def sampling(self) -> float:
        return self._sampling

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def configure(self, *, enabled: Optional[bool] = None,
                  sampling: Optional[float] = None,
                  capacity: Optional[int] = None,
                  record_function: Optional[bool] = None) -> "Tracer":
        """Reconfigure in place; returns self. ``REPRO_TELEMETRY=off``
        forces ``enabled=False`` regardless of the argument."""
        if sampling is not None:
            if not (0.0 <= sampling <= 1.0):
                raise ValueError(f"sampling must be in [0, 1], got {sampling}")
            self._sampling = float(sampling)
        if capacity is not None and int(capacity) != self._ring.maxlen:
            old = list(self._ring)
            self._ring = deque(old[-int(capacity):], maxlen=int(capacity))
        if record_function is not None:
            self._record_function = bool(record_function)
        if enabled is not None:
            self._enabled = bool(enabled) and not telemetry_forced_off()
        return self

    # -- span creation ------------------------------------------------------
    def begin(self, name: str, *, detached: bool = False, **attrs):
        """Start a span. Attached spans (default) push the thread-local
        stack, so spans begun under them become children; ``detached=True``
        skips the stack — for regions ended from another thread or out of
        lexical order (async waves). Returns the no-op span when disabled."""
        if not self._enabled:
            return NOOP_SPAN
        tls = self._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        if stack:
            parent = stack[-1]
            sampled = parent.sampled
            pid = parent.sid
        else:
            s = self._sampling
            sampled = s >= 1.0 or (s > 0.0 and random.random() < s)
            pid = None
        sp = Span(name, next(self._seq), pid, threading.get_ident(), attrs,
                  sampled, self, not detached)
        if self._record_function and sampled:
            try:
                from torch.profiler import record_function
                ctx = record_function(name)
                ctx.__enter__()
                sp._prof_ctx = ctx
            except Exception:
                pass
        if not detached:
            stack.append(sp)
        sp.ts_ns = time.perf_counter_ns()
        return sp

    def span(self, name: str, **attrs):
        """``with tracer.span("external.rung", t=2) as sp: ...`` — the
        context-manager spelling of :meth:`begin`."""
        return self.begin(name, **attrs)

    def end(self, sp) -> None:
        sp.end()

    def _finish(self, sp: Span) -> None:
        if sp.dur_ns is not None:       # double end: first one wins
            return
        sp.dur_ns = time.perf_counter_ns() - sp.ts_ns
        if sp._prof_ctx is not None:
            try:
                sp._prof_ctx.__exit__(None, None, None)
            finally:
                sp._prof_ctx = None
        if sp._attached:
            stack = getattr(self._tls, "stack", None)
            if stack:
                if stack[-1] is sp:
                    stack.pop()
                else:                    # out-of-order end: drop just this one
                    try:
                        stack.remove(sp)
                    except ValueError:
                        pass
        if sp.sampled:
            self._ring.append(sp)

    # -- ring access --------------------------------------------------------
    def spans(self, last: Optional[int] = None) -> list:
        """Recorded spans, oldest first (a copy; ``last=N`` tails)."""
        out = list(self._ring)
        return out if last is None else out[-int(last):]

    def drain(self) -> list:
        """Return every recorded span and clear the ring."""
        out = list(self._ring)
        self._ring.clear()
        return out

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer every instrumented module records into."""
    return _TRACER


def span(name: str, **attrs):
    """Module-level convenience: ``with telemetry.span("name"): ...`` on the
    default tracer."""
    return _TRACER.begin(name, **attrs)

"""Process-wide metrics registry: counters/gauges/histograms with labels,
a lock-free hot path, and pluggable collectors over the repo's existing
ledgers.

Two kinds of series feed one ``snapshot()``:

* **Native instruments** — ``registry.counter(...)`` / ``gauge`` /
  ``histogram``. The write path is lock-free under the GIL: each labeled
  series keeps one accumulation cell *per writing thread* (registered once,
  under a lock, the first time that thread touches the series), and
  ``inc()``/``observe()`` mutate only the calling thread's cell — no
  contention, no atomics beyond the interpreter's own. ``snapshot()`` sums
  the cells.
* **Collectors** — zero-arg callables registered by the subsystems that
  already own a ledger (``StoreStats``, ``TickStats``, the external plan's
  rung records). A collector reads its *live* objects at snapshot time and
  emits series in the same sample shape, so the pinned ledger semantics
  (``reads == device_reads + cache_hits``) stay exactly where they are —
  the registry is a window onto them, not a replacement for them.

``reset()`` is baseline-subtraction, not cell-zeroing: zeroing another
thread's cell would race its ``+=``, and a collector's source ledger is not
ours to clear. Instead the current sample set becomes the baseline and
``snapshot()`` subtracts it from every counter-typed series (clamped at 0 —
a collector's object dying between reset and snapshot must not produce a
negative counter). Gauges are instantaneous and never baselined.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Callable, Optional

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "get_registry",
           "DEFAULT_BUCKETS"]

# latency-flavored default bounds (ms); +Inf is implicit
DEFAULT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                   100.0, 250.0, 500.0, 1000.0, 2500.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _CounterCell:
    """Per-thread accumulation cells for one labeled counter series."""

    __slots__ = ("_tls", "_cells", "_lock")

    def __init__(self):
        self._tls = threading.local()
        self._cells: list = []
        self._lock = threading.Lock()

    def inc(self, n=1):
        try:
            cell = self._tls.cell
        except AttributeError:
            cell = self._tls.cell = [0]
            with self._lock:
                self._cells.append(cell)
        cell[0] += n

    def value(self):
        with self._lock:
            cells = list(self._cells)
        return sum(c[0] for c in cells)


class _Metric:
    """Base: labeled children keyed by the sorted label tuple."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames=()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict = {}
        self._lock = threading.Lock()

    def _child_for(self, labels: dict):
        if self.labelnames and set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got "
                f"{tuple(sorted(labels))}")
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _new_child(self):
        raise NotImplementedError

    def samples(self) -> list:
        raise NotImplementedError

    def entry(self) -> dict:
        return dict(type=self.kind, help=self.help, samples=self.samples())


class Counter(_Metric):
    """Monotonic count. ``inc(n, **labels)`` is the lock-free hot path."""

    kind = "counter"

    def _new_child(self):
        return _CounterCell()

    def labels(self, **labels) -> _CounterCell:
        return self._child_for(labels)

    def inc(self, n=1, **labels) -> None:
        self._child_for(labels).inc(n)

    def samples(self) -> list:
        with self._lock:
            items = list(self._children.items())
        return [dict(labels=dict(k), value=c.value()) for k, c in items]


class Gauge(_Metric):
    """Instantaneous value; ``set()`` takes the metric lock (not a hot
    path — gauges describe state, counters describe flow)."""

    kind = "gauge"

    def _new_child(self):
        return [0.0]

    def set(self, v, **labels) -> None:
        self._child_for(labels)[0] = float(v)

    def inc(self, n=1, **labels) -> None:
        child = self._child_for(labels)
        with self._lock:
            child[0] += n

    def samples(self) -> list:
        with self._lock:
            items = list(self._children.items())
        return [dict(labels=dict(k), value=c[0]) for k, c in items]


class _HistCell:
    """Per-thread bucket counts + sum for one labeled histogram series."""

    __slots__ = ("_tls", "_cells", "_lock", "_bounds", "_nb")

    def __init__(self, bounds):
        self._bounds = bounds
        self._nb = len(bounds) + 1          # +Inf overflow bucket
        self._tls = threading.local()
        self._cells: list = []
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        try:
            cell = self._tls.cell
        except AttributeError:
            cell = self._tls.cell = [[0] * self._nb, [0.0]]
            with self._lock:
                self._cells.append(cell)
        cell[0][bisect_left(self._bounds, v)] += 1
        cell[1][0] += v

    def value(self):
        with self._lock:
            cells = list(self._cells)
        counts = [0] * self._nb
        total = 0.0
        for bc, s in cells:
            for i, c in enumerate(bc):
                counts[i] += c
            total += s[0]
        return counts, total


class Histogram(_Metric):
    """Bucketed distribution (Prometheus classic histogram shape).
    ``observe()`` is lock-free per thread; ``quantile(q)`` interpolates
    inside the landing bucket for quick p50/p99 reads."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(float(b) for b in
                             (DEFAULT_BUCKETS if buckets is None else buckets))
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError(f"histogram buckets must be sorted: {buckets}")

    def _new_child(self):
        return _HistCell(self.buckets)

    def labels(self, **labels) -> _HistCell:
        return self._child_for(labels)

    def observe(self, v, **labels) -> None:
        self._child_for(labels).observe(v)

    def samples(self) -> list:
        with self._lock:
            items = list(self._children.items())
        out = []
        for k, cell in items:
            counts, total = cell.value()
            out.append(dict(labels=dict(k), bounds=list(self.buckets),
                            counts=counts, count=sum(counts), sum=total))
        return out

    @staticmethod
    def quantile_of(sample: dict, q: float) -> float:
        """Estimate a quantile from one histogram sample (linear inside the
        landing bucket; the overflow bucket clamps to its lower bound)."""
        counts, bounds = sample["counts"], sample["bounds"]
        n = sample["count"]
        if n == 0:
            return 0.0
        target = q * n
        seen = 0
        for i, c in enumerate(counts):
            if seen + c >= target and c > 0:
                lo = bounds[i - 1] if i > 0 else 0.0
                hi = bounds[i] if i < len(bounds) else bounds[-1]
                frac = (target - seen) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            seen += c
        return bounds[-1]

    def quantile(self, q: float, **labels) -> float:
        for s in self.samples():
            if s["labels"] == {str(k): str(v) for k, v in labels.items()}:
                return self.quantile_of(s, q)
        return 0.0


class Registry:
    """Metric namespace + collector host. ``snapshot()`` is the one unified
    stat surface (see module docstring); ``reset()`` re-baselines it."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._metrics: dict = {}
        self._collectors: dict = {}          # name -> zero-arg callable
        self._lock = threading.Lock()
        self._baseline: dict = {}

    # -- instrument factories (get-or-create, type-checked) -----------------
    def _make(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, not {cls.kind}")
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._make(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._make(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=None) -> Histogram:
        return self._make(Histogram, name, help, labelnames, buckets=buckets)

    # -- collectors ---------------------------------------------------------
    def register_collector(self, fn: Callable[[], dict], *,
                           name: Optional[str] = None) -> Callable:
        """Register (or replace) a named collector: a zero-arg callable
        returning ``{metric_name: {type, help, samples}}`` fragments merged
        into every snapshot. Named registration makes module re-imports
        idempotent."""
        with self._lock:
            self._collectors[name or getattr(fn, "__name__", repr(fn))] = fn
        return fn

    # -- the unified surface ------------------------------------------------
    def collect(self) -> dict:
        """Raw sample set: native instruments + every collector, no
        baseline applied."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors.values())
        out = {}
        for m in metrics:
            out[m.name] = m.entry()
        for fn in collectors:
            for name, entry in fn().items():
                if name in out:
                    out[name]["samples"].extend(entry["samples"])
                else:
                    out[name] = dict(type=entry["type"],
                                     help=entry.get("help", ""),
                                     samples=list(entry["samples"]))
        return out

    @staticmethod
    def _flatten(snap: dict) -> dict:
        flat = {}
        for name, entry in snap.items():
            if entry["type"] == "counter":
                for s in entry["samples"]:
                    flat[(name, _label_key(s["labels"]))] = s["value"]
            elif entry["type"] == "histogram":
                for s in entry["samples"]:
                    flat[(name, _label_key(s["labels"]))] = (
                        tuple(s["counts"]), s["sum"])
        return flat

    def snapshot(self) -> dict:
        """The one stat surface: every series, counters/histograms shown as
        deltas since the last ``reset()`` (clamped at 0), gauges live."""
        snap = self.collect()
        base = self._baseline
        if not base:
            return snap
        for name, entry in snap.items():
            if entry["type"] == "counter":
                for s in entry["samples"]:
                    b = base.get((name, _label_key(s["labels"])))
                    if b is not None:
                        s["value"] = max(0, s["value"] - b)
            elif entry["type"] == "histogram":
                for s in entry["samples"]:
                    b = base.get((name, _label_key(s["labels"])))
                    if b is not None:
                        bc, bs = b
                        s["counts"] = [max(0, c - d)
                                       for c, d in zip(s["counts"], bc)]
                        s["count"] = sum(s["counts"])
                        s["sum"] = max(0.0, s["sum"] - bs)
        return snap

    def reset(self) -> None:
        """Make the current counts the zero point of future snapshots."""
        self._baseline = self._flatten(self.collect())


_REGISTRY = Registry()


def get_registry() -> Registry:
    """The process-wide registry every instrumented module reports into."""
    return _REGISTRY

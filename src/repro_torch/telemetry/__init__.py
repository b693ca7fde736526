"""Telemetry for the query and storage stack: the part the storage tier
records into.

* :mod:`registry` — process-wide metrics (counters, gauges, histograms with
  labels). The block stores and the external plan register *collectors*
  over their own ledgers, so ``snapshot()`` reads ``StoreStats`` and the
  external plan's rung totals through one surface.
* :mod:`trace` — a span tracer with per-tree sampling, a hard
  ``REPRO_TELEMETRY=off`` switch and a bounded ring buffer. With
  ``enable(record_function=True)`` every recorded span also opens a
  ``torch.profiler.record_function`` range.

Quickstart::

    from repro_torch import telemetry
    telemetry.enable(sampling=1.0)          # tracing on (off by default)
    ... run queries ...
    spans = telemetry.get_tracer().spans()
    snap = telemetry.snapshot()             # every counter, one dict
"""
from .registry import (Counter, DEFAULT_BUCKETS, Gauge, Histogram, Registry,
                       get_registry)
from .trace import (NOOP_SPAN, Span, TELEMETRY_ENV, Tracer, get_tracer, span,
                    telemetry_forced_off)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "DEFAULT_BUCKETS",
    "get_registry", "Span", "Tracer", "get_tracer", "span", "NOOP_SPAN",
    "TELEMETRY_ENV", "telemetry_forced_off", "snapshot", "reset", "enable",
    "disable",
]


def snapshot() -> dict:
    """Every metric series in one dict (see Registry.snapshot)."""
    return get_registry().snapshot()


def reset() -> None:
    """Re-baseline the registry and clear the tracer's span ring."""
    get_registry().reset()
    get_tracer().clear()


def enable(*, sampling: float = 1.0, capacity=None,
           record_function=None) -> Tracer:
    """Turn span tracing on (``REPRO_TELEMETRY=off`` still wins)."""
    return get_tracer().configure(enabled=True, sampling=sampling,
                                  capacity=capacity,
                                  record_function=record_function)


def disable() -> Tracer:
    """Turn span tracing off (the zero-overhead default)."""
    return get_tracer().configure(enabled=False)

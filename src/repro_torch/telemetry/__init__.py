"""Telemetry for the query, storage and serving stack (docs/torch_telemetry.md).

* :mod:`registry` — process-wide metrics (counters and histograms with
  labels). The block stores, the external plan and the serving queue
  register *collectors* over their own ledgers, so ``snapshot()`` reads
  ``StoreStats``, the external plan's rung totals and the queue's
  ``TickStats`` and QoS log through one surface.
* :mod:`trace` — a span tracer with per-tree sampling, a hard
  ``REPRO_TELEMETRY=off`` switch and a bounded ring buffer. With
  ``enable(record_function=True)`` every recorded span also opens a
  ``torch.profiler.record_function`` range.
* :mod:`export` / :mod:`http` — Perfetto/chrome-trace and JSONL span
  exporters, Prometheus text rendering, and the live ``/metrics`` +
  ``/trace?last=N`` + ``/snapshot`` server (``serve.py --metrics-port``).

Quickstart::

    from repro_torch import telemetry
    telemetry.enable(sampling=1.0)          # tracing on (off by default)
    ... run queries ...
    telemetry.export_chrome_trace("trace.json")   # -> ui.perfetto.dev
    snap = telemetry.snapshot()             # every counter, one dict
    print(telemetry.render_prometheus(snap))
"""
from .export import (export_chrome_trace, export_jsonl, render_prometheus,
                     spans_to_chrome)
from .http import MetricsServer
from .registry import Counter, DEFAULT_BUCKETS, Histogram, Registry, get_registry
from .trace import (NOOP_SPAN, Span, TELEMETRY_ENV, Tracer, get_tracer, span,
                    telemetry_forced_off)

__all__ = [
    "Counter", "Histogram", "Registry", "DEFAULT_BUCKETS",
    "get_registry", "Span", "Tracer", "get_tracer", "span", "NOOP_SPAN",
    "TELEMETRY_ENV", "telemetry_forced_off", "MetricsServer",
    "export_chrome_trace", "export_jsonl", "render_prometheus",
    "spans_to_chrome", "snapshot", "reset", "enable", "disable",
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

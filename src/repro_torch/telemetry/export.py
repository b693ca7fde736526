"""Exporters: Perfetto/chrome-trace JSON + JSONL for spans, Prometheus
text format for registry snapshots.

The chrome-trace output is the ``traceEvents`` array format (complete
``ph="X"`` events, microsecond ``ts``/``dur``) that both ``chrome://tracing``
and https://ui.perfetto.dev load directly — save, open, drop the file in.
Span attributes ride in ``args`` (with ``sid``/``parent`` ids, so the tree
survives even though the viewer lays out by thread track), and timestamps
are normalized so the trace starts at 0.
"""
from __future__ import annotations

import json
from typing import Iterable, Optional

__all__ = ["spans_to_chrome", "export_chrome_trace", "export_jsonl",
           "render_prometheus"]


def spans_to_chrome(spans: Iterable, *, pid: int = 1) -> dict:
    """Chrome-trace document for a span list (Perfetto-loadable)."""
    spans = list(spans)
    t0 = min((sp.ts_ns for sp in spans), default=0)
    events = []
    tids = {}
    for sp in spans:
        tid = tids.setdefault(sp.tid, len(tids) + 1)
        args = {k: v for k, v in sp.attrs.items()}
        args["sid"] = sp.sid
        if sp.parent is not None:
            args["parent"] = sp.parent
        events.append(dict(
            name=sp.name, cat=sp.name.split(".", 1)[0], ph="X",
            ts=(sp.ts_ns - t0) / 1e3, dur=(sp.dur_ns or 0) / 1e3,
            pid=pid, tid=tid, args=args,
        ))
    for raw, tid in tids.items():
        events.append(dict(name="thread_name", ph="M", pid=pid, tid=tid,
                           args=dict(name=f"thread-{raw}")))
    return dict(traceEvents=events, displayTimeUnit="ms")


def export_chrome_trace(path, spans=None, *, tracer=None) -> int:
    """Write a Perfetto-loadable trace; returns the span count written.
    ``spans`` defaults to the (given or default) tracer's ring."""
    if spans is None:
        if tracer is None:
            from .trace import get_tracer
            tracer = get_tracer()
        spans = tracer.spans()
    spans = list(spans)
    with open(path, "w") as f:
        json.dump(spans_to_chrome(spans), f)
    return len(spans)


def export_jsonl(path, spans=None, *, tracer=None) -> int:
    """One span dict per line (grep/pandas-friendly); returns span count."""
    if spans is None:
        if tracer is None:
            from .trace import get_tracer
            tracer = get_tracer()
        spans = tracer.spans()
    spans = list(spans)
    with open(path, "w") as f:
        for sp in spans:
            f.write(json.dumps(sp.as_dict()) + "\n")
    return len(spans)


# --------------------------------------------------------------------------
# Prometheus text exposition (format 0.0.4)
# --------------------------------------------------------------------------

def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", r"\\").replace('"', r"\"")
                         .replace("\n", r"\n"))
        for k, v in sorted(merged.items()))
    return "{" + body + "}"


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return repr(v)
    return str(v)


def render_prometheus(snapshot: dict) -> str:
    """Render a registry snapshot as Prometheus text format. Histograms
    expand to the classic ``_bucket``/``_sum``/``_count`` triple with
    cumulative ``le`` buckets."""
    lines = []
    for name in sorted(snapshot):
        entry = snapshot[name]
        kind = entry["type"]
        if entry.get("help"):
            lines.append(f"# HELP {name} {entry['help']}")
        lines.append(f"# TYPE {name} {kind}")
        for s in entry["samples"]:
            if kind == "histogram":
                cum = 0
                for bound, c in zip(s["bounds"] + [float("inf")],
                                    s["counts"]):
                    cum += c
                    le = "+Inf" if bound == float("inf") else repr(bound)
                    lines.append(f"{name}_bucket"
                                 f"{_fmt_labels(s['labels'], {'le': le})}"
                                 f" {cum}")
                lines.append(f"{name}_sum{_fmt_labels(s['labels'])}"
                             f" {_fmt_value(s['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(s['labels'])}"
                             f" {s['count']}")
            else:
                lines.append(f"{name}{_fmt_labels(s['labels'])}"
                             f" {_fmt_value(s['value'])}")
    return "\n".join(lines) + "\n"

"""The program's spans and counters as a traced run hands them to the
readers: ``ctx["spans"]``, the spans the port's tracer recorded inside the
window, and ``ctx["counters"]``, ``telemetry.snapshot()`` at the window's
close with the registry re-based at its start (``Registry.reset``), so
that each counter and histogram holds the window's change. Both are None
in an untraced run, which takes no snapshot.

A span keeps the tracer's own fields: its name, its id and its parent's
(None for a root), its attributes, and its bounds on the host clock
(``time.perf_counter_ns``, the clock of the window's bounds).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .trace import union

__all__ = ["ProgramSpan", "window_spans", "share_under", "count"]


@dataclasses.dataclass(frozen=True)
class ProgramSpan:
    name: str
    start_ns: int
    end_ns: int
    sid: int
    parent: Optional[int]
    attrs: dict


def window_spans(spans, ws: int, we: int) -> list:
    """The tracer's finished spans that overlap the window [ws, we], clipped
    to it, oldest first."""
    out = []
    for s in spans:
        end = s.ts_ns + (s.dur_ns or 0)
        if end > ws and s.ts_ns < we:
            out.append(ProgramSpan(s.name, max(s.ts_ns, ws), min(end, we), s.sid, s.parent,
                                   dict(s.attrs)))
    return out


def share_under(ctx, name: str):
    """The host time under spans called ``name`` (their union, inside the
    window) over the window's wall time; None without spans or without one
    of that name."""
    spans, ws = ctx["spans"], ctx["window_s"]
    if not spans or not ws:
        return None
    ivs = [(s.start_ns, s.end_ns) for s in spans if s.name == name]
    if not ivs:
        return None
    return sum(e - s for s, e in union(ivs)) * 1e-9 / ws


def count(ctx, name: str, *, root: bool = False):
    """How many spans called ``name`` (only roots, with ``root``) the window
    holds; None without spans."""
    spans = ctx["spans"]
    if not spans:
        return None
    return sum(1 for s in spans if s.name == name and (not root or s.parent is None))

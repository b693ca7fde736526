"""The traced window: device time from ``torch.profiler`` and idle gaps
labelled by what the host was doing.

The profiler records the card's activity only (kernels, copies, sets), so
the host pays little for it. Its timeline is tied to the host clock
(``time.perf_counter_ns``, which the program's spans and the harness's own
use) by a marker kernel launched after a synchronise just before and just
after the window. Device busy time is the union of the device intervals
inside the window; every stretch between them is an idle gap, labelled by
the innermost span open at its midpoint: the program's spans first, then
the harness's.
"""
from __future__ import annotations

import bisect
import dataclasses
import time

__all__ = ["Span", "TraceSummary", "DeviceTrace", "union", "summarise", "short_name",
           "idle_share"]

_MARK_CYCLES = 20_000   # the marker kernel's spin (about 10 us)
_MARKER = "spin_kernel"
_TOP = 10
_NAME_CHARS = 96


@dataclasses.dataclass(frozen=True)
class Span:
    """A host interval (perf_counter ns) and its label."""

    start: int
    end: int
    label: str


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    device_ops: list      # [[name, seconds], ...], the most device time first
    idle_gaps: list       # [[label, seconds], ...], idle time by host label


def union(intervals):
    """Sorted, merged [(start, end)] of possibly overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _label_at(spans, starts, t: int) -> str:
    """The label of the span with the latest start that contains t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 256), -1):
        if spans[j].end >= t:
            return spans[j].label
    return ""


def summarise(events, ws: int, we: int, program_spans, harness_spans) -> TraceSummary:
    """``events``: (name, start_ns, end_ns) device intervals on the host
    clock; [ws, we] the window. Spans: lists of ``Span``."""
    clipped = [(max(s, ws), min(e, we), n) for n, s, e in events if e > ws and s < we]
    merged = union((s, e) for s, e, _ in clipped if e > s)
    busy = sum(e - s for s, e in merged)
    by_name: dict = {}
    for s, e, n in clipped:
        by_name[n] = by_name.get(n, 0) + (e - s)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]
    prog = sorted(program_spans, key=lambda sp: sp.start)
    harn = sorted(harness_spans, key=lambda sp: sp.start)
    p_starts = [sp.start for sp in prog]
    h_starts = [sp.start for sp in harn]
    gaps, prev = [], ws
    for s, e in merged + [(we, we)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle: dict = {}
    for s, e in gaps:
        mid = (s + e) // 2
        label = _label_at(prog, p_starts, mid) or _label_at(harn, h_starts, mid) or "outside"
        idle[label] = idle.get(label, 0) + (e - s)
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:_TOP]
    return TraceSummary(busy_s=busy * 1e-9, window_s=(we - ws) * 1e-9,
                        device_ops=[[n, v * 1e-9] for n, v in top_ops],
                        idle_gaps=[[n, v * 1e-9] for n, v in top_idle])


def idle_share(ctx):
    """The device's idle share of the traced window: 1 - (union of the device
    intervals in the profiler's trace) / (the window's wall time); None
    without a trace. The reader of every ``device.idle_share.*`` metric."""
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s


def short_name(name: str) -> str:
    """A device operation's name without its return type and its argument
    list (the last top-level parenthesis group)."""
    name = name[5:] if name.startswith("void ") else name
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, 0, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:_NAME_CHARS].strip()


def _event_times(ev):
    start = ev.start_ns() if hasattr(ev, "start_ns") else ev.start_us() * 1000
    dur = ev.duration_ns() if hasattr(ev, "duration_ns") else ev.duration_us() * 1000
    return int(start), int(start + dur)


def _clock_offset(device_marks, host_marks, intervals, ws: int, we: int) -> int:
    """The shift from the host clock to the trace's: a marker kernel starts a
    launch latency after its host timestamp. Each pairing of a marker found
    in the trace with a host timestamp gives a candidate (the profiler can
    drop a record, so either marker may be missing); the right one puts the
    device's intervals inside the window, and of equals the smallest, whose
    launch latency is least, is taken."""
    if not device_marks:
        raise RuntimeError("the trace holds no marker kernel: the device timeline "
                           "cannot be tied to the host clock")
    best = None
    for m in device_marks:
        for h in host_marks:
            off = m - h
            inside = sum(1 for s, e in intervals if ws <= s - off and e - off <= we)
            key = (-inside, off if off >= 0 else float("inf"))
            if best is None or key < best[0]:
                best = (key, off)
    return best[1]


class DeviceTrace:
    """``with DeviceTrace() as tr: ... tr.window(ws, we)`` around a window on
    the card; ``tr.summary(program_spans, harness_spans)`` afterwards."""

    def __init__(self):
        self._prof = None
        self._marks = []
        self._window = None

    def _mark(self):
        import torch
        torch.cuda.synchronize()
        t = time.perf_counter_ns()
        torch.cuda._sleep(_MARK_CYCLES)
        torch.cuda.synchronize()
        self._marks.append(t)

    def __enter__(self) -> "DeviceTrace":
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.zeros(1, device="cuda")       # the activity records are flowing
        self._mark()
        return self

    def __exit__(self, *exc) -> bool:
        self._mark()
        self._prof.stop()
        return False

    def window(self, ws: int, we: int) -> None:
        self._window = (ws, we)

    def _device_events(self):
        from torch.autograd import DeviceType
        out = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            s, e = _event_times(ev)
            out.append((ev.name(), s, e))
        return out

    def summary(self, program_spans, harness_spans) -> TraceSummary:
        events = self._device_events()
        marks = [s for n, s, e in events if _MARKER in n]
        ws, we = self._window
        offset = _clock_offset(marks, self._marks, [(s, e) for n, s, e in events
                                                    if _MARKER not in n], ws, we)
        host = [(short_name(n), s - offset, e - offset) for n, s, e in events
                if _MARKER not in n]
        return summarise(host, ws, we, program_spans, harness_spans)

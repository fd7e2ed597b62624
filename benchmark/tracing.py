"""The traced run's profiler window and its reduction to device numbers.

In a traced run (--trace 1) the harness opens one profiler over the whole
window (CPU and CUDA activities); while it records, every span the program
opens (`utils.perf.phase`) is also a profiler range named "span:<name>".
The harness reduces the profiler's raw events to:

- kernel_s: device seconds by kernel, copy or set name;
- busy_s: the union of the device's intervals inside the window;
- window_s: the window's length (its "bench:window" range);
- idle_gaps: device idle seconds inside the window, by the innermost span
  open on the host meanwhile ("outside_spans" where none was);
- busy_by_span: device busy seconds the same way (device work that runs
  on under a span that launched none, such as `output`, is work that an
  earlier span left unfinished at its end).
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "bench:window"
SPAN = "span:"


def open_profiler():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def _ns(ev, start: bool) -> float:
    if start:
        f = getattr(ev, "start_ns", None)
        return float(f()) if f is not None else float(ev.start_us()) * 1e3
    f = getattr(ev, "duration_ns", None)
    return float(f()) if f is not None else float(ev.duration_us()) * 1e3


def raw_events(prof) -> List[Tuple[str, bool, float, float]]:
    """(name, on_device, start_ns, end_ns) of every event the profiler
    kept."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.profiler.kineto_results.events():
        s = _ns(ev, True)
        out.append((ev.name(), ev.device_type() != DeviceType.CPU, s,
                    s + _ns(ev, False)))
    return out


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def host_segments(spans: List[Tuple[float, float, str]]
                  ) -> List[Tuple[float, float, str]]:
    """The host's timeline as [start, end) pieces, each labelled with the
    innermost span open there (spans nest: they are context managers of
    one thread)."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []
    t = None

    def emit(until):
        if stack and t is not None and until > t:
            out.append((t, until, stack[-1][1]))

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            t = stack[-1][0]
            stack.pop()
        emit(s)
        t = s
        stack.append((e, name))
    while stack:
        emit(stack[-1][0])
        t = stack[-1][0]
        stack.pop()
    return out


def gaps(busy: List[Tuple[float, float]], w0: float, w1: float
         ) -> List[Tuple[float, float]]:
    """The complement of the sorted, disjoint `busy` inside [w0, w1)."""
    out = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            out.append((prev, min(s, w1)))
        prev = max(prev, e)
    return out


def by_span(intervals: List[Tuple[float, float]],
            segments: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """The length of sorted, disjoint intervals by the host's innermost
    span over them ("outside_spans" where none was open)."""
    out: Dict[str, float] = defaultdict(float)
    ends = [e for _, e, _ in segments]
    for g0, g1 in intervals:
        covered = 0.0
        i = bisect.bisect_right(ends, g0)
        while i < len(segments) and segments[i][0] < g1:
            s, e, name = segments[i]
            ov = min(e, g1) - max(s, g0)
            if ov > 0:
                out[name] += ov
                covered += ov
            i += 1
        if g1 - g0 - covered > 0:
            out["outside_spans"] += g1 - g0 - covered
    return out


def reduce(events: List[Tuple[str, bool, float, float]]) -> Optional[Dict]:
    """The window's device numbers from the raw events; None when the trace
    holds no window range."""
    win = [(s, e) for name, dev, s, e in events
           if not dev and name == WINDOW]
    if not win:
        return None
    w0, w1 = win[0]
    kernel_ns: Dict[str, float] = defaultdict(float)
    dev_iv = []
    spans = []
    for name, dev, s, e in events:
        if dev:
            if name.startswith(SPAN) or name == WINDOW:
                continue          # the annotations' mirror on the GPU row
            s, e = max(s, w0), min(e, w1)
            if e > s:
                kernel_ns[name] += e - s
                dev_iv.append((s, e))
        elif name.startswith(SPAN):
            spans.append((s, e, name[len(SPAN):]))
    busy = union(dev_iv)
    segments = host_segments(spans)
    idle = by_span(gaps(busy, w0, w1), segments)
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "kernel_s": {k: v * 1e-9 for k, v in kernel_ns.items()},
        "idle_gaps": {k: v * 1e-9 for k, v in idle.items()},
        "busy_by_span": {k: v * 1e-9 for k, v in
                         by_span(busy, segments).items()},
    }


def breakdown(summary: Dict) -> Dict:
    """The result line's breakdown: the ten device operations that took
    most time, and the ten spans the host was in while the card idled
    longest, each [name, seconds]."""
    ops = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}

"""Phase timing and work counters (SURVEY §5.1).

The reference's only observability was Progress bars and cout phase lines;
its validation was external timing tables (Tables/Real.csv).
Here every pipeline phase is a span: its host wall, on the monotonic
clock, summed by name over the process (or since reset()). While a
torch.profiler is active (MESHCLUST_TRACE, a benchmark's traced window)
each span is also a profiler range named "span:<name>", stamped on the
clock of the trace's device activity, so the trace says what the host was
doing while the card idled; with no profiler on, a span costs one flag
test more. Counters sum work (NW cells and pairs, Phase A iterations,
collectives), and the report gives the NW cells a second of the `align`
span.

Usage:
    with perf.phase("train"):
        ...
    perf.add("nw_cells", l1 @ l2)
    perf.report()   -> dict        perf.format_report() -> str
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

SPAN_PREFIX = "span:"

_phase_s: Dict[str, float] = defaultdict(float)
_phase_n: Dict[str, int] = defaultdict(int)
_counters: Dict[str, float] = defaultdict(float)
_t0 = time.perf_counter()
_profiling = None       # torch.autograd._profiler_enabled, on first use


def reset() -> None:
    _phase_s.clear()
    _phase_n.clear()
    _counters.clear()
    global _t0
    _t0 = time.perf_counter()


def profiler_on() -> bool:
    """Whether a torch.profiler is recording (torch imported on first
    call)."""
    global _profiling
    if _profiling is None:
        import torch
        _profiling = torch.autograd._profiler_enabled
    return _profiling()


@contextlib.contextmanager
def phase(name: str):
    t = time.perf_counter()
    try:
        if profiler_on():
            import torch
            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
        else:
            yield
    finally:
        _phase_s[name] += time.perf_counter() - t
        _phase_n[name] += 1


def add(counter: str, amount: float) -> None:
    _counters[counter] += float(amount)


def counters() -> Dict[str, float]:
    return dict(_counters)


def phases() -> Dict[str, float]:
    return dict(_phase_s)


def report() -> dict:
    out: dict = {"wall_s": time.perf_counter() - _t0,
                 "phases_s": dict(_phase_s),
                 "phase_calls": dict(_phase_n),
                 "counters": dict(_counters)}
    align_s = _phase_s.get("align", 0.0)
    cells = _counters.get("nw_cells", 0.0)
    if align_s > 0 and cells > 0:
        out["nw_cells_per_s"] = cells / align_s
    return out


def format_report() -> str:
    r = report()
    lines = [f"total wall: {r['wall_s']:.2f}s"]
    for k, v in sorted(r["phases_s"].items(), key=lambda kv: -kv[1]):
        lines.append(f"  phase {k:<14s} {v:8.2f}s  x{r['phase_calls'][k]}")
    for k, v in sorted(r["counters"].items()):
        lines.append(f"  counter {k:<18s} {v:.3g}")
    if "nw_cells_per_s" in r:
        lines.append(f"  nw_cells_per_s: {r['nw_cells_per_s']:.3g}")
    return "\n".join(lines)

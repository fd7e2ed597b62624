"""Align mode's host Phase A (core.meanshift.MeanShift._accumulate_one over
AlignBackend): the utils.perf span `accumulate` over the window, in ms,
divided by the counter `accum_host_iters` (one a pass of the host loop: an
absorb or a close)."""


def read(run):
    iters = run.counters.get("accum_host_iters", 0.0)
    if not iters or "accumulate" not in run.phases:
        return None
    return run.phases["accumulate"] * 1e3 / iters

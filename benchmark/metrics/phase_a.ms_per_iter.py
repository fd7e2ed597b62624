"""Phase A (core.accumulate_device): the utils.perf span `accumulate` over
the window, in ms, divided by the counter `accum_iters` (absorb and move
iterations of the device loop)."""


def read(run):
    iters = run.counters.get("accum_iters", 0.0)
    if not iters or "accumulate" not in run.phases:
        return None
    return run.phases["accumulate"] * 1e3 / iters

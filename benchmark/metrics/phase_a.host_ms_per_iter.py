"""Phase A's host time an iteration (core.accumulate_device), in ms: the
utils.perf span `accum_loop` (the absorb/move loop) less the counter
`accum_wait_s` (the host blocked in the iterations' readbacks), over the
counter `accum_iters`."""


def read(run):
    iters = run.counters.get("accum_iters", 0.0)
    if (not iters or "accum_loop" not in run.phases
            or "accum_wait_s" not in run.counters):
        return None
    return (run.phases["accum_loop"] - run.counters["accum_wait_s"]) \
        * 1e3 / iters

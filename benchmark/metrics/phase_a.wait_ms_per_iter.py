"""Phase A's wait an iteration (core.accumulate_device), in ms: the
counter `accum_wait_s` (host seconds blocked in the iterations' one
readback each, which waits for their kernels) over the counter
`accum_iters`."""


def read(run):
    iters = run.counters.get("accum_iters", 0.0)
    if not iters or "accum_wait_s" not in run.counters:
        return None
    return run.counters["accum_wait_s"] * 1e3 / iters

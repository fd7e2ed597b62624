"""The card's idle share of the window, in %: 100 less the union of its
kernel, copy and set intervals from torch.profiler over the window's host
wall."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])

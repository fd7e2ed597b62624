"""Align mode's host Phase B means (core.classify.AlignBackend.update_banded:
the chunked mean and argmin over each center's positive members): the
utils.perf span `update_mean` summed over the window's jobs, divided by the
number of jobs that completed."""


def read(run):
    if not run.jobs or "update_mean" not in run.phases:
        return None
    return run.phases["update_mean"] / run.jobs

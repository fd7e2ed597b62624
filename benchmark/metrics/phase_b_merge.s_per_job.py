"""Align mode's host Phase B merges (core.meanshift.MeanShift.merge_once,
one a Phase B iteration): the utils.perf span `phase_b_merge` summed
over the window's jobs, divided by the number of jobs that completed."""


def read(run):
    if not run.jobs or "phase_b_merge" not in run.phases:
        return None
    return run.phases["phase_b_merge"] / run.jobs

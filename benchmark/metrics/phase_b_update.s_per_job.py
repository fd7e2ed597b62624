"""Align mode's host Phase B updates (core.meanshift.MeanShift.update_once,
one a Phase B iteration): the utils.perf span `phase_b_update` summed
over the window's jobs, divided by the number of jobs that completed."""


def read(run):
    if not run.jobs or "phase_b_update" not in run.phases:
        return None
    return run.phases["phase_b_update"] / run.jobs

"""Phase B (core.meanshift.MeanShift.run): the fused device loop, or the
host loop of update_once and merge_once (align mode): the utils.perf
span `phase_b` summed over the window's jobs, divided by the number of
jobs that completed."""


def read(run):
    if not run.jobs or "phase_b" not in run.phases:
        return None
    return run.phases["phase_b"] / run.jobs

"""Clustering (core.meanshift, core.classify, core.accumulate_device,
ops.phase_a, ops.phase_b): the utils.perf span `cluster` summed over the
window's jobs, divided by the number of jobs that completed."""


def read(run):
    if not run.jobs or "cluster" not in run.phases:
        return None
    return run.phases["cluster"] / run.jobs

"""Featurization (core.points.build_points, ops.histogram): the
utils.perf span `featurize` summed over the window's jobs, divided by
the number of jobs that completed."""


def read(run):
    if not run.jobs or "featurize" not in run.phases:
        return None
    return run.phases["featurize"] / run.jobs

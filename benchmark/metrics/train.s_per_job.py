"""Training (core.trainer, ops.glm, ops.features): the utils.perf span
`train` summed over the window's jobs, divided by the number of jobs
that completed."""


def read(run):
    if not run.jobs or "train" not in run.phases:
        return None
    return run.phases["train"] / run.jobs

"""Training's binary-search walk (core.trainer.Trainer.split, fused or
round by round; `probe_gather` and `align` nested inside): the
utils.perf span `train_probe` summed over the window's jobs, divided by
the number of jobs that completed."""


def read(run):
    if not run.jobs or "train_probe" not in run.phases:
        return None
    return run.phases["train_probe"] / run.jobs

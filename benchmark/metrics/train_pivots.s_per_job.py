"""Training's pivot choice and orders (core.trainer.Trainer.split: the
native std::sort chain, or the fallback's device orders): the utils.perf
span `train_pivots` summed over the window's jobs, divided by the number
of jobs that completed."""


def read(run):
    if not run.jobs or "train_pivots" not in run.phases:
        return None
    return run.phases["train_pivots"] / run.jobs

"""Training's pair assembly (core.trainer.Trainer.split: the boundary
positions, their gather, the header dedup and the sort): the utils.perf
span `train_pairs` summed over the window's jobs, divided by the number
of jobs that completed."""


def read(run):
    if not run.jobs or "train_pairs" not in run.phases:
        return None
    return run.phases["train_pairs"] / run.jobs

"""Training's labels (core.trainer.Trainer.get_labels: the shuffle, the
labelling alignments, the set order, the resize): the utils.perf span
`train_labels` summed over the window's jobs, divided by the number of
jobs that completed."""


def read(run):
    if not run.jobs or "train_labels" not in run.phases:
        return None
    return run.phases["train_labels"] / run.jobs

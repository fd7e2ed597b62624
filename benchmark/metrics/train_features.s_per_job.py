"""Training's feature rows (core.trainer.Trainer.train's loop: pair_raw,
normalize_raw, feature_matrix, predict and accuracy): the utils.perf
span `train_features` summed over the window's jobs, divided by the
number of jobs that completed."""


def read(run):
    if not run.jobs or "train_features" not in run.phases:
        return None
    return run.phases["train_features"] / run.jobs

"""Training's GLM fits (ops.glm.train, the float64 least squares, in
core.trainer.Trainer.train's loop): the utils.perf span `train_glm`
summed over the window's jobs, divided by the number of jobs that
completed."""


def read(run):
    if not run.jobs or "train_glm" not in run.phases:
        return None
    return run.phases["train_glm"] / run.jobs

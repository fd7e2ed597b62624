"""The run's set-up between stages (core.runner._run): find_k; the aligner
and trainer objects; make_backend, the bvec fill and MeanShift: the
utils.perf span `prepare` summed over the window's jobs, divided by the
number of jobs that completed."""


def read(run):
    if not run.jobs or "prepare" not in run.phases:
        return None
    return run.phases["prepare"] / run.jobs

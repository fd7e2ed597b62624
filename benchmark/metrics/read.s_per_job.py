"""FASTA reading (io.fasta via core.runner): the utils.perf span `read`
summed over the window's jobs, divided by the number of jobs that
completed."""


def read(run):
    if not run.jobs or "read" not in run.phases:
        return None
    return run.phases["read"] / run.jobs

"""The aligner (ops.align_device.DeviceAligner): the utils.perf span
`align` summed over the window's jobs, divided by the number of jobs
that completed."""


def read(run):
    if not run.jobs or "align" not in run.phases:
        return None
    return run.phases["align"] / run.jobs

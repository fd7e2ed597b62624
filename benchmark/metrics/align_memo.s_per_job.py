"""Align mode's identity memo (core.classify.AlignBackend._identities over
_PairMemo): the utils.perf span `align_memo` (keys, lookups, inserts)
summed over the window's jobs, divided by the number of jobs that
completed."""


def read(run):
    if not run.jobs or "align_memo" not in run.phases:
        return None
    return run.phases["align_memo"] / run.jobs

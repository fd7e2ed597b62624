"""Sequences in all the jobs the window completed, over the window's wall
time (host clock; the window ends when its last job does)."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.seqs_done / run.window_s

"""Process start to the window's start (host clock): imports, the CUDA
context, the kernel library (built on a checkout's first run), the pool of
corpora and one warm-up job."""


def read(run):
    return run.setup_s

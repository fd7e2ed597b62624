"""kmer_hist's share of its roofline, in %: the frozen bound of each job's
launch (benchmark/rooflines/kmer_hist.py, from the corpus's bases, reads
and segments and 4^k), summed over the window's jobs, over the profiler's
device time of the kernels named so. Nothing to read without a trace or
without a launch."""
from benchmark.rooflines import kmer_hist as R


def read(run):
    if run.trace is None:
        return None
    dev_s = sum(s for name, s in run.trace["kernel_s"].items()
                if any(k in name for k in R.KERNELS))
    if dev_s <= 0 or not run.job_inputs:
        return None
    bound = sum(R.launch_bound_s(j["bases"], j["reads"], j["segments"],
                                 j["k"]) for j in run.job_inputs)
    return 100.0 * bound / dev_s

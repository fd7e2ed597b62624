"""nw_align_long's share of its roofline, in %: the frozen bound
(benchmark/rooflines/nw_align_long.py) of the window's counters `nw_cells`
and `nw_pairs` (the work of the pairs, whatever computes them) over the
profiler's device time of the kernel named so."""
from benchmark.rooflines import nw_align_long as R


def read(run):
    if run.trace is None:
        return None
    dev_s = sum(s for name, s in run.trace["kernel_s"].items()
                if any(k in name for k in R.KERNELS))
    cells = run.counters.get("nw_cells", 0.0)
    if dev_s <= 0 or cells <= 0:
        return None
    return 100.0 * R.pairs_bound_s(cells, run.counters.get("nw_pairs", 0.0)
                                   ) / dev_s

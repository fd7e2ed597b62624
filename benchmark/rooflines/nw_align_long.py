"""The bound of the NW kernel (csrc/nw_align_long.cu) on a set of pairs,
frozen from chip_smoke.py's `nw_bound`: a DP cell of the GlobAlignE
recurrence takes 18 compares and selects (four choices, each a compare and
three selects of score, D and X, and the substitution score's compare and
select), on the ALU pipe alone, and 7 adds besides, at the dispatch rate;
whichever takes longer. Bytes: each pair's codes read once and two int32
written; with only the counts of cells and pairs known, the bytes counted
are the outputs, 8 a pair: a lower bound, and far below the operations'
time at any length the port aligns.
"""
from __future__ import annotations

from benchmark.rooflines.peaks import (DISPATCH_OPS_PER_S, INT32_OPS_PER_S,
                                       bound_s)

KERNELS = ("nw_align_long_kernel",)
ALU_OPS_PER_CELL = 18
OPS_PER_CELL = ALU_OPS_PER_CELL + 7


def ops_s(cells: float) -> float:
    return max(cells * ALU_OPS_PER_CELL / INT32_OPS_PER_S,
               cells * OPS_PER_CELL / DISPATCH_OPS_PER_S)


def pairs_bound_s(cells: float, pairs: float) -> float:
    """The least time of `pairs` alignments of `cells` DP cells in all."""
    return bound_s(8.0 * pairs, ops_s(cells))

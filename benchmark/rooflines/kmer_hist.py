"""The bound of one kmer_hist launch (csrc/kmer_hist.cu), frozen from
chip_smoke.py's `kmer_bound`: its inputs read once and its five outputs
written once at the HBM rate, or a few int32 operations a base on the ALU
pipe, whichever takes longer.

Inputs: the codes at one byte a base, padded to 16 bytes; rec_off and
seg_off, [N + 1] int64; segs, [S, 2] int64. Outputs: the counts [N, 4^k]
int32, the 1-mer counts [N, 4] int32, mag and sq [N] int64, and the largest
count, one int32.
"""
from __future__ import annotations

from benchmark.rooflines.peaks import INT32_OPS_PER_S, bound_s

# Kernel names in the profiler's trace (the rows and the split mode).
KERNELS = ("kmer_rows_kernel", "kmer_split_kernel")
OPS_PER_BASE = 4.0


def launch_bytes(bases: int, reads: int, segments: int, k: int) -> int:
    codes = -(-max(bases, 1) // 16) * 16
    inputs = codes + 2 * (reads + 1) * 8 + segments * 2 * 8
    outputs = reads * (4 ** k) * 4 + reads * 4 * 4 + 2 * reads * 8 + 4
    return inputs + outputs


def launch_bound_s(bases: int, reads: int, segments: int, k: int) -> float:
    return bound_s(launch_bytes(bases, reads, segments, k),
                   OPS_PER_BASE * bases / INT32_OPS_PER_S)

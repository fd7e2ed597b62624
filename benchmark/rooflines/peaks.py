"""One H100 SXM's published peaks and the least time of a piece of work.

Frozen from chip_smoke.py (`HBM_BYTES_PER_S`, `INT32_OPS_PER_S`,
`DISPATCH_OPS_PER_S`, `bound`): NVIDIA's data sheet gives 3.35 TB/s of HBM;
the INT32 ALU pipe, which alone runs compares and selects, issues 64 lanes
an SM a cycle on 132 SMs at the 1.98 GHz boost clock; the dispatch rate of
ALU and FMA pipes together, where integer adds also go, is 128 lanes an SM
a cycle. The peaks assume the card's full 700 W limit; each run reports the
card's limit beside its numbers.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
DISPATCH_OPS_PER_S = 132 * 128 * 1.98e9


def bound_s(nbytes: float, ops_s: float) -> float:
    """The least time of a kernel that moves `nbytes` and whose operations
    take `ops_s` seconds at the card's peak: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, ops_s)

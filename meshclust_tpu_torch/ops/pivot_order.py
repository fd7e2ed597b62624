"""Training's pivot orders: a CUDA kernel (csrc/pivot_order.cu) and its plain
version.

Trainer._ref_order_chain (core/trainer.py) orders every point by its
DivergencePoint distance key to a pivot, with the order std::sort leaves
tied keys in (Trainer.cpp:672-700): the begin point's row over the length
order, then each pivot's row over the begin row's order. `orders` computes
a batch of rows that share one input order: on a CUDA device one launch of
`pivot_order` (a block a row: the keys from the histogram, then libstdc++'s
introsort and its tie order, see the source's note); on the CPU the plain
version, which is the host chain the kernel replaces: the exact Manhattan
rows as torch ops on the histogram's device, the keys in float64 on the
host (PointSet.distance_rows_device) and native/refsort.cpp's std::sort a
row. A CUDA tensor never falls back to the plain version.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from meshclust_tpu_torch import _ext

# csrc/pivot_order.cu's block (kPoThreads), libstdc++'s _S_threshold
# (kThreshold) and the ranges past which the whole block partitions
# (kLarge; a warp partitions the others).
THREADS = 512
THRESHOLD = 16
LARGE = 2048

Rows = Union[Sequence[int], np.ndarray, torch.Tensor]


def orders(ps, rows: Rows, perm: torch.Tensor,
           heaps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[P, n] int32 on ps.device: row r is `perm` ([n] int32, every point
    once) ordered by the keys of pivot rows[r] as std::sort orders it. On
    the card, heaps ([1] int32) gains the ranges that took the depth-limit
    heap path."""
    if ps.device.type == "cpu":
        return orders_plain(ps, rows, perm)
    hist = ps.hist_dev
    dev = hist.device
    n = ps.n
    rows_t = torch.as_tensor(rows, dtype=torch.int64).to(dev)
    if perm.dtype != torch.int32 or perm.shape != (n,) or perm.device != dev:
        raise ValueError("perm must be [n] int32 on the histogram's device")
    if hist.dtype not in _ext._WIDTHS or hist.dim() != 2 \
            or hist.stride(1) != 1:
        raise ValueError("hist must be [N, V] rows of int8/16/32/64")
    if heaps is None:
        heaps = torch.zeros(1, dtype=torch.int32, device=dev)
    P = rows_t.shape[0]
    lib = _ext.lib()
    out = torch.empty((P, n), dtype=torch.int32, device=dev)
    row_bytes = lib.mc_pivot_order_scratch(n)
    scratch = (torch.empty(P * row_bytes, dtype=torch.uint8, device=dev)
               if row_bytes else None)
    mag = torch.from_numpy(np.ascontiguousarray(ps.mag, np.int64)).to(dev)
    _ext._launched(lib.mc_pivot_order(
        hist.data_ptr(), hist.stride(0), hist.shape[1],
        _ext._WIDTHS[hist.dtype],
        mag.data_ptr(), rows_t.data_ptr(), P, perm.contiguous().data_ptr(), n,
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        heaps.data_ptr(), _ext.stream_of(hist)), "pivot_order")
    return out


def orders_plain(ps, rows: Rows, perm: torch.Tensor) -> torch.Tensor:
    """The host chain: the keys of each pivot row (exact device Manhattan
    rows, float64 keys on the host), then std::sort of a copy of perm by
    them, a row at a time (native/refsort)."""
    from meshclust_tpu_torch import native
    rows_np = np.asarray(torch.as_tensor(rows, dtype=torch.int64).cpu(),
                         np.int64)
    keys = ps.distance_rows_device(rows_np)
    out = np.tile(perm.cpu().numpy().astype(np.int32), (rows_np.shape[0], 1))
    if not native.ref_sort_perm_batch(out, np.ascontiguousarray(keys)):
        raise RuntimeError("pivot orders need the native refsort library")
    return torch.from_numpy(out).to(perm.device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """t as a numpy array: through pinned memory from the card."""
    if not t.is_cuda:
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()

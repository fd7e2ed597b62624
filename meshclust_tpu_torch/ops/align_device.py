"""Batched device aligner: GlobAlignE identities addressed by sequence index.

Twin of meshclust_tpu/ops/align_device.py:DeviceAligner. The whole corpus
is staged on the device once ([N, Lpad] int8, 'N' kept as 78), so a call
ships only pair indices. Pairs are sorted by l1 + l2 so neighbouring CTAs
finish together, cut into launches of at most PAIRS_PER_LAUNCH, and every
launch is queued before any result is read back.

Every pair, short read or genome, goes to one CUDA kernel,
csrc/nw_align_long.cu (`nw_align_long`): one CTA a pair, whose threads
own the rows of a strip and sweep the columns in a skewed wavefront, so the
device memory of a pair is one boundary row (36 bytes a column of b) and
there is no length gate. It takes the place of all four TPU kernels of
this function: the 128-pairs-on-lanes kernels the JAX package uses for
short pairs (align_window, align_device, align_pallas) and the tiled one it
uses past their gate (align_tiled). Its plain version is
ops/align.py:align_counts_plain, which the wrapper takes only for tensors on
the CPU. Identity is returned as exact int32 (alignment length, match
count); the float64 division happens on the host like the reference's
`getIdentity` (GlobAlignE.cpp:301-305).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from meshclust_tpu_torch import _ext
from meshclust_tpu_torch.ops.align import align_counts_plain, check_operands
from meshclust_tpu_torch.utils import perf

# Pairs per launch: enough CTAs to fill the card, and boundary rows of at
# most 36 bytes x (l2 + 1) x this many pairs.
PAIRS_PER_LAUNCH = 1024
_PLANES = 9


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def nw_align_long(codes: torch.Tensor, lengths: torch.Tensor,
                  ia: torch.Tensor, ib: torch.Tensor, max_l2: int,
                  match: int = 1, mismatch: int = -1, go: int = 2,
                  gc: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alen, amatch) [P] int32 for the pairs (codes[ia[p]], codes[ib[p]]).

    codes [N, Lpad] int8; lengths [N] int32; ia, ib [P] int32; max_l2 >=
    the length of every codes[ib[p]] (it sizes the kernel's boundary rows,
    [P, 9, max_l2 + 1] int32). On a CUDA device a pair that breaks l1 >= 1,
    1 <= l2 <= max_l2 comes back as -1.
    """
    check_operands(codes, lengths, ia, ib)
    dev = codes.device
    if dev.type == "cpu":
        return align_counts_plain(codes, lengths, ia, ib, match=match,
                                  mismatch=mismatch, go=go, gc=gc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    P = ia.shape[0]
    stride = max(1, int(max_l2)) + 1
    alen = torch.empty(P, dtype=torch.int32, device=dev)
    amatch = torch.empty(P, dtype=torch.int32, device=dev)
    if P == 0:
        return alen, amatch
    ia = ia.contiguous()
    ib = ib.contiguous()
    lengths = lengths.contiguous()
    bnd = torch.empty((P, _PLANES, stride), dtype=torch.int32, device=dev)
    err = _ext.lib().mc_nw_align_long(
        codes.data_ptr(), codes.shape[1], lengths.data_ptr(), ia.data_ptr(),
        ib.data_ptr(), P, stride, match, mismatch, go, gc, bnd.data_ptr(),
        alen.data_ptr(), amatch.data_ptr(), _ext.stream_of(codes))
    _ext.check(err, "nw_align_long")
    _ext.launches["nw_align_long"] += 1
    return alen, amatch


class DeviceAligner:
    """Batched GlobAlignE identities addressed by sequence index.

    codes: per-sequence uint8 digit arrays ('N' kept as 78 — N==N matches,
    ref ChromosomeOneDigit semantics), staged once on `device`.
    """

    def __init__(self, codes: List[np.ndarray], device, match: int = 1,
                 mismatch: int = -1, go: int = 2, gc: int = 1):
        self.codes = codes
        self.device = torch.device(device)
        self.lengths = np.asarray([len(c) for c in codes], np.int64)
        self.match, self.mismatch, self.go, self.gc = match, mismatch, go, gc
        self._staged = None     # (codes [N, Lpad] int8, lengths [N] int32)

    def _stage(self):
        if self._staged is None:
            lmax = int(self.lengths.max()) if len(self.codes) else 8
            lpad = _round_up(max(lmax, 8), 128)
            mat = np.zeros((len(self.codes), lpad), np.int8)
            for i, c in enumerate(self.codes):
                mat[i, : len(c)] = c
            self._staged = (
                torch.from_numpy(mat).to(self.device),
                torch.from_numpy(self.lengths.astype(np.int32))
                .to(self.device))
        return self._staged

    # -- public API ----------------------------------------------------------
    def probe_rounds_supported(self) -> bool:
        """The trainer's speculative probe walk needs the staged corpus,
        which every call stages whole (an allocation that does not fit
        raises in _stage)."""
        return True

    def identities(self, pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
        """Float64 identities for (index_a, index_b) pairs (exact host
        division of exact int32 match/length counts)."""
        n = len(pairs)
        if n == 0:
            return np.zeros(0, np.float64)
        ia = np.asarray([p for p, _ in pairs], np.int64)
        ib = np.asarray([q for _, q in pairs], np.int64)
        perf.add("nw_cells", float((self.lengths[ia] * self.lengths[ib])
                                   .sum()))
        perf.add("nw_pairs", n)
        with perf.phase("align"):
            alen, amatch = self.counts(pairs)
        return amatch.astype(np.float64) / np.maximum(
            alen.astype(np.float64), 1.0)

    def counts(self, pairs: Sequence[Tuple[int, int]]
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact (alignment_length, matches) int64 arrays."""
        n = len(pairs)
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        ia = np.asarray([p for p, _ in pairs], np.int64)
        ib = np.asarray([q for _, q in pairs], np.int64)
        l2 = self.lengths[ib]
        order = np.argsort(self.lengths[ia] + l2, kind="stable")
        codes_dev, lens_dev = self._stage()
        # Launch every chunk before reading ANY result back.
        pending = []
        for s in range(0, n, PAIRS_PER_LAUNCH):
            chunk = order[s: s + PAIRS_PER_LAUNCH]
            al, am = nw_align_long(
                codes_dev, lens_dev,
                torch.from_numpy(ia[chunk].astype(np.int32)).to(self.device),
                torch.from_numpy(ib[chunk].astype(np.int32)).to(self.device),
                int(l2[chunk].max()), match=self.match,
                mismatch=self.mismatch, go=self.go, gc=self.gc)
            pending.append((chunk, al, am))
        alen = np.zeros(n, np.int64)
        amatch = np.zeros(n, np.int64)
        for chunk, al, am in pending:
            alen[chunk] = al.cpu().numpy()
            amatch[chunk] = am.cpu().numpy()
        if (alen < 0).any():
            raise RuntimeError("nw_align_long rejected a pair (length out of "
                               "range)")
        return alen, amatch

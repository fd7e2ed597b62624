"""Batched device aligner: GlobAlignE identities addressed by sequence index.

Twin of meshclust_tpu/ops/align_device.py:DeviceAligner. The whole corpus
is staged on the device once ([N, Lpad] int8, 'N' kept as 78), so a call
ships only pair indices. Pairs are grouped by row bucket, sorted by l1 + l2
so neighbouring threads finish together, and every chunk is launched before
any result is read back.

The alignment itself is the CUDA kernel csrc/nw_align.cu (`nw_align`); its
plain version is ops/align.py:align_counts_plain, which `nw_align` takes only
for tensors on the CPU. Identity is returned as exact int32 (alignment
length, match count); the float64 division happens on the host like the
reference's `getIdentity` (GlobAlignE.cpp:301-305).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from meshclust_tpu_torch import _ext
from meshclust_tpu_torch.ops.align import align_counts_plain
from meshclust_tpu_torch.utils import perf

# Pairs per kernel launch (scratch: 36 bytes x rows x pairs).
MAX_PAIRS = 8192
_PLANES = 9


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket_rows(x: int) -> int:
    """Quarter-octave bucket for the DP row axis (<=25% pad waste)."""
    if x <= 64:
        return 64
    step = max(64, (1 << (int(x - 1).bit_length() - 1)) // 4)
    return ((x + step - 1) // step) * step


def nw_align(codes: torch.Tensor, lengths: torch.Tensor, ia: torch.Tensor,
             ib: torch.Tensor, max_l1: int, match: int = 1,
             mismatch: int = -1, go: int = 2, gc: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alen, amatch) [P] int32 for the pairs (codes[ia[p]], codes[ib[p]]).

    codes [N, Lpad] int8; lengths [N] int32; ia, ib [P] int32; max_l1 >= the
    length of every codes[ia[p]] (it sizes the kernel's scratch). On a CUDA
    device a pair that breaks 1 <= l1 <= max_l1, l2 >= 1 comes back as -1.
    """
    if codes.dtype != torch.int8 or codes.dim() != 2 \
            or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous 2-D int8 tensor")
    if lengths.dtype != torch.int32 or lengths.dim() != 1 \
            or lengths.shape[0] != codes.shape[0]:
        raise ValueError("lengths must be int32 [N]")
    if ia.dtype != torch.int32 or ib.dtype != torch.int32 or ia.dim() != 1 \
            or ia.shape != ib.shape:
        raise ValueError("ia and ib must be int32 [P]")
    dev = codes.device
    if any(t.device != dev for t in (lengths, ia, ib)):
        raise ValueError("all operands must be on one device")
    if dev.type == "cpu":
        return align_counts_plain(codes, lengths, ia, ib, match=match,
                                  mismatch=mismatch, go=go, gc=gc)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    P = ia.shape[0]
    R = max(1, int(max_l1))
    alen = torch.empty(P, dtype=torch.int32, device=dev)
    amatch = torch.empty(P, dtype=torch.int32, device=dev)
    if P == 0:
        return alen, amatch
    ia = ia.contiguous()
    ib = ib.contiguous()
    lengths = lengths.contiguous()
    scratch = torch.empty((_PLANES, R, P), dtype=torch.int32, device=dev)
    err = _ext.lib().mc_nw_align(
        codes.data_ptr(), codes.shape[1], lengths.data_ptr(), ia.data_ptr(),
        ib.data_ptr(), P, R, match, mismatch, go, gc, scratch.data_ptr(),
        alen.data_ptr(), amatch.data_ptr(), _ext.stream_of(codes))
    _ext.check(err, "nw_align")
    _ext.launches["nw_align"] += 1
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
        l1 = self.lengths[ia]
        l2 = self.lengths[ib]
        perf.add("nw_cells", float((l1 * l2).sum()))
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
        l1 = self.lengths[ia]
        l2 = self.lengths[ib]
        codes_dev, lens_dev = self._stage()
        # group by row bucket so one oversized seq1 doesn't pad everything
        groups: dict = {}
        for t in range(n):
            groups.setdefault(_bucket_rows(int(l1[t])), []).append(t)
        # Launch every chunk before reading ANY result back.
        pending = []
        for idxs in groups.values():
            idxs.sort(key=lambda t: int(l1[t] + l2[t]))
            for s in range(0, len(idxs), MAX_PAIRS):
                chunk = np.asarray(idxs[s: s + MAX_PAIRS])
                al, am = nw_align(
                    codes_dev, lens_dev,
                    torch.from_numpy(ia[chunk].astype(np.int32))
                    .to(self.device),
                    torch.from_numpy(ib[chunk].astype(np.int32))
                    .to(self.device),
                    int(l1[chunk].max()), match=self.match,
                    mismatch=self.mismatch, go=self.go, gc=self.gc)
                pending.append((chunk, al, am))
        alen = np.zeros(n, np.int64)
        amatch = np.zeros(n, np.int64)
        for chunk, al, am in pending:
            alen[chunk] = al.cpu().numpy()
            amatch[chunk] = am.cpu().numpy()
        if (alen < 0).any():
            raise RuntimeError("nw_align rejected a pair (length out of "
                               "range)")
        return alen, amatch

"""Batched device aligner: GlobAlignE identities addressed by sequence index.

Twin of meshclust_tpu/ops/align_device.py:DeviceAligner. Where the corpus
fits `stage_mb` ([N, Lpad] int8, 'N' kept as 78; MESHCLUST_ALIGN_STAGE_MB,
by default 40% of the card's memory, as the JAX package's), it is staged on
the device once and a call ships only pair indices; otherwise each launch
packs the distinct sequences of its own pairs ([u, Lpad of the launch]).
Pairs are sorted by l1 + l2 so neighbouring CTAs finish together, cut into
launches of at most PAIRS_PER_LAUNCH whose boundary rows fit
BOUNDARY_SHARE of the card's memory, and every launch is queued before any
result is read back.

Every pair, short read or genome, goes to one CUDA kernel,
csrc/nw_align_long.cu (`nw_align_long`): one CTA a pair, each of whose
threads owns ROWS_PER_THREAD rows of a strip of STRIP_ROWS, all sweeping
the columns in a skewed wavefront, so the device memory of a pair is one
boundary row (36 bytes a column of b) and there is no length gate. It
takes the place of all four TPU kernels of
this function: the 128-pairs-on-lanes kernels the JAX package uses for
short pairs (align_window, align_device, align_pallas) and the tiled one it
uses past their gate (align_tiled). Its plain version is
ops/align.py:align_counts_plain, which the wrapper takes only for tensors on
the CPU. Identity is returned as exact int32 (alignment length, match
count); the float64 division happens on the host like the reference's
`getIdentity` (GlobAlignE.cpp:301-305).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from meshclust_tpu_torch import _ext
from meshclust_tpu_torch.ops.align import align_counts_plain, check_operands
from meshclust_tpu_torch.utils import perf

# Pairs per launch: enough CTAs to fill the card. A launch's boundary rows
# take 4 * _PLANES bytes x (its largest l2 + 1) a pair; the pairs of a launch
# are also cut so that they take at most BOUNDARY_SHARE of the card's memory
# (1,024 pairs at l2 = 1 Mb would take 36.9 GB).
PAIRS_PER_LAUNCH = 1024
_PLANES = 9
BOUNDARY_SHARE = 0.25
# stage_mb's default: this share of the card's memory (the JAX package's);
# with no card to ask (the CPU), of CPU_MEMORY_MB, which makes it 6,144 MB,
# the JAX package's fallback.
STAGE_SHARE = 0.4
CPU_MEMORY_MB = 15360
# The kernel's shape, as csrc/nw_align_long.cu's constants give it (kR, kT,
# kStrip, kK): DP rows per thread, threads per pair, rows per strip, and
# steps between the CTA's barriers.
ROWS_PER_THREAD = 8
THREADS_PER_PAIR = 128
STRIP_ROWS = ROWS_PER_THREAD * THREADS_PER_PAIR
SYNC_STEPS = 8


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
    _ext._launched(err, "nw_align_long")
    return alen, amatch


def device_memory_mb(device: torch.device) -> float:
    """The card's total memory in MiB (CPU_MEMORY_MB on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1] / 2 ** 20
    return float(CPU_MEMORY_MB)


def launch_cuts(l2: np.ndarray, budget: float) -> List[int]:
    """Where to cut pairs, in launch order, whose l2 are `l2`: greedily, so
    that a launch holds at most PAIRS_PER_LAUNCH pairs and its boundary rows,
    4 * _PLANES * P * (max(1, its largest l2) + 1) bytes, at most `budget`
    bytes, and at least one pair. -> the launches' start indices, and
    len(l2) last."""
    cuts, s, n = [0], 0, len(l2)
    while s < n:
        run = np.maximum.accumulate(
            np.maximum(l2[s: s + PAIRS_PER_LAUNCH], 1)) + 1
        rows = 4 * _PLANES * np.arange(1, run.shape[0] + 1) * run
        s += max(1, int(np.searchsorted(rows > budget, True)))
        cuts.append(s)
    return cuts


class DeviceAligner:
    """Batched GlobAlignE identities addressed by sequence index.

    codes: per-sequence uint8 digit arrays ('N' kept as 78 — N==N matches,
    ref ChromosomeOneDigit semantics). The whole corpus is staged once on
    `device` when N x Lpad fits stage_mb MiB (default: the environment's
    MESHCLUST_ALIGN_STAGE_MB, else STAGE_SHARE of the card's memory);
    otherwise each launch packs its own pairs' sequences.
    """

    def __init__(self, codes: List[np.ndarray], device, match: int = 1,
                 mismatch: int = -1, go: int = 2, gc: int = 1,
                 stage_mb: Optional[int] = None):
        self.codes = codes
        self.device = torch.device(device)
        self.lengths = np.asarray([len(c) for c in codes], np.int64)
        self.match, self.mismatch, self.go, self.gc = match, mismatch, go, gc
        if stage_mb is None:
            stage_mb = int(os.environ.get(
                "MESHCLUST_ALIGN_STAGE_MB",
                str(int(STAGE_SHARE * device_memory_mb(self.device)))))
        self.stage_mb = stage_mb
        self._staged = None     # (codes [N, Lpad] int8, lengths [N] int32)

    def _lpad(self) -> int:
        lmax = int(self.lengths.max()) if len(self.codes) else 8
        return _round_up(max(lmax, 8), 128)

    def _can_stage(self) -> bool:
        return len(self.codes) * self._lpad() <= self.stage_mb * (1 << 20)

    def _pack(self, idx: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """(codes [len(idx), Lpad] int8, lengths [len(idx)] int32) of the
        sequences idx on the device, Lpad their longest rounded up to 128."""
        lens = self.lengths[idx]
        lmax = int(lens.max()) if idx.shape[0] else 8
        mat = np.zeros((idx.shape[0], _round_up(max(lmax, 8), 128)), np.int8)
        for row, i in enumerate(idx.tolist()):
            mat[row, : lens[row]] = self.codes[i]
        return (torch.from_numpy(mat).to(self.device),
                torch.from_numpy(lens.astype(np.int32)).to(self.device))

    def _stage(self):
        if self._staged is None:
            self._staged = self._pack(np.arange(len(self.codes)))
        return self._staged

    # -- public API ----------------------------------------------------------
    def probe_rounds_supported(self) -> bool:
        """The trainer's speculative probe walk reads identities through
        identities(), staged or packed, so it is always usable."""
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
        perf.add("nw_calls", 1)
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
        staged = self._can_stage()
        if staged:
            codes_dev, lens_dev = self._stage()
        cuts = launch_cuts(l2[order], BOUNDARY_SHARE
                           * device_memory_mb(self.device) * 2 ** 20)
        # Launch every chunk before reading ANY result back. A packed
        # launch's operands may be freed once it is queued: the next
        # allocation on the stream runs after it.
        pending = []
        for s, e in zip(cuts[:-1], cuts[1:]):
            chunk = order[s: e]
            a, b = ia[chunk], ib[chunk]
            if not staged:
                seqs, inv = np.unique(np.concatenate([a, b]),
                                      return_inverse=True)
                codes_dev, lens_dev = self._pack(seqs)
                a, b = inv[: chunk.shape[0]], inv[chunk.shape[0]:]
            al, am = nw_align_long(
                codes_dev, lens_dev,
                torch.from_numpy(a.astype(np.int32)).to(self.device),
                torch.from_numpy(b.astype(np.int32)).to(self.device),
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

"""PointSet: the dense array-of-structs replacement for Point/DivergencePoint.

Twin of meshclust_tpu/core/points.py. One object per sequence becomes
column arrays over all sequences:
  hist_dev [N, 4^k] torch tensor on the device, storage dtype (pseudo-counted
           k-mer histogram; ref `points` vector); `hist` is its host copy,
           fetched on first use
  mag  [N] int64     (pseudo-magnitude = sum of counts)
  sq   [N] int64     (sum of squared counts — powers the derived statistics)
  lengths [N] int64  (nucleotide length incl. Ns; ref get_length())
  one_mers [N, 4]
  headers  list[str] (full '>'-lines)
  codes    list[np.uint8 arrays] (digit codes + literal 'N's; ref data_str)
ids equal the row index (Runner.cpp:346-349 assigns them in FASTA order).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from meshclust_tpu_torch.io import fasta as fio
from meshclust_tpu_torch.ops import histogram as H

# Elements of one [pivots, points, V] block in `manhattan_rows`.
_MAN_BLOCK = 1 << 26


def _fma_1_minus_sq(frac):
    """gcc-contracted `1.0 - frac * frac`, i.e. fma(-frac, frac, 1.0):
    ONE rounding of (1 - frac^2) instead of two.

    The reference is compiled -O3 (-ffp-contract=fast), so
    DivergencePoint::distance truncates 10000 * fma(-frac, frac, 1.0)
    (DivergencePoint.cpp:79-81) — for dist=462, mag=600 that is 4070,
    while the naive two-rounding form gives 4071; four such keys
    reordered a 20k pivot sort and changed one sampled training pair
    (round-5 parity find). Emulated in vectorized f64 with a Dekker
    two_prod residual; exact up to a ~2^-107 tie that integer-ratio
    fracs (denominator < 2^24) cannot produce."""
    frac = np.asarray(frac, np.float64)
    p = frac * frac
    split = np.float64((1 << 27) + 1)
    c = split * frac
    hi = c - (c - frac)
    lo = frac - hi
    e = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo   # p + e == frac^2
    t = 1.0 - p
    terr = (1.0 - t) - p                            # exact residual
    return t + (terr - e)


def manhattan_rows(hist: torch.Tensor, rows: np.ndarray) -> np.ndarray:
    """[P, N] exact sum_v |hist[rows[p], v] - hist[n, v]| as int32 torch ops
    on hist's device, returned on the host as int64."""
    N, V = hist.shape
    P = rows.shape[0]
    dev = hist.device
    out = torch.empty((P, N), dtype=torch.int32, device=dev)
    nb = max(1, min(N, _MAN_BLOCK // V))
    pb = max(1, _MAN_BLOCK // (nb * V))
    piv = hist[torch.as_tensor(np.asarray(rows, np.int64), device=dev)]
    for p0 in range(0, P, pb):
        hp = piv[p0: p0 + pb].to(torch.int32)[:, None, :]
        for n0 in range(0, N, nb):
            hn = hist[n0: n0 + nb].to(torch.int32)[None, :, :]
            out[p0: p0 + pb, n0: n0 + nb] = torch.sum(
                torch.abs(hp - hn), dim=-1, dtype=torch.int32)
    return out.cpu().numpy().astype(np.int64)


@dataclasses.dataclass
class PointSet:
    hist: Optional[np.ndarray]        # host histogram (lazy when on-device)
    mag: np.ndarray
    sq: np.ndarray
    lengths: np.ndarray
    one_mers: np.ndarray
    headers: List[str]
    codes: List[np.ndarray]
    k: int
    V: int
    hist_dev: Optional[torch.Tensor] = None  # device [N, V] (storage dtype)
    largest: int = 0                   # max k-mer count (dtype-scan input)

    def __post_init__(self):
        if self.hist_dev is None:
            raise ValueError("PointSet needs the device histogram hist_dev")

    def __getattribute__(self, name):
        # Lazy host materialization: featurization keeps the histogram on
        # the device; the host paths that index `ps.hist` trigger ONE full
        # fetch on first use.
        if name == "hist":
            h = object.__getattribute__(self, "hist")
            if h is None:
                h = object.__getattribute__(self, "hist_dev").cpu().numpy()
                object.__setattr__(self, "hist", h)
            return h
        return object.__getattribute__(self, name)

    @property
    def n(self) -> int:
        return int(self.lengths.shape[0])

    @property
    def device(self) -> torch.device:
        return self.hist_dev.device

    def hist_rows(self, idx: np.ndarray) -> np.ndarray:
        """Host copies of histogram rows `idx` WITHOUT materializing the
        full host histogram: device gather + small copy back when the
        histogram is device-resident."""
        h = object.__getattribute__(self, "hist")
        if h is not None:
            return h[idx]
        dev = object.__getattribute__(self, "hist_dev")
        sel = torch.as_tensor(np.asarray(idx, np.int64), device=dev.device)
        return dev[sel].cpu().numpy()

    def distance(self, i: int, j: int) -> int:
        """DivergencePoint::distance (uint64-truncated), used by the trainer's
        pivot sorts (DivergencePoint.cpp:68-81)."""
        dist = 2 * int(np.minimum(self.hist[i], self.hist[j])
                       .astype(np.int64).sum())
        mag = int(self.mag[i] + self.mag[j])
        frac = np.float64(dist) / np.float64(mag)
        return int(10000.0 * _fma_1_minus_sq(frac))

    def distance_row(self, i: int) -> np.ndarray:
        """distance(i, :) vectorized (float64 frac, truncated to int)."""
        dist = 2 * np.minimum(self.hist[i][None, :], self.hist)\
            .astype(np.int64).sum(axis=1)
        mag = (self.mag[i] + self.mag).astype(np.float64)
        frac = dist.astype(np.float64) / mag
        return (10000.0 * _fma_1_minus_sq(frac)).astype(np.uint64)

    def distance_rows_device(self, rows: np.ndarray) -> np.ndarray:
        """DivergencePoint::distance for [P] pivots vs all points.

        The device computes only the exact integer Manhattan row sums; the
        frac division, 10000*(1-frac^2) and the truncating uint cast run on
        the host in float64 — bit-identical to `distance_row` and to the
        reference's double path (DivergencePoint.cpp:68-81) by
        construction (2 * sum(min) == mag_i + mag_j - man)."""
        man = manhattan_rows(self.hist_dev, rows).astype(np.float64)
        msum = (self.mag[rows][:, None] + self.mag[None, :]).astype(
            np.float64)
        frac = (msum - man) / msum
        return (10000.0 * _fma_1_minus_sq(frac)).astype(np.uint64)\
            .astype(np.int64)


def build_points(seqs: List[fio.Sequence], k: int,
                 device: torch.device, mesh=None) -> PointSet:
    """Featurize all sequences (ref ClusterFactory::build_points +
    get_divergence_point); the histogram stays on `device`. With `mesh`
    each rank counts a block of the records and every rank gets the whole
    PointSet (ops/histogram.featurize)."""
    feats = H.featurize(seqs, k, device, mesh=mesh)
    return PointSet(
        hist=None,
        mag=feats["mag"],
        sq=feats["sq"],
        lengths=feats["lengths"],
        one_mers=feats["one_mers"],
        headers=[s.header for s in seqs],
        codes=[s.codes for s in seqs],
        k=k,
        V=feats["V"],
        hist_dev=feats["hist_dev"],
        largest=feats["largest"],
    )

"""Classifier evaluation backend for the clustering loop.

The trained model (Trainer::get_close / filter / merge / raw_classify,
Trainer.cpp:34-157,334-349) evaluates, for a (center, candidate) pair:
    cache  = raw single statistics       (Feature::compute)
    norm   = (cache - min)/(max - min), inverted for distance-type singles
    col_j  = product of (squared) normalized singles   (combo columns)
    score  = w0 + sum_j w_j * col_j
    positive <=> round(sigmoid(score)) == 1 <=> score >= 0
f1 = the FIRST combo column value — the similarity used for argmax decisions.

HostBackend: exact float64 numpy from integer sums, carried over from
meshclust_tpu/core/classify.py unchanged. It is the only backend of this
slice: the device classifier (DeviceBackend) and align mode (AlignBackend)
are later slices of the port (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

from meshclust_tpu_torch.core.points import PointSet
from meshclust_tpu_torch.ops import features as F


class HostBackend:
    """Exact float64 classifier evaluation on host numpy."""

    def __init__(self, ps: PointSet, params: F.FeatureParams,
                 align_fn: Optional[Callable] = None):
        self.ps = ps
        self.params = params
        self.align_fn = align_fn   # (center, idx_array) -> identities
        self._align_cache: Dict[Tuple[int, int], float] = {}
        self.phase_b = False       # see AlignBackend.phase_b (clone quirk)

    def _raw_cache(self, center: int, window: np.ndarray) -> np.ndarray:
        """[W, S] raw single values for candidate rows vs the center."""
        ps = self.ps
        h_c = ps.hist_rows(np.asarray([center]))[0].astype(np.int64)
        h_w = ps.hist_rows(window).astype(np.int64)
        man = np.abs(h_w - h_c[None, :]).sum(axis=1).astype(np.float64)
        dot = (h_w @ h_c).astype(np.float64)
        mag_a = np.float64(ps.mag[center])
        mag_b = ps.mag[window].astype(np.float64)
        sq_a = np.float64(ps.sq[center])
        sq_b = ps.sq[window].astype(np.float64)
        len_a = np.float64(ps.lengths[center])
        len_b = ps.lengths[window].astype(np.float64)

        extras = {}
        if F.FEAT_SQCHORD in self.params.singles:
            a = ps.hist[center].astype(np.float64)
            b = ps.hist[window].astype(np.float64)
            extras["sqchord"] = (a[None] + b - 2 * np.sqrt(a[None] * b)
                                 ).sum(axis=1)
        if F.FEAT_JENSONSHANNON in self.params.singles:
            extras["js"] = F.jenson_shannon_pairs(
                ps.hist[center][None], ps.hist[window],
                ps.mag[center: center + 1], ps.mag[window])[0]
        if F.FEAT_RREE_K_R in self.params.singles:
            extras["rree"] = F.rree_k_r_pairs(
                ps.hist[window], ps.hist[center][None])

        align_val = None
        if F.FEAT_ALIGN in self.params.singles:
            align_val = self._aligned(center, window)

        cols = []
        for flag in self.params.singles:
            cols.append(F.raw_from_sums(
                flag, man=man, dot=dot, mag_a=mag_a, mag_b=mag_b,
                sq_a=sq_a, sq_b=sq_b, len_a=len_a, len_b=len_b,
                V=ps.V, extras=extras, align_val=align_val))
        return np.stack(cols, axis=-1)

    def _aligned(self, center: int, window: np.ndarray) -> np.ndarray:
        """Memoized alignment identities (ref Feature::align's atable,
        Feature.cpp:222-243), keyed by (min_id, max_id)."""
        out = np.zeros(window.shape[0], np.float64)
        missing = []
        for w, j in enumerate(window):
            key = (min(center, int(j)), max(center, int(j)))
            if key in self._align_cache:
                out[w] = self._align_cache[key]
            else:
                missing.append(w)
        if missing:
            if self.phase_b:
                # reference phase-B clone quirk: an unmemoized pair aligns
                # against the clone's EMPTY data_str -> identity 0
                for w in missing:
                    key = (min(center, int(window[w])),
                           max(center, int(window[w])))
                    self._align_cache[key] = 0.0
                return out
            vals = self.align_fn(center, window[missing])
            for w, v in zip(missing, vals):
                key = (min(center, int(window[w])), max(center, int(window[w])))
                self._align_cache[key] = float(v)
                out[w] = v
        return out

    def classify(self, center: int, window: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (positive bool [W], f1 float64 [W])."""
        if window.shape[0] == 0:
            return np.zeros(0, bool), np.zeros(0)
        cache = self._raw_cache(center, window)
        mins = self.params.mins
        maxs = self.params.maxs
        norm = (cache - mins) / (maxs - mins)
        norm = np.where(self.params.is_sim, norm, 1.0 - norm)
        score = np.full(window.shape[0], self.params.weights[0])
        f1 = None
        for j, (combo, idx) in enumerate(self.params.combos):
            prod = np.ones(window.shape[0])
            for i in idx:
                c = norm[:, i]
                prod = prod * (c * c if combo == F.COMBO_SQUARED else c)
            if j == 0:
                f1 = prod
            score = score + self.params.weights[j + 1] * prod
        return score >= 0.0, f1

    def raw_classify(self, a: int, b: int) -> float:
        """Sigmoid probability (Trainer::raw_classify)."""
        cache = self._raw_cache(a, np.array([b]))
        mins, maxs = self.params.mins, self.params.maxs
        norm = (cache - mins) / (maxs - mins)
        norm = np.where(self.params.is_sim, norm, 1.0 - norm)
        s = self.params.weights[0]
        for j, (combo, idx) in enumerate(self.params.combos):
            prod = 1.0
            for i in idx:
                c = norm[0, i]
                prod *= (c * c if combo == F.COMBO_SQUARED else c)
            s += self.params.weights[j + 1] * prod
        return float(1.0 / (1.0 + np.exp(-s)))


ALIGN_MODE_MISSING = ("align mode (--align or --id < 0.60) is not ported "
                      "yet: AlignBackend is ROADMAP.md queue 1, slice 3 of "
                      "the port")


def make_backend(ps: PointSet, params: F.FeatureParams,
                 align_fn: Optional[Callable] = None) -> HostBackend:
    """The classifier backend for k-mer mode. Align mode (a model whose only
    feature is the alignment identity) needs AlignBackend, which this
    slice does not carry yet."""
    if tuple(params.singles) == (F.FEAT_ALIGN,):
        raise NotImplementedError(ALIGN_MODE_MISSING)
    return HostBackend(ps, params, align_fn=align_fn)

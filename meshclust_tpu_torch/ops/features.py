"""Pairwise k-mer similarity statistics + the Feature normalization pipeline.

Reference: Feature.{h,cpp} (SURVEY C9). The reference computes each raw
statistic with a separate O(4^k) pass per pair. TPU re-design: all default
statistics reduce to TWO pairwise reductions over the histogram lanes —

    man[a,b] = sum_v |p_av - q_bv|        (VPU elementwise)
    dot[a,b] = sum_v p_av * q_bv          (MXU matmul)

plus per-sequence precomputes (mag = sum p, sq = sum p^2, length):

    min_sum      = (mag_a + mag_b - man) / 2      [min(p,q)=(p+q-|p-q|)/2]
    intersection = 2*min_sum / (mag_a + mag_b)              (Feature.cpp:258-271)
    kulczynski2  = N*(ap+aq)/(2*ap*aq) * min_sum            (Feature.cpp:206-220)
    norm2        = sq_a + sq_b - 2*dot
    simratio     = dot / (dot + sqrt(norm2))                (Feature.cpp:296-309)
    pearson      = dotc / sqrt(max(0.5, np*nq)) with
                   ap = round(mag_a/N), dotc = dot - ap*mag_b - aq*mag_a + N*ap*aq,
                   np = sq_a - 2*ap*mag_a + N*ap^2          (Feature.cpp:273-294)
    manhattan    = man                                       (Feature.cpp:310-323)
    length_diff  = |len_a - len_b|                           (Feature.cpp:325-339)

Non-default statistics (squaredchord, jenson-shannon, rree_k_r) need their
own lane pass and are provided separately.

All sums are exact integers; the Feature class below does the reference's
min/max normalization + combo products in float64 on host, and exports a
compact parameter block for the float32 on-device classifier.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Feature bit flags (Feature.h:9-19)
FEAT_ALIGN = 1 << 0
FEAT_LD = 1 << 1
FEAT_MANHATTAN = 1 << 2
FEAT_SQCHORD = 1 << 3
FEAT_INTERSECTION = 1 << 4
FEAT_PEARSON = 1 << 5
FEAT_SIMRATIO = 1 << 6
FEAT_N2RRC = 1 << 7
FEAT_JENSONSHANNON = 1 << 8
FEAT_RREE_K_R = 1 << 9
FEAT_KULCZYNSKI2 = 1 << 10

COMBO_SQUARED = 1
COMBO_SELF = 2

# is-similarity flags (Feature::feat_is_sim, Feature.cpp:161-204)
_IS_SIM = {
    FEAT_ALIGN: True, FEAT_LD: False, FEAT_MANHATTAN: False,
    FEAT_SQCHORD: False, FEAT_INTERSECTION: True, FEAT_PEARSON: False,
    FEAT_SIMRATIO: True, FEAT_JENSONSHANNON: False, FEAT_RREE_K_R: False,
    FEAT_KULCZYNSKI2: True,
}

# The default greedy feature menu (Trainer.cpp:583-588, feat_set == 1).
DEFAULT_FEATURE_MENU: List[Tuple[int, int]] = [
    (FEAT_INTERSECTION | FEAT_LD, COMBO_SELF),
    (FEAT_MANHATTAN | FEAT_LD, COMBO_SQUARED),
    (FEAT_PEARSON, COMBO_SELF),
    (FEAT_KULCZYNSKI2 | FEAT_LD, COMBO_SQUARED),
]
# The alternate menu (feat_set == 0, Trainer.cpp:578-582), kept for parity.
ALT_FEATURE_MENU: List[Tuple[int, int]] = [
    (FEAT_LD | FEAT_INTERSECTION, COMBO_SELF),
    (FEAT_LD | FEAT_JENSONSHANNON, COMBO_SELF),
    (FEAT_SIMRATIO, COMBO_SELF),
    (FEAT_SQCHORD, COMBO_SELF),
]


# ---------------------------------------------------------------------------
# Per-sequence precomputes and pairwise integer sums
# ---------------------------------------------------------------------------

def seq_stats(hist: np.ndarray) -> Dict[str, np.ndarray]:
    """mag = sum p (pseudo-magnitude), sq = sum p^2 — exact int64."""
    h = hist.astype(np.int64)
    return {"mag": h.sum(axis=1), "sq": (h * h).sum(axis=1)}


def pair_sums_exact(hist_a: np.ndarray, hist_b: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact int64 man/dot on host (oracle + training path)."""
    a = hist_a.astype(np.int64)
    b = hist_b.astype(np.int64)
    dot = a @ b.T
    man = np.abs(a[:, None, :] - b[None, :, :]).sum(axis=-1)
    return man, dot


def extra_sums_exact(hist_a: np.ndarray, hist_b: np.ndarray
                     ) -> Dict[str, np.ndarray]:
    """Lane passes for the non-default statistics (host, float64)."""
    a = hist_a.astype(np.float64)
    b = hist_b.astype(np.float64)
    sqchord = (a[:, None, :] + b[None, :, :]
               - 2 * np.sqrt(a[:, None, :] * b[None, :, :])).sum(axis=-1)
    return {"sqchord": sqchord}


# ---------------------------------------------------------------------------
# Raw feature values from integer sums (float64 host math)
# ---------------------------------------------------------------------------

def raw_from_sums(flag: int, man, dot, mag_a, mag_b, sq_a, sq_b, len_a,
                  len_b, V: int, extras: Optional[dict] = None,
                  align_val=None):
    """Compute one raw single-feature value (vectorized over pair axes).

    Inputs broadcast: mag_a/sq_a/len_a indexed [A, 1]; *_b indexed [1, B].
    """
    man = np.asarray(man, np.float64)
    dot = np.asarray(dot, np.float64)
    if flag == FEAT_ALIGN:
        if align_val is None:
            raise ValueError("FEAT_ALIGN needs externally supplied identities")
        return np.asarray(align_val, np.float64)
    if flag == FEAT_LD:
        return np.abs(len_a - len_b).astype(np.float64)
    if flag == FEAT_MANHATTAN:
        return man
    if flag == FEAT_INTERSECTION:
        min_sum = (mag_a + mag_b - man) / 2.0
        return 2.0 * min_sum / (mag_a + mag_b)
    if flag == FEAT_KULCZYNSKI2:
        ap = mag_a / V
        aq = mag_b / V
        min_sum = (mag_a + mag_b - man) / 2.0
        coeff = V * (ap + aq) / (2.0 * ap * aq)
        return coeff * min_sum
    if flag == FEAT_SIMRATIO:
        norm2 = sq_a + sq_b - 2.0 * dot
        return dot / (dot + np.sqrt(np.maximum(norm2, 0.0)))
    if flag == FEAT_PEARSON:
        # C++ round(): half away from zero (mag/V > 0 => floor(x+0.5))
        ap = np.floor(mag_a / V + 0.5)
        aq = np.floor(mag_b / V + 0.5)
        np_ = sq_a - 2.0 * ap * mag_a + V * ap * ap
        nq_ = sq_b - 2.0 * aq * mag_b + V * aq * aq
        dotc = dot - ap * mag_b - aq * mag_a + V * ap * aq
        return dotc / np.sqrt(np.maximum(0.5, np_ * nq_))
    if flag == FEAT_SQCHORD:
        return np.asarray(extras["sqchord"], np.float64)
    if flag == FEAT_JENSONSHANNON:
        return np.asarray(extras["js"], np.float64)
    if flag == FEAT_RREE_K_R:
        return np.asarray(extras["rree"], np.float64)
    if flag == FEAT_N2RRC:
        raise NotImplementedError("n2rrc not implemented (ref Feature.cpp:144)")
    raise ValueError(f"bad feature flag {flag}")


def _fastlog2(x: np.ndarray) -> np.ndarray:
    """The reference's bit-trick approximate log2 (Feature.cpp:399-411),
    replicated in float32: reinterpret the float bits as an int, rescale the
    exponent, and correct with the published rational fit. Vectorized."""
    xf = np.asarray(x, np.float32)
    vx = xf.view(np.uint32)
    mx = ((vx & np.uint32(0x007FFFFF)) | np.uint32(0x7E << 23)).view(
        np.float32)
    # C: float y = vx.i; y *= 1.0 / (1 << 23);  (double multiply, f32 store)
    y = (vx.astype(np.float64) * (1.0 / (1 << 23))).astype(np.float32)
    return (y - np.float32(124.22544637) - np.float32(1.498030302) * mx
            - np.float32(1.72587999) / (np.float32(0.3520887068) + mx))


def rree_k_r_pairs(hist_a: np.ndarray, hist_b: np.ndarray) -> np.ndarray:
    """RREE_K_R statistic (Feature.cpp:447-475): the histogram's 4^k lanes
    are grouped in consecutive quartets (the 4 possible last bases of a
    shared (k-1)-mer prefix); each quartet is normalized to a conditional
    distribution and scored with a Jensen-Shannon-style divergence using the
    reference's fastlog4; the result is 0.5 * (sum_p + sum_q) over quartets.

    hist_a and hist_b broadcast over leading axes; last axis is V (=4^k).
    Float64 accumulation with the float32 fastlog4, like the reference's
    `double ip += cp * (double)fastlog4(...)`.
    """
    a = np.asarray(hist_a, np.float64)
    b = np.asarray(hist_b, np.float64)
    A4 = a.reshape(a.shape[:-1] + (-1, 4))
    B4 = b.reshape(b.shape[:-1] + (-1, 4))
    cp = A4 / A4.sum(axis=-1, keepdims=True)   # psum >= 4 (pseudocounts)
    cq = B4 / B4.sum(axis=-1, keepdims=True)
    cp, cq = np.broadcast_arrays(cp, cq)
    avg = 0.5 * (cp + cq)
    lp = (_fastlog2((cp / avg).astype(np.float32))
          / np.float32(2.0)).astype(np.float64)
    lq = (_fastlog2((cq / avg).astype(np.float32))
          / np.float32(2.0)).astype(np.float64)
    op = (cp * lp).sum(axis=(-2, -1))
    oq = (cq * lq).sum(axis=(-2, -1))
    return 0.5 * (op + oq)


def js_table(size: int = 10_000_000) -> np.ndarray:
    """The Trainer's log table: tbl[i] = log(2i) - log(size), tbl[0] = 0
    (Trainer.h:17-24). Used by the table-approximate Jensen-Shannon."""
    tbl = np.zeros(size, np.float64)
    i = np.arange(1, size)
    tbl[1:] = np.log(2.0 * i) - math.log(size)
    return tbl


def jenson_shannon_pairs(hist_a: np.ndarray, hist_b: np.ndarray,
                         mag_a: np.ndarray, mag_b: np.ndarray,
                         table: Optional[np.ndarray] = None) -> np.ndarray:
    """JS divergence [A, B]; exact log by default, reference-table approx if
    `table` is supplied (Feature.cpp:419-445)."""
    pa = hist_a.astype(np.float64) / mag_a[:, None]
    pb = hist_b.astype(np.float64) / mag_b[:, None]
    out = np.zeros((hist_a.shape[0], hist_b.shape[0]))
    for i in range(hist_a.shape[0]):
        pp = pa[i][None, :]
        pq = pb
        avg = 0.5 * (pp + pq)
        if table is None:
            lp = np.log(pp / avg)
            lq = np.log(pq / avg)
        else:
            coeff = table.shape[0] / 2.0
            lp = table[(coeff * pp / avg).astype(np.int64)]
            lq = table[(coeff * pq / avg).astype(np.int64)]
        out[i] = (pp * lp + pq * lq).sum(axis=-1) / 2.0
    return out


# ---------------------------------------------------------------------------
# The Feature pipeline (add_feature / normalize / finalize / compute)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FeatureParams:
    """Compact classifier parameter block for the device kernels."""

    singles: List[int]              # raw single flags in cache order
    mins: np.ndarray                # [S] float64
    maxs: np.ndarray                # [S]
    is_sim: np.ndarray              # [S] bool
    combos: List[Tuple[int, List[int]]]   # (combo_type, cache indices)
    weights: np.ndarray             # [1 + len(combos)] float64 (w0 first)


class Feature:
    """Faithful host-side port of the reference Feature<T> class.

    add_feature dedups single flags into `lookup` (Feature.cpp:8-31);
    normalize accumulates min/max over training pairs, skipping finalized
    singles and pinning FEAT_ALIGN to [0,1] (Feature.cpp:87-114);
    operator() combines normalized singles into combo columns (Feature.h:69-88).
    """

    def __init__(self, V: int):
        self.V = V
        self.flags = 0
        self.lookup: List[int] = []
        self.mins: List[float] = []
        self.maxs: List[float] = []
        self.is_sims: List[bool] = []
        self.is_finalized: List[bool] = []
        self.combos: List[Tuple[int, List[int]]] = []

    def copy(self) -> "Feature":
        f = Feature(self.V)
        f.flags = self.flags
        f.lookup = list(self.lookup)
        f.mins = list(self.mins)
        f.maxs = list(self.maxs)
        f.is_sims = list(self.is_sims)
        f.is_finalized = list(self.is_finalized)
        f.combos = [(c, list(ix)) for c, ix in self.combos]
        return f

    def index_of(self, flag: int) -> int:
        return self.lookup.index(flag)

    def size(self) -> int:
        return len(self.combos)

    def add_feature(self, f_flags: int, combo: int = COMBO_SELF) -> None:
        if combo not in (COMBO_SELF, COMBO_SQUARED):
            raise ValueError("invalid combo")
        indices = []
        f = 1
        while f <= f_flags:
            if f_flags & f:
                if not (self.flags & f):
                    self.lookup.append(f)
                    self.mins.append(float("inf"))
                    self.maxs.append(float("-inf"))
                    self.is_sims.append(_IS_SIM[f])
                    self.is_finalized.append(False)
                    self.flags |= f
                indices.append(self.index_of(f))
            f <<= 1
        self.combos.append((combo, indices))

    def normalize_raw(self, raw_by_single: Dict[int, np.ndarray]) -> None:
        """Update min/max from raw values of training pairs (one array per
        single flag present in lookup)."""
        for i, flag in enumerate(self.lookup):
            if flag == FEAT_ALIGN:
                self.mins[i] = 0.0
                self.maxs[i] = 1.0
                continue
            if self.is_finalized[i]:
                continue
            vals = np.asarray(raw_by_single[flag], np.float64)
            if vals.size:
                self.mins[i] = min(self.mins[i], float(vals.min()))
                self.maxs[i] = max(self.maxs[i], float(vals.max()))

    def finalize(self) -> None:
        for i in range(len(self.is_finalized)):
            self.is_finalized[i] = True

    def normalize_cache(self, cache: np.ndarray) -> np.ndarray:
        """cache [..., S] raw -> normalized (invert distance-type)."""
        mins = np.asarray(self.mins)
        maxs = np.asarray(self.maxs)
        val = (cache - mins) / (maxs - mins)
        sim = np.asarray(self.is_sims)
        return np.where(sim, val, 1.0 - val)

    def combo_columns(self, norm_cache: np.ndarray) -> np.ndarray:
        """normalized cache [..., S] -> combo feature columns [..., C]."""
        cols = []
        for combo, idx in self.combos:
            prod = np.ones(norm_cache.shape[:-1])
            for i in idx:
                c = norm_cache[..., i]
                prod = prod * (c * c if combo == COMBO_SQUARED else c)
            cols.append(prod)
        return np.stack(cols, axis=-1)

    def params(self, weights: np.ndarray) -> FeatureParams:
        return FeatureParams(
            singles=list(self.lookup),
            mins=np.asarray(self.mins, np.float64),
            maxs=np.asarray(self.maxs, np.float64),
            is_sim=np.asarray(self.is_sims, bool),
            combos=[(c, list(ix)) for c, ix in self.combos],
            weights=np.asarray(weights, np.float64).reshape(-1),
        )

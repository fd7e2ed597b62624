"""The identity classifier, refitted from the labelled pairs.

Frozen from the program's ops/features.py, ops/glm.py and the fitting half
of core/trainer.py (which follow Feature.cpp, GLM.cpp, Matrix.cpp and
Trainer.cpp): the raw statistics of the default feature menu from integer
histogram sums, min/max normalisation, combo products, the least-squares
GLM with gcc's FMA contraction, the class balancing by identity bins, the
alternating train/test split and the greedy growth of the feature set
under the 97.5 / 90 / +1 accuracy gates.

Every float operation takes the dtype `dt`: float64 as the configuration
states, float32 for the control.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

FEAT_ALIGN = 1 << 0
FEAT_LD = 1 << 1
FEAT_MANHATTAN = 1 << 2
FEAT_INTERSECTION = 1 << 4
FEAT_PEARSON = 1 << 5
FEAT_KULCZYNSKI2 = 1 << 10
COMBO_SQUARED = 1
COMBO_SELF = 2
IS_SIM = {FEAT_ALIGN: True, FEAT_LD: False, FEAT_MANHATTAN: False,
          FEAT_INTERSECTION: True, FEAT_PEARSON: False,
          FEAT_KULCZYNSKI2: True}
# Trainer.cpp:583-588 (feat_set == 1)
MENU: List[Tuple[int, int]] = [
    (FEAT_INTERSECTION | FEAT_LD, COMBO_SELF),
    (FEAT_MANHATTAN | FEAT_LD, COMBO_SQUARED),
    (FEAT_PEARSON, COMBO_SELF),
    (FEAT_KULCZYNSKI2 | FEAT_LD, COMBO_SQUARED),
]


class Model:
    """Feature singles, their bounds and combos, and the weights."""

    def __init__(self, V: int, dt=np.float64):
        self.V = V
        self.dt = dt
        self.flags = 0
        self.lookup: List[int] = []
        self.mins: List[float] = []
        self.maxs: List[float] = []
        self.finalized: List[bool] = []
        self.combos: List[Tuple[int, List[int]]] = []
        self.weights = np.zeros(0, dt)

    def copy(self) -> "Model":
        m = Model(self.V, self.dt)
        m.flags, m.lookup = self.flags, list(self.lookup)
        m.mins, m.maxs = list(self.mins), list(self.maxs)
        m.finalized = list(self.finalized)
        m.combos = [(c, list(ix)) for c, ix in self.combos]
        m.weights = self.weights.copy()
        return m

    def size(self) -> int:
        return len(self.combos)

    def add(self, flags: int, combo: int) -> None:
        """Feature::add_feature (Feature.cpp:8-31)."""
        indices = []
        f = 1
        while f <= flags:
            if flags & f:
                if not self.flags & f:
                    self.lookup.append(f)
                    self.mins.append(float("inf"))
                    self.maxs.append(float("-inf"))
                    self.finalized.append(False)
                    self.flags |= f
                indices.append(self.lookup.index(f))
            f <<= 1
        self.combos.append((combo, indices))

    def normalize_raw(self, raw: Dict[int, np.ndarray]) -> None:
        for i, flag in enumerate(self.lookup):
            if flag == FEAT_ALIGN:
                self.mins[i], self.maxs[i] = 0.0, 1.0
                continue
            if self.finalized[i]:
                continue
            vals = raw[flag]
            if vals.size:
                self.mins[i] = min(self.mins[i], float(vals.min()))
                self.maxs[i] = max(self.maxs[i], float(vals.max()))

    def finalize(self) -> None:
        self.finalized = [True] * len(self.finalized)

    def columns(self, cache: np.ndarray) -> np.ndarray:
        """raw cache [W, S] -> combo columns [W, C]."""
        dt = self.dt
        mins = np.asarray(self.mins, dt)
        maxs = np.asarray(self.maxs, dt)
        val = (cache.astype(dt) - mins) / (maxs - mins)
        norm = np.where(np.asarray([IS_SIM[f] for f in self.lookup]), val,
                        dt(1.0) - val)
        cols = []
        for combo, idx in self.combos:
            prod = np.ones(norm.shape[0], dt)
            for i in idx:
                c = norm[:, i]
                prod = prod * (c * c if combo == COMBO_SQUARED else c)
            cols.append(prod)
        return np.stack(cols, axis=-1)

    def classify(self, cache: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(positive [W], f1 [W]): score = w0 + sum w_j col_j accumulated
        in combo order, positive iff score >= 0; f1 the first column."""
        cols = self.columns(cache)
        score = np.full(cols.shape[0], self.weights[0], self.dt)
        for j in range(cols.shape[1]):
            score = score + self.weights[j + 1] * cols[:, j]
        return score >= 0.0, cols[:, 0]


def raw_from_sums(flag: int, man, dot, mag_a, mag_b, sq_a, sq_b, len_a,
                  len_b, V: int, dt=np.float64, align_val=None):
    """One raw statistic from exact integer sums (Feature.cpp:206-339)."""
    man = np.asarray(man).astype(dt)
    dot = np.asarray(dot).astype(dt)
    mag_a, mag_b, sq_a, sq_b, len_a, len_b = (
        np.asarray(x).astype(dt) for x in (mag_a, mag_b, sq_a, sq_b, len_a,
                                            len_b))
    V = dt(V)
    if flag == FEAT_ALIGN:
        return np.asarray(align_val).astype(dt)
    if flag == FEAT_LD:
        return np.abs(len_a - len_b)
    if flag == FEAT_MANHATTAN:
        return man
    if flag == FEAT_INTERSECTION:
        min_sum = (mag_a + mag_b - man) / dt(2.0)
        return dt(2.0) * min_sum / (mag_a + mag_b)
    if flag == FEAT_KULCZYNSKI2:
        ap = mag_a / V
        aq = mag_b / V
        min_sum = (mag_a + mag_b - man) / dt(2.0)
        coeff = V * (ap + aq) / (dt(2.0) * ap * aq)
        return coeff * min_sum
    if flag == FEAT_PEARSON:
        ap = np.floor(mag_a / V + dt(0.5))
        aq = np.floor(mag_b / V + dt(0.5))
        np_ = sq_a - dt(2.0) * ap * mag_a + V * ap * ap
        nq_ = sq_b - dt(2.0) * aq * mag_b + V * aq * aq
        dotc = dot - ap * mag_b - aq * mag_a + V * ap * aq
        return dotc / np.sqrt(np.maximum(dt(0.5), np_ * nq_))
    raise ValueError(f"feature {flag} is outside the default menu")


# -- GLM (GLM.cpp:19-33, Matrix.cpp:69-214) -----------------------------------
_FMA = None


def _fma():
    global _FMA
    if _FMA is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m"))
        fn = lib.fma
        fn.restype = ctypes.c_double
        fn.argtypes = [ctypes.c_double] * 3
        _FMA = fn
    return _FMA


def _matmul(a: np.ndarray, b: np.ndarray, fma: bool) -> np.ndarray:
    R, K = a.shape
    C = b.shape[1]
    out = np.zeros((R, C), a.dtype)
    if not fma:
        for k in range(K):
            out += a[:, k:k + 1] * b[k:k + 1, :]
        return out
    f = _fma()
    for i in range(R):
        for j in range(C):
            s = 0.0
            for k in range(K):
                s = f(float(a[i, k]), float(b[k, j]), s)
            out[i, j] = s
    return out


def _gauss_jordan_inverse(m: np.ndarray, fma: bool) -> np.ndarray:
    n = m.shape[0]
    a = np.array(m)
    inv = np.eye(n, dtype=m.dtype)
    if fma:
        f = _fma()

        def rowsub(dst, pv, src):
            return np.asarray([f(-float(pv), float(src[j]), float(dst[j]))
                               for j in range(n)], m.dtype)
    else:
        def rowsub(dst, pv, src):
            return dst - pv * src
    for i in range(n):
        if a[i, i] != 1.0:
            if a[i, i] != 0.0:
                pv = a[i, i]
                a[i, :] = a[i, :] / pv
                inv[i, :] = inv[i, :] / pv
            else:
                row = i + 1
                while row < n and a[row, i] == 0.0:
                    row += 1
                if row >= n:
                    raise np.linalg.LinAlgError("singular")
                a[[i, row]] = a[[row, i]]
                inv[[i, row]] = inv[[row, i]]
                pv = a[i, i]
                a[i, :] = a[i, :] / pv
                inv[i, :] = inv[i, :] / pv
        for below in range(i + 1, n):
            if a[below, i] != 0.0:
                pv = a[below, i]
                a[below, :] = rowsub(a[below, :], pv, a[i, :])
                inv[below, :] = rowsub(inv[below, :], pv, inv[i, :])
    for i in range(n - 1, -1, -1):
        for above in range(i):
            if a[above, i] != 0.0:
                pv = a[above, i]
                a[above, :] = rowsub(a[above, :], pv, a[i, :])
                inv[above, :] = rowsub(inv[above, :], pv, inv[i, :])
    return inv


def glm_train(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """w = ((inv_GJ(B) A^T) X^T) y with A = X^T X, B = A^T A; gcc's FMA
    contraction in float64, none in float32."""
    fma = X.dtype == np.float64
    y = y.reshape(-1, 1).astype(X.dtype)
    Xt = X.T.copy()
    A = _matmul(Xt, X, fma)
    B = _matmul(A.T.copy(), A, fma)
    Binv = _gauss_jordan_inverse(B, fma)
    P = _matmul(Binv, A.T.copy(), fma)
    Q = _matmul(P, Xt, fma)
    return _matmul(Q, y, fma).reshape(-1)


def glm_accuracy(y: np.ndarray, p: np.ndarray) -> float:
    return float(100.0 * (y == p).sum() / y.shape[0])


# -- labels, balancing and the split (Trainer.cpp:201-243, 490-526) ---------
def get_bin(x: float, lo: float, hi: float, num_bins: int) -> int:
    if x >= hi:
        return num_bins - 1
    if x <= lo:
        return 0
    return int(num_bins * (x - lo) / (hi - lo))


def resize_vec(vec, new_size: int, lo: float, hi: float, num_bins: int):
    if new_size == len(vec):
        return list(vec)
    bins: List[list] = [[] for _ in range(num_bins)]
    for pr, x in vec:
        bins[get_bin(x, lo, hi, num_bins)].append((pr, x))
    data: list = []
    while len(data) < new_size:
        take = math.ceil((new_size - len(data)) / num_bins)
        for i in range(num_bins - 1, -1, -1):
            for j in range(min(take, len(bins[i]))):
                data.append(bins[i][j])
    return data


def bin_data(vec, lo: float, hi: float):
    bins: List[list] = [[] for _ in range(10)]
    for pr, x in vec:
        bins[get_bin(x, lo, hi, 10)].append((pr, x))
    train, test = [], []
    last = 0
    for b in bins:
        for i, (pr, _) in enumerate(b):
            (train if i % 2 == last else test).append(pr)
        last = 1 - last
    return train, test


def labels(pairs: Sequence[Tuple[int, int]], ids: np.ndarray,
           headers: List[str], cutoff: float):
    """Trainer::get_labels after its alignments: the class split at the
    cutoff, each class ordered by header pair, then balanced by identity
    bins. (The program shuffles the pairs first; with unique headers the
    header order that follows leaves nothing of the shuffle.)"""
    pos, neg = {}, {}
    for pr, x in zip(pairs, ids):
        key = (headers[pr[0]], headers[pr[1]])
        (pos if x >= cutoff else neg).setdefault(key, (pr, float(x)))
    pos = [pos[k] for k in sorted(pos)]
    neg = [neg[k] for k in sorted(neg)]
    if not pos or not neg:
        raise ValueError("the sampled pairs fall in one class")
    m = min(len(pos), len(neg))
    return resize_vec(pos, m, cutoff, 1.0, 5), resize_vec(neg, m, 0.4,
                                                          cutoff, 5)


class Stats:
    """Per-record integer statistics of the histograms."""

    def __init__(self, hist: np.ndarray, lengths: np.ndarray):
        self.hist = hist
        self.mag = hist.sum(axis=1)
        self.sq = (hist * hist).sum(axis=1)
        self.lengths = lengths
        self.V = hist.shape[1]

    def raw(self, a_idx: np.ndarray, b_idx: np.ndarray, flags, dt,
            man=None, dot=None) -> Dict[int, np.ndarray]:
        if man is None:
            ha, hb = self.hist[a_idx], self.hist[b_idx]
            man = np.abs(ha - hb).sum(axis=1)
            dot = (ha * hb).sum(axis=1)
        return {f: raw_from_sums(f, man, dot, self.mag[a_idx],
                                 self.mag[b_idx], self.sq[a_idx],
                                 self.sq[b_idx], self.lengths[a_idx],
                                 self.lengths[b_idx], self.V, dt)
                for f in flags}


def fit(stats: Stats, bp, bn, cutoff: float, dt=np.float64,
        acc_cutoff: float = 97.5) -> Model:
    """Trainer::train's greedy loop (Trainer.cpp:527-651)."""
    train_pos, test_pos = bin_data(bp, cutoff, 1.0)
    train_neg, test_neg = bin_data(bn, 0.0, cutoff)
    if not test_pos or not test_neg:
        raise ValueError("not enough points to sample")

    def idx(prs):
        return (np.asarray([p for p, _ in prs], np.int64),
                np.asarray([q for _, q in prs], np.int64))

    def matrix(model, prs):
        a, b = idx(prs)
        raw = stats.raw(a, b, model.lookup, dt)
        cache = np.stack([raw[f] for f in model.lookup], axis=-1)
        return np.concatenate([np.ones((len(prs), 1), dt),
                               model.columns(cache)], axis=1)

    model = Model(stats.V, dt)
    prev_acc = -10000.0
    saved: List[Model] = []
    for num in range(max(1, len(MENU) - 1), len(MENU) + 1):
        for j in range(model.size(), min(num, len(MENU))):
            model.add(*MENU[j])
        for prs in (train_pos, train_neg):
            a, b = idx(prs)
            model.normalize_raw(stats.raw(a, b, model.lookup, dt))
        model.finalize()
        Xtr = matrix(model, train_pos + train_neg)
        ytr = np.concatenate([np.ones(len(train_pos)),
                              -np.ones(len(train_neg))]).astype(dt)
        Xte = matrix(model, test_pos + test_neg)
        yte = np.concatenate([np.ones(len(test_pos)),
                              -np.ones(len(test_neg))])
        model.weights = glm_train(Xtr, ytr)
        pte = np.where(Xte @ model.weights >= 0.0, 1, -1)
        acc = glm_accuracy(yte, pte)
        if acc - prev_acc <= 1 and acc >= 90.0 and saved:
            model = saved[-1]
            break
        saved.append(model.copy())
        prev_acc = acc
        if acc >= acc_cutoff:
            break
    return model


def align_model(cutoff: float, dt=np.float64) -> Model:
    """Align mode's fixed classifier: the identity alone, weights
    [-cutoff, 1] (Trainer.cpp:570-577)."""
    m = Model(0, dt)
    m.add(FEAT_ALIGN, COMBO_SELF)
    m.mins[0], m.maxs[0] = 0.0, 1.0
    m.finalize()
    m.weights = np.asarray([-1.0 * cutoff, 1.0], dt)
    return m

"""Linear classifier fit/predict (reference GLM + Matrix, SURVEY C11).

The reference "GLM" is one-shot least squares onto +/-1 labels:
    weights = pinv(X^T X) X^T y            (GLM.cpp:19-22)
with a sigmoid+round readout at predict time (GLM.cpp:24-33). pinv is a
Gauss-Jordan inverse of the (square, symmetric) normal matrix
(Matrix.cpp:202-214) — numerically this is plain least squares, which we
compute with numpy's lstsq (float64) for stability; identical up to FP
rounding on non-singular problems.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


_FMA = None


def _fma():
    """libm fma via ctypes (Python 3.12 lacks math.fma): gcc contracts the
    reference's `curSum + a*b` into FMA at -O3 (-ffp-contract=fast), so
    bit-exact weight replication needs the same single-rounding product.

    Returns None when libm/fma can't be resolved (non-glibc platforms where
    find_library('m') returns None, or CDLL(None) lacks the symbol) —
    callers then degrade to the fma=False reference path instead of
    crashing the default MESHCLUST_GLM_REF training path."""
    global _FMA
    if _FMA is None:
        import ctypes
        import ctypes.util
        try:
            lib = ctypes.CDLL(ctypes.util.find_library("m"))
            fn = lib.fma
            fn.restype = ctypes.c_double
            fn.argtypes = [ctypes.c_double, ctypes.c_double,
                           ctypes.c_double]
            # smoke-test the symbol actually computes fma
            if fn(2.0, 3.0, 1.0) != 7.0:
                raise OSError("fma symbol returned wrong value")
            _FMA = fn
        except (OSError, AttributeError, TypeError):
            _FMA = False
    return _FMA or None


def _matmul_ref(a: np.ndarray, b: np.ndarray, fma: bool) -> np.ndarray:
    """Matrix::operator* (Matrix.cpp:69-89): curSum accumulated over k in
    order. Vectorized over (i, j) with k outermost preserves the identical
    per-element accumulation order; fma=True reproduces gcc's contracted
    `curSum = fma(a_ik, b_kj, curSum)`."""
    R, K = a.shape
    K2, C = b.shape
    assert K == K2
    if not fma:
        out = np.zeros((R, C), np.float64)
        for k in range(K):
            out += a[:, k:k + 1] * b[k:k + 1, :]
        return out
    f = _fma()
    out = np.zeros((R, C), np.float64)
    for i in range(R):
        for j in range(C):
            s = 0.0
            for k in range(K):
                s = f(float(a[i, k]), float(b[k, j]), s)
            out[i, j] = s
    return out


def _gauss_jordan_inverse(m: np.ndarray, fma: bool) -> np.ndarray:
    """Matrix::gaussJordanInverse (Matrix.cpp:100-200), op-for-op float64:
    divide the pivot row only when the pivot != 1, eliminate below in the
    forward pass and above in the backward pass. With fma, the row update
    `x - pv*y` is contracted like gcc -O3 emits it."""
    n = m.shape[0]
    a = np.array(m, np.float64)
    inv = np.eye(n, dtype=np.float64)
    if fma:
        f = _fma()

        def rowsub(dst, pv, src):
            return np.asarray([f(-float(pv), float(src[j]), float(dst[j]))
                               for j in range(n)], np.float64)
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


def train(features: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """features [R, C] (first column 1s), labels [R] in {+1, -1} ->
    weights [C].

    Replicates GLM::train's exact float64 operation sequence
    (GLM.cpp:19-22 + Matrix::pseudoInverse, Matrix.cpp:202-214):
      A = X^T X;  B = A^T A;  w = ((inv_GJ(B) A^T) X^T) y
    including gcc's FMA contraction, so (given the reference-identical
    training pairs from trainer._ref_order_chain) trained weights are
    bit-identical to the reference binary's. MESHCLUST_GLM_FMA=0 drops
    the contraction; MESHCLUST_GLM_REF=0 falls back to np.linalg.solve."""
    import os
    X = np.asarray(features, np.float64)
    y = np.asarray(labels, np.float64).reshape(-1, 1)
    if os.environ.get("MESHCLUST_GLM_REF", "1") != "1":
        XtX = X.T @ X
        Xty = X.T @ y.reshape(-1)
        try:
            return np.linalg.solve(XtX, Xty)
        except np.linalg.LinAlgError:
            return np.linalg.lstsq(X, y.reshape(-1), rcond=None)[0]
    fma = os.environ.get("MESHCLUST_GLM_FMA", "1") == "1"
    if fma and _fma() is None:
        fma = False          # no usable libm fma: uncontracted ref path
    Xt = X.T.copy()
    try:
        A = _matmul_ref(Xt, X, fma)
        B = _matmul_ref(A.T.copy(), A, fma)
        Binv = _gauss_jordan_inverse(B, fma)
        P = _matmul_ref(Binv, A.T.copy(), fma)
        Q = _matmul_ref(P, Xt, fma)
        w = _matmul_ref(Q, y, fma)
        return w.reshape(-1)
    except np.linalg.LinAlgError:
        return np.linalg.lstsq(X, y.reshape(-1), rcond=None)[0]


def decision(features: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Raw linear score X @ w; classifier positive <=> score >= 0
    (round(sigmoid(s)) == 1 for s >= 0, C++ round-half-away)."""
    return np.asarray(features, np.float64) @ np.asarray(weights, np.float64)


def predict(features: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """{0,1} predictions like GLM::predict (sigmoid + round)."""
    return (decision(features, weights) >= 0.0).astype(np.int64)


def accuracy(labels: np.ndarray, preds_pm1: np.ndarray
             ) -> Tuple[float, float, float]:
    """(accuracy%, sensitivity%, specificity%) like GLM::accuracy
    (GLM.cpp:35-63). Inputs are +/-1 labels and +/-1 predictions."""
    y = np.asarray(labels).reshape(-1)
    p = np.asarray(preds_pm1).reshape(-1)
    pos = y == 1
    neg = ~pos
    acc = 100.0 * (y == p).sum() / y.shape[0]
    sens = 100.0 * ((y == p) & pos).sum() / max(1, pos.sum())
    spec = 100.0 * ((y == p) & neg).sum() / max(1, neg.sum())
    return float(acc), float(sens), float(spec)

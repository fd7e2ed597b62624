"""Cluster-quality metrics used by the reference's external validation
(Tables/*.csv: purity, NMI, 1-1 recovery, silhouette — SURVEY §4/§6)."""
from __future__ import annotations

from typing import Dict

import numpy as np


def purity(labels_pred: Dict[str, int], labels_true: Dict[str, int]) -> float:
    keys = set(labels_pred) & set(labels_true)
    clusters: Dict[int, list] = {}
    for k in keys:
        clusters.setdefault(labels_pred[k], []).append(labels_true[k])
    correct = 0
    for members in clusters.values():
        _, counts = np.unique(members, return_counts=True)
        correct += int(counts.max())
    return correct / max(1, len(keys))


def silhouette(hist: np.ndarray, mag: np.ndarray, labels: np.ndarray,
               sample: int = 2000, seed: int = 0) -> float:
    """Mean silhouette over a sample, with the engine's histogram distance
    d = 10000*(1 - f^2), f = 2*min_sum/(mag_a+mag_b)."""
    rng = np.random.default_rng(seed)
    n = hist.shape[0]
    idx = rng.permutation(n)[: min(sample, n)]
    h = hist.astype(np.int64)
    scores = []
    uniq = np.unique(labels)
    if uniq.shape[0] < 2:
        return 0.0
    for i in idx:
        min_sum = np.minimum(h[i][None, :], h).sum(axis=1)
        frac = 2.0 * min_sum / (mag[i] + mag)
        d = 10000.0 * (1.0 - frac * frac)
        same = labels == labels[i]
        same[i] = False
        if not same.any():
            continue
        a = d[same].mean()
        b = np.inf
        for c in uniq:
            if c == labels[i]:
                continue
            mask = labels == c
            if mask.any():
                b = min(b, d[mask].mean())
        s = (b - a) / max(a, b) if max(a, b) > 0 else 0.0
        scores.append(s)
    return float(np.mean(scores)) if scores else 0.0

"""k and the k-mer histograms, recomputed from the corpus.

k = ceil(log4(mean length)) - 1 with the reference's integer mean
(Runner.cpp:265-292). A record's histogram is a dense 4^k table started at
1 (the pseudocount) that counts the base-4 id of every k-mer window; a
record under 20 bases has no segment and keeps only the pseudocounts
(Chromosome.cpp:203). mag and sq are the sum and the sum of squares of a
row.
"""
from __future__ import annotations

from typing import List

import numpy as np

MIN_SEG = 20


def find_k(lengths: np.ndarray) -> int:
    mean = int(np.asarray(lengths, np.int64).sum()) // max(1, len(lengths))
    return max(1, int(np.ceil(np.log(max(mean, 2)) / np.log(4.0))) - 1)


def histograms(codes: List[np.ndarray], k: int) -> np.ndarray:
    """[N, 4^k] int64 counts, pseudocount included."""
    n = len(codes)
    V = 4 ** k
    lengths = np.asarray([c.shape[0] for c in codes], np.int64)
    flat = np.concatenate(codes).astype(np.int64) if n else \
        np.zeros(0, np.int64)
    T = flat.shape[0]
    ids = np.zeros(T, np.int64)
    for i in range(k):
        ids[: T - i] = ids[: T - i] * 4 + flat[i:]
    rows = np.repeat(np.arange(n, dtype=np.int64), lengths)
    off = np.repeat(np.cumsum(lengths) - lengths, lengths)
    pos = np.arange(T, dtype=np.int64) - off
    ok = (pos <= np.repeat(lengths, lengths) - k) & \
        np.repeat(lengths >= MIN_SEG, lengths)
    counts = np.bincount(rows[ok] * V + ids[ok], minlength=n * V)
    return counts.reshape(n, V).astype(np.int64) + 1

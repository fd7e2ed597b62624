"""Per-position genome scoring (reference Scorer, SURVEY R4; Scorer.cpp).

scores[p] = adjusted count of the k-mer starting at p, for p inside a
segment; the last k-1 positions of each segment repeat the previous value;
positions outside segments (N runs) stay 0. takeLog: ceil(log(v)/log(base))
for v != 0, with base 1 handled as log(1.5) and v == 1 left unchanged.
"""
from __future__ import annotations

import math

import numpy as np

from meshclust_tpu_torch.io import fasta as fio


def score_chromosome(seq: fio.Sequence, table: np.ndarray, k: int
                     ) -> np.ndarray:
    """Whole-chromosome vectorized scoring (one rolling-id pass + one table
    gather); the per-segment loop only patches the k-1 tail positions and
    the short-segment cascade (reference Scorer.cpp:36-66 semantics)."""
    from meshclust_tpu_torch.red.emv import rolling_ids, valid_mask

    scores = np.zeros(seq.length, np.int64)
    ids, ok = rolling_ids(seq.codes, valid_mask(seq), k)
    if ids.shape[0]:
        sel = np.where(ok)[0]
        scores[sel] = table[ids[sel]]
    for a, b in seq.segments:
        n = b - a + 1 - k + 1
        if n > 0:
            # positions a..a+n-1 came from the gather; the last k-1
            # positions of the segment repeat the previous value
            scores[a + n: b + 1] = scores[a + n - 1]
        else:
            # segment shorter than k: reference reads the previous value
            # (scores[i-1]) cascading from before the segment (0 there)
            scores[a: b + 1] = scores[a - 1] if a > 0 else 0
    return scores


def take_log(scores: np.ndarray, seq: fio.Sequence, base: float
             ) -> np.ndarray:
    """Scorer::takeLog semantics, in place on a copy."""
    out = scores.copy()
    is_one = abs(base - 1.0) < np.finfo(float).eps
    log_base = math.log(1.5) if is_one else math.log(base)
    for a, b in seq.segments:
        v = out[a: b + 1]
        mask = v != 0
        if is_one:
            mask = mask & (v > 1)
        vv = v[mask].astype(np.float64)
        v[mask] = np.ceil(np.log(vv) / log_base).astype(np.int64)
        out[a: b + 1] = v
    return out

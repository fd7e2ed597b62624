"""Genome k-mer table with Markov-background enrichment adjustment.

Reference: TableBuilder + EnrichmentMarkovView (SURVEY R2/R3;
TableBuilder.cpp:27-97, EnrichmentMarkovView.cpp:14-210).

counts[y] for every k-mer y over all genome segments, plus background word
counts of lengths 1..order+1. The adjusted value is
    exp(y) = L * prod_{m=1}^{order} P_m(prefix_m) * prod_i P_top(word_i)
where P_m are the per-group-normalized word frequencies (x factor=1e4,
rounded — faithfully reproduced) and the adjusted count is
    round(observed - exp) if observed >= min_obs and observed > exp else 0.

Everything is vectorized over the 4^k table with integer digit arithmetic.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from meshclust_tpu_torch.io import fasta as fio

FACTOR = 10000.0


def valid_mask(s: fio.Sequence) -> np.ndarray:
    """[L] bool: position is inside one of the sequence's segments."""
    v = np.zeros(s.length, bool)
    for a, b in s.segments:
        v[a: b + 1] = True
    return v


def chunk_tails(segments: np.ndarray, n: int, word_len: int) -> np.ndarray:
    """Starts (< n) among the last word_len - 1 of every segment chunk,
    whose windows end past their chunk. io/fasta.py cuts a non-N run longer
    than SEG_LENGTH into adjacent chunks, and the reference's TableBuilder
    counts each chunk on its own (TableBuilder.cpp:40-60,
    Chromosome.cpp:228-258): a window that spans two adjacent chunks is not
    counted, though every base of it is valid."""
    segs = np.asarray(segments, np.int64).reshape(-1, 2)
    back = np.arange(word_len - 1, dtype=np.int64)
    idx = segs[:, 1:2] - back[None, :]          # e, e-1, ..., e-wl+2
    keep = (idx >= segs[:, 0:1]) & (idx < n)
    return idx[keep]


def rolling_ids(codes: np.ndarray, valid: np.ndarray, word_len: int,
                segments: Optional[np.ndarray] = None):
    """(ids [n], window_ok [n]) for all windows of `word_len` over the WHOLE
    chromosome: ids by shifted integer sums (exact; int32 — Red's k is
    clamped to 15 so 4^k <= 2^30), window_ok iff every position of the
    window lies inside one segment (prefix-sum of the invalid mask).

    With `segments` (the sequence's chunks), window_ok also requires the
    window to end inside the chunk it starts in (chunk_tails): the starts
    of fasta.kmer_valid_starts, which are the windows the reference counts.
    Without it a window that spans two adjacent chunks passes; the scorer
    calls it so, and overwrites the last k - 1 positions of every chunk."""
    n = codes.shape[0] - word_len + 1
    if n <= 0:
        return (np.zeros(0, np.int32), np.zeros(0, bool))
    c = (codes & 3).astype(np.int32)      # out-of-segment bytes masked below
    ids = np.zeros(n, np.int32)
    for d in range(word_len):
        ids <<= 2
        ids += c[d: d + n]
    bad = np.concatenate([[0], np.cumsum(~valid, dtype=np.int32)])
    window_ok = (bad[word_len:] - bad[:-word_len]) == 0
    if segments is not None:
        window_ok[chunk_tails(segments, n, word_len)] = False
    return ids, window_ok


def count_words_multi(seqs: Sequence[fio.Sequence],
                      word_lens: Sequence[int]) -> dict:
    """{word_len: counts [4^wl]} in ONE pass per chromosome: the invalid-
    prefix and the rolling ids are shared across word lengths (ids for wl
    extend ids for the previous wl by appending digits), so a genome is
    read ~2x total instead of once per word length. A window counts only
    if it starts and ends inside one segment chunk (chunk_tails), as the
    reference counts each chunk on its own."""
    wls = sorted({int(w) for w in word_lens})
    out = {wl: np.zeros(4 ** wl, np.int64) for wl in wls}
    for s in seqs:
        valid = valid_mask(s)
        bad = np.concatenate([[0], np.cumsum(~valid, dtype=np.int32)])
        c = (s.codes & 3).astype(np.int32)
        L = c.shape[0]
        ids = None
        pl = 0
        for wl in wls:
            n = L - wl + 1
            if n <= 0:
                continue
            if ids is None:
                ids = np.zeros(n, np.int32)
                lo = 0
            else:
                ids = ids[:n]
                lo = pl
            for d in range(lo, wl):
                ids <<= 2
                ids += c[d: d + n]
            pl = wl
            ok = (bad[wl:] - bad[:-wl]) == 0
            ok[chunk_tails(s.segments, n, wl)] = False
            out[wl] += np.bincount(ids[ok], minlength=4 ** wl)
    return out


def count_words(seqs: Sequence[fio.Sequence], word_len: int) -> np.ndarray:
    """Counts of all words of `word_len` across all segments (init 0)."""
    return count_words_multi(seqs, [word_len])[word_len]


def build_table(seqs: Sequence[fio.Sequence], k: int, order: int,
                min_obs: int = 3) -> Tuple[np.ndarray, int, int]:
    """-> (adjusted counts [4^k] int64, genome_length, max_value)."""
    counts_map = count_words_multi(seqs, list(range(1, order + 2)) + [k])
    counts = counts_map[k]
    L = int(sum(int(b - a + 1) for s in seqs for a, b in s.segments))

    # background models: word lengths 1..order+1, group-normalized
    models: List[np.ndarray] = []
    for wl in range(1, order + 2):
        c = counts_map[wl].astype(np.float64)
        g = c.reshape(-1, 4)
        sums = g.sum(axis=1, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            norm = np.round(FACTOR * g / sums)
        norm = np.where(sums > 0, norm, 0.0)
        models.append(norm.reshape(-1))

    # The k-mer id y is base-4 digits d0..d_{k-1} (d0 most significant), so
    # model lookups by bit-sliced sub-words are pure digit-slice broadcasts:
    # prefix of length wl -> axis split [4^wl, rest]; sliding word at offset
    # i -> [4^i, 4^wl, rest].  Same factors multiplied in the same order as
    # the gather formulation (bit-identical doubles), but each factor is one
    # broadcast multiply over the 4^k table instead of a 4^k gather.
    V = 4 ** k
    # lowerP: prefixes of length 1..order (models 0..order-1)
    lowerP = np.ones(V, np.float64)
    for m in range(order):
        wl = m + 1
        fac = models[m] / FACTOR
        view = lowerP.reshape(4 ** wl, -1)
        view *= fac[:, None]
    # upper: sliding words of length order+1 at offsets 0..k-order-1
    top = models[order]
    wl = order + 1
    results_size = k - order - 1
    fac_top = top / FACTOR
    upperP = np.ones(V, np.float64)
    for i in range(results_size):
        view = upperP.reshape(4 ** i, 4 ** wl, -1)
        view *= fac_top[None, :, None]
    exp = L * lowerP
    exp *= upperP
    view = exp.reshape(-1, 4 ** wl)       # last word: offset k - wl
    view *= fac_top[None, :]

    observed = counts
    adjusted = np.where((observed >= min_obs) & (observed > exp),
                        np.round(observed - exp), 0.0).astype(np.int64)
    return adjusted, L, int(adjusted.max(initial=0))

"""Chromosome scanning + outputs (reference Scanner, SURVEY R8; Scanner.cpp).

decode per segment -> positive regions; extend each region end by k-1 within
its segment; merge overlaps; emit .rpt (zero-based, end-exclusive), .msk
(repeats lowercased), .scr (50 scores per line).
"""
from __future__ import annotations

from typing import List

import numpy as np

from meshclust_tpu_torch.io import fasta as fio
from meshclust_tpu_torch.red.hmm import HMM


def scan_chromosome(hmm: HMM, k: int, seq: fio.Sequence,
                    scores: np.ndarray) -> List[List[int]]:
    regions: List[List[int]] = []
    for a, b in seq.segments:
        regions.extend(hmm.decode_regions(scores, int(a), int(b)))
    # extendByK within each segment
    ri = 0
    for a, b in seq.segments:
        a, b = int(a), int(b)
        while ri < len(regions) and regions[ri][0] <= b \
                and a <= regions[ri][1]:
            regions[ri][1] = min(regions[ri][1] + k - 1, b)
            ri += 1
    # merge overlapping (Scanner::merge)
    gg = 0
    while gg < len(regions):
        if gg > 0:
            ps, pe = regions[gg - 1]
            rs, re = regions[gg]
            if ps <= re and rs <= pe:
                regions[gg - 1][1] = max(re, pe)
                del regions[gg]
                continue
            gg += 1
        if gg == 0:
            gg += 1
    return regions


def write_rpt(path: str, header: str, regions, fmt: int = 1,
              append: bool = False) -> None:
    """chrName:start-end (fmt 1) or chrName\\tstart\\tend (fmt 2);
    zero-based, end exclusive (Scanner::printIndex)."""
    name = header[1:] if header.startswith(">") else header
    with open(path, "a" if append else "w") as f:
        for s, e in regions:
            if fmt == 2:
                f.write(f"{name}\t{s}\t{e + 1}\n")
            else:
                f.write(f">{name}:{s}-{e + 1}\n")


def write_masked(path: str, header: str, original_seq: str, regions,
                 append: bool = False, width: int = 60) -> None:
    """Masked FASTA: repeat positions lowercased (Scanner::printMasked)."""
    base = list(original_seq)
    for s, e in regions:
        for h in range(s, min(e + 1, len(base))):
            base[h] = base[h].lower()
    with open(path, "a" if append else "w") as f:
        f.write(header + "\n")
        seq = "".join(base)
        for i in range(0, len(seq), width):
            f.write(seq[i: i + width] + "\n")


def write_scores(path: str, header: str, scores: np.ndarray,
                 append: bool = False) -> None:
    """50 scores per line under the header (Scorer::printScores)."""
    with open(path, "a" if append else "w") as f:
        f.write(header + "\n")
        n = scores.shape[0]
        for i in range(0, n, 50):
            f.write(" ".join(str(int(x)) for x in scores[i: i + 50]) + " \n")
        f.write("\n")

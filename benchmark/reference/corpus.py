"""A plain FASTA reader for the benchmark's corpora: one record a header
line and the lines after it, bases A, C, G, T in upper case coded 0-3 as
the reference binary codes them (ChromosomeOneDigit.cpp:59-85)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

_LUT = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _i


def read_fasta(path: str) -> Tuple[List[str], List[np.ndarray]]:
    """(headers with their '>', codes [L] uint8 a record)."""
    headers: List[str] = []
    chunks: List[List[bytes]] = []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                headers.append(line.decode())
                chunks.append([])
            elif line:
                chunks[-1].append(line)
    codes = []
    for h, parts in zip(headers, chunks):
        c = _LUT[np.frombuffer(b"".join(parts), np.uint8)]
        if (c == 255).any() or c.shape[0] >= 1_000_000:
            raise ValueError(f"record {h!r}: the reference reads only A, C, "
                             f"G and T, in records under 1 Mb")
        codes.append(c)
    return headers, codes

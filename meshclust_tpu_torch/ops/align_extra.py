"""Alternate alignment kernels kept for capability parity (SURVEY C17/N8/N9).

- needleman_wunsch: full-matrix affine NW with backtrack producing the
  aligned strings (ref needleman_wunsch.{h,cpp}; only referenced by a
  commented-out line in Trainer.cpp:23-24 but shipped by the reference).
- AffineId: 2-column affine-gap identity estimator (ref AffineId.cpp:82-192,
  MATCH=1 MIS=-1 OPEN=-2 EXT=-1).
- LCSLen: longest-common-subsequence length, two-row DP (ref LCSLen.{h,cpp}).

These are host (numpy) implementations — none are on the clustering hot
path; the production aligner is ops/align.batch_align.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

HORIZ, VERT, DIAG = 1, 2, 4


class NeedlemanWunsch:
    """Full-matrix affine NW with multi-direction backtrack flags.

    Mirrors the reference's quirks: sequences swapped so s1 is the longer
    (needleman_wunsch.cpp:129-143), gap(glen) = sigma + (glen-1)*epsilon,
    and the DP treats index 0 as the first CHARACTER (not a boundary row),
    exactly like fill() (needleman_wunsch.cpp:14-70).
    """

    def __init__(self, s1: str, s2: str, match: int, mismatch: int,
                 sigma: int, epsilon: int):
        if len(s1) >= len(s2):
            self.s1, self.s2 = s1, s2
        else:
            self.s1, self.s2 = s2, s1
        self.match = match
        self.mismatch = mismatch
        self.sigma = sigma
        self.epsilon = epsilon

    def gap(self, glen: int) -> int:
        return self.sigma + (glen - 1) * self.epsilon

    def align(self) -> Tuple[str, str]:
        s1, s2 = self.s1, self.s2
        l1, l2 = len(s1), len(s2)
        score = np.zeros((l1, l2), np.int64)
        direction = np.zeros((l1, l2), np.uint8)
        hlen = np.zeros((l1, l2), np.int64)
        vlen = np.zeros((l1, l2), np.int64)
        for i in range(l1):
            for j in range(l2):
                if i == 0 or j == 0:
                    if i == j:
                        score[0, 0] = 0
                        direction[0, 0] = DIAG
                    elif i == 0:
                        score[0, j] = score[0, j - 1] + self.gap(j)
                        vlen[0, j] = j
                        direction[0, j] = VERT
                    else:
                        score[i, 0] = score[i - 1, 0] + self.gap(i)
                        hlen[i, 0] = i
                        direction[i, 0] = HORIZ
                    continue
                hl = hlen[i - 1, j] + 1
                vl = vlen[i, j - 1] + 1
                ds = score[i - 1, j - 1] + (
                    self.match if s1[i] == s2[j] else self.mismatch)
                hs = score[i - 1, j] + self.gap(hl)
                vs = score[i, j - 1] + self.gap(vl)
                m = max(ds, hs, vs)
                score[i, j] = m
                d = 0
                if m == ds:
                    d |= DIAG
                if m == vs:
                    d |= VERT
                    vlen[i, j] = vl
                if m == hs:
                    d |= HORIZ
                    hlen[i, j] = hl
                direction[i, j] = d
        self._direction = direction
        self._score = score
        return self._backtrack()

    def _backtrack(self) -> Tuple[str, str]:
        s1, s2 = self.s1, self.s2
        a1, a2 = [], []
        i, j = len(s1) - 1, len(s2) - 1
        while i >= 0 and j >= 0:
            d = self._direction[i, j]
            if d & DIAG:
                a1.append(s1[i])
                a2.append(s2[j])
                i -= 1
                j -= 1
            elif d & HORIZ:
                a1.append(s1[i])
                a2.append("-")
                i -= 1
            elif d & VERT:
                a1.append("-")
                a2.append(s2[j])
                j -= 1
            else:
                break
        return "".join(reversed(a1)), "".join(reversed(a2))

    @staticmethod
    def identity(alignment: Tuple[str, str]) -> float:
        a, b = alignment
        count = sum(1 for x, y in zip(a, b) if x == y)
        return count / len(a)


def affine_id(seq1: np.ndarray, seq2: np.ndarray, match: int = 1,
              mis: int = -1, open_: int = -2, ext: int = -1) -> float:
    """AffineId::getAlign: lenCS / lenPath (ref AffineId.cpp:82-197).

    The reference constructor makes seq1 the LONGER sequence
    (AffineId.cpp:26-43)."""
    if len(seq1) < len(seq2):
        seq1, seq2 = seq2, seq1
    len1 = len(seq1) + 1
    len2 = len(seq2) + 1
    m = np.zeros((len2, 2), np.int64)
    u = np.zeros((len2, 2), np.int64)
    m_id = np.zeros((len2, 2), np.int64)
    u_id = np.zeros((len2, 2), np.int64)
    m_path = np.zeros((len2, 2), np.int64)
    u_path = np.zeros((len2, 2), np.int64)
    for i in range(1, len1):
        base1 = seq1[i - 1]
        lower = 0
        lower_id = 0
        lower_path = 0
        for j in range(1, len2):
            ext_lower = lower + ext
            open_lower = m[j - 1, 0] + open_
            if ext_lower > open_lower:
                lower = ext_lower
                lower_path += 1
            else:
                lower = open_lower
                lower_id = m_id[j - 1, 0]
                lower_path = m_path[j - 1, 0] + 1
            ext_upper = u[j, 0] + ext
            open_upper = m[j, 0] + open_
            if ext_upper > open_upper:
                u[j, 1] = ext_upper
                u_id[j, 1] = u_id[j, 0]
                u_path[j, 1] = u_path[j, 0] + 1
            else:
                u[j, 1] = open_upper
                u_id[j, 1] = m_id[j, 0]
                u_path[j, 1] = m_path[j, 0] + 1
            is_match = base1 == seq2[j - 1]
            mm = m[j - 1, 0] + (match if is_match else mis)
            lu = lower if lower > u[j, 1] else u[j, 1]
            if mm > lu:
                m[j, 1] = mm
                m_path[j, 1] = m_path[j - 1, 0] + 1
                m_id[j, 1] = m_id[j - 1, 0] + (1 if is_match else 0)
            else:
                m[j, 1] = lu
                if lower > u[j, 1]:
                    m_id[j, 1] = lower_id
                    m_path[j, 1] = lower_path
                else:
                    m_id[j, 1] = u_id[j, 1]
                    m_path[j, 1] = u_path[j, 1]
        if i != len1 - 1:
            m[:, 0] = m[:, 1]
            u[:, 0] = u[:, 1]
            m_id[:, 0] = m_id[:, 1]
            u_id[:, 0] = u_id[:, 1]
            m_path[:, 0] = m_path[:, 1]
            u_path[:, 0] = u_path[:, 1]
    len_cs = int(m_id[len2 - 1, 1])
    len_path = int(m_path[len2 - 1, 1])
    return len_cs / len_path if len_path else 0.0


def lcs_len(a: np.ndarray, b: np.ndarray) -> int:
    """Longest common subsequence length, two-row DP (ref LCSLen)."""
    la, lb = len(a), len(b)
    prev = np.zeros(lb + 1, np.int64)
    cur = np.zeros(lb + 1, np.int64)
    for i in range(1, la + 1):
        eq = a[i - 1] == b
        for j in range(1, lb + 1):
            if eq[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev, cur = cur, prev
    return int(prev[lb])

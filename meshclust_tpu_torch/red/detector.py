"""Candidate repeat-region detection (reference DetectorMaxima +
ChromDetectorMaxima, SURVEY R6; DetectorMaxima.cpp, ChromDetectorMaxima.cpp).

Per segment: Gaussian-mask smoothing (edge-renormalized), windowed first and
second derivative sums, zero-crossing maxima filtered by magnitude and by
the low-score percentage test, separator detection between maxima, region
assembly, then step-wise + base-wise region extension and overlap merging.
The smoothing/derivatives are vectorized (convolutions / prefix sums);
the region logic is a faithful loop (region counts are small).
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def _smooth(oscores: np.ndarray, seg_start: int, seg_end: int, s: int
            ) -> np.ndarray:
    sigma = s / 3.5
    part1 = 1.0 / math.sqrt(2 * math.pi * sigma * sigma)
    l = 2 * s + 1
    mask = part1 * np.exp(-((np.arange(l) - s) ** 2) / (2 * sigma * sigma))
    x = oscores[seg_start: seg_end + 1].astype(np.float64)
    num = np.convolve(x, mask[::-1], mode="same")
    den = np.convolve(np.ones_like(x), mask[::-1], mode="same")
    # np.convolve 'same' centers the kernel; mask is symmetric so the flip
    # is cosmetic. Edge renormalization = num/den exactly like the loop.
    return num / den


def _window_sums(scores: np.ndarray, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """first[i] = round(-L + R), second[i] = round(L + R - 2w*scores[i+w])
    for i in 0..len-2w-1, where L = sum(scores[i:i+w]),
    R = sum(scores[i+w+1:i+2w+1]) (DetectorMaxima::deriveFirst/Second)."""
    n = scores.shape[0]
    c = np.concatenate(([0.0], np.cumsum(scores)))
    m = n - 2 * w
    i = np.arange(m)
    L = c[i + w] - c[i]
    R = c[i + 2 * w + 1] - c[i + w + 1]
    center = scores[i + w]
    first = np.round(-L + R)
    second = np.round(L + R - 2 * w * center)
    return first, second


def detect_segment(oscores: np.ndarray, seg_start: int, seg_end: int,
                   s: int, w: int, m: float, t: float, p: float, e: int,
                   lt: np.ndarray = None) -> List[List[int]]:
    half_s = s
    smoothed = _smooth(oscores, seg_start, seg_end, s)
    first, second = _window_sums(smoothed, w)
    if lt is None:
        # prefix of score<t over the genome — callers with many segments
        # precompute this once (detect_chromosome) instead of per segment
        lt = np.concatenate(([0], np.cumsum(
            (oscores < t).astype(np.int64))))

    def count_less(a: int, b: int) -> int:
        return int(lt[b + 1] - lt[a])

    # maxima (DetectorMaxima::findMaxima)
    maxima: List[int] = []
    f0 = first[:-1]
    f1 = first[1:]
    cross = (f1 == 0) | ((f0 < 0) & (f1 > 0)) | ((f0 > 0) & (f1 < 0))
    neg2 = second[1:] < 0
    mag = np.abs(f0 - f1)
    cand = np.nonzero(cross & neg2 & (mag > m))[0] + 1
    for i in cand:
        peak = int(i) + w + seg_start
        ps = max(peak - half_s, seg_start)
        pe = min(peak + half_s, seg_end)
        v = 100.0 * count_less(ps, pe) / (pe - ps + 1)
        if v < p:
            maxima.append(peak)
    if not maxima:
        return []

    # separators + regions
    separators: List[Tuple[int, int]] = []
    for i in range(len(maxima) - 1):
        a, b = maxima[i], maxima[i + 1]
        v = 100.0 * count_less(a, b) / (b - a + 1)
        if v >= p:
            separators.append((a, b))
    regions: List[List[int]] = []
    start = maxima[0]
    for a, b in separators:
        regions.append([start, a])
        start = b
    regions.append([start, maxima[-1]])

    # extendRegions (step-wise + base-wise + merge)
    gg = 0
    while gg < len(regions):
        region = regions[gg]
        r_start, r_end = region
        if r_start == r_end:
            r_start = max(r_start - half_s, seg_start)
            r_end = min(r_end + half_s, seg_end)
            region[0], region[1] = r_start, r_end
        l_end = seg_start if gg == 0 else regions[gg - 1][1]
        u = r_start
        while u >= l_end:
            d = max(u - e + 1, l_end)
            v = 100.0 * count_less(d, u) / e
            if v >= p:
                break
            r_start = d
            u -= e
        if oscores[r_start] < t:
            for a in range(r_start, r_end):
                if oscores[a] >= t:
                    r_start = a
                    break
        else:
            a = r_start
            while a >= l_end and oscores[a] >= t:
                r_start = a
                a -= 1
        region[0] = r_start

        r_end_lim = seg_end if gg == len(regions) - 1 else regions[gg + 1][0]
        u = r_end
        while u <= r_end_lim:
            d = min(u + e - 1, r_end_lim)
            v = 100.0 * count_less(u, d) / e
            if v >= p:
                break
            r_end = d
            u += e
        if oscores[r_end] < t:
            for a in range(r_end, r_start, -1):
                if oscores[a] >= t:
                    r_end = a
                    break
        else:
            a = r_end
            while a <= r_end_lim and oscores[a] >= t:
                r_end = a
                a += 1
        region[1] = r_end

        if gg > 0:
            prev = regions[gg - 1]
            if prev[0] <= r_end and r_start <= prev[1]:
                prev[1] = r_end
                del regions[gg]
                continue
            gg += 1
        if gg == 0:
            gg += 1
    return regions


def detect_chromosome(oscores: np.ndarray, segments: np.ndarray, s: int,
                      w: int, m: float, t: float, p: float, e: int
                      ) -> List[List[int]]:
    """ChromDetectorMaxima::start: per segment, skipping segments not longer
    than 2w + 10 (ChromDetectorMaxima.cpp:38-56)."""
    out: List[List[int]] = []
    eff_len = 2 * w + 10
    lt = np.concatenate(([0], np.cumsum((oscores < t).astype(np.int64))))
    for a, b in segments:
        if b - a + 1 > eff_len:
            out.extend(detect_segment(oscores, int(a), int(b), s, w, m, t,
                                      p, e, lt=lt))
    return out

"""The length-binned candidate store (bvec.{h,cpp}), frozen from the
program's core/bvec.py with the native helpers replaced by plain Python:
the sequential least-filled insert and libstdc++'s std::sort per bin.

Its quirks, kept: one bin per `bin_size` sorted lengths, bounds from the
sorted lengths (bvec.cpp:10-24); insert into the least-filled eligible bin,
the middle one on ties (bvec.cpp:152-177); get_range's bin scan and in-bin
binary search with their boundary behaviours (bvec.cpp:52-149); pop from
the first non-empty bin, erase, and the harvest of marked entries over
whole bins in bin order (bvec.cpp:27-37, 281-317).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from benchmark.reference import stdsort


class BVec:
    def __init__(self, lengths: np.ndarray, bin_size: int = 1000):
        lengths = np.sort(np.asarray(lengths, np.int64))
        self.begin_bounds: List[int] = [
            int(lengths[i]) for i in range(0, lengths.shape[0], bin_size)
        ]
        nb = len(self.begin_bounds)
        # build phase: python lists; after insert_finalize: numpy arrays
        self.idx: List = [[] for _ in range(nb)]
        self.lens: List = [[] for _ in range(nb)]
        self.marked: List = [None] * nb
        self._final = False

    # -- construction ------------------------------------------------------
    def bulk_insert(self, lengths: np.ndarray) -> None:
        """Insert points 0..N-1 in id order by the sequential least-filled
        rule (bvec.cpp:152-177)."""
        lengths = np.asarray(lengths, np.int64)
        memo = {}
        for idx in range(lengths.shape[0]):
            ln = int(lengths[idx])
            fb = memo.get(ln)
            if fb is None:
                fb = memo[ln] = self._index_of(ln)
            front, back = fb
            sizes = [len(self.idx[i]) for i in range(front, back + 1)]
            minimum = min(sizes)
            min_bins = [front + i for i, s in enumerate(sizes)
                        if s == minimum]
            target = min_bins[len(min_bins) // 2]
            self.idx[target].append(idx)
            self.lens[target].append(ln)

    def insert_finalize(self) -> None:
        """Sort each bin by length with libstdc++'s std::sort
        (bvec.cpp:208-218; reference/stdsort.py)."""
        for b in range(len(self.idx)):
            lens = [int(x) for x in self.lens[b]]
            order = list(range(len(lens)))
            stdsort.sort_perm(order, lens)
            order = np.asarray(order, np.int64)
            self.idx[b] = np.asarray(self.idx[b], np.int64)[order]
            self.lens[b] = np.asarray(lens, np.int64)[order]
            self.marked[b] = np.zeros(len(order), bool)
        self._final = True

    # -- queries -----------------------------------------------------------
    def _index_of(self, length: int) -> Tuple[int, int]:
        """bvec::index_of: a linear scan over begin_bounds
        (bvec.cpp:122-149)."""
        bb = self.begin_bounds
        low = len(bb) - 1
        high = 0
        for i in range(len(bb)):
            prev = bb[i - 1] if i > 0 else 0
            prev_index = i - 1 if i > 0 else 0
            if prev <= length <= bb[i]:
                low = min(low, prev_index)
                high = max(high, prev_index)
        if length >= bb[-1]:
            high = max(high, len(bb) - 1)
        return low, high

    def _inner_index_of(self, length: int, idx: int, want_front: bool,
                        want_back: bool):
        """bvec::inner_index_of with its exact quirks (bvec.cpp:52-120).

        Returns (bin_idx, inner_idx) for the requested side.
        """
        data_len = len(self.idx[idx])
        if data_len == 0:
            if want_front:
                for i in range(len(self.idx)):
                    if len(self.idx[i]):
                        return i, 0
            if want_back:
                for i in range(len(self.idx) - 1, -1, -1):
                    if len(self.idx[i]):
                        return i, 0
            return idx, 0
        lens = self.lens[idx]
        front = 0
        back = 0
        low, high = 0, data_len - 1
        pre_front: Optional[int] = None
        pre_back: Optional[int] = None
        if want_front and length < lens[low]:
            pre_front = low
        if want_back and length > lens[high]:
            pre_back = high
        while low <= high:
            mid = (low + high) // 2
            d = lens[mid]
            if d == length:
                front = back = mid
                break
            elif length < d:
                high = mid
            else:
                low = mid + 1
            if low == high:
                front = low
                back = high
                break
        if want_front:
            i = front
            while i >= 0 and lens[i] == length:
                front = i
                i -= 1
            return idx, front if pre_front is None else pre_front
        if want_back:
            i = back
            while i < data_len and lens[i] == length:
                back = i
                i += 1
            return idx, back if pre_back is None else pre_back
        return idx, front

    def get_range(self, begin_len: int, end_len: int):
        """-> ((bin, inner), (bin, inner)), INCLUSIVE bounds
        (bvec.cpp:246-278)."""
        front_bin = self._index_of(begin_len)[0]
        back_bin = self._index_of(end_len)[1]
        fb, fi = self._inner_index_of(begin_len, front_bin, True, False)
        bb_, bi = self._inner_index_of(end_len, back_bin, False, True)
        return (fb, fi), (bb_, bi)

    def window_spans(self, front, back):
        """The inclusive window as [(bin, c0, c1)] spans."""
        r, c = front
        br, bc = back
        nb = len(self.idx)
        spans = []
        while r < nb and (r < br or (r == br and c <= bc)):
            size = len(self.idx[r])
            if c >= size:
                r += 1
                c = 0
                continue
            c1 = min((bc + 1) if r == br else size, size)
            if c1 > c:
                spans.append((r, c, c1))
            if r == br:
                break
            r += 1
            c = 0
        return spans

    def window(self, front, back):
        """(flat point-index array, spans) for the inclusive range."""
        spans = self.window_spans(front, back)
        if spans:
            flat = np.concatenate(
                [self.idx[b][c0:c1] for b, c0, c1 in spans])
        else:
            flat = np.zeros(0, np.int64)
        return flat, spans

    def apply_marks(self, spans, marks: np.ndarray) -> None:
        """Set marked flags for a window given flat marks (window order)."""
        off = 0
        for b, c0, c1 in spans:
            n = c1 - c0
            self.marked[b][c0:c1] |= marks[off: off + n]
            off += n

    def flat_to_position(self, spans, flat_pos: int):
        """Map a flat window position back to (bin, inner)."""
        off = 0
        for b, c0, c1 in spans:
            n = c1 - c0
            if flat_pos < off + n:
                return b, c0 + (flat_pos - off)
            off += n
        raise IndexError(flat_pos)

    # -- mutation ----------------------------------------------------------
    def pop(self) -> Optional[int]:
        for b in range(len(self.idx)):
            if len(self.idx[b]):
                p = int(self.idx[b][0])
                self.idx[b] = self.idx[b][1:]
                self.lens[b] = self.lens[b][1:]
                self.marked[b] = self.marked[b][1:]
                return p
        return None

    def erase(self, r: int, c: int) -> None:
        keep = np.ones(len(self.idx[r]), bool)
        keep[c] = False
        self.idx[r] = self.idx[r][keep]
        self.lens[r] = self.lens[r][keep]
        self.marked[r] = self.marked[r][keep]

    def remove_available(self, front, back) -> List[int]:
        """Harvest marked points in bins front.bin..back.bin (FULL bins, like
        the reference) in bin-then-index order; returns point indices
        (bvec.cpp:290-317)."""
        a, b = front[0], back[0]
        out: List[int] = []
        for i in range(a, min(b, len(self.idx) - 1) + 1):
            m = self.marked[i]
            if m.any():
                out.extend(self.idx[i][m].tolist())
                keep = ~m
                self.idx[i] = self.idx[i][keep]
                self.lens[i] = self.lens[i][keep]
                self.marked[i] = self.marked[i][keep]
        return out

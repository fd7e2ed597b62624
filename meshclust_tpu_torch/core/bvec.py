"""Length-binned candidate store — faithful emulation of bvec<T>.

Reference: bvec.{h,cpp} + bvec_iterator (SURVEY C7/C8). This is pure host
bookkeeping (numpy index arrays per bin); the heavy numeric work happens on
static device arrays (see core/meanshift).

Faithfully reproduced quirks:
- one bin per `bin_size` sorted lengths; bin lower bounds from the sorted
  length array (bvec.cpp:10-24),
- insert into the least-filled eligible bin, middle one on ties
  (bvec.cpp:152-177),
- per-bin sort by length at finalize (stable here; the reference's std::sort
  tie order is unspecified — tie-breaking tolerance) (bvec.cpp:209-218),
- `get_range`'s bin-level linear scan and the in-bin binary search with its
  boundary behaviors (bvec.cpp:122-149, 52-120),
- `pop` from the first non-empty bin; `erase`; `remove_available` harvest of
  marked entries in bin order (bvec.cpp:27-37, 281-317).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


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
    def insert(self, point_idx: int, length: int) -> None:
        front, back = self._index_of(length)
        sizes = [len(self.idx[i]) for i in range(front, back + 1)]
        minimum = min(sizes)
        min_bins = [front + i for i, s in enumerate(sizes) if s == minimum]
        target = min_bins[len(min_bins) // 2]
        self.idx[target].append(point_idx)
        self.lens[target].append(int(length))

    def bulk_insert(self, lengths: np.ndarray) -> None:
        """Insert points 0..N-1 (id order) with the sequential least-filled
        rule, without N Python-level insert calls. The native helper
        (native/bvec_insert.cpp: memoized index_of + a segment tree over bin
        sizes, O(N log nbins)) computes the per-point target bin; the Python
        per-insert loop remains the oracle (tests/test_bvec.py) and the
        fallback. At 1M points the Python loop costs minutes; this is ~0.1 s.
        """
        from meshclust_tpu_torch import native
        lengths = np.asarray(lengths, np.int64)
        targets = native.bvec_targets(lengths,
                                      np.asarray(self.begin_bounds, np.int64))
        if targets is None:
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
            return
        order = np.argsort(targets, kind="stable")
        tg = targets[order]
        starts = np.searchsorted(tg, np.arange(len(self.idx) + 1))
        for b in range(len(self.idx)):
            sl = order[starts[b]: starts[b + 1]]
            self.idx[b] = sl.astype(np.int64).tolist()
            self.lens[b] = lengths[sl].tolist()

    def insert_finalize(self) -> None:
        """Sort each bin by length (bvec.cpp:208-218). The reference uses
        UNSTABLE std::sort, and the in-bin tie order is the Phase-A member
        iteration order — for bins > 16 elements libstdc++'s quicksort
        phase permutes ties differently from a stable argsort (round-5
        parity find: first wrong member order at 20k), so the introsort is
        replayed exactly via the native helper when available."""
        from meshclust_tpu_torch import native
        use_ref = native.get_refsort() is not None
        for b in range(len(self.idx)):
            lens = np.asarray(self.lens[b], np.int64)
            if use_ref and len(lens) > 16:
                order32 = np.arange(len(lens), dtype=np.int32)
                native.ref_sort_perm(order32, lens)
                order = order32.astype(np.int64)
            else:
                # <= 16 elements: libstdc++ uses insertion sort == stable
                order = np.argsort(lens, kind="stable")
            self.idx[b] = np.asarray(self.idx[b], np.int64)[order]
            self.lens[b] = lens[order]
            self.marked[b] = np.zeros(len(order), bool)
        self._final = True

    # -- queries -----------------------------------------------------------
    def _index_of(self, length: int) -> Tuple[int, int]:
        """bvec::index_of — linear scan over begin_bounds (bvec.cpp:122-149)."""
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

    def iter_range(self, front, back):
        """Yield (bin, inner) positions from front to back inclusive, with
        bvec_iterator's skip-empty-bin semantics (bvec_iterator.cpp)."""
        for b, c0, c1 in self.window_spans(front, back):
            for c in range(c0, c1):
                yield (b, c)

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

    def mark(self, r: int, c: int) -> None:
        self.marked[r][c] = True

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

    def size(self) -> int:
        return sum(len(b) for b in self.idx)

    def empty(self) -> bool:
        return all(len(b) == 0 for b in self.idx)

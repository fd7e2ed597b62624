"""libstdc++'s std::sort (introsort) in plain Python, for an index array
sorted by integer keys.

std::sort is unstable: the order it leaves tied keys in is fixed by its
algorithm, and the program's length-binned store sorts each bin with it
(bvec.cpp:208-218). The order of tied lengths inside a bin is the order in
which Phase A visits them, so the reference replays the same algorithm:
__introsort_loop with a median-of-three pivot moved to the front and
__unguarded_partition, a heap sort past 2 log2(n) levels, then
__final_insertion_sort with its threshold of 16 (bits/stl_algo.h).
"""
from __future__ import annotations

from typing import List, Sequence

THRESHOLD = 16


def sort_perm(idx: List[int], key: Sequence[int]) -> None:
    """Sort idx in place by key[idx] ascending, as std::sort would."""
    n = len(idx)
    if n < 2:
        return
    _introsort_loop(idx, 0, n, 2 * (n.bit_length() - 1), key)
    _final_insertion_sort(idx, 0, n, key)


def _introsort_loop(a, first, last, depth, key):
    while last - first > THRESHOLD:
        if depth == 0:
            _heap_sort(a, first, last, key)
            return
        depth -= 1
        cut = _partition_pivot(a, first, last, key)
        _introsort_loop(a, cut, last, depth, key)
        last = cut


def _partition_pivot(a, first, last, key):
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1, key)
    return _unguarded_partition(a, first + 1, last, first, key)


def _move_median_to_first(a, result, x, y, z, key):
    kx, ky, kz = key[a[x]], key[a[y]], key[a[z]]
    if kx < ky:
        if ky < kz:
            a[result], a[y] = a[y], a[result]
        elif kx < kz:
            a[result], a[z] = a[z], a[result]
        else:
            a[result], a[x] = a[x], a[result]
    elif kx < kz:
        a[result], a[x] = a[x], a[result]
    elif ky < kz:
        a[result], a[z] = a[z], a[result]
    else:
        a[result], a[y] = a[y], a[result]


def _unguarded_partition(a, first, last, pivot, key):
    kp = key[a[pivot]]
    while True:
        while key[a[first]] < kp:
            first += 1
        last -= 1
        while kp < key[a[last]]:
            last -= 1
        if not first < last:
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _insertion_sort(a, first, last, key):
    for i in range(first + 1, last):
        val = a[i]
        kv = key[val]
        if kv < key[a[first]]:
            a[first + 1: i + 1] = a[first: i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i, key)


def _unguarded_linear_insert(a, last, key):
    val = a[last]
    kv = key[val]
    nxt = last - 1
    while kv < key[a[nxt]]:
        a[last] = a[nxt]
        last = nxt
        nxt -= 1
    a[last] = val


def _final_insertion_sort(a, first, last, key):
    if last - first > THRESHOLD:
        _insertion_sort(a, first, first + THRESHOLD, key)
        for i in range(first + THRESHOLD, last):
            _unguarded_linear_insert(a, i, key)
    else:
        _insertion_sort(a, first, last, key)


# std::__partial_sort(first, last, last): make_heap, then sort_heap.
def _adjust_heap(a, first, hole, length, value, key):
    top = hole
    child = hole
    while child < (length - 1) // 2:
        child = 2 * (child + 1)
        if key[a[first + child]] < key[a[first + child - 1]]:
            child -= 1
        a[first + hole] = a[first + child]
        hole = child
    if (length & 1) == 0 and child == (length - 2) // 2:
        child = 2 * (child + 1)
        a[first + hole] = a[first + child - 1]
        hole = child - 1
    parent = (hole - 1) // 2
    kv = key[value]
    while hole > top and key[a[first + parent]] < kv:
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _heap_sort(a, first, last, key):
    n = last - first
    if n >= 2:
        parent = (n - 2) // 2
        while True:
            _adjust_heap(a, first, parent, n, a[first + parent], key)
            if parent == 0:
                break
            parent -= 1
    while last - first > 1:
        last -= 1
        value = a[last]
        a[last] = a[first]
        _adjust_heap(a, first, 0, last - first, value, key)

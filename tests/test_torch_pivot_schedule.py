"""What the pivot-order kernel (meshclust_tpu_torch/csrc/pivot_order.cu)
relies on, checked on the CPU through a numpy model of its decomposition.

The kernel runs only on a CUDA card. It must leave each row in the order
libstdc++'s std::sort leaves it (GCC 12, bits/stl_algo.h, stl_heap.h),
tied keys included. The model below replays its steps:
  rounds      every pending range a round, its children into the next
              round's list (in any order: the kernel appends them by
              atomics); a range past `large` elements partitioned by the
              block, the others by warps, taken in a random order;
  depth       the root's 2 floor(log2 n), each child at its parent's less
              one, a range of depth 0 sorted by the heap path on one thread
              (libstdc++'s __make_heap and __sort_heap steps), counted;
  partition   __move_median_to_first's comparisons, then the rank pairing:
              the block's ranks from an exclusive scan of each thread's
              counts over a contiguous chunk of odd length, a warp's from
              ballots over 32 positions at a time; an L (key >= pv, past
              the pivot) at rank j moves iff at least j + 1 R (key <= pv)
              lie right of it, an R at rank j from the right iff at least
              j + 1 L lie left of it; their positions written to scr[f + j]
              and scr[l - 1 - j], each slot once, then the pairs swapped;
              the cut the least of the first L that stays and the moving R;
  leaves      a range of at most 16 elements, or each position of a heap
              range, starts a leaf at a set bit; each leaf is sorted by a
              stable insertion, every leaf on its own.
Each partition is held to the header's __unguarded_partition_pivot run on
a copy of the range, each heap range to __partial_sort's steps, the leaves
to __final_insertion_sort over the whole row, and the result to
native/refsort.cpp's std::sort (built with this machine's g++) and to a
sequential replica of the header; the heap count to the replica's. Inputs:
n = 1, 2, 16, 17, 33, equal, sorted, reverse-sorted, tie-heavy and
clustered keys (a 15k-point row's shape), and a McIlroy adversary built
against the replica, which reaches the depth limit. Copies of the model
with an R's move rule off by one or the leaves sorted unstably must
disagree. The wrapper on CPU tensors is the host chain, and
csrc/pivot_order.cu's constants are ops/pivot_order.py's. Tolerance: exact
equality.
"""
import os
import re
import zlib

import numpy as np
import pytest
import torch

from meshclust_tpu_torch import native
from meshclust_tpu_torch.ops import pivot_order as PO

torch.set_num_threads(1)
SOURCE = os.path.join(os.path.dirname(PO.__file__), "..", "csrc",
                      "pivot_order.cu")
THRESHOLD = 16


# -- libstdc++'s std::sort, as the header writes it ------------------------
# Generic in the keys (anything with <), so that an adversary can answer
# the comparisons; _heap_sort counts the ranges that reach it.

class Replica:
    def __init__(self, key):
        self.key = key
        self.heaps = 0

    def sort(self, a):
        n = len(a)
        if n > 0:
            self.introsort_loop(a, 0, n, 2 * (n.bit_length() - 1))
            self.final_insertion_sort(a, 0, n)

    def introsort_loop(self, a, first, last, depth):
        while last - first > THRESHOLD:
            if depth == 0:
                self.heap_sort(a, first, last)
                return
            depth -= 1
            cut = self.partition_pivot(a, first, last)
            self.introsort_loop(a, cut, last, depth)
            last = cut

    def partition_pivot(self, a, first, last):
        mid = first + (last - first) // 2
        self.move_median_to_first(a, first, first + 1, mid, last - 1)
        return self.unguarded_partition(a, first + 1, last, first)

    def less(self, x, y):
        return self.key[x] < self.key[y]

    def move_median_to_first(self, a, result, x, y, z):
        lt = self.less
        if lt(a[x], a[y]):
            if lt(a[y], a[z]):
                pick = y
            elif lt(a[x], a[z]):
                pick = z
            else:
                pick = x
        elif lt(a[x], a[z]):
            pick = x
        elif lt(a[y], a[z]):
            pick = z
        else:
            pick = y
        a[result], a[pick] = a[pick], a[result]

    def unguarded_partition(self, a, first, last, pivot):
        while True:
            while self.less(a[first], a[pivot]):
                first += 1
            last -= 1
            while self.less(a[pivot], a[last]):
                last -= 1
            if not first < last:
                return first
            a[first], a[last] = a[last], a[first]
            first += 1

    def insertion_sort(self, a, first, last):
        for i in range(first + 1, last):
            if self.less(a[i], a[first]):
                v = a[i]
                a[first + 1: i + 1] = a[first: i]
                a[first] = v
            else:
                self.unguarded_linear_insert(a, i)

    def unguarded_linear_insert(self, a, last):
        v = a[last]
        nxt = last - 1
        while self.less(v, a[nxt]):
            a[last] = a[nxt]
            last = nxt
            nxt -= 1
        a[last] = v

    def final_insertion_sort(self, a, first, last):
        if last - first > THRESHOLD:
            self.insertion_sort(a, first, first + THRESHOLD)
            for i in range(first + THRESHOLD, last):
                self.unguarded_linear_insert(a, i)
        else:
            self.insertion_sort(a, first, last)

    def adjust_heap(self, a, first, hole, length, value):
        top = child = hole
        while child < (length - 1) // 2:
            child = 2 * (child + 1)
            if self.less(a[first + child], a[first + child - 1]):
                child -= 1
            a[first + hole] = a[first + child]
            hole = child
        if length & 1 == 0 and child == (length - 2) // 2:
            child = 2 * (child + 1)
            a[first + hole] = a[first + child - 1]
            hole = child - 1
        parent = int((hole - 1) / 2)              # C++'s truncation
        while hole > top and self.less(a[first + parent], value):
            a[first + hole] = a[first + parent]
            hole = parent
            parent = int((hole - 1) / 2)
        a[first + hole] = value

    def heap_sort(self, a, first, last):          # __partial_sort(f, l, l)
        self.heaps += 1
        length = last - first
        if length >= 2:
            parent = (length - 2) // 2
            while True:
                self.adjust_heap(a, first, parent, length, a[first + parent])
                if parent == 0:
                    break
                parent -= 1
        while last - first > 1:
            last -= 1
            v = a[last]
            a[last] = a[first]
            self.adjust_heap(a, first, 0, last - first, v)


def replica_sort(perm, key):
    a = [int(x) for x in perm]
    r = Replica([int(k) for k in key])
    r.sort(a)
    return np.asarray(a, np.int32), r.heaps


def native_sort(perm, key):
    a = np.ascontiguousarray(perm, np.int32).copy()
    assert native.ref_sort_perm(a, np.asarray(key, np.int64))
    return a


# -- the kernel's decomposition ---------------------------------------------

def excl(x):
    """Exclusive prefix sum."""
    c = np.cumsum(x)
    return c - x


class Model:
    """pivot_order_kernel's order phase over one row (`threads` a block,
    ranges past `large` partitioned by the block). `broken` names a fault
    planted for the mutation tests."""

    def __init__(self, key, threads=PO.THREADS, large=PO.LARGE, seed=0,
                 broken=None):
        self.key = np.asarray(key, np.int64)
        self.threads = threads
        self.large = large
        self.rng = np.random.default_rng(seed)
        self.broken = broken
        self.replica = Replica([int(k) for k in self.key])
        self.heaps = 0
        self.partitions = 0

    def run(self, perm):
        idx = np.asarray(perm, np.int64).copy()
        n = idx.shape[0]
        self.idx, self.n = idx, n
        self.scr = np.zeros(n, np.int64)
        self.stamp = np.full(n, -1, np.int64)     # the partition a slot is of
        self.bits = np.zeros(n, bool)
        cur = []
        if n > THRESHOLD:
            cur = [(0, n, 2 * (n.bit_length() - 1))]
        elif n > 0:
            self.bits[0] = True
        while cur:
            nxt = []
            # the list's order is the atomics' of the round before
            cur = [cur[i] for i in self.rng.permutation(len(cur))]
            for r in cur:
                if r[1] - r[0] > self.large:
                    self.step(r, nxt, self.block_pass)
            small = [r for r in cur if r[1] - r[0] <= self.large]
            for i in self.rng.permutation(len(small)):
                self.step(small[i], nxt, self.warp_pass)
            cur = nxt
        loop_out = [int(x) for x in idx]
        self.leaves()
        want = list(loop_out)
        self.replica.final_insertion_sort(want, 0, n)
        assert list(idx) == want
        return idx.astype(np.int32)

    # one range ---------------------------------------------------------
    def step(self, r, nxt, partition):
        f, l, d = r
        idx, key = self.idx, self.key
        if d == 0:
            want = [int(x) for x in idx[f:l]]
            self.replica.heap_sort(want, 0, l - f)
            self.heap_sort(f, l)
            assert list(idx[f:l]) == want
            self.heaps += 1
            self.bits[f:l] = True
            return
        want = [int(x) for x in idx[f:l]]
        want_cut = f + self.replica.partition_pivot(want, 0, l - f)
        self.median_to_first(f, f + 1, f + (l - f) // 2, l - 1)
        pv = int(key[idx[f]])
        self.partitions += 1
        s, cut = partition(f, l, pv)
        for j in range(s):
            a, b = self.scr[f + j], self.scr[l - 1 - j]
            assert self.stamp[f + j] == self.stamp[l - 1 - j] \
                == self.partitions and f < a < b < l
            idx[a], idx[b] = idx[b], idx[a]
        assert cut == want_cut and list(idx[f:l]) == want
        for cf, cl in ((f, cut), (cut, l)):
            assert cl - cf >= 1
            if cl - cf > THRESHOLD:
                nxt.append((cf, cl, d - 1))
            else:
                self.bits[cf] = True

    def median_to_first(self, result, a, b, c):
        idx, key = self.idx, self.key
        ka, kb, kc = key[idx[a]], key[idx[b]], key[idx[c]]
        if ka < kb:
            pick = b if kb < kc else c if ka < kc else a
        else:
            pick = a if ka < kc else c if kb < kc else b
        idx[result], idx[pick] = idx[pick], idx[result]

    def moves(self, f, l, pos, isL, isR, preL, preR, totR):
        """The positions' moves and the slots they write; -> (moved L,
        least cut candidate)."""
        after = totR - preR - isR                 # R right of p: its rank
        mvL = isL & (after >= preL + 1)
        mvR = isR & (preL >= after + (2 if self.broken == "r_rule" else 1))
        for slots, p in ((f + preL[mvL], pos[mvL]),
                         (l - 1 - after[mvR], pos[mvR])):
            assert (self.stamp[slots] != self.partitions).all()
            assert ((slots >= f) & (slots < l)).all()
            self.scr[slots] = p
            self.stamp[slots] = self.partitions
        cand = pos[(isL & ~mvL) | mvR]
        return int(mvL.sum()), int(cand.min()) if cand.size else l

    def block_pass(self, f, l, pv):
        """A contiguous chunk of odd length a thread; the thread's counts,
        their exclusive scan over the block, then each chunk in order."""
        T = self.threads
        chunk = ((l - f + T - 1) // T) | 1
        assert T * chunk >= l - f
        spans = [(min(f + t * chunk, l), min(f + t * chunk + chunk, l))
                 for t in range(T)]
        flags = []
        for a, b in spans:
            pos = np.arange(a, b)
            k = self.key[self.idx[a:b]]
            flags.append((pos, (pos > f) & (k >= pv), k <= pv))
        cL = np.asarray([fl[1].sum() for fl in flags])
        cR = np.asarray([fl[2].sum() for fl in flags])
        baseL, baseR, totR = excl(cL), excl(cR), int(cR.sum())
        s, cut = 0, l
        for t in range(T):
            pos, isL, isR = flags[t]
            moved, c = self.moves(f, l, pos, isL, isR,
                                  baseL[t] + excl(isL.astype(np.int64)),
                                  baseR[t] + excl(isR.astype(np.int64)),
                                  totR)
            s, cut = s + moved, min(cut, c)
        return s, cut

    def warp_pass(self, f, l, pv):
        """32 positions at a time: totR by ballots, then each position's
        ranks from the running counts and its lanes below."""
        lanes = np.arange(32)

        def chunk(base):
            p = base + lanes
            inr = p < l
            k = np.where(inr, self.key[self.idx[np.minimum(p, l - 1)]], 0)
            return p, inr & (p > f) & (k >= pv), inr & (k <= pv)

        totR = sum(int(chunk(b)[2].sum()) for b in range(f, l, 32))
        preL = preR = s = 0
        cut = l
        for base in range(f, l, 32):
            p, isL, isR = chunk(base)
            moved, c = self.moves(f, l, p, isL, isR,
                                  preL + excl(isL.astype(np.int64)),
                                  preR + excl(isR.astype(np.int64)), totR)
            s, cut = s + moved, min(cut, c)
            preL += int(isL.sum())
            preR += int(isR.sum())
        return s, cut

    def heap_sort(self, f, l):
        """The kernel's heap_sort: make_heap, then sort_heap, over [f, l)."""
        a, key = self.idx, self.key

        def adjust(hole, length, value):
            top = child = hole
            while child < (length - 1) // 2:
                child = 2 * (child + 1)
                if key[a[f + child]] < key[a[f + child - 1]]:
                    child -= 1
                a[f + hole] = a[f + child]
                hole = child
            if length & 1 == 0 and child == (length - 2) // 2:
                child = 2 * (child + 1)
                a[f + hole] = a[f + child - 1]
                hole = child - 1
            parent = int((hole - 1) / 2)
            while hole > top and key[a[f + parent]] < key[value]:
                a[f + hole] = a[f + parent]
                hole = parent
                parent = int((hole - 1) / 2)
            a[f + hole] = value

        length = l - f
        parent = (length - 2) // 2
        while length >= 2:
            adjust(parent, length, a[f + parent])
            if parent == 0:
                break
            parent -= 1
        for last in range(length - 1, 0, -1):
            v = a[f + last]
            a[f + last] = a[f]
            adjust(0, last, v)

    def leaves(self):
        """A stable insertion inside each leaf, every leaf on its own."""
        idx, key = self.idx, self.key
        starts = np.flatnonzero(self.bits)
        ends = np.append(starts[1:], self.n)
        assert self.n == 0 or starts[0] == 0
        for p, e in zip(starts, ends):
            assert e - p <= THRESHOLD
            if self.broken == "unstable_leaves":
                seg = idx[p:e][::-1]
                idx[p:e] = seg[np.argsort(key[seg], kind="stable")]
                continue
            for i in range(p + 1, e):
                v = idx[i]
                j = i
                while j > p and key[idx[j - 1]] > key[v]:
                    idx[j] = idx[j - 1]
                    j -= 1
                idx[j] = v


# -- inputs -----------------------------------------------------------------

def mcilroy(n, solid=()):
    """Keys that drive the replica's quicksort into its depth limit
    (McIlroy, "A killer adversary for quicksort", 1999): every item starts
    as gas; a comparison of two gas items freezes one (the last candidate)
    at the next solid value; gas compares above every solid. `solid` items
    are frozen first, lowest."""
    val = [None] * n
    state = {"solid": 0, "candidate": -1}
    for i in solid:
        val[i] = state["solid"]
        state["solid"] += 1

    class Item:
        __slots__ = ("i",)

        def __init__(self, i):
            self.i = i

        def __lt__(self, other):
            x, y = self.i, other.i
            if val[x] is None and val[y] is None:
                z = x if x == state["candidate"] else y
                val[z] = state["solid"]
                state["solid"] += 1
            if val[x] is None:
                state["candidate"] = x
            elif val[y] is None:
                state["candidate"] = y
            gx = n if val[x] is None else val[x]
            gy = n if val[y] is None else val[y]
            return gx < gy

    r = Replica([Item(i) for i in range(n)])
    r.sort(list(range(n)))
    return np.asarray([n if v is None else v for v in val], np.int64)


def clustered_row(n=15000, seed=7):
    """A pivot's row at 15k reads: its own species' 100 reads near it, every
    other read near 9,700 with heavy ties (keys cover a few hundred
    values)."""
    rng = np.random.default_rng(seed)
    key = 9700 + rng.integers(-150, 150, size=n)
    own = rng.choice(n, 100, replace=False)
    key[own] = rng.integers(100, 900, size=100)
    return key


def case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name.startswith("n"):
        n = int(name[1:])
        return rng.permutation(n), rng.integers(0, 5, size=n)
    n = 3000
    perm = rng.permutation(n)
    if name == "equal":
        return perm, np.full(n, 4321)
    if name == "sorted":
        return np.arange(n), np.arange(n) // 3
    if name == "reverse":
        return np.arange(n), (n - np.arange(n)) // 2
    if name == "ties2":
        return perm, rng.integers(0, 2, size=n)
    if name == "ties10":
        return perm, rng.integers(0, 10, size=n)
    if name == "distinct":
        return perm, rng.permutation(n)
    if name == "organ":     # rises, then falls: spends the depth limit
        return np.arange(n), np.minimum(np.arange(n), n - np.arange(n))
    raise KeyError(name)


CASES = ["n1", "n2", "n16", "n17", "n33", "equal", "sorted", "reverse",
         "ties2", "ties10", "distinct", "organ"]
# the kernel's block and block ranges, and a small block with small block
# ranges (so that short rows take the block path too, chunks of several
# positions a thread)
SHAPES = {"kernel": (PO.THREADS, PO.LARGE), "small": (8, 40)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", CASES)
def test_model_equals_std_sort(name, shape):
    perm, key = case(name)
    threads, large = SHAPES[shape]
    for seed in range(2):
        m = Model(key, threads, large, seed=seed)
        got = m.run(perm)
        want, heaps = replica_sort(perm, key)
        np.testing.assert_array_equal(got, native_sort(perm, key))
        np.testing.assert_array_equal(got, want)
        assert m.heaps == heaps
        assert (heaps > 0) == (name == "organ")


def test_model_equals_std_sort_on_a_clustered_15k_row():
    key = clustered_row()
    perm = np.random.default_rng(3).permutation(key.shape[0])
    m = Model(key)
    got = m.run(perm)
    np.testing.assert_array_equal(got, native_sort(perm, key))
    assert m.heaps == 0 and m.partitions > 500


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_model_reaches_the_heap_path_as_std_sort(shape):
    """The adversary's keys spend the depth limit (2 x 10 at n = 2,000):
    the model takes the heap path as often as the replica, and the order
    is std::sort's."""
    n = 2000
    key = mcilroy(n)
    perm = np.arange(n)
    want, heaps = replica_sort(perm, key)
    assert heaps >= 1
    m = Model(key, *SHAPES[shape])
    got = m.run(perm)
    np.testing.assert_array_equal(got, native_sort(perm, key))
    np.testing.assert_array_equal(got, want)
    assert m.heaps == heaps


def test_adversary_with_a_solid_pivot_point():
    """The GPU test's adversary: point 0 (the pivot, key 0) frozen first."""
    key = mcilroy(600, solid=(0,))
    assert key[0] == 0 and (key[1:] > 0).all()
    _, heaps = replica_sort(np.arange(600), key)
    assert heaps >= 1


@pytest.mark.parametrize("broken", ["r_rule", "unstable_leaves"])
def test_broken_models_disagree(broken):
    perm, key = case("ties10")
    with pytest.raises(AssertionError):
        Model(key, 8, 40, broken=broken).run(perm)


def test_cpu_wrapper_is_the_host_chain():
    """ops/pivot_order.orders on a CPU PointSet: the host keys, then
    std::sort of the input order a row."""
    from meshclust_tpu_torch.core import points as P
    from meshclust_tpu_torch.io import fasta as fio
    rng = np.random.default_rng(5)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = rng.integers(0, 4, size=300)
    recs = []
    for i in range(80):
        seq = base.copy()
        seq[rng.random(300) < 0.1] = rng.integers(0, 4)
        recs.append(fio.encode_record(
            f">r{i}", letters[seq[: int(rng.integers(200, 301))]].tobytes()))
    ps = P.build_points(recs, 3, torch.device("cpu"))
    perm = rng.permutation(ps.n).astype(np.int32)
    rows = [0, 17, 79]
    got = PO.orders(ps, rows, torch.from_numpy(perm))
    assert got.dtype == torch.int32 and got.shape == (3, ps.n)
    keys = ps.distance_rows_device(np.asarray(rows, np.int64))
    for r in range(3):
        np.testing.assert_array_equal(got[r].numpy(),
                                      native_sort(perm, keys[r]))


def test_source_constants_match_the_wrapper():
    with open(SOURCE) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+);", src).group(1))

    assert const("kPoThreads") == PO.THREADS
    assert const("kThreshold") == PO.THRESHOLD == THRESHOLD
    assert const("kLarge") == PO.LARGE

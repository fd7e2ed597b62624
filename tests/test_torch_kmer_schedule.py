"""What the k-mer histogram kernel (meshclust_tpu_torch/csrc/kmer_hist.cu)
relies on, checked on the CPU through a numpy model of its work split.

The kernel runs only on a CUDA card. `kernel_model` replays its count loop
with the same index arithmetic and bit operations: each segment's 16-byte
blocks of the flat buffer go to one warp (rows mode) or in contiguous shares
to the warps of a cluster (split mode); a warp takes 32 blocks a step, one a
lane; a lane packs its 16 codes into one word (pack_codes), takes the word
of the block before its own (lane - 1's, or for lane 0 the previous step's
lane 31, or a load before the share's first block), reads the id of each
window out of the two words with one funnel shift and the mask, takes the
fast path when the whole block lies at or after the first counted window end
and inside the segment, and counts 1-mers by popcount. The model records
which window ends each lane counted, and asserts that every valid window
start is counted exactly once; its counts and 1-mer counts must equal
ops/histogram.py:kmer_hist_plain bit for bit. Copies whose ids do not reach
into the previous block, or with the segment end off by one, must fail.
Inputs come from numpy seeds, with records of odd lengths before each case
so that record offsets are not 16-byte aligned. Tolerance: exact equality.
"""
import collections
import os
import re

import numpy as np
import pytest
import torch

from meshclust_tpu_torch.ops import histogram as H

torch.set_num_threads(1)
BLOCK = H.BLOCK
# the model's small shape: warps of 4 lanes, 2 warps a CTA, 2 CTAs a cluster
SMALL = dict(lanes=4, warps=2, ctas=2)
OWN = dict(lanes=32, warps=H.WARPS, ctas=H.CLUSTER_CTAS)


MASK32 = 0xFFFFFFFF


def pack_codes(block):
    """csrc/kmer_hist.cu:pack_codes: per 4-byte word, the bytes reversed
    (__byte_perm(w, 0, 0x0123)), the low 2 bits of each kept and gathered
    into the top byte by one multiply mod 2^32; the four bytes make one
    word with code t at bits 30 - 2t."""
    m = (1 << 6) | (1 << 12) | (1 << 18) | (1 << 24)
    packed = 0
    for w in range(4):
        rev = int.from_bytes(bytes(block[4 * w: 4 * w + 4])[::-1], "little")
        top = (((rev & 0x03030303) * m) & MASK32) >> 24
        packed |= top << (24 - 8 * w)
    return packed


def popcount_ones(cur, inseg):
    """The kernel's 1-mer counts of a packed block: codes 1 and 3 have the
    low bit, 2 and 3 the high bit."""
    low = 0x55555555 & inseg
    b0 = bin(cur & low).count("1")
    b1 = bin((cur >> 1) & low).count("1")
    both = bin(cur & (cur >> 1) & low).count("1")
    return (bin(low).count("1") - b0 - b1 + both, b0 - both, b1 - both,
            both)


def kernel_model(codes, rec_off, segs, seg_off, k, split, lanes, warps,
                 ctas, halo=True, end_slip=0):
    """(counts [N, 4^k] without init, ones [N, 4], Counter of counted
    (record, window end)) by the kernel's schedule and arithmetic.
    halo=False (ids that do not reach into the previous block) and
    `end_slip`, which moves every segment's end, make the broken copies."""
    n = rec_off.shape[0] - 1
    V = 4 ** k
    mask = V - 1
    split = split and k <= H.MAX_SHARED_K
    blocks = codes.reshape(-1, BLOCK)
    zero = np.zeros(BLOCK, np.uint8)
    counts = np.zeros((n, V), np.int64)
    ones = np.zeros((n, 4), np.int64)
    seen = collections.Counter()

    def span(r, a0, a1, A, B):
        lo = A + k - 1
        carry = blocks[a0 - 1] if a0 > 0 else zero
        for base in range(a0, a1, lanes):
            cur = [blocks[j] if j < a1 else zero
                   for j in range(base, base + lanes)]
            prev = [carry] + cur[:-1]
            carry = cur[-1]
            step(r, base, a1, prev, cur, A, B, lo)

    def step(r, base, a1, prev, cur, A, B, lo):
        for lane in range(lanes):
            j = base + lane
            if j >= a1:
                continue
            pc = pack_codes(cur[lane])
            pp = pack_codes(prev[lane]) if halo else 0
            p0 = j * BLOCK
            if p0 >= lo and p0 + BLOCK - 1 <= B:
                inseg, ends = MASK32, range(BLOCK)
            else:
                first, last = max(0, A - p0), min(BLOCK - 1, B - p0)
                inseg = (MASK32 >> (2 * first)) \
                    & (MASK32 << (2 * (BLOCK - 1 - last))) & MASK32
                ends = range(max(first, lo - p0), last + 1)
            for t in ends:
                ident = (((pp << 32) | pc) >> (30 - 2 * t)) & mask
                counts[r, ident] += 1
                seen[(r, p0 + t)] += 1
            for c, n_c in enumerate(popcount_ones(pc, inseg)):
                ones[r, c] += n_c

    for r in range(n):
        for s in range(seg_off[r], seg_off[r + 1]):
            A = int(rec_off[r] + segs[s, 0])
            B = int(rec_off[r] + segs[s, 1]) + end_slip
            j0, j1 = A // BLOCK, B // BLOCK + 1
            if split:
                team = ctas * warps
                share = -(-(j1 - j0) // team)
                for tw in range(team):
                    a0 = j0 + tw * share
                    a1 = min(a0 + share, j1)
                    if a0 < a1:
                        span(r, a0, a1, A, B)
            else:
                span(r, j0, j1, A, B)
    return counts, ones, seen


def corpus(seed, lengths, lead=0):
    """Records of the given lengths after `lead` records of 1-15 bp (which
    shift every offset off the 16-byte grid). Each record is one segment,
    except where a length is a list of (a, b) segments over a record of
    length b_last + 1 + tail: there the gaps hold N (78) and segment
    boundaries may touch, as chunking leaves them."""
    rng = np.random.default_rng(seed)
    recs = [(int(rng.integers(1, 16)), None) for _ in range(lead)]
    for L in lengths:
        if isinstance(L, list):
            recs.append((L[-1][1] + 1 + int(rng.integers(0, 5)), L))
        else:
            recs.append((L, None))
    parts, seg_list, rec_off, seg_off = [], [], [0], [0]
    for L, sg in recs:
        c = rng.integers(0, 4, size=L).astype(np.uint8)
        if sg is None:
            sg = [(0, L - 1)] if L >= 20 else []
        else:
            inside = np.zeros(L, bool)
            for a, b in sg:
                inside[a: b + 1] = True
            c[~inside] = 78
        parts.append(c)
        seg_list += sg
        rec_off.append(rec_off[-1] + L)
        seg_off.append(seg_off[-1] + len(sg))
    total = rec_off[-1]
    codes = np.zeros(H.round_up(max(total, 1), BLOCK), np.uint8)
    codes[:total] = np.concatenate(parts)
    return (codes, np.asarray(rec_off, np.int64),
            np.asarray(seg_list, np.int64).reshape(-1, 2),
            np.asarray(seg_off, np.int64))


def valid_ends(rec_off, segs, seg_off, k):
    want = set()
    for r in range(rec_off.shape[0] - 1):
        for s in range(seg_off[r], seg_off[r + 1]):
            A = int(rec_off[r] + segs[s, 0])
            B = int(rec_off[r] + segs[s, 1])
            want.update((r, e) for e in range(A + k - 1, B + 1))
    return want


def check(inputs, k, split, **shape):
    counts, ones, seen = kernel_model(*inputs, k, split, **shape)
    assert set(seen) == valid_ends(*inputs[1:], k)
    assert max(seen.values(), default=1) == 1
    want = H.kmer_hist_plain(*(torch.from_numpy(a) for a in inputs), k,
                             init=0)
    np.testing.assert_array_equal(counts, want[0].numpy())
    np.testing.assert_array_equal(ones, want[1].numpy())


def edge_lengths(lanes, warps, ctas):
    """Lengths at the block (R = 16 bases), step (lanes x R) and split
    share edges, plus records under k and under 20 bp."""
    R = BLOCK
    W = lanes * R
    team = warps * ctas * R
    out = [1, 5, 19, 20, 21, R - 1, R, R + 1, 2 * R + 1, W - 1, W, W + 1,
           2 * W + 3, team - 1, team, team + 1, 3 * team + 7]
    return sorted(set(out))


@pytest.mark.parametrize("split", [False, True], ids=["rows", "split"])
@pytest.mark.parametrize("k", [1, 4, 6, 7, 8, 10])
def test_every_start_once_at_edges_small_shape(k, split):
    lens = edge_lengths(**SMALL)
    for lead in (0, 3):
        check(corpus(k + lead, lens, lead=lead), k, split, **SMALL)


@pytest.mark.parametrize("split", [False, True], ids=["rows", "split"])
@pytest.mark.parametrize("k", [3, 4, 6])
def test_every_start_once_at_the_kernels_own_shape(k, split):
    lens = [BLOCK * 32 - 1, BLOCK * 32 + 1, 1000, 2100, 4100]
    if split:   # shares of a cluster's 32 warps: edges of 32-block shares
        team = H.WARPS * H.CLUSTER_CTAS * BLOCK
        lens += [team - 1, team + 1, 10 * team + 5]
    check(corpus(50 + k, lens, lead=5), k, split, **OWN)


@pytest.mark.parametrize("split", [False, True], ids=["rows", "split"])
def test_segment_resets(split):
    """N runs that split a record into segments, segments that touch (a
    chunk boundary), segments shorter than k, and a record with no
    segment at all."""
    lens = [[(0, 30), (40, 90)], [(0, 49), (50, 99), (100, 180)],
            [(3, 5), (20, 60), (64, 66)], [(17, 17)], 12, [(0, 15), (16, 31)],
            [(5, 200), (215, 500)]]
    for k in (1, 4, 6, 9):
        check(corpus(k, lens, lead=1), k, split, **SMALL)


@pytest.mark.parametrize("shape", [SMALL, OWN], ids=["small", "own"])
def test_random_corpora(shape):
    rng = np.random.default_rng(9)
    lens = [int(x) for x in rng.integers(1, 700, size=12)]
    for k in (2, 5, 7):
        for split in (False, True):
            check(corpus(k, lens, lead=2), k, split, **shape)


@pytest.mark.parametrize("broken", [dict(halo=False), dict(end_slip=1),
                                    dict(end_slip=-1)],
                         ids=["no_halo", "end_plus_one", "end_minus_one"])
def test_broken_copies_fail(broken):
    inputs = corpus(3, [[(0, 40), (50, 120)], 300, 61], lead=3)
    with pytest.raises(AssertionError):
        counts, ones, seen = kernel_model(*inputs, 4, False, **SMALL,
                                          **broken)
        assert set(seen) == valid_ends(*inputs[1:], 4)
        want = H.kmer_hist_plain(*(torch.from_numpy(a) for a in inputs), 4,
                                 init=0)
        np.testing.assert_array_equal(counts, want[0].numpy())
        np.testing.assert_array_equal(ones, want[1].numpy())


def test_constants_match_the_source():
    path = os.path.join(os.path.dirname(H.__file__), os.pardir, "csrc",
                        "kmer_hist.cu")
    with open(path) as f:
        src = f.read()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert constant("kBlock") == H.BLOCK == 16
    assert constant("kWarps") == H.WARPS
    assert constant("kClusterCtas") == H.CLUSTER_CTAS
    assert constant("kMaxSharedK") == H.MAX_SHARED_K
    # the ids reach into the whole previous block (the model's halo)
    assert "__funnelshift_r(cur, prev, 30 - 2 * t)" in src
    assert H.MAX_K < BLOCK

"""What the NW kernel (meshclust_tpu_torch/csrc/nw_align_long.cu) relies on,
checked on the CPU through a numpy model of its schedule.

The kernel runs only on a CUDA card. `kernel_model` replays its loop step by
step with the same index arithmetic, at a small shape (T threads, R rows a
thread, warps of WS lanes, a barrier every K steps): row 0's messages
travel the kernel's three channels (the lane shuffle, the ring of
shared-memory slots between warps, the double-buffered chunk of the row
above the strip, which the strip's last row writes to the boundary row), and
each message and carried state is tagged with the cell it came from. The
model asserts that every cell is computed once, from its own three
neighbours, and that every cross-warp read has a barrier after its write and
before the slot's next write. Its recurrence is the kernel's: max with a
(a >= b) predicate (DPX __vibmax_s32) for the tie-breaks, the best of
(i - 1, j - 1)'s states carried to M(i, j), and in place of the path length
and the match count, the diagonal-step count D and the sum X of the
substitution scores (length l1 + l2 - D, matches (X - D * mismatch) /
(match - mismatch)). Its results must equal ops/align.py:
align_counts_plain and the JAX package's meshclust_tpu/ops/align.py:
batch_align bit for bit. Inputs come from numpy seeds. Tolerance: exact
equality (integer DP).
"""
import os
import re

import numpy as np
import pytest
import torch

from meshclust_tpu_torch.ops import align as A
from meshclust_tpu_torch.ops import align_device as AD

torch.set_num_threads(1)
MATCH, MISMATCH, GO, GC = 1, -1, 2, 1
T, R, WS, K = 4, 3, 2, 2   # the model's small shape: 2 warps of 2 lanes
EDGES = [1, R - 1, R, R + 1, R * T - 1, R * T, R * T + 1, 2 * R * T + 1]


def vibmax(a, b):
    """__vibmax_s32: (max(a, b), a >= b)."""
    return (a, True) if a >= b else (b, False)


def boundary(i, j, neg):
    if i == 0:
        m, ug, lg = (0 if j == 0 else neg), -GO - j * GC, neg
    else:
        m, ug, lg = neg, neg, -GO - i * GC
    return {"m": (m, 0, 0), "ug": (ug, 0, 0), "lg": (lg, 0, 0), "at": (i, j)}


def gap_from(c, g):
    s, begin = vibmax(c["m"][0] - GO - GC, c[g][0] - GC)
    src = c["m"] if begin else c[g]
    return (s, src[1], src[2])


def best(c):
    x, m_ge_lg = vibmax(c["m"][0], c["lg"][0])
    s, first_ge_ug = vibmax(x, c["ug"][0])
    src = (c["m"] if m_ge_lg else c["lg"]) if first_ge_ug else c["ug"]
    return (s, src[1], src[2])


def message(c):
    return {"lg": gap_from(c, "lg"), "best": best(c), "at": c["at"]}


def kernel_model(a, b, T=T, R=R, WS=WS, K=K):
    """(alignment length, matches) of the pair (a, b) by the kernel's
    schedule; asserts the schedule's invariants on the way."""
    l1, l2 = len(a), len(b)
    strip, lag, nring, warps = R * T, K - 1, 2 * K, T // WS
    neg = MISMATCH * min(l1, l2) - 1 - (GO + abs(l1 - l2) * GC
                                        if l1 != l2 else 0)
    done = {}                     # (i, j) -> clock of its computation
    barriers = []                 # clocks after which the CTA synchronised
    bnd = {}                      # column -> (cell, clock written)
    ring = {}                     # (slot, warp) -> (message, clock written)
    ring_read = {}                # (slot, warp) -> clock of its last use
    top = {}                      # (buffer, x) -> (message, clock written)
    top_read = {}                 # (buffer, x) -> clock of thread 0's read
    loaded = {}                   # column -> clock its top message loaded
    out = None
    clock = 0

    def synced(lo, hi):
        """A barrier ran after some clock x with lo <= x < hi."""
        return any(lo <= x < hi for x in barriers)

    def load_top(c, r0, now):
        for t in range(T):
            col = c * T + 1 + t
            if col > l2:
                continue
            if r0 == 0:
                x = boundary(0, col, neg)
            else:
                x, wrote = bnd[col]
                assert x["at"] == (r0, col) and synced(wrote, now)
            key = (c % 2, t)
            if key in top_read:          # thread 0 read the old chunk
                assert synced(top_read[key], now)
            top[key] = (message(x), now)
            loaded[col] = now

    for r0 in range(0, l1, strip):
        nrows = min(strip, l1 - r0)
        writes_row = r0 + strip < l1
        ar, bq, cell, prev = {}, {}, {}, {}
        for t in range(T):
            for r in range(R):
                i = r0 + R * t + r + 1
                ar[t, r] = a[i - 1] if R * t + r < nrows else -1
                bq[t, r] = -2
                cell[t, r] = boundary(i, 0, neg)
                prev[t, r] = best(boundary(i - 1, 0, neg)) + ((i - 1, 0),)
        base = [R * t + lag * (t // WS) for t in range(T)]
        bnext = [b[min(max(-base[t], 0), l2 - 1)] for t in range(T)]
        incoming = [None] * T
        clock += 1
        load_top(0, r0, clock)
        barriers.append(clock)
        tl = (nrows - 1) // R
        nsteps = l2 + nrows - 1 + lag * (tl // WS)
        for g in range(1, nsteps + 1):
            clock += 1
            used_ring = {}
            for t in range(T):
                lane, warp = t % WS, t // WS
                if t == 0:
                    if g <= l2:
                        key = (((g - 1) // T) % 2, (g - 1) % T)
                        msg, wrote = top[key]
                        assert synced(wrote, clock)
                        top_read[key] = clock
                        incoming[t] = msg
                elif lane == 0:
                    slot = ((g - K) % nring, warp - 1)
                    if slot in ring:
                        incoming[t] = ring[slot][0]
                        used_ring[t] = (slot, ring[slot][1])
                for r in range(R - 1, 0, -1):
                    bq[t, r] = bq[t, r - 1]
                bq[t, 0] = bnext[t]
                bnext[t] = b[min(max(g - base[t], 0), l2 - 1)]
                j0 = g - base[t]
                fast = (R * t + R <= nrows and j0 - (R - 1) >= 1
                        and j0 <= l2)
                for r in range(R - 1, -1, -1):
                    j = j0 - r
                    ok = R * t + r < nrows and 1 <= j <= l2
                    assert ok or not fast
                    if not ok:
                        continue
                    i = r0 + R * t + r + 1
                    msg = message(cell[t, r - 1]) if r > 0 else incoming[t]
                    if r == 0 and t > 0 and lane == 0:
                        slot, wrote = used_ring[t]
                        assert synced(wrote, clock)   # the write is visible
                        ring_read[slot] = clock
                    left, pv = cell[t, r], prev[t, r]
                    assert left["at"] == (i, j - 1)
                    assert msg["at"] == (i - 1, j)
                    assert pv[3] == (i - 1, j - 1)
                    assert (i, j) not in done
                    assert ar[t, r] == a[i - 1] and bq[t, r] == b[j - 1]
                    sc = MATCH if ar[t, r] == bq[t, r] else MISMATCH
                    cell[t, r] = {
                        "ug": gap_from(left, "ug"), "lg": msg["lg"],
                        "m": (pv[0] + sc, pv[1] + 1, pv[2] + sc),
                        "at": (i, j)}
                    prev[t, r] = msg["best"] + ((i - 1, j),)
                    done[i, j] = clock
                jl = j0 - (R - 1)
                if writes_row and t == T - 1 and 1 <= jl <= l2:
                    assert synced(loaded[jl], clock)  # row r0 read first
                    bnd[jl] = (cell[t, R - 1], clock)
            outs = [message(cell[t, R - 1]) for t in range(T)]
            for t in range(T):
                if t % WS == WS - 1 and t // WS + 1 < warps:
                    slot = (g % nring, t // WS)
                    if slot in ring_read:   # the consumer read it first
                        assert synced(ring_read[slot], clock)
                    ring[slot] = (outs[t], clock)
                if t % WS > 0:
                    incoming[t] = outs[t - 1]
            if (g - 1) % T == 0:
                load_top((g - 1) // T + 1, r0, clock)
            if g % K == 0:
                barriers.append(clock)
        if not writes_row:
            q = nrows - 1
            c = cell[q // R, q % R]
            assert c["at"] == (l1, l2)
            s, d, x = best(c)
            out = (l1 + l2 - d, (x - d * MISMATCH) // (MATCH - MISMATCH))
        barriers.append(clock)
    assert len(done) == l1 * l2
    return out


def _codes(rng, n):
    c = rng.integers(0, 4, size=n).astype(np.int8)
    c[rng.random(n) < 0.05] = 78
    return c


def _related(rng, a, n):
    """b of length n: a's first bases with 15% substitutions, then random."""
    b = _codes(rng, n)
    m = min(len(a), n)
    b[:m] = np.where(rng.random(m) < 0.15, b[:m], a[:m])
    return b


def _plain(pairs):
    seqs = [c for p in pairs for c in p]
    lpad = max(len(c) for c in seqs)
    mat = np.zeros((len(seqs), lpad), np.int8)
    for i, c in enumerate(seqs):
        mat[i, : len(c)] = c
    lens = torch.tensor([len(c) for c in seqs], dtype=torch.int32)
    ia = torch.arange(0, len(seqs), 2, dtype=torch.int32)
    alen, amatch = A.align_counts_plain(torch.from_numpy(mat), lens, ia,
                                        ia + 1)
    return list(zip(alen.tolist(), amatch.tolist()))


def _jax(pairs):
    import jax.numpy as jnp
    from meshclust_tpu.ops import align as JA
    ba = max(len(x) for x, _ in pairs)
    bb = max(len(y) for _, y in pairs)
    s1 = np.zeros((len(pairs), ba), np.uint8)
    s2 = np.zeros((len(pairs), bb), np.uint8)
    for p, (x, y) in enumerate(pairs):
        s1[p, : len(x)] = x
        s2[p, : len(y)] = y
    l1 = np.asarray([len(x) for x, _ in pairs], np.int32)
    l2 = np.asarray([len(y) for _, y in pairs], np.int32)
    _, alen, amatch = JA.batch_align(
        jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(l1), jnp.asarray(l2),
        R=ba + 1, D=ba + bb + 1)[:3]
    return list(zip(np.asarray(alen).tolist(), np.asarray(amatch).tolist()))


def _check(pairs, **shape):
    got = [kernel_model(x, y, **shape) for x, y in pairs]
    assert got == _plain(pairs)
    assert got == _jax(pairs)


@pytest.mark.parametrize("length", EDGES)
def test_model_at_strip_and_thread_edges(length):
    """l1 and l2 at 1, R - 1, R, R + 1, R*T - 1, R*T, R*T + 1, 2*R*T + 1,
    each against every edge length and two random ones, both ways round."""
    rng = np.random.default_rng(100 + length)
    pairs = []
    for other in EDGES + [int(x) for x in rng.integers(1, 40, size=2)]:
        x = _codes(rng, length)
        pairs.append((x, _related(rng, x, other)))
        y = _codes(rng, other)
        pairs.append((_related(rng, y, length), y))
    _check(pairs)


@pytest.mark.parametrize("seed", range(4))
def test_model_on_random_pairs(seed):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(10):
        x = _codes(rng, int(rng.integers(1, 60)))
        n = int(rng.integers(1, 60))
        pairs.append((x, _related(rng, x, n) if rng.random() < 0.6
                      else _codes(rng, n)))
    _check(pairs)


@pytest.mark.parametrize("shape", [
    dict(T=4, R=3, WS=2, K=1),    # a barrier every step, no warp lag
    dict(T=8, R=2, WS=4, K=4),    # four-lane warps, lag 3
    dict(T=4, R=1, WS=4, K=4),    # one row a thread, one warp
], ids=["K1", "WS4_K4", "R1"])
def test_model_other_shapes(shape):
    rng = np.random.default_rng(7)
    strip = shape["T"] * shape["R"]
    lens = [1, strip - 1, strip, strip + 1, 2 * strip + 1, 17, 30]
    pairs = []
    for n in lens:
        x = _codes(rng, n)
        pairs.append((x, _related(rng, x, int(rng.integers(1, 30)))))
        pairs.append((_codes(rng, int(rng.integers(1, 30))), x))
    _check(pairs, **shape)


def test_model_at_the_kernels_own_shape():
    """The shape the kernel is built with (warps of 32 lanes), at a warp
    edge: l1 = 32 * R + 1 rows cross from warp 0 into warp 1."""
    R0, T0, K0 = AD.ROWS_PER_THREAD, AD.THREADS_PER_PAIR, AD.SYNC_STEPS
    rng = np.random.default_rng(3)
    x = _codes(rng, 32 * R0 + 1)
    pairs = [(x, _related(rng, x, 6)), (_codes(rng, 5), _codes(rng, 2))]
    got = [kernel_model(p, q, T=T0, R=R0, WS=32, K=K0) for p, q in pairs]
    assert got == _plain(pairs)


def test_strip_constants_match_the_source():
    path = os.path.join(os.path.dirname(AD.__file__), os.pardir, "csrc",
                        "nw_align_long.cu")
    with open(path) as f:
        src = f.read()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert constant("kR") == AD.ROWS_PER_THREAD
    assert constant("kT") == AD.THREADS_PER_PAIR
    assert constant("kK") == AD.SYNC_STEPS
    assert AD.STRIP_ROWS == AD.ROWS_PER_THREAD * AD.THREADS_PER_PAIR
    assert "constexpr int kStrip = kR * kT;" in src

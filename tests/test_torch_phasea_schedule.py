"""What the Phase A kernels (meshclust_tpu_torch/csrc/phase_a.cu) rely on,
checked on the CPU through a numpy model of their decomposition.

The kernels run only on a CUDA card. The model below replays each one with
its grid (blocks of threads walking a slot range, grid-strided; warps of
lanes striding over the V counts), its reductions (each thread's own
slots, then its block, then the blocks' atomics or partials combined by
the last block, here in a random block order) and its tie rules:
  pa_window       one block, a warp a query: the first or last live slot
                  of a slot range named by the center's row of the table
                  (core/accumulate_device.window_ranges), read as 16-byte
                  vectors of flags a step (the byte-to-bit packing, the
                  ends read byte by byte, ballot and __ffs / __clz), the
                  first and last live slots scanned on from st[LIVE] and
                  st[TAIL], and the truncation quirk's second query;
  pa_sums         a warp a live slot of [w0, w1]; no other row is read;
  pa_absorb       the float64 classifier read from ops/classifier.Model's
                  packed arrays in the kernel's order, the first max of f1
                  as (max, least slot) with NaN making it N, positives'
                  rows added into sumvec;
  pa_move         tiles of owners compacted into member lists (ballots,
                  warps in a random order), the floored mean once a block
                  and chunk of V, members in lane groups over pieces; only
                  the members' rows (owner == c) are read; each busy block's
                  least (d, stamp, slot) a partial at an index it drew,
                  combined by the block whose members complete st[COUNT],
                  the blocks' draws and adds on one counter interleaved in
                  a random order, no other block drawing or writing
                  anything;
  pa_next         one block: the center's slot recorded where nothing was
                  absorbed, the next seed (the best, else the first live
                  slot) or the done flag, the stamp and iteration counters
                  in st, the seed's row written into sumvec.
The center's id and the absorb's stamp are read from st, as the kernels
read them. The model is held equal, step by step and iteration by
iteration, to the plain steps of core/accumulate_device._Slots' chain
(every step after the done flag a no-op), on the edge
corpora of tests/test_torch_accumulate.py (--id 0.60 and 0.97 at their
window-limit edges, 0.90 on species corpora), with duplicate rows planted
so that f1 and d tie, with empty windows and with a lone read whose length
window holds only itself; a copy of the model with either tie rule turned
around must disagree. The move is held to move_plain also on members
planted in several tiles whose d ties, on a lone member, and at a wrong
member count, which the model refuses. The whole phase's centers are held equal to the JAX
package's accumulate_device. Tolerance: exact equality.
"""
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from meshclust_tpu_torch.core import accumulate_device as A
from meshclust_tpu_torch.ops import classifier as CL
from meshclust_tpu_torch.ops import features as F
from meshclust_tpu_torch.ops import phase_a as P
from tests.test_torch_accumulate import (CORPORA, edge_points, jax_points,
                                         listed, port_bv, port_case, shifted)
from tests.test_torch_device_backend import toy_model, toy_points

torch.set_num_threads(1)
os.environ.setdefault("MESHCLUST_QUIET", "1")
# grid shapes: the kernels' own, and a small one whose blocks each see many
# slots (blocks, threads a block, lanes a warp); pa_sums's blocks: on the
# card SMs x resident blocks (an H100 SXM's 132 x 8 here); pa_window's
# vectors a lane has in flight; pa_move's owner loads a thread and bytes of
# the mean a chunk
OWN = dict(blocks=P.BLOCKS, threads=P.THREADS, lanes=32,
           sums_blocks=132 * 8, win_loads=P.WINDOW_LOADS,
           owner_loads=P.OWNER_LOADS, cw_bytes=P.CW_BYTES)
SMALL = dict(blocks=3, threads=8, lanes=4, sums_blocks=3, win_loads=1,
             owner_loads=1, cw_bytes=16)
SOURCE = os.path.join(os.path.dirname(A.__file__), "..", "csrc", "phase_a.cu")
# The header phase_a.cu includes: its block size, pieces and classifier.
HEADER = os.path.join(os.path.dirname(SOURCE), "common.cuh")


# -- the model -----------------------------------------------------------------

def grid_owner(start: int, stop: int, blocks: int, per_block: int) -> dict:
    """{block: [units in the order its workers take them]}: units start,
    start + 1, ... < stop grid-strided over blocks * per_block workers
    (threads or warps), worker w of block b taking start + b * per_block +
    w + k * blocks * per_block."""
    out = {}
    width = blocks * per_block
    for u in range(start, stop):
        b = ((u - start) % width) // per_block
        out.setdefault(b, []).append(u)
    return out


def combine(parts: list, op, rng):
    """Partials combined in a random block order (the last block's, or the
    atomics' order, is not fixed)."""
    out = None
    for i in rng.permutation(len(parts)):
        out = parts[i] if out is None else op(out, parts[i])
    return out


def f1_op(a, b, least_slot=True):
    """(f1, slot, nan): the greater f1, the least slot among equal f1 (or,
    for the broken copy, the greatest)."""
    tie = (b[1] < a[1]) if least_slot else (b[1] > a[1])
    pick = b if (b[0] > a[0] or (b[0] == a[0] and tie)) else a
    return (pick[0], pick[1], a[2] or b[2])


def d_op(a, b, stamp_first=True):
    """(d, stamp, slot): the least d, then stamp, then slot (or, for the
    broken copy, slot alone)."""
    ka = (a[0], a[1], a[2]) if stamp_first else (a[0], a[2])
    kb = (b[0], b[1], b[2]) if stamp_first else (b[0], b[2])
    return b if kb < ka else a


def live_bits(act, s0, a, b, mis):
    """csrc/phase_a.cu:live_bits -> (bits, slots read): bit i where slot
    s0 + i is live and lies in [a, b); s0 starts a 16-byte-aligned vector
    (mis: the flags' address mod 16), read whole where it lies in [0, n),
    else byte by byte where it does; each word's nonzero bytes packed into
    4 bits by the mask and multiply of the kernel."""
    n = act.shape[0]
    if s0 >= b or s0 + 16 <= a:
        return 0, []
    assert (s0 + mis) % 16 == 0
    read = [x for x in range(s0, s0 + 16) if 0 <= x < n]
    raw = np.zeros(16, np.uint8)
    raw[[x - s0 for x in read]] = act[read]
    bits = 0
    for k, w in enumerate(raw.view("<u4").tolist()):
        ne = sum(0xff << (8 * e) for e in range(4) if (w >> (8 * e)) & 0xff)
        bits |= (((ne & 0x08040201) * 0x01010101) & 0xffffffff) >> 24 \
            << (4 * k)
    lo, hi = a - s0, b - s0
    if lo > 0:
        bits &= 0xffff << lo
    if hi < 16:
        bits &= (1 << hi) - 1
    return bits, read


def scan_live(act, a, b, mis, grid, forward, reads):
    """first_live (forward) or last_live of csrc/phase_a.cu: the first or
    last live slot of [a, b), -1 if none, a warp of grid["lanes"] lanes
    reading grid["win_loads"] vectors a lane a step and stopping at the
    first step with a live flag; the slots it reads go into reads."""
    L, U = grid["lanes"], grid["win_loads"]
    a, b = int(a), int(b)
    if a >= b:
        return -1
    base = (a if forward else b - 1)
    base -= (base + mis) % 16
    while (base < b) if forward else (base + 16 > a):
        for u in range(U):
            got = []
            for lane in range(L):
                s0 = base + 16 * (u * L + lane) * (1 if forward else -1)
                bits, read = live_bits(act, s0, a, b, mis)
                reads.update(read)
                got.append((s0, bits))
            hits = [(s0, bits) for s0, bits in got if bits]
            if hits:                            # the least lane
                s0, bits = hits[0]
                i = ((bits & -bits).bit_length() - 1) if forward \
                    else bits.bit_length() - 1
                return s0 + i
        base += 16 * L * U * (1 if forward else -1)
    return -1


def model_window(st, act, ranges, grid, mis=0):
    """pa_window on the flags act (numpy bool [N]) and its table; -> the
    slots whose flags it read. The scans for the first and last live slots
    start at st[LIVE] and st[TAIL], which no live slot may precede or
    follow."""
    N = act.shape[0]
    live0, tail0 = int(st[P.LIVE]), int(st[P.TAIL])
    assert not act[:live0].any() and not act[tail0 + 1:].any()
    reads = set()
    row = ranges[st[P.LAST]].astype(np.int64)

    def q(a, b, forward):
        return scan_live(act, a, b, mis, grid, forward, reads)

    found = [q(live0, N, True), q(0, tail0 + 1, False),
             q(row[P.GE], row[P.FRONT_END], True),
             q(row[P.FRONT], row[P.GE], False),
             q(row[P.EQ], row[P.GT], False),
             q(row[P.GT], row[P.BACK_END], True),
             q(row[P.BACK], row[P.EQ], False)]
    assert len(found) == P.WINDOW_WARPS
    first = N if found[0] < 0 else found[0]
    tail = found[1]
    w0 = next((x for x in (found[2], found[3]) if x >= 0), first)
    w1 = next((x for x in found[4:] if x >= 0), -1)
    if w1 < 0 and tail >= 0:                    # the truncation quirk
        w1 = q(int(ranges[tail, P.BIN]), tail + 1, True)
    st[P.W0], st[P.W1], st[P.LIVE], st[P.TAIL] = w0, w1, first, tail
    assert all(0 <= x < N for x in reads)
    return reads


def piece_bytes(addr: int, pitch: int, length: int, width: int) -> int:
    """mc_pa_sums's piece: the widest of PIECE_BYTES, 8, 4, 2 and 1 bytes,
    at least the element, that divides the rows' address, pitch and length
    in bytes."""
    vec = P.PIECE_BYTES
    while vec > width and (addr | pitch | length) % vec:
        vec //= 2
    return vec


def piece_sums(a, b):
    """(man, dot) of each piece of a against b ([pieces, elements] of one
    storage dtype) as the kernel's add_piece takes them: int8 pieces of 4
    or more bytes word by word, |a - b| as __vsadu4 of the counts biased to
    unsigned (x ^ 0x80) and a * b as __dp4a's signed bytes."""
    if a.dtype == np.int8 and a.shape[1] >= 4:
        au = (a.view(np.uint8) ^ 0x80).astype(np.int64)
        bu = (b.view(np.uint8) ^ 0x80).astype(np.int64)
        man = np.abs(au - bu).reshape(a.shape[0], -1, 4).sum((1, 2))
    else:
        man = np.abs(a.astype(np.int64) - b.astype(np.int64)).sum(1)
    dot = (a.astype(np.int64) * b.astype(np.int64)).sum(1)
    return man, dot


def fits_int32(*xs) -> bool:
    return all(-2 ** 31 <= int(x) < 2 ** 31 for x in xs)


def model_sums(st, s, shards, out, with_dot, grid):
    """pa_sums over shards (consecutive column slices of one [N, V] array
    on a 16-byte boundary, each a launch on its slice; their partials
    summed):
    a shard's rows are read in pieces of piece_bytes of the slice's
    address, pitch and length. Short rows (pieces <= the warp's lanes): a
    group of `lanes` lanes a row, lane `sub` its piece sub, the warp's
    groups and SUMS_UNROLL loads a batch of consecutive rows, batches
    grid-strided over the warps; long rows: a warp a row, lane l its
    pieces l, l + W, ..., summed SUMS_UNROLL at a time. int8 partials must
    fit 32 bits where the kernel keeps them in 32. Returns the slots whose
    rows it read."""
    N = s["active"].shape[0]
    w0, w1, last = st[P.W0], st[P.W1], st[P.LAST]
    W = grid["lanes"]
    warps = grid["sums_blocks"] * grid["threads"] // W
    width = shards[0].dtype.itemsize
    pitch = sum(h.shape[1] for h in shards) * width
    totals = {}
    col0 = 0
    for h in shards:
        vl = h.shape[1]
        vec = piece_bytes(col0 * width, pitch, vl * width, width)
        nv, E = vl * width // vec, vec // width
        assert nv * vec == vl * width and vec >= width
        lanes = 1
        while lanes < nv and lanes < W:
            lanes *= 2
        a = h[last].reshape(nv, E)
        narrow = h.dtype == np.int8

        def row(x):
            return piece_sums(a, h[x].reshape(nv, E))

        if nv <= lanes:
            groups = W // lanes
            step = groups * P.SUMS_UNROLL
            batches = -(-(w1 - w0 + 1) // step) if w1 >= w0 else 0
            for warp in range(min(warps, batches)):
                for s0 in range(w0 + warp * step, w1 + 1, warps * step):
                    for u in range(P.SUMS_UNROLL):
                        for grp in range(groups):
                            x = s0 + u * groups + grp
                            if x > w1 or not s["active"][x]:
                                continue
                            man, dot = row(x)     # lane sub: piece sub
                            if narrow:
                                assert fits_int32(man.sum(), dot.sum())
                            t = totals.setdefault(x, [0, 0, 0])
                            t[0] += int(man.sum())
                            t[1] += int(dot.sum())
                            t[2] += 1
        else:
            for warp in range(min(warps, max(0, w1 - w0 + 1))):
                for x in range(w0 + warp, w1 + 1, warps):
                    if not s["active"][x]:
                        continue
                    man, dot = row(x)
                    lane_man = lane_dot = 0
                    span = W * P.SUMS_UNROLL
                    for lane in range(W):
                        for v0 in range(lane, nv, span):
                            ps_ = list(range(v0, min(nv, v0 + span), W))
                            if narrow:
                                assert fits_int32(man[ps_].sum(),
                                                  dot[ps_].sum())
                            lane_man += int(man[ps_].sum())
                            lane_dot += int(dot[ps_].sum())
                    t = totals.setdefault(x, [0, 0, 0])
                    t[0] += lane_man
                    t[1] += lane_dot
                    t[2] += 1
        col0 += vl
    out[:, :] = -7                      # the kernel leaves other slots be
    for x, (man, dot, visits) in totals.items():
        assert visits == len(shards)    # each row once a shard
        out[0, x] = man
        if with_dot:
            out[1, x] = dot
    read = sorted(totals)
    assert all(w0 <= x <= w1 for x in read)
    return read


def classify(spec, coef, man, dot, mag_a, mag_b, sq_a, sq_b, len_a, len_b):
    """csrc/phase_a.cu:classify in numpy float64 scalars (IEEE, no FMA),
    reading Model's packed arrays as the kernel does: each single flag of
    the model once, then each single normalized, then the combos."""
    f8 = np.float64
    S, J = int(spec[0]), int(spec[1])
    assert S <= CL.MAX_SINGLES
    singles, is_sim = spec[2: 2 + S], spec[2 + S: 2 + 2 * S]
    kinds = spec[2 + 2 * S: 2 + 2 * S + J]
    off = spec[2 + 2 * S + J: 3 + 2 * S + 2 * J]
    idx = spec[3 + 2 * S + 2 * J:]
    V, mins, spans = f8(coef[0]), coef[1: 1 + S], coef[1 + S: 1 + 2 * S]
    weights = coef[1 + 2 * S:]
    man, dot = f8(man), f8(dot)
    flags = int(np.bitwise_or.reduce(singles)) if S else 0
    raw = {F.FEAT_MANHATTAN: man}
    with np.errstate(all="ignore"):
        if flags & F.FEAT_LD:
            raw[F.FEAT_LD] = abs(len_a - len_b)
        if flags & (F.FEAT_INTERSECTION | F.FEAT_KULCZYNSKI2):
            mm = mag_a + mag_b
            ms = (mm - man) / f8(2.0)
            raw[F.FEAT_INTERSECTION] = f8(2.0) * ms / mm
            ap, aq = mag_a / V, mag_b / V
            raw[F.FEAT_KULCZYNSKI2] = (V * (ap + aq) / (f8(2.0) * ap * aq)) \
                * ms
        if flags & F.FEAT_SIMRATIO:
            n2 = sq_a + sq_b - f8(2.0) * dot
            n2 = f8(0.0) if n2 < 0.0 else n2
            raw[F.FEAT_SIMRATIO] = dot / (dot + np.sqrt(n2))
        if flags & F.FEAT_PEARSON:
            ap = np.floor(mag_a / V + f8(0.5))
            aq = np.floor(mag_b / V + f8(0.5))
            np_ = sq_a - f8(2.0) * ap * mag_a + V * ap * ap
            nq_ = sq_b - f8(2.0) * aq * mag_b + V * aq * aq
            dotc = dot - ap * mag_b - aq * mag_a + V * ap * aq
            p = np_ * nq_
            raw[F.FEAT_PEARSON] = dotc / np.sqrt(f8(0.5) if p < 0.5 else p)
        norm = []
        for i in range(S):
            nv = (f8(raw[int(singles[i])]) - mins[i]) / spans[i]
            norm.append(nv if is_sim[i] else f8(1.0) - nv)
        score, f1 = f8(weights[0]), None
        for j in range(J):
            prod = f8(1.0)
            for e in range(off[j], off[j + 1]):
                c = norm[idx[e]]
                prod = prod * (c * c if kinds[j] == F.COMBO_SQUARED else c)
            if j == 0:
                f1 = prod
            score = score + f8(weights[j + 1]) * prod
    return bool(score >= 0.0), f1


def model_absorb(st, s, sums, spec, coef, with_dot, h, sv, c, t, grid, rng,
                 least_slot=True):
    """pa_absorb: block-wide tiles of [w0, w1], a thread a slot. Only the
    first `busy` blocks hold a slot; the others read nothing and write no
    partial, and with no busy block the empty window's result is written
    as is. A tile's positives are summed count by count (a thread a count)
    and each count added into sumvec once, in any order; the busy blocks'
    partials are combined in any order."""
    N = s["active"].shape[0]
    w0, w1, last = st[P.W0], st[P.W1], st[P.LAST]
    T, G = grid["threads"], grid["blocks"]
    busy = 0 if w1 < w0 else min(-(-(w1 - w0 + 1) // T), G)
    if busy == 0:
        st[P.NPOS], st[P.BEST] = 0, N
        return
    parts = []
    for b in range(busy):
        best, npos = (-np.inf, N, False), 0
        for base in range(w0 + b * T, w1 + 1, G * T):
            tile = []
            for x in range(base, min(base + T, w1 + 1)):
                if not s["active"][x]:
                    continue
                pos, f1 = classify(
                    spec, coef, sums[0, x], sums[1, x] if with_dot else 0,
                    s["mag"][last], s["mag"][x], s["sq"][last], s["sq"][x],
                    s["lenf"][last], s["lenf"][x])
                if np.isnan(f1):
                    best = (best[0], best[1], True)
                else:
                    best = f1_op(best, (f1, x, False), least_slot)
                if pos:
                    s["owner"][x], s["stamp"][x] = c, t
                    s["active"][x] = False
                    npos += 1
                    tile.append(x)
            if tile:                            # the list's order: any
                sv += h[rng.permutation(tile)].astype(np.int64).sum(0)
        parts.append((best, npos))
    best = combine([p[0] for p in parts],
                   lambda a, b: f1_op(a, b, least_slot), rng)
    npos = sum(p[1] for p in parts)
    st[P.NPOS] = npos
    st[P.BEST] = N if best[2] else best[1]
    st[P.COUNT] += npos


def tile_members(owner, c, block, grid, rng):
    """csrc/phase_a.cu:tile_members: the members (owner == c) of a block's
    tile of threads * 2 * owner_loads owners, thread t's load j slots tile
    + 2 * (j * threads + t) + {0, 1}; each (load, slot of the pair) is one
    ballot a warp, whose members a warp appends to the block's list in the
    order the warps win the shared atomic."""
    N = owner.shape[0]
    T, W, OL = grid["threads"], grid["lanes"], grid["owner_loads"]
    tile = T * 2 * OL
    lst = []
    for e in range(2 * OL):
        warps = []
        for w in range(T // W):
            xs = [block * tile + 2 * ((e >> 1) * T + w * W + lane) + (e & 1)
                  for lane in range(W)]
            warps.append([x for x in xs if x < N and owner[x] == c])
        for w in rng.permutation(len(warps)):
            lst += warps[w]
    return lst


def owner_tiles(N, grid):
    return max(1, -(-N // (grid["threads"] * 2 * grid["owner_loads"])))


def tile_dist(h, sv, lst, count, vec, grid, out):
    """csrc/common.cuh:tile_dist on the rows h (their pieces of vec
    bytes): V in chunks of cw_bytes, cw = floor(sumvec /
    count) once a chunk, then each member's pieces of the chunk against
    cw's, int8 partials within 32 bits; the first chunk writes out[x], the
    later ones add. -> sum cw."""
    W = grid["lanes"]
    width = h.dtype.itemsize
    chunk = grid["cw_bytes"] // width
    cw_sum = 0
    for c0 in range(0, h.shape[1], chunk):
        cw = np.floor(sv[c0: c0 + chunk].astype(np.float64)
                      / count).astype(np.int64)
        cw_sum += int(cw.sum())
        nbytes = cw.shape[0] * width
        assert nbytes % vec == 0
        nv, E = nbytes // vec, vec // width
        lanes = 1
        while lanes < nv and lanes < W:
            lanes *= 2
        m = cw.astype(h.dtype).reshape(nv, E)
        for x in lst:
            part = np.minimum(h[x, c0: c0 + chunk].reshape(nv, E),
                              m).astype(np.int64).sum(1)
            if h.dtype == np.int8:      # 32-bit lane partials
                span = lanes if nv <= lanes else W * P.SUMS_UNROLL
                assert all(fits_int32(part[i: i + span].sum())
                           for i in range(0, nv, span))
            d = 2 * int(part.sum())
            if c0 == 0:
                out[x] = d
            else:
                assert out[x] != -7
                out[x] += d
    return cw_sum


def member_d(x, dist, s, cw_sum):
    """csrc/phase_a.cu:member_d: (d, stamp, slot) of member x."""
    frac = np.float64(dist[x]) / (s["mag"][x] + cw_sum)
    d = np.float64(10000.0) * (np.float64(1.0) - frac * frac)
    return (d, int(s["stamp"][x]), x)


def least_d(slots, dist, s, cw_sum, threads, rng, stamp_first):
    """A block's least (d, stamp, slot) over slots, its threads striding
    over them, reduced in any order."""
    none = (np.inf, np.iinfo(np.int64).max, s["owner"].shape[0])
    parts = []
    for t in range(threads):
        best = none
        for x in slots[t::threads]:
            best = d_op(best, member_d(x, dist, s, cw_sum), stamp_first)
        parts.append(best)
    return combine(parts, lambda a, b: d_op(a, b, stamp_first), rng)


def model_move(st, s, c, h, sv, grid, rng, stamp_first=True):
    """pa_move on the rows h: -> (dist with -7 where the kernel writes
    nothing, the slots whose rows it read). A block takes a tile of owners
    (tile_members) and computes its members' distances (tile_dist); the
    blocks that hold a member (no other block draws or writes anything) each
    draw
    a partial's index from st[MOVE]'s high field, divide the whole mean
    (sum cw), serve their members and reduce their own least (d, stamp,
    slot) to that partial, then add their member count to st[MOVE]'s low
    field: the draws and adds of the blocks interleave in any order, each
    block's draw before its add. st[COUNT] is the number of members, so the
    block whose add reaches it comes last, when every partial is in and the
    high field it read back is their number: it combines them, writes
    st[LAST] and dist[N], and resets st[MOVE]."""
    N = s["owner"].shape[0]
    assert st[P.MOVE] == 0
    count = np.float64(st[P.COUNT])
    dist = np.full(N + 1, -7, np.int64)
    width = h.dtype.itemsize
    vec = piece_bytes(0, h.shape[1] * width, h.shape[1] * width, width)
    busy = []
    for block in range(owner_tiles(N, grid)):
        lst = tile_members(s["owner"], c, block, grid, rng)
        if not lst:
            continue
        cw_sum = tile_dist(h, sv, lst, count, vec, grid, dist)
        busy.append((len(lst), least_d(lst, dist, s, np.float64(cw_sum),
                                       grid["threads"], rng, stamp_first),
                     cw_sum))
    assert len({cw for *_, cw in busy}) == 1    # every busy block's sum cw
    events = [(b, "draw") for b in range(len(busy))] + \
        [(b, "add") for b in range(len(busy))]
    events = [events[i] for i in rng.permutation(len(events))]
    seen = set()
    for i, (b, kind) in enumerate(events):      # each block's draw first
        if kind == "add" and b not in seen:
            j = events.index((b, "draw"))
            events[i], events[j] = events[j], events[i]
            b, kind = events[i]
        seen.add(b)
    mask = (1 << P.MOVE_SHIFT) - 1
    at, parts, combined = {}, {}, 0
    for b, kind in events:
        m, best, cw_sum = busy[b]
        old = int(st[P.MOVE])
        if kind == "draw":
            at[b] = old >> P.MOVE_SHIFT
            st[P.MOVE] = old + (1 << P.MOVE_SHIFT)
            continue
        parts[at[b]] = best
        st[P.MOVE] = old + m
        if (old & mask) + m == st[P.COUNT]:     # the combining block
            combined += 1
            n_parts = old >> P.MOVE_SHIFT
            assert n_parts == len(parts) == len(busy)
            st[P.LAST] = combine([parts[i] for i in range(n_parts)],
                                 lambda a, b: d_op(a, b, stamp_first),
                                 rng)[2]
            dist[N] = cw_sum
            st[P.MOVE] = 0
    assert combined == 1
    read = sorted(np.flatnonzero(dist[:N] != -7).tolist())
    return dist, read


# -- lockstep against _Slots' plain steps -----------------------------------------

def numpy_slots(sl):
    """The numpy copy of a plain _Slots' arrays that the model works on."""
    keys = ("active", "ranges", "mag", "sq", "lenf", "owner", "stamp")
    return {k: getattr(sl, k).numpy().copy() for k in keys}


def model_next(st, s, h, sv, center_slot, cmax):
    """pa_next: one block, whose threads all read st before thread 0
    writes it; where a center begins, the block's threads write the seed's
    row into sumvec, a count each. Nothing once st[DONE] is set."""
    N = s["active"].shape[0]
    if st[P.DONE]:
        return
    c, t, best = int(st[P.C]), int(st[P.T]) + 1, int(st[P.BEST])
    ends = st[P.NPOS] == 0
    seed = best if best < N else int(st[P.LIVE])
    stop = ends and (seed >= N or c + 1 >= cmax)
    if ends and not stop:
        sv[:] = h[seed]
    st[P.ITERS] += 1
    if not ends:
        st[P.T] = t
        return
    center_slot[c] = st[P.LAST]
    st[P.MEMBERS] += st[P.COUNT]
    st[P.C] = c + 1
    if stop:
        st[P.T], st[P.DONE] = t, 1
        return
    s["active"][seed] = False
    s["owner"][seed], s["stamp"][seed] = c + 1, t
    st[P.LAST], st[P.COUNT], st[P.T] = seed, 1, t + 1


def lockstep(ps, bv, params, sim, grid=SMALL, seed=0, least_slot=True,
             stamp_first=True):
    """Phase A driven as accumulate_device drives it, each step by the
    plain _Slots' chain and by the model, every value the next step reads
    compared (the move as the chain's move_plain against pa_move's model),
    until the done flag. -> (center slots, owner, stamp, slots, record)
    where record counts empty windows, ties and iterations."""
    rng = np.random.default_rng(seed)
    sl = A._Slots(ps, bv, params, sim, plain=True)
    N = sl.N
    s = numpy_slots(sl)
    h = ps.hist_dev[torch.as_tensor(sl.point)].numpy()
    spec, coef = sl.model.spec.numpy(), sl.model.coef.numpy()
    with_dot = sl.model.with_dot
    msums = np.zeros((2 if with_dot else 1, N), np.int64)
    rec = {"iters": 0, "empty": 0, "f1_ties": 0, "d_ties": 0}
    center_slot = np.zeros(N + 1, np.int64)

    def same_state():
        for k in ("active", "owner", "stamp"):
            np.testing.assert_array_equal(getattr(sl, k).numpy(), s[k])
        for a, b in ((0, P.COUNT + 1), (P.DONE, P.T + 1)):
            np.testing.assert_array_equal(sl.st.numpy()[a: b], st[a: b])
        np.testing.assert_array_equal(sv, sl.sumvec.numpy())

    sl.active[:1] = False
    sl.begin(0, 0, 0)
    st = sl.st.numpy().copy()
    s["active"][0] = False
    s["owner"][0] = s["stamp"][0] = 0
    sv = h[0].astype(np.int64)
    while not st[P.DONE]:
        sl.window()
        model_window(st, s["active"], s["ranges"], grid, seed % 16)
        same_state()
        w0, w1 = st[P.W0], st[P.W1]
        rec.setdefault("first_window", (w0, w1))
        rec["empty"] += int(not (s["active"][max(w0, 0): w1 + 1]).any())
        sl.sweep()
        read = model_sums(st, s, [h], msums, with_dot, grid)
        live = [x for x in range(max(w0, 0), min(w1, N - 1) + 1)
                if s["active"][x]]
        assert read == live
        np.testing.assert_array_equal(msums[:, live],
                                      sl.sums.numpy()[:, live])
        f1_live = _f1_of(sl, live)
        rec["f1_ties"] += int(len(f1_live) > 1 and np.sum(
            f1_live == f1_live.max()) > 1)
        c = int(st[P.C])
        sl.absorb_step()
        model_absorb(st, s, msums, spec, coef, with_dot, h, sv, c,
                     int(st[P.T]), grid, rng, least_slot)
        same_state()
        rec["iters"] += 1
        if st[P.NPOS]:
            sl.move(None)
            mdist, read = model_move(st, s, c, h, sv, grid, rng, stamp_first)
            members = np.flatnonzero(s["owner"] == c).tolist()
            assert read == members
            np.testing.assert_array_equal(mdist[members + [N]],
                                          sl.dist.numpy()[members + [N]])
            d = _d_of(sl, members)
            rec["d_ties"] += int(np.sum(d == d.min()) > 1)
            assert not st[P.TICKET: P.MOVE + 1].any()
        else:
            sl.move(None)               # a no-op: nothing absorbed
        same_state()
        sl.next_step()
        model_next(st, s, h, sv, center_slot, N + 1)
        same_state()
        np.testing.assert_array_equal(sl.center_slot.numpy(), center_slot)
    assert st[P.ITERS] == rec["iters"] and st[P.MEMBERS] == N
    n_centers = int(st[P.C])
    return (center_slot[:n_centers].tolist(), s["owner"], s["stamp"],
            sl.point, rec)


def _f1_of(sl, live):
    """The plain f1 of the live window slots (for counting ties)."""
    if not live:
        return np.zeros(0)
    last = sl.st[P.LAST: P.LAST + 1]
    sums = sl.sums
    _, f1 = sl.model.scorer(sums[0], sums[1] if sl.model.with_dot else None,
                            sl.mag[last], sl.mag, sl.sq[last], sl.sq,
                            sl.lenf[last], sl.lenf)
    return f1.numpy()[live]


def _d_of(sl, members):
    N = sl.N
    dist = sl.dist.numpy()
    frac = dist[members].astype(np.float64) / (sl.mag.numpy()[members]
                                               + np.float64(dist[N]))
    return 10000.0 * (1.0 - frac * frac)


def centers_of(center_slot, owner, stamp, point):
    """accumulate_device's grouping: (center point, members in (stamp,
    slot) order)."""
    out = []
    for c, slot in enumerate(center_slot):
        mem = np.flatnonzero(owner == c)
        mem = mem[np.lexsort((mem, stamp[mem]))]
        out.append((int(point[slot]), point[mem].tolist()))
    return out


# -- cases ----------------------------------------------------------------------

def planted_points(seed=3, n=96):
    """Toy points in near-copy pairs, with exact duplicates (counts and
    length) planted in threes, so f1 and d tie; and one lone read, the
    shortest (the first seed), whose length window holds only itself."""
    rng = np.random.default_rng(seed)
    hist, _, _, lens, params = toy_model(n=n, seed=seed)
    hist[1::2] = hist[0::2] + rng.integers(0, 2, size=hist[0::2].shape)
    hist[2::6], lens[2::6] = hist[0::6], lens[0::6]
    hist[3::6], lens[3::6] = hist[0::6], lens[0::6]
    lens[-1] = 100
    mag = hist.astype(np.int64).sum(1)
    sq = (hist.astype(np.int64) ** 2).sum(1)
    return toy_points(hist, mag, sq, lens), params


def k1_points(seed=8, n=96):
    """Toy points of 4 counts a row (k = 1: 4 bytes of int8, under one
    16-byte piece), rows in near-copy pairs."""
    rng = np.random.default_rng(seed)
    hist, _, _, lens, params = toy_model(n=n, V=4, seed=seed)
    hist[1::2] = hist[0::2] + rng.integers(0, 2, size=hist[0::2].shape)
    mag = hist.astype(np.int64).sum(1)
    sq = (hist.astype(np.int64) ** 2).sum(1)
    return toy_points(hist, mag, sq, lens), params


def _k1(q):
    ps, params = k1_points()
    return ps, shifted(params, ps, q)[0]


def _edge(sim, q):
    ps, params = edge_points(sim)
    return ps, shifted(params, ps, q)[0]


def _planted(q):
    ps, params = planted_points()
    return ps, shifted(params, ps, q)[0]


# name -> (sim, maker of (points, params)); q moves the intercept as
# test_torch_device_backend.shifted does (stricter: more centers, windows)
CASES = {
    "edge_0.60": (0.60, lambda: _edge(0.60, None)),
    "edge_0.60_strict": (0.60, lambda: _edge(0.60, 0.9)),
    "edge_0.97": (0.97, lambda: _edge(0.97, None)),
    "edge_0.97_strict": (0.97, lambda: _edge(0.97, 0.8)),
    "planted_0.90": (0.90, lambda: _planted(0.5)),
    "k1_0.90": (0.90, lambda: _k1(0.5)),
}


def _edge_case(name):
    sim, make = CASES[name]
    return (*make(), sim)


@pytest.mark.parametrize("grid", ["small", "own"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_model_equals_plain_steps(name, grid):
    """Each step's model against its plain step, iteration by iteration,
    the move by pa_move's model."""
    ps, params, sim = _edge_case(name)
    bv = port_bv(ps, 7)
    got = lockstep(ps, bv, params, sim, grid=SMALL if grid == "small"
                   else OWN, seed=len(name))
    want = listed(A.accumulate_device(ps, port_bv(ps, 7), params, sim))
    assert centers_of(*got[:4]) == want
    rec = got[4]
    assert rec["empty"] >= 1            # at least the last center's window
    assert rec["iters"] > len(want)


def test_planted_case_ties_and_lone_read():
    """f1 and d tie in some iterations; the lone read (slot 0) seeds the
    first center, no other read lies in its length window, and
    bvec::get_range's in-bin cases still give it a window of live slots
    past that window's end."""
    ps, params, sim = _edge_case("planted_0.90")
    *_, point, rec = lockstep(ps, port_bv(ps, 7), params, sim)
    assert rec["f1_ties"] >= 1 and rec["d_ties"] >= 1
    lens = ps.lengths[point]
    w0, w1 = rec["first_window"]
    assert point[0] == ps.n - 1 and lens[1] > int(lens[0] / sim)
    assert 1 <= w0 <= w1


def test_model_with_the_f1_tie_rule_turned_around_disagrees():
    ps, params, sim = _edge_case("planted_0.90")
    with pytest.raises(AssertionError):
        lockstep(ps, port_bv(ps, 7), params, sim, least_slot=False)


def move_case(n=40, c=2, seed=4):
    """Slots 0..n-1 whose owners are random centers other than c but for
    c's members 1 (stamp 9), 20 (stamp 3) and 35 (stamp 3), three equal
    rows in three tiles of the SMALL grid (16 slots; n is not a multiple),
    whose d ties at the least, and 3 (stamp 5), a row of zeros; their mag
    and sumvec as Phase A keeps them, st[COUNT] their number."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 60, size=(n, 24)).astype(np.int8)
    rows[[20, 35]] = rows[1]
    rows[3] = 0
    owner = np.where(rng.random(n) < 0.5, 0, 5)
    stamp = rng.integers(0, 4, size=n)
    owner[[1, 20, 35, 3]] = c
    stamp[[1, 20, 35, 3]] = [9, 3, 3, 5]
    return rows, owner, stamp


def move_models(rows, owner, stamp, c, count, grid, stamp_first, seed=0):
    """st[LAST] and dist by pa_move's model."""
    rng = np.random.default_rng(seed)
    n = owner.shape[0]
    s = {"owner": owner, "stamp": stamp,
         "mag": rows.astype(np.int64).sum(1).astype(np.float64)}
    sv = rows[owner == c].astype(np.int64).sum(0)
    st = P.new_state(n, "cpu")[0].numpy().copy()
    st[P.COUNT] = count
    dist, _ = model_move(st, s, c, rows, sv, grid, rng, stamp_first)
    return int(st[P.LAST]), dist


def plain_move(rows, owner, stamp, c, count):
    """move_plain through the wrapper (CPU tensors), in an iteration that
    absorbed: (st[LAST], dist)."""
    n = owner.shape[0]
    h = torch.as_tensor(rows)
    st, part = P.new_state(n, "cpu")
    st[P.COUNT], st[P.C], st[P.NPOS] = count, c, 1
    dist = torch.zeros(n + 1, dtype=torch.int64)
    P.move(st, torch.as_tensor(owner), h, h[torch.as_tensor(owner) == c]
           .to(torch.int64).sum(0), h.to(torch.int64).sum(1).to(torch.float64),
           torch.as_tensor(stamp), dist, part)
    return int(st[P.LAST]), dist.numpy()


@pytest.mark.parametrize("grid", ["small", "own"])
@pytest.mark.parametrize("stamp_first", [True, False])
def test_mean_argmin_tie_goes_to_the_least_stamp(stamp_first, grid):
    """Members 1, 20 and 35 of center 2 tie in d (the same row and mass)
    across three blocks; slot 1 was absorbed last: the plain step takes
    slot 20 (least stamp, then slot), as pa_move's model does in any block
    order, and a copy that ranks by slot alone takes slot 1. move_plain's
    argmin, on distances given, also takes the least stamp."""
    rows, owner, stamp = move_case()
    members = np.flatnonzero(owner == 2).tolist() + [owner.shape[0]]
    want, want_dist = plain_move(rows, owner, stamp, 2, 4)
    assert want == 20
    for seed in range(4):
        got, dist = move_models(rows, owner, stamp, 2, 4,
                                SMALL if grid == "small" else OWN,
                                stamp_first, seed)
        np.testing.assert_array_equal(dist[members], want_dist[members])
        assert (got == 20) == stamp_first and (got == 1) != stamp_first
    n = 8
    owner = torch.tensor([0, 2, 1, 2, 2, 0, 2, 1])
    stamp = torch.tensor([1, 9, 2, 5, 3, 1, 3, 4])
    dist = torch.tensor([4, 50, 4, 40, 50, 4, 50, 4, 30])
    st, _ = P.new_state(n, "cpu")
    st[P.C] = 2
    assert int(P._mean_argmin(st, dist, torch.full(
        (n,), 200.0, dtype=torch.float64), owner, stamp)) == 4


def test_move_of_a_lone_member():
    """A center whose only member is itself: it stays, on both grids."""
    rows, owner, stamp = move_case()
    owner[owner == 2] = 0
    owner[33] = 2
    assert plain_move(rows, owner, stamp, 2, 1)[0] == 33
    for grid in (SMALL, OWN):
        assert move_models(rows, owner, stamp, 2, 1, grid, True)[0] == 33


def test_move_models_need_the_member_count():
    """st[COUNT] one off the members' number: no block of pa_move combines
    (its model fails)."""
    rows, owner, stamp = move_case()
    with pytest.raises(AssertionError):
        move_models(rows, owner, stamp, 2, 5, SMALL, True)


@pytest.fixture(scope="module", params=sorted(CORPORA))
def species(request):
    kw = dict(CORPORA[request.param])
    jps, jparams = jax_points(np.random.default_rng(kw.pop("seed")), **kw)
    return jps, jparams, port_case(jps, jparams)


def test_model_phase_equals_jax(species):
    """--id 0.90 on the species corpora: the model's whole phase against
    the JAX package's accumulate_device, and the wrappers' path
    (plain=False, their plain versions on the CPU) against both."""
    from meshclust_tpu.core.accumulate_device import accumulate_device
    from meshclust_tpu.core.bvec import BVec as JBVec
    jps, jparams, (ps, params) = species
    jbv = JBVec(jps.lengths.copy(), 20)
    for i in range(jps.n):
        jbv.insert(i, int(jps.lengths[i]))
    jbv.insert_finalize()
    want = listed(accumulate_device(jps, jbv, jparams, 0.90))
    got = lockstep(ps, port_bv(ps), params, 0.90)
    assert centers_of(*got[:4]) == want
    assert listed(A.accumulate_device(ps, port_bv(ps), params, 0.90,
                                      plain=False)) == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrappers_on_the_cpu_equal_plain_path(name):
    """accumulate_device(plain=False): the kernels' wrappers, which take
    their plain versions for CPU tensors (rows in the storage dtype)."""
    ps, params, sim = _edge_case(name)
    want = listed(A.accumulate_device(ps, port_bv(ps, 7), params, sim))
    got = listed(A.accumulate_device(ps, port_bv(ps, 7), params, sim,
                                     plain=False))
    assert got == want


# pa_sums on rows at its pieces' edges: (V, dtype, counts drawn from,
# column slices [start, stop), a launch each), against sums_plain
SUMS_ROWS = {
    "k1_int8": (4, np.int8, np.arange(128), None),
    "int8_0_1_127": (256, np.int8, np.array([0, 1, 127]), None),
    "int8_full_range": (256, np.int8, np.arange(-128, 128), None),
    "int8_V65536_at_127": (65536, np.int8, np.array([127]), None),
    "int8_odd_slices": (256, np.int8, np.arange(128),
                        [(0, 86), (86, 171), (171, 256)]),
    "int8_slice_of_4": (260, np.int8, np.arange(128), [(0, 4), (4, 260)]),
    "int16_extremes": (256, np.int16, np.array([0, 1, 32767, -32768]),
                       None),
    "int16_odd_slices": (100, np.int16, np.arange(-300, 300),
                         [(0, 33), (33, 100)]),
    "int32": (64, np.int32, np.arange(-46340, 46341, 97), None),
    "int64": (16, np.int64, np.arange(-10 ** 6, 10 ** 6, 999), None),
}


@pytest.mark.parametrize("grid", ["small", "own"])
@pytest.mark.parametrize("case", sorted(SUMS_ROWS))
def test_model_sums_pieces_equal_plain(case, grid):
    """The model of pa_sums (pieces chosen from each slice's address,
    pitch and length; short and long rows; int8 byte SIMD on biased
    counts) against sums_plain on the live slots of a window, with the
    rows' sums of extreme counts (V = 65,536 at 127 is int8's largest dot
    within 32 bits)."""
    V, dtype, pool, slices = SUMS_ROWS[case]
    rng = np.random.default_rng(V)
    n = 12
    rows = rng.choice(pool, size=(n, V)).astype(dtype)
    active = rng.random(n) < 0.7
    active[[1, 3]] = True
    st, _ = P.new_state(n, "cpu")
    st[P.W0], st[P.W1], st[P.LAST] = 1, n - 2, 3
    want = torch.zeros((2, n), dtype=torch.int64)
    P.sums(st, torch.as_tensor(active), torch.as_tensor(rows), want)
    shards = [rows[:, a: b] for a, b in slices or [(0, V)]]
    got = np.zeros((2, n), np.int64)
    read = model_sums(st.numpy(), {"active": active}, shards, got, True,
                      SMALL if grid == "small" else OWN)
    live = [x for x in range(1, n - 1) if active[x]]
    assert read == live
    np.testing.assert_array_equal(got[:, live], want.numpy()[:, live])


def test_piece_bytes_of_the_main_path_and_its_slices():
    """16-byte pieces for the k-mer path's rows (256 int8 counts); a column
    slice at an odd column takes single bytes, at an even one 2-byte
    pieces; 4 int8 counts (k = 1) one 4-byte piece."""
    assert piece_bytes(0, 256, 256, 1) == 16
    assert piece_bytes(86, 256, 85, 1) == 1
    assert piece_bytes(0, 256, 86, 1) == 2
    assert piece_bytes(0, 4, 4, 1) == 4
    assert piece_bytes(128 * 2, 512, 256, 2) == 16
    assert piece_bytes(0, 24, 24, 8) == 8


def all_singles_params(V=256):
    """A model with every single the kernels compute, SIMRATIO too."""
    feat = F.Feature(V)
    for flags, combo in F.DEFAULT_FEATURE_MENU + [
            (F.FEAT_SIMRATIO | F.FEAT_MANHATTAN, F.COMBO_SQUARED)]:
        feat.add_feature(flags, combo)
    feat.normalize_raw({
        F.FEAT_LD: np.array([0.0, 500.0]),
        F.FEAT_MANHATTAN: np.array([50.0, 4000.0]),
        F.FEAT_INTERSECTION: np.array([0.3, 0.99]),
        F.FEAT_PEARSON: np.array([-0.5, 0.999]),
        F.FEAT_SIMRATIO: np.array([0.2, 0.95]),
        F.FEAT_KULCZYNSKI2: np.array([1000.0, 90000.0]),
    })
    feat.finalize()
    return feat.params(np.array([-3.0, 2.0, 1.5, 2.0, 1.0, 0.5]))


def test_packed_classifier_equals_scorer():
    """The kernel's classify, read from Model's packed arrays, against
    Scorer (decisions and f1, bit for bit) on pairs of toy rows with every
    supported single."""
    hist, mag, sq, lens, _ = toy_model(n=64, seed=5)
    params = all_singles_params()
    model = CL.Model(params, hist.shape[1], "cpu")
    assert model.with_dot
    spec, coef = model.spec.numpy(), model.coef.numpy()
    h = torch.as_tensor(hist.astype(np.int64))
    rng = np.random.default_rng(6)
    f64 = {"dtype": torch.float64}
    for a in rng.integers(0, 64, size=6):
        man = (h[a] - h).abs().sum(-1)
        dot = (h[a] * h).sum(-1)
        m, q, ln = (torch.as_tensor(x.astype(np.float64), **f64)
                    for x in (mag, sq, lens))
        pos, f1 = model.scorer(man, dot, m[a: a + 1], m, q[a: a + 1], q,
                               ln[a: a + 1], ln)
        for b in range(64):
            got = classify(spec, coef, int(man[b]), int(dot[b]),
                           np.float64(mag[a]), np.float64(mag[b]),
                           np.float64(sq[a]), np.float64(sq[b]),
                           np.float64(lens[a]), np.float64(lens[b]))
            assert got[0] == bool(pos[b])
            assert got[1] == float(f1[b]) or (np.isnan(got[1])
                                              and np.isnan(float(f1[b])))


def test_model_takes_distinct_singles_only():
    """pa_absorb's classifier holds one normalized value a single in
    kMaxSingles registers: Model refuses a single flag given twice (a
    trained model never has one: Feature.add_feature adds each once)."""
    params = all_singles_params()
    assert len(params.singles) == CL.MAX_SINGLES
    CL.Model(params, 256, "cpu")
    params.singles = params.singles + params.singles[:1]
    with pytest.raises(ValueError):
        CL.Model(params, 256, "cpu")


# -- pa_window's table against window_plain ----------------------------------

def check_windows(sizes, lens, lo, hi, front, back, masks, grid, mis=0):
    """For each mask in turn (each a subset of the one before, as slots
    die in a phase), the window of every center slot: the model (its st
    carried over from mask to mask) and the wrapper's CPU path
    (window_table_plain) on core/accumulate_device.window_ranges's table
    against window_plain on the per-slot arrays (bins of `sizes` slots).
    -> [(w0, w1)] in order."""
    N = len(lens)
    plain_in = tuple(torch.as_tensor(np.asarray(a, np.int64)) for a in (
        np.repeat(np.arange(len(sizes)), sizes), lens, lo, hi, front, back))
    ranges = A.window_ranges(lens, sizes, lo, hi, front, back)
    st_m = P.new_state(N, "cpu")[0].numpy().copy()
    st_t = P.new_state(N, "cpu")[0]
    out, keys = [], [P.W0, P.W1, P.LIVE]
    for act in masks:
        active = torch.as_tensor(act)
        live = np.flatnonzero(act)
        for c in range(N):
            st_p = P.new_state(N, "cpu")[0]
            st_p[P.LAST] = st_t[P.LAST] = st_m[P.LAST] = c
            P.window_plain(st_p, active, *plain_in)
            model_window(st_m, act, ranges, grid, mis)
            P.window(st_t, active, torch.as_tensor(ranges))
            want = st_p[keys].tolist()
            assert st_m[keys].tolist() == want
            assert st_t[keys].tolist() == want
            assert st_m[P.TAIL] == st_t[P.TAIL] == (live[-1] if live.size
                                                    else -1)
            out.append(tuple(want[:2]))
    return out


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(data=hst.data())
@pytest.mark.parametrize("grid", ["small", "own"])
def test_window_table_equals_window_plain(grid, data):
    """Random bins (empty ones too), non-decreasing lengths, any window
    limits and front and back bins a center, random live masks that shrink
    to all dead, and any alignment of the flags: the window of every center
    slot under each mask."""
    nb = data.draw(hst.integers(1, 5))
    sizes = data.draw(hst.lists(hst.integers(0, 24), min_size=nb,
                                max_size=nb))
    N = sum(sizes)
    if N == 0:
        return
    steps = data.draw(hst.lists(hst.integers(0, 3), min_size=N, max_size=N))
    lens = 100 + np.cumsum(steps)
    pick = lambda lo_, hi_: np.asarray(data.draw(hst.lists(      # noqa: E731
        hst.integers(lo_, hi_), min_size=N, max_size=N)))
    lo, hi = lens - pick(0, 8), lens + pick(0, 8)
    front, back = pick(0, nb - 1), pick(0, nb - 1)
    p = data.draw(hst.sampled_from([0.1, 0.5, 0.9, 1.0]))
    rng = np.random.default_rng(data.draw(hst.integers(0, 2 ** 16)))
    act = rng.random(N) < p
    masks = [act, act & (rng.random(N) < 0.5), np.zeros(N, bool)]
    check_windows(sizes, lens, lo, hi, front, back, masks,
                  SMALL if grid == "small" else OWN,
                  data.draw(hst.integers(0, 15)))


# four bins of four slots; a center at slot 5 whose (lo, front bin, hi,
# back bin) and dead slots make each case of window_plain, with its (w0, w1)
WINDOW_LENS = [10, 10, 11, 12, 13, 13, 14, 15, 16, 16, 17, 18, 19, 20, 20, 21]
WINDOW_CASES = {
    "front_ge": ((13, 1, 16, 2), [], (4, 9)),
    "front_at_bin_edge": ((16, 2, 16, 2), [], (8, 9)),
    "front_none_ge_takes_the_bins_last": ((16, 1, 17, 2), [6], (7, 10)),
    "empty_front_bin_takes_the_first_live": ((13, 1, 16, 2),
                                             [0, 4, 5, 6, 7], (1, 9)),
    "back_eq_run_dead_takes_the_first_gt": ((13, 1, 16, 2), [8, 9], (4, 10)),
    "back_only_shorter_takes_the_bins_last": ((13, 1, 20, 3), [13, 14, 15],
                                              (4, 12)),
    "truncation_quirk": ((13, 1, 20, 3), [12, 13, 14, 15, 8, 11], (4, 9)),
    "nothing_live": ((13, 1, 16, 2), list(range(16)), (16, -1)),
}


@pytest.mark.parametrize("grid", ["small", "own"])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_cases(case, grid):
    """Each case of window_plain at the center slot 5: the model and the
    table's plain step give window_plain's (w0, w1), the one written
    down, at flags of every alignment."""
    (lo_c, fb, hi_c, bb), dead, want = WINDOW_CASES[case]
    lens = np.asarray(WINDOW_LENS)
    lo, hi = lens.copy(), lens.copy()
    front, back = np.arange(16) // 4, np.arange(16) // 4
    lo[5], front[5], hi[5], back[5] = lo_c, fb, hi_c, bb
    act = np.ones(16, bool)
    act[dead] = False
    for mis in range(16):
        got = check_windows([4] * 4, lens, lo, hi, front, back, [act],
                            SMALL if grid == "small" else OWN, mis)
        assert got[5] == want


def test_window_ranges_need_sorted_lengths():
    """The table reads a length bound as a searchsorted over the slots."""
    with pytest.raises(ValueError):
        A.window_ranges([3, 2], [2], [1, 1], [4, 4], [0, 0], [0, 0])


def test_source_constants_match_the_wrappers():
    """csrc/phase_a.cu's grid, state slots and flags (and those of the
    header it includes, csrc/common.cuh) are the ones ops/phase_a.py and
    ops/features.py name."""
    src = ""
    for path in (SOURCE, HEADER):
        with open(path) as f:
            src += f.read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)[,;]", src).group(1))

    def flag(name):
        return 1 << int(re.search(rf"\b{name} = 1 << (\d+)", src).group(1))

    assert const("kBlocks") == P.BLOCKS
    assert const("kPartials") == P.PARTIALS
    assert const("kThreads") == P.THREADS
    assert const("kMaxSingles") == CL.MAX_SINGLES
    assert const("kPieceBytes") == P.PIECE_BYTES
    assert const("kUnroll") == P.SUMS_UNROLL
    assert const("kWindowWarps") == P.WINDOW_WARPS
    assert const("kWinLoads") == P.WINDOW_LOADS
    assert const("kOwnerLoads") == P.OWNER_LOADS
    assert const("kCwBytes") == P.CW_BYTES
    assert const("kRanges") == len(P.RANGES)
    for name, want in (("kNPos", P.NPOS), ("kBest", P.BEST),
                       ("kLast", P.LAST), ("kLive", P.LIVE), ("kW0", P.W0),
                       ("kW1", P.W1), ("kCount", P.COUNT), ("kTail", P.TAIL),
                       ("kTicket", P.TICKET), ("kMove", P.MOVE),
                       ("kDone", P.DONE),
                       ("kIters", P.ITERS), ("kC", P.C),
                       ("kMembers", P.MEMBERS), ("kT", P.T),
                       ("kMoveShift", P.MOVE_SHIFT),
                       ("kComboSquared", F.COMBO_SQUARED)):
        assert const(name) == want, name
    for i, col in enumerate(P.RANGES):
        name = "k" + "".join(w.title() for w in col.split("_"))
        assert const(name) == i == getattr(P, col), name
    for name, want in (("kFeatLD", F.FEAT_LD),
                       ("kFeatManhattan", F.FEAT_MANHATTAN),
                       ("kFeatIntersection", F.FEAT_INTERSECTION),
                       ("kFeatPearson", F.FEAT_PEARSON),
                       ("kFeatSimRatio", F.FEAT_SIMRATIO),
                       ("kFeatKulczynski2", F.FEAT_KULCZYNSKI2)):
        assert flag(name) == want, name
    assert P.T < P.STATE_LEN
    # pa_move's partials fit part at every size: three a busy tile
    for n in (1, 1023, 1024, 1025, 10 ** 6):
        assert 3 * P.owner_tiles(n) <= P.part_len(n)
    assert set(CL.SUPPORTED) == {F.FEAT_LD, F.FEAT_MANHATTAN,
                                F.FEAT_INTERSECTION, F.FEAT_PEARSON,
                                F.FEAT_SIMRATIO, F.FEAT_KULCZYNSKI2}

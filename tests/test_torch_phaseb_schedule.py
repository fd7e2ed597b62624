"""What the Phase B kernels (meshclust_tpu_torch/csrc/phase_b.cu) rely on,
checked on the CPU through a numpy model of their decomposition.

The kernels run only on a CUDA card. The model below replays each one with
its grid (blocks of a tile of members, run in a random order), its threads
and its reductions:
  pb_band   assign mapped through remap; the tile's span of centers [min
            assign - delta, max assign + delta] over the members that count,
            staged where it holds at most the budget's rows (the kernels'
            shared memory, or a small budget); a thread a (member, offset)
            pair in any order, man and dot over the whole row (32-bit
            partial sums for int8 counts, checked), the float64 classifier
            read from ops/classifier.Model's packed arrays, the bit into the
            member's word and, staged, the member's bit into its center's
            mask; then staged, each center of the span with a positive adds
            its masked members' rows (32-bit column sums for int8 and int16
            counts, checked) and count into sc, an add a column, none for a
            zero; on the global path each positive adds its member's row;
  pb_dist   the tile's positives numbered member by member; the span of
            centers with a positive, staged within the budget: each such
            center's floored mean and its sum once a tile, then a thread a
            positive, d in float64 (IEEE, no FMA), each center's least d a
            minimum of bit patterns merged into best_d once a tile; on the
            global path a positive divides the mean itself;
  pb_pick   zero blocks (a warp a row of sc: the count read first, a row
            with one cleared in a head word, 16-byte pairs and a tail word)
            and tie blocks (a thread a member, its positives in bit order
            (__ffs), d from the offset-major dstore, the least pool
            position among the ties), interleaved in any order;
  pb_merge  blocks of a few centers numbered in the order they start, their
            steps interleaved at random or latest first: each stages its
            slots' moves, takes a center's first max of f1 over its
            candidates (a group of `lanes` lanes splits each row and
            classifies the offsets in turn, then keeps the greatest f1,
            the least offset on a tie), publishes its counts of kept and valid centers, takes its
            prefix by look-back once every earlier block has published,
            then writes NP, remap where the chain ends in its tile, the
            list of chains that leave it, and its kept centers into their
            slots in place; the last block follows the listed chains,
            clears the slots from the new kept total to the old.
The model is held equal, step by step and iteration by iteration, to the
plain steps (ops/phase_b.py, the port's Phase B torch ops), on species
corpora whose intercept splits species into several centers (Phase A's
centers, then merges that make assign non-monotone), with rows in int8,
int16 and int32, --delta 0, 5 and 40 (three words of bits), a rank's
padded block of the pool, C = 1, rows duplicated so that distances tie
inside a tile and across tiles, and centers with no positive; at the
kernels' own tile and budget, at small ones where tiles' spans pass the
budget (both paths in one step), and with no budget (every tile global);
the merge also with no center moved (every moved center read from c_idx)
and its blocks latest first. Copies of the model with the pick's tie rule
turned around, the pick clearing a row's count before reading it, the
listed chains left after one hop, a merge block publishing its counts
before its last read of c_idx (run latest first), the band's accumulator
one row short of the span, or the dist's span taken from assign without
the offsets, must disagree. The wrappers on CPU tensors are the plain steps, and
csrc/phase_b.cu's constants are ops/phase_b.py's. Tolerance: exact
equality.
"""
import dataclasses
import os
import re
import types

import numpy as np
import pytest
import torch

from meshclust_tpu_torch import _ext
from meshclust_tpu_torch.core.classify import DeviceBackend, HostBackend
from meshclust_tpu_torch.ops import phase_b as PB
from meshclust_tpu_torch.ops.classifier import DBL_MIN
from test_torch_device_backend import host_scores, toy_model, toy_points

torch.set_num_threads(1)
os.environ.setdefault("MESHCLUST_QUIET", "1")
SOURCE = os.path.join(os.path.dirname(PB.__file__), "..", "csrc",
                      "phase_b.cu")
HEADER = os.path.join(os.path.dirname(SOURCE), "common.cuh")
# counts 1-12 scaled into each storage dtype of the rows
SCALES = {"int8": 1, "int16": 1000, "int32": 5000}
# pb_band's and pb_dist's tile and budget of staged center rows (None:
# the kernels', PB.stage_cap of the rows' bytes), pb_merge's lanes a
# center (None: the kernel's, lanes_of), its centers a block (None: the
# kernel's, kWarps groups of lanes) and the slots it stages past them
# (None: the kernel's, min(delta, kMergeAhead))
OWN = dict(tile=PB.TILE, cap=None, lanes=None, centers=None, ahead=None)
SMALL = dict(tile=8, cap=12, lanes=4, centers=3, ahead=2)
ONE_LANE = dict(tile=5, cap=0, lanes=1, centers=1, ahead=0)
GRIDS = {"own": OWN, "small": SMALL, "one_lane": ONE_LANE}
CHUNK_PIECES = 32                     # phase_b.cu: kChunkPieces
PIECE_BYTES = 16                      # common.cuh: kPieceBytes
MERGE_AHEAD = 64                      # phase_b.cu: kMergeAhead
# phase_b.cu: kMergeLanesSmall, kMergeLanesLarge (the launch takes the
# large where its tiles all fit on the card at once: the tests' centers)
MERGE_LANES_SMALL, MERGE_LANES_LARGE = 4, 16


def species_case(dtype, device, n_species=8, per=24, seed=3, dup=0,
                 close=False):
    """Species of k-mer rows (each clone its species' counts, 1-12, with a
    few counts moved by one; with `dup`, every dup-th clone a copy of the
    one before it, so that distances tie; with `close`, species lengths a
    few bp apart, so that species interleave in the length order and a
    merge may pass over a kept center) scaled into `dtype`, the toy
    classifier with its intercept raised to the median score within a
    species (species split into several centers, which Phase B pools and
    merges), and Phase A's centers of them on `device`: (backend, members,
    assign, center rows)."""
    from meshclust_tpu_torch.core.accumulate_device import accumulate_device
    from meshclust_tpu_torch.core.bvec import BVec
    scale = SCALES[dtype]
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 12, size=(n_species, 256))
    species = np.repeat(np.arange(n_species), per)
    n = species.shape[0]
    hist = base[species] + rng.integers(-1, 2, size=(n, 256)) \
        * (rng.random((n, 256)) < 0.2)
    lens = ((500 + 3 * np.arange(n_species) if close
             else rng.integers(300, 800, size=n_species))[species]
            + rng.integers(-10, 10, size=n))
    if dup:
        hist[dup::dup] = hist[dup - 1::dup][: hist[dup::dup].shape[0]]
        lens[dup::dup] = lens[dup - 1::dup][: lens[dup::dup].shape[0]]
    hist = (np.maximum(hist, 1) * scale).astype(np.int32)
    mag = hist.astype(np.int64).sum(1)
    sq = (hist.astype(np.int64) ** 2).sum(1)
    params = toy_model(n=8, scale=scale)[4]
    hb = HostBackend(toy_points(hist, mag, sq, lens), params)
    intra = [host_scores(hb, int(c), np.flatnonzero(species == species[c]))
             for c in np.unique(species, return_index=True)[1]]
    w = params.weights.copy()
    w[0] -= np.median(np.concatenate(intra))
    params = dataclasses.replace(params, weights=w)
    ps = toy_points(hist, mag, sq, lens, device=device)
    assert ps.hist_dev.dtype == getattr(torch, dtype)
    bv = BVec(ps.lengths.copy(), 40)
    for i in range(ps.n):
        bv.insert(i, int(ps.lengths[i]))
    bv.insert_finalize()
    centers = accumulate_device(ps, bv, params, 0.90)
    members = np.asarray([m for c in centers for m in c.members], np.int64)
    assign = np.repeat(np.arange(len(centers)),
                       [len(c.members) for c in centers])
    rows = np.asarray([c.center for c in centers], np.int64)
    return DeviceBackend(ps, params), members, assign, rows


# -- the model ----------------------------------------------------------------

def numpy_state(pb):
    """The model's copy of a State: every tensor as numpy (rows widened to
    int64, bits as uint32, best_d as float64 bit patterns compared as
    int64)."""
    s = {k: v.numpy().copy() for k, v in vars(pb).items()
         if isinstance(v, torch.Tensor)}
    s["rows"] = pb.rows.numpy().astype(np.int64)
    s["hist"] = pb.hist.numpy().astype(np.int64)
    s["bits"] = pb.bits.numpy().view(np.uint32).copy()
    s["spec"] = pb.model.spec.numpy()
    s["coef"] = pb.model.coef.numpy()
    s["itemsize"] = pb.rows.element_size()
    s["delta"], s["goff"] = pb.delta, pb.goff
    s["m_valid"] = (None if pb.m_valid is None else pb.m_valid.numpy())
    s["paths"] = np.zeros(len(PB.PATHS), np.int64)
    s["np"] = np.zeros(pb.c_idx.shape[0], np.int64)   # pb_merge's NP
    return s


def lanes_of(s, grid):
    """pb_merge's lanes a center: the kernel's at the tests' few centers
    (kMergeLanesLarge), or the grid's (SMALL's are kMergeLanesSmall)."""
    return MERGE_LANES_LARGE if grid["lanes"] is None else grid["lanes"]


def classify(s, man, dot, a, b):
    from test_torch_phasea_schedule import classify as cls
    return cls(s["spec"], s["coef"], man, dot, s["mag"][a], s["mag"][b],
               s["sq"][a], s["sq"][b], s["lenf"][a], s["lenf"][b])


def lane_sums(row_a, row_b, lanes, itemsize):
    """man and dot of two rows as a group of `lanes` lanes sums them: each
    lane its pieces (16 bytes, every lanes-th), then the group."""
    per = PIECE_BYTES // itemsize
    piece = np.arange(row_a.shape[0]) // per
    man = dot = 0
    for sub in range(lanes):
        on = piece % lanes == sub
        man += int(np.abs(row_a[on] - row_b[on]).sum())
        dot += int((row_a[on] * row_b[on]).sum())
    return man, dot


def thread_sums(row_a, row_b, itemsize):
    """man and dot of two rows as one thread sums them: 32-bit partial sums
    over CHUNK_PIECES 16-byte pieces for int8 counts (checked to fit), 64
    bits across them."""
    per = CHUNK_PIECES * PIECE_BYTES // itemsize
    man = dot = 0
    for c0 in range(0, row_a.shape[0], per):
        a, b = row_a[c0: c0 + per], row_b[c0: c0 + per]
        m, d = int(np.abs(a - b).sum()), int((a * b).sum())
        if itemsize == 1:
            assert abs(m) < 2 ** 31 and abs(d) < 2 ** 31
        man, dot = man + m, dot + d
    return man, dot


def tiles(s, grid, rng):
    M = s["rows"].shape[0]
    t = grid["tile"]
    n = max(1, -(-M // t))
    return [list(range(b * t, min(b * t + t, M)))
            for b in rng.permutation(n)]


def stage_cap(s, grid):
    """The center rows a tile stages: the kernels' (PB.stage_cap of the
    rows' bytes) or the grid's budget."""
    length = s["rows"].shape[1] * s["itemsize"]
    return PB.stage_cap(length) if grid["cap"] is None else grid["cap"]


def add_row(s, jc, row, count, rng):
    """A tile's sums of center jc added into sc: an atomic a column, none
    for a zero, in any order."""
    acc = np.append(row, count)
    for v in rng.permutation(acc.shape[0]):
        if acc[v]:
            s["sc"][jc, v] += acc[v]


def model_band(s, grid, rng, drop_edge=False):
    """pb_band: tiles of grid["tile"] members in any order; each maps its
    assign through remap, takes its span of centers [min - delta, max +
    delta] over the members that count, stages it where it holds at most
    the budget's rows; a thread a (member, offset) pair in any order, its
    bit and, staged, its member's bit in the center's mask; then staged,
    each center of the span with a positive adds its masked members' rows
    (32-bit column sums for int8 and int16 counts, checked) and count;
    on the global path each positive adds its member's row and a count.
    With drop_edge the accumulator's rows stop one short of the span (a
    broken copy)."""
    C = s["c_idx"].shape[0]
    M, V = s["rows"].shape
    K, W, delta = 2 * s["delta"] + 1, PB.words(s["delta"]), s["delta"]
    cap = stage_cap(s, grid)
    s["best_d"][:] = np.inf
    s["best_pos"][:] = s["m_all"].shape[0]
    for tile in tiles(s, grid, rng):
        for m in tile:
            s["assign"][m] = s["remap"][s["assign"][m]]
        valid = [m for m in tile
                 if s["m_valid"] is None or bool(s["m_valid"][m])]
        asg = {m: int(s["assign"][m]) for m in valid}
        if valid:
            lo = max(0, min(asg.values()) - delta)
            span = min(C - 1, max(asg.values()) + delta) - lo + 1
        else:
            lo, span = 0, 0
        staged = span <= cap
        s["paths"][0 if staged else 1] += 1
        mask = np.zeros(max(span, 1), np.int64)
        bits = {m: np.zeros(W, np.uint32) for m in tile}
        pairs = [(t, oi) for t in range(len(tile)) for oi in range(K)]
        for i in rng.permutation(len(pairs)):
            t, oi = pairs[i]
            m = tile[t]
            if m not in asg:
                continue
            j = asg[m] + oi - delta
            if not (0 <= j < C and s["c_valid"][j]):
                continue
            if staged:
                assert lo <= j < lo + span
            a = int(s["c_idx"][j])
            man, dot = thread_sums(s["hist"][a], s["rows"][m],
                                   s["itemsize"])
            if classify(s, man, dot, a, s["m_idx"][m])[0]:
                bits[m][oi // 32] |= np.uint32(1 << (oi % 32))
                if staged:
                    mask[j - lo] |= 1 << t
        for m in tile:
            s["bits"][m] = bits[m]
        if not staged:
            for m in tile:
                for oi in range(K):
                    if (int(bits[m][oi // 32]) >> (oi % 32)) & 1:
                        add_row(s, asg[m] + oi - delta, s["rows"][m], 1, rng)
            continue
        for r in rng.permutation(span - 1 if drop_edge else span):
            members = [tile[t] for t in range(len(tile))
                       if (int(mask[r]) >> t) & 1]
            if not members:
                continue
            sums = s["rows"][members].sum(0)
            if s["itemsize"] <= 2:
                assert np.abs(sums).max() < 2 ** 31
            add_row(s, lo + r, sums, len(members), rng)


def positives(s, m):
    """Member m's positive offsets, in bit order."""
    return [oi for oi in range(2 * s["delta"] + 1)
            if (int(s["bits"][m, oi // 32]) >> (oi % 32)) & 1]


def mean_row(s, jc):
    """Center jc's floored mean, divided in float64 as mean_floor does, and
    its sum."""
    V = s["rows"].shape[1]
    count = np.float64(max(int(s["sc"][jc, V]), 1))
    cw = np.floor(s["sc"][jc, :V].astype(np.float64) / count).astype(
        np.int64)
    return cw, int(cw.sum())


def model_dist(s, grid, rng, assign_span=False):
    """pb_dist: the same tiles in any order; a tile's positives numbered
    member by member (each member's count, then a scan); its span of
    centers with a positive; staged where it holds at most the budget's
    rows: each flagged center's floored mean and its sum once, into rows
    that start as zeros, then a thread a positive in any order: d from its
    center's staged mean, the least d of each center a minimum of bit
    patterns, merged into best_d once a center; on the global path a
    positive divides its center's mean itself and takes best_d's minimum
    directly. With assign_span (a broken copy) the span is taken from the
    members' assign alone, without their offsets."""
    V = s["rows"].shape[1]
    delta = s["delta"]
    cap = stage_cap(s, grid)
    f8 = np.float64
    big = np.iinfo(np.int64).max

    def merge_least(jc, key):
        cur = int(s["best_d"][jc:jc + 1].view(np.int64)[0])
        s["best_d"][jc:jc + 1] = np.asarray([min(cur, key)], np.int64).view(
            np.float64)

    for tile in tiles(s, grid, rng):
        pairs = [(m, oi) for m in tile for oi in positives(s, m)]
        if assign_span:
            jcs = [int(s["assign"][m]) for m, _ in pairs]
        else:
            jcs = [int(s["assign"][m]) + oi - delta for m, oi in pairs]
        lo = min(jcs) if jcs else 0
        span = max(jcs) - lo + 1 if jcs else 0
        staged = span <= cap
        s["paths"][2 if staged else 3] += 1
        if staged:
            means = np.zeros((max(cap, 1), V), np.int64)
            totals = np.zeros(max(cap, 1))
            least = np.full(max(cap, 1), big)
            for m, oi in pairs:
                r = int(s["assign"][m]) + oi - delta - lo
                if 0 <= r < span:
                    means[r], totals[r] = mean_row(s, lo + r)
        for i in rng.permutation(len(pairs)):
            m, oi = pairs[i]
            jc = int(s["assign"][m]) + oi - delta
            if staged:
                r = jc - lo
                cw, cw_sum = ((means[r], totals[r]) if 0 <= r < cap
                              else (np.zeros(V, np.int64), 0.0))
            else:
                cw, cw_sum = mean_row(s, jc)
            dl = 2 * int(np.minimum(s["rows"][m], cw).sum())
            frac = f8(dl) / (f8(s["mag"][s["m_idx"][m]]) + f8(cw_sum))
            d = f8(10000.0) * (f8(1.0) - frac * frac)
            s["dstore"][oi, m] = d
            key = int(np.float64(d).view(np.int64))
            if staged and 0 <= r < cap:
                least[r] = min(least[r], key)
            else:
                merge_least(jc, key)
        if staged:
            for r in rng.permutation(min(span, cap)):
                if least[r] != big:
                    merge_least(lo + r, int(least[r]))


def sc_stores(c, Vp):
    """The word ranges of row c of sc [C, Vp] that a zero block's warp
    stores (sc's base 16-byte aligned): the head word where the row starts
    8 bytes past a 16-byte boundary, then 16-byte pairs, then a tail word
    where one is left; checked to cover the row once."""
    start = c * Vp
    head = start & 1
    pairs = (Vp - head) >> 1
    out = ([(0, 1)] if head else []) + [(head + 2 * p, head + 2 * p + 2)
                                        for p in range(pairs)]
    if (Vp - head) & 1:
        out.append((Vp - 1, Vp))
    assert sorted(w for a, b in out for w in range(a, b)) == list(range(Vp))
    assert all((start + a) % 2 == 0 for a, b in out if b - a == 2)
    return out


def model_pick(s, grid, rng, least=True, count_first=True):
    """pb_pick: its zero blocks (a warp a row of sc) and tie blocks (a
    thread a member) in any order, interleaved. A row's count is read
    first; a row with a count is cleared by sc_stores' pieces in any order
    (a row without one is zero throughout: checked). A member's positives
    in bit order (__ffs), d read from the offset-major dstore, the least
    pool position among the ties. Broken copies: with least False the
    greatest position; with count_first False the count word cleared
    before it is read."""
    C, Vp = s["sc"].shape
    M = s["rows"].shape[0]
    assert not s["sc"][s["sc"][:, Vp - 1] == 0].any()
    tasks = [(True, c) for c in range(C)] + [(False, m) for m in range(M)]
    for i in rng.permutation(len(tasks)):
        row, x = tasks[i]
        if row:
            stores = sc_stores(x, Vp)
            if not count_first:
                s["sc"][x, Vp - 1] = 0
            if s["sc"][x, Vp - 1] == 0:
                continue
            for q in rng.permutation(len(stores)):
                a, b = stores[q]
                s["sc"][x, a:b] = 0
            continue
        m = x
        a = int(s["assign"][m])
        for w in range(s["bits"].shape[1]):
            word = int(s["bits"][m, w])
            while word:
                oi = 32 * w + (word & -word).bit_length() - 1
                word &= word - 1
                jc = a + oi - s["delta"]
                if s["dstore"][oi, m] == s["best_d"][jc]:
                    pos = s["goff"] + int(m)
                    cur = s["best_pos"][jc]
                    s["best_pos"][jc] = min(cur, pos) if least else (
                        pos if cur == s["m_all"].shape[0] else max(cur, pos))


def merge_tile(s, grid):
    """The centers a block of pb_merge takes (a group of lanes_of lanes a
    center, kWarps groups' worth), or the grid's; and the slots it stages
    past them (min(delta, kMergeAhead), or the grid's)."""
    per = grid.get("centers") or (PB.THREADS // 32) * (32 // lanes_of(s,
                                                                    grid))
    ahead = grid.get("ahead")
    return per, min(s["delta"], MERGE_AHEAD if ahead is None else ahead)


def merge_block(s, b, per, ahead, lanes, shared, rng, publish_first):
    """Block b of pb_merge's model, a generator: each step yields True, or
    False where the look-back waits. Phase 1 stages its slots (the move,
    the valid flag) and takes t for its centers: the lanes split each
    candidate's row (lane_sums) and classify the offsets in turn, each lane
    keeping its first max of f1, then the group's butterfly keeps the
    greatest, the least offset on a tie; phase 2 publishes its counts,
    then its inclusive ones once the look-back has seen every earlier tile
    publish (walking back to the nearest inclusive one); phase 3 writes NP,
    t into t_row, remap where the chain ends inside the tile, the list, and
    the kept centers into their slots in place. With publish_first (a broken copy)
    the kept centers' moved center is read again for the compaction after
    the counts are published."""
    C = s["c_idx"].shape[0]
    M_all = s["m_all"].shape[0]
    delta = s["delta"]
    c_valid, best_pos, c_idx = s["c_valid"], s["best_pos"], s["c_idx"]
    desc, t_row = shared["desc"], shared["t_row"]

    def moved(j):
        bp = int(best_pos[j])
        return int(s["m_all"][bp]) if bp < M_all and c_valid[j] \
            else int(c_idx[j])

    base = b * per
    own = range(base, min(C, base + per))
    staged = {j: (moved(j), bool(c_valid[j]))
              for j in range(base, min(C, base + per + ahead))}

    def slot(j):
        return staged[j] if j in staged else (moved(j), bool(c_valid[j]))

    t = {}
    for i in rng.permutation(list(own)):
        i = int(i)
        ci, vi = staged[i]
        best = [(DBL_MIN, delta)] * lanes       # a lane's (f1, offset)
        for o0 in range(0, delta, lanes):
            for lane in range(min(lanes, delta - o0)):
                oi = o0 + lane
                j = i + oi + 1
                cj, ok = slot(j) if vi and j < C else (-1, False)
                if not ok:
                    continue
                sums = lane_sums(s["hist"][cj], s["hist"][ci], lanes,
                                 s["itemsize"])
                pos, f1 = classify(s, *sums, cj, ci)
                if pos and f1 > best[lane][0]:
                    best[lane] = (f1, oi)
        # the group's butterfly: the greatest f1, the least offset on a tie
        step = lanes >> 1
        while step:
            best = [max(best[q], best[q ^ step],
                        key=lambda x: (x[0], -x[1])) for q in range(lanes)]
            step >>= 1
        t[i] = i + best[0][1] + 1 if vi and best[0][1] < delta else i
    kept = [k for k in own if staged[k][1] and t[k] == k]
    n_valid = sum(staged[k][1] for k in own)
    yield True
    desc[b] = ("aggregate", len(kept), n_valid)
    yield True
    while True:
        ex_kept = ex_valid = 0
        for p in range(b - 1, -2, -1):
            d = ("inclusive", 0, 0) if p < 0 else desc[p]
            if d is None:
                break
            ex_kept += d[1]
            ex_valid += d[2]
            if d[0] == "inclusive":
                break
        if d is not None:
            break
        yield False
    desc[b] = ("inclusive", ex_kept + len(kept), ex_valid + n_valid)
    yield True
    np_of = {k: ex_kept + n for n, k in enumerate(kept)}
    for k in kept:
        shared["NP"][k] = np_of[k]
    for k in rng.permutation(list(own)):
        k = int(k)
        x = t[k]
        t_row[k] = x
        while x in t and t[x] != x:
            x = t[x]
        if x == k:
            s["remap"][k] = ex_kept + sum(1 for q in kept if q <= k) - 1
        elif x in t:
            s["remap"][k] = np_of[x]
        else:
            shared["list"].append(k)
        if k in np_of:
            c_idx[np_of[k]] = moved(k) if publish_first else staged[k][0]
            c_valid[np_of[k]] = True


def model_merge(s, it, grid, rng, follow=True, publish_first=False,
                late_first=False):
    """pb_merge: blocks of merge_tile's centers numbered in the order they
    start, their steps (merge_block) interleaved at random or, with
    late_first, the latest block able to go on first (its compaction lands
    before an earlier block's writes); then the last block: the listed
    chains followed to their ends (with follow False, a broken copy, one
    hop), remap = NP[T], the slots from the new kept total to the old
    cleared. Checks what the last block relies on: the valid centers a
    dense prefix, c_idx 0 past it. -> the chains listed."""
    C = s["c_idx"].shape[0]
    per, ahead = merge_tile(s, grid)
    n_valid = int(s["c_valid"].sum())
    assert s["c_valid"][:n_valid].all() and not s["c_idx"][n_valid:].any()
    n_tiles = max(1, -(-C // per))
    shared = dict(desc=[None] * n_tiles, t_row=np.arange(C), NP=s["np"],
                  list=[])
    blocks = [merge_block(s, b, per, ahead, lanes_of(s, grid), shared, rng,
                          publish_first) for b in range(n_tiles)]
    live = list(range(n_tiles))
    while live:
        order = sorted(live, reverse=True) if late_first else \
            [live[int(i)] for i in rng.permutation(len(live))]
        for b in order:
            try:
                moved_on = next(blocks[b])
            except StopIteration:
                live.remove(b)
                break
            if moved_on:
                break
    _, kept_total, valid_total = shared["desc"][-1]
    assert valid_total == n_valid
    s["c_idx"][kept_total:valid_total] = 0
    s["c_valid"][kept_total:valid_total] = False
    t_row = shared["t_row"]
    for q in rng.permutation(len(shared["list"])):
        k = shared["list"][int(q)]
        x = t_row[k]
        while follow and t_row[x] != x:
            x = t_row[x]
        s["remap"][k] = shared["NP"][x]
    s["t_hist"][it] = t_row
    return len(shared["list"])


MODELS = {"band": model_band, "dist": model_dist, "pick": model_pick,
          "merge": model_merge}
COMPARED = {"band": ("assign", "bits", "sc", "best_d", "best_pos"),
            "dist": ("dstore", "best_d"), "pick": ("best_pos", "sc"),
            "merge": ("c_idx", "c_valid", "remap")}


def same_as(s, pb, names):
    for name in names:
        got = s[name]
        want = getattr(pb, name).numpy()
        if name == "bits":
            want = want.view(np.uint32)
        if got.dtype == np.float64:
            got, want = got.view(np.int64), want.view(np.int64)
        if not np.array_equal(got, want):
            return name
    return None


def no_winner(pb, s):
    """Every center left without a best member before the merge (in the
    State and the model's copy): each moved center is read from c_idx."""
    pb.best_pos.fill_(pb.m_all.shape[0])
    s["best_pos"][:] = pb.m_all.shape[0]


def model_against_plain(be, members, assign, rows, delta, iterations, grid,
                        seed=0, mesh=None, late_first=False, before=None):
    """The model and the plain steps over `iterations` iterations from one
    State each; every value the next step reads compared after each step
    (with late_first, the merge's blocks latest first; before(pb, s) run
    on both before each merge). -> facts of the run: merges, non-monotone
    assign, centers with no positive, ties in d, the merge's listed chains
    and the model's tiles on each path (PB.PATHS)."""
    pb = be._phase_b_state(members, assign, rows, delta, iterations, mesh)
    s = numpy_state(pb)
    rng = np.random.default_rng(seed)
    step = PB.steps(True)
    V = pb.rows.shape[1]
    facts = dict(merges=0, non_monotone=False, empty_centers=0, ties=0,
                 listed=0)
    for it in range(iterations):
        for name in PB.STEPS:
            if name == "merge":
                if before is not None:
                    before(pb, s)
                facts["listed"] += model_merge(s, it, grid, rng,
                                               late_first=late_first)
                step.merge(pb, it)
                assert np.array_equal(s["t_hist"][it], pb.t_hist[it].numpy())
            else:
                MODELS[name](s, grid, rng)
                getattr(step, name)(pb)
            bad = same_as(s, pb, COMPARED[name])
            assert bad is None, f"iteration {it}, {name}: {bad} differs"
            if name == "band":
                facts["empty_centers"] += int(
                    (pb.c_valid & (pb.sc[:, V] == 0)).sum())
                facts["non_monotone"] |= bool(
                    (np.diff(pb.assign.numpy()) < 0).any())
            if name == "dist":
                d = pb.dstore.numpy().T[_positives(pb)]
                facts["ties"] += d.shape[0] - np.unique(d).shape[0]
        facts["merges"] += int((pb.t_hist[it].numpy()
                                != np.arange(rows.shape[0])).sum())
    facts.update(zip(PB.PATHS, s["paths"].tolist()))
    return facts


def _positives(pb):
    K = 2 * pb.delta + 1
    bits = pb.bits.numpy().view(np.uint32).astype(np.int64)
    return np.stack([(bits[:, oi // 32] >> (oi % 32)) & 1
                     for oi in range(K)], 1).astype(bool)


# -- tests ----------------------------------------------------------------------

CASES = {"int8": dict(dtype="int8"), "int16": dict(dtype="int16"),
         "int32": dict(dtype="int32"), "int8_dup": dict(dtype="int8", dup=3),
         "int8_close": dict(dtype="int8", seed=4, close=True)}


@pytest.fixture(scope="module")
def cases():
    return {name: species_case(device="cpu", **kw)
            for name, kw in CASES.items()}


@pytest.mark.parametrize("grid", ["own", "small", "one_lane"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_model_equals_plain_steps(cases, case, grid):
    """Every kernel's model against its plain step over 4 iterations at
    --delta 5; the runs merge, and where species interleave (int8_close)
    a merge passes over a kept center and assign is no longer monotone."""
    be, members, assign, rows = cases[case]
    facts = model_against_plain(be, members, assign, rows, 5, 4,
                                GRIDS[grid])
    assert facts["merges"]
    assert facts["non_monotone"] or case != "int8_close"
    if grid == "one_lane":
        assert facts["band_staged"] == 0 and facts["band_global"] > 0


@pytest.mark.parametrize("delta,cap", [(1, 3), (2, 5), (3, 7)])
def test_model_tiles_past_the_budget(cases, delta, cap):
    """A budget of 2 delta + 1 center rows and one more (the kernels stage
    up to 32): a tile whose members span more centers takes the global
    path while the others stage, in the same step, also after merges make
    assign non-monotone (--delta 2 and 3 where species interleave); both
    paths of both kernels run, and the model stays equal to the plain
    steps."""
    be, members, assign, rows = cases["int8_close"]
    facts = model_against_plain(be, members, assign, rows, delta, 4,
                                dict(SMALL, cap=cap))
    for path in PB.PATHS:
        assert facts[path] > 0, path
    assert facts["merges"]
    assert facts["non_monotone"] or delta == 1


@pytest.mark.parametrize("delta", [0, 1, 40])
def test_model_equals_plain_steps_at_other_deltas(cases, delta):
    """--delta 0 (one offset, no merge candidate), 1 and 40 (81 bits a
    member, three words, offsets past both ends of the centers)."""
    be, members, assign, rows = cases["int8_close"]
    assert 2 * delta + 1 <= 32 or PB.words(delta) == 3
    facts = model_against_plain(be, members, assign, rows, delta, 3, SMALL)
    assert facts["merges"] == 0 or delta > 0


def test_model_ties_across_tiles(cases):
    """Duplicated rows: equal d inside a tile and across the small grid's
    tiles of 8 members, the least pool position kept."""
    be, members, assign, rows = cases["int8_dup"]
    facts = model_against_plain(be, members, assign, rows, 5, 4, SMALL,
                                seed=7)
    assert facts["ties"] > 0


def test_model_center_with_no_positive(cases):
    """A center whose point is another species' (the last center's): no
    member of its pool classifies positive, so it keeps its row; its
    neighbours' pools still count."""
    be, members, assign, rows = cases["int8"]
    rows = rows.copy()
    rows[0] = rows[-1]
    facts = model_against_plain(be, members, assign, rows, 5, 3, SMALL)
    assert facts["empty_centers"] > 0


@pytest.mark.parametrize("ranks", [(2, 1), (3, 0), (5, 4)])
def test_model_equals_plain_steps_on_a_ranks_block(cases, ranks):
    """A rank's block of the pool (pool positions from goff, padding rows
    that never count), as under a mesh without the collectives."""
    be, members, assign, rows = cases["int16"]
    mesh = types.SimpleNamespace(size=ranks[0], rank=ranks[1])
    pb = be._phase_b_state(members, assign, rows, 5, 1, mesh)
    assert (pb.m_valid is not None) == (members.shape[0] % ranks[0] != 0)
    model_against_plain(be, members, assign, rows, 5, 3, SMALL, mesh=mesh)


def test_model_equals_plain_steps_with_one_center(cases):
    """C = 1: every member in one pool, no merge candidate."""
    be, members, _, rows = cases["int8"]
    facts = model_against_plain(be, members, np.zeros_like(members),
                                rows[:1], 5, 3, SMALL)
    assert facts["merges"] == 0


@pytest.mark.parametrize("grid", ["small", "one_lane"])
@pytest.mark.parametrize("delta", [3, 5])
def test_model_merge_in_place_latest_first(cases, delta, grid):
    """The merge with no center moved (each moved center read from c_idx,
    the slots the compaction overwrites) and its blocks latest first, so
    that later blocks compact into earlier blocks' slots before those
    blocks write: equal to the plain steps, with merges and with chains
    that leave their block (all of them at a center a block)."""
    be, members, assign, rows = cases["int8_close"]
    facts = model_against_plain(be, members, assign, rows, delta, 3,
                                GRIDS[grid], late_first=True,
                                before=no_winner)
    assert facts["merges"] and facts["listed"]


# Broken copies of the model: (case, delta, the copy's step, a hook run on
# both before each merge)
BROKEN = {
    # the least position turned into the greatest, on duplicated rows
    "pick": ("int8_dup", 5, ("pick", lambda s, g, r: model_pick(
        s, g, r, least=False)), None),
    # a row's count cleared before it is read: the row is left as it was
    "pick_count": ("int8", 5, ("pick", lambda s, g, r: model_pick(
        s, g, r, count_first=False)), None),
    # the listed chains left after one hop, where species interleave
    "merge": ("int8_close", 5, ("merge", lambda s, it, g, r: model_merge(
        s, it, g, r, follow=False)), None),
    # a block's counts published before its last read of c_idx (the kept
    # centers' moved center read again for the compaction), latest block
    # first, no center moved: a later block's compaction lands first
    "merge_publish": ("int8_close", 5, ("merge", lambda s, it, g, r:
                                        model_merge(s, it, g, r,
                                                    publish_first=True,
                                                    late_first=True)),
                      no_winner),
    # the band's accumulator one row short of the span: at --delta 0 the
    # span's last row is the tile's last center, which has positives
    "band_edge": ("int8", 0, ("band", lambda s, g, r: model_band(
        s, g, r, drop_edge=True)), None),
    # the dist's span from assign alone: positives at other offsets read
    # means outside it
    "dist_span": ("int8_close", 5, ("dist", lambda s, g, r: model_dist(
        s, g, r, assign_span=True)), None),
}


@pytest.mark.parametrize("which", sorted(BROKEN))
def test_a_broken_model_disagrees(cases, which):
    """Each broken copy of the model (BROKEN) differs from the plain steps,
    so the tests above do see the tie rule, the pick's read of a row's
    count, the chains, the merge's order of publishing and compacting, the
    span's edge rows and the offsets in the span."""
    case, delta, (broken, fn), before = BROKEN[which]
    be, members, assign, rows = cases[case]
    pb = be._phase_b_state(members, assign, rows, delta, 4)
    s = numpy_state(pb)
    rng = np.random.default_rng(0)
    step = PB.steps(True)
    differs = False
    for it in range(4):
        for name in PB.STEPS:
            model = fn if name == broken else MODELS[name]
            if name == "merge":
                if before is not None:
                    before(pb, s)
                model(s, it, SMALL, rng)
                step.merge(pb, it)
            else:
                model(s, SMALL, rng)
                getattr(step, name)(pb)
            if same_as(s, pb, COMPARED[name]) is not None:
                differs = True
                break
        if differs:
            break
    assert differs


def test_wrappers_on_cpu_are_the_plain_steps(cases):
    """On CPU tensors each wrapper is its plain step, bit for bit, and
    launches nothing; the fused loop through them equals plain=True."""
    be, members, assign, rows = cases["int8"]
    a, b = (be._phase_b_state(members, assign, rows, 5, 3)
            for _ in range(2))
    before = dict(_ext.launches)
    for it in range(3):
        for name in PB.STEPS:
            args = (it,) if name == "merge" else ()
            getattr(PB, name)(a, *args)
            getattr(PB, f"{name}_plain")(b, *args)
            for x in ("assign", "bits", "sc", "dstore", "best_d",
                      "best_pos", "c_idx", "c_valid", "remap"):
                assert torch.equal(getattr(a, x), getattr(b, x)), (name, x)
    assert _ext.launches == before
    for g, w in zip(be.phase_b_loop(members, assign, rows, 5, 3),
                    be.phase_b_loop(members, assign, rows, 5, 3,
                                    plain=True)):
        np.testing.assert_array_equal(g, w)


def test_state_refuses_what_the_kernels_do_not_take(cases):
    be, members, assign, rows = cases["int8"]
    pb = be._phase_b_state(members, assign, rows, 5, 1)
    args = (pb.model, pb.hist, pb.mag, pb.sq, pb.lenf, pb.rows, pb.m_idx,
            None, pb.m_all, 0, pb.assign, pb.c_idx, 5)
    PB.State(*args)
    with pytest.raises(ValueError, match="delta"):
        PB.State(*args[:-1], -1)
    with pytest.raises(ValueError, match="rows"):
        PB.State(*args[:5], pb.rows.to(torch.int16), *args[6:])
    with pytest.raises(ValueError, match="assign"):
        PB.State(*args[:10], pb.assign.to(torch.int32), *args[11:])


def test_source_constants_match_the_wrappers():
    """csrc/phase_b.cu's tile, its block, the stage's budget, the paths'
    slots, the scratch slots, DBL_MIN and words of bits, and the block size
    and piece of the header it includes, are ops/phase_b.py's; the stage's
    pitch and rows at the rows' widths."""
    src = ""
    for path in (SOURCE, HEADER):
        with open(path) as f:
            src += f.read()

    def const(name):
        return re.search(rf"\b{name} = ([^,;]+)[,;]", src).group(1).strip()

    assert int(const("kThreads")) == PB.THREADS
    assert int(const("kTile")) == PB.TILE == 32
    assert int(const("kTileThreads")) == PB.TILE_THREADS
    assert int(const("kStageBytes")) == PB.STAGE_BYTES
    assert int(const("kSpanRows")) == PB.SPAN_ROWS
    assert int(const("kChunkPieces")) == CHUNK_PIECES
    assert [int(const(k)) for k in ("kBandStaged", "kBandGlobal",
                                    "kDistStaged", "kDistGlobal")] == \
        [PB.PATHS.index(p) for p in ("band_staged", "band_global",
                                     "dist_staged", "dist_global")]
    assert int(const("kTicket")) == PB.TICKET
    assert int(const("kTiles")) == PB.TILES
    assert int(const("kMerged")) == PB.MERGED
    assert int(const("kScratchHead")) == PB.SCRATCH_HEAD
    assert int(const("kMergeAhead")) == MERGE_AHEAD
    assert int(const("kMergeLanesSmall")) == MERGE_LANES_SMALL == \
        SMALL["lanes"]
    assert int(const("kMergeLanesLarge")) == MERGE_LANES_LARGE
    assert int(const("kPieceBytes")) == PIECE_BYTES
    assert float(const("kDblMin")) == DBL_MIN
    assert src.count("(2 * delta + 1 + 31) / 32") == 1
    for delta in (0, 5, 15, 16, 40):
        assert PB.words(delta) == (2 * delta + 1 + 31) // 32
    # NP, the list and a descriptor a tile (at most C tiles)
    assert PB.scratch_len(7) == PB.SCRATCH_HEAD + 3 * 7
    # V = 256 counts of 1, 2, 4 and 8 bytes, 4 counts (k = 1), an odd slice
    assert [PB.stage_pitch(n) for n in (256, 512, 1024, 2048, 4, 129)] == \
        [272, 528, 1040, 0, 16, 144]
    assert [PB.stage_cap(n) for n in (256, 512, 1024, 2048)] == \
        [32, 32, 15, 0]
    assert PB.stage_cap(256, 11) == 11 and PB.stage_cap(256, 100) == 32

"""What the Phase B kernels (meshclust_tpu_torch/csrc/phase_b.cu) rely on,
checked on the CPU through a numpy model of their decomposition.

The kernels run only on a CUDA card. The model below replays each one with
its grid (blocks of a tile of members, run in a random order), its lane
groups and its reductions:
  pb_band   assign mapped through remap; a group of `lanes` lanes a member
            over its 2 delta + 1 offsets, the lane whose number is the
            offset's (mod lanes) keeping man and dot and classifying at the
            end of each chunk of `lanes` offsets (the float64 classifier
            read from ops/phase_a.Model's packed arrays), the chunk's bits
            shifted into 32-bit words; then offset by offset the tile's
            positives listed in member order, cut into runs of equal
            centers, one add a run and column into sc (none for a zero);
  pb_dist   the same lists and runs; a run's floored mean divided once a
            chunk of V (kCwBytes of the rows' dtype), the run's members
            served chunk by chunk, d in float64 (IEEE, no FMA), the run's
            least d added into best_d as a minimum of bit patterns;
  pb_pick   a thread a member, its positives in bit order (__ffs), the
            least pool position among the ties; sc zeroed in a grid stride;
  pb_merge  a group a center over its candidates in chunks of `lanes`, the
            first max of f1 taken lane by lane in order; the last block's
            chains followed in place (threads in a random order) until
            nothing changes, the kept centers scanned in chunks of the
            block with a carry, remap and the compaction.
The model is held equal, step by step and iteration by iteration, to the
plain steps (ops/phase_b.py, the port's Phase B torch ops), on species
corpora whose intercept splits species into several centers (Phase A's
centers, then merges that make assign non-monotone), with rows in int8,
int16 and int32, --delta 0, 5 and 40 (three words of bits), a rank's
padded block of the pool, C = 1, rows duplicated so that distances tie
inside a tile and across tiles, and centers with no positive; at the
kernels' own tile and lanes and at small ones (many tiles, one lane). A
copy of the model with the pick's tie rule turned around, or with the
merge chains left after one hop, must disagree. The wrappers on CPU tensors are the plain steps, and
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
from meshclust_tpu_torch.core.meanshift import _DBL_MIN
from meshclust_tpu_torch.ops import phase_b as PB
from test_torch_device_backend import host_scores, toy_model, toy_points

torch.set_num_threads(1)
os.environ.setdefault("MESHCLUST_QUIET", "1")
SOURCE = os.path.join(os.path.dirname(PB.__file__), "..", "csrc",
                      "phase_b.cu")
HEADER = os.path.join(os.path.dirname(SOURCE), "common.cuh")
# counts 1-12 scaled into each storage dtype of the rows
SCALES = {"int8": 1, "int16": 1000, "int32": 5000}
# pb_band's and pb_dist's tiles, lanes (None: the kernel's, from the rows'
# pieces), pb_merge's block
OWN = dict(tile=PB.TILE, dist_tile=PB.DIST_TILE, lanes=None,
           threads=PB.THREADS)
SMALL = dict(tile=8, dist_tile=16, lanes=4, threads=8)
ONE_LANE = dict(tile=5, dist_tile=5, lanes=1, threads=4)
CW_BYTES = 8192                       # common.cuh: kCwBytes
PIECE_BYTES = 16                      # common.cuh: kPieceBytes


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
    return s


def lanes_of(s, grid):
    """The lanes of a row's group: the kernel's (a power of two, at least
    the row's 16-byte pieces, up to 32), or the grid's."""
    if grid["lanes"] is not None:
        return grid["lanes"]
    nv = -(-s["rows"].shape[1] * s["itemsize"] // PIECE_BYTES)
    lanes = 1
    while lanes < nv and lanes < 32:
        lanes <<= 1
    return lanes


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


def offset_words(s, m, asg, lanes):
    """pb_band's words of member m (assign asg): the lane chunks, each
    lane's classification at its chunk's end, shifted in."""
    K, W, C = 2 * s["delta"] + 1, PB.words(s["delta"]), s["c_idx"].shape[0]
    mv = s["m_valid"] is None or bool(s["m_valid"][m])
    held = [None] * lanes
    out = np.zeros(W, np.uint32)
    word = shift = wi = 0
    b = s["m_idx"][m]
    for oi in range(K):
        j = asg + oi - s["delta"]
        ok = mv and 0 <= j < C and bool(s["c_valid"][j])
        a = int(s["c_idx"][j]) if ok else -1
        at = oi % lanes
        held[at] = (lane_sums(s["hist"][a], s["rows"][m], lanes,
                              s["itemsize"]) if ok else (0, 0), a)
        if at != lanes - 1 and oi != K - 1:
            continue
        chunk = 0
        for sub in range(at + 1):
            (man, dot), a_ = held[sub]
            if a_ >= 0 and classify(s, man, dot, a_, b)[0]:
                chunk |= 1 << sub
        word |= chunk << shift
        shift += lanes
        if shift == 32 or oi == K - 1:
            out[wi] = word
            word = shift = 0
            wi += 1
    return out


def runs_of(s, tile_members, oi, asg):
    """A tile's positives at offset oi in member order, cut into runs of
    equal centers: [(center, members)]."""
    listed = [m for m in tile_members
              if (int(s["bits"][m, oi // 32]) >> (oi % 32)) & 1]
    out = []
    for m in listed:
        jc = asg[m] + oi - s["delta"]
        if out and out[-1][0] == jc:
            out[-1][1].append(m)
        else:
            out.append((jc, [m]))
    return out


def tiles(s, grid, rng, key="tile"):
    M = s["rows"].shape[0]
    t = grid[key]
    n = max(1, -(-M // t))
    return [list(range(b * t, min(b * t + t, M)))
            for b in rng.permutation(n)]


def model_band(s, grid, rng):
    C = s["c_idx"].shape[0]
    V = s["rows"].shape[1]
    lanes = lanes_of(s, grid)
    s["best_d"][:] = np.inf
    s["best_pos"][:] = s["m_all"].shape[0]
    for tile in tiles(s, grid, rng):
        for m in tile:
            s["assign"][m] = s["remap"][s["assign"][m]]
        for m in tile:
            s["bits"][m] = offset_words(s, m, int(s["assign"][m]), lanes)
        for oi in range(2 * s["delta"] + 1):
            for jc, run in runs_of(s, tile, oi, s["assign"]):
                assert 0 <= jc < C
                acc = np.append(s["rows"][run].sum(0), len(run))
                for v in rng.permutation(V + 1):
                    if acc[v]:
                        s["sc"][jc, v] += acc[v]


def model_dist(s, grid, rng):
    V = s["rows"].shape[1]
    chunk = CW_BYTES // s["itemsize"]
    f8 = np.float64
    for tile in tiles(s, grid, rng, "dist_tile"):
        for oi in range(2 * s["delta"] + 1):
            for jc, run in runs_of(s, tile, oi, s["assign"]):
                count = f8(max(int(s["sc"][jc, V]), 1))
                dl = np.zeros(len(run), np.int64)
                cw_sum = 0
                for c0 in range(0, V, chunk):
                    c1 = min(V, c0 + chunk)
                    cw = np.floor(s["sc"][jc, c0: c1].astype(f8)
                                  / count).astype(np.int64)
                    cw_sum += int(cw.sum())
                    for i, m in enumerate(run):
                        dl[i] += 2 * int(np.minimum(
                            s["rows"][m, c0: c1], cw).sum())
                least = np.iinfo(np.int64).max
                for i, m in enumerate(run):
                    frac = f8(dl[i]) / (f8(s["mag"][s["m_idx"][m]])
                                        + f8(cw_sum))
                    d = f8(10000.0) * (f8(1.0) - frac * frac)
                    s["dstore"][m, oi] = d
                    least = min(least, int(np.float64(d).view(np.int64)))
                cur = int(s["best_d"][jc:jc + 1].view(np.int64)[0])
                s["best_d"][jc:jc + 1] = np.asarray(
                    [min(cur, least)], np.int64).view(np.float64)


def model_pick(s, grid, rng, least=True):
    s["sc"][:] = 0
    M = s["rows"].shape[0]
    for m in rng.permutation(M):
        a = int(s["assign"][m])
        for w in range(s["bits"].shape[1]):
            word = int(s["bits"][m, w])
            while word:
                oi = 32 * w + (word & -word).bit_length() - 1
                word &= word - 1
                jc = a + oi - s["delta"]
                if s["dstore"][m, oi] == s["best_d"][jc]:
                    pos = s["goff"] + int(m)
                    cur = s["best_pos"][jc]
                    s["best_pos"][jc] = min(cur, pos) if least else (
                        pos if cur == s["m_all"].shape[0] else max(cur, pos))


def model_merge(s, it, grid, rng, follow=True):
    C = s["c_idx"].shape[0]
    M_all = s["m_all"].shape[0]
    lanes = lanes_of(s, grid)
    delta = s["delta"]
    c_valid, best_pos, c_idx = s["c_valid"], s["best_pos"], s["c_idx"]

    def moved(j):
        bp = int(best_pos[j])
        return int(s["m_all"][bp]) if bp < M_all and c_valid[j] \
            else int(c_idx[j])

    t_row = np.arange(C)
    c_new = np.zeros(C, np.int64)
    for i in rng.permutation(C):
        vi, ci = bool(c_valid[i]), moved(i)
        best_f1, best_t = _DBL_MIN, i
        held = [None] * lanes
        for oi in range(delta):
            j = i + oi + 1
            ok = vi and j < C and bool(c_valid[j])
            cj = moved(j) if ok else -1
            at = oi % lanes
            held[at] = (lane_sums(s["hist"][cj], s["hist"][ci], lanes,
                                  s["itemsize"]) if ok else (0, 0), cj)
            if at != lanes - 1 and oi != delta - 1:
                continue
            got = [classify(s, *sums, a, ci) if a >= 0 else (False, 0.0)
                   for sums, a in held[: at + 1]]
            for lane, (pos, f1) in enumerate(got):
                if pos and f1 > best_f1:
                    best_f1, best_t = f1, i + (oi - at + lane) + 1
        t_row[i] = best_t if vi else i
        c_new[i] = ci
    s["t_hist"][it] = t_row
    T = t_row.copy()                       # the last block, in place
    while follow:
        changed = False
        for k in rng.permutation(C):
            a = T[k]
            if T[a] != a:
                T[k] = T[a]
                changed = True
        if not changed:
            break
    kept = c_valid & (t_row == np.arange(C))
    NP = np.zeros(C, np.int64)
    carry = 0
    for k0 in range(0, C, grid["threads"]):
        part = kept[k0: k0 + grid["threads"]].astype(np.int64)
        NP[k0: k0 + part.shape[0]] = carry + np.cumsum(part) - 1
        carry += int(part.sum())
    s["remap"][:] = NP[T]
    s["c_idx"][:] = 0
    s["c_idx"][NP[kept]] = c_new[kept]
    s["c_valid"][:] = np.arange(C) < carry


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


def model_against_plain(be, members, assign, rows, delta, iterations, grid,
                        seed=0, mesh=None):
    """The model and the plain steps over `iterations` iterations from one
    State each; every value the next step reads compared after each step.
    -> facts of the run: merges, non-monotone assign, centers with no
    positive, ties in d."""
    pb = be._phase_b_state(members, assign, rows, delta, iterations, mesh)
    s = numpy_state(pb)
    rng = np.random.default_rng(seed)
    step = PB.steps(True)
    V = pb.rows.shape[1]
    facts = dict(merges=0, non_monotone=False, empty_centers=0, ties=0)
    for it in range(iterations):
        for name in PB.STEPS:
            if name == "merge":
                MODELS[name](s, it, grid, rng)
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
                d = pb.dstore.numpy()[_positives(pb)]
                facts["ties"] += d.shape[0] - np.unique(d).shape[0]
        facts["merges"] += int((pb.t_hist[it].numpy()
                                != np.arange(rows.shape[0])).sum())
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
    facts = model_against_plain(
        be, members, assign, rows, 5, 4,
        {"own": OWN, "small": SMALL, "one_lane": ONE_LANE}[grid])
    assert facts["merges"]
    assert facts["non_monotone"] or case != "int8_close"


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


@pytest.mark.parametrize("which", ["pick", "merge"])
def test_a_broken_model_disagrees(cases, which):
    """The model with the pick's least position turned into the greatest
    (on the duplicated rows), or with the merge chains left after one hop
    (where species interleave), differs from the plain steps, so the tests
    above do see the tie rule and the chains."""
    be, members, assign, rows = cases["int8_dup" if which == "pick"
                                      else "int8_close"]
    pb = be._phase_b_state(members, assign, rows, 5, 4)
    s = numpy_state(pb)
    rng = np.random.default_rng(0)
    step = PB.steps(True)
    differs = False
    for it in range(4):
        for name in PB.STEPS:
            if name == "merge":
                model_merge(s, it, SMALL, rng, follow=which != "merge")
                step.merge(pb, it)
            elif name == "pick":
                model_pick(s, SMALL, rng, least=which != "pick")
                step.pick(pb)
            else:
                MODELS[name](s, SMALL, rng)
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
    """csrc/phase_b.cu's tile, scratch slots, DBL_MIN and words of bits,
    and the block size of the header it includes, are ops/phase_b.py's."""
    src = ""
    for path in (SOURCE, HEADER):
        with open(path) as f:
            src += f.read()

    def const(name):
        return re.search(rf"\b{name} = ([^,;]+)[,;]", src).group(1).strip()

    assert int(const("kThreads")) == PB.THREADS
    assert int(const("kTile")) == PB.TILE <= PB.THREADS
    assert const("kDistTile") == "kThreads" and PB.DIST_TILE == PB.THREADS
    assert int(const("kTicket")) == PB.TICKET
    assert int(const("kScratchHead")) == PB.SCRATCH_HEAD
    assert int(const("kCwBytes")) == CW_BYTES
    assert int(const("kPieceBytes")) == PIECE_BYTES
    assert float(const("kDblMin")) == _DBL_MIN
    assert src.count("(2 * delta + 1 + 31) / 32") == 3
    for delta in (0, 5, 15, 16, 40):
        assert PB.words(delta) == (2 * delta + 1 + 31) // 32
    assert PB.scratch_len(7) == PB.SCRATCH_HEAD + 3 * 7

"""The port's device Phase A (core/accumulate_device.py) on the CPU.

Against the JAX package's accumulate_device on the corpora of
tests/test_accum_device.py (species clones, and one where half the reads
duplicate their species' seed), against the port's own host path at
--id 0.90, and at --id 0.60 and 0.97 on lengths where the JAX package's
float32 window limits differ from the host path's float64 ones: there the
port follows the host path. The device-driven loop (chunks of CHUNK
iterations, read back once a chunk) against the host-driven loop it
replaced, on those corpora and on a Zipf(2) corpus of mostly singletons,
with phases that end on, before and just after a chunk's end; and pa_next's
plain step against the host loop's decisions. Every comparison is exact:
the same centers with the same members in the same order.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from meshclust_tpu_torch import convert
from meshclust_tpu_torch.core import classify as C
from meshclust_tpu_torch.core import accumulate_device as A
from meshclust_tpu_torch.core.bvec import BVec
from meshclust_tpu_torch.core.meanshift import MeanShift
from meshclust_tpu_torch.ops import phase_a as P
from tests.conftest import mutate, random_dna
from tests.test_torch_device_backend import shifted, toy_model, toy_points

torch.set_num_threads(1)


def strict_weights(ps, params):
    """params' weights with the intercept raised to the median score of
    pairs within a species (headers sp<s>_c<c>), which splits species into
    several centers."""
    from tests.test_torch_device_backend import host_scores
    species = np.asarray([h[1:].split("_")[0] for h in ps.headers])
    hb = C.HostBackend(ps, params)
    intra = []
    for c in np.unique(species, return_index=True)[1]:
        same = np.flatnonzero(species == species[c])
        intra.append(host_scores(hb, int(c), same[same != c]))
    w = params.weights.copy()
    w[0] -= np.median(np.concatenate(intra))
    return w


def with_weights(params, w):
    return dataclasses.replace(params, weights=np.asarray(w, np.float64))


def jax_points(rng, n_species=8, per=10, length=400, rate=0.03,
               duplicates=False, sizes=None):
    """The JAX package's PointSet of test_accum_device's corpus (n_species
    random species, per clones each, or sizes[s] clones in species s,
    every other clone an exact copy of the species' seed with
    `duplicates`, records shuffled) and a classifier trained on it by the
    port's Trainer (sample 120, --id 0.90), as the JAX package's
    FeatureParams."""
    from meshclust_tpu.core.points import build_points
    from meshclust_tpu.io import fasta
    from meshclust_tpu.ops.features import FeatureParams
    from meshclust_tpu_torch.core.trainer import Trainer
    seqs = []
    sizes = [per] * n_species if sizes is None else sizes
    for s, per in enumerate(sizes):
        base = random_dna(rng, length + (0 if duplicates
                                         else int(rng.integers(-20, 20))))
        for c in range(per):
            keep = c == 0 or (duplicates and c % 2 == 0)
            seq = base if keep else mutate(rng, base, rate)
            seqs.append(fasta.encode_record(f">sp{s}_c{c}", seq.encode()))
    order = rng.permutation(len(seqs))
    jps = build_points([seqs[i] for i in order], k=4, use_pallas=False)
    ps = convert.pointset_from_numpy(jps.hist, jps.mag, jps.sq, jps.lengths,
                                     jps.one_mers, jps.codes, jps.headers,
                                     jps.k, device="cpu")
    p = Trainer(ps, n_points=120, cutoff=0.90, max_pts_from_one=20,
                k=4).train(97.5).params
    return jps, FeatureParams(p.singles, p.mins, p.maxs, p.is_sim, p.combos,
                              p.weights)


def port_case(jps, jparams):
    """The port's PointSet and params of a JAX PointSet and params."""
    ps = convert.pointset_from_numpy(jps.hist, jps.mag, jps.sq, jps.lengths,
                                     jps.one_mers, jps.codes, jps.headers,
                                     jps.k, device="cpu")
    params = convert.params_from_numpy(
        jparams.singles, jparams.mins, jparams.maxs, jparams.is_sim,
        jparams.combos, jparams.weights)
    return ps, params


def port_bv(ps, bin_size=20):
    bv = BVec(ps.lengths.copy(), bin_size)
    for i in range(ps.n):
        bv.insert(i, int(ps.lengths[i]))
    bv.insert_finalize()
    return bv


def listed(centers):
    return [(c.center, list(c.members)) for c in centers]


CORPORA = {
    "species": dict(seed=1234),
    "species_wide": dict(seed=12, n_species=6, per=9, length=350,
                         rate=0.08),
    "duplicates": dict(seed=99, n_species=4, per=8, length=300, rate=0.05,
                       duplicates=True),
}


@pytest.fixture(scope="module", params=sorted(CORPORA))
def corpus(request):
    kw = dict(CORPORA[request.param])
    jps, jparams = jax_points(np.random.default_rng(kw.pop("seed")), **kw)
    return jps, jparams, port_case(jps, jparams)


def test_accumulate_equals_jax(corpus):
    from meshclust_tpu.core.accumulate_device import accumulate_device
    from meshclust_tpu.core.bvec import BVec as JBVec
    jps, jparams, (ps, params) = corpus
    jbv = JBVec(jps.lengths.copy(), 20)
    for i in range(jps.n):
        jbv.insert(i, int(jps.lengths[i]))
    jbv.insert_finalize()
    want = listed(accumulate_device(jps, jbv, jparams, 0.90))
    got = listed(A.accumulate_device(ps, port_bv(ps), params, 0.90))
    assert len(want) >= 4
    assert any(len(m) > 1 for _, m in want)
    assert got == want


@pytest.mark.parametrize("backend", ["host", "device_get_close"])
def test_accumulate_equals_host_path(corpus, backend):
    """The port's host Phase A (MeanShift._accumulate_one over the bvec),
    with HostBackend or with DeviceBackend's get_close."""
    _, _, (ps, params) = corpus
    be = C.HostBackend(ps, params) if backend == "host" \
        else C.DeviceBackend(ps, params)
    if backend != "host":
        be.supports_device_accumulate = False
    want = listed(MeanShift(ps, be, sim=0.90, delta=3, iterations=1)
                  .accumulate_all(port_bv(ps)))
    got = listed(A.accumulate_device(ps, port_bv(ps), params, 0.90))
    assert got == want
    assert sorted(m for _, ms in got for m in ms) == list(range(ps.n))


def test_index_of_equals_bvec():
    rng = np.random.default_rng(2)
    bv = BVec(np.sort(rng.integers(50, 400, size=97)), 10)
    x = rng.integers(0, 450, size=300)
    low, high = A.index_of(x, bv.begin_bounds)
    want = np.asarray([bv._index_of(int(v)) for v in x])
    np.testing.assert_array_equal(low, want[:, 0])
    np.testing.assert_array_equal(high, want[:, 1])


def divergent_lengths(sim, lo, hi):
    """Lengths in [lo, hi) whose float32 window limits (the JAX package's
    device Phase A) differ from int(L * sim), int(L / sim)."""
    L = np.arange(lo, hi, dtype=np.int64)
    f = L.astype(np.float32)
    lo32 = np.floor(f * np.float32(sim)).astype(np.int64)
    hi32 = np.floor(f / np.float32(sim)).astype(np.int64)
    lo64, hi64 = A.window_limits(L, sim)
    return L[(lo32 != lo64) | (hi32 != hi64)]


# (sim, range to search for divergent lengths): the upper limit at 0.60
# differs at read lengths, the lower one at 0.97 only past ~135 kb
EDGES = {0.60: (700, 1300), 0.97: (135000, 136500)}


@pytest.mark.parametrize("sim", sorted(EDGES))
def test_window_limits_follow_host_path(sim):
    L = divergent_lengths(sim, *EDGES[sim])
    assert L.shape[0] > 0
    lo, hi = A.window_limits(L, sim)
    assert lo.tolist() == [int(int(v) * sim) for v in L]
    assert hi.tolist() == [int(int(v) / sim) for v in L]


def edge_points(sim, n=160, seed=4):
    """Toy points whose lengths sit at the divergent lengths of `sim`, at
    their float64 window limits and one off them; rows come in near-copies
    so that some pairs classify positive."""
    L = divergent_lengths(sim, *EDGES[sim])[:12]
    lo, hi = A.window_limits(L, sim)
    pool = np.unique(np.concatenate([L, lo, lo - 1, lo + 1, hi, hi - 1,
                                     hi + 1]))
    rng = np.random.default_rng(seed)
    hist, _, _, _, params = toy_model(n=n, seed=seed)
    hist[1::2] = hist[0::2] + rng.integers(0, 2, size=hist[0::2].shape)
    lens = rng.choice(pool, size=n)
    mag = hist.astype(np.int64).sum(1)
    sq = (hist.astype(np.int64) ** 2).sum(1)
    return toy_points(hist, mag, sq, lens), params


@pytest.mark.parametrize("sim", sorted(EDGES))
def test_window_bounds_equal_get_range(sim):
    """Every live slot's device window equals the host bvec's
    get_range(int(L * sim), int(L / sim)) window, with a third of the
    slots removed from both."""
    ps, params = edge_points(sim)
    bv = port_bv(ps, bin_size=7)
    s = A._Slots(ps, bv, params, sim)
    slot_of = np.empty(ps.n, np.int64)
    slot_of[s.point] = np.arange(ps.n)
    rng = np.random.default_rng(5)
    for p in rng.choice(ps.n, size=ps.n // 3, replace=False):
        b = next(i for i, ids in enumerate(bv.idx) if p in ids)
        bv.erase(b, int(np.flatnonzero(bv.idx[b] == p)[0]))
        s.active[slot_of[p]] = False
    active = s.active.numpy()
    checked = 0
    for slot in np.flatnonzero(active):
        length = int(ps.lengths[s.point[slot]])
        want, _ = bv.window(*bv.get_range(int(length * sim),
                                          int(length / sim)))
        w0, w1 = (int(w) for w in s.window_bounds(torch.tensor(slot)))
        sl = np.arange(ps.n)
        got = s.point[(sl >= w0) & (sl <= w1) & active]
        np.testing.assert_array_equal(got, want)
        checked += 1
    assert checked > 50


@pytest.mark.parametrize("sim,q", [(0.60, None), (0.60, 0.9), (0.97, None),
                                   (0.97, 0.8)])
def test_accumulate_at_window_edges_equals_host_path(sim, q):
    """q: the intercept moved as test_torch_device_backend.shifted does
    (a stricter classifier, more centers and windows)."""
    ps, params = edge_points(sim)
    params, _ = shifted(params, ps, q)
    want = listed(MeanShift(ps, C.HostBackend(ps, params), sim=sim, delta=3,
                            iterations=1).accumulate_all(port_bv(ps, 7)))
    got = listed(A.accumulate_device(ps, port_bv(ps, 7), params, sim))
    assert any(len(m) > 1 for _, m in want)
    assert got == want


def test_counters_and_cmax_hint():
    from meshclust_tpu_torch.utils import perf
    ps, params = edge_points(0.60, n=40)
    perf.reset()
    full = A.accumulate_device(ps, port_bv(ps, 7), params, 0.60)
    got = perf.counters()
    perf.reset()
    assert got["accum_centers"] == len(full)
    assert got["accum_iters"] >= len(full)
    assert got["accum_device_iters"] == got["accum_iters"]
    assert got["accum_replays"] == -(-got["accum_iters"] // A.CHUNK)
    assert got["accum_readbacks"] == got["accum_replays"] + 1 \
        <= got["accum_iters"] + 1
    cut = A.accumulate_device(ps, port_bv(ps, 7), params, 0.60, cmax_hint=3)
    assert listed(cut) == listed(full)[:3]


def _scalar_reads(fn):
    """How many times fn() reads a tensor's value back to the host (the
    aten::_local_scalar_dense behind .item(), bool(), int() and indexing
    with a 0-dim tensor); .tolist() and .cpu() are not counted."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages()
               if e.key == "aten::_local_scalar_dense")


def test_one_readback_an_iteration():
    """Phase A reads back once a chunk of iterations (its .tolist()) and
    nothing else (its rows are widened by their storage dtype, no count
    read); Phase B never until its end. On the card each hidden read would
    be a sync."""
    ps, params = edge_points(0.97)
    params, _ = shifted(params, ps, 0.8)
    assert _scalar_reads(lambda: A.accumulate_device(
        ps, port_bv(ps, 7), params, 0.97)) == 0
    centers = A.accumulate_device(ps, port_bv(ps, 7), params, 0.97)
    members = np.asarray([m for c in centers for m in c.members], np.int64)
    assign = np.repeat(np.arange(len(centers)),
                       [len(c.members) for c in centers])
    rows = np.asarray([c.center for c in centers], np.int64)
    db = C.DeviceBackend(ps, params)
    assert _scalar_reads(lambda: db.phase_b_loop(members, assign, rows, 5,
                                                 3)) == 0


def host_driven(ps, bv, params, sim, cmax=0):
    """Phase A as the host drove it before its control moved onto the
    device, over the plain steps: each iteration's four scalars read back,
    and the host choosing to move the center, end it, seed the next or
    stop. -> (owner, stamp, active, center slots, iterations)."""
    sl = A._Slots(ps, bv, params, sim, plain=True)
    N = sl.N
    cmax = cmax or N + 1
    center_slot, t, seed, iters = [], 0, 0, 0
    sl.active[:1] = False
    while True:
        sl.begin(seed, len(center_slot), t)
        t += 1
        while True:
            sl.st[P.T] = t
            sl.window()
            sl.sweep()
            sl.absorb_step()
            n_pos, best, last, live = sl.st[: P.LIVE + 1].tolist()
            t += 1
            iters += 1
            if n_pos == 0:
                break
            sl.move_step()
        center_slot.append(last)
        seed = best if best < N else live
        if seed >= N or len(center_slot) >= cmax:
            break
        sl.active[seed] = False
    return (sl.owner.numpy(), sl.stamp.numpy(), sl.active.numpy(),
            np.asarray(center_slot, np.int64), iters)


@functools.lru_cache(maxsize=None)
def zipf_points(n=220, seed=6):
    """port_case of jax_points' corpus in species whose sizes are Zipf(2)
    draws of at most 12 (most of them singletons): -> (points, params,
    sizes)."""
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(min(rng.zipf(2.0), 12, n - sum(sizes))))
    return (*port_case(*jax_points(rng, sizes=sizes)), sizes)


def _phase_case(name):
    if name == "zipf":
        ps, params, sizes = zipf_points()
        assert sum(s == 1 for s in sizes) > len(sizes) / 2
        return ps, params, 0.90
    sim, q = {"edge_0.60_strict": (0.60, 0.9), "edge_0.97": (0.97, None),
              "edge_0.97_strict": (0.97, 0.8)}[name]
    ps, params = edge_points(sim)
    return ps, shifted(params, ps, q)[0], sim


@pytest.mark.parametrize("end", ["default", "on", "before", "after"])
@pytest.mark.parametrize("name", ["edge_0.60_strict", "edge_0.97",
                                  "edge_0.97_strict", "zipf"])
def test_chunked_loop_equals_host_driven_loop(name, end, monkeypatch):
    """accumulate_device's chunks (the plain steps on the CPU, as a graph's
    replays run the kernels) against the host-driven loop: owner, stamp,
    active, center slots and iterations equal, bit for bit. CHUNK set so
    that the phase ends on a chunk's last iteration, one before it, or on
    the first iteration of a new chunk (past the end each chunk's
    iterations change nothing); the device counted every iteration."""
    from meshclust_tpu_torch.utils import perf
    ps, params, sim = _phase_case(name)
    owner, stamp, active, center_slot, iters = host_driven(
        ps, port_bv(ps, 7), params, sim)
    assert iters > len(center_slot) >= 4
    if end != "default":
        monkeypatch.setattr(A, "CHUNK", {"on": iters, "before": iters + 1,
                                         "after": iters - 1}[end])
    state = {}
    perf.reset()
    centers = A.accumulate_device(ps, port_bv(ps, 7), params, sim,
                                  state=state)
    got = perf.counters()
    perf.reset()
    for key, want in (("owner", owner), ("stamp", stamp), ("active", active),
                      ("center_slot", center_slot)):
        np.testing.assert_array_equal(state[key], want, err_msg=key)
    assert got["accum_iters"] == got["accum_device_iters"] == iters
    assert got["accum_centers"] == len(centers) == len(center_slot)
    assert got["accum_replays"] == {"on": 1, "before": 1, "after": 2}.get(
        end, -(-iters // A.CHUNK))
    if name == "zipf":
        assert sum(len(c.members) == 1 for c in centers) > len(centers) / 2
        assert max(len(c.members) for c in centers) > 3


@pytest.mark.parametrize("cmax", [1, 3])
def test_chunked_loop_cut_at_cmax_equals_host_driven_loop(cmax):
    ps, params, sim = _phase_case("zipf")
    owner, stamp, active, center_slot, _ = host_driven(
        ps, port_bv(ps, 7), params, sim, cmax)
    state = {}
    A.accumulate_device(ps, port_bv(ps, 7), params, sim, cmax_hint=cmax,
                        state=state)
    assert len(center_slot) == cmax
    for key, want in (("owner", owner), ("stamp", stamp), ("active", active),
                      ("center_slot", center_slot)):
        np.testing.assert_array_equal(state[key], want, err_msg=key)


def next_state(n=6, c=2, t=9, npos=0, best=4, live=1, done=0, count=3):
    """A state at an iteration's end: center c (its slot 3) with `count`
    members, absorb stamp t, the window's best and first live slots; the
    slot arrays of n slots, rows [n, 3] int8; cmax-free."""
    st, _ = P.new_state(n, "cpu")
    st[[P.NPOS, P.BEST, P.LAST, P.LIVE, P.COUNT]] = torch.tensor(
        [npos, best, 3, live, count])
    st[[P.DONE, P.ITERS, P.C, P.MEMBERS, P.T]] = torch.tensor(
        [done, 40, c, 11, t])
    arrays = dict(
        active=torch.tensor([False, True, True, False, True, True][:n]),
        owner=torch.tensor([0, -1, -1, 2, -1, -1][:n]),
        stamp=torch.tensor([0, 0, 0, 5, 0, 0][:n]),
        rows=torch.arange(3 * n, dtype=torch.int8).reshape(n, 3),
        sumvec=torch.tensor([7, 8, 9]),
        center_slot=torch.full((n + 1,), -5))
    return st, arrays


def host_next(st, a, cmax):
    """The host loop's decisions at an iteration's end (host_driven), on
    copies: -> (st, arrays) after them."""
    st = st.clone()
    a = {k: v.clone() for k, v in a.items()}
    n = a["active"].shape[0]
    if st[P.DONE]:
        return st, a
    st[P.ITERS] += 1
    t = int(st[P.T]) + 1
    st[P.T] = t
    if st[P.NPOS]:
        return st, a
    c = int(st[P.C])
    a["center_slot"][c] = st[P.LAST]
    st[P.MEMBERS] += st[P.COUNT]
    st[P.C] = c + 1
    best, live = int(st[P.BEST]), int(st[P.LIVE])
    seed = best if best < n else live
    if seed >= n or c + 1 >= cmax:
        st[P.DONE] = 1
        return st, a
    a["active"][seed] = False
    a["owner"][seed] = c + 1
    a["stamp"][seed] = t
    a["sumvec"][:] = a["rows"][seed]
    st[P.LAST], st[P.COUNT], st[P.T] = seed, 1, t + 1
    return st, a


NEXT_CASES = {
    "absorbed": (dict(npos=2), 99),
    "seed_best": (dict(), 99),
    "seed_first_live": (dict(best=6, live=1), 99),
    "no_seed": (dict(best=6, live=6), 99),
    "cmax": (dict(), 3),
    "cmax_not_yet": (dict(), 4),
    "done": (dict(done=1), 99),
    "done_absorbed": (dict(done=1, npos=2), 99),
}


@pytest.mark.parametrize("case", sorted(NEXT_CASES))
def test_next_plain_equals_host_decisions(case):
    """pa_next's plain step (through its CPU wrapper) against the host
    loop's decisions: a seed from the window's best, else the first live
    slot, else done; the cmax cut; nothing once done; st[T] spent once, or
    twice where a center begins."""
    kw, cmax = NEXT_CASES[case]
    st, a = next_state(**kw)
    want_st, want = host_next(st, a, cmax)
    P.next(st, a["active"], a["owner"], a["stamp"], a["rows"], a["sumvec"],
           a["center_slot"], cmax)
    assert st.tolist() == want_st.tolist()
    for k in a:
        assert torch.equal(a[k], want[k]), k
    begins = case in ("seed_best", "seed_first_live", "cmax_not_yet")
    assert int(st[P.T]) == {True: 11, False: 10}[begins] \
        or case.startswith("done")
    assert bool(st[P.DONE]) == (case in ("no_seed", "cmax")
                                or case.startswith("done"))

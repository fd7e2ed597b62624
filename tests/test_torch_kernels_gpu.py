"""The port's CUDA kernels against their plain PyTorch versions, on a GPU,
and the paths through them (DeviceAligner, k-mer mode, align mode) and the
float64 device classifier (DeviceBackend, Phase A, Phase B) against the
same on the CPU.

Run on a machine with a CUDA GPU and nvcc (tests/conftest.py imports jax,
which such a machine may lack, and nothing here needs it):
    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu
Without CUDA every test skips. Tolerance: exact equality (integer outputs,
float64 decisions and f1).
"""
import numpy as np
import pytest
import torch

from meshclust_tpu_torch import _ext
from meshclust_tpu_torch.ops import align as A
from meshclust_tpu_torch.ops import align_device as AD
from meshclust_tpu_torch.ops import histogram as H
from meshclust_tpu_torch.io import fasta as fio
import ref_impl  # tests/ is on sys.path under pytest (no __init__.py)

pytestmark = pytest.mark.gpu
LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _records(seed, n, lo, hi, n_frac=0.0, short=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n + short):
        L = int(rng.integers(lo, hi + 1)) if i < n else int(
            rng.integers(4, 20))
        raw = LETTERS[rng.integers(0, 4, size=L)].copy()
        if i < n and rng.random() < n_frac:
            p = int(rng.integers(0, L - 60))
            raw[p: p + int(rng.integers(3, 40))] = ord("N")
        out.append(fio.encode_record(f">r{i}", raw.tobytes()))
    return out


def _kernel_equals_plain(cuda, flat, k, split):
    t = [torch.from_numpy(a).to(cuda) for a in flat]
    before = _ext.launches["kmer_hist"]
    got = H.kmer_hist(*t, k, split=split)
    assert _ext.launches["kmer_hist"] == before + 1
    want = H.kmer_hist_plain(*t, k)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)


@pytest.mark.parametrize("k,n_frac,short", [(1, 0.0, 0), (2, 0.0, 0),
                                            (3, 0.0, 0), (4, 0.0, 0),
                                            (6, 0.0, 0), (7, 0.0, 0),
                                            (8, 0.0, 0), (5, 0.5, 20)])
def test_kmer_hist_kernel_equals_plain(cuda, k, n_frac, short):
    """Reads with N runs and records under 20 bp, and the schedule model's
    edge corpus at the kernel's own shape (lengths at its block, step and
    cluster-share edges, segments that touch or are shorter than k, record
    offsets off the 16-byte grid), in rows and in split mode."""
    from test_torch_kmer_schedule import OWN, corpus, edge_lengths
    seqs = _records(k, 300, 100, 1100, n_frac, short)
    edges = edge_lengths(**OWN) + [[(0, 30), (40, 90)],
                                   [(0, 49), (50, 99), (100, 180)],
                                   [(3, 5), (20, 60)], 10500]
    for split in (False, True):
        _kernel_equals_plain(cuda, H.flat_inputs(seqs), k, split)
        _kernel_equals_plain(cuda, corpus(k, edges, lead=3), k, split)


def test_device_aligner_cuda_equals_cpu(cuda):
    rng = np.random.default_rng(4)
    codes = [rng.integers(0, 4, size=int(rng.integers(5, 300))).astype(
        np.uint8) for _ in range(40)]
    pairs = [(int(rng.integers(40)), int(rng.integers(40)))
             for _ in range(200)]
    got = AD.DeviceAligner(codes, cuda).identities(pairs)
    want = AD.DeviceAligner(codes, "cpu").identities(pairs)
    np.testing.assert_array_equal(got, want)


def test_run_cuda_equals_cpu(cuda, tmp_path):
    from test_torch_end2end import run_port, write_corpus
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.runner import run
    fasta = write_corpus(tmp_path / "c.fasta", 2, True)
    want = run_port(fasta, str(tmp_path / "cpu.clstr"))
    out = str(tmp_path / "gpu.clstr")
    _ext.reset_launches()
    run(ClusterConfig(files=[fasta], similarity=0.90, output=out,
                      sample_size=300), device=cuda)
    assert _ext.launches["kmer_hist"] > 0
    assert _ext.launches["nw_align_long"] > 0
    with open(out, "rb") as f:
        assert f.read() == want


# l1 and l2 at the edges of the kernel's threads (R rows), warps (32 R rows)
# and strips (S rows)
_R, _S = AD.ROWS_PER_THREAD, AD.STRIP_ROWS
STRIP_EDGES = [1, 2, _R - 1, _R, _R + 1, 32 * _R - 1, 32 * _R, 32 * _R + 1,
               _S - 1, _S, _S + 1, 2 * _S, 2 * _S + 1]


def _staged(lens, seed, n_frac=0.03):
    rng = np.random.default_rng(seed)
    mat = np.zeros((len(lens), H.round_up(int(max(lens)), 128)), np.int8)
    for i, L in enumerate(lens):
        c = rng.integers(0, 4, size=int(L)).astype(np.int8)
        c[rng.random(int(L)) < n_frac] = 78
        mat[i, :L] = c
    return mat, torch.from_numpy(mat), torch.from_numpy(
        np.asarray(lens, np.int32))


def test_nw_align_long_kernel_equals_plain_and_oracle(cuda):
    rng = np.random.default_rng(8)
    lens = np.concatenate([rng.integers(1, 3001, size=40), STRIP_EDGES,
                           [3000, 5]]).astype(np.int64)
    mat, codes, lens_t = _staged(lens, 9)
    codes, lens_t = codes.to(cuda), lens_t.to(cuda)
    n = lens.shape[0]
    edges = list(range(40, 40 + len(STRIP_EDGES)))
    ia = list(rng.integers(0, n, size=120))
    ib = list(rng.integers(0, n, size=120))
    for e in edges:                      # strip edges as l1 and as l2
        ia += [e, e, int(rng.integers(0, 40))]
        ib += [int(rng.integers(0, 40)), e, e]
    ia += [n - 2, n - 1]                 # l1 >> l2 and l2 >> l1
    ib += [n - 1, n - 2]
    ia, ib = np.asarray(ia), np.asarray(ib)
    ia_t = torch.from_numpy(ia.astype(np.int32)).to(cuda)
    ib_t = torch.from_numpy(ib.astype(np.int32)).to(cuda)
    before = _ext.launches["nw_align_long"]
    got = AD.nw_align_long(codes, lens_t, ia_t, ib_t, int(lens[ib].max()))
    assert _ext.launches["nw_align_long"] == before + 1
    want = A.align_counts_plain(codes, lens_t, ia_t, ib_t)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    small = [t for t in range(ia.shape[0])
             if lens[ia[t]] * lens[ib[t]] <= 40000]
    for t in small[::max(1, len(small) // 12)]:
        _, el, em, _ = ref_impl.glob_align(mat[ia[t], : lens[ia[t]]],
                                           mat[ib[t], : lens[ib[t]]])
        assert (int(got[0][t]), int(got[1][t])) == (el, em)


def test_nw_align_long_kernel_flags_l2_beyond_boundary_rows(cuda):
    codes = torch.zeros((2, 128), dtype=torch.int8, device=cuda)
    lens = torch.tensor([100, 50], dtype=torch.int32, device=cuda)
    idx = torch.tensor([0], dtype=torch.int32, device=cuda)
    alen, amatch = AD.nw_align_long(codes, lens, idx, idx + 1, max_l2=40)
    assert int(alen[0]) == -1 and int(amatch[0]) == -1


def test_device_aligner_long_pairs_cuda_equals_cpu(cuda):
    """Short pairs and pairs past the JAX package's short-kernel gate
    (l1 > 8,192) in one call: the kernel launches, and the identities equal
    the CPU run's."""
    rng = np.random.default_rng(6)
    codes = [rng.integers(0, 4, size=int(rng.integers(5, 300))).astype(
        np.uint8) for _ in range(30)]
    codes += [rng.integers(0, 4, size=int(L)).astype(np.uint8)
              for L in (8193, 8300, 8400)]
    pairs = [(int(rng.integers(30)), int(rng.integers(30)))
             for _ in range(80)]
    pairs += [(30 + k, int(rng.integers(30))) for k in range(3)]   # long
    pairs += [(int(rng.integers(30)), 30 + k) for k in range(3)]   # short
    before = dict(_ext.launches)
    got = AD.DeviceAligner(codes, cuda).identities(pairs)
    assert _ext.launches["nw_align_long"] > before["nw_align_long"]
    want = AD.DeviceAligner(codes, "cpu").identities(pairs)
    np.testing.assert_array_equal(got, want)


def test_run_align_mode_cuda_equals_cpu(cuda, tmp_path):
    from test_torch_align_mode import write_mix
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.runner import run
    fasta = write_mix(tmp_path / "mix.fasta", 3, 4, 8, 160, 0.12, 0.22)
    outs = {}
    for name, d in (("cpu", "cpu"), ("gpu", cuda)):
        outs[name] = str(tmp_path / f"{name}.clstr")
        _ext.reset_launches()
        res = run(ClusterConfig(files=[fasta], similarity=0.50,
                                output=outs[name]), device=d)
    assert res["model"].k == 0
    assert _ext.launches["kmer_hist"] > 0
    assert _ext.launches["nw_align_long"] > 0
    with open(outs["gpu"], "rb") as a, open(outs["cpu"], "rb") as b:
        assert a.read() == b.read()


def test_device_backend_cuda_equals_host(cuda):
    """DeviceBackend on the card against HostBackend on the host, on the
    toy classifier as trained and with scores shifted to within 1e-12 of
    0, at counts whose products fit int32 and at counts that need int64:
    decisions and f1 bit-equal. Then Phase A and the fused Phase B on the
    card against the same on the CPU (which the CPU tests hold to the host
    path): the same centers, members and merge history."""
    from test_torch_device_backend import (CENTERS, SHIFTS, shifted,
                                           toy_model, toy_points)
    from meshclust_tpu_torch.core import classify as C
    from meshclust_tpu_torch.core.accumulate_device import accumulate_device
    from meshclust_tpu_torch.core.bvec import BVec
    rng = np.random.default_rng(3)
    for scale in (1, 5000):
        hist, mag, sq, lens, trained = toy_model(scale=scale)
        host = toy_points(hist, mag, sq, lens)
        card = toy_points(hist, mag, sq, lens, device=cuda)
        window = np.arange(host.n)
        for q in SHIFTS:
            params, _ = shifted(trained, host, q)
            hb = C.HostBackend(host, params)
            db = C.DeviceBackend(card, params)
            for center in CENTERS:
                want_pos, want_f1 = hb.classify(center, window)
                got_pos, got_f1 = db.classify(center, window)
                np.testing.assert_array_equal(got_pos, want_pos)
                assert np.array_equal(got_f1, want_f1)
            a = rng.integers(0, host.n, size=200)
            b = rng.integers(0, host.n, size=200)
            got_pos, got_f1 = db.classify_pairs(a, b)
            for t in range(a.shape[0]):
                want_pos, want_f1 = hb.classify(int(a[t]), b[t: t + 1])
                assert got_pos[t] == want_pos[0]
                assert got_f1[t] == want_f1[0]
        params, _ = shifted(trained, host, 0.5)
        out = {}
        for name, ps in (("cpu", host), ("cuda", card)):
            bv = BVec(ps.lengths.copy(), 40)
            bv.bulk_insert(ps.lengths)
            bv.insert_finalize()
            centers = accumulate_device(ps, bv, params, 0.90)
            members = np.asarray([m for c in centers for m in c.members])
            assign = np.repeat(np.arange(len(centers)),
                               [len(c.members) for c in centers])
            rows = np.asarray([c.center for c in centers])
            loop = C.DeviceBackend(ps, params).phase_b_loop(
                members, assign, rows, 5, 4)
            out[name] = ([(c.center, c.members) for c in centers], loop)
        assert out["cuda"][0] == out["cpu"][0]
        for g, w in zip(out["cuda"][1], out["cpu"][1]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [2, 3])
def test_collectives_of_ranks_sharing_one_card(cuda, n):
    """parallel/dist's collectives on CUDA tensors, n ranks on one card
    (gloo, since NCCL refuses two ranks on one device): the values numpy
    gives on the same inputs."""
    import torch_dist_ranks as R
    from meshclust_tpu_torch.parallel import dist
    from test_torch_dist import OPS, SEED, want
    if torch.cuda.device_count() != 1:
        pytest.skip("ranks share a card only where there is one")
    outs = dist.launch(R.collectives, n, None, SEED)
    for r, out in enumerate(outs):
        assert (out["rank"], out["backend"], out["device"]) == \
            (r, "gloo", "cuda:0")
        for op in OPS:
            for dtype in sorted(R.DTYPES):
                expect = want(op, dtype, n)
                if isinstance(expect, str):
                    assert out[op, dtype] == expect
                else:
                    np.testing.assert_array_equal(out[op, dtype], expect)


# -- Phase A (csrc/phase_a.cu) -------------------------------------------------

# toy counts scaled into each storage dtype of the rows the kernels read
PHASE_A_SCALES = {"int8": 1, "int16": 1000, "int32": 5000}


def _phase_a_case(scale, device, n=512):
    """Toy points on `device` whose counts are `scale` times 1-12, and the
    toy classifier with its intercept moved to the median score, so that
    some pairs classify positive and rows duplicate (f1 and d tie)."""
    from test_torch_device_backend import shifted, toy_model, toy_points
    hist, mag, sq, lens, trained = toy_model(n=n, scale=scale)
    params, _ = shifted(trained, toy_points(hist, mag, sq, lens), 0.5)
    arrays = {"hist": hist, "mag": mag, "sq": sq, "lengths": lens,
              "one_mers": np.zeros((n, 4), np.int64),
              "codes": [np.zeros(0, np.uint8)] * n,
              "headers": [f">s{i}" for i in range(n)], "k": 4}
    return toy_points(hist, mag, sq, lens, device=device), params, arrays


def _bvec(ps, bin_size=40):
    """The bvec that torch_dist_ranks.phase_a builds."""
    from meshclust_tpu_torch.core.bvec import BVec
    bv = BVec(ps.lengths.copy(), bin_size)
    for i in range(ps.n):
        bv.insert(i, int(ps.lengths[i]))
    bv.insert_finalize()
    return bv


def _listed(centers):
    return [(c.center, list(c.members)) for c in centers]


def phase_a_lockstep(ps, params, sim, bv):
    """Phase A driven as accumulate_device drives it, each step
    by the plain _Slots and by the kernels' _Slots on the same card, every
    value the next step reads compared bit for bit (the state buffer with
    the loop's slots, active, owner, stamp, sumvec, the center slots; the
    sums of the window's live slots; the members' distances), until the
    done flag; then one more iteration, which changes nothing. ->
    (iterations, launches of each kernel)."""
    from meshclust_tpu_torch.core import accumulate_device as A
    from meshclust_tpu_torch.ops import phase_a as P
    plain = A._Slots(ps, bv, params, sim, plain=True)
    kern = A._Slots(ps, bv, params, sim, plain=False)
    assert kern.h.dtype == ps.hist_dev.dtype
    both, N = (plain, kern), plain.N
    names = ("active", "owner", "stamp", "sumvec", "center_slot")

    def same(*names):
        for name in names:
            assert torch.equal(getattr(plain, name), getattr(kern, name)), \
                name
        for a, b in ((0, P.COUNT + 1), (P.DONE, P.T + 1)):
            assert torch.equal(plain.st[a: b], kern.st[a: b])

    before = dict(_ext.launches)
    for sl in both:
        sl.active[:1] = False
        sl.begin(0, 0, 0)
    iters = 0
    while not int(kern.st[P.DONE]):
        for sl in both:
            sl.window()
            sl.sweep()
        same("active")
        w0, w1 = kern.st[P.W0: P.W1 + 1].tolist()
        live = torch.nonzero(kern.active[w0: w1 + 1]).flatten() + w0
        assert torch.equal(plain.sums[:, live], kern.sums[:, live])
        for sl in both:
            sl.absorb_step()
        same("active", "owner", "stamp", "sumvec")
        moved = int(kern.st[P.NPOS]) > 0
        iters += 1
        for sl in both:
            sl.move(None)
        if moved:
            members = torch.nonzero(kern.owner == kern.st[P.C]).flatten()
            assert torch.equal(plain.dist[members], kern.dist[members])
            assert torch.equal(plain.dist[N], kern.dist[N])
        same()
        assert not kern.st[P.TICKET: P.MOVE + 1].any()
        for sl in both:
            sl.next_step()
        same(*names)
    assert int(kern.st[P.ITERS]) == iters
    assert int(kern.st[P.MEMBERS]) == N
    ended = [getattr(kern, x).clone() for x in names + ("st",)]
    for sl in both:
        sl.iteration()
    same(*names)
    for x, want in zip(names + ("st",), ended):
        assert torch.equal(getattr(kern, x), want), x
    return iters, {k: _ext.launches[k] - before[k] for k in _ext.launches}


CHAIN = ("pa_window", "pa_sums", "pa_absorb", "pa_move", "pa_next")


@pytest.mark.parametrize("dtype", sorted(PHASE_A_SCALES))
def test_phase_a_kernels_equal_plain_steps(cuda, dtype):
    """Each Phase A kernel against its plain step on the card, iteration
    by iteration, with the rows in each storage dtype, through the done
    flag and one iteration past it: the five kernels of the chain launch
    once an iteration."""
    ps, params, _ = _phase_a_case(PHASE_A_SCALES[dtype], cuda)
    assert ps.hist_dev.dtype == getattr(torch, dtype)
    iters, launched = phase_a_lockstep(ps, params, 0.90, _bvec(ps))
    assert {launched[k] for k in CHAIN} == {iters + 1}


def _device_kernels(fn) -> dict:
    """Launches of each Phase A kernel that the card ran in fn() (graph
    replays included), read from torch.profiler's device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(CHAIN, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k in CHAIN:
                if f"{k}_kernel" in e.name:
                    out[k] += 1
    return out


@pytest.mark.parametrize("dtype", sorted(PHASE_A_SCALES))
def test_phase_a_on_the_card_equals_plain_and_cpu(cuda, dtype):
    """The whole Phase A through the kernels, CHUNK iterations a replay of
    a CUDA graph, against plain=True on the card and the CPU path: the same
    owner, stamp, active and center slots, the same iterations, and so the
    same centers with the same members in the same order. The card runs
    the five kernels of the chain once an iteration, CHUNK a replay, once
    more each before the capture; the host launches them only into the
    capture and reads back once a replay and once at the end."""
    from meshclust_tpu_torch.core import accumulate_device as A
    from meshclust_tpu_torch.utils import perf
    ps, params, arrays = _phase_a_case(PHASE_A_SCALES[dtype], cuda)
    host, _, _ = _phase_a_case(PHASE_A_SCALES[dtype], "cpu")
    perf.reset()
    _ext.reset_launches()
    state = {}
    ran = _device_kernels(lambda: state.setdefault("centers", _listed(
        A.accumulate_device(ps, _bvec(ps), params, 0.90, state=state))))
    c = perf.counters()
    replays = c["accum_replays"]
    assert replays == -(-c["accum_iters"] // A.CHUNK) >= 2
    assert c["accum_device_iters"] == c["accum_iters"]
    assert c["accum_readbacks"] == replays + 1
    assert {_ext.launches[k] for k in CHAIN} == {A.CHUNK + 1}
    assert ran == dict.fromkeys(CHAIN, A.CHUNK * replays + 1)
    for other, plain in ((ps, True), (host, None)):
        want = {}
        perf.reset()
        centers = _listed(A.accumulate_device(other, _bvec(other), params,
                                              0.90, plain=plain, state=want))
        assert perf.counters()["accum_iters"] == c["accum_iters"]
        assert centers == state["centers"]
        for key in ("owner", "stamp", "active", "center_slot"):
            np.testing.assert_array_equal(state[key], want[key],
                                          err_msg=key)


# pa_next's cases: (the state's n_pos, best, first live slot, done; cmax)
# for 6 slots, center 2 at slot 3 (with_state below)
PA_NEXT = {"absorbed": (2, 4, 1, 0, 99), "seed_best": (0, 4, 1, 0, 99),
           "seed_first_live": (0, 6, 1, 0, 99), "no_seed": (0, 6, 6, 0, 99),
           "cmax": (0, 4, 1, 0, 3), "done": (0, 4, 1, 1, 99)}


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "int64"])
@pytest.mark.parametrize("case", sorted(PA_NEXT))
def test_pa_next_kernel_equals_plain(cuda, case, dtype):
    """pa_next against next_plain, one launch: the state buffer, active,
    owner, stamp, sumvec (a seed's row widened from each storage dtype)
    and the center slots equal, for each of the loop's decisions."""
    from meshclust_tpu_torch.ops import phase_a as P
    npos, best, live, done, cmax = PA_NEXT[case]
    n = 6
    out = {}
    for kernel in (True, False):
        st, _ = P.new_state(n, cuda)
        st[[P.NPOS, P.BEST, P.LAST, P.LIVE, P.COUNT]] = torch.tensor(
            [npos, best, 3, live, 3], device=cuda)
        st[[P.DONE, P.ITERS, P.C, P.MEMBERS, P.T]] = torch.tensor(
            [done, 40, 2, 11, 9], device=cuda)
        a = [torch.tensor([False, True, True, False, True, True],
                          device=cuda),
             torch.tensor([0, -1, -1, 2, -1, -1], device=cuda),
             torch.tensor([0, 0, 0, 5, 0, 0], device=cuda),
             (torch.arange(3 * n, device=cuda).reshape(n, 3) * 7 - 20).to(
                 getattr(torch, dtype)),
             torch.tensor([7, 8, 9], device=cuda),
             torch.full((n + 1,), -5, dtype=torch.int64, device=cuda)]
        if kernel:
            before = _ext.launches["pa_next"]
            P.next(st, *a, cmax)
            assert _ext.launches["pa_next"] == before + 1
        else:
            P.next_plain(st, *a, cmax)
        out[kernel] = [st] + a
    for got, want in zip(out[True], out[False]):
        assert torch.equal(got, want)


def test_phase_a_at_two_ranks_sharing_the_card(cuda):
    """Phase A at 2 ranks on the one card (gloo), each rank running the
    whole phase through the graphed chain: every rank's centers equal one
    rank's, every iteration the device's, one readback a replay and no
    collective."""
    import torch_dist_ranks as R
    from meshclust_tpu_torch.core.accumulate_device import (
        CHUNK, accumulate_device)
    from meshclust_tpu_torch.parallel import dist
    if torch.cuda.device_count() != 1:
        pytest.skip("ranks share a card only where there is one")
    cases, want = [], []
    for dtype in sorted(PHASE_A_SCALES):
        ps, params, arrays = _phase_a_case(PHASE_A_SCALES[dtype], cuda)
        want.append(_listed(accumulate_device(ps, _bvec(ps), params, 0.90)))
        cases.append((arrays, params, 40, 0.90))
    outs = dist.launch(R.phase_a, 2, None, cases)
    for out in outs:
        for res, w in zip(out, want):
            c = res["counters"]
            assert res["centers"] == w
            assert {res["launches"][k] for k in CHAIN} == {CHUNK + 1}
            assert c["accum_device_iters"] == c["accum_iters"]
            assert c["accum_readbacks"] == c["accum_replays"] + 1
            assert c.get("coll_accumulate", 0) == 0


def _window_slots(sizes, lens, sim, begin_bounds):
    """pa_window's inputs for slots in bins of `sizes` (lengths
    non-decreasing): the plain step's per-slot arrays and the table, as
    core/accumulate_device._Slots builds them, on the CPU."""
    from meshclust_tpu_torch.core import accumulate_device as A
    lo, hi = A.window_limits(lens, sim)
    front = A.index_of(lo, begin_bounds)[0]
    back = A.index_of(hi, begin_bounds)[1]
    plain_in = tuple(torch.as_tensor(np.asarray(a, np.int64)) for a in (
        np.repeat(np.arange(len(sizes)), sizes), lens, lo, hi, front, back))
    return plain_in, torch.as_tensor(
        A.window_ranges(lens, sizes, lo, hi, front, back))


def _windows_equal_plain(cuda, plain_in, ranges, centers, masks):
    """pa_window, one launch a center, against window_plain for each
    center under each mask in turn (each a subset of the one before, st
    carried over as in a phase): w0, w1, the first and the last live
    slot."""
    from meshclust_tpu_torch.ops import phase_a as P
    n = ranges.shape[0]
    dev_in = tuple(t.to(cuda) for t in plain_in)
    ranges = ranges.to(cuda)
    st, _ = P.new_state(n, cuda)
    launches = _ext.launches["pa_window"]
    for act in masks:
        active = torch.as_tensor(act).to(cuda)
        tail = int(np.flatnonzero(act)[-1]) if act.any() else -1
        for c in centers:
            want, _ = P.new_state(n, cuda)
            want[P.LAST] = st[P.LAST] = int(c)
            P.window_plain(want, active, *dev_in)
            P.window(st, active, ranges)
            keys = [P.W0, P.W1, P.LIVE]
            assert st[keys].tolist() == want[keys].tolist(), (c, act.sum())
            assert int(st[P.TAIL]) == tail
    assert _ext.launches["pa_window"] == launches + len(masks) * len(centers)


def test_pa_window_kernel_equals_plain_small_corpus(cuda):
    """The small corpus's slots (bins of 40): every center slot under
    random masks that shrink to all dead."""
    from meshclust_tpu_torch.core import accumulate_device as A
    ps, params, _ = _phase_a_case(1, "cpu")
    bv = _bvec(ps)
    sl = A._Slots(ps, bv, params, 0.90)
    rng = np.random.default_rng(11)
    act = rng.random(sl.N) < 0.7
    masks = [np.ones(sl.N, bool), act, act & (rng.random(sl.N) < 0.2),
             np.zeros(sl.N, bool)]
    _windows_equal_plain(cuda, sl.window_in, sl.ranges, range(sl.N), masks)


def test_pa_window_kernel_equals_plain_150k_slots(cuda):
    """150,000 synthetic slots in bins of 1,000 (lengths 800-1,250 bp, the
    default bin size, --id 0.90) at 400 random centers under masks that
    shrink from 90% to 0.45% live and to none, the flags at an odd
    address too."""
    rng = np.random.default_rng(12)
    n = 150000
    lens = np.sort(rng.integers(800, 1250, size=n))
    plain_in, ranges = _window_slots([1000] * (n // 1000), lens, 0.90,
                                     lens[::1000].tolist())
    masks = [rng.random(n) < 0.9]
    for p in (0.1, 0.05, 0.0):
        masks.append(masks[-1] & (rng.random(n) < p))
    centers = rng.integers(0, n, size=400)
    _windows_equal_plain(cuda, plain_in, ranges, centers, masks)
    from meshclust_tpu_torch.ops import phase_a as P
    odd = torch.zeros(n + 1, dtype=torch.bool, device=cuda)[1:]
    odd.copy_(torch.as_tensor(masks[1]))
    st, _ = P.new_state(n, cuda)
    want, _ = P.new_state(n, cuda)
    for c in centers[:50]:
        st[P.LAST] = want[P.LAST] = int(c)
        P.window(st, odd, ranges.to(cuda))
        P.window_plain(want, odd, *(t.to(cuda) for t in plain_in))
        assert st[:P.W1 + 1].tolist() == want[:P.W1 + 1].tolist()


# pa_move's rows: (V, dtype, counts drawn from, a column slice [start,
# stop) or None); V * width past the kernel's 8 KB of the mean in shared
# memory takes chunks
PA_MEMBER_ROWS = {
    "k1_int8": (4, torch.int8, np.arange(128), None),
    "int8": (256, torch.int8, np.arange(128), None),
    "int8_odd_slice": (256, torch.int8, np.arange(128), (171, 256)),
    "int8_chunked_V16384": (16384, torch.int8, np.arange(128), None),
    "int16": (256, torch.int16, np.array([0, 1, 300, 32767]), None),
    "int16_odd_slice": (100, torch.int16, np.arange(300), (33, 100)),
    "int32": (256, torch.int32, np.arange(0, 46341, 97), None),
    "int64": (256, torch.int64, np.arange(0, 10 ** 6, 999), None),
    "int64_chunked_V2048": (2048, torch.int64, np.arange(0, 10 ** 6, 999),
                            None),
}


# pa_move's ties: members of center 5 whose rows are t, the floored mean,
# in three tiles of 1,024 owners (d = 0, the least), and their stamps
TWINS = [20, 1050, 1051, 1500, 2990]
TIES = {"least slot": ([2] * 5, 20), "least stamp": ([3, 2, 2, 2, 2], 1050),
        "least stamp, last tile": ([3, 2, 2, 2, 1], 2990)}


def _move_inputs(cuda, case, aligned, n=3000, c=5):
    """Rows of PA_MEMBER_ROWS[case] (or its column slice) and the members
    of c: a run of neighbouring slots (1,000-1,099), pairs at slots 300,
    2,200 and 2,998 and TWINS, in the three tiles. Every member's row is
    t +- e in pairs, so that the mean is t, and TWINS' rows are t: their d
    is 0, the least, and they tie. Other slots belong to other centers;
    owner at a 16-byte address or not."""
    V, dtype, pool, cols = PA_MEMBER_ROWS[case]
    rng = np.random.default_rng(V + 2)
    full = torch.as_tensor(rng.choice(pool, size=(n, V))).to(dtype).to(cuda)
    rows = full if cols is None else full[:, cols[0]: cols[1]]
    own = rng.integers(0, 9, size=n)
    own[own == c] = c + 1
    pairs = [(x, x + 1) for x in list(range(1000, 1100, 2)) + [300, 2200,
                                                                 2998]]
    pairs = [p for p in pairs if p != (1050, 1051)]
    t = rows[0].to(torch.int64).clamp(1, int(pool.max()) - 1)
    for a, b in pairs:
        e = torch.as_tensor(rng.integers(0, 2, size=t.shape[0])).to(cuda)
        rows[a] = (t + e).to(dtype)
        rows[b] = (t - e).to(dtype)
        own[[a, b]] = c
    rows[TWINS] = t.to(dtype)
    own[TWINS] = c
    base = torch.full((n + 1,), -1, dtype=torch.int64, device=cuda)
    owner = base[:n] if aligned else base[1:]
    owner.copy_(torch.as_tensor(own))
    stamp = torch.as_tensor(rng.integers(5, 10, size=n)).to(cuda)
    mag = rows.to(torch.int64).sum(1).to(torch.float64)
    members = torch.nonzero(owner == c).flatten()
    st, part = P_.new_state(n, cuda)
    st[P_.COUNT], st[P_.C], st[P_.NPOS] = members.numel(), c, 1
    sumvec = rows[members].to(torch.int64).sum(0)
    assert torch.equal(sumvec, t * members.numel())
    return st, part, owner, c, rows, sumvec, mag, stamp, members


from meshclust_tpu_torch.ops import phase_a as P_  # noqa: E402


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", sorted(PA_MEMBER_ROWS))
def test_pa_move_kernel_equals_plain(cuda, case, aligned):
    """pa_move against move_plain, one launch each time: st[LAST], the
    members' distances and sum cw equal, the other slots keep what they held, and
    the kernel's counters are back at 0; TWINS tie in d across three
    blocks, their stamps set in turn so that the least slot, the least
    stamp, and the least stamp in the last tile win."""
    st, part, owner, c, rows, sumvec, mag, stamp, members = _move_inputs(
        cuda, case, aligned)
    n = owner.shape[0]
    mask = torch.zeros(n + 1, dtype=torch.bool, device=cuda)
    mask[members] = True
    mask[n] = True
    for stamps, want_last in TIES.values():
        stamp[TWINS] = torch.tensor(stamps, device=cuda)
        got = torch.full((n + 1,), -7, dtype=torch.int64, device=cuda)
        want = torch.zeros(n + 1, dtype=torch.int64, device=cuda)
        st_p = st.clone()
        before = _ext.launches["pa_move"]
        P_.move(st, owner, rows, sumvec, mag, stamp, got, part)
        assert _ext.launches["pa_move"] == before + 1
        P_.move_plain(st_p, owner, rows, sumvec, mag, stamp, want, part)
        assert torch.equal(got[mask], want[mask])
        assert bool((got[~mask] == -7).all())
        assert torch.equal(st, st_p)
        assert int(st[P_.LAST]) == want_last
        assert not st[P_.TICKET: P_.MOVE + 1].any()


def test_device_aligner_unstaged_small_budget_equals_cpu(cuda, monkeypatch):
    """stage_mb = 0 (each launch packs its own pairs' sequences) and a
    boundary budget of four pairs at l2 = 400 (the short records' longest):
    the kernel launches as launch_cuts cuts the sorted pairs (dozens of
    launches, the 9 kb record's pairs alone), and the identities equal the
    CPU run's."""
    rng = np.random.default_rng(7)
    codes = [rng.integers(0, 4, size=int(rng.integers(5, 400))).astype(
        np.uint8) for _ in range(40)]
    codes.append(rng.integers(0, 4, size=9000).astype(np.uint8))
    pairs = [(int(rng.integers(41)), int(rng.integers(41)))
             for _ in range(120)] + [(40, 3), (5, 40)]
    total = torch.cuda.mem_get_info(cuda)[1]
    monkeypatch.setattr(AD, "BOUNDARY_SHARE", 4 * 36 * 401 / total)
    before = _ext.launches["nw_align_long"]
    al = AD.DeviceAligner(codes, cuda, stage_mb=0)
    got = al.identities(pairs)
    assert al._staged is None
    lens = np.asarray([len(c) for c in codes])
    ia, ib = (np.asarray(x) for x in zip(*pairs))
    cuts = AD.launch_cuts(lens[ib][np.argsort(lens[ia] + lens[ib],
                                              kind="stable")],
                          AD.BOUNDARY_SHARE * AD.device_memory_mb(cuda)
                          * 2 ** 20)
    assert _ext.launches["nw_align_long"] - before == len(cuts) - 1 >= 20
    want = AD.DeviceAligner(codes, "cpu").identities(pairs)
    np.testing.assert_array_equal(got, want)


# pa_sums on rows at the edges of its pieces and byte SIMD: (V, dtype,
# counts drawn from, a rank's column slice [start, stop) of the rows or
# None); V = 65,536 at 127 is int8's largest dot within 32 bits
PA_SUMS_ROWS = {
    "k1_int8": (4, torch.int8, np.arange(128), None),
    "int8_0_1_127": (256, torch.int8, np.array([0, 1, 127]), None),
    "int8_V65536_at_127": (65536, torch.int8, np.array([127]), None),
    "int8_V1024": (1024, torch.int8, np.arange(128), None),
    "int8_odd_slice": (256, torch.int8, np.arange(128), (171, 256)),
    "int8_even_slice": (256, torch.int8, np.arange(128), (86, 171)),
    "int16_extremes": (256, torch.int16, np.array([0, 1, 32767]), None),
    "int16_odd_slice": (100, torch.int16, np.arange(300), (33, 100)),
    "int32": (256, torch.int32, np.arange(0, 46341, 97), None),
    "int64": (256, torch.int64, np.arange(0, 10 ** 6, 999), None),
}


@pytest.mark.parametrize("with_dot", [True, False])
@pytest.mark.parametrize("case", sorted(PA_SUMS_ROWS))
def test_pa_sums_kernel_equals_plain(cuda, case, with_dot):
    """pa_sums against sums_plain on the live slots of a window, one
    launch; the slots outside the window or not live keep what they
    held."""
    from meshclust_tpu_torch.ops import phase_a as P
    V, dtype, pool, cols = PA_SUMS_ROWS[case]
    rng = np.random.default_rng(V)
    n = 300
    full = torch.as_tensor(rng.choice(pool, size=(n, V))).to(dtype).to(cuda)
    rows = full if cols is None else full[:, cols[0]: cols[1]]
    active = torch.as_tensor(rng.random(n) < 0.8).to(cuda)
    st, _ = P.new_state(n, cuda)
    st[P.W0], st[P.W1], st[P.LAST] = 3, n - 5, 7
    k = 2 if with_dot else 1
    got = torch.full((k, n), -7, dtype=torch.int64, device=cuda)
    before = _ext.launches["pa_sums"]
    P.sums(st, active, rows, got)
    assert _ext.launches["pa_sums"] == before + 1
    want = torch.zeros((k, n), dtype=torch.int64, device=cuda)
    P.sums_plain(st, active, rows.to(torch.int64), want)
    live = torch.zeros(n, dtype=torch.bool, device=cuda)
    live[3: n - 4] = active[3: n - 4]
    assert torch.equal(got[:, live], want[:, live])
    assert bool((got[:, ~live] == -7).all())


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("window", ["empty", "one_slot", "all"])
def test_pa_absorb_kernel_equals_plain(cuda, window, nan):
    """pa_absorb against absorb_plain on an empty window, a one-slot
    window and a window of all N, with three slots whose rows and length
    equal the center's (their f1 ties at the maximum: the least slot wins)
    and, with `nan`, a slot whose length is NaN (its f1 is NaN: best is
    N)."""
    from meshclust_tpu_torch.ops import phase_a as P
    from meshclust_tpu_torch.ops.classifier import Model
    ps, params, _ = _phase_a_case(1, cuda)
    n = ps.n
    h = ps.hist_dev.clone()
    lens = np.asarray(ps.lengths, np.float64).copy()
    center = 10
    for x in (40, 90, 300):
        h[x] = h[center]
        lens[x] = lens[center]
    if nan:
        lens[200] = np.nan
    h64 = h.to(torch.int64)
    mag = h64.sum(1).to(torch.float64)
    sq = (h64 * h64).sum(1).to(torch.float64)
    lenf = torch.as_tensor(lens, device=cuda)
    model = Model(params, h.shape[1], cuda)
    w0, w1 = {"empty": (50, 49), "one_slot": (90, 90),
              "all": (0, n - 1)}[window]
    out = {}
    for kernel in (True, False):
        st, part = P.new_state(n, cuda)
        st[P.W0], st[P.W1], st[P.LAST], st[P.COUNT] = w0, w1, center, 5
        st[P.C], st[P.T] = 3, 17
        active = torch.ones(n, dtype=torch.bool, device=cuda)
        active[center] = False
        owner = torch.full((n,), -1, dtype=torch.int64, device=cuda)
        stamp = torch.zeros(n, dtype=torch.int64, device=cuda)
        sumvec = h64[center].clone()
        sums = torch.zeros((2 if model.with_dot else 1, n),
                           dtype=torch.int64, device=cuda)
        P.sums_plain(st, active, h64, sums)
        args = (st, sums, model, mag, sq, lenf, owner, stamp, active, h,
                sumvec, part)
        if kernel:
            before = _ext.launches["pa_absorb"]
            P.absorb(*args)
            assert _ext.launches["pa_absorb"] == before + 1
        else:
            P.absorb_plain(*args)
        out[kernel] = (st[: P.COUNT + 1], owner, stamp, active, sumvec)
    for got, want in zip(out[True], out[False]):
        assert torch.equal(got, want)
    st = out[True][0].tolist()
    if window == "empty":
        assert st[P.NPOS] == 0 and st[P.BEST] == n
    if window == "all":
        assert st[P.NPOS] > 3
        assert st[P.BEST] == (n if nan else 40)


# -- Phase B (csrc/phase_b.cu) -------------------------------------------------

def _phase_b_case(dtype, device):
    """tests/test_torch_phaseb_schedule.py's species corpus whose species
    interleave in the length order (merges pass over kept centers, so
    assign turns non-monotone), rows in `dtype`, Phase A's centers on
    `device`: (backend, members, assign, center rows)."""
    from test_torch_phaseb_schedule import species_case
    return species_case(dtype, device, seed=4, close=True)


def phase_b_lockstep(be, members, assign, rows, delta, iterations,
                     mesh=None, span_cap=-1):
    """Phase B driven as phase_b_loop drives it, each step by the plain
    steps and by the kernels on two States of the same card (with `mesh`,
    a stand-in holding size and rank: that rank's padded block of the pool,
    no collectives; span_cap: the most center rows a tile of pb_band and
    pb_dist stages), every value the next step reads compared bit for bit.
    -> (launches of each kernel, iterations that merged, the kernels' tiles
    on each path {PB.PATHS: count})."""
    from meshclust_tpu_torch.ops import phase_b as PB
    both = [be._phase_b_state(members, assign, rows, delta, iterations, mesh)
            for _ in range(2)]
    both[1].span_cap = span_cap
    steps = (PB.steps(True), PB.steps(False))

    def same(*names):
        for name in names:
            a, b = (getattr(s, name) for s in both)
            assert torch.equal(a, b), name

    before = dict(_ext.launches)
    merged = 0
    for it in range(iterations):
        for s, step in zip(both, steps):
            step.band(s)
        same("assign", "bits", "sc", "best_d", "best_pos")
        for s, step in zip(both, steps):
            step.dist(s)
        same("dstore", "best_d")
        for s, step in zip(both, steps):
            step.pick(s)
        same("best_pos", "sc")
        for s, step in zip(both, steps):
            step.merge(s, it)
        same("c_idx", "c_valid", "remap")
        assert torch.equal(both[0].t_hist[it], both[1].t_hist[it])
        assert both[1].scratch[PB.TICKET] == 0
        C = rows.shape[0]
        merged += bool((both[1].t_hist[it].cpu().numpy() != np.arange(C))
                       .any())
    same("assign")
    return ({k: _ext.launches[k] - before[k] for k in _ext.launches},
            merged, dict(zip(PB.PATHS, both[1].paths.tolist())))


PHASE_B_CASES = {"int8_delta5": ("int8", 5, None),
                 "int8_delta0": ("int8", 0, None),
                 "int8_delta40": ("int8", 40, None),
                 "int16_delta5": ("int16", 5, None),
                 "int32_delta5": ("int32", 5, None),
                 "int8_rank1_of2": ("int8", 5, (2, 1)),
                 "int16_rank0_of3": ("int16", 3, (3, 0))}


@pytest.mark.parametrize("case", sorted(PHASE_B_CASES))
def test_phase_b_kernels_equal_plain_steps(cuda, case):
    """Each Phase B kernel against its plain step on the card, iteration by
    iteration over 6 iterations of Phase A's centers of the toy points:
    rows in each storage dtype, --delta 0, 5 and 40 (81 bits a member,
    three words), a rank's padded block of the pool; one launch of each
    kernel an iteration, and the case merges."""
    import types
    dtype, delta, ranks = PHASE_B_CASES[case]
    be, members, assign, rows = _phase_b_case(dtype, cuda)
    mesh = None if ranks is None else types.SimpleNamespace(
        size=ranks[0], rank=ranks[1])
    launched, merged, _ = phase_b_lockstep(be, members, assign, rows,
                                           delta, 6, mesh)
    assert {k: v for k, v in launched.items() if k.startswith("pb_")} == \
        dict.fromkeys(("pb_band", "pb_dist", "pb_pick", "pb_merge"), 6)
    assert merged or delta == 0


def test_phase_b_kernels_one_center(cuda):
    """C = 1: every member in one center's pool, no merge candidate."""
    be, members, _, rows = _phase_b_case("int8", cuda)
    launched, merged, _ = phase_b_lockstep(
        be, members, np.zeros_like(members), rows[:1], 5, 3)
    assert launched["pb_merge"] == 3 and merged == 0


# (rows, --delta, the most center rows a tile stages, the paths that must
# run): budgets below the stage's 32 rows, which tests/
# test_torch_phaseb_schedule.py's model shows sending these tiles down
# both paths
PAST_BUDGET = {
    "int8_delta1_cap4": ("int8", 1, 4, ("band_staged", "band_global",
                                        "dist_staged", "dist_global")),
    "int8_delta2_cap5": ("int8", 2, 5, ("band_staged", "band_global",
                                        "dist_staged", "dist_global")),
    "int8_delta40_cap3": ("int8", 40, 3, ("band_global", "dist_staged",
                                          "dist_global")),
    "int16_delta1_cap3": ("int16", 1, 3, ("band_global", "dist_staged",
                                          "dist_global")),
    "int16_delta2_cap5": ("int16", 2, 5, ("band_staged", "band_global",
                                          "dist_staged"))}


@pytest.mark.parametrize("case", sorted(PAST_BUDGET))
def test_phase_b_kernels_tiles_past_the_budget(cuda, case):
    """pb_band and pb_dist with a budget of staged center rows that some
    tiles' spans pass (after merges assign is non-monotone): those tiles
    take the global path in the same launch as the staged ones; every step
    stays bit-equal to its plain step over 6 iterations, at --delta 1, 2
    and 40 (three words of bits) and with int16 rows, and the paths named
    ran."""
    dtype, delta, cap, paths = PAST_BUDGET[case]
    be, members, assign, rows = _phase_b_case(dtype, cuda)
    launched, merged, ran = phase_b_lockstep(be, members, assign, rows,
                                             delta, 6, span_cap=cap)
    assert launched["pb_band"] == launched["pb_dist"] == 6 and merged
    for path in paths:
        assert ran[path] > 0, (path, ran)


@pytest.mark.parametrize("dtype", sorted(PHASE_A_SCALES))
def test_phase_b_loop_on_the_card_equals_plain_and_cpu(cuda, dtype):
    """The whole fused Phase B through the kernels against plain=True on
    the card and the CPU path (assign, centers, valid, t_hist), four
    launches an iteration; update_banded on the card against the CPU's."""
    be, members, assign, rows = _phase_b_case(dtype, cuda)
    host, _, _, _ = _phase_b_case(dtype, "cpu")
    _ext.reset_launches()
    got = be.phase_b_loop(members, assign, rows, 5, 15)
    assert {k: v for k, v in _ext.launches.items() if v} == dict.fromkeys(
        ("pb_band", "pb_dist", "pb_pick", "pb_merge"), 15)
    for want in (be.phase_b_loop(members, assign, rows, 5, 15, plain=True),
                 host.phase_b_loop(members, assign, rows, 5, 15)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        be.update_banded(members, assign, rows, 5),
        host.update_banded(members, assign, rows, 5))


def _merge_states(cuda, C, delta, seed=0):
    """Two States (for the kernel and the plain step) of C centers over the
    species corpus's points, drawn in point order (so neighbours share a
    species and merge, in chains), best_pos a member for half the centers
    and none for the rest, the last tenth of the slots not valid (c_idx 0
    there, as after a merge)."""
    be, members, assign, _ = _phase_b_case("int8", cuda)
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, be.hist_dev.shape[0], size=C))
    M_all = members.shape[0]
    pos = rng.integers(0, M_all, size=C)
    pos[rng.random(C) < 0.5] = M_all
    valid = C - C // 10
    out = []
    for _ in range(2):
        pb = be._phase_b_state(members, np.minimum(assign, C - 1), rows,
                               delta, 2)
        pb.best_pos.copy_(torch.from_numpy(pos))
        pb.c_valid[valid:] = False
        pb.c_idx[valid:] = 0
        out.append(pb)
    return out


# (centers, --delta): the look-back across hundreds of blocks, one
# center, the nearest and the farthest candidates (past 64, the slots a
# block stages, candidates are read from device memory), few centers (a
# group of 16 lanes a center)
MERGE_CASES = {"C12000_delta5": (12000, 5), "C1_delta5": (1, 5),
               "C12000_delta1": (12000, 1), "C12000_delta40": (12000, 40),
               "C12000_delta70": (12000, 70), "C3000_delta5": (3000, 5)}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_pb_merge_equals_plain_with_merges(cuda, case):
    """pb_merge against merge_plain, twice on the same States (the second
    pass after the first's compaction, with the scratch as the first left
    it): t_hist, c_idx, c_valid and remap bit-equal; merges and chains
    across blocks where C > 1."""
    from meshclust_tpu_torch.ops import phase_b as PB
    C, delta = MERGE_CASES[case]
    a, b = _merge_states(cuda, C, delta)
    for it in range(2):
        PB.merge(a, it)
        PB.merge_plain(b, it)
        for name in ("c_idx", "c_valid", "remap"):
            assert torch.equal(getattr(a, name), getattr(b, name)), (it, name)
        assert torch.equal(a.t_hist[it], b.t_hist[it]), it
        assert int(a.scratch[PB.TICKET]) == int(a.scratch[PB.TILES]) == \
            int(a.scratch[PB.MERGED]) == 0
    merged = int((b.t_hist[0] != torch.arange(C, device=cuda)).sum())
    assert merged > C // 10 or C == 1
    if C > 1:
        assert int(b.c_valid.sum()) < C - C // 10


def test_pb_pick_ties_across_ranks_blocks(cuda):
    """pb_pick on two ranks' blocks of a pool that holds every member twice
    (once in each block, so every d ties with its copy in the other block;
    the second block's positions from goff > 0): each rank's best_pos and
    sc bit-equal to pick_plain's, band, dist and the collectives done as
    _band_argmin does them, and the minimum across the ranks equal too."""
    import types
    from meshclust_tpu_torch.ops import phase_b as PB
    be, members, assign, rows = _phase_b_case("int8", cuda)
    members2 = np.concatenate([members, members])
    assign2 = np.concatenate([assign, assign])
    got = {}
    for plain in (True, False):
        step = PB.steps(plain)
        ranks = [be._phase_b_state(members2, assign2, rows, 5, 1,
                                   types.SimpleNamespace(size=2, rank=r))
                 for r in range(2)]
        assert ranks[1].goff == members.shape[0]
        for s in ranks:
            step.band(s)
        sc = ranks[0].sc + ranks[1].sc
        for s in ranks:
            s.sc.copy_(sc)
            step.dist(s)
        best_d = torch.minimum(ranks[0].best_d, ranks[1].best_d)
        for s in ranks:
            s.best_d.copy_(best_d)
            step.pick(s)
            assert not s.sc.any()
        got[plain] = [s.best_pos.clone() for s in ranks]
    M_all = 2 * members.shape[0]
    for r in range(2):
        assert torch.equal(got[False][r], got[True][r]), r
    both = (got[True][0] < M_all) & (got[True][1] < M_all)
    assert int(both.sum()) > 0
    assert torch.equal(torch.minimum(*got[False]), got[True][0])


def test_phase_b_loop_split_150k_equals_plain(cuda):
    """chip_smoke.py's merging input at 150k reads (Phase A's centers, each
    split in two adjacent centers) through the whole phase_b_loop: the
    kernels' assign, centers, valid and t_hist equal to plain=True, four
    launches an iteration, and centers merge."""
    import os
    import chip_smoke as S
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.bvec import BVec
    from meshclust_tpu_torch.core.runner import run
    os.makedirs(S.WORK, exist_ok=True)
    cfg = ClusterConfig(files=[S.bench_corpus(n=150000)],
                        output=S.WORK + "/split_150k.clstr",
                        similarity=0.90).finalize()
    res = run(cfg, device=cuda)
    ps = res["pointset"]
    bv = BVec(ps.lengths.copy(), cfg.bin_size)
    bv.bulk_insert(ps.lengths)
    bv.insert_finalize()
    be, members, assign, rows = S.phase_b_inputs(ps, bv,
                                                 res["model"].params)
    members, assign, rows = S.split_centers(members, assign, rows)
    _ext.reset_launches()
    got = be.phase_b_loop(members, assign, rows, 5, 15)
    assert {k: v for k, v in _ext.launches.items() if v} == dict.fromkeys(
        ("pb_band", "pb_dist", "pb_pick", "pb_merge"), 15)
    want = be.phase_b_loop(members, assign, rows, 5, 15, plain=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[3] != np.arange(rows.shape[0])).sum() > rows.shape[0] // 4


# -- pivot orders (csrc/pivot_order.cu) -------------------------------------

def _traffic_points(cuda, tmp_path, traffic, reads=None, seed=2718281829):
    """A PointSet on the card of corpus 0 of a benchmark traffic mix
    (benchmark/traffic/<traffic>.json), `reads` reads if given."""
    import json
    import os
    from benchmark.generators import species_clones
    from meshclust_tpu_torch.core import points as PT
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "traffic",
                           f"{traffic}.json")) as f:
        mix = json.load(f)
    if reads:
        mix["reads"] = reads
    path = str(tmp_path / f"{traffic}.fasta")
    species_clones.make(mix, seed, 0, path)
    per = [fio.read_fasta(path)]
    return PT.build_points(per[0], H.find_k(per), cuda)


def _as_dtype(ps, dtype):
    import dataclasses
    return dataclasses.replace(ps, hist=None, hist_dev=ps.hist_dev.to(dtype))


def _chain(ps, pivots, fn):
    """Trainer._ref_order_chain's orders through `fn` (orders or
    orders_plain): the begin row over the length order, then `pivots`
    evenly spaced pivot rows over the begin row's order."""
    from meshclust_tpu_torch import native
    n = ps.n
    perm = np.arange(n, dtype=np.int32)
    assert native.ref_sort_perm(perm, np.asarray(ps.lengths, np.int64))
    begin = fn(ps, [int(perm[n // 2])],
               torch.from_numpy(perm).to(ps.device))[0]
    rows = begin[torch.as_tensor([i * (n - 1) // (pivots - 1)
                                  for i in range(pivots)],
                                 device=ps.device)].to(torch.int64)
    return begin.cpu(), fn(ps, rows, begin).cpu()


@pytest.mark.parametrize("traffic", ["r15k", "rare15k"])
def test_pivot_order_kernel_equals_host_chain(cuda, tmp_path, traffic):
    """At 15k reads (the workspace in shared memory), every storage dtype:
    the kernel's begin row and 150 pivot rows equal the host chain's
    (float64 host keys, libstdc++'s std::sort) bit for bit, one launch a
    batch of rows."""
    from meshclust_tpu_torch.ops import pivot_order as PO
    ps = _traffic_points(cuda, tmp_path, traffic)
    assert ps.n == 15000 and _ext.lib().mc_pivot_order_scratch(ps.n) == 0
    want = _chain(ps, 150, PO.orders_plain)
    for dtype in (torch.int8, torch.int16, torch.int32, torch.int64):
        psd = _as_dtype(ps, dtype)
        before = _ext.launches["pivot_order"]
        got = _chain(psd, 150, PO.orders)
        assert _ext.launches["pivot_order"] == before + 2
        for g, w in zip(got, want):
            assert torch.equal(g, w), dtype


def test_pivot_order_kernel_equals_host_chain_150k(cuda, tmp_path):
    """At 150k reads the workspace lives in global scratch: the same
    kernel's rows equal the host chain's."""
    from meshclust_tpu_torch.ops import pivot_order as PO
    ps = _traffic_points(cuda, tmp_path, "r15k", reads=150000)
    assert _ext.lib().mc_pivot_order_scratch(ps.n) > 0
    got = _chain(ps, 9, PO.orders)
    want = _chain(ps, 9, PO.orders_plain)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pivot_order_kernel_reaches_the_heap_path(cuda):
    """Keys from a McIlroy adversary (test_torch_pivot_schedule.mcilroy,
    point 0 the pivot at key 0) as Manhattan distances: row j = [M - t_j,
    t_j, 0, 0], so key j rises with t_j. The kernel takes the depth-limit
    heap path as often as std::sort does and leaves its order."""
    from meshclust_tpu_torch.core import points as PT
    from meshclust_tpu_torch.ops import pivot_order as PO
    from test_torch_pivot_schedule import mcilroy, replica_sort
    n, M = 2000, 5000
    t = mcilroy(n, solid=(0,))
    hist = np.zeros((n, 4), np.int16)
    hist[:, 0] = M - t
    hist[:, 1] = t
    ps = PT.PointSet(hist=None, mag=np.full(n, M, np.int64),
                     sq=np.zeros(n, np.int64),
                     lengths=np.full(n, 100, np.int64),
                     one_mers=np.zeros((n, 4), np.int64),
                     headers=[f">r{i}" for i in range(n)], codes=[], k=1,
                     V=4, hist_dev=torch.from_numpy(hist).to(cuda))
    keys = ps.distance_rows_device(np.zeros(1, np.int64))[0]
    assert np.array_equal(np.argsort(keys, kind="stable"),
                          np.argsort(t, kind="stable"))
    assert len(np.unique(keys)) == len(np.unique(t))
    perm = torch.arange(n, dtype=torch.int32, device=cuda)
    heaps = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = PO.orders(ps, [0], perm, heaps)
    want = PO.orders_plain(ps, [0], perm)
    assert torch.equal(got, want)
    order, count = replica_sort(np.arange(n), keys)
    assert count > 0 and int(heaps.item()) == count
    assert np.array_equal(got[0].cpu().numpy(), order)


def test_trainer_split_on_the_card_equals_cpu(cuda, tmp_path):
    """Trainer.split()'s sampled pairs through the kernel equal the host
    chain's on the CPU; a training launches the kernel twice and counts
    its rows."""
    import json
    import os
    from benchmark.generators import species_clones
    from meshclust_tpu_torch.core import points as PT
    from meshclust_tpu_torch.core import trainer as TR
    from meshclust_tpu_torch.utils import perf
    mix = {"generator": "species_clones", "pool": 1, "shape_seed": 21,
           "reads": 1200, "species_sizes": {"law": "fixed", "size": 40},
           "length": {"mean": 240, "spread": 30}, "trim_div": 50,
           "trim_min": 2, "substitution": {"low": 0.03, "high": 0.03}}
    path = str(tmp_path / "split.fasta")
    species_clones.make(mix, 1618033988, 0, path)
    per = [fio.read_fasta(path)]
    k = H.find_k(per)
    pairs = {}
    for dev in (cuda, torch.device("cpu")):
        ps = PT.build_points(per[0], k, dev)
        tr = TR.Trainer(ps, n_points=600, cutoff=0.9, max_pts_from_one=8,
                        k=k)
        perf.reset()
        _ext.reset_launches()
        pairs[dev.type] = tr.split()
        if dev.type == "cuda":
            assert _ext.launches["pivot_order"] == 2
            assert perf.counters()["pivot_rows"] == 1 + 75
            assert perf.counters()["pivot_heap"] == 0
        else:
            assert _ext.launches["pivot_order"] == 0
    assert len(pairs["cuda"]) > 100
    assert pairs["cuda"] == pairs["cpu"]
    perf.reset()
    _ext.reset_launches()
    TR.Trainer(PT.build_points(per[0], k, cuda), n_points=600, cutoff=0.9,
               max_pts_from_one=8, k=k).train()
    assert _ext.launches["pivot_order"] == 2

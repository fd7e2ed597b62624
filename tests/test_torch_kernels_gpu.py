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

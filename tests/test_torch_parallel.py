"""The port's sharded modules on gloo ranks (parallel/dist.launch with
device="cpu"), against the JAX package's 8-device virtual mesh and the
port's single rank; mirrors tests/test_parallel.py case by case.

- featurization sharded on records at 2/3/4 ranks: the histograms, 1-mers,
  magnitudes, sums of squares and largest count of JAX's featurize over
  the mesh, one kmer_hist call a rank, split mode decided on every record;
- the fused Phase B with the member pool sharded at 2/4/8 ranks: all four
  outputs of JAX's 8-device phase_b_loop (the toy model of
  test_parallel.py, with an uneven pool, and banded cases that merge), and
  no read back before the end;
- Phase A with the feature axis sharded at 2/4 ranks: JAX's Phase A over
  its mesh (the same centers with the same members in the same order), the
  sharded path engaged (collectives at its site) and one read an absorb
  iteration, as on one rank; under MESHCLUST_PHASEA_SHARD=0 the same
  centers from the replicated path (no collective at its site).

Every comparison is exact. tests/test_torch_parallel_run.py drives the
whole pipeline over ranks.
"""
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from meshclust_tpu_torch import convert
from meshclust_tpu_torch.parallel import dist

torch.set_num_threads(1)
KS = [4, 6]


def jax_mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:8]), axis_names=("data",))


def arrays_of(jps) -> dict:
    """A JAX PointSet's arrays as the rank functions take them."""
    n = jps.hist.shape[0]
    codes = jps.codes if len(jps.codes) == n else \
        [np.zeros(0, np.uint8)] * n
    return {"hist": np.asarray(jps.hist), "mag": jps.mag, "sq": jps.sq,
            "lengths": jps.lengths, "one_mers": jps.one_mers,
            "codes": codes, "headers": jps.headers, "k": jps.k}


def port_params(jparams):
    return convert.params_from_numpy(jparams.singles, jparams.mins,
                                     jparams.maxs, jparams.is_sim,
                                     jparams.combos, jparams.weights)


# -- featurization ------------------------------------------------------------

def feat_corpus(path) -> str:
    """test_torch_histogram's reads (150-300 bp, N runs, records under
    20 bp) then three 9 kb records: the last rank's block averages over
    LONG_RECORD bases while the corpus does not."""
    from tests.test_torch_histogram import LETTERS, _records
    rng = np.random.default_rng(8)
    records = _records(3) + [
        (f">long{i}", LETTERS[rng.integers(0, 4, size=9000)].tobytes())
        for i in range(3)]
    with open(path, "wb") as f:
        for h, s in records:
            f.write(h.encode() + b"\n" + s + b"\n")
    return str(path)


@pytest.fixture(scope="module")
def feat_ref(tmp_path_factory):
    from meshclust_tpu.io import fasta as jfio
    from meshclust_tpu.ops import histogram as JH
    from meshclust_tpu_torch.io import fasta as fio
    from meshclust_tpu_torch.ops import histogram as H
    fasta = feat_corpus(tmp_path_factory.mktemp("feat") / "feat.fasta")
    jseqs = jfio.read_fasta(fasta)
    seqs = fio.read_fasta(fasta)
    want = {k: JH.featurize(jseqs, k, use_pallas=False, mesh=jax_mesh())
            for k in KS}
    one = {k: H.featurize(seqs, k, torch.device("cpu")) for k in KS}
    return fasta, want, one


@pytest.fixture(scope="module", params=[2, 3, 4],
                ids=["2ranks", "3ranks", "4ranks"])
def feat_ranks(request, feat_ref):
    return request.param, dist.launch(R.featurize, request.param, "cpu",
                                      feat_ref[0], KS)


@pytest.mark.parametrize("k", KS)
def test_featurize_sharded_equals_jax_mesh_and_one_rank(feat_ranks, feat_ref,
                                                        k):
    from meshclust_tpu.ops import histogram as JH
    _, want, one = feat_ref
    want, one = want[k], one[k]
    for got in (out[k] for out in feat_ranks[1]):
        assert got["hist"].dtype == np.dtype(JH.storage_dtype(
            want["largest"]))
        np.testing.assert_array_equal(got["hist"].astype(np.int64),
                                      want["hist"].astype(np.int64))
        np.testing.assert_array_equal(got["hist"], one["hist_dev"].numpy())
        for key in ("one_mers", "mag", "sq", "lengths"):
            np.testing.assert_array_equal(got[key], want[key])
            np.testing.assert_array_equal(got[key], one[key])
        assert got["largest"] == want["largest"] == one["largest"]


@pytest.mark.parametrize("k", KS)
def test_featurize_one_kmer_hist_call_a_rank(feat_ranks, k):
    from meshclust_tpu_torch.ops import histogram as H
    n, outs = feat_ranks
    rows = [out[k]["counters"]["feat_rows"] for out in outs]
    lengths = outs[0][k]["lengths"]
    off = dist.blocks(lengths, n)
    assert rows == np.diff(off).tolist()
    assert sum(rows) == lengths.shape[0] and min(rows) > 0
    # balanced by bases: the three 9 kb records do not share one rank
    assert max(lengths[off[r]: off[r + 1]].sum() for r in range(n)) \
        < 0.75 * lengths.sum()
    last = lengths[off[-2]:]
    assert last.mean() >= H.LONG_RECORD and lengths.mean() < H.LONG_RECORD
    for out in outs:
        assert out[k]["splits"] == [H.split_mode(lengths, k)]
        # rows, statistics, the largest count
        assert out[k]["counters"]["coll_featurize"] == 3


# -- Phase B ------------------------------------------------------------------

def toy_case(n_members):
    """test_parallel.py's toy case (its rng fixture's seed) with the first
    n_members of its member permutation."""
    import __graft_entry__ as g
    from meshclust_tpu.core.points import PointSet
    rng = np.random.default_rng(1234)
    hist, mag, sq, lens, params = g._toy_model(n=96, V=64, seed=5)
    jps = PointSet(hist=hist, mag=mag, sq=sq, lengths=lens,
                   one_mers=np.zeros((96, 4), np.int64),
                   headers=[f">s{i}" for i in range(96)],
                   codes=[], k=4, V=64)
    members = np.asarray(rng.permutation(96), np.int64)[:n_members]
    assign = np.sort(rng.integers(0, 7, size=96)).astype(
        np.int64)[:n_members]
    center_rows = np.asarray(rng.choice(96, size=7, replace=False), np.int64)
    return jps, params, members, assign, center_rows, 2


def banded(seed, delta):
    from tests.test_torch_device_backend import banded_case
    jps, jparams, _, _, members, assign, rows = banded_case(seed)
    return jps, jparams, members, assign, rows, delta


PHASE_B_CASES = {"toy96": lambda: toy_case(96),
                 "toy91_uneven": lambda: toy_case(91),
                 "banded6": lambda: banded(6, 5)}


@pytest.fixture(scope="module")
def phase_b_ref():
    from meshclust_tpu.core.classify import DeviceBackend
    cases, want = [], {}
    for name in sorted(PHASE_B_CASES):
        jps, jparams, members, assign, rows, delta = PHASE_B_CASES[name]()
        cases.append((arrays_of(jps), port_params(jparams), members, assign,
                      rows, delta, 4))
        want[name] = DeviceBackend(jps, jparams, mesh=jax_mesh()) \
            .phase_b_loop(members, assign, rows, delta, 4)
    return cases, want


@pytest.fixture(scope="module", params=[2, 4, 8],
                ids=["2ranks", "4ranks", "8ranks"])
def phase_b_ranks(request, phase_b_ref):
    return request.param, dist.launch(R.phase_b, request.param, "cpu",
                                      phase_b_ref[0])


@pytest.mark.parametrize("case", sorted(PHASE_B_CASES))
def test_phase_b_loop_sharded_equals_jax_mesh(phase_b_ranks, phase_b_ref,
                                              case):
    i = sorted(PHASE_B_CASES).index(case)
    want = phase_b_ref[1][case]
    C_ = phase_b_ref[0][i][4].shape[0]
    for out in phase_b_ranks[1]:
        a, c_rows, valid, t_hist = out[i]["result"]
        np.testing.assert_array_equal(a, want[0])
        np.testing.assert_array_equal(c_rows, want[1][:C_])
        np.testing.assert_array_equal(valid, want[2][:C_])
        np.testing.assert_array_equal(t_hist, want[3][:, :C_])
    if case.startswith("banded"):
        assert (t_hist != np.arange(C_)).any()      # the case merges


def test_phase_b_sharded_collectives_and_reads(phase_b_ranks, phase_b_ref):
    """Three collectives an iteration (the [C, V + 1] sums and counts, the
    best distance, the best position) and the gather of the assignment;
    no read back before the loop's end."""
    _, outs = phase_b_ranks
    for out in outs:
        for case, res in zip(phase_b_ref[0], out):
            C_, V = case[4].shape[0], case[0]["hist"].shape[1]
            assert res["reads"] == 0
            assert res["counters"]["coll_phase_b"] == 3 * 4 + 1
            M = case[2].shape[0]
            Ml = -(-M // len(outs))
            assert res["counters"]["coll_phase_b_bytes"] == \
                4 * 8 * (C_ * (V + 1) + 2 * C_) + 8 * Ml * len(outs)


# -- Phase A ------------------------------------------------------------------

@pytest.fixture(scope="module")
def phase_a_ref():
    from meshclust_tpu.core.accumulate_device import accumulate_device
    from meshclust_tpu.core.bvec import BVec as JBVec
    from tests.test_torch_accumulate import CORPORA, jax_points
    cases, want = [], []
    for name in ("duplicates", "species"):
        kw = dict(CORPORA[name])
        jps, jparams = jax_points(np.random.default_rng(kw.pop("seed")),
                                  **kw)
        jbv = JBVec(jps.lengths.copy(), 20)
        for i in range(jps.n):
            jbv.insert(i, int(jps.lengths[i]))
        jbv.insert_finalize()
        want.append([(c.center, list(c.members)) for c in accumulate_device(
            jps, jbv, jparams, 0.90, mesh=jax_mesh())])
        cases.append((arrays_of(jps), port_params(jparams), 20, 0.90))
    return cases, want


@pytest.fixture(scope="module", params=[(2, "1"), (4, "1"), (2, "0")],
                ids=["2ranks", "4ranks", "2ranks_shard_off"])
def phase_a_ranks(request, phase_a_ref):
    """(shard switch, each rank's results); the spawned ranks inherit
    MESHCLUST_PHASEA_SHARD."""
    n, shard = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MESHCLUST_PHASEA_SHARD", shard)
        return shard, dist.launch(R.phase_a, n, "cpu", phase_a_ref[0])


def test_phase_a_feature_sharded_equals_jax_mesh(phase_a_ranks, phase_a_ref):
    _, outs = phase_a_ranks
    for out in outs:
        for got, want in zip(out, phase_a_ref[1]):
            assert len(want) >= 4
            assert got["centers"] == want


def test_phase_a_sharded_engaged_one_read_an_iteration(phase_a_ranks):
    """Each absorb iteration sums its sweep's partials, and each one that
    absorbs also the mean's: between 1 and 2 collectives an iteration; with
    the switch off, none. The only value read back besides the iteration's
    .tolist() is the largest count at setup, as on one rank."""
    shard, outs = phase_a_ranks
    for out in outs:
        for res in out:
            c = res["counters"]
            assert c["accum_iters"] > 0
            if shard == "0":
                assert c.get("coll_accumulate", 0) == 0
            else:
                assert c["accum_iters"] <= c["coll_accumulate"] \
                    <= 2 * c["accum_iters"]
            assert res["reads"] == 1

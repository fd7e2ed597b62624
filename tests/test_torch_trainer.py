"""The port's Trainer against the JAX package's: on the same corpus, the
feature list, the normalization bounds and the GLM weights of the trained
model must be bit-equal (float64 computed in the same op order from exact
integers).
"""
import numpy as np
import pytest
import torch

from meshclust_tpu.core import points as JP
from meshclust_tpu.core import trainer as JT
from meshclust_tpu.io import fasta as jfio
from meshclust_tpu_torch.core import points as P
from meshclust_tpu_torch.core import trainer as T
from meshclust_tpu_torch.io import fasta as fio

# One intra-op thread per test process (no OpenMP oversubscription under
# pytest-xdist).
torch.set_num_threads(1)
LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


def _records(seed, n_species=6, per=18, L=160):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_species):
        Ls = L + int(rng.integers(-L // 10, L // 10))
        base = rng.integers(0, 4, size=Ls)
        for c in range(per):
            seq = base.copy()
            mut = rng.random(Ls) < 0.04
            seq[mut] = (seq[mut] + 1 + rng.integers(
                0, 3, size=int(mut.sum()))) % 4
            out.append((f">sp{s}_c{c}",
                        LETTERS[seq[: Ls - int(rng.integers(0, 6))]]
                        .tobytes()))
    order = rng.permutation(len(out))
    return [out[i] for i in order]


@pytest.fixture(scope="module")
def models():
    recs = _records(21)
    jps = JP.build_points([jfio.encode_record(h, s) for h, s in recs], 3,
                          use_pallas=False)
    tps = P.build_points([fio.encode_record(h, s) for h, s in recs], 3,
                         torch.device("cpu"))
    jt = JT.Trainer(jps, n_points=200, cutoff=0.9, max_pts_from_one=20, k=3)
    tt = T.Trainer(tps, n_points=200, cutoff=0.9, max_pts_from_one=20, k=3)
    return jt, tt, jt.train(), tt.train()


def test_trained_model_equals_jax(models):
    _, _, jm, tm = models
    assert tm.feature.lookup == jm.feature.lookup
    assert tm.feature.combos == jm.feature.combos
    assert tm.feature.is_sims == jm.feature.is_sims
    np.testing.assert_array_equal(np.asarray(tm.feature.mins),
                                  np.asarray(jm.feature.mins))
    np.testing.assert_array_equal(np.asarray(tm.feature.maxs),
                                  np.asarray(jm.feature.maxs))
    np.testing.assert_array_equal(tm.weights, jm.weights)
    assert tm.weights.dtype == np.float64


def test_pivot_orders_are_stable_distance_sorts(models):
    """The device-sort route (used beyond MESHCLUST_REFSORT_MAX points or
    without the native refsort library) orders each pivot's row by the
    exact distance keys, ties in index order."""
    _, tt, _, _ = models
    rows = np.asarray([0, 9, 50], np.int64)
    orders = tt._pivot_orders(rows)
    n = tt.ps.n
    ii = np.repeat(np.arange(3), n)
    jj = np.tile(np.arange(n), 3)
    got = orders.gather(ii, jj).reshape(3, n)
    for a, r in enumerate(rows):
        want = np.argsort(tt.ps.distance_row(int(r)).astype(np.int64),
                          kind="stable")
        np.testing.assert_array_equal(got[a], want)

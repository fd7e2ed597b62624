"""The port's PointSet against the JAX package's: the pivot distance rows
(exact integer Manhattan sums as torch ops, float64 keys on the host) must
equal meshclust_tpu's PointSet.distance_rows_device and distance_row
exactly, and host row gathers must equal the host histogram.
"""
import numpy as np
import pytest
import torch

from meshclust_tpu.core import points as JP
from meshclust_tpu.io import fasta as jfio
from meshclust_tpu_torch.core import points as P
from meshclust_tpu_torch.io import fasta as fio

# One intra-op thread per test process (no OpenMP oversubscription under
# pytest-xdist).
torch.set_num_threads(1)
LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


def _records(seed, n=60):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=260)
    out = []
    for i in range(n):
        seq = base.copy() if i % 2 else rng.integers(0, 4, size=260)
        seq[rng.random(260) < 0.05] = rng.integers(0, 4)
        L = int(rng.integers(150, 261))
        raw = LETTERS[seq[:L]].copy()
        if i % 5 == 0:
            raw[40: 40 + int(rng.integers(3, 30))] = ord("N")
        out.append((f">r{i}", raw.tobytes()))
    return out


@pytest.fixture(scope="module")
def both():
    recs = _records(3)
    jps = JP.build_points([jfio.encode_record(h, s) for h, s in recs], 4,
                          use_pallas=False)
    tps = P.build_points([fio.encode_record(h, s) for h, s in recs], 4,
                         torch.device("cpu"))
    return jps, tps


def test_distance_rows_device_equals_jax(both):
    jps, tps = both
    rows = np.asarray([0, 5, 17, 59, 33], np.int64)
    got = tps.distance_rows_device(rows)
    np.testing.assert_array_equal(got, jps.distance_rows_device(rows))
    for r, row in zip(rows, got):
        np.testing.assert_array_equal(row, jps.distance_row(int(r))
                                      .astype(np.int64))
    assert got.dtype == np.int64


def test_manhattan_rows_blocks(both, monkeypatch):
    """Blocking over pivots and points (forced tiny here) changes nothing."""
    _, tps = both
    rows = np.asarray([3, 1, 4, 1, 5, 9, 2, 6], np.int64)
    whole = P.manhattan_rows(tps.hist_dev, rows)
    monkeypatch.setattr(P, "_MAN_BLOCK", 3 * tps.V)
    blocked = P.manhattan_rows(tps.hist_dev, rows)
    h = tps.hist.astype(np.int64)
    want = np.abs(h[rows][:, None, :] - h[None, :, :]).sum(-1)
    np.testing.assert_array_equal(whole, want)
    np.testing.assert_array_equal(blocked, want)


def test_host_views_equal_jax(both):
    jps, tps = both
    idx = np.asarray([7, 0, 42], np.int64)
    np.testing.assert_array_equal(tps.hist_rows(idx), jps.hist[idx])
    np.testing.assert_array_equal(tps.hist, jps.hist)
    assert tps.hist.dtype == jps.hist.dtype
    assert tps.distance(3, 8) == jps.distance(3, 8)
    for key in ("mag", "sq", "lengths", "one_mers"):
        np.testing.assert_array_equal(getattr(tps, key), getattr(jps, key))
    assert tps.largest == jps.largest

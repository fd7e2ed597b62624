"""The port's DeviceBackend (the float64 classifier in torch) against the
float64 host oracle, HostBackend, and the JAX package's DeviceBackend.

On the CPU (tensors on the CPU; the same ops run on CUDA). Every comparison
is exact: equal decisions, f1 equal as float64, equal center rows. The
points and the classifier are __graft_entry__._toy_model's, as trained and
with the intercept shifted so that many scores sit within 1e-12 of 0 (a
quarter of the rows duplicate another, so a shift that puts one pair's
score at 0 puts its duplicates there too), and with counts large enough
that their products need int64.

The helpers at the top import neither jax nor meshclust_tpu, so the GPU
tests can use them.
"""
import functools

import numpy as np
import pytest
import torch

from meshclust_tpu_torch import convert
from meshclust_tpu_torch.core import classify as C
from meshclust_tpu_torch.ops import features as F

# One intra-op thread per test process keeps OpenMP from oversubscribing
# the cores under pytest-xdist.
torch.set_num_threads(1)
SHIFTS = [None, 0.25, 0.5, 0.75]
CENTERS = [0, 1, 7, 130, 511]


def toy_model(n=512, V=256, seed=0, scale=1):
    """__graft_entry__._toy_model built with the port's features module:
    (hist, mag, sq, lens, params). Every fourth row from row 1 duplicates
    the row before it (counts and length); counts, and with them the
    Manhattan bounds, are multiplied by `scale`."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, 12, size=(n, V)).astype(np.int32)
    lens = rng.integers(300, 800, size=n).astype(np.int64)
    hist[1::4] = hist[0::4][: hist[1::4].shape[0]]
    lens[1::4] = lens[0::4][: lens[1::4].shape[0]]
    hist = hist * scale
    mag = hist.astype(np.int64).sum(1)
    sq = (hist.astype(np.int64) ** 2).sum(1)
    feat = F.Feature(V)
    for flags, combo in F.DEFAULT_FEATURE_MENU:
        feat.add_feature(flags, combo)
    feat.normalize_raw({
        F.FEAT_LD: np.array([0.0, 500.0]),
        F.FEAT_MANHATTAN: np.array([50.0, 4000.0]) * scale,
        F.FEAT_INTERSECTION: np.array([0.3, 0.99]),
        F.FEAT_PEARSON: np.array([-0.5, 0.999]),
        F.FEAT_KULCZYNSKI2: np.array([1000.0, 90000.0]),
    })
    feat.finalize()
    return hist, mag, sq, lens, feat.params(np.array([-3.0, 2.0, 1.5, 2.0,
                                                      1.0]))


def toy_points(hist, mag, sq, lens, device="cpu"):
    n = hist.shape[0]
    return convert.pointset_from_numpy(
        hist, mag, sq, lens, np.zeros((n, 4), np.int64),
        [np.zeros(0, np.uint8)] * n, [f">s{i}" for i in range(n)], 4,
        device=device)


def host_scores(hb, center, window):
    """HostBackend.classify's score (before its sign test)."""
    p = hb.params
    norm = (hb._raw_cache(center, window) - p.mins) / (p.maxs - p.mins)
    norm = np.where(p.is_sim, norm, 1.0 - norm)
    score = np.full(window.shape[0], p.weights[0])
    for j, (combo, idx) in enumerate(p.combos):
        prod = np.ones(window.shape[0])
        for i in idx:
            c = norm[:, i]
            prod = prod * (c * c if combo == F.COMBO_SQUARED else c)
        score = score + p.weights[j + 1] * prod
    return score


def shifted(params, ps, q):
    """params with the intercept moved so that the score of the pair at
    quantile q of center 0's scores against duplicated rows is about 0
    (None: unchanged). Returns (params, how many of center 0's scores lie
    within 1e-12 of 0)."""
    if q is None:
        return params, 0
    hb = C.HostBackend(ps, params)
    window = np.arange(ps.n)
    s = np.sort(host_scores(hb, 0, window)[0::4])
    target = s[int(q * (s.shape[0] - 1))]
    w = params.weights.copy()
    w[0] -= target
    out = convert.params_from_numpy(params.singles, params.mins, params.maxs,
                                    params.is_sim, params.combos, w)
    near = int((np.abs(host_scores(C.HostBackend(ps, out), 0, window))
                < 1e-12).sum())
    return out, near


@pytest.fixture(scope="module", params=[1, 5000], ids=["counts", "large"])
def toy(request):
    hist, mag, sq, lens, params = toy_model(scale=request.param)
    return toy_points(hist, mag, sq, lens), params, request.param


def test_toy_model_is_graft_entry_toy_model():
    import __graft_entry__ as g
    want = g._toy_model()
    got = toy_model()
    rows = np.arange(512) % 4 != 1          # rows the copy leaves as drawn
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a[rows], b[rows])
    for field in ("singles", "mins", "maxs", "is_sim", "combos", "weights"):
        assert np.array_equal(np.asarray(getattr(got[4], field), object),
                              np.asarray(getattr(want[4], field), object))


@pytest.mark.parametrize("q", SHIFTS, ids=["trained", "near0_q25",
                                           "near0_q50", "near0_q75"])
def test_decisions_equal_host_backend(toy, q):
    ps, params, scale = toy
    params, near = shifted(params, ps, q)
    if q is not None:
        assert near >= 2
    db = C.DeviceBackend(ps, params)
    hb = C.HostBackend(ps, params)
    assert db.rows == (torch.int32 if scale == 1 else torch.int64)
    window = np.arange(ps.n)
    n_pos = 0
    for center in CENTERS:
        want_pos, want_f1 = hb.classify(center, window)
        got_pos, got_f1 = db.classify(center, window)
        np.testing.assert_array_equal(got_pos, want_pos)
        assert np.array_equal(got_f1, want_f1)
        marks, is_min, best = db.get_close(center, window)
        np.testing.assert_array_equal(marks, want_pos)
        assert is_min == (not want_pos.any())
        assert best == int(np.argmax(want_f1))
        n_pos += int(want_pos.sum())
    if q is not None:
        assert 0 < n_pos < len(CENTERS) * ps.n
    rng = np.random.default_rng(3)
    a = rng.integers(0, ps.n, size=300)
    b = rng.integers(0, ps.n, size=300)
    got_pos, got_f1 = db.classify_pairs(a, b)
    for t in range(a.shape[0]):
        want_pos, want_f1 = hb.classify(int(a[t]), b[t: t + 1])
        assert got_pos[t] == want_pos[0]
        assert got_f1[t] == want_f1[0]


def test_empty_windows():
    hist, mag, sq, lens, params = toy_model(n=8)
    db = C.DeviceBackend(toy_points(hist, mag, sq, lens), params)
    empty = np.zeros(0, np.int64)
    assert db.classify(0, empty)[0].shape == (0,)
    assert db.get_close(0, empty)[1:] == (True, -1)
    assert db.classify_pairs(empty, empty)[1].shape == (0,)


def test_mean_floor_at_integer_means():
    """tests/test_ds.py::test_cw_exact_at_integer_means' cases: exactly
    divisible lanes, and quotients near 2^23 over a count of 1, against
    integer floor division."""
    rng = np.random.default_rng(1234)
    for cnt in (7, 98, 1000, 16383):
        V = 128
        q_true = rng.integers(0, 200, V).astype(np.int64)
        rem = rng.integers(0, cnt, V).astype(np.int64)
        rem[::3] = 0                      # a third exactly divisible
        sums = q_true * cnt + rem
        got = C.mean_floor(torch.from_numpy(sums), torch.tensor(cnt))
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      sums // cnt)
    sums = (np.arange(100) + (1 << 23) - 50).astype(np.int64)
    for cnt in (1, 3):
        got = C.mean_floor(torch.from_numpy(sums * cnt),
                           torch.full((100,), cnt))
        np.testing.assert_array_equal(got.numpy().astype(np.int64), sums)


def test_row_dtype():
    assert C.row_dtype(46340) == torch.int32
    assert C.row_dtype(46341) == torch.int64


def test_make_backend_picks_device_backend(toy):
    ps, params, _ = toy
    assert isinstance(C.make_backend(ps, params), C.DeviceBackend)
    assert isinstance(C.make_backend(ps, params, exact=True), C.HostBackend)
    js = convert.params_from_numpy(
        [F.FEAT_JENSONSHANNON], [0.0], [1.0], [False],
        [(F.COMBO_SELF, [0])], [-0.5, 1.0])
    assert isinstance(C.make_backend(ps, js), C.HostBackend)
    with pytest.raises(ValueError):
        C.DeviceBackend(ps, js)


@functools.lru_cache(maxsize=None)
def banded_case(seed):
    """A corpus of 8 species x 8 reads of ~300 bp (tests/
    test_torch_accumulate.py's jax_points, trained classifier) and Phase
    A's centers under the strict intercept, where species split into
    several centers that the trained classifier then pools or merges:
    (JAX points, JAX params, points, params, members, assign, center
    rows)."""
    from meshclust_tpu_torch.core.accumulate_device import accumulate_device
    from tests.test_torch_accumulate import (jax_points, port_bv, port_case,
                                             strict_weights, with_weights)
    jps, jparams = jax_points(np.random.default_rng(seed), n_species=8,
                              per=8, length=300, rate=0.06)
    ps, params = port_case(jps, jparams)
    strict = with_weights(params, strict_weights(ps, params))
    centers = accumulate_device(ps, port_bv(ps), strict, 0.90)
    members = np.asarray([m for c in centers for m in c.members], np.int64)
    assign = np.repeat(np.arange(len(centers)),
                       [len(c.members) for c in centers])
    rows = np.asarray([c.center for c in centers], np.int64)
    return jps, jparams, ps, params, members, assign, rows


@pytest.mark.parametrize("delta", [2, 5])
def test_update_banded_equals_jax_and_host(delta):
    """update_banded against the JAX package's (points and classifier
    carried across by convert.py) and against MeanShift's host sweep with
    HostBackend (mean_select per center)."""
    from meshclust_tpu.core import classify as JC
    from meshclust_tpu_torch.core.meanshift import Center, MeanShift
    jps, jparams, ps, params, members, assign, rows = banded_case(5)
    assert rows.shape[0] >= 2 * delta
    got = C.DeviceBackend(ps, params).update_banded(members, assign, rows,
                                                    delta)
    want = JC.DeviceBackend(jps, jparams).update_banded(members, assign,
                                                        rows, delta)
    np.testing.assert_array_equal(got, want)
    centers = [Center(int(r), members[assign == j].tolist())
               for j, r in enumerate(rows)]
    MeanShift(ps, C.HostBackend(ps, params), sim=0.90, delta=delta,
              iterations=1).update_once(centers)
    host = np.asarray([c.center for c in centers])
    moved = got >= 0
    np.testing.assert_array_equal(host[moved], got[moved])
    np.testing.assert_array_equal(host[~moved], rows[~moved])
    assert (got[moved] != rows[moved]).any()

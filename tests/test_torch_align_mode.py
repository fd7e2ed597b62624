"""Align mode (--align or --id < 0.60), the port against the JAX package.

The port's AlignBackend, given the JAX package's points and an align-mode
model carried across by convert.py, must make the same decisions as the
JAX AlignBackend (classify, get_close, classify_pairs with its memo,
update_banded), bit for bit on res and f1; and the port's run() on the CPU
(every kernel through its plain PyTorch version) must write a CLSTR
byte-equal to meshclust_tpu's run() on two align-mode corpora.
"""
import numpy as np
import pytest
import torch

# The port's CPU run issues many small ops through the kernels' plain
# versions: one intra-op thread per test process keeps OpenMP from
# oversubscribing the cores under pytest-xdist.
torch.set_num_threads(1)
LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


def write_mix(path, seed, n_species, per, L, rate_lo, rate_hi):
    """The recipe of bench.py:make_viral_dataset at a small size:
    n_species random base sequences of ~L bp, `per` clones each with a
    substitution rate drawn from [rate_lo, rate_hi), every clone trimmed at
    its end by under 5%."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for s in range(n_species):
            Ls = L + int(rng.integers(-L // 12, L // 12))
            base = rng.integers(0, 4, size=Ls)
            for c in range(per):
                rate = rate_lo + (rate_hi - rate_lo) * rng.random()
                e = Ls - int(rng.integers(0, Ls // 20))
                seq = base[:e].copy()
                mut = rng.random(e) < rate
                seq[mut] = (seq[mut] + 1 + rng.integers(
                    0, 3, size=int(mut.sum()))) % 4
                f.write(b">v%d_c%d\n" % (s, c))
                f.write(LETTERS[seq].tobytes() + b"\n")
    return str(path)


# name: (corpus arguments, ClusterConfig keywords)
RUNS = {
    "id_0.50": ((3, 4, 8, 160, 0.12, 0.22), {"similarity": 0.50}),
    "align_id_0.90": ((4, 3, 8, 200, 0.03, 0.05),
                      {"similarity": 0.90, "align": True}),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_clstr_equals_jax(name, tmp_path):
    from meshclust_tpu.config import ClusterConfig as JaxConfig
    from meshclust_tpu.core.runner import run as jax_run
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.classify import AlignBackend
    from meshclust_tpu_torch.core.runner import run
    corpus, kw = RUNS[name]
    fasta = write_mix(tmp_path / "mix.fasta", *corpus)
    port_out = str(tmp_path / "port.clstr")
    jax_out = str(tmp_path / "jax.clstr")
    res = run(ClusterConfig(files=[fasta], output=port_out, **kw),
              device="cpu")
    jres = jax_run(JaxConfig(files=[fasta], output=jax_out, **kw))
    assert res["model"].k == 0 and isinstance(res["backend"], AlignBackend)
    assert jres["n_clusters"] >= 2
    with open(port_out, "rb") as a, open(jax_out, "rb") as b:
        assert a.read() == b.read()


@pytest.fixture(scope="module")
def backends():
    """The JAX and the port's AlignBackend over the same points (carried
    across by convert.py) and the same align-mode model."""
    from meshclust_tpu.core import classify as JC
    from meshclust_tpu.core.points import build_points
    from meshclust_tpu.io import fasta
    from meshclust_tpu.ops import features as JF
    from meshclust_tpu.ops.align_device import DeviceAligner as JaxAligner
    from meshclust_tpu_torch import convert
    from meshclust_tpu_torch.core.classify import AlignBackend, make_backend
    from meshclust_tpu_torch.ops.align_device import DeviceAligner
    rng = np.random.default_rng(1234)
    seqs = []
    for s in range(4):
        base = rng.integers(0, 4, size=120 + int(rng.integers(0, 30)))
        for c in range(6):
            seq = base.copy()
            if c:
                mut = rng.random(seq.shape[0]) < 0.25
                seq[mut] = (seq[mut] + 1 + rng.integers(
                    0, 3, size=int(mut.sum()))) % 4
            seqs.append(fasta.encode_record(f">x{s}_{c}",
                                            LETTERS[seq].tobytes()))
    jps = build_points(seqs, k=3, use_pallas=False)
    feat = JF.Feature(jps.V)
    feat.add_feature(JF.FEAT_ALIGN, JF.COMBO_SELF)
    feat.mins[0] = 0.0
    feat.maxs[0] = 1.0
    feat.finalize()
    jparams = feat.params(np.array([-0.50, 1.0]))
    jab = JC.AlignBackend(jps, jparams, JaxAligner(jps.codes))
    ps = convert.pointset_from_numpy(
        jps.hist, jps.mag, jps.sq, jps.lengths, jps.one_mers, jps.codes,
        jps.headers, jps.k, device="cpu")
    params = convert.params_from_numpy(
        jparams.singles, jparams.mins, jparams.maxs, jparams.is_sim,
        jparams.combos, jparams.weights)
    ab = make_backend(ps, params, aligner=DeviceAligner(ps.codes, "cpu"))
    assert isinstance(ab, AlignBackend)
    return jab, ab, ps.n


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_classify_and_get_close_equal_jax(backends):
    jab, ab, n = backends
    window = np.asarray(sorted(np.random.default_rng(5).choice(
        n, size=15, replace=False)), np.int64)
    _equal(ab.classify(3, window), jab.classify(3, window))
    got = ab.get_close(3, window)
    want = jab.get_close(3, window)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_classify_pairs_equal_jax_and_memo_symmetric(backends):
    jab, ab, _ = backends
    a_idx = np.asarray([0, 1, 2, 5, 13], np.int64)
    b_idx = np.asarray([7, 9, 2, 11, 22], np.int64)
    r1 = ab.classify_pairs(a_idx, b_idx)
    _equal(r1, jab.classify_pairs(a_idx, b_idx))
    n_before = ab.memo.keys.shape[0]
    r2 = ab.classify_pairs(b_idx, a_idx)     # swapped operands
    assert ab.memo.keys.shape[0] == n_before  # no new alignments
    _equal(r2, r1)


def test_update_banded_equals_jax(backends):
    jab, ab, n = backends
    center_rows = np.asarray([0, 6, 12, 18], np.int64)
    members = np.arange(n, dtype=np.int64)
    assign = np.repeat(np.arange(4), n // 4).astype(np.int64)
    for delta in (0, 1):
        got = ab.update_banded(members, assign, center_rows, delta)
        want = jab.update_banded(members, assign, center_rows, delta)
        np.testing.assert_array_equal(got, want)


def test_phase_b_misses_read_as_zero_like_jax(backends):
    """The reference's phase-B clone quirk: a pair first met in phase B
    aligns against an empty string, identity 0."""
    jab, ab, _ = backends
    a_idx = np.asarray([19, 20, 17], np.int64)   # pairs no other test
    b_idx = np.asarray([23, 22, 21], np.int64)   # aligns
    for backend in (jab, ab):
        backend.phase_b = True
    try:
        got = ab.classify_pairs(a_idx, b_idx)
        _equal(got, jab.classify_pairs(a_idx, b_idx))
        assert not got[0].any()
    finally:
        for backend in (jab, ab):
            backend.phase_b = False

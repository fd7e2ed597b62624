"""The port's NW alignment against the JAX package.

The plain PyTorch version of the nw_align_long kernel (ops/align.py, the
anti-diagonal wavefront) must give the same (alignment length, matches) as
the three Pallas kernels the JAX package holds for the same function, each
under the Pallas interpreter — A: the row-windowed grid kernel
(align_window.py, the default of align_device._align_packed), B: the
full-row grid kernel (MESHCLUST_ALIGN_WINDOWED=0), C: the single-block
kernel (align_pallas.batch_align_pallas) — and as the scalar oracle
tests/ref_impl.glob_align. Tolerance: exact equality (integer DP).
"""
import numpy as np
import pytest
import torch

from meshclust_tpu.ops import align_device as JAD
from meshclust_tpu.ops import align_pallas as JAP
from meshclust_tpu_torch.ops import align as A
from meshclust_tpu_torch.ops import align_device as AD
from tests import ref_impl

# The plain versions issue many small ops: one intra-op thread per test
# process keeps OpenMP from oversubscribing the cores under pytest-xdist.
torch.set_num_threads(1)
LANES = JAP.LANES


def _codes(rng, n, n_prob=0.0):
    c = rng.integers(0, 4, size=n).astype(np.uint8)
    if n_prob:
        c[rng.random(n) < n_prob] = 78
    return c


def _corpus(rng):
    """Sequences of 5-100 bp with N bytes, plus two of length 1 (the 1x1
    pairs the JAX kernels use as lane padding)."""
    codes = [_codes(rng, int(rng.integers(5, 101)), 0.05) for _ in range(30)]
    codes += [_codes(rng, 1), _codes(rng, 1)]
    return codes


def _pairs(rng, n_codes, n):
    """Random pairs, asymmetric ones included, and the 1x1 pair."""
    pairs = [(int(rng.integers(n_codes)), int(rng.integers(n_codes)))
             for _ in range(n - 3)]
    return pairs + [(n_codes - 2, n_codes - 1), (n_codes - 1, 0),
                    (0, n_codes - 2)]


def _pack(codes, pairs, ba, bb, dtype_b):
    """Operands of the JAX Pallas kernels for one 128-lane block."""
    Rpad = JAP._round_up(ba + 1, 8)
    BL = JAP._round_up(ba + bb + 2, 8)
    a_t = np.zeros((Rpad, LANES), np.int8)
    b_t = np.zeros((BL, LANES), dtype_b)
    l1 = np.ones((1, LANES), np.int32)
    l2 = np.ones((1, LANES), np.int32)
    for p, (ia, ib) in enumerate(pairs):
        a_t[1: len(codes[ia]) + 1, p] = codes[ia]
        b_t[: len(codes[ib]), p] = codes[ib]
        l1[0, p] = len(codes[ia])
        l2[0, p] = len(codes[ib])
    s = l1[0] + l2[0]
    return a_t, b_t, l1, l2, s


def _port_counts(codes, pairs):
    lpad = 128
    mat = np.zeros((len(codes), lpad), np.int8)
    for i, c in enumerate(codes):
        mat[i, : len(c)] = c
    lens = torch.tensor([len(c) for c in codes], dtype=torch.int32)
    ia = torch.tensor([p for p, _ in pairs], dtype=torch.int32)
    ib = torch.tensor([q for _, q in pairs], dtype=torch.int32)
    alen, amatch = AD.nw_align_long(torch.from_numpy(mat), lens, ia, ib,
                                    max_l2=int(lens[ib.long()].max()))
    return alen.numpy(), amatch.numpy()


@pytest.fixture
def block(rng):
    codes = _corpus(rng)
    pairs = _pairs(rng, len(codes), LANES)
    return codes, pairs, _port_counts(codes, pairs)


def test_plain_equals_oracle(block):
    codes, pairs, (alen, amatch) = block
    for t, (ia, ib) in enumerate(pairs):
        _, el, em, _ = ref_impl.glob_align(codes[ia], codes[ib])
        assert (alen[t], amatch[t]) == (el, em), f"pair {t} ({ia}, {ib})"


@pytest.mark.parametrize("windowed", ["1", "0"], ids=["kernel_A_windowed",
                                                      "kernel_B_full_row"])
def test_plain_equals_grid_kernels(block, monkeypatch, windowed):
    import jax.numpy as jnp
    codes, pairs, (alen, amatch) = block
    a_t, b_t, l1, l2, s = _pack(codes, pairs, 104, 104, np.int8)
    dmin = np.array([[s.min()]], np.int32)
    dmax = np.array([[s.max()]], np.int32)
    monkeypatch.setenv("MESHCLUST_ALIGN_WINDOWED", windowed)
    JAD._align_packed.clear_cache()
    try:
        got_len, got_match = JAD._align_packed(
            jnp.asarray(a_t), jnp.asarray(b_t), jnp.asarray(l1),
            jnp.asarray(l2), jnp.asarray(dmin), jnp.asarray(dmax), G=1,
            match=1, mismatch=-1, go=2, gc=1, interpret=True)
    finally:
        JAD._align_packed.clear_cache()
    np.testing.assert_array_equal(np.asarray(got_len), alen)
    np.testing.assert_array_equal(np.asarray(got_match), amatch)


def test_plain_equals_single_block_kernel_C(block):
    import jax.numpy as jnp
    codes, pairs, (alen, amatch) = block
    a_t, b_t, l1, l2, s = _pack(codes, pairs, 104, 104, np.int32)
    _, got_len, got_match = JAP.batch_align_pallas(
        jnp.asarray(a_t.astype(np.int32)), jnp.asarray(b_t), jnp.asarray(l1),
        jnp.asarray(l2), jnp.asarray(np.array([[s.min()]], np.int32)),
        jnp.asarray(np.array([[s.max()]], np.int32)), interpret=True)
    np.testing.assert_array_equal(np.asarray(got_len), alen)
    np.testing.assert_array_equal(np.asarray(got_match), amatch)


def test_batch_align_equals_jax_scan(rng):
    """The wavefront twin against meshclust_tpu.ops.align.batch_align (the
    XLA scan), score included, on padded operands."""
    import jax.numpy as jnp
    from meshclust_tpu.ops import align as JA
    P, ba, bb = 24, 70, 90
    s1 = np.zeros((P, ba), np.uint8)
    s2 = np.zeros((P, bb), np.uint8)
    l1 = rng.integers(1, ba + 1, size=P).astype(np.int32)
    l2 = rng.integers(1, bb + 1, size=P).astype(np.int32)
    for p in range(P):
        s1[p, : l1[p]] = _codes(rng, int(l1[p]), 0.05)
        s2[p, : l2[p]] = _codes(rng, int(l2[p]), 0.05)
    want = JA.batch_align(jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(l1),
                          jnp.asarray(l2), R=ba + 1, D=ba + bb + 1)
    got = A.batch_align(torch.from_numpy(s1.astype(np.int8)),
                        torch.from_numpy(s2.astype(np.int8)),
                        torch.from_numpy(l1), torch.from_numpy(l2))
    for g, w in zip(got, want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_device_aligner_identities_equal_jax(rng):
    """Identities through the port's DeviceAligner (staged corpus, sorted
    chunks) equal the JAX DeviceAligner's, pair for pair."""
    from meshclust_tpu_torch.ops.align_device import DeviceAligner
    codes = [_codes(rng, int(rng.integers(3, 150)), 0.03) for _ in range(25)]
    pairs = [(int(rng.integers(25)), int(rng.integers(25)))
             for _ in range(60)]
    want = JAD.DeviceAligner(codes).identities(pairs)
    al = DeviceAligner(codes, "cpu")
    assert al.probe_rounds_supported()
    got = al.identities(pairs)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float64


def test_nw_align_rejects_bad_operands():
    codes = torch.zeros((3, 128), dtype=torch.int8)
    lens = torch.tensor([5, 6, 7], dtype=torch.int32)
    idx = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError):
        AD.nw_align_long(codes.to(torch.uint8), lens, idx, idx, 7)
    with pytest.raises(ValueError):
        AD.nw_align_long(codes, lens.to(torch.int64), idx, idx, 7)
    with pytest.raises(ValueError):
        AD.nw_align_long(codes, lens, idx.to(torch.int64), idx, 7)
    with pytest.raises(ValueError):
        AD.nw_align_long(codes, torch.tensor([0, 6, 7], dtype=torch.int32),
                         idx, idx, 7)

"""The port's aligner against the JAX package's long-pair (tiled) kernel.

ops/align_device.py:DeviceAligner (the nw_align_long kernel, through its
plain PyTorch version on the CPU) must give the same (alignment length,
matches) as meshclust_tpu's tiled Pallas kernel under the Pallas
interpreter, with tiles small enough that the pairs cross several of them
(strip-to-strip, tile-to-tile and corner boundaries), as
tests/test_align_tiled.py drives it. DeviceAligner's launches must hold at
most PAIRS_PER_LAUNCH pairs, sorted by l1 + l2, and put each result back in
its pair's place. Tolerance: exact equality (integer DP).
"""
import numpy as np
import pytest
import torch

from meshclust_tpu.ops import align_tiled as JAT
from meshclust_tpu_torch.ops import align as A
from meshclust_tpu_torch.ops import align_device as AD
from tests.test_align_tiled import _pairs

# The plain version issues many small ops: one intra-op thread per test
# process keeps OpenMP from oversubscribing the cores under pytest-xdist.
torch.set_num_threads(1)


def _single_tile_and_degenerate(rng):
    return _pairs(rng, 3, 40, 100) + [
        (np.zeros(1, np.uint8), np.zeros(1, np.uint8))]


CASES = {
    # name: (pairs from rng, tile_h, tile_w)
    "multitile_related": (lambda rng: _pairs(rng, 9, 180, 520), 128, 128),
    "multitile_unrelated": (
        lambda rng: _pairs(rng, 9, 180, 520, related=False), 128, 128),
    "single_tile_and_1bp": (_single_tile_and_degenerate, 128, 128),
    "rectangular_tiles": (lambda rng: _pairs(rng, 4, 250, 400), 128, 256),
}


def _aligner(pairs):
    """A CPU DeviceAligner over the sequences of the pairs, and the index
    pairs (2t, 2t + 1) that address them."""
    codes = [c for pair in pairs for c in pair]
    return (AD.DeviceAligner(codes, "cpu"),
            [(2 * t, 2 * t + 1) for t in range(len(pairs))])


@pytest.mark.parametrize("case", sorted(CASES))
def test_align_long_batch_equals_jax_tiled(rng, case):
    make, tile_h, tile_w = CASES[case]
    pairs = make(rng)
    want = JAT.align_long_batch(pairs, tile_h=tile_h, tile_w=tile_w,
                                interpret=True)
    aligner, idx = _aligner(pairs)
    got = aligner.counts(idx)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        aligner.identities(idx),
        want[1].astype(np.float64) / np.maximum(want[0], 1.0))


@pytest.mark.parametrize("per_launch", [1, 3, 64])
def test_device_aligner_launches_sorted_chunks(rng, monkeypatch, per_launch):
    lengths = rng.integers(1, 60, size=12)
    codes = [rng.integers(0, 4, size=int(L)).astype(np.uint8)
             for L in lengths]
    pairs = [(int(rng.integers(12)), int(rng.integers(12)))
             for _ in range(20)]
    launched = []
    kernel = AD.nw_align_long

    def spy(codes_dev, lens_dev, ia, ib, max_l2, **kwargs):
        launched.append((ia.tolist(), ib.tolist(), max_l2))
        return kernel(codes_dev, lens_dev, ia, ib, max_l2, **kwargs)

    monkeypatch.setattr(AD, "PAIRS_PER_LAUNCH", per_launch)
    monkeypatch.setattr(AD, "nw_align_long", spy)
    got = AD.DeviceAligner(codes, "cpu").counts(pairs)
    assert len(launched) == -(-len(pairs) // per_launch)
    order = []
    for ia, ib, max_l2 in launched:
        assert 1 <= len(ia) <= per_launch
        assert max_l2 == max(lengths[b] for b in ib)
        order += list(zip(ia, ib))
    assert sorted(order) == sorted(pairs)
    sums = [lengths[a] + lengths[b] for a, b in order]
    assert sums == sorted(sums)
    mat = np.zeros((12, 64), np.int8)
    for i, c in enumerate(codes):
        mat[i, : len(c)] = c
    want = A.align_counts_plain(
        torch.from_numpy(mat), torch.from_numpy(lengths.astype(np.int32)),
        torch.tensor([a for a, _ in pairs], dtype=torch.int32),
        torch.tensor([b for _, b in pairs], dtype=torch.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_nw_align_long_rejects_bad_operands():
    codes = torch.zeros((3, 128), dtype=torch.int8)
    lens = torch.tensor([5, 6, 7], dtype=torch.int32)
    idx = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError):
        AD.nw_align_long(codes.to(torch.uint8), lens, idx, idx, 7)
    with pytest.raises(ValueError):
        AD.nw_align_long(codes[:, ::2], lens, idx, idx, 7)
    with pytest.raises(ValueError):
        AD.nw_align_long(codes, lens.to(torch.int64), idx, idx, 7)
    with pytest.raises(ValueError):
        AD.nw_align_long(codes, lens, idx, idx[:1], 7)
    with pytest.raises(ValueError):
        AD.nw_align_long(codes, torch.tensor([0, 6, 7], dtype=torch.int32),
                         idx, idx, 7)

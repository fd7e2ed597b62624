"""The port's k-mer featurization (meshclust_tpu_torch.ops.histogram) against
the JAX package's: the plain PyTorch version of the kmer_hist kernel on the
CPU must give bit-equal histograms, 1-mer counts, magnitudes, sums of
squares and largest counts, and histograms equal to the Pallas kernel
(histogram_pallas) run in interpret mode. Tolerance: exact equality, since
every compared quantity is an integer.
"""
import numpy as np
import pytest
import torch

from meshclust_tpu.io import fasta as jfio
from meshclust_tpu.ops import histogram as JH
from meshclust_tpu_torch.ops import histogram as H

# One intra-op thread per test process (no OpenMP oversubscription under
# pytest-xdist).
torch.set_num_threads(1)
LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


def _records(seed, n=40):
    """Reads of 150-300 bp (a third with N runs that split or shorten their
    segments) plus records under 20 bp, which have no segment at all."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(150, 301))
        raw = LETTERS[rng.integers(0, 4, size=L)].copy()
        if i % 3 == 0:
            p = int(rng.integers(0, L - 60))
            raw[p: p + int(rng.integers(3, 40))] = ord("N")
        out.append((f">r{i}", raw.tobytes()))
    for i in range(4):
        L = int(rng.integers(5, 20))
        out.append((f">s{i}", LETTERS[rng.integers(0, 4, size=L)].tobytes()))
    return out


def _seqs(records):
    return [jfio.encode_record(h, s) for h, s in records]


@pytest.mark.parametrize("k", [1, 3, 4, 5, 7])
def test_featurize_equals_jax(k):
    seqs = _seqs(_records(k))
    want = JH.featurize(seqs, k, use_pallas=False)
    got = H.featurize(seqs, k, torch.device("cpu"))
    hist = got["hist_dev"].numpy()
    assert hist.dtype == np.dtype(JH.storage_dtype(want["largest"]))
    np.testing.assert_array_equal(hist.astype(np.int64),
                                  want["hist"].astype(np.int64))
    for key in ("one_mers", "mag", "sq", "lengths"):
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == np.int64
    assert got["largest"] == want["largest"]
    assert got["V"] == want["V"] == 4 ** k


@pytest.mark.parametrize("k", [1, 3, 4, 5, 7])
def test_plain_version_equals_pallas_interpret(k):
    """kmer_hist's plain version on one padded batch with explicit masks,
    against histogram_pallas (the TPU kernel) under the interpreter."""
    import jax.numpy as jnp
    seqs = _seqs(_records(100 + k, n=12))
    Lp = H.round_up(max(max(s.length for s in seqs), H.LANE), H.LANE)
    codes, valid, inseg = JH.pad_batch(seqs, k, pad_to=Lp)
    want = np.asarray(JH.histogram_pallas(
        jnp.asarray(codes), jnp.asarray(valid), k, init=1, interpret=True))
    packed, lens, valid_t, inseg_t = H.batch_inputs(seqs, k, Lp, "cpu")
    counts, ones, mag, sq = H.kmer_hist(packed, lens, valid_t, inseg_t, k)
    np.testing.assert_array_equal(counts.numpy(), want)
    np.testing.assert_array_equal(mag.numpy(), want.astype(np.int64).sum(1))


def test_length_masks_equal_explicit_masks():
    """Single-segment batches derive their masks from the lengths; that
    must count exactly what the explicit masks of pad_batch count."""
    rng = np.random.default_rng(7)
    seqs = _seqs([(f">r{i}", LETTERS[rng.integers(0, 4, size=int(
        rng.integers(20, 300)))].tobytes()) for i in range(30)])
    Lp = 384
    packed, lens, valid, inseg = H.batch_inputs(seqs, 4, Lp, "cpu")
    assert valid is None and inseg is None
    codes, v, s = H.pad_batch(seqs, 4, pad_to=Lp)
    derived = H.kmer_hist(packed, lens, None, None, 4)
    explicit = H.kmer_hist(packed, lens, torch.from_numpy(v),
                           torch.from_numpy(s), 4)
    for a, b in zip(derived, explicit):
        assert torch.equal(a, b)


def test_kmer_hist_rejects_bad_operands():
    packed = torch.zeros((2, 32), dtype=torch.uint8)
    lens = torch.tensor([10, 20], dtype=torch.int32)
    with pytest.raises(ValueError):
        H.kmer_hist(packed.to(torch.int32), lens, None, None, 3)
    with pytest.raises(ValueError):
        H.kmer_hist(packed, lens.to(torch.int64), None, None, 3)
    with pytest.raises(ValueError):
        H.kmer_hist(packed, lens, torch.zeros((2, 128), dtype=torch.uint8),
                    None, 3)
    with pytest.raises(ValueError):
        H.kmer_hist(packed, lens, None, None, 16)


def test_find_k_and_storage_dtype_equal_jax():
    seqs = _seqs(_records(3))
    assert H.find_k([seqs]) == JH.find_k([seqs])
    assert H.find_k([seqs[:10], seqs[10:]]) == JH.find_k([seqs[:10],
                                                          seqs[10:]])
    for largest in (0, 127, 128, 32767, 32768, 2 ** 31):
        assert H.storage_dtype(largest) == JH.storage_dtype(largest)

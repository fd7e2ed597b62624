"""The port's k-mer featurization (meshclust_tpu_torch.ops.histogram) against
the JAX package's: the plain PyTorch version of the kmer_hist kernel on the
CPU, fed the parser's flat codes, must give bit-equal histograms, storage
dtypes, 1-mer counts, magnitudes, sums of squares and largest counts, and
histograms equal to the Pallas kernel (histogram_pallas) run in interpret
mode, for k from 1 to 8. Tolerance: exact equality, since
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


KS = [1, 3, 4, 5, 6, 7, 8]


def _flat(seqs):
    return tuple(torch.from_numpy(a) for a in H.flat_inputs(seqs))


def _check_featurize(seqs, k):
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


@pytest.mark.parametrize("k", KS)
def test_featurize_equals_jax(k):
    _check_featurize(_seqs(_records(k)), k)


@pytest.mark.parametrize("k", [4, 6])
def test_featurize_chunked_segment_equals_jax(k):
    """A record longer than 2 x SEG_LENGTH, whose segment is chunked (no
    k-mer spans the chunk boundary), beside two short records and an N
    run: few records, so the JAX side's padded batch stays small."""
    rng = np.random.default_rng(20 + k)
    L = 2 * jfio.SEG_LENGTH + 2307
    raw = LETTERS[rng.integers(0, 4, size=L)].copy()
    raw[1500: 1530] = ord("N")
    seqs = _seqs([(">long", raw.tobytes())] + _records(k, n=2)[:2])
    assert seqs[0].segments.shape[0] == 3
    assert seqs[0].segments[1, 0] == seqs[0].segments[0, 1] + 1 \
        or seqs[0].segments[2, 0] == seqs[0].segments[1, 1] + 1
    _check_featurize(seqs, k)


@pytest.mark.parametrize("k", KS)
def test_plain_version_equals_pallas_interpret(k):
    """kmer_hist (its plain version, on the CPU) on the flat codes, against
    histogram_pallas (the TPU kernel) under the interpreter on the JAX
    package's padded batch with explicit masks."""
    import jax.numpy as jnp
    seqs = _seqs(_records(100 + k, n=12))
    codes, valid, inseg = JH.pad_batch(seqs, k)
    want = np.asarray(JH.histogram_pallas(
        jnp.asarray(codes), jnp.asarray(valid), k, init=1, interpret=True))
    counts, ones, mag, sq, largest = H.kmer_hist(*_flat(seqs), k)
    np.testing.assert_array_equal(counts.numpy(), want)
    np.testing.assert_array_equal(mag.numpy(), want.astype(np.int64).sum(1))
    np.testing.assert_array_equal(
        sq.numpy(), (want.astype(np.int64) ** 2).sum(1))
    assert int(largest[0]) == int(want.max())
    np.testing.assert_array_equal(ones.numpy(), np.asarray(
        JH.one_mer_counts(jnp.asarray(codes), jnp.asarray(inseg))))


def test_length_masks_equal_explicit_masks():
    """Records that are one whole segment, and the same records with their
    segments spelt out as explicit lists of pieces that touch (as chunking
    leaves them): the first count what the length-derived masks count,
    the second what io.fasta's explicit masks count."""
    rng = np.random.default_rng(7)
    seqs = _seqs([(f">r{i}", LETTERS[rng.integers(0, 4, size=int(
        rng.integers(20, 300)))].tobytes()) for i in range(30)])
    assert all(s.segments.tolist() == [[0, s.length - 1]] for s in seqs)
    pieces = []
    for s in seqs:
        cut = int(rng.integers(1, s.length))
        pieces.append(jfio.Sequence(s.header, s.codes, np.asarray(
            [[0, cut - 1], [cut, s.length - 1]], np.int64)))
    k = 4
    for batch in (seqs, pieces):
        counts, ones, _, _, _ = H.kmer_hist(*_flat(batch), k, init=0)
        for r, s in enumerate(batch):
            starts = np.nonzero(jfio.kmer_valid_starts(s, k))[0]
            ids = np.zeros(starts.shape[0], np.int64)
            for i in range(k):
                ids = ids * 4 + s.codes[starts + i]
            np.testing.assert_array_equal(
                counts[r].numpy(), np.bincount(ids, minlength=4 ** k))
            np.testing.assert_array_equal(ones[r].numpy(), np.bincount(
                s.codes[jfio.in_segment_mask(s)], minlength=4))
    whole = H.kmer_hist(*_flat(seqs), k)[0]
    split = H.kmer_hist(*_flat(pieces), k)[0]
    assert int((whole - split).min()) >= 0
    assert int((whole - split).sum()) == sum(
        min(k - 1, c, s.length - c) for s, c in
        zip(seqs, (int(p.segments[1, 0]) for p in pieces)))


def test_flat_inputs_equal_the_native_parser(tmp_path):
    """flat_inputs of the parsed records is what parse_fasta_native
    returns, the codes padded to a multiple of BLOCK bytes."""
    from meshclust_tpu_torch import native
    from meshclust_tpu_torch.io import fasta as fio
    path = tmp_path / "c.fasta"
    with open(path, "wb") as f:
        for h, s in _records(5):
            f.write(h.encode() + b"\n" + s + b"\n")
    parsed = native.parse_fasta_native(str(path))
    if parsed is None:
        pytest.skip("the native parser did not build here (no g++)")
    _, codes, rec_off, segs, seg_off = parsed
    got = H.flat_inputs(fio.read_fasta(str(path)))
    assert got[0].shape[0] % H.BLOCK == 0
    np.testing.assert_array_equal(got[0][: codes.shape[0]], codes)
    assert not got[0][codes.shape[0]:].any()
    for a, b in zip(got[1:], (rec_off, segs, seg_off)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int64


def test_kmer_hist_rejects_bad_operands():
    codes, rec_off, segs, seg_off = _flat(_seqs(_records(1, n=3)))
    with pytest.raises(ValueError):
        H.kmer_hist(codes.to(torch.int32), rec_off, segs, seg_off, 3)
    with pytest.raises(ValueError):
        H.kmer_hist(codes[:-1], rec_off, segs, seg_off, 3)
    with pytest.raises(ValueError):
        H.kmer_hist(codes, rec_off.to(torch.int32), segs, seg_off, 3)
    with pytest.raises(ValueError):
        H.kmer_hist(codes, rec_off, segs.reshape(-1), seg_off, 3)
    with pytest.raises(ValueError):
        H.kmer_hist(codes, rec_off, segs, seg_off[:-1], 3)
    with pytest.raises(ValueError):
        H.kmer_hist(codes, rec_off, segs, seg_off, 16)


def test_find_k_and_storage_dtype_equal_jax():
    seqs = _seqs(_records(3))
    assert H.find_k([seqs]) == JH.find_k([seqs])
    assert H.find_k([seqs[:10], seqs[10:]]) == JH.find_k([seqs[:10],
                                                          seqs[10:]])
    for largest in (0, 127, 128, 32767, 32768, 2 ** 31):
        assert H.storage_dtype(largest) == JH.storage_dtype(largest)

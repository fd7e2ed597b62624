"""The port's Red (meshclust_tpu_torch.red) against the JAX package's.

On genomes whose non-N runs are all shorter than a segment chunk
(fasta.SEG_LENGTH, 1 Mbp) the two must agree byte for byte: the .rpt, .msk
and .scr files, the adjusted k-mer table, the percentage p and the HMM.
Where they are meant to differ, the tests show both sides:
- a run longer than a chunk is cut into adjacent chunks, and the reference
  counts each chunk on its own: the port's table equals that per-chunk
  count, and the JAX package's, which also counts the k-mers that span the
  cut, does not;
- the masked output pairs each one-digit record with the plain record of
  the same index, so records with the same header and length are masked
  from their own letters.
"""
import os

import numpy as np
import pytest

from meshclust_tpu.io import fasta as jfio
from meshclust_tpu.red import emv as jemv
from meshclust_tpu.red.runner import RedConfig as JaxRedConfig
from meshclust_tpu.red.runner import run_red as jax_run_red
from meshclust_tpu_torch import native
from meshclust_tpu_torch.io import fasta as pfio
from meshclust_tpu_torch.red import emv as pemv
from meshclust_tpu_torch.red import scorer as pscorer
from meshclust_tpu_torch.red.__main__ import main as red_main
from meshclust_tpu_torch.red.hmm import HMM
from meshclust_tpu_torch.red.runner import RedConfig, run_red
from tests.conftest import random_dna
from tests.test_red import _genome_with_repeats

OUTPUTS = ("rpt", "msk", "sco")


def _write_fa(path, records, width=70):
    with open(path, "w") as f:
        for header, seq in records:
            f.write(f">{header}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i: i + width] + "\n")


def _planted(d):
    """tests/test_red.py's 60 kb genome: 40 copies of a 600 bp motif."""
    seq, _ = _genome_with_repeats(np.random.default_rng(5))
    _write_fa(os.path.join(d, "chr1.fa"), [("chr1", seq)])


def _two_chromosomes(d):
    """Two records in one file and a third in another: 3 motifs planted in
    random background, N runs (some merged into segments, some not), lower
    case and IUPAC letters that the masked output must keep."""
    rng = np.random.default_rng(21)
    motifs = [random_dna(rng, 500) for _ in range(3)]

    def chromosome(n_parts):
        parts = []
        for i in range(n_parts):
            parts.append(random_dna(rng, int(rng.integers(600, 1500))))
            if i % 4 == 1:
                parts.append("N" * int(rng.integers(3, 200)))
            parts.append(motifs[int(rng.integers(3))])
        s = list("".join(parts))
        for p in rng.integers(0, len(s), size=30):
            s[p] = "RYKMSW"[int(rng.integers(6))] if s[p] != "N" else "N"
        return "".join(s)

    a, b, c = chromosome(30), chromosome(24), chromosome(12)
    _write_fa(os.path.join(d, "chrA.fa"),
              [("chrA first", a.lower()[:5000] + a[5000:]), ("chrB", b)])
    _write_fa(os.path.join(d, "chrC.fa"), [("chrC", c)], width=61)


GENOMES = {"planted_60kb": _planted, "two_chromosomes": _two_chromosomes}


def _run_both(gdir, out):
    """Port and JAX run_red on gdir at k = 12, every output directory."""
    dirs = {}
    for name, cfg_cls, fn in (("port", RedConfig, run_red),
                              ("jax", JaxRedConfig, jax_run_red)):
        dirs[name] = {o: os.path.join(out, name, o) for o in OUTPUTS}
        res = fn(cfg_cls(gnm=gdir, k=12, **dirs[name]))
        dirs[name]["res"] = res
    return dirs


@pytest.fixture(scope="module", params=sorted(GENOMES))
def both(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"red_{request.param}")
    gdir = os.path.join(d, "genome")
    os.makedirs(gdir)
    GENOMES[request.param](gdir)
    return _run_both(gdir, str(d))


def test_red_outputs_equal_jax(both):
    port, jax = both["port"], both["jax"]
    for o in OUTPUTS:
        names = sorted(os.listdir(jax[o]))
        assert names and names == sorted(os.listdir(port[o]))
        for name in names:
            with open(os.path.join(port[o], name), "rb") as a, \
                    open(os.path.join(jax[o], name), "rb") as b:
                assert a.read() == b.read(), (o, name)
    assert any(r for _, r in port["res"]["results"])


def test_red_model_equals_jax(both):
    port, jax = both["port"]["res"], both["jax"]["res"]
    assert np.array_equal(port["table"], jax["table"])
    assert port["table"].max() > 0
    assert port["p"] == jax["p"]
    assert (port["k"], port["order"], port["gau"]) \
        == (jax["k"], jax["order"], jax["gau"])
    assert np.array_equal(port["hmm"].trans, jax["hmm"].trans)
    assert np.array_equal(port["hmm"].priors, jax["hmm"].priors)
    assert port["results"] == jax["results"]


def test_red_cli(tmp_path):
    gdir = tmp_path / "genome"
    gdir.mkdir()
    _planted(str(gdir))
    assert red_main(["-gnm", str(gdir), "-rpt", str(tmp_path / "rpt"),
                     "-len", "12", "-frm", "2"]) == 0
    lines = (tmp_path / "rpt" / "chr1.rpt").read_text().splitlines()
    assert lines and all(line.startswith("chr1\t") for line in lines)


# -- a non-N run longer than one chunk ---------------------------------------

CHUNKED_LEN = 2_500_000
CUT = pfio.SEG_LENGTH          # the first chunk is [0, SEG_LENGTH)


@pytest.fixture(scope="module")
def chunked():
    """One N-free 2.5 Mbp chromosome, so two chunks meet at CUT. A 100 bp
    motif lies across the cut and twice elsewhere: each 12-mer that spans
    the cut then occurs 3 times if spanning windows count and 2 times if
    they do not, on either side of the table's min_obs of 3."""
    rng = np.random.default_rng(3)
    letters = np.frombuffer(b"ACGT", np.uint8)
    raw = letters[rng.integers(0, 4, CHUNKED_LEN)].copy()
    motif = raw[10_000: 10_100].copy()
    raw[CUT - 50: CUT + 50] = motif
    raw[1_700_000: 1_700_100] = motif
    seq_p = pfio.encode_record(">chunked", raw.tobytes())
    seq_j = jfio.encode_record(">chunked", raw.tobytes())
    assert seq_p.segments.tolist() == [[0, CUT - 1], [CUT, CHUNKED_LEN - 1]]
    # the same chunks as separate records: nothing can span them
    per_chunk = [jfio.Sequence(header=">c", codes=seq_j.codes[a: b + 1],
                               segments=np.array([[0, b - a]], np.int64))
                 for a, b in seq_j.segments]
    return {"port": seq_p, "jax": seq_j, "per_chunk": per_chunk,
            "want": jemv.build_table(per_chunk, 12, 5),
            "port_table": pemv.build_table([seq_p], 12, 5),
            "jax_table": jemv.build_table([seq_j], 12, 5)}


def _per_chunk_counts(seq, wl):
    """np.bincount of the wl-mers at fasta.kmer_valid_starts."""
    c = (seq.codes & 3).astype(np.int64)
    n = seq.length - wl + 1
    ids = np.zeros(n, np.int64)
    for d in range(wl):
        ids = ids * 4 + c[d: d + n]
    starts = pfio.kmer_valid_starts(seq, wl)[:n]
    return np.bincount(ids[starts], minlength=4 ** wl)


def test_chunked_counts_are_per_chunk(chunked):
    wls = [1, 2, 6, 12]
    got = pemv.count_words_multi([chunked["port"]], wls)
    jax = jemv.count_words_multi([chunked["jax"]], wls)
    for wl in wls:
        want = _per_chunk_counts(chunked["port"], wl)
        assert np.array_equal(got[wl], want), wl
        # the JAX package also counts the wl - 1 windows across the cut
        assert int(jax[wl].sum() - want.sum()) == wl - 1, wl


def test_chunked_table_equals_per_chunk_table(chunked):
    want, got, jax = (chunked["want"], chunked["port_table"],
                      chunked["jax_table"])
    assert np.array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert not np.array_equal(jax[0], want[0])
    assert jax[1] == want[1]


def test_scores_ignore_spanning_windows(chunked):
    """score_chromosome lets the windows across the cut through rolling_ids
    (it passes no segments) and then overwrites the last k - 1 positions
    of every chunk: its scores equal those built from the per-chunk
    windows alone."""
    seq, table, k = chunked["port"], chunked["port_table"][0], 12
    scores = pscorer.score_chromosome(seq, table, k)
    ids, ok = pemv.rolling_ids(seq.codes, pemv.valid_mask(seq), k,
                               seq.segments)
    _, ok_spanning = pemv.rolling_ids(seq.codes, pemv.valid_mask(seq), k)
    assert np.flatnonzero(ok_spanning & ~ok).tolist() \
        == list(range(CUT - k + 1, CUT))
    want = np.zeros(seq.length, np.int64)
    want[np.flatnonzero(ok)] = table[ids[ok]]
    for a, b in seq.segments:
        want[b - k + 2: b + 1] = want[b - k + 1]
    assert np.array_equal(scores, want)
    assert scores[CUT - 12: CUT + 12].any()


def test_chunk_tails_are_the_starts_kmer_valid_starts_drops():
    codes = np.zeros(3000, np.uint8)
    segs = np.array([[0, 999], [1000, 1999], [2030, 2999]], np.int64)
    seq = pfio.Sequence(header=">s", codes=codes, segments=segs)
    for wl in (1, 2, 7, 16):
        n = seq.length - wl + 1
        _, ok = pemv.rolling_ids(codes, pemv.valid_mask(seq), wl, segs)
        assert np.array_equal(ok, pfio.kmer_valid_starts(seq, wl)[:n]), wl


# -- masked output pairing ----------------------------------------------------

def test_duplicate_headers_masked_from_their_own_letters(tmp_path):
    """Two records share header and length; the second's letters differ.
    Each masked record must be its own letters with repeats lower-cased.
    The JAX package pairs by (header, length), so its second record
    carries the first's letters."""
    rng = np.random.default_rng(8)
    motif = random_dna(rng, 400)
    parts = []
    for _ in range(30):
        parts += [random_dna(rng, 1200), motif]
    first = "".join(parts)
    second = list(first)
    for p in rng.choice(len(second), size=2000, replace=False):
        second[p] = "ACGT"[("ACGT".index(second[p]) + 1) % 4]
    second = "".join(second)
    gdir = tmp_path / "genome"
    gdir.mkdir()
    _write_fa(gdir / "dup.fa", [("chrU", first), ("", ""), ("chrU", second)])
    outs = {}
    for name, cfg_cls, fn in (("port", RedConfig, run_red),
                              ("jax", JaxRedConfig, jax_run_red)):
        outs[name] = tmp_path / name
        res = fn(cfg_cls(gnm=str(gdir), msk=str(outs[name]), k=12))
        assert len(res["results"]) == 2     # the empty record is dropped
        assert any(r for _, r in res["results"])
    port = pfio.read_fasta_plain(str(outs["port"] / "dup.msk"))
    jax = pfio.read_fasta_plain(str(outs["jax"] / "dup.msk"))
    with open(outs["port"] / "dup.msk") as f:
        masked = [line for line in f if not line.startswith(">")]
    assert any(c.islower() for line in masked for c in line)
    assert [h for h, _ in port] == [">chrU", ">chrU"]
    assert [s for _, s in port] == [first, second]
    assert [s for _, s in jax] == [first, first]


# -- the HMM ------------------------------------------------------------------

def test_native_viterbi_equals_numpy_loop(monkeypatch):
    assert native.get_red_viterbi() is not None
    rng = np.random.default_rng(4)
    hmm = HMM(2.0, 12)
    scores = rng.integers(0, 6, size=5000)
    hmm.train(scores, np.array([[0, 4999]]), [[100, 800], [2000, 2600]])
    hmm.normalize()
    fast = hmm.decode_states(scores, 10, 4900)
    monkeypatch.setattr(native, "red_viterbi", lambda *a: None)
    slow = hmm.decode_states(scores, 10, 4900)
    assert np.array_equal(fast, slow)

"""The corpus generator: the same seed gives the same corpus, every seed
the same sizes, and the mixes their stated shapes."""
import numpy as np
import pytest

from benchmark import spec as S

GEN = S.generator("species_clones")


def read(path):
    heads, seqs = [], []
    with open(path) as f:
        for line in f:
            (heads if line.startswith(">") else seqs).append(line.strip())
    return heads, seqs


def small(name):
    t = S.traffic(name)
    t["reads"] = 20 * (t["reads"] // 1000 or 4)
    if t["species_sizes"]["law"] == "fixed":
        t["species_sizes"]["size"] = 10
    return t


@pytest.mark.parametrize("name", ["r15k", "genomes", "rare15k"])
def test_same_seed_same_corpus_other_seed_same_sizes(tmp_path, name):
    t = small(name)
    a = GEN.make(t, 2**31 + 11, 1, str(tmp_path / "a.fa"))
    b = GEN.make(t, 2**31 + 11, 1, str(tmp_path / "b.fa"))
    c = GEN.make(t, 7, 1, str(tmp_path / "c.fa"))
    assert a == b == c
    assert (tmp_path / "a.fa").read_bytes() == (tmp_path / "b.fa").read_bytes()
    ha, sa = read(tmp_path / "a.fa")
    hc, sc = read(tmp_path / "c.fa")
    assert ha == hc and [len(s) for s in sa] == [len(s) for s in sc]
    assert sa != sc
    assert len(sa) == a["reads"] == t["reads"]
    assert sum(len(s) for s in sa) == a["bases"]
    assert set("".join(sa)) <= set("ACGT")


def test_r15k_is_150_species_of_100_clones_of_about_1kb():
    t = S.traffic("r15k")
    for i in range(t["pool"]):
        sh = GEN.shape(t, i)
        assert list(sh["sizes"]) == [100] * 150
        assert sh["base_len"].min() >= 900 and sh["base_len"].max() < 1100
        trim = np.repeat(sh["base_len"], sh["sizes"]) - sh["keep"]
        assert trim.min() >= 0 and (trim <= sh["keep"] // 49).all()
        assert (sh["rate"] == 0.03).all()


def test_genomes_are_6_species_of_50_of_9_to_12_kb():
    t = S.traffic("genomes")
    sh = GEN.shape(t, 0)
    assert list(sh["sizes"]) == [50] * 6
    assert sh["base_len"].min() >= 9000 and sh["base_len"].max() < 12000
    assert sh["rate"].min() >= 0.12 and sh["rate"].max() < 0.22


def test_rare15k_is_a_zipf_tail_of_2500_to_3400_species_60pc_singletons():
    t = S.traffic("rare15k")
    for i in range(t["pool"]):
        sizes = GEN.shape(t, i)["sizes"]
        assert sizes.sum() == 15000 and sizes.max() <= 1000
        assert 2400 <= sizes.shape[0] <= 3700
        assert 0.55 <= (sizes == 1).mean() <= 0.66

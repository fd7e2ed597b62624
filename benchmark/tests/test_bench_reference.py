"""The plain reference against the program's own host pieces on the CPU,
and its independence: it imports nothing of the program or of JAX."""
import ast
import os

import numpy as np
import pytest
import torch

from benchmark import spec as S
from benchmark.reference import bvec as RB
from benchmark.reference import kmer, nw, stdsort

REF = os.path.join(S.HERE, "reference")


@pytest.mark.parametrize("n,distinct", [(0, 1), (5, 2), (17, 3), (200, 7),
                                        (1000, 40), (3000, 3000),
                                        (4000, 1)])
def test_stdsort_replays_libstdcxx(n, distinct):
    from meshclust_tpu_torch import native
    if native.get_refsort() is None:
        pytest.skip("the program's native std::sort helper did not build")
    rng = np.random.default_rng(n + distinct)
    keys = rng.integers(0, distinct, size=n).astype(np.int64)
    want = np.arange(n, dtype=np.int32)
    native.ref_sort_perm(want, keys)
    got = list(range(n))
    stdsort.sort_perm(got, keys.tolist())
    assert got == want.tolist()


def test_bvec_bins_and_queries_equal_the_programs():
    from meshclust_tpu_torch.core.bvec import BVec
    rng = np.random.default_rng(3)
    lengths = rng.integers(900, 1100, size=5000).astype(np.int64)
    a, b = BVec(lengths.copy(), 1000), RB.BVec(lengths.copy(), 1000)
    for x in (a, b):
        x.bulk_insert(lengths)
        x.insert_finalize()
    for i in range(len(a.idx)):
        assert np.array_equal(a.idx[i], b.idx[i])
    for length in (850, 900, 950, 1000, 1099, 1200):
        ra = a.get_range(int(length * 0.9), int(length / 0.9))
        assert ra == b.get_range(int(length * 0.9), int(length / 0.9))
        assert np.array_equal(a.window(*ra)[0], b.window(*ra)[0])
    assert a.pop() == b.pop()


def test_histograms_and_k_equal_the_programs_featurization(tmp_path):
    from meshclust_tpu_torch.core.points import build_points
    from meshclust_tpu_torch.io import fasta as fio
    from meshclust_tpu_torch.ops import histogram as H
    from benchmark.reference import corpus
    t = S.traffic("r15k")
    t["reads"] = 60
    t["species_sizes"]["size"] = 12
    path = str(tmp_path / "c.fa")
    S.generator("species_clones").make(t, 5, 0, path)
    with open(path, "a") as f:
        f.write(">short\nACGTACGTAC\n")
    seqs = fio.read_fasta(path)
    k = H.find_k([seqs])
    ps = build_points(seqs, k, torch.device("cpu"))
    heads, codes = corpus.read_fasta(path)
    lengths = np.asarray([c.shape[0] for c in codes])
    assert heads == ps.headers and kmer.find_k(lengths) == k
    hist = kmer.histograms(codes, k)
    assert np.array_equal(hist, np.asarray(ps.hist, np.int64))
    assert np.array_equal(hist.sum(1), ps.mag)


def test_nw_identities_equal_the_programs_aligner():
    from meshclust_tpu_torch.ops.align_device import DeviceAligner
    rng = np.random.default_rng(4)
    base = rng.integers(0, 4, size=300)
    codes = []
    for _ in range(8):
        s = base.copy()
        m = rng.random(300) < 0.15
        s[m] = (s[m] + rng.integers(1, 4, size=m.sum())) % 4
        codes.append(s[: 300 - rng.integers(0, 30)].astype(np.uint8))
    pairs = [(i, j) for i in range(8) for j in range(8) if i != j]
    want = DeviceAligner(codes, torch.device("cpu")).identities(pairs)
    assert np.array_equal(nw.identities(codes, pairs, "cpu"), want)
    bad = nw.identities(codes, pairs, "cpu", continue_first=True)
    assert (bad != want).any()


def test_the_reference_imports_nothing_of_the_program_or_jax():
    for name in sorted(os.listdir(REF)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REF, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "meshclust_tpu",
                                   "meshclust_tpu_torch"), (name, m)
                assert top in ("__future__", "benchmark", "numpy", "torch",
                               "typing", "dataclasses", "math", "ctypes",
                               "bisect"), (name, m)
                assert top != "benchmark" or \
                    m.startswith("benchmark.reference"), (name, m)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("similarity", [0.5, 0.59, 0.6, 0.9])
def test_align_mode_is_the_programs_rule(similarity, align):
    from meshclust_tpu_torch.config import ClusterConfig
    from benchmark.reference import solve
    flags = {"similarity": similarity, "align": align}
    want = ClusterConfig(similarity=similarity, align=align).finalize().align
    assert solve.align_mode(flags) is want
    if not align:
        assert solve.align_mode({"similarity": similarity}) is want

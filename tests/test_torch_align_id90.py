"""Align mode at --id 0.90 chosen by the `align` flag (MeShClust's
`--id 0.90 --align`), on short reads: the port's run on the CPU against the
benchmark's plain reference (benchmark/reference/, numpy and torch, neither
the program nor JAX), and the spans and counters of align mode's host
Phase A and Phase B.

A k-mer run keeps its own spans: none of align mode's host path."""
import numpy as np
import pytest
import torch

from benchmark.capture import Capture, settle
from benchmark.generators import species_clones
from benchmark.reference import solve
from meshclust_tpu_torch.config import ClusterConfig
from meshclust_tpu_torch.core.classify import AlignBackend
from meshclust_tpu_torch.core.meanshift import MeanShift
from meshclust_tpu_torch.core.runner import run
from meshclust_tpu_torch.ops.align_device import DeviceAligner
from meshclust_tpu_torch.utils import perf
from tests.test_torch_end2end import write_corpus

torch.set_num_threads(1)

# The benchmark's r15k mix cut to 240 reads of ~400 bases: 6 species of 40
# clones, 3% substitutions, ends trimmed by under 2%.
MIX = {"generator": "species_clones", "pool": 1, "shape_seed": 240,
       "reads": 240, "species_sizes": {"law": "fixed", "size": 40},
       "length": {"mean": 400, "spread": 40}, "trim_div": 50,
       "trim_min": 2, "substitution": {"low": 0.03, "high": 0.03}}
FLAGS = {"similarity": 0.9, "align": True, "delta": 5, "iterations": 15,
         "kmer": None, "exact": False}
SEED = 3141592653    # larger than 32 signed bits hold
SPANS = ("accum_bvec", "accum_mean", "align_memo", "align_batch",
         "update_mean")
COUNTERS = ("accum_host_iters", "memo_lookups", "nw_calls")


@pytest.fixture(scope="module")
def align_run(tmp_path_factory):
    """One align-mode job on the CPU: its captured state, the spans and
    counters it recorded, and the calls the test's wrappers counted. (The
    aligner's plain version takes ~35 s of the CPU for its ~1,100 pairs.)"""
    seed = SEED
    tmp = tmp_path_factory.mktemp(f"align_id90_{seed}")
    fasta = str(tmp / "mix.fasta")
    species_clones.make(MIX, seed, 0, fasta)
    seen = {"get_close": 0, "nw_in_a": 0, "nw_outside": 0}
    in_a = [False]
    originals = [(AlignBackend, "get_close"), (MeanShift, "accumulate_all"),
                 (DeviceAligner, "identities")]
    saved = [(cls, name, getattr(cls, name)) for cls, name in originals]
    get_close, accumulate_all, identities = (s[2] for s in saved)

    def counted_get_close(self, *a, **kw):
        seen["get_close"] += 1
        return get_close(self, *a, **kw)

    def marked_accumulate_all(self, *a, **kw):
        in_a[0] = True
        try:
            return accumulate_all(self, *a, **kw)
        finally:
            in_a[0] = False

    def counted_identities(self, pairs):
        if len(pairs):
            seen["nw_in_a" if in_a[0] else "nw_outside"] += 1
        return identities(self, pairs)
    AlignBackend.get_close = counted_get_close
    MeanShift.accumulate_all = marked_accumulate_all
    DeviceAligner.identities = counted_identities
    cap = Capture()
    try:
        cap.active = True
        perf.reset()
        res = run(ClusterConfig(files=[fasta], output=str(tmp / "out.clstr"),
                                **FLAGS), device="cpu")
        report = perf.report()
        perf.reset()
        state = settle(cap.take(res))
    finally:
        cap.restore()
        for cls, name, orig in saved:
            setattr(cls, name, orig)
    with open(tmp / "out.clstr") as f:
        state["clstr"] = f.read()
    return {"seed": seed, "fasta": fasta, "state": state, "report": report,
            "seen": seen}


def test_clstr_and_phase_a_equal_the_plain_reference(align_run):
    """The reference recomputes k, the histograms, 64 of the job's NW
    identities and every decision taken from the identities: Phase A's
    centers and members and the CLSTR are the program's."""
    st = align_run["state"]
    assert solve.align_mode(FLAGS)
    rng = np.random.default_rng([align_run["seed"], 104729])
    sample = solve.sample_pairs(list(st["aligned"]), 64, rng)
    ref = solve.solve(align_run["fasta"], FLAGS, None, sample,
                      st["aligned"], torch.device("cpu"))
    assert len(ref["aligned"]) == len(sample) == 64
    numbers = solve.compare(st, ref, True)
    assert numbers == {"k": 0, "hist_rows": 0, "nw_pairs": 0, "phase_a": 0,
                       "clstr_lines": 0}
    # the reference's own Phase A, member for member
    assert [tuple(c) for c in ref["phase_a"]] == st["phase_a"]
    assert len(st["phase_a"]) >= 6


def test_host_path_records_its_spans_and_counters(align_run):
    r = align_run["report"]
    phases, counters, seen = r["phases_s"], r["counters"], align_run["seen"]
    assert set(SPANS) <= set(phases)
    assert set(COUNTERS) <= set(counters)
    # one pass of the host Phase A loop is one get_close call
    assert counters["accum_host_iters"] == seen["get_close"] > 0
    assert r["phase_calls"]["accum_mean"] + len(
        align_run["state"]["phase_a"]) == seen["get_close"]
    # one nw call an aligner call with pairs; Phase A's at most one an
    # iteration, the rest training's (none at fixed align weights)
    assert counters["nw_calls"] == seen["nw_in_a"] + seen["nw_outside"]
    assert seen["nw_in_a"] <= counters["accum_host_iters"]
    assert counters["nw_calls"] <= counters["accum_host_iters"] \
        + seen["nw_outside"]
    # every aligned pair was first a memo miss
    assert counters["memo_lookups"] >= counters["nw_pairs"] \
        == len(align_run["state"]["aligned"])


def test_host_path_spans_nest(align_run):
    phases = align_run["report"]["phases_s"]
    assert phases["accum_bvec"] + phases["accum_mean"] \
        <= phases["accumulate"]
    assert phases["update_mean"] <= phases["phase_b_update"]
    # the aligner's span lies outside the memo's and the batch's
    assert phases["align_memo"] + phases["align_batch"] + phases["align"] \
        <= phases["accumulate"] + phases["phase_b"]


def test_a_kmer_run_records_none_of_the_align_host_path(tmp_path):
    fasta = write_corpus(tmp_path / "k.fasta", 3, False, n_species=3,
                         per=8, L=150)
    perf.reset()
    run(ClusterConfig(files=[fasta], output=str(tmp_path / "k.clstr"),
                      similarity=0.90, sample_size=60), device="cpu")
    r = perf.report()
    perf.reset()
    for name in ("accum_host_iters", "memo_lookups"):
        assert name not in r["counters"]
    for name in ("align_memo", "update_mean", "accum_bvec", "accum_mean",
                 "align_batch"):
        assert name not in r["phases_s"]
    # training's probe walk and labels call the aligner
    assert 0 < r["counters"]["nw_calls"] <= r["counters"]["nw_pairs"]
    assert r["counters"]["accum_iters"] > 0

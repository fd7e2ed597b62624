"""The `align_id90` configuration and the readers of align mode's host path:
the configuration clusters in align mode, the readers return None where the
program has no such span or counter (an older program), and a traced
align-mode run reads all four; the aligner's batch size reads in k-mer mode
too."""
import pytest

from benchmark import run as R
from benchmark import spec as S
from benchmark.reference import solve
from benchmark.tests import tiny

NEW = ["accumulate_host.ms_per_iter", "align_memo.s_per_job",
       "update_mean.s_per_job", "nw.pairs_per_call"]


def test_align_id90_is_align_mode_at_090():
    cfg = S.config(S.load(), "align_id90")
    assert cfg["flags"]["align"] is True
    assert cfg["flags"]["similarity"] == 0.9
    assert solve.align_mode(cfg["flags"])
    assert "model_gap" not in cfg["limits"]
    assert all(v == 0 for v in cfg["limits"].values())
    assert cfg["reduced"] == [] and cfg["control"] in solve.CONTROLS


@pytest.mark.parametrize("name", NEW)
def test_a_new_reader_with_nothing_to_read_returns_none(name):
    assert S.metric_reader(name).read(R.Run()) is None


@pytest.mark.parametrize("name", NEW)
def test_a_new_reader_is_listed_with_the_align_cells(name):
    spec = S.load()
    entry = S._named(spec["per_layer"], name, "metric")
    assert entry["moves"] == "seqs_per_s"
    cells = {w["name"] for w in spec["workloads"]
             if entry in S.metrics_of(spec, "per_layer", w["name"])}
    assert {"align_id50.genomes", "align_id90.r15k"} <= cells
    if name == "nw.pairs_per_call":
        # the aligner's batch size: every cell
        assert cells == {w["name"] for w in spec["workloads"]}


def test_the_readers_divide_as_they_say():
    run = R.Run()
    run.jobs = 2
    run.phases = {"accumulate": 3.0, "align_memo": 1.0, "update_mean": 0.5}
    run.counters = {"accum_host_iters": 600.0, "nw_pairs": 3000.0,
                    "nw_calls": 600.0}
    got = {n: S.metric_reader(n).read(run) for n in NEW}
    assert got == pytest.approx({"accumulate_host.ms_per_iter": 5.0,
                                 "align_memo.s_per_job": 0.5,
                                 "update_mean.s_per_job": 0.25,
                                 "nw.pairs_per_call": 5.0})
    # the device loop's counter is not the host loop's
    run.counters = {"accum_iters": 600.0}
    assert S.metric_reader("accumulate_host.ms_per_iter").read(run) is None


def traced(monkeypatch, tmp_path, workload, seconds):
    root = tiny.make(str(tmp_path))
    tiny.point(monkeypatch, root)
    args = R.parse(["--workload", workload, "--seed", str(2**31 + 7),
                    "--seconds", str(seconds), "--trace", "1"])
    return R.execute(args, device="cpu")


def test_a_traced_align_id90_run_reads_the_new_metrics(monkeypatch,
                                                       tmp_path):
    res = traced(monkeypatch, tmp_path, "align_id90.tiny", 0.5)
    assert res["correct"] is True
    for name in NEW:
        assert res["metrics"][name]["value"] > 0, name
    gaps = {name for name, _ in res["breakdown"]["idle_gaps"]}
    assert gaps & {"accum_bvec", "accum_mean", "align_memo", "align_batch",
                   "update_mean"}


def test_a_traced_kmer_run_reads_the_batch_size(monkeypatch, tmp_path):
    res = traced(monkeypatch, tmp_path, "kmer_id90.tiny", 0.5)
    assert res["correct"] is True
    assert res["metrics"]["nw.pairs_per_call"]["value"] >= 1
    for name in NEW[:3]:
        assert name not in res["metrics"]

"""BENCHMARK.json against the limits its format sets, and every cell, mix and
metric found by name, a new one added as files and entries only."""
import json
import os
import re

import pytest

from benchmark import run as R
from benchmark import spec as S
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec():
    return S.load()


def test_top_level_keys_and_paths():
    sp = spec()
    assert set(sp) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert sp["paths"] == ["benchmark"]
    assert sp["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(sp["run_seconds"], int) and \
        1 <= sp["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(S.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_entries_keep_to_their_keys_and_names():
    sp = spec()
    for c in sp["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in sp["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in sp[k]]
    assert all(NAME.match(n) for n in names)
    for m in sp["end_to_end"] + sp["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in sp["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in sp["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in sp["end_to_end"]]
        layers.add(m["layer"])
    assert all("\n" not in x and len(x) <= 200 for x in layers)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    sp = spec()
    for w in sp["workloads"]:
        e2e = [m["name"] for m in S.metrics_of(sp, "end_to_end", w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert S.metrics_of(sp, "per_layer", w["name"])


def test_cells_configs_mixes_and_metrics_are_found_by_name():
    sp = spec()
    for w in sp["workloads"]:
        cfg = S.config(sp, w["config"])
        assert {"flags", "limits", "control", "check_pairs"} <= set(cfg)
        assert set(cfg["reduced"]) == set(S._named(
            sp["configs"], w["config"], "config")["reduced"])
        t = S.traffic(w["traffic"])
        assert hasattr(S.generator(t["generator"]), "make")
    for m in sp["end_to_end"] + sp["per_layer"]:
        assert callable(S.metric_reader(m["name"]).read)


def test_a_new_cell_mix_and_metric_are_new_files_only(tmp_path,
                                                      monkeypatch):
    root = tiny.make(str(tmp_path))
    tiny.point(monkeypatch, root)
    here = S.HERE
    t = S.traffic("r15k")
    t["reads"] = 3000
    with open(os.path.join(here, "traffic", "r3k.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(here, "metrics", "output.s_per_job.py"),
              "w") as f:
        f.write("def read(run):\n"
                "    return run.phases.get('output', 0) / run.jobs\n")
    sp = S.load()
    sp["workloads"].append({"name": "kmer_id90.r3k", "config": "kmer_id90",
                            "traffic": "r3k", "chips": 1, "why": "new"})
    sp["per_layer"].append({"name": "output.s_per_job", "unit": "s",
                            "better": "lower", "source": "program_span",
                            "layer": "output", "moves": "seqs_per_s",
                            "workloads": ["kmer_id90.r3k"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(sp, f)
    sp = S.load()
    cell = S.cell(sp, "kmer_id90.r3k")
    assert S.traffic(cell["traffic"])["reads"] == 3000
    names = [m["name"] for m in S.metrics_of(sp, "per_layer",
                                              "kmer_id90.r3k")]
    assert names == ["output.s_per_job"]
    run = R.Run()
    run.jobs, run.phases = 4, {"output": 2.0}
    assert S.metric_reader("output.s_per_job").read(run) == 0.5


@pytest.mark.parametrize("name", ["read.s_per_job", "train.s_per_job",
                                  "phase_a.ms_per_iter",
                                  "kmer_hist_roofline",
                                  "nw_align_long_roofline",
                                  "device.idle_share"])
def test_a_reader_with_nothing_to_read_returns_none(name):
    assert S.metric_reader(name).read(R.Run()) is None

"""A copy of the benchmark's data files with cells small enough for the CPU:
the real cells' entries plus `kmer_id90.tiny` and `align_id50.tiny`, whose
corpora have 240 reads of ~400 bases and 24 of ~300, and a k-mer
configuration that samples 200 training pairs."""
from __future__ import annotations

import json
import os
import shutil

from benchmark import spec as S

REAL = S.HERE


def make(root: str) -> str:
    """Write the copy under `root`; returns it."""
    here = os.path.join(root, "benchmark")
    shutil.copytree(REAL, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(S.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "kmer_tiny", "source": "tests",
                            "file": "benchmark/configs/kmer_tiny.json",
                            "reduced": [], "why": "CPU tests"})
    spec["workloads"] += [
        {"name": "kmer_id90.tiny", "config": "kmer_tiny", "traffic": "tiny",
         "chips": 1, "why": "CPU tests"},
        {"name": "align_id50.tiny", "config": "align_id50",
         "traffic": "tiny_genomes", "chips": 1, "why": "CPU tests"}]
    for m in spec["per_layer"]:
        m["workloads"] += ["kmer_id90.tiny", "align_id50.tiny"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    with open(os.path.join(here, "configs", "kmer_id90.json")) as f:
        cfg = json.load(f)
    cfg["flags"]["sample_size"] = 200
    cfg["check_pairs"] = 64
    with open(os.path.join(here, "configs", "kmer_tiny.json"), "w") as f:
        json.dump(cfg, f)
    for name, src, upd in (
            ("tiny", "r15k", {"reads": 240, "pool": 2,
                              "species_sizes": {"law": "fixed", "size": 40},
                              "length": {"mean": 400, "spread": 40}}),
            ("tiny_genomes", "genomes", {
                "reads": 24, "pool": 2,
                "species_sizes": {"law": "fixed", "size": 8},
                "length": {"mean": 300, "spread": 30}})):
        with open(os.path.join(here, "traffic", src + ".json")) as f:
            t = json.load(f)
        t.update(upd)
        with open(os.path.join(here, "traffic", name + ".json"), "w") as f:
            json.dump(t, f)
    return root


def point(monkeypatch, root: str) -> None:
    """Make the harness read the copy under `root`."""
    monkeypatch.setattr(S, "ROOT", root)
    monkeypatch.setattr(S, "HERE", os.path.join(root, "benchmark"))

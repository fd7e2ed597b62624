"""A copy of the benchmark's data files with cells small enough for the CPU:
the real cells' entries plus `kmer_id90.tiny` and `align_id50.tiny`, whose
corpora have 240 reads of ~400 bases and 24 of ~300, a k-mer configuration
that samples 200 training pairs, and `align_id90.tiny`: align mode chosen by
the `align` flag at --id 0.90, over the 240-read mix."""
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
    spec["configs"] += [
        {"name": name, "source": "tests",
         "file": f"benchmark/configs/{name}.json", "reduced": [],
         "why": "CPU tests"} for name in ("kmer_tiny", "align_id90_tiny")]
    tiny_cells = [
        {"name": "kmer_id90.tiny", "config": "kmer_tiny", "traffic": "tiny",
         "chips": 1, "why": "CPU tests"},
        {"name": "align_id50.tiny", "config": "align_id50",
         "traffic": "tiny_genomes", "chips": 1, "why": "CPU tests"},
        {"name": "align_id90.tiny", "config": "align_id90_tiny",
         "traffic": "tiny", "chips": 1, "why": "CPU tests"}]
    spec["workloads"] += tiny_cells
    for m in spec["per_layer"]:
        m["workloads"] += [c["name"] for c in tiny_cells]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    with open(os.path.join(here, "configs", "kmer_id90.json")) as f:
        cfg = json.load(f)
    cfg["flags"]["sample_size"] = 200
    cfg["check_pairs"] = 64
    with open(os.path.join(here, "configs", "kmer_tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(here, "configs", "align_id50.json")) as f:
        cfg = json.load(f)
    cfg["flags"].update(similarity=0.9, align=True)
    cfg["check_pairs"] = 64
    with open(os.path.join(here, "configs", "align_id90_tiny.json"),
              "w") as f:
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

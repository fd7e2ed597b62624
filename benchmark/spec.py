"""BENCHMARK.json and the files it names, found by name.

ROOT is the checkout, HERE the benchmark's folder in it (the tests point
them at a copy). A configuration is the file its entry names; a traffic mix
is traffic/<name>.json, read by generators/<generator>.py; a metric is
metrics/<name>.py, a module with read(run) -> float or None. A later cell,
mix or metric is new files and entries, and no edit here.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(spec: Dict, name: str) -> Dict:
    return _named(spec["workloads"], name, "workload")


def config(spec: Dict, name: str) -> Dict:
    entry = _named(spec["configs"], name, "config")
    with open(os.path.join(ROOT, entry["file"])) as f:
        return json.load(f)


def traffic(name: str) -> Dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def _module(path: str, name: str):
    sp = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def generator(name: str):
    return _module(os.path.join(HERE, "generators", name + ".py"),
                   "benchmark_generator_" + name)


def metric_reader(name: str):
    return _module(os.path.join(HERE, "metrics", name + ".py"),
                   "benchmark_metric_" + name.replace(".", "_"))


def metrics_of(spec: Dict, kind: str, cell_name: str) -> List[Dict]:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those
    that list it, or list no cells."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell_name in m["workloads"]]

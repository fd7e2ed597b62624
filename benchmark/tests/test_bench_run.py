"""Whole runs of the harness on the CPU at a tiny size: the result line,
no JAX loaded, no run without a card or without the program, and a planted
fault in the timed path turning `correct` false."""
import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from benchmark import run as R
from benchmark import spec as S
from benchmark.tests import tiny

torch.set_num_threads(2)


def execute(monkeypatch, tmp_path, workload, faults=None, seconds=1.0):
    root = tiny.make(str(tmp_path))
    tiny.point(monkeypatch, root)
    args = R.parse(["--workload", workload, "--seed", str(2**31 + 5),
                    "--seconds", str(seconds), "--trace", "0"])
    return R.execute(args, device="cpu", faults=faults)


def test_a_cpu_run_is_correct_and_its_line_has_the_keys(monkeypatch,
                                                         tmp_path, capsys):
    res = execute(monkeypatch, tmp_path, "kmer_id90.tiny")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"seqs_per_s", "job_p95_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(res["device"])
    checks = res["checks"]
    assert {"k", "hist_rows", "nw_pairs", "model_gap", "phase_a",
            "clstr_lines", "repeat_off", "clstr_invalid"} == set(checks)
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-len(checks):] == [
        f"check {n} {c['value']!r} limit {c['limit']!r}"
        for n, c in checks.items()]
    json.loads(json.dumps(res))


def plant(name):
    """A fault in the timed path, planted once the program is imported."""
    def move_unchanged():
        from meshclust_tpu_torch.core import accumulate_device as A
        A._Slots.move = lambda self, c: None

    def half_batch():
        from meshclust_tpu_torch.ops import histogram as H
        orig = H.kmer_hist

        def kmer_hist(*a, **kw):
            counts, ones, mag, sq, largest = orig(*a, **kw)
            counts[counts.shape[0] // 2:] = 1
            return counts, ones, mag, sq, largest
        H.kmer_hist = kmer_hist

    def altered_answer():
        from meshclust_tpu_torch.ops.align_device import DeviceAligner
        orig = DeviceAligner.counts

        def counts(self, pairs):
            alen, amatch = orig(self, pairs)
            amatch[0] -= 1
            return alen, amatch
        DeviceAligner.counts = counts
    return {"move_unchanged": move_unchanged, "half_batch": half_batch,
            "altered_answer": altered_answer}[name]


@pytest.mark.parametrize("workload,fault,caught", [
    ("kmer_id90.tiny", "move_unchanged", "phase_a"),
    ("kmer_id90.tiny", "half_batch", "hist_rows"),
    ("kmer_id90.tiny", "altered_answer", "nw_pairs"),
    ("align_id50.tiny", "altered_answer", "nw_pairs"),
    ("align_id90.tiny", "altered_answer", "nw_pairs")])
def test_a_planted_fault_makes_the_run_not_correct(monkeypatch, tmp_path,
                                                   workload, fault, caught):
    from meshclust_tpu_torch.core import accumulate_device as A
    from meshclust_tpu_torch.ops import histogram as H
    from meshclust_tpu_torch.ops.align_device import DeviceAligner
    for obj, name in ((A._Slots, "move"),
                      (H, "kmer_hist"), (DeviceAligner, "counts")):
        monkeypatch.setattr(obj, name, getattr(obj, name))
    res = execute(monkeypatch, tmp_path, workload, faults=plant(fault),
                  seconds=2.0 if workload.startswith("align") else 1.0)
    assert res["correct"] is False
    c = res["checks"][caught]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("workload,similarity", [("align_id50.tiny", 0.5),
                                                 ("align_id90.tiny", 0.9)])
def test_align_mode_run_is_correct(monkeypatch, tmp_path, workload,
                                   similarity):
    """Align mode by --id < 0.60 or by the `align` flag: the run is correct,
    compares no model, and the job's model is the identity alone."""
    from benchmark.reference import model as M
    from benchmark.reference import solve
    checked = []
    orig = solve.check_job

    def check_job(state, *a, **kw):
        checked.append(state)
        return orig(state, *a, **kw)
    monkeypatch.setattr(solve, "check_job", check_job)
    res = execute(monkeypatch, tmp_path, workload, seconds=2.0)
    assert res["correct"] is True and res["attempted"] >= 1
    assert "model_gap" not in res["checks"]
    (state,) = checked
    want = solve.model_params(M.align_model(similarity))
    assert state["model"]["lookup"] == [M.FEAT_ALIGN]
    assert solve.model_gap(state["model"], want) == 0.0
    assert state["split"] is None


def test_settle_keeps_each_pairs_first_identity_in_order():
    from benchmark.capture import settle
    state = {"hist": np.ones((2, 3), np.int16),
             "calls": [([(3, 1), (0, 2)], np.asarray([0.5, 0.25])),
                       ([(0, 2), (1, 3), (3, 1)],
                        np.asarray([0.75, 1.0, 0.125]))]}
    out = settle(state)
    assert list(out["aligned"].items()) == [((3, 1), 0.5), ((0, 2), 0.25),
                                            ((1, 3), 1.0)]
    assert "calls" not in out and out["hist"].dtype == np.int64


def test_a_traced_run_reads_the_programs_own_spans(monkeypatch, tmp_path):
    """The program's own spans are the trace's ranges: the idle breakdown
    is by them, and the per-layer metrics are read."""
    from meshclust_tpu_torch.utils import perf
    root = tiny.make(str(tmp_path))
    tiny.point(monkeypatch, root)
    args = R.parse(["--workload", "kmer_id90.tiny", "--seed", "11",
                    "--seconds", "1", "--trace", "1"])
    res = R.execute(args, device="cpu")
    assert res["correct"] is True
    gaps = {name for name, _ in res["breakdown"]["idle_gaps"]}
    assert len(gaps) == 10
    assert gaps - {"outside_spans"} <= set(perf.phases())
    assert {"train_pivots.s_per_job", "phase_a.host_ms_per_iter",
            "device.idle_share", "prepare.s_per_job"} <= set(res["metrics"])


def test_no_module_of_jax_is_loaded_in_a_run(tmp_path):
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {S.ROOT!r})\n"
        "from benchmark import run as R, spec as S\n"
        "from benchmark.tests import tiny\n"
        f"root = tiny.make({str(tmp_path)!r})\n"
        "S.ROOT, S.HERE = root, root + '/benchmark'\n"
        "a = R.parse(['--workload', 'align_id50.tiny', '--seed', '3',"
        " '--seconds', '0.5', '--trace', '1'])\n"
        "res = R.execute(a, device='cpu')\n"
        "print(json.dumps([res['correct'], R.forbidden_modules(),"
        " sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'meshclust_tpu'))]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, bad, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct is True and bad == [] and loaded == []
    assert R.forbidden_modules() == [] or "jax" in sys.modules


def test_a_module_of_jax_loaded_by_the_reference_stops_the_result(
        monkeypatch, tmp_path):
    from benchmark.reference import solve
    orig = solve.check_job

    def check_job(*a, **kw):
        monkeypatch.setitem(sys.modules, "jaxlib",
                            types.ModuleType("jaxlib"))
        return orig(*a, **kw)
    monkeypatch.setattr(solve, "check_job", check_job)
    with pytest.raises(R.NoResult, match="jaxlib"):
        execute(monkeypatch, tmp_path, "kmer_id90.tiny", seconds=0.5)


def test_a_build_in_set_up_is_timed_and_a_built_library_is_not(tmp_path):
    lib = tmp_path / "libkernels.so"

    class Ext:
        @staticmethod
        def library_path():
            return str(lib)

        @staticmethod
        def lib():
            if not lib.exists():
                time.sleep(0.05)
                lib.write_bytes(b"")
    first = R.load_library(Ext)
    assert first is not None and first >= 0.05
    assert R.load_library(Ext) is None


def last_json(stdout):
    for line in reversed(stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            return None
    return None


def test_the_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "kmer_id90.r15k",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=S.ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and last_json(out.stdout) is None
    assert "no result" in out.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(S.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(S.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from benchmark import run as R\n"
            "a = R.parse(['--workload', 'kmer_id90.r15k', '--seed', '1',"
            " '--seconds', '1', '--trace', '0'])\n"
            "try:\n"
            "    R.execute(a, device='cpu')\n"
            "except R.NoResult as e:\n"
            "    print('no result:', e, file=sys.stderr); sys.exit(2)\n")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0 and last_json(out.stdout) is None
    assert "meshclust_tpu_torch is not importable" in out.stderr
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "kmer_id90.r15k",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and last_json(out.stdout) is None

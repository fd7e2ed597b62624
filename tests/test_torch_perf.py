"""utils.perf spans: host wall on the monotonic clock, profiler ranges named
"span:<name>" while a torch.profiler records and nothing more otherwise,
and the spans and counters that a CPU run of each mode reports."""
import glob
import types

import pytest
import torch

from meshclust_tpu_torch.config import ClusterConfig
from meshclust_tpu_torch.core.runner import run
from meshclust_tpu_torch.utils import perf
from tests.test_torch_end2end import write_corpus

torch.set_num_threads(1)

TRAIN_SPANS = ("train_pivots", "train_probe", "train_pairs", "train_labels",
               "train_features", "train_glm")


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def time(self):
        raise AssertionError("spans read the monotonic clock only")


def test_spans_nest_and_sum_on_the_monotonic_clock(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(perf, "time", clock)
    perf.reset()
    with perf.phase("outer"):
        clock.now += 1.0
        for _ in range(3):
            with perf.phase("inner"):
                clock.now += 0.5
        clock.now += 2.0
    with perf.phase("outer"):
        clock.now += 0.25
    r = perf.report()
    perf.reset()
    assert r["phases_s"] == {"outer": 4.75, "inner": 1.5}
    assert r["phase_calls"] == {"outer": 2, "inner": 3}


def test_a_span_that_raises_is_still_counted(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(perf, "time", clock)
    perf.reset()
    with pytest.raises(KeyError):
        with perf.phase("failing"):
            clock.now += 1.0
            raise KeyError("x")
    assert perf.phases() == {"failing": 1.0}
    perf.reset()


def test_spans_are_profiler_ranges_while_a_profiler_records():
    from torch.profiler import ProfilerActivity, profile
    perf.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with perf.phase("outer"):
            with perf.phase("inner"):
                torch.ones(4).sum()
    perf.reset()
    ranges = {}
    for ev in prof.events():
        if ev.name.startswith(perf.SPAN_PREFIX):
            ranges[ev.name] = (ev.time_range.start, ev.time_range.end)
    assert set(ranges) == {"span:outer", "span:inner"}
    (o0, o1), (i0, i1) = ranges["span:outer"], ranges["span:inner"]
    assert o0 <= i0 <= i1 <= o1


def test_no_range_is_opened_without_a_profiler(monkeypatch):
    import torch.profiler as tp
    opened = []
    monkeypatch.setattr(tp, "record_function",
                        lambda *a, **k: opened.append(a) or pytest.fail())
    assert not perf.profiler_on()
    with perf.phase("quiet"):
        pass
    assert not opened and "quiet" in perf.phases()
    perf.reset()


def test_report_has_no_tpu_estimates_and_keeps_nw_cells_per_s():
    assert not any(k.startswith("PEAK_") for k in vars(perf))
    perf.reset()
    with perf.phase("align"):
        perf.add("nw_cells", 1e6)
        perf.add("accum_sweep_bytes", 1e9)
        perf.add("feat_matmul_flops", 1e9)
    with perf.phase("accumulate"):
        pass
    r = perf.report()
    perf.reset()
    assert set(r) == {"wall_s", "phases_s", "phase_calls", "counters",
                      "nw_cells_per_s"}


def _run(tmp_path, name, **opts):
    fasta = write_corpus(tmp_path / f"{name}.fasta", 3, False, n_species=3,
                         per=8, L=150)
    perf.reset()
    run(ClusterConfig(files=[fasta], output=str(tmp_path / f"{name}.clstr"),
                      **opts), device="cpu")
    r = perf.report()
    perf.reset()
    return r


def test_kmer_run_reports_the_training_and_phase_a_splits(tmp_path):
    r = _run(tmp_path, "kmer", similarity=0.90, sample_size=60)
    phases, calls, counters = r["phases_s"], r["phase_calls"], r["counters"]
    assert set(TRAIN_SPANS) | {"train", "accum_loop", "accumulate",
                               "prepare"} <= set(phases)
    for name in ("train_pivots", "train_probe", "train_pairs",
                 "train_labels"):
        assert calls[name] == 1
    assert calls["train_glm"] >= 1
    assert calls["train_features"] == 2 * calls["train_glm"]
    # spans nest: the parts within their parent
    assert sum(phases[n] for n in TRAIN_SPANS) <= phases["train"]
    assert phases["accum_loop"] <= phases["accumulate"]
    assert 0 < counters["accum_wait_s"] <= phases["accum_loop"]
    assert calls["prepare"] == 3 and calls["accum_loop"] == 1


def test_align_run_reports_host_phase_b(tmp_path):
    r = _run(tmp_path, "align", similarity=0.50, iterations=15)
    phases, calls = r["phases_s"], r["phase_calls"]
    assert calls["phase_b"] == 1
    assert calls["phase_b_update"] == calls["phase_b_merge"] == 15
    assert phases["phase_b_update"] + phases["phase_b_merge"] \
        <= phases["phase_b"] <= phases["cluster"]
    assert "prepare" in phases and "train" in phases


def test_traced_run_holds_span_ranges(tmp_path, monkeypatch):
    """MESHCLUST_TRACE's trace carries the program's spans. The CPU trace
    holds every aten op of the kernels' plain versions, so the corpus is
    the smallest that trains."""
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("MESHCLUST_TRACE", str(trace_dir))
    fasta = write_corpus(tmp_path / "t.fasta", 5, False, n_species=2, per=6,
                         L=150)
    perf.reset()
    run(ClusterConfig(files=[fasta], output=str(tmp_path / "t.clstr"),
                      similarity=0.90, sample_size=60), device="cpu")
    perf.reset()
    traces = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        text = f.read()
    for name in ("train", "cluster", "train_probe", "accum_loop"):
        assert f'"name": "span:{name}"' in text


def test_the_profiler_flag_is_read_at_every_span(monkeypatch):
    """The flag's function is looked up once and called at each span, so
    a profiler started after the first span still sees the next ones."""
    monkeypatch.setattr(perf, "_profiling", None)
    fake = types.SimpleNamespace(calls=0)

    def enabled():
        fake.calls += 1
        return False
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", enabled)
    with perf.phase("x"):
        pass
    with perf.phase("x"):
        pass
    assert fake.calls == 2 and perf.report()["phase_calls"]["x"] == 2
    perf.reset()

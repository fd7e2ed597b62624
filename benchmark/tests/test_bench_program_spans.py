"""The readers of the program's split spans and Phase A's wait counter: None
where the program has no such span or counter (an older program), else the
span or counter over jobs or iterations."""
import pytest

from benchmark import run as R
from benchmark import spec as S

SPAN_METRICS = ["train_pivots", "train_probe", "train_pairs",
                "train_labels", "train_features", "train_glm", "phase_b",
                "phase_b_update", "phase_b_merge", "prepare"]
NEW = [f"{s}.s_per_job" for s in SPAN_METRICS] + [
    "phase_a.host_ms_per_iter", "phase_a.wait_ms_per_iter"]


def made_up_run():
    run = R.Run()
    run.jobs = 4
    run.phases = {s: 0.5 * (i + 1) for i, s in enumerate(SPAN_METRICS)}
    run.phases.update(accumulate=3.0, accum_loop=2.5, train=9.0)
    run.counters = {"accum_iters": 1000.0, "accum_wait_s": 0.5}
    return run


@pytest.mark.parametrize("name", NEW)
def test_a_new_reader_with_nothing_to_read_returns_none(name):
    assert S.metric_reader(name).read(R.Run()) is None


@pytest.mark.parametrize("name", NEW)
def test_a_new_reader_is_listed_with_its_cells(name):
    entry = S._named(S.load()["per_layer"], name, "metric")
    assert entry["moves"] == "seqs_per_s" and entry["workloads"]


@pytest.mark.parametrize("span", SPAN_METRICS)
def test_a_span_over_jobs(span):
    run = made_up_run()
    want = run.phases[span] / 4
    assert S.metric_reader(f"{span}.s_per_job").read(run) == \
        pytest.approx(want)
    del run.phases[span]
    assert S.metric_reader(f"{span}.s_per_job").read(run) is None


def test_phase_a_host_and_wait_split_the_loop():
    run = made_up_run()
    host = S.metric_reader("phase_a.host_ms_per_iter").read(run)
    wait = S.metric_reader("phase_a.wait_ms_per_iter").read(run)
    assert host == pytest.approx(2.0) and wait == pytest.approx(0.5)
    # together at most the iteration's share of the whole `accumulate`
    whole = S.metric_reader("phase_a.ms_per_iter").read(run)
    assert host + wait <= whole


@pytest.mark.parametrize("missing", ["accum_loop", "accum_wait_s",
                                     "accum_iters"])
def test_phase_a_split_needs_the_loop_span_and_both_counters(missing):
    run = made_up_run()
    run.phases.pop(missing, None)
    run.counters.pop(missing, None)
    host = S.metric_reader("phase_a.host_ms_per_iter").read(run)
    wait = S.metric_reader("phase_a.wait_ms_per_iter").read(run)
    assert host is None
    assert (wait is None) == (missing != "accum_loop")

"""The reduction of a profiler's events to busy time, kernel time and the
device's idle time by the host's innermost span."""
import pytest

from benchmark import tracing as T


def ev(name, dev, s, e):
    return (name, dev, s * 1e9, e * 1e9)


def test_host_segments_label_the_innermost_span():
    spans = [(0, 10, "cluster"), (1, 4, "accumulate"), (5, 9, "phase_b"),
             (12, 20, "train"), (13, 15, "align")]
    assert T.host_segments(spans) == [
        (0, 1, "cluster"), (1, 4, "accumulate"), (4, 5, "cluster"),
        (5, 9, "phase_b"), (9, 10, "cluster"), (12, 13, "train"),
        (13, 15, "align"), (15, 20, "train")]


def test_reduce_counts_the_union_inside_the_window():
    events = [ev(T.WINDOW, False, 1, 21), ev("span:cluster", False, 0, 10),
              ev("span:accumulate", False, 1, 4), ev("k1", True, 2, 3),
              ev("k2", True, 2.5, 3.5), ev("k1", True, 20, 22),
              ev("span:cluster", True, 0, 10)]
    r = T.reduce(events)
    assert r["window_s"] == pytest.approx(20)
    assert r["busy_s"] == pytest.approx(1.5 + 1)
    assert r["kernel_s"] == pytest.approx({"k1": 2.0, "k2": 1.0})
    assert r["idle_gaps"] == pytest.approx(
        {"accumulate": 1.5, "cluster": 6.0, "outside_spans": 10.0})
    assert sum(r["idle_gaps"].values()) == pytest.approx(
        r["window_s"] - r["busy_s"])
    assert r["busy_by_span"] == pytest.approx(
        {"accumulate": 1.5, "outside_spans": 1.0})


def test_no_window_no_summary_and_breakdown_keeps_ten():
    assert T.reduce([ev("k", True, 0, 1)]) is None
    s = {"kernel_s": {f"k{i}": float(i) for i in range(15)},
         "idle_gaps": {f"g{i}": float(i) for i in range(12)}}
    b = T.breakdown(s)
    assert [x[0] for x in b["device_ops"]][:2] == ["k14", "k13"]
    assert len(b["device_ops"]) == 10 and len(b["idle_gaps"]) == 10

"""The frozen bounds against counts made by hand."""
import pytest

from benchmark import run as R
from benchmark import spec as S
from benchmark.rooflines import kmer_hist, nw_align_long, peaks


def test_peaks_are_the_h100_sheet_and_its_pipes():
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.INT32_OPS_PER_S == 132 * 64 * 1.98e9
    assert peaks.DISPATCH_OPS_PER_S == 2 * peaks.INT32_OPS_PER_S
    assert peaks.bound_s(3.35e12, 0.5) == 1.0
    assert peaks.bound_s(0, 0.5) == 0.5


def test_kmer_hist_bytes_by_hand():
    # 2 reads of 10 and 20 bases, k = 2: 30 codes padded to 32; rec_off
    # and seg_off 3 int64 each; 2 segments of 2 int64; counts 2 x 16
    # int32, ones 2 x 4 int32, mag and sq 2 int64 each, largest 1 int32
    want = 32 + 2 * 3 * 8 + 2 * 2 * 8 + 2 * 16 * 4 + 2 * 4 * 4 + 2 * 2 * 8 + 4
    assert kmer_hist.launch_bytes(30, 2, 2, 2) == want == 308
    assert kmer_hist.launch_bound_s(30, 2, 2, 2) == pytest.approx(
        308 / 3.35e12)


def test_kmer_hist_15k_reads_are_bound_by_bytes():
    b = kmer_hist.launch_bytes(15_000_000, 15000, 15000, 4)
    assert b == 15_000_000 + 2 * 15001 * 8 + 15000 * 16 + 15000 * 256 * 4 \
        + 15000 * 16 + 15000 * 16 + 4
    ops = 4 * 15_000_000 / peaks.INT32_OPS_PER_S
    assert kmer_hist.launch_bound_s(15_000_000, 15000, 15000, 4) == \
        pytest.approx(b / 3.35e12) and b / 3.35e12 > ops


def test_nw_bound_by_hand():
    # one 1,000 x 1,000 pair: 18e6 ALU ops at 132*64*1.98e9/s against
    # 25e6 ops at twice that rate; the ALU pipe is the longer
    t = 18e6 / (132 * 64 * 1.98e9)
    assert nw_align_long.ops_s(1e6) == pytest.approx(t)
    assert nw_align_long.pairs_bound_s(1e6, 1) == pytest.approx(t)


def test_roofline_readers_divide_bound_by_device_time():
    run = R.Run()
    run.trace = {"kernel_s": {"void nw_align_long_kernel(int)": 2e-3,
                              "kmer_rows_kernel<4>": 1e-4,
                              "other": 5.0},
                 "busy_s": 1.0, "window_s": 4.0, "idle_gaps": {}}
    run.counters = {"nw_cells": 1e8, "nw_pairs": 100}
    run.job_inputs = [{"reads": 2, "bases": 30, "segments": 2, "k": 2}]
    nw = S.metric_reader("nw_align_long_roofline").read(run)
    assert nw == pytest.approx(100 * nw_align_long.ops_s(1e8) / 2e-3)
    km = S.metric_reader("kmer_hist_roofline").read(run)
    assert km == pytest.approx(100 * 308 / 3.35e12 / 1e-4)
    assert S.metric_reader("device.idle_share").read(run) == 75.0

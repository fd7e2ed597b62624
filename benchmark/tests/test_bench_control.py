"""The control at a size a test run holds: the reference in the
configuration's control variant, in the program's place, must fail one of
the cell's numbers, while the program passes them all."""
import pytest
import torch

from benchmark import control
from benchmark import spec as S
from benchmark.reference import solve
from benchmark.tests import tiny

torch.set_num_threads(2)


@pytest.mark.parametrize("workload", ["kmer_id90.tiny", "align_id50.tiny",
                                      "align_id90.tiny"])
def test_the_control_fails_a_number_the_program_passes(monkeypatch,
                                                        tmp_path, workload):
    root = tiny.make(str(tmp_path))
    tiny.point(monkeypatch, root)
    cfg = S.config(S.load(), S.cell(S.load(), workload)["config"])
    limits = cfg["limits"]
    (row,) = control.readings(workload, [2**31 + 9], device="cpu")
    assert all(v <= limits[k] for k, v in row["program"].items())
    assert any(v > limits[k] for k, v in row["control"].items())
    # align mode (by --id or by the flag) compares no model
    model = not solve.align_mode(cfg["flags"])
    assert ("model_gap" in row["program"]) == model
    assert ("model_gap" in row["control"]) == model

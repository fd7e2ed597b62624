"""The port's fused Phase B (DeviceBackend.phase_b_loop) on the CPU.

Against the JAX package's phase_b_loop on the same members, centers and
classifier (carried across by convert.py): the same assignment of every
member, centers, valid mask and merge history. Then end to end: the fused
loop against the per-iteration path (MESHCLUST_FUSED_PHASEB=0, which calls
update_banded and classify_pairs), as tests/test_phaseb_device.py does for
the JAX package; no run may see the fused loop's replay check fall back to
the host.
"""
import numpy as np
import pytest
import torch

from meshclust_tpu_torch.core import classify as C
from meshclust_tpu_torch.core.meanshift import MeanShift
from tests.test_torch_device_backend import banded_case

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,delta", [(5, 3), (6, 5)])
def test_phase_b_loop_equals_jax(seed, delta):
    from meshclust_tpu.core import classify as JC
    jps, jparams, ps, params, members, assign, rows = banded_case(seed)
    C_ = rows.shape[0]
    got = C.DeviceBackend(ps, params).phase_b_loop(members, assign, rows,
                                                   delta, 4)
    want = JC.DeviceBackend(jps, jparams).phase_b_loop(members, assign,
                                                       rows, delta, 4)
    a, c_rows, valid, t_hist = got
    assert t_hist.shape == (4, C_)
    np.testing.assert_array_equal(a, want[0])
    np.testing.assert_array_equal(c_rows, want[1][:C_])
    np.testing.assert_array_equal(valid, want[2][:C_])
    np.testing.assert_array_equal(t_hist, want[3][:, :C_])
    # the case merges centers, and a merge makes assign non-monotone
    assert (t_hist != np.arange(C_)).any()
    assert valid.sum() < C_


def test_phase_b_loop_replays_on_host():
    """MeanShift's replay check accepts the loop's history, and the
    centers it leaves equal the loop's."""
    from meshclust_tpu_torch.core.meanshift import Center
    _, _, ps, params, members, assign, rows = banded_case(6)
    centers = [Center(int(r), members[assign == j].tolist())
               for j, r in enumerate(rows)]
    ms = MeanShift(ps, C.DeviceBackend(ps, params), sim=0.90, delta=5,
                   iterations=4)
    assert ms.run_phase_b_device(centers) is centers
    a, c_rows, valid, _ = C.DeviceBackend(ps, params).phase_b_loop(
        members, assign, rows, 5, 4)
    assert [c.center for c in centers] == c_rows[valid].tolist()


@pytest.fixture
def no_fallback(monkeypatch):
    """Wraps MeanShift.run_phase_b_device; asserts each call accepted the
    fused loop's result. Yields the list of its results."""
    seen = []
    original = MeanShift.run_phase_b_device

    def spy(self, centers):
        out = original(self, centers)
        seen.append(out)
        assert out is not None, "fused Phase B replay fell back to the host"
        return out

    monkeypatch.setattr(MeanShift, "run_phase_b_device", spy)
    return seen


def test_fused_equals_per_iteration(tmp_path, monkeypatch, no_fallback):
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.runner import run
    from meshclust_tpu_torch.io.clstr import nmi, parse_clstr, \
        partition_labels
    from tests.test_torch_end2end import write_corpus
    fasta = write_corpus(tmp_path / "pb.fasta", 7, False, n_species=8,
                         per=10, L=200)
    outs = {}
    for fused in ("1", "0"):
        monkeypatch.setenv("MESHCLUST_FUSED_PHASEB", fused)
        outs[fused] = str(tmp_path / f"fused{fused}.clstr")
        res = run(ClusterConfig(files=[fasta], similarity=0.90,
                                output=outs[fused], iterations=6,
                                sample_size=300), device="cpu")
        assert isinstance(res["backend"], C.DeviceBackend)
    assert len(no_fallback) == 1
    lf = partition_labels(parse_clstr(outs["1"]))
    lp = partition_labels(parse_clstr(outs["0"]))
    assert set(lf) == set(lp)
    assert nmi(lf, lp) == pytest.approx(1.0)

    def reps(path):
        return {h for cl in parse_clstr(path) for h, is_rep in cl if is_rep}

    assert reps(outs["1"]) == reps(outs["0"])

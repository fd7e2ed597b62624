"""The port runs where jax is not installed, and its CLI never falls back
to the CPU.

Each test starts a fresh interpreter in which `import jax` fails (as on a
GPU machine without jax), imports the port, and drives it: through
run(device="cpu") on a tiny corpus, in k-mer mode (DeviceBackend, device
Phase A, fused Phase B) and in align mode (AlignBackend), and through the
CLI with CUDA hidden, which must exit non-zero with a message.
"""
import os
import subprocess
import sys

import pytest

from tests.test_torch_end2end import write_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK_JAX = """
import sys
sys.modules["jax"] = None        # any `import jax` now raises ImportError
"""


def _python(code, tmp_path, env_extra=None):
    env = dict(os.environ, MESHCLUST_QUIET="1", PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", BLOCK_JAX + code],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("mode,backend",
                         [("similarity=0.90, sample_size=200",
                           "DeviceBackend"),
                          ("similarity=0.50", "AlignBackend")],
                         ids=["kmer_mode", "align_mode"])
def test_port_runs_without_jax(mode, backend, tmp_path):
    fasta = write_corpus(tmp_path / "tiny.fasta", 5, True, n_species=3,
                         per=10, L=150)
    out = tmp_path / "tiny.clstr"
    proc = _python(f"""
from meshclust_tpu_torch.config import ClusterConfig
from meshclust_tpu_torch.core.runner import run
res = run(ClusterConfig(files=[{fasta!r}], output={str(out)!r}, {mode}),
          device="cpu")
assert "jax" not in sys.modules or sys.modules["jax"] is None
assert not any(m == "meshclust_tpu" or m.startswith("meshclust_tpu.")
               for m in sys.modules)
assert type(res["backend"]).__name__ == {backend!r}
print("clusters", res["n_clusters"])
""", tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "clusters" in proc.stdout
    text = out.read_text()
    assert text.startswith(">Cluster 0")
    assert text.count("nt, >sp") == 30


def test_cli_without_cuda_exits_nonzero(tmp_path):
    fasta = write_corpus(tmp_path / "tiny.fasta", 5, False, n_species=2,
                         per=5, L=150)
    out = tmp_path / "cli.clstr"
    proc = _python(f"""
import runpy
sys.argv = ["meshclust_tpu_torch.cli", {fasta!r}, "--output", {str(out)!r}]
runpy.run_module("meshclust_tpu_torch.cli", run_name="__main__")
""", tmp_path, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not out.exists()

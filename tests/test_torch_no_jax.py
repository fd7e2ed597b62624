"""The port runs where jax is not installed, and its CLI never falls back
to the CPU.

Each test starts a fresh interpreter in which `import jax` fails (as on a
GPU machine without jax), imports the port, and drives it: through
run(device="cpu") on a tiny corpus, in k-mer mode (DeviceBackend, device
Phase A, fused Phase B), in align mode (AlignBackend) and with a
checkpoint written and resumed; two gloo ranks (parallel/dist.launch),
where a `jax` package that fails to import comes first on every process's
path; Red on a small genome; and the CLI with CUDA hidden, which must exit
non-zero with a message, also when asked for several ranks.
"""
import os
import subprocess
import sys

import numpy as np
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


NO_MESHCLUST_TPU = """
assert "jax" not in sys.modules or sys.modules["jax"] is None
assert not any(m == "meshclust_tpu" or m.startswith("meshclust_tpu.")
               for m in sys.modules)
"""


def test_checkpoint_run_without_jax(tmp_path):
    """A --checkpoint run writes both files; its rerun resumes both."""
    fasta = write_corpus(tmp_path / "tiny.fasta", 7, True, n_species=3,
                         per=10, L=150)
    prefix = str(tmp_path / "ck")
    proc = _python(f"""
from meshclust_tpu_torch.config import ClusterConfig
from meshclust_tpu_torch.core.runner import run
from meshclust_tpu_torch.utils import perf
outs = []
for i in range(2):
    perf.reset()
    out = {str(tmp_path)!r} + f"/run{{i}}.clstr"
    run(ClusterConfig(files=[{fasta!r}], output=out, similarity=0.90,
                      sample_size=200, checkpoint={prefix!r}), device="cpu")
    outs.append(open(out).read())
assert "train" not in perf.phases() and "accumulate" not in perf.phases()
assert outs[0] == outs[1]
{NO_MESHCLUST_TPU}
print("resumed")
""", tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "resumed" in proc.stdout
    assert os.path.exists(prefix + ".model.json")
    assert os.path.exists(prefix + ".centers.json")


def test_two_ranks_without_jax(tmp_path):
    """k-mer mode over two gloo ranks, each a spawned process whose path
    starts with a `jax` that raises ImportError."""
    blocked = tmp_path / "blocked"
    (blocked / "jax").mkdir(parents=True)
    (blocked / "jax" / "__init__.py").write_text(
        "raise ImportError('jax is not installed here')\n")
    fasta = write_corpus(tmp_path / "tiny.fasta", 5, True, n_species=3,
                         per=10, L=150)
    out = str(tmp_path / "ranks.clstr")
    path = os.pathsep.join([str(blocked), ROOT, os.path.join(ROOT, "tests")])
    proc = _python(f"""
import torch_dist_ranks as R
from meshclust_tpu_torch.parallel import dist
outs = dist.launch(R.cluster, 2, "cpu", dict(files=[{fasta!r}], output={out!r},
                                             similarity=0.90,
                                             sample_size=200))
for o in outs:
    assert o["jax_free"] and o["meshclust_tpu_free"], o
    assert o["clusterer"] == "DeviceBackend" and o["kmer_hist_calls"] == 1
    assert o["counters"]["coll_phase_b"] > 0
{NO_MESHCLUST_TPU}
print("ranks", [o["n_clusters"] for o in outs])
""", tmp_path, env_extra={"PYTHONPATH": path})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ranks" in proc.stdout
    text = open(out).read()
    assert text.startswith(">Cluster 0")
    assert text.count("nt, >sp") == 30


def test_red_without_jax(tmp_path):
    """python -m meshclust_tpu_torch.red on a small planted genome."""
    rng = np.random.default_rng(9)
    letters = np.array(list("ACGT"))
    motif = "".join(letters[rng.integers(0, 4, 300)])
    seq = "".join("".join(letters[rng.integers(0, 4, 700)]) + motif
                  for _ in range(40))
    gdir = tmp_path / "genome"
    gdir.mkdir()
    with open(gdir / "chr1.fa", "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(seq), 70):
            f.write(seq[i: i + 70] + "\n")
    proc = _python(f"""
import runpy
sys.argv = ["meshclust_tpu_torch.red", "-gnm", {str(gdir)!r}, "-rpt",
            {str(tmp_path / "rpt")!r}, "-msk", {str(tmp_path / "msk")!r},
            "-len", "12"]
try:
    runpy.run_module("meshclust_tpu_torch.red", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
{NO_MESHCLUST_TPU}
""", tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "repeat regions" in proc.stdout
    assert (tmp_path / "rpt" / "chr1.rpt").read_text().strip()
    assert any(c.islower() for c in (tmp_path / "msk" / "chr1.msk")
               .read_text())


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


def test_cli_ranks_without_cuda_exit_nonzero(tmp_path):
    """MESHCLUST_DEVICES=2 with CUDA hidden: refused before any rank
    starts."""
    fasta = write_corpus(tmp_path / "tiny.fasta", 5, False, n_species=2,
                         per=5, L=150)
    out = tmp_path / "cli.clstr"
    proc = _python(f"""
import runpy
sys.argv = ["meshclust_tpu_torch.cli", {fasta!r}, "--output", {str(out)!r}]
runpy.run_module("meshclust_tpu_torch.cli", run_name="__main__")
""", tmp_path, env_extra={"CUDA_VISIBLE_DEVICES": "",
                          "MESHCLUST_DEVICES": "2"})
    assert proc.returncode == 2
    assert "CUDA is not available" in proc.stderr
    assert not out.exists()

"""The port's whole pipeline over gloo ranks on the CPU (core.runner.run in
ranks started by parallel/dist.launch with device="cpu"), as
tests/test_parallel.py drives the JAX package's over its 8-device mesh.

- k-mer mode on test_parallel.py's corpus at 2/3/4 ranks: the CLSTR of
  JAX's MESHCLUST_DEVICES=8 run and of the port's single rank, byte for
  byte; each rank clusters on DeviceBackend, calls kmer_hist once, shards
  Phase B, and shards Phase A where the ranks divide V (2 and 4 of
  V = 256, not 3);
- align mode at 2 ranks: the single rank's CLSTR;
- checkpoints: a 2-rank run's files resume a single-rank run and the
  reverse, with the same CLSTR; only rank 0 writes the CLSTR and the
  checkpoint files;
- two processes joined through the JAX package's multi-host variables
  (MESHCLUST_COORDINATOR, MESHCLUST_NUM_PROCS, MESHCLUST_PROC_ID): rank
  0's CLSTR is the single rank's, and rank 1 writes none.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from meshclust_tpu_torch.parallel import dist
from tests.test_torch_dist import coordinator_env, free_port

torch.set_num_threads(1)
KMER = dict(similarity=0.90, iterations=5, sample_size=120)


def e2e_fasta(d) -> str:
    """test_parallel.py's _e2e_fasta corpus (its rng fixture's seed)."""
    from tests.test_parallel import _e2e_fasta
    return _e2e_fasta(d, np.random.default_rng(1234))


def run_one(fasta, out, **kw) -> bytes:
    """The port's single rank (no group) on the CPU."""
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.runner import run
    run(ClusterConfig(files=[fasta], output=out, **kw), device="cpu")
    with open(out, "rb") as f:
        return f.read()


def run_ranks(n, fasta, out, **kw):
    outs = dist.launch(R.cluster, n, "cpu",
                       dict(files=[fasta], output=out, **kw))
    with open(out, "rb") as f:
        return f.read(), outs


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    from meshclust_tpu.config import ClusterConfig as JConfig
    from meshclust_tpu.core.runner import run as jrun
    d = tmp_path_factory.mktemp("e2e")
    fasta = e2e_fasta(d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MESHCLUST_DEVICES", "8")
        jrun(JConfig(files=[fasta], output=str(d / "jax8.clstr"), **KMER))
    with open(d / "jax8.clstr", "rb") as f:
        jax8 = f.read()
    return d, fasta, jax8, run_one(fasta, str(d / "one.clstr"), **KMER)


@pytest.fixture(scope="module", params=[2, 3, 4],
                ids=["2ranks", "3ranks", "4ranks"])
def e2e_ranks(request, e2e):
    d, fasta = e2e[:2]
    n = request.param
    return (n,) + run_ranks(n, fasta, str(d / f"ranks{n}.clstr"), **KMER)


def test_pipeline_ranks_equal_jax_8_devices(e2e_ranks, e2e):
    assert e2e[2].count(b">Cluster") >= 2
    assert e2e_ranks[1] == e2e[2]


def test_pipeline_ranks_equal_one_rank(e2e_ranks, e2e):
    assert e2e_ranks[1] == e2e[3]


def test_pipeline_ranks_shard_and_launch_once(e2e_ranks):
    n, _, outs = e2e_ranks
    for r, out in enumerate(outs):
        assert (out["rank"], out["size"], out["backend"]) == (r, n, "gloo")
        assert out["clusterer"] == "DeviceBackend"
        assert out["kmer_hist_calls"] == 1
        c = out["counters"]
        assert c["coll_featurize"] == 3
        assert c["coll_phase_b"] == 3 * KMER["iterations"] + 1
        # Phase A is sharded where the ranks divide V = 4^4
        assert ("coll_accumulate" in c) == (256 % n == 0)
        assert out["jax_free"] and out["meshclust_tpu_free"]
    assert [o["n_clusters"] for o in outs] == [outs[0]["n_clusters"]] * n


def test_align_mode_two_ranks_equal_one_rank(e2e):
    d, fasta = e2e[:2]
    kw = dict(similarity=0.50, sample_size=120)
    got, outs = run_ranks(2, fasta, str(d / "align2.clstr"), **kw)
    assert got == run_one(fasta, str(d / "align1.clstr"), **kw)
    assert [o["clusterer"] for o in outs] == ["AlignBackend"] * 2
    assert [o["kmer_hist_calls"] for o in outs] == [1, 1]


@pytest.fixture(scope="module")
def written_by_ranks(e2e):
    """A 2-rank run with a checkpoint: (its CLSTR, its ranks' records,
    the checkpoint prefix)."""
    d, fasta = e2e[:2]
    prefix = str(d / "ck2")
    got, outs = run_ranks(2, fasta, str(d / "ck2.clstr"), checkpoint=prefix,
                          **KMER)
    return got, outs, prefix


def test_two_rank_checkpoint_resumes_one_rank(written_by_ranks, e2e):
    from meshclust_tpu_torch.utils import perf
    d, fasta = e2e[:2]
    got, _, prefix = written_by_ranks
    perf.reset()
    resumed = run_one(fasta, str(d / "ck2_resumed.clstr"),
                      checkpoint=prefix, **KMER)
    assert not {"train", "accumulate"} & set(perf.phases())
    assert resumed == got == e2e[3]


def test_one_rank_checkpoint_resumes_two_ranks(e2e):
    d, fasta = e2e[:2]
    prefix = str(d / "ck1")
    first = run_one(fasta, str(d / "ck1.clstr"), checkpoint=prefix, **KMER)
    resumed, outs = run_ranks(2, fasta, str(d / "ck1_resumed.clstr"),
                              checkpoint=prefix, **KMER)
    for out in outs:
        assert not {"train", "accumulate"} & set(out["phases"])
        assert out["writes"]["save_model"] == 0
    assert resumed == first == e2e[3]


def test_only_rank_zero_writes(written_by_ranks):
    _, outs, prefix = written_by_ranks
    assert outs[0]["writes"] == {"write_clstr": 1, "save_model": 1,
                                 "save_centers": 1, "save_memo": 0}
    assert outs[1]["writes"] == {"write_clstr": 0, "save_model": 0,
                                 "save_centers": 0, "save_memo": 0}
    assert os.path.isfile(prefix + ".model.json")
    assert os.path.isfile(prefix + ".centers.json")


RANK_SCRIPT = """
import sys, torch
torch.set_num_threads(1)
from meshclust_tpu_torch.config import ClusterConfig
from meshclust_tpu_torch.core.runner import run
res = run(ClusterConfig(files=[sys.argv[1]], output=sys.argv[2],
                        similarity=0.90, iterations=5, sample_size=120),
          device="cpu")
print("clusters", res["n_clusters"])
"""


def test_two_process_coordinator_run(e2e, tmp_path):
    _, fasta, _, one = e2e
    port = free_port()
    outs = [str(tmp_path / f"r{r}.clstr") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, fasta, outs[r]],
        cwd=str(tmp_path), env=coordinator_env(r, 2, port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
        assert "clusters" in out
    assert "Mesh: 2 ranks (data-parallel), backend gloo" in logs[0][1]
    with open(outs[0], "rb") as f:
        assert f.read() == one
    assert not os.path.exists(outs[1])

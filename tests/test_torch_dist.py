"""The port's collectives and launch (meshclust_tpu_torch/parallel/dist.py)
on the CPU: gloo ranks started by dist.launch(..., device="cpu").

Every collective at 2 and 4 ranks, on int64 and float64, against numpy on
the same inputs (exact: equal values); gather_rows with uneven and empty
blocks; psum and gather_rows refuse floats. Without a launcher, or with
MESHCLUST_DEVICES=1, there is no group and no mesh. The JAX package's
multi-host variables (MESHCLUST_COORDINATOR, MESHCLUST_NUM_PROCS,
MESHCLUST_PROC_ID) join two processes. A failing rank fails the launch
instead of hanging it.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.multiprocessing.spawn import ProcessException

import torch_dist_ranks as R
from meshclust_tpu_torch.parallel import dist

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 17
OPS = ["psum", "pmin", "pmax", "gather_rows"]


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request):
    n = request.param
    return n, dist.launch(R.collectives, n, "cpu", SEED)


def want(op, dtype, n):
    xs = np.stack([R.rank_values(SEED, r, dtype) for r in range(n)])
    if op == "psum":
        return "refused" if dtype == "float64" else xs.sum(0)
    if op == "pmin":
        return xs.min(0)
    if op == "pmax":
        return xs.max(0)
    off = R.uneven_offsets(n)
    if dtype == "float64":
        return "refused"
    return np.concatenate([R.rank_values(SEED + 1, r, dtype,
                                         int(off[r + 1] - off[r]))
                           for r in range(n)])


@pytest.mark.parametrize("dtype", sorted(R.DTYPES))
@pytest.mark.parametrize("op", OPS)
def test_collective_equals_numpy(ranks, op, dtype):
    n, outs = ranks
    expect = want(op, dtype, n)
    for r, out in enumerate(outs):
        assert out["rank"] == r and out["size"] == n
        got = out[op, dtype]
        if isinstance(expect, str):
            assert got == expect
        else:
            assert got.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(got, expect)


def test_ranks_are_gloo_on_the_cpu_and_counted(ranks):
    n, outs = ranks
    for out in outs:
        assert (out["backend"], out["device"]) == ("gloo", "cpu")
        # 2 dtypes x (pmin, pmax) + psum and gather_rows of int64 + the
        # barrier
        assert out["counters"]["coll_test"] == 2 * 2 + 2 + 1
    gathered = int(R.uneven_offsets(n)[-1]) * 3 * 8
    assert outs[0]["counters"]["coll_test_bytes"] == \
        2 * 2 * 5 * 3 * 8 + 5 * 3 * 8 + gathered + 8


def test_blocks_balance_by_weight():
    w = np.array([100, 1, 1, 1, 100, 1, 50, 50, 1, 1])
    off = dist.blocks(w, 3)
    assert off[0] == 0 and off[-1] == w.shape[0]
    assert (np.diff(off) >= 0).all()
    sums = [int(w[off[r]: off[r + 1]].sum()) for r in range(3)]
    assert max(sums) <= 104
    assert dist.blocks(w, 1).tolist() == [0, 10]
    assert dist.blocks(np.array([5, 5]), 4).tolist()[-1] == 2


def test_backend_rule():
    assert dist.backend_for("cpu", 4, 0) == "gloo"
    assert dist.backend_for("cuda", 2, 1) == "gloo"     # ranks share a GPU
    assert dist.backend_for("cuda", 4, 4) == "nccl"
    assert dist.backend_for("cuda", 2, 8) == "nccl"


@pytest.mark.parametrize("env", [{}, {"MESHCLUST_DEVICES": "1"}],
                         ids=["no_launcher", "devices_1"])
def test_no_group_without_launcher(env, monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MESHCLUST_COORDINATOR",
                 "MESHCLUST_DEVICES"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert not dist.under_launcher()
    assert dist.init_distributed("cpu") is None
    assert dist.get_mesh() is None
    assert not torch.distributed.is_initialized()
    assert dist.local_ranks() == 1


def test_failing_rank_fails_the_launch():
    """Rank 1 raises while ranks 0 and 2 wait at a barrier: the launch
    raises (with rank 1's error, or a waiting rank's on losing its peer,
    whichever process ends first) well before the group's timeout."""
    t0 = time.time()
    with pytest.raises(ProcessException):
        dist.launch(R.one_rank_fails, 3, "cpu")
    assert time.time() - t0 < dist.GROUP_TIMEOUT_S / 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


JOIN = """
import sys, torch
torch.set_num_threads(1)
from meshclust_tpu_torch.parallel import dist
mesh = dist.init_distributed("cpu")
total = dist.psum(torch.tensor([mesh.rank + 1]), mesh, "test")
print("mesh", mesh.rank, mesh.size, mesh.backend, int(total[0]))
dist.shutdown()
"""


def coordinator_env(rank: int, n: int, port: int) -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               MESHCLUST_COORDINATOR=f"127.0.0.1:{port}",
               MESHCLUST_NUM_PROCS=str(n), MESHCLUST_PROC_ID=str(rank))
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MESHCLUST_DEVICES", "MESHCLUST_QUIET"):
        env.pop(name, None)
    return env


def test_coordinator_env_joins_two_processes(tmp_path):
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", JOIN], cwd=str(tmp_path),
                              env=coordinator_env(r, 2, port),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert f"mesh {r} 2 gloo 3" in out

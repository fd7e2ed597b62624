"""Data parallelism over ranks with torch.distributed; twin of
meshclust_tpu/parallel/dist.py.

One process per rank, one device per rank. The sequence axis is split over
the ranks and the (small) center state is replicated:

  - featurization: each rank counts the k-mers of a contiguous block of
    records, balanced by bases, in one kmer_hist launch; the rows, 1-mers,
    magnitudes and sums of squares are gathered, so every rank holds the
    whole [N, V] histogram, and the largest count is a MAX across ranks;
  - Phase A (accumulate) is FEATURE-sharded: each rank keeps its [N, V/n]
    slice of the rows, and every reduction over V (Manhattan and dot sums,
    the mean's distance sums) is one SUM of exact int64 partials. The slot
    state (window, active, owner, stamp) is replicated and identical on
    every rank;
  - the fused Phase B (update + merge loop) is MEMBER-sharded: each rank
    holds a contiguous block of the member pool; per iteration one SUM of
    the mean's int64 sums and counts, one MIN of the best float64 distance
    and one MIN of the global pool position among the ties pick each new
    center; the merge is recomputed identically on every rank.

Determinism: every cross-rank reduction is exact (SUM on integers only, MIN
and MAX on int64 or float64, `psum` refuses floats), and every decision is
made in float64 on every rank from identical inputs in the op order of one
rank. So n ranks give the single rank's results bit for bit, and the CLSTR
byte for byte.

Launch (init_distributed, launch):
  - under torchrun (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) or the JAX package's multi-host variables
    (MESHCLUST_COORDINATOR=host:port, MESHCLUST_NUM_PROCS, MESHCLUST_PROC_ID;
    LOCAL_RANK and LOCAL_WORLD_SIZE where ranks span hosts), the process is
    one rank of that group;
  - otherwise the CLI starts MESHCLUST_DEVICES ranks with `launch`, which
    spawns them and joins them through a file store in a temporary
    directory. The default is 1, which runs without a process group: on 4
    H100s the 15k-read run took 3.1-4.0 s a rank at 2-4 ranks against
    1.2-1.3 s on one GPU, so several GPUs are opt-in until a size is
    measured where they win.
A rank takes device cuda:(LOCAL_RANK % device_count). The backend is a
rule, never a fallback: NCCL where every rank has a GPU of its own; gloo on
the CPU and where ranks share a GPU (NCCL refuses two ranks on one device).
The group has a timeout of GROUP_TIMEOUT_S, so a rank that dies fails the
run instead of hanging it. In a fresh checkout every rank builds the
kernel library at its first launch (_ext.build is atomic: the same file
written n times, n nvcc runs of a few seconds side by side).

The collectives are all built on all_reduce, which gloo takes on CUDA
tensors as well as CPU ones, so one form serves NCCL and gloo alike;
`gather_rows` is a SUM into a zeroed buffer (exact: only integers are
gathered). Each call names its site, and utils/perf counts the calls and bytes of each site (counters
coll_<site> and coll_<site>_bytes).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from meshclust_tpu_torch import device as D
from meshclust_tpu_torch.utils import perf

GROUP_TIMEOUT_S = 180


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a run: a 1-D "data" axis over a process group."""
    rank: int
    size: int
    group: object
    device: torch.device
    backend: str


_MESH: Optional[Mesh] = None


def _launcher_env() -> Optional[tuple]:
    """(rank, world_size, local_rank, local_world_size, init_method) from a
    launcher's environment, or None when the process was not launched as a
    rank."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, size, init = int(env["RANK"]), int(env["WORLD_SIZE"]), "env://"
    elif env.get("MESHCLUST_COORDINATOR"):
        rank = int(env.get("MESHCLUST_PROC_ID", "0"))
        size = int(env.get("MESHCLUST_NUM_PROCS", "1"))
        init = f"tcp://{env['MESHCLUST_COORDINATOR']}"
    else:
        return None
    return (rank, size, int(env.get("LOCAL_RANK", rank)),
            int(env.get("LOCAL_WORLD_SIZE", size)), init)


def under_launcher() -> bool:
    return _launcher_env() is not None


def local_ranks() -> int:
    """Ranks the CLI starts on this machine: MESHCLUST_DEVICES, else 1."""
    return max(1, int(os.environ.get("MESHCLUST_DEVICES") or 1))


def backend_for(device_type: str, local_world_size: int,
                device_count: int) -> str:
    """NCCL where every local rank has a GPU of its own, else gloo."""
    if device_type == "cuda" and local_world_size <= device_count:
        return "nccl"
    return "gloo"


def init_distributed(device: Optional[Union[str, torch.device]] = None, *,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     local_world_size: Optional[int] = None,
                     init_method: Optional[str] = None) -> Optional[Mesh]:
    """Join the process group of this rank before anything touches the
    device; returns the mesh (None for a single rank). The arguments come
    from the launcher's environment unless given (`launch` gives them).
    `device` is the run's device (None: CUDA); it picks the device type,
    and the rank's device index is LOCAL_RANK % device_count. A no-op once
    the group exists."""
    global _MESH
    if _MESH is not None:
        return get_mesh()
    if world_size is None:
        env = _launcher_env()
        if env is None:
            return None
        rank, world_size, local_rank, local_world_size, init_method = env
    if world_size <= 1:
        return None
    dev = D.resolve("cuda" if device is None else torch.device(device).type)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    backend = backend_for(dev.type, local_world_size, count)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    _MESH = Mesh(rank=rank, size=world_size, group=dist.group.WORLD,
                 device=dev, backend=backend)
    return _MESH


def get_mesh() -> Optional[Mesh]:
    """The run's mesh, or None on the single-rank path (no group)."""
    return _MESH if _MESH is not None and _MESH.size > 1 else None


def shutdown() -> None:
    """Leave the process group (the end of a rank)."""
    global _MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESH = None


# -- collectives --------------------------------------------------------------

def _count(site: str, t: torch.Tensor) -> None:
    perf.add(f"coll_{site}", 1.0)
    perf.add(f"coll_{site}_bytes", float(t.numel() * t.element_size()))


def _all_reduce(t: torch.Tensor, mesh: Mesh, op, site: str) -> torch.Tensor:
    out = t.clone()
    _count(site, out)
    dist.all_reduce(out, op=op, group=mesh.group)
    return out


def psum(t: torch.Tensor, mesh: Mesh, site: str) -> torch.Tensor:
    """Sum across ranks; integers only, so the sum is exact in any order."""
    if t.is_floating_point() or t.dtype == torch.bool:
        raise TypeError(f"psum takes integer tensors, not {t.dtype}: a sum "
                        f"of floats across ranks depends on their order")
    return _all_reduce(t, mesh, dist.ReduceOp.SUM, site)


def _exact_order(t: torch.Tensor, name: str) -> None:
    if t.dtype not in (torch.int64, torch.float64):
        raise TypeError(f"{name} takes int64 or float64 tensors, not "
                        f"{t.dtype}")


def pmin(t: torch.Tensor, mesh: Mesh, site: str) -> torch.Tensor:
    """Elementwise minimum across ranks (int64 or float64)."""
    _exact_order(t, "pmin")
    return _all_reduce(t, mesh, dist.ReduceOp.MIN, site)


def pmax(t: torch.Tensor, mesh: Mesh, site: str) -> torch.Tensor:
    """Elementwise maximum across ranks (int64 or float64)."""
    _exact_order(t, "pmax")
    return _all_reduce(t, mesh, dist.ReduceOp.MAX, site)


def gather_rows(local: torch.Tensor, offsets: Sequence[int], mesh: Mesh,
                site: str) -> torch.Tensor:
    """The blocks of all ranks stacked on axis 0: rank r holds rows
    offsets[r]:offsets[r + 1] (blocks may be uneven or empty). An integer
    SUM into a zeroed buffer, so the result is exact on every rank. A ring
    all-reduce moves twice the bytes of an all-gather, but a run gathers
    three times, in featurization; an all-gather of padded blocks would
    need a second full-size buffer to drop the padding of uneven blocks."""
    if local.is_floating_point() or local.dtype == torch.bool:
        raise TypeError(f"gather_rows takes integer tensors, not "
                        f"{local.dtype}")
    lo, hi = int(offsets[mesh.rank]), int(offsets[mesh.rank + 1])
    if local.shape[0] != hi - lo:
        raise ValueError(f"rank {mesh.rank} holds {local.shape[0]} rows, "
                         f"not {hi - lo}")
    out = torch.zeros((int(offsets[-1]),) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    out[lo:hi] = local
    _count(site, out)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def barrier(mesh: Mesh, site: str) -> None:
    """Returns on each rank once every rank has reached it."""
    t = torch.zeros(1, dtype=torch.int64, device=mesh.device)
    _count(site, t)
    dist.all_reduce(t, group=mesh.group)
    t.cpu()


def blocks(weights: np.ndarray, n: int) -> np.ndarray:
    """[n + 1] offsets of n contiguous blocks of the items, balanced by
    their weights (rank r takes items offsets[r]:offsets[r + 1])."""
    w = np.asarray(weights, np.int64)
    cum = np.concatenate([[0], np.cumsum(w)])
    cuts = np.searchsorted(cum, cum[-1] * np.arange(1, n) / n, side="left")
    return np.concatenate([[0], cuts, [w.shape[0]]]).astype(np.int64)


# -- launch -------------------------------------------------------------------

def _rank_main(rank: int, fn: Callable, n: int, device, tmp: str,
               args: tuple) -> None:
    if torch.device("cuda" if device is None else device).type == "cpu":
        # n ranks share the host's cores: one intra-op thread each
        torch.set_num_threads(1)
    init_distributed(device, rank=rank, world_size=n, local_rank=rank,
                     local_world_size=n,
                     init_method="file://" + os.path.join(tmp, "store"))
    try:
        result = fn(*args)
    finally:
        shutdown()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def launch(fn: Callable, n: int,
           device: Optional[Union[str, torch.device]] = None,
           *args) -> List[object]:
    """Run fn(*args) on n local ranks, one spawned process each, joined as
    one group (the run's device as run() takes it: None is CUDA, "cpu"
    gloo ranks on the host). fn must be importable by name and its result
    picklable. Returns the ranks' results in rank order; raises when a rank
    fails (the others are then terminated)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="meshclust_ranks_") as tmp:
        mp.start_processes(_rank_main, args=(fn, n, device, tmp, args),
                           nprocs=n, join=True, start_method="spawn")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

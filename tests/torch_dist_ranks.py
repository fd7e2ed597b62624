"""Rank functions of the multi-rank tests of the port.

parallel/dist.launch spawns each rank, which imports its function from this
module by name (tests/ is on sys.path under pytest). Each function runs
inside a joined group, reads the mesh with dist.get_mesh() and returns
plain numpy and Python values. The module imports neither jax nor
meshclust_tpu, so the ranks start where jax is absent too.
"""
import numpy as np
import torch

from meshclust_tpu_torch.parallel import dist
from meshclust_tpu_torch.utils import perf

DTYPES = {"int64": torch.int64, "float64": torch.float64}


def rank_values(seed: int, rank: int, dtype: str, rows: int = 5):
    """Rank `rank`'s [rows, 3] input of the collective tests (float64
    values carry fractions and signs, int64 ones exceed 2^31)."""
    rng = np.random.default_rng([seed, rank])
    if dtype == "int64":
        return rng.integers(-2 ** 40, 2 ** 40, size=(rows, 3))
    return rng.normal(size=(rows, 3)) * 1e3


def uneven_offsets(n: int) -> np.ndarray:
    """Offsets of uneven blocks: rank r holds (r * 2) % 5 rows (rank 0
    none)."""
    return np.concatenate([[0], np.cumsum([(r * 2) % 5 for r in range(n)])])


def collectives(seed: int) -> dict:
    """Each collective of parallel/dist on this rank's rank_values, on
    int64 and float64 tensors on the mesh's device; a refused call is
    recorded as "refused"."""
    mesh = dist.get_mesh()
    perf.reset()
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device)}
    off = uneven_offsets(mesh.size)

    def put(a, dt):
        return torch.as_tensor(a, dtype=dt, device=mesh.device)

    def calls(name, fn):
        try:
            out[name] = fn().cpu().numpy()
        except TypeError:
            out[name] = "refused"

    for name, dt in DTYPES.items():
        x = put(rank_values(seed, mesh.rank, name), dt)
        rows = put(rank_values(seed + 1, mesh.rank, name,
                               int(off[mesh.rank + 1] - off[mesh.rank])), dt)
        calls(("pmin", name), lambda: dist.pmin(x, mesh, "test"))
        calls(("pmax", name), lambda: dist.pmax(x, mesh, "test"))
        calls(("psum", name), lambda: dist.psum(x, mesh, "test"))
        calls(("gather_rows", name),
              lambda: dist.gather_rows(rows, off, mesh, "test"))
    dist.barrier(mesh, "test")
    out["counters"] = perf.counters()
    return out


def _count_calls(module, name: str) -> list:
    """Wrap module.name so each call appends its keyword arguments to the
    returned list."""
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(kw)
        return fn(*a, **kw)

    setattr(module, name, counted)
    return calls


def featurize(fasta: str, ks: list) -> dict:
    """ops/histogram.featurize over the mesh at each k: its outputs, the
    kmer_hist calls (with their split flag) and the counters."""
    from meshclust_tpu_torch.io import fasta as fio
    from meshclust_tpu_torch.ops import histogram as H
    seqs = fio.read_fasta(fasta)
    calls = _count_calls(H, "kmer_hist")
    out = {}
    for k in ks:
        perf.reset()
        del calls[:]
        f = H.featurize(seqs, k, torch.device("cpu"), mesh=dist.get_mesh())
        out[k] = {"hist": f["hist_dev"].numpy(), "one_mers": f["one_mers"],
                  "mag": f["mag"], "sq": f["sq"], "largest": f["largest"],
                  "lengths": f["lengths"],
                  "splits": [c["split"] for c in calls],
                  "counters": perf.counters()}
    return out


def _points(arrays: dict):
    from meshclust_tpu_torch import convert
    return convert.pointset_from_numpy(
        arrays["hist"], arrays["mag"], arrays["sq"], arrays["lengths"],
        arrays["one_mers"], arrays["codes"], arrays["headers"], arrays["k"],
        device="cpu")


def scalar_reads(fn):
    """(fn(), how many times it read a tensor's value back to the host
    through aten::_local_scalar_dense: .item(), int(), a 0-dim index)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sum(e.count for e in prof.key_averages()
                    if e.key == "aten::_local_scalar_dense")


def phase_b(cases: list) -> list:
    """DeviceBackend(mesh=).phase_b_loop of each case (arrays, params,
    members, assign, rows, delta, iterations)."""
    from meshclust_tpu_torch.core.classify import DeviceBackend
    out = []
    for arrays, params, members, assign, rows, delta, iters in cases:
        be = DeviceBackend(_points(arrays), params, mesh=dist.get_mesh())
        perf.reset()
        res, reads = scalar_reads(lambda: be.phase_b_loop(
            members, assign, rows, delta, iters))
        out.append({"result": res, "reads": reads,
                    "counters": perf.counters()})
    return out


def phase_a(cases: list) -> list:
    """accumulate_device over the mesh for each case (arrays, params,
    bin_size, sim): (center, members) lists, counters and scalar reads."""
    from meshclust_tpu_torch.core.accumulate_device import accumulate_device
    from meshclust_tpu_torch.core.bvec import BVec
    out = []
    for arrays, params, bin_size, sim in cases:
        ps = _points(arrays)
        bv = BVec(ps.lengths.copy(), bin_size)
        for i in range(ps.n):
            bv.insert(i, int(ps.lengths[i]))
        bv.insert_finalize()
        perf.reset()
        centers, reads = scalar_reads(lambda: accumulate_device(
            ps, bv, params, sim, mesh=dist.get_mesh()))
        out.append({"centers": [(c.center, list(c.members))
                                for c in centers],
                    "reads": reads, "counters": perf.counters()})
    return out


def cluster(cfg_kwargs: dict) -> dict:
    """core.runner.run(ClusterConfig(**cfg_kwargs), device="cpu") as one
    rank, with the kmer_hist calls and the file writes recorded."""
    import sys
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core import runner
    from meshclust_tpu_torch.ops import histogram as H
    from meshclust_tpu_torch.utils import align_memo
    from meshclust_tpu_torch.utils import checkpoint as ckpt
    calls = _count_calls(H, "kmer_hist")
    writes = []
    for module, name in ((runner, "write_clstr"), (ckpt, "save_model"),
                         (ckpt, "save_centers"), (align_memo, "save_memo")):
        hits = _count_calls(module, name)
        writes.append((name, hits))
    mesh = dist.get_mesh()
    perf.reset()
    res = runner.run(ClusterConfig(**cfg_kwargs), device="cpu")
    return {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
            "device": str(mesh.device),
            "clusterer": type(res["backend"]).__name__,
            "n_clusters": res["n_clusters"], "kmer_hist_calls": len(calls),
            "writes": {name: len(hits) for name, hits in writes},
            "phases": perf.phases(), "counters": perf.counters(),
            "jax_free": "jax" not in sys.modules
            or sys.modules["jax"] is None,
            "meshclust_tpu_free": not any(
                m == "meshclust_tpu" or m.startswith("meshclust_tpu.")
                for m in sys.modules)}


def one_rank_fails() -> None:
    """Rank 1 raises before a barrier that the others wait at."""
    mesh = dist.get_mesh()
    if mesh.rank == 1:
        dist.psum(torch.ones(2, dtype=torch.float64), mesh, "test")
    dist.barrier(mesh, "test")

"""End to end, the port against the JAX package on two seeded corpora (one
with N runs): the port's run() on the CPU (every kernel through its plain
PyTorch version), by default (DeviceBackend, device Phase A, fused Phase B)
and with exact=True (HostBackend), must write a CLSTR byte-equal to
meshclust_tpu's run() with exact=True, and the port's MeanShift, given the
JAX-trained model and points through convert.py, must find the same centers
and members as the JAX run with either backend.
"""
import numpy as np
import pytest
import torch

# The port's CPU run issues many small ops through the kernels' plain
# versions: one intra-op thread per test process keeps OpenMP from
# oversubscribing the cores under pytest-xdist.
torch.set_num_threads(1)
LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)
CORPORA = {"plain": (1, False), "n_runs": (2, True)}


def write_corpus(path, seed, n_runs, n_species=6, per=20, L=160):
    """n_species random species of ~L bp, `per` clones each with 3% point
    substitutions and slight length jitter; with n_runs, every third clone
    gets an N run. Records are written in species order."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for s in range(n_species):
            Ls = L + int(rng.integers(-L // 10, L // 10))
            base = rng.integers(0, 4, size=Ls)
            for c in range(per):
                seq = base.copy()
                mut = rng.random(Ls) < 0.03
                seq[mut] = (seq[mut] + 1 + rng.integers(
                    0, 3, size=int(mut.sum()))) % 4
                row = LETTERS[seq[: Ls - int(rng.integers(0, 6))]].copy()
                if n_runs and c % 3 == 0:
                    p = int(rng.integers(10, row.shape[0] - 40))
                    row[p: p + int(rng.integers(3, 30))] = ord("N")
                f.write(b">sp%d_c%d\n" % (s, c))
                f.write(row.tobytes() + b"\n")
    return str(path)


def run_port(fasta, out, exact=False):
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.runner import run
    run(ClusterConfig(files=[fasta], similarity=0.90, output=out,
                      sample_size=300, exact=exact), device="cpu")
    with open(out, "rb") as f:
        return f.read()


def run_jax(fasta, out, exact):
    from meshclust_tpu.config import ClusterConfig
    from meshclust_tpu.core.runner import run
    res = run(ClusterConfig(files=[fasta], similarity=0.90, output=out,
                            sample_size=300, exact=exact))
    with open(out, "rb") as f:
        return f.read(), res


@pytest.fixture(scope="module", params=sorted(CORPORA))
def runs(request, tmp_path_factory):
    seed, n_runs = CORPORA[request.param]
    d = tmp_path_factory.mktemp(f"e2e_{request.param}")
    fasta = write_corpus(d / "corpus.fasta", seed, n_runs)
    port = run_port(fasta, str(d / "port.clstr"))
    port_exact = run_port(fasta, str(d / "port_exact.clstr"), exact=True)
    jax_clstr, jax_res = run_jax(fasta, str(d / "jax_exact.clstr"), True)
    return port, jax_clstr, jax_res, port_exact


def test_clstr_equals_jax_exact(runs):
    port, jax_clstr, jax_res, _ = runs
    assert jax_res["n_clusters"] >= 2
    assert port == jax_clstr


def test_clstr_exact_equals_jax_exact(runs):
    _, jax_clstr, _, port_exact = runs
    assert port_exact == jax_clstr


def meanshift_given_jax_model(runs, exact):
    """The port's MeanShift, on make_backend(exact=exact), driven by the
    JAX-trained model and points carried over by convert.py: (centers,
    backend)."""
    from meshclust_tpu_torch import convert
    from meshclust_tpu_torch.core.bvec import BVec
    from meshclust_tpu_torch.core.classify import make_backend
    from meshclust_tpu_torch.core.meanshift import MeanShift
    jax_res = runs[2]
    jps = jax_res["pointset"]
    jparams = jax_res["model"].params
    ps = convert.pointset_from_numpy(
        jps.hist, jps.mag, jps.sq, jps.lengths, jps.one_mers, jps.codes,
        jps.headers, jps.k, device="cpu")
    params = convert.params_from_numpy(
        jparams.singles, jparams.mins, jparams.maxs, jparams.is_sim,
        jparams.combos, jparams.weights)
    bv = BVec(ps.lengths.copy(), 1000)
    bv.bulk_insert(ps.lengths)
    bv.insert_finalize()
    backend = make_backend(ps, params, exact=exact)
    centers = MeanShift(ps, backend, sim=0.90, delta=5,
                        iterations=15).run(bv)
    want = [(c.center, list(c.members)) for c in jax_res["centers"]]
    assert [(c.center, list(c.members)) for c in centers] == want
    return centers, backend


def test_meanshift_equals_jax_given_jax_model(runs):
    """Clustering alone: the JAX-trained model and points drive the port's
    MeanShift, on DeviceBackend, to the JAX run's centers."""
    from meshclust_tpu_torch.core.classify import DeviceBackend
    _, backend = meanshift_given_jax_model(runs, exact=False)
    assert isinstance(backend, DeviceBackend)


def test_meanshift_host_backend_equals_jax_given_jax_model(runs):
    """The same on HostBackend (exact=True)."""
    from meshclust_tpu_torch.core.classify import HostBackend
    _, backend = meanshift_given_jax_model(runs, exact=True)
    assert isinstance(backend, HostBackend)


def test_make_backend_picks_align_backend(tmp_path):
    """An align-mode model (the alignment identity is its only feature)
    gets AlignBackend when an aligner is given, HostBackend otherwise."""
    from meshclust_tpu_torch import convert
    from meshclust_tpu_torch.core.classify import (AlignBackend, HostBackend,
                                                   make_backend)
    from meshclust_tpu_torch.core.points import build_points
    from meshclust_tpu_torch.io import fasta as fio
    from meshclust_tpu_torch.ops import features as F
    from meshclust_tpu_torch.ops.align_device import DeviceAligner
    params = convert.params_from_numpy([F.FEAT_ALIGN], [0.0], [1.0], [True],
                                       [(F.COMBO_SELF, [0])], [-0.9, 1.0])
    fasta = write_corpus(tmp_path / "tiny.fasta", 3, False, n_species=2,
                         per=3, L=60)
    ps = build_points(fio.read_fasta(fasta), 3, "cpu")
    backend = make_backend(ps, params,
                           aligner=DeviceAligner(ps.codes, "cpu"))
    assert isinstance(backend, AlignBackend)
    assert backend.memo.n == ps.n
    assert isinstance(make_backend(ps, params), HostBackend)


@pytest.mark.parametrize("kw", [{"similarity": 0.5}, {"align": True}],
                         ids=["id_below_0.60", "align_flag"])
def test_run_align_mode_writes_clstr(kw, tmp_path):
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.classify import AlignBackend
    from meshclust_tpu_torch.core.runner import run
    fasta = write_corpus(tmp_path / "tiny.fasta", 4, False, n_species=2,
                         per=4, L=80)
    out = tmp_path / "out.clstr"
    res = run(ClusterConfig(files=[fasta], output=str(out), **kw),
              device="cpu")
    assert res["model"].k == 0
    assert isinstance(res["backend"], AlignBackend)
    text = out.read_text()
    assert text.startswith(">Cluster 0")
    assert text.count("nt, >sp") == 8


def test_perf_report_leaves_out_tpu_utilization_estimates():
    """MESHCLUST_PERF=1 prints phases, counters and measured rates; the
    report has no *_util_est keys (the JAX package's TPU peaks)."""
    from meshclust_tpu_torch.utils import perf
    import time
    perf.reset()
    with perf.phase("align"):
        perf.add("nw_cells", 1e6)
        perf.add("accum_sweep_bytes", 1e9)
        time.sleep(0.002)
    with perf.phase("accumulate"):
        time.sleep(0.002)
    text = perf.format_report()
    perf.reset()
    assert "phase align" in text and "counter nw_cells" in text
    assert "nw_cells_per_s" in text
    assert "util_est" not in text and "accum_gbps" not in text


@pytest.mark.parametrize("flags", [["--no-pallas"], ["--checkpoint", "ck"]],
                         ids=["no_pallas", "checkpoint"])
def test_cli_refuses_unported_flags(flags, tmp_path, capsys, monkeypatch):
    """--no-pallas is refused. --checkpoint was refused until it was
    ported; now it reaches run() (tests/test_torch_checkpoint.py drives
    it)."""
    from meshclust_tpu_torch import cli
    seen = []
    monkeypatch.setattr(cli, "run", lambda cfg: seen.append(cfg) or {
        "n_clusters": 0})
    got = cli.main([str(tmp_path / "in.fasta"), *flags])
    if flags[0] == "--no-pallas":
        assert got == 2 and not seen
        assert "not supported" in capsys.readouterr().err
    else:
        assert got == 0 and [c.checkpoint for c in seen] == ["ck"]

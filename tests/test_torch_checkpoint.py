"""--checkpoint and MESHCLUST_TRACE in the port, on the CPU.

A checkpoint is two JSON files, PREFIX.model.json (the trained classifier)
and PREFIX.centers.json (the Phase-A centers), in the JAX package's format
(utils/checkpoint.py is a verbatim copy): one written by either package
loads in the other and gives the same CLSTR, byte for byte. A resumed run,
with or without the centers file, writes what an uninterrupted run writes;
a changed corpus, seed or identity makes both loads return None; and a
traced run writes a torch.profiler trace and the same CLSTR.
"""
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from meshclust_tpu_torch import cli
from meshclust_tpu_torch.config import ClusterConfig
from meshclust_tpu_torch.core.runner import run
from meshclust_tpu_torch.utils import checkpoint as ckpt
from meshclust_tpu_torch.utils import perf
from tests.test_torch_end2end import write_corpus

torch.set_num_threads(1)

KMER = {"similarity": 0.90, "sample_size": 300}
ALIGN = {"similarity": 0.50}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def run_port(fasta, out, checkpoint=None, **opts):
    """The port's run on the CPU -> (CLSTR bytes, phases, result)."""
    perf.reset()
    res = run(ClusterConfig(files=[fasta], output=out, checkpoint=checkpoint,
                            **opts), device="cpu")
    return _read(out), set(perf.phases()), res


def run_jax(fasta, out, checkpoint=None):
    """The JAX package's run with the float64 host classifier."""
    from meshclust_tpu.config import ClusterConfig as JaxConfig
    from meshclust_tpu.core.runner import run as jax_run
    from meshclust_tpu.utils import perf as jax_perf
    jax_perf.reset()
    jax_run(JaxConfig(files=[fasta], output=out, checkpoint=checkpoint,
                      exact=True, **KMER))
    return _read(out), set(jax_perf.phases())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    return str(d), write_corpus(d / "corpus.fasta", 2, True)


def test_jax_checkpoint_resumes_in_port(corpus):
    d, fasta = corpus
    prefix = os.path.join(d, "from_jax")
    jax_clstr, jax_phases = run_jax(fasta, os.path.join(d, "j1.clstr"),
                                    prefix)
    assert {"train", "accumulate"} <= jax_phases
    clstr, phases, res = run_port(fasta, os.path.join(d, "p1.clstr"),
                                  prefix, **KMER)
    assert "train" not in phases and "accumulate" not in phases
    assert type(res["backend"]).__name__ == "DeviceBackend"
    assert clstr == jax_clstr
    assert res["n_clusters"] >= 2


def test_port_checkpoint_resumes_in_jax(corpus):
    d, fasta = corpus
    prefix = os.path.join(d, "from_port")
    clstr, phases, _ = run_port(fasta, os.path.join(d, "p2.clstr"), prefix,
                                **KMER)
    assert {"train", "accumulate"} <= phases
    for kind in ("model", "centers"):
        with open(f"{prefix}.{kind}.json") as f:
            assert json.load(f)["kind"] == kind
    jax_clstr, jax_phases = run_jax(fasta, os.path.join(d, "j2.clstr"),
                                    prefix)
    assert "train" not in jax_phases and "accumulate" not in jax_phases
    assert jax_clstr == clstr


@pytest.mark.parametrize("mode", ["kmer", "align", "align_exact"])
def test_resumed_run_equals_uninterrupted(mode, tmp_path):
    """Uninterrupted (no checkpoint); first run with a checkpoint (writes
    the files); resumed from them; resumed from the model alone (the
    centers file removed, so Phase A runs again and rewrites it). In align
    mode Phase B reads Phase A's identities, so the memo file goes with the
    centers: without it the centers do not resume either."""
    if mode == "kmer":
        fasta = write_corpus(tmp_path / "c.fasta", 3, True)
        opts, backend = KMER, "DeviceBackend"
    else:
        fasta = write_corpus(tmp_path / "c.fasta", 4, False, n_species=3,
                             per=8, L=150)
        opts = dict(ALIGN, exact=mode == "align_exact")
        backend = "HostBackend" if opts["exact"] else "AlignBackend"
    prefix = str(tmp_path / "ck")
    files = [prefix + ".model.json", prefix + ".centers.json"]
    if mode != "kmer":
        files.append(prefix + ".memo.json")
    want, _, _ = run_port(fasta, str(tmp_path / "plain.clstr"), **opts)
    first, phases, _ = run_port(fasta, str(tmp_path / "first.clstr"),
                                prefix, **opts)
    assert {"train", "accumulate"} <= phases
    assert sorted(glob.glob(prefix + ".*")) == sorted(files)
    saved = [_read(f) for f in files[1:]]
    resumed, phases, res = run_port(fasta, str(tmp_path / "both.clstr"),
                                    prefix, **opts)
    assert "train" not in phases and "accumulate" not in phases
    assert type(res["backend"]).__name__ == backend
    outs = [first, resumed]
    for gone in files[1:]:
        os.remove(gone)
        out, phases, _ = run_port(fasta, str(tmp_path / "again.clstr"),
                                  prefix, **opts)
        assert "train" not in phases and "accumulate" in phases
        assert [_read(f) for f in files[1:]] == saved
        outs.append(out)
    assert outs == [want] * len(outs)


@pytest.mark.parametrize("reader", ["native", "numpy"])
def test_align_memo_file_same_from_either_memo(reader, tmp_path,
                                               monkeypatch):
    """An align-mode run writes PREFIX.memo.json byte for byte the same
    (format version 1) whether its memo is the native hash table or the
    numpy fallback (MESHCLUST_NATIVE=0), and a run of either kind resumes
    from the other's files through PairMemo.load, with the memo it loaded
    and the same CLSTR."""
    fasta = write_corpus(tmp_path / "c.fasta", 4, False, n_species=3, per=8,
                         L=150)
    outs, memos = [], []
    for kind in ("native", "numpy"):
        monkeypatch.setenv("MESHCLUST_NATIVE", "1" if kind == "native"
                           else "0")
        prefix = str(tmp_path / kind)
        out, phases, res = run_port(fasta, str(tmp_path / f"{kind}.clstr"),
                                    prefix, **ALIGN)
        assert "accumulate" in phases
        assert (res["backend"].memo._h is not None) == (kind == "native")
        outs.append(out)
        memos.append(_read(prefix + ".memo.json"))
    assert memos[0] == memos[1] and outs[0] == outs[1]
    blob = json.loads(memos[0])
    assert blob["version"] == 1 and len(blob["keys"]) > 0
    monkeypatch.setenv("MESHCLUST_NATIVE", "1" if reader == "native"
                       else "0")
    writer = "numpy" if reader == "native" else "native"
    out, phases, res = run_port(fasta, str(tmp_path / "resumed.clstr"),
                                str(tmp_path / writer), **ALIGN)
    assert "train" not in phases and "accumulate" not in phases
    memo = res["backend"].memo
    assert (memo._h is not None) == (reader == "native")
    # Phase B adds its misses to what was loaded
    vals, found = memo.lookup(np.asarray(blob["keys"], np.int64))
    assert found.all() and vals.tolist() == blob["vals"]
    assert out == outs[0]


def test_mismatched_checkpoint_does_not_load(corpus, tmp_path):
    d, fasta = corpus
    prefix = str(tmp_path / "ck")
    cfg = ClusterConfig(files=[fasta], output=str(tmp_path / "a.clstr"),
                        checkpoint=prefix, **KMER)
    res = run(cfg, device="cpu")
    cfg = cfg.finalize()
    ps, k = res["pointset"], res["k"]
    model, centers = prefix + ".model.json", prefix + ".centers.json"

    def loads(ps=ps, cutoff=0.90, seed=10, cfg=cfg):
        return (ckpt.load_model(model, ps, k, cutoff, seed, cfg) is not None,
                ckpt.load_centers(centers, ps, k, cutoff, seed, cfg)
                is not None)

    assert loads() == (True, True)
    assert loads(cutoff=0.85) == (False, False)
    assert loads(seed=11) == (False, False)
    assert loads(cfg=dataclasses.replace(cfg, sample_size=400)) \
        == (False, False)
    # one base of one record changed: the content hash differs
    codes = [c.copy() for c in ps.codes]
    codes[7][20] = (codes[7][20] + 1) % 4
    assert loads(ps=dataclasses.replace(ps, codes=codes)) == (False, False)
    # a changed --id retrains and recomputes Phase A
    _, phases, _ = run_port(fasta, str(tmp_path / "b.clstr"), prefix,
                            similarity=0.85, sample_size=300)
    assert {"train", "accumulate"} <= phases


def test_trace_written_and_clstr_unchanged(tmp_path, monkeypatch):
    """The CPU run's trace holds every aten op of the kernels' plain
    versions (~80 MB here), so only its head and its op names are read."""
    fasta = write_corpus(tmp_path / "c.fasta", 5, True, n_species=2, per=6,
                         L=150)
    opts = dict(KMER, sample_size=60)
    want, _, _ = run_port(fasta, str(tmp_path / "plain.clstr"), **opts)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("MESHCLUST_TRACE", str(trace_dir))
    got, _, _ = run_port(fasta, str(tmp_path / "traced.clstr"), **opts)
    assert got == want
    traces = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        text = f.read()
    assert text.lstrip().startswith("{") and '"traceEvents"' in text
    assert '"name": "aten::' in text


def test_trace_off_when_unset(tmp_path, monkeypatch):
    monkeypatch.delenv("MESHCLUST_TRACE", raising=False)
    fasta = write_corpus(tmp_path / "c.fasta", 6, False, n_species=2, per=6,
                         L=150)
    seen = []
    import torch.profiler as tp
    monkeypatch.setattr(tp, "profile",
                        lambda *a, **k: seen.append(1) or pytest.fail())
    run_port(fasta, str(tmp_path / "a.clstr"), **KMER)
    assert not seen


def test_cli_passes_checkpoint(tmp_path, monkeypatch):
    seen = {}

    def fake_run(cfg):
        seen["cfg"] = cfg
        return {"n_clusters": 1}

    monkeypatch.setattr(cli, "run", fake_run)
    prefix = str(tmp_path / "ck")
    assert cli.main(["in.fasta", "--checkpoint", prefix, "--exact"]) == 0
    assert seen["cfg"].checkpoint == prefix and seen["cfg"].exact
    assert cli.build_parser().parse_args(["x.fa"]).checkpoint is None
    text = cli.build_parser().format_help()
    assert "float64 host classifier" in text and "PREFIX" in text
    assert all(w in cli.__doc__ for w in ("--exact", "--checkpoint"))

"""Run orchestration (Runner re-design), twin of meshclust_tpu/core/runner.py.

Pipeline (Runner.cpp:25-90, 321-375): input collection (basename-sorted),
auto-k, featurization, dtype scan, training, bvec fill, mean-shift, CLSTR.

Featurization, the pivot distance rows and every alignment run on the
device. In k-mer mode clustering runs there too: the float64 device
classifier (DeviceBackend), Phase A on the device and the fused Phase B;
--exact (cfg.exact) selects the float64 host classifier (HostBackend) and
the host Phase A and B instead. In align mode (--align or --id < 0.60)
every decision is an alignment identity from the device aligner
(AlignBackend).

cfg.checkpoint saves and resumes the trained classifier and the Phase-A
centers (utils/checkpoint, the JAX package's format: a checkpoint written
by either package loads in the other), and in align mode the Phase-A
alignment memo that Phase B reads (utils/align_memo). MESHCLUST_TRACE=DIR
writes a torch.profiler trace of the run (host and, on CUDA, the card's
kernels) into DIR, one file a rank.

Several ranks (parallel/dist; the CLI starts them, or a launcher does):
run() joins the process group first and takes the rank's device. Every
rank computes the same centers; rank 0 alone writes the CLSTR and the
checkpoint files, and every rank reads the checkpoint files. Barriers keep
a rank from reading a file that rank 0 is about to write, and end the run
with the files in place.
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional, Union

import numpy as np
import torch

from meshclust_tpu_torch import device as D
from meshclust_tpu_torch.config import ClusterConfig
from meshclust_tpu_torch.core import classify as C
from meshclust_tpu_torch.core.bvec import BVec
from meshclust_tpu_torch.core.meanshift import MeanShift
from meshclust_tpu_torch.core.points import build_points
from meshclust_tpu_torch.core.trainer import Trainer
from meshclust_tpu_torch.errors import FileDoesNotExistError
from meshclust_tpu_torch.io import fasta as fio
from meshclust_tpu_torch.io.clstr import write_clstr
from meshclust_tpu_torch.ops import histogram as H
from meshclust_tpu_torch.ops.align_device import DeviceAligner
from meshclust_tpu_torch.parallel import dist
from meshclust_tpu_torch.utils import align_memo
from meshclust_tpu_torch.utils import checkpoint as ckpt
from meshclust_tpu_torch.utils import perf
from meshclust_tpu_torch.utils.log import log


def sort_files(files: List[str]) -> List[str]:
    """Inputs sorted by basename (Runner.cpp:253-262)."""
    return sorted(files, key=lambda p: os.path.basename(p))


def perf_report() -> str:
    """Phase times, work counters and measured rates from utils/perf.

    The carried-over report's *_util_est lines are left out: they divide by
    a TPU's peak rates, which say nothing about a GPU."""
    return "\n".join(line for line in perf.format_report().splitlines()
                     if "_util_est" not in line)


def run(cfg: ClusterConfig,
        device: Optional[Union[str, torch.device]] = None) -> dict:
    """Cluster cfg.files into cfg.output on `device` (None: CUDA).

    cfg.exact selects HostBackend, the float64 host oracle, for every
    clustering decision, as in the JAX package. Under a launcher, or in a
    rank that parallel/dist.launch started, the run is one rank of the
    group, on the rank's device of `device`'s type; a group that run()
    joined itself it also leaves (a process that exits still in a group
    may abort in gloo's teardown)."""
    joins = dist.get_mesh() is None
    mesh = dist.init_distributed(device)   # before anything touches the device
    dev = mesh.device if mesh is not None else D.resolve(device)
    try:
        trace_dir = os.environ.get("MESHCLUST_TRACE")
        if not trace_dir:
            return _run(cfg, dev)
        # a Chrome/TensorBoard trace of host ops and the card's kernels;
        # complements the phase times and counters of utils/perf.py
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(trace_dir)):
            return _run(cfg, dev)
    finally:
        if joins and mesh is not None:
            dist.shutdown()


def _run(cfg: ClusterConfig, dev: torch.device) -> dict:
    mesh = dist.get_mesh()
    if mesh is not None:
        log(f"Mesh: {mesh.size} ranks (data-parallel), backend "
            f"{mesh.backend}")
    writer = mesh is None or mesh.rank == 0

    def barrier():
        if mesh is not None:
            dist.barrier(mesh, "run")
    cfg = cfg.finalize()
    files = sort_files(list(cfg.files))
    if not files:
        raise FileDoesNotExistError("no input files")
    for f in files:
        if not os.path.isfile(f):
            raise FileDoesNotExistError(f'File "{f}" does not exist')
    log(f"Device: {dev}")

    log("Reading in sequences")
    with perf.phase("read"):
        per_file = [fio.read_fasta(f) for f in files]
    seqs = [s for fs in per_file for s in fs]
    if not seqs:
        raise FileDoesNotExistError("no sequences found")

    k = cfg.kmer if cfg.kmer is not None else H.find_k(per_file)
    k = max(1, k)
    log(f"Using k = {k}")

    log(f"Counting {k}-mers")
    with perf.phase("featurize"):
        ps = build_points(seqs, k, dev, mesh)
    bits = int(np.dtype(H.storage_dtype(ps.largest)).itemsize * 8)
    log(f"Using {bits} bit histograms")

    aligner = DeviceAligner(ps.codes, dev, match=cfg.match,
                            mismatch=cfg.mismatch, go=cfg.gap_open,
                            gc=cfg.gap_continue)
    trainer = Trainer(
        ps, n_points=cfg.sample_size, cutoff=cfg.similarity,
        max_pts_from_one=cfg.pivots, k=0 if cfg.align else k)
    if (cfg.match, cfg.mismatch, cfg.gap_open, cfg.gap_continue) \
            == (1, -1, 2, 1):
        trainer._dev_aligner = aligner   # share its staged codes
    tk = 0 if cfg.align else k
    model = None
    if cfg.checkpoint:
        model = ckpt.load_model(cfg.checkpoint + ".model.json", ps, tk,
                                cfg.similarity, cfg.seed, cfg)
        if model is not None:
            log("Resumed trained classifier from checkpoint")
        barrier()
    if model is None:
        with perf.phase("train"):
            model = trainer.train(cfg.acc_cutoff)
        if cfg.checkpoint and writer:
            ckpt.save_model(cfg.checkpoint + ".model.json", model, ps,
                            cfg.seed, cfg)

    def align_fn(center: int, idxs: np.ndarray) -> np.ndarray:
        # (candidate, center) orientation — GlobAlignE identity depends on
        # operand order via gap tie-breaks; the reference's classify sites
        # put the center SECOND (Trainer.cpp:88,:150,:341)
        return aligner.identities([(int(j), center) for j in idxs])

    backend = C.make_backend(ps, model.params, align_fn=align_fn,
                             exact=cfg.exact, mesh=mesh, aligner=aligner)

    bv = BVec(ps.lengths.copy(), cfg.bin_size)
    bv.bulk_insert(ps.lengths)
    bv.insert_finalize()

    ms = MeanShift(ps, backend, sim=cfg.similarity, delta=cfg.delta,
                   iterations=cfg.iterations)
    resume = None
    on_acc = None
    if cfg.checkpoint:
        cpath = cfg.checkpoint + ".centers.json"
        mpath = cfg.checkpoint + ".memo.json"
        key = (ps, tk, cfg.similarity, cfg.seed, cfg)
        resume = ckpt.load_centers(cpath, *key)
        # align mode: Phase B reads Phase A's identities (utils/align_memo)
        if cfg.align and resume is not None \
                and not align_memo.load_memo(mpath, backend, *key):
            resume = None
        barrier()

        def on_acc(cs):
            if not writer:
                return
            if cfg.align:
                align_memo.save_memo(mpath, backend, *key)
            ckpt.save_centers(cpath, cs, *key)
    with perf.phase("cluster"):
        centers = ms.run(bv, resume_centers=resume, on_accumulated=on_acc)

    log("Printing output")
    with perf.phase("output"):
        if writer:
            write_clstr(cfg.output, centers, ps.headers, ps.lengths)
        barrier()
    if os.environ.get("MESHCLUST_PERF", "0") == "1":
        print(perf_report(), file=sys.stderr, flush=True)
    return {
        "centers": centers,
        "pointset": ps,
        "model": model,
        "k": k,
        "backend": backend,
        "n_clusters": sum(1 for c in centers if c.members),
    }

#!/usr/bin/env python3
"""Profile of the PyTorch/CUDA port (meshclust_tpu_torch) on one GPU.

Run from the repository root, after chip_smoke.py has passed:
    python3 profile_port.py [--parts throughput,busy,variants,compare,e2e,
                                     feat,kvariants,sass,phase_a,cluster,
                                     phase_b,pbvariants,walls,ranks]
                            [--ranks 2,4] [--sizes 15000,150000,1000000]
                            [--against OLD.cu ...] [--variants "R,T,K ..."]
                            [--parent DIR] [--parent-tree DIR]
                            [--kmer-variants "SPEC ..."]

Parts (default: throughput,busy):
  throughput  the NW kernel's time, throughput (DP cells per second) and
              share of its bound against the number of pairs in one launch,
              by CUDA events, on pairs of ~1 kb (the k-mer path's) and of
              9-12 kb (the genome path's), sorted by l1 + l2 as
              DeviceAligner sorts them. The bound is chip_smoke.py's
              nw_bound: NW_ALU_OPS_PER_CELL compares and selects a cell at
              INT32_OPS_PER_S (the ALU pipe), or NW_OPS_PER_CELL operations
              at DISPATCH_OPS_PER_S, whichever takes longer.
  busy        the device busy share of two whole runs, each after a warm-up
              run of the same configuration: the smoke's k-mer path (15k x
              1 kb, --id 0.90, default flags) and its genome align-mode path
              (300 genomes of 9-12 kb, --id 0.50). Device self time from
              torch.profiler over the run's host wall time, followed by the
              profiler's table of the busiest device ops.
  variants    csrc/nw_align_long.cu built side by side with other shapes:
              for each "R,T,K" of --variants a copy under build/variants/
              with its constants kR, kT and kK set so, each timed at the
              SHAPES below and held bit-equal to the default build; prints
              each build's registers.
  compare     other NW sources (--against, e.g. an earlier commit's
              csrc/nw_align_long.cu) built beside this one and timed in
              turns (others, this, this, others reversed) at the SHAPES
              below, held bit-equal to each other.
  e2e         both main paths of the busy part run end to end in turns
              (first --against source, this, this, that source): align
              phase and wall of each run, and whether the CLSTR files of
              the two kernels are byte-equal.
  feat        featurization of an earlier kmer_hist (--parent DIR holding
              its csrc/kmer_hist.cu and ops/histogram.py, e.g. from
              `git show HEAD~1:...`) against this tree's, in turns (parent,
              this, this, parent) at chip_smoke.py's kmer_shapes (15k reads
              at k = 4, 300 genomes at k = 6, 150k reads at k = 4): the
              host time of building each one's device inputs, the device
              time of its featurization with the L2 flushed (launches,
              index-puts, maximum, narrowing), its kmer_hist launches and
              equal histograms; then the featurize phase and wall of both
              main paths on each, with a CLSTR check.
  kvariants   kmer_hist built with other constants, with probes that each
              remove one cost (@atomic: atomicAdd for red.shared; @noatom:
              no bin updates; @loadonly: no ids or counts), or from other
              sources (file:PATH), per --kmer-variants, timed in turns at
              the same three shapes beside the card's floor there (a fill
              of the rows, a copy of the codes).
  sass        opcode counts of nw_align_long_kernel, the kmer_hist
              kernels, pa_absorb and pa_sums (int8 rows) in each library
              built by the run (cuobjdump -sass).
  cluster     k-mer-mode clustering on the device (DeviceBackend, Phase A
              through csrc/phase_a.cu, the fused Phase B) at --id 0.90 on
              bench.py:make_dataset's corpus at each read count of --sizes
              (the first after a warm-up run): one run's wall, phases,
              counters, NMI against the planted species and CLSTR digest
              (ms per absorb iteration and per Phase B iteration from its
              phase times); at every size, on that run's points and
              model, each Phase A kernel's device ms a launch under the
              profiler (first PROFILE_CENTERS centers), its launches in
              the run, its bound (chip_smoke.py:phase_a_traffic over the
              same centers) and its loss, launches x (ms - bound); and one
              whole Phase A with an iteration's host wall split into the
              set-up, the graph's capture, the replays' launches, the
              readbacks' wait and the rest. Up to 150k reads also: the
              busy share of a profiled run; Phase A alone on that run's points and model
              through the kernels and through the plain steps, unprofiled
              in turns (plain, kernels, kernels, plain) and then each under
              the profiler (wall, device time, busy share, kernel launches,
              host-device copies, wall and device ms per iteration); the
              fused Phase B alone under the profiler. Larger corpora (the
              1M row) run once.
  phase_a     csrc/phase_a.cu of an earlier commit (--parent DIR holding
              its phase_a.cu, e.g. `git show HEAD~1:meshclust_tpu_torch/
              csrc/phase_a.cu > build/parent/phase_a.cu`, and its
              csrc/common.cuh where it includes one) built beside this
              tree's, in turns (parent, this, this, parent): pa_sums on
              chip_smoke.py's 1M x 256 int8 rows and on a column slice at
              an odd byte with the L2 flushed; then for each corpus of
              --sizes, on each build: pa_absorb's ms a launch by window (no
              slot, one, every slot; up to 150k reads), each Phase A
              kernel's device ms a launch, bound and share as in the
              cluster part, and the host split of an iteration; then the
              run end to end in turns (wall, accumulate, NMI) with its
              CLSTR byte-equal across the turns. The parent must have
              pa_next (the loop's control on the card); an older one
              takes the center and the stamp from a host loop that this
              tree no longer runs, and the part stops.
  phase_b     the fused Phase B (csrc/phase_b.cu) at each read count of
              --sizes, on Phase A's centers of one run's points and model:
              phase_b_loop through the kernels and through the plain steps
              (the torch ops of the parent commit, moved), unprofiled in
              turns (plain, kernels, kernels, plain), with the outputs
              equal across the turns; launches an iteration; wall and
              device ms an iteration under the profiler; each kernel's
              device ms a launch beside its plain step's, its bound
              (chip_smoke.py:phase_b_lockstep's traffic from the same
              run's data), share and loss over a run, launches x (ms -
              bound); the tiles pb_band and pb_dist ran on each path;
              pb_band's yardstick (one index_add_ of its positive rows)
              and pb_pick's (one scatter_reduce_ of its ties' positions);
              then the same centers each split in two
              (chip_smoke.split_centers, which merge): the loop against
              the plain steps', each kernel's device ms, pb_merge's at
              each iteration and its mean against the unsplit input's.
  pbvariants  the four Phase B kernels of an earlier csrc/phase_b.cu
              (--parent DIR holding it and its common.cuh, e.g. from `git
              show HEAD~1:...`) beside this tree's, at each read count of
              --sizes on Phase A's centers of one run: each build's device
              ms a launch over iterations of band, dist, pick and merge on
              one State (CUDA events around each launch, all queued behind
              a sleeping kernel), in turns (the earlier one, this, this,
              the earlier one), their outputs equal; then the earlier
              pb_pick and pb_merge alone, repeated on a State after one
              real iteration, beside probes built under build/pbvariants/
              that each remove one cost and keep the outputs
              (@pick-nozero: no zeroing of sc; @pick-nodstore: the ties
              read back from the last launch's best_pos, no dstore read;
              @merge-notail: no last-block tail; @merge-staged: phase 1's
              moved centers read with one load from the last launch's
              scratch, no chain); this tree's probes and constants
              (PB_THIS_VARIANTS) are timed in the turns, and
              @this-merge-stamps' clock64 stamps split pb_merge by phase
              (merge_phases).
  walls       whole k-mer runs (--id 0.90) at each read count of --sizes
              against an earlier commit's tree (--parent-tree DIR, e.g.
              `git archive HEAD~1 | tar -x -C build/parent_tree`), in
              turns (parent, this, this, parent, twice), each a child
              process in its tree's root that warms up on the 15k corpus
              first: wall, phases, NMI against the planted species and
              CLSTR digest (equal across the turns); then each tree's
              least, median and greatest wall and phase.
  ranks       several ranks (parallel/dist), for each n of --ranks: n
              ranks (gloo where they share a card, NCCL where each has its
              own) time each collective at the 15k k-mer run's shapes (a
              Phase B iteration's sums, minimum and positions) and the
              gather of
              the featurized rows at 15k and, over NCCL, 1M reads in two
              forms (the port's SUM into zeros and, over NCCL, an
              all-gather of padded blocks), host
              clock around a call that ends in a sync, median of 20 after 3
              warm-ups; then the smoke's 15k-read run (--id 0.90) at one
              rank in this process and at n ranks, in turns (1, n, n, 1):
              walls, each rank's phases and collectives, and the CLSTR
              against the single rank's.
Every line starts with the card's name and power limit or follows one that
does, so each number can be kept beside the card it came from.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import chip_smoke as smoke

# (label, shortest and longest sequence, pairs per launch)
NW_SHAPES = (("~1 kb", 900, 1100, (128, 2048, 16384)),
             ("9-12 kb", 9000, 12000, (1, 64, 163, 300, 1024)))
# (label, pairs) for variants and compare: the k-mer path's launch, the
# genome path's launch, a full launch of genomes, one genome (latency)
SHAPES = (("2,048 x 700-1,300 bp", 2048, 700, 1300),
          ("163 x 9-12 kb", 163, 9000, 12000),
          ("1,024 x 9-12 kb", 1024, 9000, 12000),
          ("1 x 10.5 kb", 1, 10500, 10500))
BUILT: dict = {}    # {name: library path} of the builds of this run
# the cluster part profiles corpora up to this size; larger ones run once
FULL_CLUSTER_READS = 150000


def sorted_pairs(rng, n: int, lo: int, hi: int) -> list:
    return sorted(((int(rng.integers(lo, hi + 1)),
                    int(rng.integers(lo, hi + 1))) for _ in range(n)),
                  key=sum)


def nw_line(label: str, pairs, ms: float) -> str:
    cells = float(sum(a * b for a, b in pairs))
    b = smoke.nw_bound(pairs)
    return (f"{label}: {ms:.3f} ms, {cells / ms / 1e6:.4f} Gcells/s, "
            f"bound {b['bound_ms']:.3f} ms ({b['bound_by']}), share of "
            f"bound {b['bound_ms'] / ms:.4f}")


def nw_throughput(dev) -> None:
    from meshclust_tpu_torch.ops.align_device import nw_align_long
    rng = np.random.default_rng(1)
    for label, lo, hi, counts in NW_SHAPES:
        for P in counts:
            pairs = sorted_pairs(rng, P, lo, hi)
            codes, lens, ia, ib = smoke.pair_corpus(pairs, 2, dev,
                                                    set(range(0, P, 2)))
            ms = smoke.cuda_ms(
                lambda: nw_align_long(codes, lens, ia, ib, hi), reps=2)
            print("  " + nw_line(f"nw_align_long {label} pairs={P}", pairs,
                                 ms), flush=True)


def busy_share(dev, label: str, fasta: str, warm: bool = True,
               **cfg) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.runner import run
    from meshclust_tpu_torch.utils import perf
    if warm:
        run(ClusterConfig(files=[fasta], output=os.path.join(
            smoke.WORK, "warm.clstr"), **cfg), device=dev)
    perf.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(ClusterConfig(files=[fasta], output=os.path.join(
            smoke.WORK, "prof.clstr"), **cfg), device=dev)
        torch.cuda.synchronize()
    wall = time.time() - t0
    ka = prof.key_averages()
    dev_s = device_seconds(ka)
    print(f"  {label} profiled wall {wall:.3f} s, device self time "
          f"{dev_s:.4f} s, busy share {dev_s / wall:.4f}", flush=True)
    print(f"  phases {json.dumps(perf.phases())}", flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=12),
          flush=True)


def device_seconds(ka) -> float:
    """Device time of a profile's key_averages: the device's own events
    (kernels, copies) only. The host ops that launched them carry the same
    time as their self device time, so summing every event counts it
    twice (as the profiler's table does not)."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in ka
               if e.device_type == DeviceType.CUDA) / 1e6


# host-side events of torch.profiler that launch a kernel or copy memory
LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")
COPY_EVENTS = ("cudaMemcpyAsync", "cudaMemcpy")


def profiled(fn):
    """(fn(), wall s, device self s, kernel launches, memory copies) of one
    call of fn under torch.profiler, ending in a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    ka = prof.key_averages()
    return (out, wall, device_seconds(ka),
            sum(e.count for e in ka if e.key in LAUNCH_EVENTS),
            sum(e.count for e in ka if e.key in COPY_EVENTS))


def piece_line(label: str, wall: float, dev_s: float, launches: int,
               copies: int, iters: float) -> str:
    return (f"{label}: wall {wall:.4f} s, device {dev_s:.4f} s, busy share "
            f"{dev_s / wall:.4f}; {iters:.0f} iterations: {launches} "
            f"launches ({launches / iters:.1f} an iteration), {copies} "
            f"copies, wall {wall * 1e3 / iters:.4f} ms and device "
            f"{dev_s * 1e3 / iters:.4f} ms an iteration")


def phase_a_kernels(ps, bv, params, counters: dict,
                    traffic: tuple = None) -> None:
    """Each Phase A kernel's device ms a launch under the profiler over the
    first PROFILE_CENTERS centers, its launches on the card in a whole run
    (counters: the run's; each kernel of the chain CHUNK a replay and once
    before the capture), its bound (chip_smoke.py:phase_a_traffic over
    the same centers, unless given), the share of it, and the run's loss:
    launches x (ms - bound)."""
    from meshclust_tpu_torch.core.accumulate_device import CHUNK
    launches = dict.fromkeys(
        smoke.PHASE_A, int(counters["accum_replays"]) * CHUNK + 1)
    ms, dev_ms = smoke.phase_a_device_ms(ps, bv, params, False,
                                         smoke.PROFILE_CENTERS)
    per_launch, ops_s = (traffic or smoke.phase_a_traffic(
        ps, bv, params, smoke.PROFILE_CENTERS))[:2]
    print(f"    Phase A kernels, first {smoke.PROFILE_CENTERS} centers under "
          f"the profiler: device {dev_ms:.5f} ms an iteration", flush=True)
    for k in smoke.PHASE_A:
        b = smoke.bound(per_launch[k], ops_s[k])
        print(f"      {k}: {ms[k]:.5f} ms a launch, {launches[k]} launches "
              f"in the run, bound {b['bound_ms']:.6g} ms ({b['bound_by']}, "
              f"{per_launch[k]:.0f} B a launch), share "
              f"{b['bound_ms'] / ms[k] if ms[k] else 0.0:.4g}, loss "
              f"{launches[k] * (ms[k] - b['bound_ms']) / 1e3:.4f} s",
              flush=True)


def host_split(ps, bv, params, sim: float) -> None:
    """One whole Phase A through the kernels with its host wall split, an
    iteration: the set-up (_Slots: the buffers, the steps bound and their
    checks made), the capture of the chunk's CUDA graph (the kernels
    launched once before it included), the replays' launches, the readbacks
    (st[DONE: MEMBERS + 1].tolist() once a replay, which waits for the
    device) and the rest (the final read and the grouping of the members).
    Each piece on perf_counter."""
    import torch
    from meshclust_tpu_torch.core import accumulate_device as A
    from meshclust_tpu_torch.core.accumulate_device import accumulate_device
    from meshclust_tpu_torch.utils import perf
    spent = {"set-up": 0.0, "capture": 0.0, "replays": 0.0, "readback": 0.0}

    def timed(key, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t0
        return call

    saved = {name: getattr(A._Slots, name)
             for name in ("__init__", "graph", "readback")}
    A._Slots.__init__ = timed("set-up", saved["__init__"])
    A._Slots.graph = lambda self: timed("replays", timed(
        "capture", saved["graph"])(self))
    A._Slots.readback = timed("readback", saved["readback"])
    perf.reset()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accumulate_device(ps, bv, params, sim, plain=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(A._Slots, name, fn)
    c = perf.counters()
    iters = c["accum_iters"]
    rest = wall - sum(spent.values())
    print(f"    host split of an iteration ({iters:.0f} iterations in "
          f"{c['accum_replays']:.0f} replays of {A.CHUNK}, whole phase "
          f"through the kernels): wall {wall * 1e3 / iters:.5f} ms = "
          + " + ".join(f"{k} {v * 1e3 / iters:.5f}"
                       for k, v in spent.items())
          + f" + rest {rest * 1e3 / iters:.5f}", flush=True)


def cluster(dev, n: int, warm: bool, full: bool) -> None:
    """The k-mer path's clustering on the device on bench_corpus(n) at
    --id 0.90 (see the cluster part in the module docstring); without
    `full` only the one run, its phases, counters and NMI."""
    import torch
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.accumulate_device import accumulate_device
    from meshclust_tpu_torch.core.bvec import BVec
    from meshclust_tpu_torch.core.runner import run
    from meshclust_tpu_torch.utils import perf
    label = f"k-mer path --id 0.90, {n} reads"
    fasta = smoke.bench_corpus(n=n)
    out = os.path.join(smoke.WORK, f"cluster_{n}.clstr")
    cfg = ClusterConfig(files=[fasta], output=out,
                        similarity=0.90).finalize()
    if warm:
        run(cfg, device=dev)
    perf.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    res = run(cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    phases, counters = perf.phases(), perf.counters()
    ps = res["pointset"]
    with open(out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    print(f"  {label}: {ps.n} sequences, {res['n_clusters']} clusters, "
          f"backend {type(res['backend']).__name__}, wall {wall:.3f} s, "
          f"NMI vs species {smoke.species_nmi(out):.6f}, CLSTR sha256 "
          f"{digest}", flush=True)
    print(f"    phases {json.dumps(phases)}", flush=True)
    print(f"    counters {json.dumps(counters)}", flush=True)
    iters = counters.get("accum_iters", 0.0)
    print(f"    ms per absorb iteration (accumulate phase / accum_iters): "
          f"{phases.get('accumulate', 0.0) * 1e3 / max(iters, 1):.4f}; ms "
          f"per Phase B iteration (phase_b phase / {cfg.iterations}): "
          f"{phases.get('phase_b', 0.0) * 1e3 / cfg.iterations:.4f}",
          flush=True)
    # Phase A alone on this run's points and model
    bv = BVec(ps.lengths.copy(), cfg.bin_size)
    bv.bulk_insert(ps.lengths)
    bv.insert_finalize()
    params = res["model"].params
    phase_a_kernels(ps, bv, params, counters)
    host_split(ps, bv, params, cfg.similarity)
    if not full:
        return
    busy_share(dev, label, fasta, warm=False, similarity=cfg.similarity)
    # Phase A (kernels, then plain) and the fused Phase B alone
    walls = {True: [], False: []}
    for plain in (True, False, False, True):
        perf.reset()
        torch.cuda.synchronize()
        t0 = time.time()
        accumulate_device(ps, bv, params, cfg.similarity, plain=plain)
        torch.cuda.synchronize()
        walls[plain].append(time.time() - t0)
    for plain, name in ((False, "kernels"), (True, "plain")):
        print(f"    Phase A alone ({name}), unprofiled walls (in turns: "
              f"plain, kernels, kernels, plain): "
              + ", ".join(f"{w:.4f} s ({w * 1e3 / iters:.4f} ms an "
                          f"iteration)" for w in walls[plain]), flush=True)
        perf.reset()
        centers, wall, dev_s, launches, copies = profiled(
            lambda: accumulate_device(ps, bv, params, cfg.similarity,
                                      plain=plain))
        print("    " + piece_line(f"Phase A alone ({name})", wall, dev_s,
                                  launches, copies,
                                  perf.counters()["accum_iters"]),
              flush=True)
    members = np.asarray([m for c in centers for m in c.members], np.int64)
    assign = np.repeat(np.arange(len(centers)),
                       [len(c.members) for c in centers])
    rows = np.asarray([c.center for c in centers], np.int64)
    _, wall, dev_s, launches, copies = profiled(
        lambda: res["backend"].phase_b_loop(members, assign, rows, cfg.delta,
                                            cfg.iterations))
    print("    " + piece_line(f"fused Phase B alone ({len(centers)} centers, "
                              f"{members.shape[0]} members)", wall, dev_s,
                              launches, copies, cfg.iterations), flush=True)


PB_SETUP: dict = {}


def phase_b_setup(dev, n: int) -> tuple:
    """(points, bvec, model params, backend, members, assign, center rows)
    of one k-mer run at n reads (--id 0.90): Phase A's centers as
    run_phase_b_device hands them to phase_b_loop; kept for the other
    parts of this run."""
    if n not in PB_SETUP:
        from meshclust_tpu_torch.config import ClusterConfig
        from meshclust_tpu_torch.core.bvec import BVec
        from meshclust_tpu_torch.core.runner import run
        cfg = ClusterConfig(files=[smoke.bench_corpus(n=n)],
                            output=os.path.join(smoke.WORK, f"pb_{n}.clstr"),
                            similarity=0.90).finalize()
        res = run(cfg, device=dev)
        ps, params = res["pointset"], res["model"].params
        bv = BVec(ps.lengths.copy(), cfg.bin_size)
        bv.bulk_insert(ps.lengths)
        bv.insert_finalize()
        PB_SETUP.clear()
        PB_SETUP[n] = (ps, bv, params,
                       *smoke.phase_b_inputs(ps, bv, params))
    return PB_SETUP[n]


def phase_b_part(dev, n: int) -> None:
    """The phase_b part at n reads (see the module docstring)."""
    import torch
    from meshclust_tpu_torch import _ext
    from meshclust_tpu_torch.ops import phase_b as PB
    ps, bv, params, be, members, assign, rows = phase_b_setup(dev, n)
    it = smoke.PB_ITERS
    print(f"  {n} reads: {members.shape[0]} members, {rows.shape[0]} "
          f"centers, --delta {smoke.PB_DELTA}, {it} iterations, "
          f"{ps.hist_dev.dtype} rows, V = {ps.V}", flush=True)
    walls, outs = {True: [], False: []}, []
    for plain in (True, False, False, True):
        _ext.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        outs.append(be.phase_b_loop(members, assign, rows, smoke.PB_DELTA,
                                    it, plain=plain))
        torch.cuda.synchronize()
        walls[plain].append(time.time() - t0)
        if not plain:
            launched = sum(_ext.launches[k] for k in smoke.PHASE_B)
    same = all(np.array_equal(a, b) for o in outs[1:]
               for a, b in zip(o, outs[0]))
    print(f"    phase_b_loop unprofiled, in turns (plain, kernels, kernels, "
          f"plain), ms an iteration: kernels "
          + ", ".join(f"{w * 1e3 / it:.4f}" for w in walls[False])
          + "; plain " + ", ".join(f"{w * 1e3 / it:.4f}"
                                   for w in walls[True])
          + f"; outputs equal across the turns {same}; kernel launches "
          f"{launched / it:.2f} an iteration", flush=True)
    for plain, name in ((False, "kernels"), (True, "plain steps")):
        _, wall, dev_s, launches, copies = profiled(
            lambda: be.phase_b_loop(members, assign, rows, smoke.PB_DELTA,
                                    it, plain=plain))
        print("    " + piece_line(f"Phase B ({name}) under the profiler",
                                  wall, dev_s, launches, copies, it),
              flush=True)
    ms, dev_ms = smoke.phase_b_device_ms(ps, bv, params, False)
    plain_ms, plain_dev_ms = smoke.phase_b_device_ms(ps, bv, params, True)
    err, per_launch, ops_s, paths = smoke.phase_b_lockstep(
        be, members, assign, rows)
    pb = be._phase_b_state(members, assign, rows, smoke.PB_DELTA, 0)
    PB.band(pb)
    band_lib = smoke.band_yardstick(pb)
    PB.dist(pb)
    pick_lib = smoke.pick_yardstick(pb)
    del pb
    print(f"    device ms an iteration: kernels {dev_ms:.5f}, plain steps "
          f"{plain_dev_ms:.5f}; tiles over the {it} iterations by path "
          f"{paths}; library calls, warm: pb_band's sums as one index_add_ "
          f"{band_lib:.5f} ms, pb_pick's as one scatter_reduce_ "
          f"{pick_lib:.5f} ms", flush=True)
    for k in smoke.PHASE_B:
        b = smoke.bound(per_launch[k], ops_s[k])
        print(f"      {k}: {ms[k]:.5f} ms a launch (plain step "
              f"{plain_ms[k]:.5f}), {it} launches a run, bound "
              f"{b['bound_ms']:.6g} ms ({b['bound_by']}, "
              f"{per_launch[k]:.0f} B a launch), share "
              f"{b['bound_ms'] / ms[k] if ms[k] else 0.0:.4g}, loss "
              f"{it * (ms[k] - b['bound_ms']) / 1e3:.6f} s, max abs err "
              f"{err[k]}", flush=True)
    # the merging input: the same centers, each split in two
    members, assign, rows = smoke.split_centers(members, assign, rows)
    outs = [be.phase_b_loop(members, assign, rows, smoke.PB_DELTA, it,
                            plain=plain) for plain in (False, True)]
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    merged = int((outs[0][3] != np.arange(rows.shape[0])).sum())
    split_ms, split_dev_ms = smoke.phase_b_device_ms(ps, bv, params, False,
                                                     split=True)
    each = merge_launch_ms(be, members, assign, rows)
    print(f"    centers split in two (chip_smoke.split_centers): "
          f"{rows.shape[0]} centers, {merged} merge targets over the "
          f"iterations, {int(outs[0][2].sum())} kept; the kernels' loop "
          f"equal to the plain steps' {same}; device ms an iteration "
          f"{split_dev_ms:.5f}; ms a launch: "
          + ", ".join(f"{k} {split_ms[k]:.5f}" for k in smoke.PHASE_B)
          + "; pb_merge by iteration: "
          + ", ".join(f"{x:.5f}" for x in each)
          + f"; pb_merge's mean over the unsplit centers' "
          f"{split_ms['pb_merge'] / ms['pb_merge']:.4f}", flush=True)


def merge_launch_ms(be, members, assign, rows) -> list:
    """pb_merge's device ms at each iteration of one phase_b_loop, in
    order, under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        be.phase_b_loop(members, assign, rows, smoke.PB_DELTA,
                        smoke.PB_ITERS)
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "pb_merge_kernel" in e.name),
                 key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() / 1e3 for e in evs]


# Probes of the earlier csrc/phase_b.cu (in --parent; they fit a pb_pick
# that zeroes all of sc in a grid stride beside the ties and a pb_merge
# whose last block does every C-sized step) for --parts pbvariants:
# each removes one cost and keeps the bits of a launch repeated on one
# State (after one real iteration: see pbvariants).
PB_PROBES = {
    # pb_pick: no zeroing of sc (repeated, sc is already zero)
    "@pick-nozero": [(
        "  for (i64 e = gid; e < sc_len; e += stride) sc[e] = 0;",
        "  for (i64 e = gid; e < 0 * sc_len; e += stride) sc[e] = 0;")],
    # pb_pick: no read of dstore, the ties read back from the last launch's
    # best_pos (its winners)
    "@pick-nodstore": [(
        "      if (dstore[gid * K + oi] == best_d[jc])",
        "      if (best_pos[jc] == goff + gid)")],
    # pb_merge: no tail (the last block returns at its ticket)
    "@merge-notail": [(
        "  if (!last_block(scr + kTicket, gridDim.x)) return;",
        "  if (!last_block(scr + kTicket, gridDim.x) || C > 0) return;")],
    # pb_merge: phase 1's moved centers read with one load each, from the
    # last launch's c_new in the scratch, in place of the chain c_valid,
    # best_pos, m_all (or c_idx)
    "@merge-staged": [
        ("  const i64 ci =\n"
         "      have ? moved(i, best_pos, m_all, M_all, c_idx, c_valid) : 0;",
         "  const i64 ci = have ? __ldcg(scr + kScratchHead + i) : 0;"),
        ("    const i64 cj = ok ? moved(j, best_pos, m_all, M_all, c_idx, "
         "c_valid) : 0;",
         "    const i64 cj = ok ? __ldcg(scr + kScratchHead + j) : 0;")],
}
# Probes and constants of this tree's phase_b.cu ("@this-", NAME=VALUE),
# timed over whole iterations (a probe's outputs may differ)
PB_PROBES.update({
    # pb_pick: the zero blocks read the counts and store nothing
    "@this-pick-nostores": [(
        "      if (__shfl_sync(0xffffffffu, count, 0) == 0) continue;",
        "      if (__shfl_sync(0xffffffffu, count, 0) == 0 || C > 0) "
        "continue;")],
    # pb_pick: the tie blocks return at once
    "@this-pick-noties": [(
        "  if (m >= M) return;\n  const i64 a = assign[m];",
        "  if (m >= M || M > 0) return;\n  const i64 a = assign[m];")],
    # pb_merge: no classifier (no candidate positive)
    "@this-merge-noclassify": [(
        "    if (my_c >= 0) {\n      double f1;",
        "    if (my_c >= 0 && C < 0) {\n      double f1;")],
    # pb_merge at 3 blocks an SM (its registers capped at 85): the 313
    # tiles of 20,000 split centers on the card at once
    "@this-merge-3blocks": [(
        "__global__ void __launch_bounds__(kThreads)\npb_merge_kernel(",
        "__global__ void __launch_bounds__(kThreads, 3)\npb_merge_kernel(")],
    # pb_merge with each block's clock64 at the ends of its phases (STAMPS),
    # its globaltimer at entry and exit, and whether it ran the last block's
    # tail, read back by mc_pb_merge_stamps (merge_stamps)
    "@this-merge-stamps": [
        ("template <typename T, int VEC, int LANES>\n"
         "__global__ void __launch_bounds__(kThreads)\npb_merge_kernel(",
         "constexpr int kStampBlocks = %d, kStamps = %d;\n"
         "__device__ long long merge_stamps[kStampBlocks * kStamps];\n"
         "__device__ __forceinline__ long long gtimer() {\n"
         "  long long g;\n"
         "  asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(g));\n"
         "  return g;\n}\n"
         "#define STAMP(s, v) if (threadIdx.x == 0 && tile < kStampBlocks) "
         "merge_stamps[tile * kStamps + (s)] = (v)\n"
         "template <typename T, int VEC, int LANES>\n"
         "__global__ void __launch_bounds__(kThreads)\npb_merge_kernel("
         % (4096, 12)),
        ("  const int sub = lane & (LANES - 1), grp = lane / LANES;\n",
         "  const int sub = lane & (LANES - 1), grp = lane / LANES;\n"
         "  const long long c0 = clock64(), g0 = gtimer();\n"),
        ("  const i64 tile = tile_s, base = tile * per;\n",
         "  const i64 tile = tile_s, base = tile * per;\n"
         "  STAMP(0, c0); STAMP(9, g0); STAMP(1, clock64());\n"),
        ("\n  const int li = warp * (32 / LANES) + grp;",
         "\n  STAMP(2, clock64());\n  const int li = warp * (32 / LANES) + grp;"),
        ("  // phase 2, a thread an own slot",
         "  STAMP(3, clock64());\n  // phase 2, a thread an own slot"),
        ("  if (tid == 0 && tile > 0)\n    atomicExch(",
         "  STAMP(4, clock64());\n  if (tid == 0 && tile > 0)\n    atomicExch("),
        ("  const u64 excl = look_back(desc, tile);\n",
         "  const u64 excl = look_back(desc, tile);\n  STAMP(5, clock64());\n"),
        ("  if (!last_block(scr + kTicket, gridDim.x)) return;",
         "  STAMP(6, clock64());\n"
         "  const bool last = last_block(scr + kTicket, gridDim.x);\n"
         "  STAMP(7, clock64()); STAMP(11, last ? 1 : 0);\n"
         "  if (!last) { STAMP(8, clock64()); STAMP(10, gtimer()); return; }"),
        ("    scr[kTiles] = 0;\n  }\n}",
         "    scr[kTiles] = 0;\n  }\n  __syncthreads();\n"
         "  STAMP(8, clock64()); STAMP(10, gtimer());\n}"),
        ("static int tiles(int n) {",
         "extern \"C\" int mc_pb_merge_stamps(void* out) {\n"
         "  void* p = nullptr;\n"
         "  cudaGetSymbolAddress(&p, merge_stamps);\n"
         "  cudaMemcpy(out, p, sizeof(merge_stamps), cudaMemcpyDeviceToHost);\n"
         "  cudaMemset(p, 0, sizeof(merge_stamps));\n"
         "  return cudaGetLastError();\n}\n\n"
         "static int tiles(int n) {")],
})
# the blocks and slots of @this-merge-stamps' merge_stamps, and the phases
# between its slots 0-8 (a block's thread 0 after the block's barrier)
STAMP_BLOCKS, STAMP_SLOTS = 4096, 12
STAMPS = ("the ticket and the model", "staging the slots",
          "the rows and the classifier", "the scan", "the look-back",
          "NP, remap and the compaction", "the last block's ticket",
          "the tail")
PB_VARIANTS = ("@pick-nozero", "@pick-nodstore", "@merge-notail",
               "@merge-staged")
PB_THIS_VARIANTS = ("@this-pick-nostores", "@this-pick-noties",
                    "@this-merge-noclassify", "kMergeLanesLarge=4",
                    "@this-merge-3blocks", "@this-merge-stamps")


def pb_variant_source(parent_dir: str, spec: str) -> str:
    """A copy of parent_dir's phase_b.cu (or, for "@this-" probes and
    NAME=VALUE constants, this tree's) and its common.cuh under
    build/pbvariants/ with the edits of spec applied; returns its path."""
    from meshclust_tpu_torch import _ext
    src_dir = _ext.CSRC if spec in PB_THIS_VARIANTS else parent_dir
    with open(os.path.join(src_dir, "phase_b.cu")) as f:
        src = f.read()
    for item in spec.split(","):
        if "=" in item:
            name, value = item.split("=")
            src, n = re.subn(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {int(value)};", src)
            if n != 1:
                smoke.fail(f"phase_b.cu: no constant {name}")
            continue
        for old, new in PB_PROBES[item]:
            if src.count(old) != 1:
                smoke.fail(f"phase_b.cu: probe {item} does not apply")
            src = src.replace(old, new)
    out = os.path.join(os.path.dirname(_ext.BUILD_DIR), "pbvariants",
                       re.sub(r"[^A-Za-z0-9]+", "_", spec), "phase_b.cu")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(src)
    with open(os.path.join(src_dir, "common.cuh")) as f, \
            open(os.path.join(os.path.dirname(out), "common.cuh"), "w") as g:
        g.write(f.read())
    return out


# the parent's mc_pb_pick: sc's length in place of C and V
PARENT_PICK_SIGNATURE = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + \
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p,
                             ctypes.c_longlong, ctypes.c_void_p]


class ParentPhaseB:
    """A kernel library whose mc_pb_pick takes sc's length (the earlier
    signature), called with this tree's arguments (C and V)."""

    def __init__(self, handle):
        self.handle = handle
        handle.mc_pb_pick.argtypes = PARENT_PICK_SIGNATURE
        handle.mc_pb_pick.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.handle, name)

    def mc_pb_pick(self, *a):
        C, V = a[9], a[10]
        return self.handle.mc_pb_pick(*a[:9], C * (V + 1), a[11])


def kernel_ms(calls, reps: int) -> dict:
    """{name: device ms a launch} of each (name, fn) of calls, each fn one
    launch: the calls run in order reps times behind a kernel that sleeps
    while the host enqueues them all, so that no launch waits on the host,
    and CUDA events between them time each on the card."""
    import torch
    for _, fn in calls:
        fn()
    torch.cuda.synchronize()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(len(calls) + 1)]
          for _ in range(reps)]
    torch.cuda._sleep(20_000_000)
    for r in range(reps):
        ev[r][0].record()
        for i, (_, fn) in enumerate(calls):
            fn()
            ev[r][i + 1].record()
    torch.cuda.synchronize()
    return {name: sum(ev[r][i].elapsed_time(ev[r][i + 1])
                      for r in range(reps)) / reps
            for i, (name, _) in enumerate(calls)}


def pb_outputs(pb) -> list:
    return [x.clone() for x in (pb.best_pos, pb.c_idx, pb.c_valid,
                                pb.remap, pb.t_hist[0])]


def pbvariants(dev, parent_dir: str, sizes: list) -> None:
    """The pbvariants part (see the module docstring)."""
    import torch
    from meshclust_tpu_torch import _ext
    from meshclust_tpu_torch.ops import phase_b as PB
    parent_src = os.path.abspath(os.path.join(parent_dir, "phase_b.cu"))
    nw = os.path.join(_ext.CSRC, "nw_align_long.cu")   # mc_error_string
    builds = {"parent": [parent_src, nw],
              "this": [os.path.join(_ext.CSRC, "phase_b.cu"), nw]}
    for spec in PB_VARIANTS + PB_THIS_VARIANTS:
        builds[spec] = [os.path.abspath(pb_variant_source(parent_dir, spec)),
                        nw]
    paths = build_all(builds)
    libs = {name: load_library(path) for name, path in paths.items()}
    for name in libs:
        if name != "this" and name not in PB_THIS_VARIANTS:
            libs[name] = ParentPhaseB(libs[name])
    names = ("pb_band", "pb_dist", "pb_pick", "pb_merge")

    def cycle(pb):
        return [(k, fn) for k, fn in zip(names, (
            lambda: PB.band(pb), lambda: PB.dist(pb),
            lambda: PB.pick(pb), lambda: PB.merge(pb, 0)))]

    def turns(state, order, reps):
        """{build: least ms a launch of each kernel over its turns}."""
        got, want = {}, None
        for name in order:
            pb = state()
            with kernels_from(libs[name]):
                ms = kernel_ms(cycle(pb), reps)
            out = pb_outputs(pb)
            want = want or out
            same = all(torch.equal(a, b) for a, b in zip(out, want))
            got.setdefault(name, []).append(ms)
            print(f"    {name}: " + ", ".join(f"{k} {ms[k]:.5f}"
                                               for k in names)
                  + f"; best_pos, c_idx, c_valid, remap, t_hist equal "
                  f"across the builds {same}", flush=True)
            del pb
        return {k: {m: min(x[m] for x in v) for m in names}
                for k, v in got.items()}

    for n in sizes:
        ps, bv, params, be, members, assign, rows = phase_b_setup(dev, n)
        reps = 20 if n <= 150000 else 10

        def state():
            return be._phase_b_state(members, assign, rows, smoke.PB_DELTA, 1)
        print(f"  {n} reads: {members.shape[0]} members, {rows.shape[0]} "
              f"centers; device ms a launch (CUDA events, launches queued "
              f"behind a sleeping kernel) over {reps} iterations of the four "
              f"kernels on one State, in turns:", flush=True)
        c = turns(state, ("parent", "this", *PB_THIS_VARIANTS, "this",
                          "parent"), reps)
        t = c["this"]
        print(f"  {n} reads, this tree's pb_pick split by its probes (the "
              f"least of each build's turns): whole {t['pb_pick']:.5f} ms; "
              f"the zero blocks' stores "
              f"{t['pb_pick'] - c['@this-pick-nostores']['pb_pick']:.5f}; "
              f"the ties {t['pb_pick'] - c['@this-pick-noties']['pb_pick']:.5f}"
              f"; pb_merge: whole {t['pb_merge']:.5f} ms; the classifier "
              f"{t['pb_merge'] - c['@this-merge-noclassify']['pb_merge']:.5f}"
              f"; the stamps' own cost "
              f"{c['@this-merge-stamps']['pb_merge'] - t['pb_merge']:.5f}",
              flush=True)
        merge_phases(libs["@this-merge-stamps"], state, cycle, reps)
        split = smoke.split_centers(members, assign, rows)

        def split_state():
            return be._phase_b_state(*split, smoke.PB_DELTA, 1)
        print(f"  {n} reads, the centers split in two "
              f"(chip_smoke.split_centers): {split[2].shape[0]} centers, "
              f"the first iteration merging; in turns:", flush=True)
        c = turns(split_state, ("parent", "this", "@this-merge-3blocks",
                                "this", "parent"), reps)
        print(f"  {n} reads, split: pb_merge this {c['this']['pb_merge']:.5f}"
              f" ms, at 3 blocks an SM "
              f"{c['@this-merge-3blocks']['pb_merge']:.5f}, the parent's "
              f"{c['parent']['pb_merge']:.5f}", flush=True)
        merge_phases(libs["@this-merge-stamps"], split_state, cycle, reps)
        # the parent's pick and merge alone, repeated on a State after one
        # real iteration, and its probes
        alone, want = {}, None
        for name in ("parent", *PB_VARIANTS, "parent"):
            pb = state()
            with kernels_from(libs["parent"]):
                for _, fn in cycle(pb):
                    fn()
            with kernels_from(libs[name]):
                ms = kernel_ms(cycle(pb)[2:], reps)
            out = pb_outputs(pb)
            want = want or out
            same = all(torch.equal(a, b) for a, b in zip(out, want))
            alone.setdefault(name, []).append(ms)
            print(f"    alone, {name}: pb_pick {ms['pb_pick']:.5f}, "
                  f"pb_merge {ms['pb_merge']:.5f}; outputs equal {same}",
                  flush=True)
            del pb
        b = {k: {m: min(x[m] for x in v) for m in ("pb_pick", "pb_merge")}
             for k, v in alone.items()}
        p = b["parent"]
        print(f"  {n} reads, the parent's pb_pick alone split by the probes "
              f"(the least of each build's turns): whole "
              f"{p['pb_pick']:.5f} ms; zeroing sc "
              f"{p['pb_pick'] - b['@pick-nozero']['pb_pick']:.5f}; reading "
              f"dstore {p['pb_pick'] - b['@pick-nodstore']['pb_pick']:.5f}; "
              f"pb_merge alone: whole {p['pb_merge']:.5f} ms; the tail "
              f"{p['pb_merge'] - b['@merge-notail']['pb_merge']:.5f}; the "
              f"moves' load chains in phase 1 "
              f"{p['pb_merge'] - b['@merge-staged']['pb_merge']:.5f}",
              flush=True)


def merge_phases(lib, state, cycle, reps: int) -> None:
    """pb_merge's time split by its phases: @this-merge-stamps' build run
    reps iterations on one State, each launch's stamps read back; each
    phase's cycles (the mean over the blocks, the median over the
    launches, and the first launch's), the last block's timeline, and the
    span from the first block's entry to the last one's exit (globaltimer)
    beside the launch's device time (CUDA events, queued behind a sleeping
    kernel)."""
    import torch
    lib.mc_pb_merge_stamps.argtypes = [ctypes.c_void_p]
    lib.mc_pb_merge_stamps.restype = ctypes.c_int
    buf = np.zeros(STAMP_BLOCKS * STAMP_SLOTS, dtype=np.int64)
    pb = state()
    mean, last, spans, event_ms, tiles = [], [], [], [], []
    with kernels_from(lib):
        for _ in range(reps):
            calls = cycle(pb)
            for _, fn in calls[:3]:
                fn()
            torch.cuda.synchronize()
            lib.mc_pb_merge_stamps(buf.ctypes.data)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda._sleep(20_000_000)   # the launch queued, not waited
            ev[0].record()
            calls[3][1]()
            ev[1].record()
            torch.cuda.synchronize()
            lib.mc_pb_merge_stamps(buf.ctypes.data)
            st = buf.reshape(STAMP_BLOCKS, STAMP_SLOTS)
            st = st[st[:, 0] != 0]
            d = np.diff(st[:, :9], axis=1).astype(np.float64)
            is_last = st[:, 11] == 1
            mean.append(np.append(d[:, :7].mean(axis=0), np.nan))
            last.append(d[is_last][0])
            spans.append((st[:, 10].max() - st[:, 9].min()) / 1e3)
            event_ms.append(ev[0].elapsed_time(ev[1]))
            tiles.append(st.shape[0])
    del pb
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()
    mhz = float(clock[0]) if clock else float("nan")
    for label, k in (("the median launch", None), ("the first launch", 0)):
        m, x = ((np.median(mean, axis=0), np.median(last, axis=0))
                if k is None else (mean[k], last[k]))
        sp = np.median(spans) if k is None else spans[k]
        ev = np.median(event_ms) if k is None else event_ms[k]
        print(f"    pb_merge by phase (@this-merge-stamps, {label} of "
              f"{reps}, {tiles[0]} blocks; cycles, the blocks' mean / the "
              f"last block, and the last block's us at the SM clock "
              f"{mhz:.0f} MHz read after): "
              + "; ".join(f"{name} {a:.0f} / {b:.0f} ({b / mhz:.3f} us)"
                          for name, a, b in zip(STAMPS, m, x))
              + f"; the blocks' span (globaltimer) {sp:.3f} us against the "
              f"launch's {ev * 1e3:.3f} us (events)", flush=True)


# A whole k-mer run in a tree's root (the walls part): warm up on the 15k
# corpus, then one timed run; prints one JSON line.
WALL_CHILD = r"""
import hashlib, json, sys, time
import torch
from meshclust_tpu_torch.config import ClusterConfig
from meshclust_tpu_torch.core.runner import run
from meshclust_tpu_torch.utils import perf
warm, fasta, out = sys.argv[1:4]
dev = torch.device("cuda", 0)
run(ClusterConfig(files=[warm], output=out + ".warm", similarity=0.90),
    device=dev)
perf.reset()
torch.cuda.synchronize()
t0 = time.time()
run(ClusterConfig(files=[fasta], output=out, similarity=0.90), device=dev)
torch.cuda.synchronize()
wall = time.time() - t0
with open(out, "rb") as f:
    digest = hashlib.sha256(f.read()).hexdigest()[:16]
print(json.dumps({"wall": wall, "phases": perf.phases(), "digest": digest}))
"""


def walls(parent_tree: str, sizes: list) -> None:
    """The walls part (see the module docstring)."""
    trees = {"parent": os.path.abspath(parent_tree),
             "this": os.path.dirname(os.path.abspath(__file__))}
    if not os.path.isdir(os.path.join(trees["parent"],
                                      "meshclust_tpu_torch")):
        raise SystemExit(f"walls: no meshclust_tpu_torch under "
                         f"{parent_tree}")
    warm = smoke.bench_corpus()
    for n in sizes:
        fasta = smoke.bench_corpus(n=n)
        got, order = [], ("parent", "this", "this", "parent") * 2
        for who in order:
            out = os.path.join(smoke.WORK, f"walls_{who}_{n}.clstr")
            child = subprocess.run(
                [sys.executable, "-c", WALL_CHILD, warm, fasta, out],
                capture_output=True, text=True, timeout=1800,
                cwd=trees[who], env={**os.environ, "MESHCLUST_QUIET": "1"})
            if child.returncode != 0:
                raise SystemExit(f"walls: the {who} run at {n} reads "
                                 f"failed:\n{child.stderr[-3000:]}")
            r = json.loads(child.stdout.strip().splitlines()[-1])
            got.append(r)
            ph = r["phases"]
            print(f"  {n} reads, {who}: wall {r['wall']:.4f} s, "
                  + ", ".join(f"{k} {ph[k]:.4f}" for k in
                              ("read", "featurize", "train", "accumulate",
                               "phase_b") if k in ph)
                  + f" s; NMI vs species {smoke.species_nmi(out):.6f}, "
                  f"CLSTR sha256 {r['digest']}", flush=True)
        print(f"  {n} reads: CLSTR equal across the turns "
              f"{len({r['digest'] for r in got}) == 1}", flush=True)
        for who in ("parent", "this"):
            runs = [r for r, w in zip(got, order) if w == who]
            cols = {"wall": [r["wall"] for r in runs]}
            for k in ("read", "featurize", "train", "accumulate", "phase_b"):
                cols[k] = [r["phases"].get(k, 0.0) for r in runs]
            print(f"  {n} reads, {who}, {len(runs)} runs (least / median / "
                  f"greatest s): " + "; ".join(
                      f"{k} {min(v):.4f} / {np.median(v):.4f} / "
                      f"{max(v):.4f}" for k, v in cols.items()), flush=True)


@contextlib.contextmanager
def kernels_from(handle):
    """Run the port's wrappers on another build of the kernel library."""
    from meshclust_tpu_torch import _ext
    with _ext._lock:
        saved, _ext._lib = _ext._lib, handle
    try:
        yield
    finally:
        with _ext._lock:
            _ext._lib = saved


def build_all(builds: dict) -> dict:
    """{name: sources} built in parallel; {name: library path}, each
    build's register lines printed."""
    from meshclust_tpu_torch import _ext
    t0 = time.time()
    with ThreadPoolExecutor(len(builds)) as pool:
        paths = dict(zip(builds, pool.map(_ext.build, builds.values())))
    print(f"  built {len(builds)} libraries in {time.time() - t0:.2f} s",
          flush=True)
    for name, srcs in builds.items():
        with open(_ext.build_log_path(srcs)) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"    {name}: {line.strip()}", flush=True)
    BUILT.update(paths)
    return paths


def shape_inputs(dev):
    rng = np.random.default_rng(5)
    for label, n, lo, hi in SHAPES:
        pairs = sorted_pairs(rng, n, lo, hi)
        yield label, pairs, smoke.pair_corpus(
            pairs, 6, dev, set(range(0, n, 2))), hi


def time_in_turns(paths: dict, order: list, dev) -> None:
    """Each shape on each library in `order`; outputs must be bit-equal."""
    import torch
    from meshclust_tpu_torch import _ext
    from meshclust_tpu_torch.ops.align_device import nw_align_long
    libs = {name: _ext.load(path) for name, path in paths.items()}
    for label, pairs, (codes, lens, ia, ib), hi in shape_inputs(dev):
        want = None
        for name in order:
            with kernels_from(libs[name]):
                got = nw_align_long(codes, lens, ia, ib, hi)
                ms = smoke.cuda_ms(
                    lambda: nw_align_long(codes, lens, ia, ib, hi), reps=2)
            if want is None:
                want = got
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"  {nw_line(f'{name} {label}', pairs, ms)}, bit-equal "
                  f"{same}", flush=True)
            if not same:
                smoke.fail(f"{name} disagrees at {label}")


def variant_source(r: str, t: str, k: str) -> str:
    """A copy of csrc/nw_align_long.cu under build/variants/ with its
    constants kR, kT and kK set to r, t and k; returns its path."""
    from meshclust_tpu_torch import _ext
    with open(os.path.join(_ext.CSRC, "nw_align_long.cu")) as f:
        src = f.read()
    for name, value in (("kR", r), ("kT", t), ("kK", k)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {int(value)};", src)
        if n != 1:
            smoke.fail(f"nw_align_long.cu: no constant {name}")
    out = os.path.join(os.path.dirname(_ext.BUILD_DIR), "variants",
                       f"R{r}_T{t}_K{k}", "nw_align_long.cu")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(src)
    return out


def variants(dev, specs: str) -> None:
    from meshclust_tpu_torch import _ext
    kmer = os.path.join(_ext.CSRC, "kmer_hist.cu")
    builds = {"default": _ext.sources()}
    for spec in specs.split():
        r, t, k = spec.split(",")
        builds[f"R={r} T={t} K={k}"] = [kmer, variant_source(r, t, k)]
    paths = build_all(builds)
    time_in_turns(paths, list(paths), dev)


def run_path(dev, fasta: str, out: str, **cfg) -> tuple:
    """(wall s, {phase: s}) of one run of core.runner.run on dev."""
    import torch
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.runner import run
    from meshclust_tpu_torch.utils import perf
    perf.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    run(ClusterConfig(files=[fasta], output=out, **cfg), device=dev)
    torch.cuda.synchronize()
    return time.time() - t0, perf.phases()


def compare(dev, against: list, timed: bool, e2e: bool) -> None:
    """With timed, each source of `against` in turns with this tree's
    kernel at SHAPES; with e2e, both main paths on the first of them and on
    this one."""
    from meshclust_tpu_torch import _ext
    kmer = os.path.join(_ext.CSRC, "kmer_hist.cu")
    builds = {os.path.relpath(path): [kmer, os.path.abspath(path)]
              for path in against}
    builds["this"] = _ext.sources()
    paths = build_all(builds)
    others = [name for name in builds if name != "this"]
    if timed:
        time_in_turns(paths, others + ["this", "this"] + others[::-1], dev)
    if not e2e:
        return
    libs = {name: _ext.load(paths[name]) for name in (others[0], "this")}
    turns = [others[0], "this", "this", others[0]]
    for label, fasta, cfg in (
            ("k-mer path --id 0.90", smoke.bench_corpus(),
             {"similarity": 0.90}),
            ("genome align-mode path --id 0.50", smoke.genome_corpus(),
             {"similarity": 0.50})):
        run_path(dev, fasta, os.path.join(smoke.WORK, "warm.clstr"), **cfg)
        clstr = set()
        for k, name in enumerate(turns):
            out = os.path.join(smoke.WORK, f"compare_{k}.clstr")
            with kernels_from(libs[name]):
                wall, phases = run_path(dev, fasta, out, **cfg)
            align = phases.get("align", 0.0)
            with open(out, "rb") as f:
                clstr.add(f.read())
            print(f"  {name} {label}: wall {wall:.3f} s, align {align:.4f} "
                  f"s", flush=True)
        print(f"  {label}: CLSTR byte-equal across the {len(turns)} runs of "
              f"both kernels: {len(clstr) == 1}", flush=True)


# The parent's C entry point (csrc/kmer_hist.cu before the one-launch
# redesign): packed, lengths, valid, inseg, B, Lp, k, init, counts, ones,
# mag, sq, stream.
PARENT_KMER_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p] * 5


def seqs_of(flat) -> list:
    """Sequences viewing flat inputs (records r0, r1, ...)."""
    from meshclust_tpu_torch.io import fasta as fio
    codes, rec_off, segs, seg_off = flat
    return [fio.Sequence(f">r{r}", codes[rec_off[r]: rec_off[r + 1]],
                         segs[seg_off[r]: seg_off[r + 1]])
            for r in range(rec_off.shape[0] - 1)]


def parent_inputs(Hp, seqs, k, dev) -> list:
    """The parent's host work of featurize: length buckets, padded and
    2-bit-packed batches on dev."""
    import torch
    lengths = [s.length for s in seqs]
    out = []
    for bucket in Hp.length_buckets(lengths):
        Lp = Hp.round_up(max(max(lengths[i] for i in bucket), Hp.LANE),
                         Hp.LANE)
        out.append((torch.as_tensor(bucket, dtype=torch.int64, device=dev),
                    *Hp.batch_inputs([seqs[i] for i in bucket], k, Lp, dev)))
    return out


def parent_device(Hp, batches, n: int, k: int, dev):
    """The parent's device work of featurize: a launch and an index-put a
    bucket, the maximum over hist_dev, the narrowing."""
    import torch
    hist = torch.zeros((n, 4 ** k), dtype=torch.int32, device=dev)
    for rows, packed, lens, valid, inseg in batches:
        counts, ones, mag, sq = Hp.kmer_hist(packed, lens, valid, inseg, k)
        hist[rows] = counts
    sdt = np.dtype(Hp.storage_dtype(int(hist.max())))
    return hist.to(Hp._TORCH_DTYPE[sdt]) if sdt.itemsize < 4 else hist


def this_host(seqs, dev) -> list:
    """This tree's host work of featurize: the flat inputs on dev."""
    import torch
    from meshclust_tpu_torch.ops import histogram as H
    return [torch.from_numpy(a).to(dev) for a in H.flat_inputs(seqs)]


def feat(dev, parent_dir: str) -> None:
    """kmer_hist and featurize of the parent (parent_dir/kmer_hist.cu and
    parent_dir/histogram.py) against this tree's, in turns."""
    import importlib.util
    import torch
    from meshclust_tpu_torch import _ext
    from meshclust_tpu_torch.core import points
    from meshclust_tpu_torch.io import fasta as fio
    from meshclust_tpu_torch.ops import histogram as H
    spec = importlib.util.spec_from_file_location(
        "parent_histogram", os.path.join(parent_dir, "histogram.py"))
    Hp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(Hp)
    nw = os.path.join(_ext.CSRC, "nw_align_long.cu")
    paths = build_all({"parent": [os.path.abspath(os.path.join(
        parent_dir, "kmer_hist.cu")), nw], "this": _ext.sources()})
    parent_lib = _ext.load(paths["parent"])
    parent_lib.mc_kmer_hist.argtypes = PARENT_KMER_SIGNATURE
    libs = {"parent": parent_lib, "this": _ext.load(paths["this"])}
    turns = ["parent", "this", "this", "parent"]
    flush = smoke.flush_l2(dev)
    for label, flat, k in smoke.kmer_shapes():
        seqs = seqs_of(flat)
        n = len(seqs)
        split = H.split_mode(np.diff(flat[1]), k)
        results = {}
        for name in turns:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "parent":
                batches = parent_inputs(Hp, seqs, k, dev)
            else:
                t = this_host(seqs, dev)
            torch.cuda.synchronize()
            host = time.perf_counter() - t0
            with kernels_from(libs[name]):
                _ext.reset_launches()
                if name == "parent":
                    fn = lambda: parent_device(Hp, batches, n, k, dev)
                else:
                    fn = lambda: smoke.featurize_device(t, k, split)
                out = fn()
                launches = _ext.launches["kmer_hist"]
                ms = smoke.cold_ms(fn, 10, flush)
            results.setdefault("hist", out)
            same = torch.equal(out, results["hist"])
            print(f"  {name} {label}: host inputs {host:.4f} s, device "
                  f"featurization {ms:.4f} ms cold L2, {launches} kmer_hist "
                  f"launches, equal to the first turn: {same}", flush=True)
            if not same:
                smoke.fail(f"{name} featurizes {label} differently")
            del out
    for label, fasta, cfg in (
            ("k-mer path --id 0.90", smoke.bench_corpus(),
             {"similarity": 0.90}),
            ("genome align-mode path --id 0.50", smoke.genome_corpus(),
             {"similarity": 0.50})):
        run_path(dev, fasta, os.path.join(smoke.WORK, "warm.clstr"), **cfg)
        clstr = set()
        for i, name in enumerate(turns):
            out = os.path.join(smoke.WORK, f"feat_{i}.clstr")
            saved = points.H
            points.H = Hp if name == "parent" else H
            try:
                with kernels_from(libs[name]):
                    wall, phases = run_path(dev, fasta, out, **cfg)
            finally:
                points.H = saved
            with open(out, "rb") as f:
                clstr.add(f.read())
            print(f"  {name} {label}: wall {wall:.3f} s, featurize "
                  f"{phases.get('featurize', 0.0):.4f} s (feat_pack "
                  f"{phases.get('feat_pack', 0.0):.4f}, feat_device "
                  f"{phases.get('feat_device', 0.0):.4f}, feat_stats "
                  f"{phases.get('feat_stats', 0.0):.4f})", flush=True)
        print(f"  {label}: CLSTR byte-equal across the {len(turns)} runs: "
              f"{len(clstr) == 1}", flush=True)


# ~0.5 ms at the H100's clocks: longer than a wrapper call on the host
ABSORB_SPIN_CYCLES = 1_000_000


def absorb_windows_ms(ps, bv, params) -> dict:
    """pa_absorb's device ms (CUDA events around each launch, median of
    20) on these Phase A inputs with the center at slot 0 and every other
    slot live: a window of no slot, of one slot, and of every slot (the
    state restored before each launch, outside the events). A spin of
    ABSORB_SPIN_CYCLES on the stream precedes the start event, so the
    launch is queued before the event runs and the host's wrapper time
    stays out of the interval."""
    import torch
    from meshclust_tpu_torch.core import accumulate_device as A
    from meshclust_tpu_torch.ops import phase_a as P
    sl = A._Slots(ps, bv, params, 0.90, plain=False)
    sl.begin(0, 0, 0)
    sl.active[0] = False
    P.sums(sl.st, sl.active, sl.h, sl.sums)     # every slot's sums
    saved = [x.clone() for x in (sl.st, sl.active, sl.owner, sl.stamp,
                                 sl.sumvec)]
    out = {}
    for name, (w0, w1) in (("empty", (1, 0)), ("one slot", (1, 1)),
                           ("every slot", (0, sl.N - 1))):
        times = []
        for _ in range(21):
            for x, y in zip((sl.st, sl.active, sl.owner, sl.stamp,
                             sl.sumvec), saved):
                x.copy_(y)
            sl.st[P.W0], sl.st[P.W1] = w0, w1
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(ABSORB_SPIN_CYCLES)
            start.record()
            P.absorb(sl.st, sl.sums, sl.model, sl.mag, sl.sq, sl.lenf,
                     sl.owner, sl.stamp, sl.active, sl.h, sl.sumvec, sl.part)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = float(np.median(times[1:]))
    return out


def load_library(path: str) -> ctypes.CDLL:
    """A kernel library, as _ext.load types it, of this tree or an
    earlier one: an entry point it lacks is left out."""
    from meshclust_tpu_torch import _ext
    handle = ctypes.CDLL(path)
    for name, argtypes in _ext._SIGNATURES.items():
        if hasattr(handle, name):
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    handle.mc_error_string.argtypes = [ctypes.c_int]
    handle.mc_error_string.restype = ctypes.c_char_p
    return handle


@contextlib.contextmanager
def phase_a_library(libs: dict, name: str):
    """The wrappers on libs[name]."""
    with kernels_from(libs[name]):
        yield


def phase_a_compare(dev, parent_dir: str, sizes: list) -> None:
    """The phase_a part: an earlier csrc/phase_a.cu against this tree's,
    in turns (module docstring)."""
    import torch
    from meshclust_tpu_torch import _ext
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.bvec import BVec
    from meshclust_tpu_torch.core.runner import run
    from meshclust_tpu_torch.utils import perf
    others = [os.path.join(_ext.CSRC, f) for f in ("kmer_hist.cu",
                                                     "nw_align_long.cu",
                                                     "phase_b.cu")]
    paths = build_all({"parent": others + [os.path.abspath(os.path.join(
        parent_dir, "phase_a.cu"))], "this": _ext.sources()})
    libs = {name: load_library(path) for name, path in paths.items()}
    with open(os.path.join(parent_dir, "phase_a.cu")) as f:
        if "mc_pa_next" not in f.read():
            smoke.fail("the parent's phase_a.cu has no pa_next: its kernels "
                       "take the center and the stamp from a host loop, "
                       "which this tree's accumulate_device no longer runs")
    turns = ["parent", "this", "this", "parent"]
    flush = smoke.flush_l2(dev)
    rng = np.random.default_rng(9)
    rows8 = torch.from_numpy(rng.integers(
        0, 128, size=(smoke.PA_SUMS_ROWS, 256), dtype=np.int8)).to(dev)
    for name in turns:
        with phase_a_library(libs, name):
            for label, rows in (("int8", rows8),
                                ("int8 slice [:, 1:129]", rows8[:, 1:129])):
                r = smoke.sums_case(rows, True, flush)
                print(f"  {name} pa_sums {smoke.PA_SUMS_ROWS} x 256 {label}: "
                      f"{r['ms']:.5f} ms cold L2, bound {r['bound_ms']:.5f} "
                      f"ms, {r['bound_ms'] / r['ms']:.4f} of it, max abs err "
                      f"{r['max_abs_err']}", flush=True)
                del r
    del rows8
    torch.cuda.empty_cache()
    for n in sizes:
        fasta = smoke.bench_corpus(n=n)
        cfg = ClusterConfig(files=[fasta], output=os.path.join(
            smoke.WORK, "phase_a_warm.clstr"), similarity=0.90).finalize()
        perf.reset()
        res = run(cfg, device=dev)
        counters = perf.counters()
        ps = res["pointset"]
        bv = BVec(ps.lengths.copy(), cfg.bin_size)
        bv.bulk_insert(ps.lengths)
        bv.insert_finalize()
        params = res["model"].params
        traffic = smoke.phase_a_traffic(ps, bv, params,
                                        smoke.PROFILE_CENTERS)
        notes = traffic[3]
        print(f"  {n} reads: pa_window's bound as PR 8's kernel read it "
              f"(every flag, bin and len of the live slots): "
              f"{notes['pa_window (all flags)']:.0f} B a launch, against "
              f"{traffic[0]['pa_window']:.0f} B it must read; a move: "
              f"{notes['members']:.2f} members in "
              f"{notes['member warps']:.2f} warps of 32 slots and "
              f"{notes['member tiles']:.2f} tiles", flush=True)
        for name in ("parent", "this"):
            with phase_a_library(libs, name):
                print(f"  {name}, {n} reads:", flush=True)
                if n <= FULL_CLUSTER_READS:
                    ms = absorb_windows_ms(ps, bv, params)
                    print("    pa_absorb ms a launch by window: "
                          + ", ".join(f"{k} {v:.5f}" for k, v in ms.items()),
                          flush=True)
                phase_a_kernels(ps, bv, params, counters, traffic)
                host_split(ps, bv, params, cfg.similarity)
        clstr = set()
        for i, name in enumerate(turns):
            out = os.path.join(smoke.WORK, f"phase_a_{i}.clstr")
            with phase_a_library(libs, name):
                wall, phases = run_path(dev, fasta, out, similarity=0.90)
            with open(out, "rb") as f:
                clstr.add(f.read())
            print(f"  {name} {n} reads: wall {wall:.3f} s, accumulate "
                  f"{phases.get('accumulate', 0.0):.4f} s, NMI "
                  f"{smoke.species_nmi(out):.6f}", flush=True)
        print(f"  {n} reads: CLSTR byte-equal across the {len(turns)} runs: "
              f"{len(clstr) == 1}", flush=True)
        if len(clstr) != 1:
            smoke.fail(f"the parent's Phase A and this one cluster {n} reads "
                       f"differently")


# Probes of kmer_hist for --parts kvariants: edits of csrc/kmer_hist.cu that
# remove one cost each (their results differ from the kernel's by design).
KMER_PROBES = {
    # global-style atomicAdd in place of red.shared at a shared address
    "@atomic": [("  if (kGlobal)\n    atomicAdd(bins + id, 1);\n  else\n",
                 "  if (true)\n    atomicAdd(bins + id, 1);\n  else\n")],
    # the ids computed, nothing added to the bins
    "@noatom": [("count_id<kGlobal>(bins, bins_s,\n                        "
                 "__funnelshift_r(cur, prev, 30 - 2 * t) & mask);",
                 "tl.n0 ^= __funnelshift_r(cur, prev, 30 - 2 * t) & mask;")],
    # loads, shuffles, epilogue and stores only: no id, no count
    "@loadonly": [("  uint32_t inseg = 0xffffffffu;",
                   "  tl.n0 += (cur ^ prev) & 1u;\n  return;\n"
                   "  uint32_t inseg = 0xffffffffu;")],
}


def kmer_variant_source(spec: str) -> str:
    """A copy of csrc/kmer_hist.cu under build/kvariants/ with the edits of
    spec ("kWarps=4,@noatom": constants set, probes applied); returns its
    path."""
    from meshclust_tpu_torch import _ext
    with open(os.path.join(_ext.CSRC, "kmer_hist.cu")) as f:
        src = f.read()
    for item in spec.split(","):
        if item.startswith("@"):
            for old, new in KMER_PROBES[item]:
                if old not in src:
                    smoke.fail(f"kmer_hist.cu: probe {item} does not apply")
                src = src.replace(old, new)
            continue
        name, value = item.split("=")
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {int(value)};", src)
        if n != 1:
            smoke.fail(f"kmer_hist.cu: no constant {name}")
    out = os.path.join(os.path.dirname(_ext.BUILD_DIR), "kvariants",
                       re.sub(r"[^A-Za-z0-9]+", "_", spec), "kmer_hist.cu")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(src)
    return out


def kvariants(dev, specs: str) -> None:
    """kmer_hist built side by side with the edits of each spec (or from
    another source, file:PATH) and timed in turns at chip_smoke.py's
    kmer_shapes with the L2 flushed; results held against the plain
    version; the genome shape also in the other mode. First, the card's
    own floor at each shape: a fill of the rows and a copy of the codes."""
    import torch
    from meshclust_tpu_torch import _ext
    from meshclust_tpu_torch.ops import histogram as H
    nw = os.path.join(_ext.CSRC, "nw_align_long.cu")
    builds = {"this": _ext.sources()}
    for spec in specs.split():
        src = spec[5:] if spec.startswith("file:") \
            else kmer_variant_source(spec)
        builds[spec] = [os.path.abspath(src), nw]
    paths = build_all(builds)
    libs = {name: _ext.load(path) for name, path in paths.items()}
    flush = smoke.flush_l2(dev)
    for label, flat, k in smoke.kmer_shapes():
        t = [torch.from_numpy(a).to(dev) for a in flat]
        rows = torch.empty((len(flat[1]) - 1, 4 ** k), dtype=torch.int32,
                           device=dev)
        print(f"  floor {label}: fill of the rows "
              f"{smoke.cold_ms(lambda: rows.fill_(1), 10, flush):.4f} ms, "
              f"copy of the codes "
              f"{smoke.cold_ms(lambda: t[0].clone(), 10, flush):.4f} ms",
              flush=True)
        del rows
        split = H.split_mode(np.diff(flat[1]), k)
        want = H.kmer_hist_plain(*t, k)
        b = smoke.kmer_bound(t, want)
        for name in list(libs) + list(libs)[::-1]:
            with kernels_from(libs[name]):
                got = H.kmer_hist(*t, k, split=split)
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                ms = smoke.cold_ms(lambda: H.kmer_hist(*t, k, split=split),
                                   10, flush)
                other = smoke.cold_ms(
                    lambda: H.kmer_hist(*t, k, split=not split), 5, flush) \
                    if split else None
            print(f"  {name} {label}: {ms:.4f} ms cold L2, share of bound "
                  f"{b['bound_ms'] / ms:.4f}"
                  + (f", rows mode {other:.4f} ms" if split else "")
                  + f", equal to the plain version {same}", flush=True)
        del want


SASS_KERNELS = ("nw_align_long_kernel", "kmer_rows_kernelILb0E",
                "kmer_split_kernel", "pa_absorb_kernelIaE",
                "pa_sums_kernelIaLi16E", "pa_window_kernel",
                "pa_move_kernelIaLi16E", "pb_band_kernelIaLi16E",
                "pb_dist_kernelIaLi16E")


def sass() -> None:
    """Opcode counts of each kernel of SASS_KERNELS in every library built
    in this run: the whole function, and its longest straight-line block
    (the NW fast path's step; kmer_hist's fast path over one 16-base
    block)."""
    import subprocess
    from meshclust_tpu_torch import _ext
    tool = os.path.join(os.path.dirname(_ext.nvcc()), "cuobjdump")
    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_.]*)")
    seen = set()
    for name, path in {"default": _ext.library_path(), **BUILT}.items():
        if path in seen:
            continue
        seen.add(path)
        text = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, timeout=300).stdout
        for chunk in text.split("Function : ")[1:]:
            kernel = [k for k in SASS_KERNELS
                      if k in chunk.split("\n", 1)[0]]
            if kernel:
                sass_counts(f"{name} {kernel[0]}", chunk, op)


def sass_counts(label: str, func: str, op) -> None:
    """Opcode counts of one function's SASS and of its longest
    straight-line block."""
    import collections
    blocks, block = [], []
    for line in func.splitlines():
        if line.lstrip().startswith(".L_"):
            blocks.append(block)
            block = []
        m = op.search(line)
        if m:
            block.append(m.group(1))
            if m.group(1).startswith(("BRA", "EXIT", "BAR")):
                blocks.append(block)
                block = []
    blocks.append(block)
    longest = max(blocks, key=len)
    if label.split()[-1].startswith("pb_"):
        # pb_band's and pb_dist's staged pair sums: the block of 16-byte
        # shared-memory loads with the most IDP.4A
        staged = max(blocks, key=lambda b: (
            "LDS.128" in b, sum(o.startswith("IDP") for o in b)))
        print(f"  {label}: staged block {len(staged)}: "
              + ", ".join(f"{o} {n}" for o, n in
                          collections.Counter(staged).most_common()),
              flush=True)
    ops = collections.Counter(o for b in blocks for o in b)
    local = {k: sum(n for o, n in ops.items() if o.split(".")[0] == k)
             for k in ("LDL", "STL")}
    print(f"  {label}: {sum(ops.values())} instructions in all (local "
          f"memory: LDL {local['LDL']}, STL {local['STL']}); longest "
          f"block {len(longest)}: "
          + ", ".join(f"{o} {n}" for o, n in
                      collections.Counter(longest).most_common()),
          flush=True)


# (label, shape, dtype, reduction) of the collectives timed by --parts
# ranks: the 15k k-mer run's (N = 15,000, V = 256, ~150 centers)
COLLECTIVES = (("Phase B sums [150, 257] int64 SUM", (150, 257), "int64",
                "sum"),
               ("Phase B minimum [150] float64 MIN", (150,), "float64",
                "min"),
               ("Phase B position [150] int64 MIN", (150,), "int64", "min"))
# reads of the featurized rows gathered by --parts ranks, [N, 256] int32 in
# blocks balanced by bases: the 15k run's, and the 1M-read run's (over
# NCCL only: through gloo each call stages 1 GB through the host)
GATHER_ROWS = (15000, 1000000)


def _median_ms(mesh, fn, reps: int = 20, warm: int = 3) -> float:
    """Median ms of fn() to a sync, each call after a barrier."""
    import torch
    from meshclust_tpu_torch.parallel import dist
    times = []
    for _ in range(warm + reps):
        dist.barrier(mesh, "bench")
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times[warm:])) * 1e3


def _gather_padded(local, off, mesh):
    """gather_rows as one all-gather of the blocks padded to the largest,
    then one copy that drops the padding: the form timed against
    parallel/dist.gather_rows's SUM into zeros over NCCL."""
    import torch
    import torch.distributed as tdist
    sizes = np.diff(off)
    B = int(sizes.max())
    if local.shape[0] < B:
        local = torch.cat([local, local.new_zeros(
            (B - local.shape[0],) + tuple(local.shape[1:]))])
    buf = local.new_empty((mesh.size * B,) + tuple(local.shape[1:]))
    tdist.all_gather_into_tensor(buf, local, group=mesh.group)
    return torch.cat([buf[r * B: r * B + int(c)] for r, c in enumerate(sizes)])


def collective_ms() -> list:
    """One rank's median ms of each of COLLECTIVES, and of the gather of
    the rows at GATHER_ROWS: parallel/dist.gather_rows (SUM into zeros)
    and, over NCCL, _gather_padded (spawned by parallel/dist.launch)."""
    import torch
    from meshclust_tpu_torch.parallel import dist
    mesh = dist.get_mesh()
    fns = {"sum": dist.psum, "min": dist.pmin}
    out = []
    for label, shape, dtype, red in COLLECTIVES:
        t = torch.ones(shape, dtype=getattr(torch, dtype),
                       device=mesh.device)
        out.append((label, t.numel() * t.element_size(),
                    _median_ms(mesh, lambda: fns[red](t, mesh, "bench"))))
    forms = {"SUM": lambda x, off: dist.gather_rows(x, off, mesh, "bench")}
    if mesh.backend == "nccl":
        forms["padded all-gather"] = lambda x, off: _gather_padded(x, off,
                                                                   mesh)
    for n_rows in GATHER_ROWS:
        if n_rows > 15000 and mesh.backend != "nccl":
            continue
        bases = np.random.default_rng(0).integers(900, 1100, n_rows)
        off = dist.blocks(bases, mesh.size)
        local = torch.full((int(off[mesh.rank + 1] - off[mesh.rank]), 256),
                           mesh.rank + 1, dtype=torch.int32,
                           device=mesh.device)
        want = torch.repeat_interleave(
            torch.arange(1, mesh.size + 1, dtype=torch.int32,
                         device=mesh.device),
            torch.as_tensor(np.diff(off), device=mesh.device))
        for name, fn in forms.items():
            if not torch.equal(fn(local, off)[:, 0], want):
                raise AssertionError(f"the {name} gather is wrong")
            ms = _median_ms(mesh, lambda: fn(local, off))
            out.append((f"featurize rows [{n_rows}, 256] int32 {name}, "
                        f"blocks {np.diff(off).tolist()}",
                        n_rows * 256 * 4, ms))
        del local, want
        torch.cuda.empty_cache()
    return out


def ranks(dev, counts: list) -> None:
    """The ranks part (module docstring)."""
    from meshclust_tpu_torch.parallel import dist
    fasta = smoke.bench_corpus()
    one = os.path.join(smoke.WORK, "ranks_one.clstr")
    walls = {}
    for n in counts:
        outs = dist.launch(collective_ms, n, None)
        print(f"  {n} ranks: collectives, median ms of 20 (rank: ms ...)",
              flush=True)
        for i, (label, nbytes, _) in enumerate(outs[0]):
            ms = [o[i][2] for o in outs]
            print(f"    {label}, {nbytes} B: "
                  + ", ".join(f"{r}: {m:.4f}" for r, m in enumerate(ms)),
                  flush=True)
        got = os.path.join(smoke.WORK, f"ranks_{n}.clstr")
        for turn in ("1", "n", "n", "1"):
            if turn == "1":
                smoke.drive(dev, "k-mer path, 1 rank", fasta, one,
                            similarity=0.90)
                walls.setdefault(1, []).append(
                    smoke.WALLS["k-mer path, 1 rank"])
            else:
                rank_outs, wall = smoke.launch_ranks(
                    f"k-mer path, {n} ranks", n, fasta, got,
                    similarity=0.90)
                walls.setdefault(n, []).append(
                    (wall, max(o["wall"] for o in rank_outs)))
        print(f"  {n} ranks: CLSTR byte-equal to 1 rank's: "
              f"{smoke.same_file(got, one)}", flush=True)
    print(f"  walls, s: 1 rank {walls[1]}; "
          + "; ".join(f"{n} ranks (launch, slowest rank's run) {walls[n]}"
                      for n in counts), flush=True)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="throughput,busy")
    ap.add_argument("--against", nargs="+", default=[],
                    help="NW sources for the compare and e2e parts")
    ap.add_argument("--parent", default="build/parent",
                    help="directory with the parent's kmer_hist.cu and "
                    "ops/histogram.py, for the feat part, its "
                    "phase_a.cu, for the phase_a part, or its phase_b.cu "
                    "and common.cuh, for the pbvariants part")
    ap.add_argument("--parent-tree", default="build/parent_tree",
                    help="an earlier commit's whole tree, for the walls "
                    "part")
    ap.add_argument("--kmer-variants", default="kWarps=4 kClusterCtas=2 "
                    "kClusterCtas=8 @atomic @noatom @loadonly",
                    help="kmer_hist edits (NAME=VALUE, @probe) or "
                    "file:PATH sources for the kvariants part")
    ap.add_argument("--variants", default="4,128,8 6,128,8 12,128,8 "
                    "16,128,8 8,256,8 8,128,1 8,128,4")
    ap.add_argument("--ranks", default="2",
                    help="rank counts of the ranks part, e.g. 2,4")
    ap.add_argument("--sizes", default="15000,150000",
                    help="read counts of the cluster part's corpora, e.g. "
                    "15000,150000,1000000")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if ("compare" in parts or "e2e" in parts) and not args.against:
        ap.error("compare and e2e need --against")
    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", file=sys.stderr)
        return 1
    from meshclust_tpu_torch import _ext
    os.makedirs(smoke.WORK, exist_ok=True)
    os.environ.setdefault("MESHCLUST_QUIET", "1")
    dev = torch.device("cuda", 0)
    print(f"card: {smoke.card_line()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; NW bound: the longer of "
          f"{smoke.NW_ALU_OPS_PER_CELL} ALU ops a cell at "
          f"{smoke.INT32_OPS_PER_S:.4g} ops/s and {smoke.NW_OPS_PER_CELL} "
          f"int32 ops a cell at {smoke.DISPATCH_OPS_PER_S:.4g} ops/s",
          flush=True)
    _ext.lib()
    if "throughput" in parts:
        print("NW kernel's throughput by pairs per launch", flush=True)
        nw_throughput(dev)
    if "variants" in parts:
        print("NW kernel's variants, side by side", flush=True)
        variants(dev, args.variants)
    if "compare" in parts or "e2e" in parts:
        print(f"NW kernel against {' '.join(args.against)}, in turns",
              flush=True)
        compare(dev, args.against, "compare" in parts, "e2e" in parts)
    if "kvariants" in parts:
        print("kmer_hist's variants and probes, side by side", flush=True)
        kvariants(dev, args.kmer_variants)
    if "feat" in parts:
        print(f"kmer_hist and featurize against {args.parent}, in turns",
              flush=True)
        feat(dev, args.parent)
    if "phase_a" in parts:
        print(f"Phase A's kernels against {args.parent}/phase_a.cu, in turns",
              flush=True)
        phase_a_compare(dev, args.parent,
                        [int(x) for x in args.sizes.split(",")])
    if "sass" in parts:
        print("SASS of the kernels", flush=True)
        sass()
    if "cluster" in parts:
        print("k-mer-mode clustering on the device", flush=True)
        for k, n in enumerate(int(x) for x in args.sizes.split(",")):
            cluster(dev, n, warm=k == 0, full=n <= FULL_CLUSTER_READS)
    if "phase_b" in parts or "pbvariants" in parts:
        for n in (int(x) for x in args.sizes.split(",")):
            if "phase_b" in parts:
                print(f"the fused Phase B at {n} reads: kernels against "
                      f"plain steps", flush=True)
                phase_b_part(dev, n)
            if "pbvariants" in parts:
                print(f"Phase B's kernels at {n} reads against "
                      f"{args.parent}/phase_b.cu and its probes", flush=True)
                pbvariants(dev, args.parent, [n])
    if "walls" in parts:
        print(f"whole runs against {args.parent_tree}, in turns", flush=True)
        walls(args.parent_tree, [int(x) for x in args.sizes.split(",")])
    if "ranks" in parts:
        print(f"several ranks on {torch.cuda.device_count()} GPUs",
              flush=True)
        ranks(dev, [int(n) for n in args.ranks.split(",")])
    if "busy" in parts:
        print("device busy share of the main paths", flush=True)
        busy_share(dev, "k-mer path --id 0.90", smoke.bench_corpus(),
                   similarity=0.90)
        busy_share(dev, "genome align-mode path --id 0.50",
                   smoke.genome_corpus(), similarity=0.50)
    print(f"card: {smoke.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

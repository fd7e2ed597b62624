#!/usr/bin/env python3
"""Profile of the PyTorch/CUDA port (meshclust_tpu_torch) on one GPU.

Run from the repository root, after chip_smoke.py has passed:
    python3 profile_port.py [--parts throughput,busy,variants,compare,e2e,
                                     feat,kvariants,sass,cluster,ranks]
                            [--ranks 2,4]
                            [--against OLD.cu ...] [--variants "R,T,K ..."]
                            [--parent DIR] [--kmer-variants "SPEC ..."]

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
  sass        opcode counts of nw_align_long_kernel and the kmer_hist
              kernels in each library built by the run (cuobjdump -sass).
  cluster     k-mer-mode clustering on the device (DeviceBackend, Phase A
              in core/accumulate_device.py, the fused Phase B), on the
              smoke's 15k-read corpus (after a warm-up run) and on the
              150k-read corpus of bench.py:make_dataset: one run's wall,
              phases and counters (ms per absorb iteration and per Phase B
              iteration from its phase times); the busy share of a profiled
              run; then Phase A and Phase B alone on that run's points and
              model under the profiler: wall, device time, busy share, and
              kernel launches, host-device copies, wall and device ms per
              iteration.
  ranks       several ranks (parallel/dist), for each n of --ranks: n
              ranks (gloo where they share a card, NCCL where each has its
              own) time each collective at the 15k k-mer run's shapes (a
              Phase A sweep's sums, a move of the center, a Phase B
              iteration's sums, minimum and positions) and the gather of
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
import json
import os
import re
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


def cluster(dev, label: str, fasta: str, warm: bool, **cfg) -> None:
    """The k-mer path's clustering on the device (see the cluster part in
    the module docstring)."""
    import torch
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.accumulate_device import accumulate_device
    from meshclust_tpu_torch.core.bvec import BVec
    from meshclust_tpu_torch.core.runner import run
    from meshclust_tpu_torch.utils import perf
    cfg = ClusterConfig(files=[fasta], output=os.path.join(
        smoke.WORK, "cluster.clstr"), **cfg).finalize()
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
    print(f"  {label}: {ps.n} sequences, {res['n_clusters']} clusters, "
          f"backend {type(res['backend']).__name__}, wall {wall:.3f} s",
          flush=True)
    print(f"    phases {json.dumps(phases)}", flush=True)
    print(f"    counters {json.dumps(counters)}", flush=True)
    iters = counters.get("accum_iters", 0.0)
    print(f"    ms per absorb iteration (accumulate phase / accum_iters): "
          f"{phases.get('accumulate', 0.0) * 1e3 / max(iters, 1):.4f}; ms "
          f"per Phase B iteration (phase_b phase / {cfg.iterations}): "
          f"{phases.get('phase_b', 0.0) * 1e3 / cfg.iterations:.4f}",
          flush=True)
    busy_share(dev, label, fasta, warm=False, similarity=cfg.similarity)
    # Phase A and the fused Phase B alone, on this run's points and model
    bv = BVec(ps.lengths.copy(), cfg.bin_size)
    bv.bulk_insert(ps.lengths)
    bv.insert_finalize()
    params = res["model"].params
    perf.reset()
    centers, wall, dev_s, launches, copies = profiled(
        lambda: accumulate_device(ps, bv, params, cfg.similarity))
    print("    " + piece_line("Phase A alone", wall, dev_s, launches, copies,
                              perf.counters()["accum_iters"]), flush=True)
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
                "kmer_split_kernel")


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
    ops = collections.Counter(o for b in blocks for o in b)
    print(f"  {label}: {sum(ops.values())} instructions in all; longest "
          f"block {len(longest)}: "
          + ", ".join(f"{o} {n}" for o, n in
                      collections.Counter(longest).most_common()),
          flush=True)


# (label, shape, dtype, reduction) of the collectives timed by --parts
# ranks: the 15k k-mer run's (N = 15,000, V = 256, ~150 centers)
COLLECTIVES = (("Phase A sweep [2, 15000] int64 SUM", (2, 15000), "int64",
                "sum"),
               ("Phase A move [15001] int64 SUM", (15001,), "int64", "sum"),
               ("Phase B sums [150, 257] int64 SUM", (150, 257), "int64",
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
                    "ops/histogram.py, for the feat part")
    ap.add_argument("--kmer-variants", default="kWarps=4 kClusterCtas=2 "
                    "kClusterCtas=8 @atomic @noatom @loadonly",
                    help="kmer_hist edits (NAME=VALUE, @probe) or "
                    "file:PATH sources for the kvariants part")
    ap.add_argument("--variants", default="4,128,8 6,128,8 12,128,8 "
                    "16,128,8 8,256,8 8,128,1 8,128,4")
    ap.add_argument("--ranks", default="2",
                    help="rank counts of the ranks part, e.g. 2,4")
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
    if "sass" in parts:
        print("SASS of the kernels", flush=True)
        sass()
    if "cluster" in parts:
        print("k-mer-mode clustering on the device", flush=True)
        cluster(dev, "k-mer path --id 0.90, 15k reads", smoke.bench_corpus(),
                True, similarity=0.90)
        cluster(dev, "k-mer path --id 0.90, 150k reads",
                smoke.bench_corpus(n=150000), False, similarity=0.90)
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

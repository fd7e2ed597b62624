#!/usr/bin/env python3
"""Profile of the PyTorch/CUDA port (meshclust_tpu_torch) on one GPU.

Run from the repository root, after chip_smoke.py has passed:
    python3 profile_port.py

It measures what chip_smoke.py does not:
  1. the NW kernel's time and throughput (DP cells per second) against the
     number of pairs in one launch, by CUDA events, on pairs of ~1 kb (the
     k-mer path's) and of 9-12 kb (the genome path's), sorted by l1 + l2 as
     DeviceAligner sorts them;
  2. the device busy share of two whole runs, each after a warm-up run of
     the same configuration: the smoke's k-mer path (15k x 1 kb, --id 0.90,
     default flags) and its genome align-mode path (300 genomes of 9-12 kb,
     --id 0.50). Device self time from torch.profiler over the run's host
     wall time, followed by the profiler's table of the busiest device
     ops.
Every line starts with the card's name and power limit or follows one that
does, so each number can be kept beside the card it came from.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

import chip_smoke as smoke

# (label, shortest and longest sequence, pairs per launch)
NW_SHAPES = (("~1 kb", 900, 1100, (128, 2048, 16384)),
             ("9-12 kb", 9000, 12000, (1, 64, 300, 1024)))


def nw_throughput(dev) -> None:
    from meshclust_tpu_torch.ops.align_device import nw_align_long
    rng = np.random.default_rng(1)
    for label, lo, hi, counts in NW_SHAPES:
        for P in counts:
            pairs = sorted(((int(rng.integers(lo, hi + 1)),
                             int(rng.integers(lo, hi + 1)))
                            for _ in range(P)), key=sum)
            codes, lens, ia, ib = smoke.pair_corpus(pairs, 2, dev,
                                                    set(range(0, P, 2)))
            ms = smoke.cuda_ms(
                lambda: nw_align_long(codes, lens, ia, ib, hi), reps=2)
            cells = float(sum(a * b for a, b in pairs))
            print(f"  nw_align_long {label} pairs={P}: {ms:.3f} ms, "
                  f"{cells / ms / 1e6:.4f} Gcells/s", flush=True)


def busy_share(dev, label: str, fasta: str, **cfg) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.runner import run
    from meshclust_tpu_torch.utils import perf
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
    dev_s = sum(e.self_device_time_total for e in ka) / 1e6
    print(f"  {label} profiled wall {wall:.3f} s, device self time "
          f"{dev_s:.4f} s, busy share {dev_s / wall:.4f}", flush=True)
    print(f"  phases {json.dumps(perf.phases())}", flush=True)
    print(ka.table(sort_by="self_device_time_total", row_limit=12),
          flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", file=sys.stderr)
        return 1
    from meshclust_tpu_torch import _ext
    os.makedirs(smoke.WORK, exist_ok=True)
    os.environ.setdefault("MESHCLUST_QUIET", "1")
    dev = torch.device("cuda", 0)
    print(f"card: {smoke.card_line()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    _ext.lib()
    print("NW kernel's throughput by pairs per launch", flush=True)
    nw_throughput(dev)
    print("device busy share of the main paths", flush=True)
    busy_share(dev, "k-mer path --id 0.90", smoke.bench_corpus(),
               similarity=0.90)
    busy_share(dev, "genome align-mode path --id 0.50",
               smoke.genome_corpus(), similarity=0.50)
    print(f"card: {smoke.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

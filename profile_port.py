#!/usr/bin/env python3
"""Profile of the PyTorch/CUDA port (meshclust_tpu_torch) on one GPU.

Run from the repository root, after chip_smoke.py has passed:
    python3 profile_port.py

It measures two things that chip_smoke.py does not:
  1. the NW kernel's time and throughput (DP cells per second) against the
     number of pairs in one launch (random ~1 kb codes, pairs sorted by
     l1 + l2 as DeviceAligner sorts them), by CUDA events;
  2. the device busy share of one whole main-path run (the smoke's 15k x
     1 kb corpus, --id 0.90, default flags) after a warm-up run: device self
     time from torch.profiler over the run's host wall time, followed by the
     profiler's table of the busiest device ops.
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

PAIR_COUNTS = (128, 512, 2048, 8192, 16384)


def nw_throughput(dev) -> None:
    import torch
    from meshclust_tpu_torch.ops.align_device import nw_align
    rng = np.random.default_rng(1)
    lens = rng.integers(900, 1101, size=4096)
    codes, lens_dev = smoke.staged_corpus(lens, 2, dev)
    for P in PAIR_COUNTS:
        ia = rng.integers(0, lens.shape[0], size=P)
        ib = rng.integers(0, lens.shape[0], size=P)
        order = np.argsort(lens[ia] + lens[ib], kind="stable")
        ia, ib = ia[order], ib[order]
        ia_t = torch.from_numpy(ia.astype(np.int32)).to(dev)
        ib_t = torch.from_numpy(ib.astype(np.int32)).to(dev)
        max_l1 = int(lens[ia].max())
        ms = smoke.cuda_ms(
            lambda: nw_align(codes, lens_dev, ia_t, ib_t, max_l1), reps=2)
        cells = float((lens[ia] * lens[ib]).sum())
        print(f"  nw_align pairs={P}: {ms:.3f} ms, "
              f"{cells / ms / 1e6:.4f} Gcells/s", flush=True)


def busy_share(dev) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.runner import run
    from meshclust_tpu_torch.utils import perf
    fasta = smoke.bench_corpus()
    run(ClusterConfig(files=[fasta], similarity=0.90, sample_size=300,
                      output=os.path.join(smoke.WORK, "warm.clstr")),
        device=dev)
    perf.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(ClusterConfig(files=[fasta], similarity=0.90,
                          output=os.path.join(smoke.WORK, "prof.clstr")),
            device=dev)
        torch.cuda.synchronize()
    wall = time.time() - t0
    ka = prof.key_averages()
    dev_s = sum(e.self_device_time_total for e in ka) / 1e6
    print(f"  main path profiled wall {wall:.3f} s, device self time "
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
    print("NW kernel throughput by pairs per launch", flush=True)
    nw_throughput(dev)
    print("device busy share of the main path", flush=True)
    busy_share(dev)
    print(f"card: {smoke.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (meshclust_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. print the torch, CUDA and nvcc versions and the card's name and power
     limit;
  2. build the CUDA kernels (csrc/*.cu) and print the build time;
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (results must be bit-equal) and time both;
  4. run the k-mer-mode main path (15,000 synthetic reads of ~1 kb, --id
     0.90, default flags) on the GPU: both kernels must have launched, the
     native host libraries must have loaded, and the partition must match
     the planted species (NMI >= 0.95); then a small corpus clustered on the
     GPU and on the CPU (plain versions) must give byte-equal CLSTR files;
  5. print one JSON line per the contract, the card line, and the final
     {"ok": true, ...} line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "smoke")
NMI_MIN = 0.95


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    return int((a.to(dtype=b.dtype) - b).abs().max()) if a.numel() else 0


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def synthetic_records(n: int, lo: int, hi: int, seed: int, n_frac: float = 0.0,
                      short: int = 0):
    """n encoded FASTA records of lengths in [lo, hi]; a share n_frac of
    them gets an N run, and `short` extra records are under 20 bp."""
    from meshclust_tpu_torch.io import fasta as fio
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    for i in range(n + short):
        L = int(rng.integers(lo, hi + 1)) if i < n else int(rng.integers(4, 20))
        raw = letters[rng.integers(0, 4, size=L)].copy()
        if i < n and rng.random() < n_frac:
            p = int(rng.integers(0, L - 60))
            raw[p: p + int(rng.integers(3, 40))] = ord("N")
        out.append(fio.encode_record(f">r{i}", raw.tobytes()))
    return out


def bench_corpus(n: int = 15000, length: int = 1000, seed: int = 42) -> str:
    """The corpus of bench.py:make_dataset: n // species clones of each of
    max(10, n // 100) random ~length bp species, 3% substitutions."""
    path = os.path.join(WORK, f"bench_{n}_{length}.fasta")
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    species = max(10, n // 100)
    per = n // species
    with open(path, "wb") as f:
        for s in range(species):
            L = length + int(rng.integers(-length // 10, length // 10))
            base = rng.integers(0, 4, size=L, dtype=np.int8)
            seqs = np.tile(base, (per, 1))
            mut = rng.random((per, L)) < 0.03
            seqs = np.where(mut, (seqs + 1 + rng.integers(
                0, 3, size=(per, L), dtype=np.int8)) % 4, seqs)
            ends = L - rng.integers(0, max(2, L // 50), size=per)
            rows = letters[seqs]
            for c in range(per):
                f.write(b">sp%d_c%d\n" % (s, c))
                f.write(rows[c, : ends[c]].tobytes() + b"\n")
    return path


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_histogram(dev) -> dict:
    import torch
    from meshclust_tpu_torch.ops import histogram as H
    cases = [("2048x1024bp k=4", synthetic_records(2048, 900, 1024, 1), 4),
             ("2048x1024bp k=7", synthetic_records(2048, 900, 1024, 2), 7),
             ("512x1024bp k=8 (global bins)",
              synthetic_records(512, 900, 1024, 3), 8),
             ("N segments + <20bp k=5",
              synthetic_records(500, 100, 1024, 4, n_frac=0.5, short=40), 5)]
    row = None
    for name, seqs, k in cases:
        Lp = H.round_up(max(max(s.length for s in seqs), H.LANE), H.LANE)
        packed, lens, valid, inseg = H.batch_inputs(seqs, k, Lp, dev)
        got = H.kmer_hist(packed, lens, valid, inseg, k)
        want = H.kmer_hist_plain(packed, lens, valid, inseg, k)
        torch.cuda.synchronize()
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"  kmer_hist {name}: bit-equal={same} max_abs_err={err}",
              flush=True)
        if not same:
            fail(f"kmer_hist disagrees with its plain version ({name})")
        if row is None:   # the main path's shape
            ms = cuda_ms(lambda: H.kmer_hist(packed, lens, None, None, k),
                         reps=20, warmup=3)
            plain_ms = cuda_ms(
                lambda: H.kmer_hist_plain(packed, lens, None, None, k),
                reps=5)
            print(f"  kmer_hist {name}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms", flush=True)
            row = {"name": "kmer_hist", "route": "cuda",
                   "source": "meshclust_tpu_torch/csrc/kmer_hist.cu",
                   "replaces": "meshclust_tpu/ops/histogram.py:102",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return row


def staged_corpus(lens: np.ndarray, seed: int, dev):
    """[n, Lpad] int8 random codes of the given lengths, with 1% N bytes
    (78), and their int32 lengths, on dev."""
    import torch
    rng = np.random.default_rng(seed)
    lpad = -(-int(lens.max()) // 128) * 128
    mat = np.zeros((lens.shape[0], lpad), np.int8)
    for i, L in enumerate(lens):
        c = rng.integers(0, 4, size=int(L)).astype(np.int8)
        c[rng.random(int(L)) < 0.01] = 78
        mat[i, :L] = c
    return (torch.from_numpy(mat).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev))


def check_nw(dev) -> dict:
    import torch
    from meshclust_tpu_torch.ops.align import align_counts_plain
    from meshclust_tpu_torch.ops.align_device import nw_align
    rng = np.random.default_rng(5)
    lens = rng.integers(700, 1301, size=1024)
    codes, lens_dev = staged_corpus(lens, 6, dev)
    ia = rng.integers(0, 1024, size=2048)
    ib = rng.integers(0, 1024, size=2048)
    order = np.argsort(lens[ia] + lens[ib], kind="stable")
    ia, ib = ia[order], ib[order]
    ia_t = torch.from_numpy(ia.astype(np.int32)).to(dev)
    ib_t = torch.from_numpy(ib.astype(np.int32)).to(dev)
    max_l1 = int(lens[ia].max())
    got = nw_align(codes, lens_dev, ia_t, ib_t, max_l1)
    want = align_counts_plain(codes, lens_dev, ia_t, ib_t)
    torch.cuda.synchronize()
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"  nw_align 2048 pairs 700-1300bp: bit-equal={same} "
          f"max_abs_err={err}", flush=True)
    if not same:
        fail("nw_align disagrees with its plain version (2048 pairs)")
    ms = cuda_ms(lambda: nw_align(codes, lens_dev, ia_t, ib_t, max_l1),
                 reps=5)
    plain_ms = cuda_ms(lambda: align_counts_plain(codes, lens_dev, ia_t,
                                                  ib_t), reps=2)
    print(f"  nw_align 2048 pairs: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms", flush=True)

    # one pair beyond the TPU kernel's row cap (l1 <= 8,192)
    long_codes, long_lens = staged_corpus(np.array([9000, 8500]), 7, dev)
    first = torch.zeros(1, dtype=torch.int32, device=dev)
    second = torch.ones(1, dtype=torch.int32, device=dev)
    g = nw_align(long_codes, long_lens, first, second, 9000)
    w = align_counts_plain(long_codes, long_lens, first, second)
    torch.cuda.synchronize()
    same_long = all(torch.equal(a, b) for a, b in zip(g, w))
    print(f"  nw_align l1=9000 l2=8500: bit-equal={same_long} "
          f"(alen={int(g[0][0])}, amatch={int(g[1][0])})", flush=True)
    if not same_long:
        fail("nw_align disagrees with its plain version (l1 = 9000)")
    err = max(err, max_abs_err(g[0], w[0]), max_abs_err(g[1], w[1]))
    return {"name": "nw_align", "route": "cuda",
            "source": "meshclust_tpu_torch/csrc/nw_align.cu",
            "replaces": "meshclust_tpu/ops/align_window.py:69",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def species_nmi(clstr_path: str) -> float:
    from meshclust_tpu_torch.io.clstr import nmi, parse_clstr, partition_labels
    labels = partition_labels(parse_clstr(clstr_path))
    truth = {h: h[1:].split("_")[0] for h in labels}
    ids = {s: i for i, s in enumerate(sorted(set(truth.values())))}
    return nmi(labels, {h: ids[s] for h, s in truth.items()})


def main_path(dev) -> dict:
    import torch
    from meshclust_tpu_torch import _ext, native
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.runner import run
    from meshclust_tpu_torch.utils import perf
    fasta = bench_corpus()
    out = os.path.join(WORK, "smoke_15k.clstr")
    perf.reset()
    _ext.reset_launches()
    t0 = time.time()
    res = run(ClusterConfig(files=[fasta], similarity=0.90, output=out),
              device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_ext.launches)
    print(f"  main path {res['pointset'].n} reads --id 0.90: wall "
          f"{wall:.3f} s, {res['n_clusters']} clusters, k={res['k']}, "
          f"launches {launches}", flush=True)
    for name, secs in sorted(perf.phases().items(), key=lambda kv: -kv[1]):
        print(f"    phase {name:<14s} {secs:10.4f} s", flush=True)
    for name, val in sorted(perf.counters().items()):
        print(f"    counter {name:<14s} {val:.6g}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the main path")
    if native.get_lib() is None or native.get_refsort() is None:
        fail("the native fasta_parser or refsort library did not load")
    score = species_nmi(out)
    print(f"  NMI vs species labels: {score:.6f}", flush=True)
    if not score >= NMI_MIN:
        fail(f"NMI {score} < {NMI_MIN}")
    return launches


def small_parity(dev) -> None:
    """A small corpus clustered on the GPU and on the CPU (plain versions
    of the kernels) must give byte-equal CLSTR files."""
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.runner import run
    rng = np.random.default_rng(11)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    fasta = os.path.join(WORK, "small.fasta")
    with open(fasta, "wb") as f:
        for s in range(6):
            L = 160 + int(rng.integers(-16, 16))
            base = rng.integers(0, 4, size=L)
            for c in range(20):
                seq = base.copy()
                mut = rng.random(L) < 0.03
                seq[mut] = (seq[mut] + 1 + rng.integers(
                    0, 3, size=int(mut.sum()))) % 4
                row = letters[seq[: L - int(rng.integers(0, 6))]].copy()
                if c % 4 == 0:
                    p = int(rng.integers(10, 100))
                    row[p: p + int(rng.integers(3, 25))] = ord("N")
                f.write(b">sp%d_c%d\n" % (s, c))
                f.write(row.tobytes() + b"\n")
    outs = {}
    for name, d in (("gpu", dev), ("cpu", "cpu")):
        outs[name] = os.path.join(WORK, f"small_{name}.clstr")
        run(ClusterConfig(files=[fasta], similarity=0.90,
                          output=outs[name], sample_size=300), device=d)
    with open(outs["gpu"], "rb") as a, open(outs["cpu"], "rb") as b:
        same = a.read() == b.read()
    print(f"  small corpus GPU vs CPU CLSTR byte-equal: {same}", flush=True)
    if not same:
        fail("GPU and CPU runs of the small corpus differ")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "meshclust_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository (no "
              "meshclust_tpu_torch/csrc beside this script)", file=sys.stderr)
        return 1
    from meshclust_tpu_torch import _ext
    os.makedirs(WORK, exist_ok=True)
    os.environ.setdefault("MESHCLUST_QUIET", "1")
    dev = torch.device("cuda", 0)
    card = card_line()

    print("phase 1: versions", flush=True)
    nvcc_version = subprocess.run(
        [_ext.nvcc(), "--version"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[-1]
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc {nvcc_version}", flush=True)
    print(f"  card: {card} ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible)", flush=True)

    print("phase 2: build", flush=True)
    t0 = time.time()
    _ext.lib()
    print(f"  built {os.path.relpath(_ext.library_path(), ROOT)} in "
          f"{time.time() - t0:.2f} s", flush=True)
    if os.path.exists(_ext.build_log_path()):
        with open(_ext.build_log_path()) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"    {line.strip()}", flush=True)

    print("phase 3: kernels against their plain versions", flush=True)
    rows = [check_histogram(dev), check_nw(dev)]

    print("phase 4: main path", flush=True)
    launches = main_path(dev)
    small_parity(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

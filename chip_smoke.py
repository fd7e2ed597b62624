#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (meshclust_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. print the torch, CUDA and nvcc versions and the card's name and power
     limit;
  2. build the CUDA kernels (csrc/*.cu, one nvcc per source, in parallel)
     and print the build time and each kernel's registers;
  3. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes (results must be bit-equal), time both, and compute
     each kernel's bound (HBM bytes or INT32 operations); kmer_hist also on
     an edge corpus at k = 1..8 in both of its modes (lengths at its block,
     step and cluster-share edges from the constants ops/histogram.py
     exports, N runs, records under 20 bp, a chunked 2 Mb record), timed
     at the 15k-read, 300-genome and 150k-read shapes with a warm and a
     flushed L2, beside its other mode and the device featurization
     (launch + narrowing); the NW kernel also on pairs at its thread, warp
     and strip edges (from the constants ops/align_device.py exports),
     lopsided pairs and one 40 kb x 40 kb pair;
  4. run each path on the GPU with the launch counts set to 0 just before
     it, and check that it launched both kernels, kmer_hist exactly once:
     - k-mer mode: 15,000 synthetic reads of ~1 kb, --id 0.90, default
       flags; the native host libraries must have loaded and the partition
       must match the planted species (NMI >= 0.95); then a small corpus
       clustered on the GPU and on the CPU (plain versions) must give
       byte-equal CLSTR files;
     - align mode on genomes: a 6-virus mix of 9-12 kb genomes at --id 0.50,
       NMI against the planted species >= 0.889, and 32 pairs of the run's identity memo re-aligned
       by the plain version must give the same identities;
     - align mode on short reads (--align --id 0.90): GPU and CPU CLSTR
       files must be byte-equal;
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
# The reference's own NMI on its 6-virus mix at --id 0.50
# (Tables/Viral.csv:6).
NMI_MIN_VIRAL = 0.889
# Least times ("bound_ms"): one H100 SXM's published HBM rate (NVIDIA's
# data sheet); its INT32 ALU pipe, 132 SMs x 64 lanes x 1.98 GHz boost,
# which alone runs compares and selects; and its dispatch rate, 128 lanes
# an SM a cycle, of ALU and FMA pipes together, where integer adds also go.
# A cell of the NW recurrence takes 18 compares and selects (four choices,
# each a compare and three selects of score, D and X, and the substitution
# score's compare and select) and 7 adds (csrc/nw_align_long.cu).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
DISPATCH_OPS_PER_S = 132 * 128 * 1.98e9
NW_ALU_OPS_PER_CELL = 18
NW_OPS_PER_CELL = NW_ALU_OPS_PER_CELL + 7


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


def timed(fn):
    """(fn(), device ms of that one call), by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(a, b) -> int:
    return int((a.to(dtype=b.dtype) - b).abs().max()) if a.numel() else 0


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(nbytes: float, ops_s: float) -> dict:
    """The least time of a kernel that moves nbytes and whose operations
    take ops_s seconds at the card's peak: the larger of the two, and
    which it is."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nw_bound(pairs) -> dict:
    """The NW kernel's bound on (l1, l2) pairs: each code read once, two
    int32 written a pair; a DP cell's NW_ALU_OPS_PER_CELL compares and
    selects on the ALU pipe, or all its NW_OPS_PER_CELL operations at the
    dispatch rate, whichever takes longer."""
    cells = float(sum(a * b for a, b in pairs))
    return bound(sum(a + b + 8 for a, b in pairs),
                 max(cells * NW_ALU_OPS_PER_CELL / INT32_OPS_PER_S,
                     cells * NW_OPS_PER_CELL / DISPATCH_OPS_PER_S))


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


def viral_corpus(name: str, species: int, per: int, length: int,
                 spread: int, rate_lo: float, rate_hi: float,
                 seed: int) -> str:
    """The recipe of bench.py:make_viral_dataset: `species` random base
    genomes of length +- spread bp, `per` clones each with a substitution
    rate drawn from [rate_lo, rate_hi), each clone trimmed at its end by
    under 5%."""
    path = os.path.join(WORK, f"{name}.fasta")
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as f:
        for s in range(species):
            L = length + int(rng.integers(-spread, spread))
            base = rng.integers(0, 4, size=L, dtype=np.int8)
            for c in range(per):
                rate = rate_lo + (rate_hi - rate_lo) * rng.random()
                e = L - int(rng.integers(0, L // 20))
                seq = base[:e].copy()
                mut = rng.random(e) < rate
                seq[mut] = (seq[mut] + 1 + rng.integers(
                    0, 3, size=int(mut.sum()))) % 4
                f.write(b">v%d_c%d\n" % (s, c))
                f.write(letters[seq].tobytes() + b"\n")
    return path


def genome_corpus() -> str:
    """A 6-virus mix of genomes of 9,000-12,000 bp, 50 clones each with
    12-22% substitutions, seed 7: bench.py:make_viral_dataset with genome
    lengths in place of ~1.2 kb. Every clone is longer than 8,550 bp, past
    the 8,192-row cap of the JAX package's short-pair kernels."""
    return viral_corpus("viral_genomes", 6, 50, 10500, 1500, 0.12, 0.22, 7)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def flush_l2(dev):
    """A function that evicts the 50 MB L2 (writes 256 MB)."""
    import torch
    junk = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    return lambda: junk.fill_(1)


def cold_ms(fn, reps: int, flush) -> float:
    """Mean device time of fn() with the L2 flushed before each run."""
    import torch
    total = 0.0
    fn()
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def kmer_edge_records(seed: int):
    """Records at the kmer_hist kernel's edges (ops/histogram.py BLOCK,
    WARPS, CLUSTER_CTAS): lengths at its 16-base blocks, 32-block steps and
    cluster shares, reads with N runs that split or merge segments, records
    under 20 bp (no segment) that push every later offset off the 16-byte
    grid, and one record of 2 x SEG_LENGTH + 999 bp with an N run, whose
    segment is chunked."""
    from meshclust_tpu_torch.io import fasta as fio
    from meshclust_tpu_torch.ops import histogram as H
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    R, W = H.BLOCK, 32 * H.BLOCK
    team = H.WARPS * H.CLUSTER_CTAS * H.BLOCK
    lengths = [20, 21, R + 5, 2 * R - 1, 2 * R, 2 * R + 1, W - 1, W, W + 1,
               2 * W + 3, team - 1, team, team + 1, 10 * team + 5, 10500]
    out = synthetic_records(200, 100, 1500, seed, n_frac=0.4, short=9)
    for i, L in enumerate(lengths + [2 * fio.SEG_LENGTH + 999]):
        raw = letters[rng.integers(0, 4, size=L)].copy()
        if L > fio.SEG_LENGTH:
            raw[700: 760] = ord("N")
        out.append(fio.encode_record(f">e{i}", raw.tobytes()))
        out.append(fio.encode_record(f">s{i}", raw[: 1 + i % 15].tobytes()))
    return out


def bench_flat(n: int, seed: int = 42):
    """flat_inputs of a corpus with bench.py:make_dataset's lengths (max(10,
    n // 100) species of 1,000 +- 100 bp, each clone trimmed by under 2%),
    random bases, built in bulk with numpy."""
    rng = np.random.default_rng(seed)
    species = max(10, n // 100)
    per = n // species
    base = 1000 + rng.integers(-100, 100, size=species)
    lens = (np.repeat(base, per) - rng.integers(
        0, np.repeat(np.maximum(2, base // 50), per))).astype(np.int64)
    rec_off = np.zeros(lens.shape[0] + 1, np.int64)
    np.cumsum(lens, out=rec_off[1:])
    total = int(rec_off[-1])
    codes = np.zeros(-(-total // 16) * 16, np.uint8)
    codes[:total] = rng.integers(0, 4, size=total, dtype=np.uint8)
    segs = np.stack([np.zeros_like(lens), lens - 1], axis=1)
    return codes, rec_off, segs, np.arange(lens.shape[0] + 1, dtype=np.int64)


def kmer_shapes():
    """(label, flat inputs, k) of the main paths' launches and the 150k
    corpus."""
    from meshclust_tpu_torch.io import fasta as fio
    from meshclust_tpu_torch.ops import histogram as H
    return [("15k reads k=4 (k-mer path)",
             H.flat_inputs(fio.read_fasta(bench_corpus())), 4),
            ("300 genomes k=6 (genome path)",
             H.flat_inputs(fio.read_fasta(genome_corpus())), 6),
            ("150k reads k=4", bench_flat(150000), 4)]


def kmer_bound(t, out) -> dict:
    """kmer_hist's bound: its inputs read once (the codes at one byte a
    base) and its five outputs written once, at the HBM rate; operations:
    a few int32 operations a base."""
    bases = float(t[1][-1])
    return bound(bases + tensor_bytes(*t[1:], *out),
                 4.0 * bases / INT32_OPS_PER_S)


def featurize_device(t, k, split):
    """What featurize runs on the device: the launch, then the narrowing
    of the rows to their storage dtype."""
    from meshclust_tpu_torch.ops import histogram as H
    hist, _, _, _, largest = H.kmer_hist(*t, k, split=split)
    sdt = np.dtype(H.storage_dtype(int(largest[0])))
    return hist.to(H._TORCH_DTYPE[sdt]) if sdt.itemsize < 4 else hist


def check_histogram(dev) -> dict:
    import torch
    from meshclust_tpu_torch.ops import histogram as H
    edges = H.flat_inputs(kmer_edge_records(4))
    for k in range(1, 9):
        t = [torch.from_numpy(a).to(dev) for a in edges]
        for split in (False, True):
            got = H.kmer_hist(*t, k, split=split)
            want = H.kmer_hist_plain(*t, k)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"kmer_hist disagrees with its plain version at the "
                     f"edges, k={k} split={split}")
    print(f"  kmer_hist edge corpus ({edges[1].shape[0] - 1} records, "
          f"k=1..8, rows and split mode): bit-equal=True", flush=True)
    flush = flush_l2(dev)
    row = None
    for label, flat, k in kmer_shapes():
        t = [torch.from_numpy(a).to(dev) for a in flat]
        split = H.split_mode(np.diff(flat[1]), k)
        got = H.kmer_hist(*t, k, split=split)
        want, plain_ms = timed(lambda: H.kmer_hist_plain(*t, k))
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        del want
        if not same:
            fail(f"kmer_hist disagrees with its plain version ({label})")
        b = kmer_bound(t, got)
        warm = cuda_ms(lambda: H.kmer_hist(*t, k, split=split), reps=20,
                       warmup=3)
        cold = cold_ms(lambda: H.kmer_hist(*t, k, split=split), 10, flush)
        feat = cold_ms(lambda: featurize_device(t, k, split), 10, flush)
        other = cold_ms(lambda: H.kmer_hist(*t, k, split=not split), 10,
                        flush)
        mode = "split" if split else "rows"
        print(f"  kmer_hist {label}: bit-equal={same}, {mode} mode, kernel "
              f"{warm:.4f} ms warm L2, {cold:.4f} ms cold, bound "
              f"{b['bound_ms']:.6f} ms ({b['bound_by']}, share "
              f"{b['bound_ms'] / cold:.4f} cold); the other mode "
              f"{other:.4f} ms cold; featurize on the device (launch + "
              f"narrowing) {feat:.4f} ms cold; plain {plain_ms:.4f} ms",
              flush=True)
        if row is None:   # the k-mer path's shape
            # No single PyTorch call computes it: torch.bincount would need
            # the k-mer ids built first.
            row = {"name": "kmer_hist", "route": "cuda",
                   "source": "meshclust_tpu_torch/csrc/kmer_hist.cu",
                   "replaces": "meshclust_tpu/ops/histogram.py:102",
                   "max_abs_err": err, "ms": cold, "plain_ms": plain_ms,
                   "library_ms": None, **b}
    return row


def pair_corpus(pairs, seed: int, dev, related=()):
    """Staged codes for (l1, l2) pairs: sequence 2t has length l1 and
    2t + 1 length l2. For t in `related` the second is a copy of the first
    with 15% substitutions, cut or padded with random bases to l2; all get
    1% N bytes (78). Returns stage()'s tensors on dev."""
    rng = np.random.default_rng(seed)
    seqs = []
    for t, (l1, l2) in enumerate(pairs):
        a = rng.integers(0, 4, size=l1).astype(np.int8)
        b = rng.integers(0, 4, size=l2).astype(np.int8)
        if t in related:
            n = min(l1, l2)
            b[:n] = a[:n]
            mut = rng.random(n) < 0.15
            b[:n][mut] = (b[:n][mut] + 1 + rng.integers(
                0, 3, size=int(mut.sum()))) % 4
        for c in (a, b):
            c[rng.random(c.shape[0]) < 0.01] = 78
            seqs.append(c)
    return stage(seqs, dev)


def stage(seqs, dev):
    """Codes of the pairs (seqs[2t], seqs[2t + 1]) as the NW kernels take
    them: (codes [2P, Lpad] int8, lengths [2P] int32, ia [P], ib [P]
    int32) on dev."""
    import torch
    lpad = -(-max(len(c) for c in seqs) // 128) * 128
    mat = np.zeros((len(seqs), lpad), np.int8)
    for i, c in enumerate(seqs):
        mat[i, : len(c)] = c
    idx = np.arange(len(seqs) // 2, dtype=np.int32)
    return (torch.from_numpy(mat).to(dev),
            torch.from_numpy(np.asarray([len(c) for c in seqs],
                                        np.int32)).to(dev),
            torch.from_numpy(2 * idx).to(dev),
            torch.from_numpy(2 * idx + 1).to(dev))


def check_nw_long(dev) -> dict:
    import torch
    from meshclust_tpu_torch.ops.align import align_counts_plain
    from meshclust_tpu_torch.ops import align_device as AD
    from meshclust_tpu_torch.ops.align_device import nw_align_long
    rng = np.random.default_rng(13)
    genome = [(int(rng.integers(9000, 12001)), int(rng.integers(9000, 12001)))
              for _ in range(163)]
    # l1 and l2 at the kernel's thread (R rows), warp (32 R rows) and strip
    # (S rows) edges, lopsided pairs, and the 1 x 1 pair
    R, S = AD.ROWS_PER_THREAD, AD.STRIP_ROWS
    W = 32 * R
    edges = [(100, 3000), (S - 1, 3000), (S, 3000), (S + 1, 3000),
             (2 * S, 2 * S + 1), (2 * S + 1, 2 * S), (W - 1, 700),
             (W, 700), (W + 1, 700), (700, W + 1), (R - 1, 500), (R, 500),
             (R + 1, 500), (500, R - 1), (500, R + 1), (1, 5000), (5000, 1),
             (1, 1), (20000, 500), (500, 20000)]
    reads = [(int(rng.integers(700, 1301)), int(rng.integers(700, 1301)))
             for _ in range(2048)]
    cases = [("163 pairs 9,000-12,000 bp (the genome path's launch, 82 "
              "related)", genome, range(0, 163, 2)),
             ("2,048 pairs 700-1,300 bp (k-mer path's shape)", reads, ()),
             ("thread-, warp- and strip-edge and lopsided pairs", edges,
              range(len(edges))),
             ("one pair 40,000 x 40,000 bp (related)", [(40000, 40000)],
              (0,))]
    row = None
    err = 0
    for k, (name, pairs, related) in enumerate(cases):
        codes, lens, ia, ib = pair_corpus(pairs, 20 + k, dev, set(related))
        max_l2 = max(l2 for _, l2 in pairs)
        got, ms = timed(lambda: nw_align_long(codes, lens, ia, ib, max_l2))
        want, plain_ms = timed(lambda: align_counts_plain(codes, lens, ia,
                                                          ib))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(err, *(max_abs_err(g, w) for g, w in zip(got, want)))
        cells = float(sum(a * b for a, b in pairs))
        b = nw_bound(pairs)
        print(f"  nw_align_long {name}: bit-equal={same}, kernel {ms:.4f} "
              f"ms ({cells / ms / 1e6:.4f} Gcells/s, bound "
              f"{b['bound_ms']:.4f} ms, {b['bound_ms'] / ms:.4f} of it), "
              f"plain {plain_ms:.4f} ms", flush=True)
        if not same:
            fail(f"nw_align_long disagrees with its plain version ({name})")
        if row is None:   # the genome-length path's shape
            ms = cuda_ms(lambda: nw_align_long(codes, lens, ia, ib, max_l2),
                         reps=3)
            print(f"  nw_align_long {name}: kernel {ms:.4f} ms over 3 "
                  f"launches, plain {plain_ms:.4f} ms", flush=True)
            # No PyTorch call computes GlobAlignE: library_ms is null.
            row = {"name": "nw_align_long", "route": "cuda",
                   "source": "meshclust_tpu_torch/csrc/nw_align_long.cu",
                   "replaces": "meshclust_tpu/ops/align_tiled.py:65",
                   "ms": ms, "plain_ms": plain_ms, "library_ms": None, **b}
    row["max_abs_err"] = err
    return row


# ---------------------------------------------------------------------------
# phase 4: the main paths
# ---------------------------------------------------------------------------

def species_nmi(clstr_path: str) -> float:
    from meshclust_tpu_torch.io.clstr import nmi, parse_clstr, partition_labels
    labels = partition_labels(parse_clstr(clstr_path))
    truth = {h: h[1:].split("_")[0] for h in labels}
    ids = {s: i for i, s in enumerate(sorted(set(truth.values())))}
    return nmi(labels, {h: ids[s] for h, s in truth.items()})


def drive(dev, label: str, fasta: str, out: str, **cfg) -> tuple:
    """One run of core.runner.run on dev, with the launch counts and the
    perf counters set to 0 just before it and read just after it."""
    import torch
    from meshclust_tpu_torch import _ext
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.runner import run
    from meshclust_tpu_torch.utils import perf
    perf.reset()
    _ext.reset_launches()
    t0 = time.time()
    res = run(ClusterConfig(files=[fasta], output=out, **cfg), device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_ext.launches)
    print(f"  {label}: {res['pointset'].n} sequences, wall {wall:.3f} s, "
          f"{res['n_clusters']} clusters, k={res['k']}, launches "
          f"{launches}", flush=True)
    for name, secs in sorted(perf.phases().items(), key=lambda kv: -kv[1]):
        print(f"    phase {name:<14s} {secs:10.4f} s", flush=True)
    for name, val in sorted(perf.counters().items()):
        print(f"    counter {name:<14s} {val:.6g}", flush=True)
    return res, launches


def expect_launches(label: str, launches: dict) -> None:
    for name in ("kmer_hist", "nw_align_long"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the {label} run")
    if launches["kmer_hist"] != 1:
        fail(f"the {label} run launched kmer_hist {launches['kmer_hist']} "
             f"times, not once")


def check_nmi(clstr_path: str, least: float) -> None:
    score = species_nmi(clstr_path)
    print(f"  NMI vs species labels: {score:.6f}", flush=True)
    if not score >= least:
        fail(f"NMI {score} < {least}")


def main_path(dev) -> dict:
    from meshclust_tpu_torch import native
    res, launches = drive(dev, "k-mer path --id 0.90", bench_corpus(),
                          os.path.join(WORK, "smoke_15k.clstr"),
                          similarity=0.90)
    expect_launches("k-mer", launches)
    if native.get_lib() is None or native.get_refsort() is None:
        fail("the native fasta_parser or refsort library did not load")
    check_nmi(os.path.join(WORK, "smoke_15k.clstr"), NMI_MIN)
    return launches


def genome_path(dev) -> dict:
    """Align mode on a 6-virus mix of 9-12 kb genomes at --id 0.50.
    Afterwards 32 pairs of the
    AlignBackend's memo, re-aligned by the plain version in the orientation
    the run aligned them, must give the identities the memo holds."""
    from meshclust_tpu_torch.ops import align_device as AD
    from meshclust_tpu_torch.ops.align import align_counts_plain
    fasta = genome_corpus()
    out = os.path.join(WORK, "viral_genomes.clstr")
    asked = []          # (a, b) in the order the run aligned them
    identities = AD.DeviceAligner.identities

    def spy(self, pairs):
        asked.extend(pairs)
        return identities(self, pairs)

    AD.DeviceAligner.identities = spy
    try:
        res, launches = drive(dev, "align path, genomes --id 0.50", fasta,
                              out, similarity=0.50)
    finally:
        AD.DeviceAligner.identities = identities
    ps = res["pointset"]
    expect_launches("genome align-mode", launches)
    check_nmi(out, NMI_MIN_VIRAL)

    memo = res["backend"].memo
    first = {}
    for a, b in asked:
        first.setdefault(int(memo.key_of(np.asarray(a), np.asarray(b))),
                         (a, b))
    aligned = np.asarray([k for k in memo.keys.tolist() if k in first],
                         np.int64)
    keys = np.random.default_rng(3).choice(
        aligned, size=min(32, aligned.shape[0]), replace=False)
    vals, found = memo.lookup(keys)
    pairs = [first[int(k)] for k in keys]
    codes, lens, ia, ib = stage([c for a, b in pairs
                                 for c in (ps.codes[a], ps.codes[b])], dev)
    (alen, amatch), plain_ms = timed(lambda: align_counts_plain(
        codes, lens, ia, ib))
    ids = amatch.cpu().numpy().astype(np.float64) / np.maximum(
        alen.cpu().numpy().astype(np.float64), 1.0)
    same = bool(found.all()) and np.array_equal(ids, vals)
    print(f"  {keys.shape[0]} memo pairs of {aligned.shape[0]} aligned, "
          f"re-aligned by the plain version ({plain_ms:.4f} ms): "
          f"equal={same}", flush=True)
    if not same:
        fail("the genome run's memo disagrees with the plain version")
    return launches


def short_align_parity(dev) -> None:
    """Align mode on short reads (--align --id 0.90, AlignBackend through
    nw_align_long on short pairs): the GPU and the CPU (plain versions) must write byte-equal
    CLSTR files."""
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.runner import run
    fasta = viral_corpus("short_align", 3, 8, 200, 16, 0.03, 0.05, 11)
    outs = {name: os.path.join(WORK, f"short_align_{name}.clstr")
            for name in ("gpu", "cpu")}
    _, launches = drive(dev, "align path, short reads --align --id 0.90",
                        fasta, outs["gpu"], similarity=0.90, align=True)
    expect_launches("short-read align-mode", launches)
    run(ClusterConfig(files=[fasta], similarity=0.90, align=True,
                      output=outs["cpu"]), device="cpu")
    with open(outs["gpu"], "rb") as a, open(outs["cpu"], "rb") as b:
        same = a.read() == b.read()
    print(f"  short-read align mode GPU vs CPU CLSTR byte-equal: {same}",
          flush=True)
    if not same:
        fail("GPU and CPU align-mode runs of the short reads differ")


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
                if any(w in line for w in ("entry function", "registers",
                                           "spill")):
                    print(f"    {line.strip()}", flush=True)

    print("phase 3: kernels against their plain versions", flush=True)
    rows = [check_histogram(dev), check_nw_long(dev)]

    print("phase 4: main paths", flush=True)
    kmer = main_path(dev)
    small_parity(dev)
    genome = genome_path(dev)
    short_align_parity(dev)
    # each kernel's launches from the two main paths
    for row in rows:
        row["launches"] = kmer[row["name"]] + genome[row["name"]]

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

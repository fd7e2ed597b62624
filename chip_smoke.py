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
     lopsided pairs and one 40 kb x 40 kb pair; Phase A's five kernels
     (csrc/phase_a.cu) on the 15k-read and the 150k-read k-mer corpora's
     Phase A inputs (each from one run of the path): each kernel against
     its plain step over the first 200 iterations of the chain (pa_window,
     pa_sums, pa_absorb, pa_move, pa_next), then the whole phase's owner,
     stamp and center slots against the plain path's, in turns (plain,
     kernels, kernels, plain) with their walls and ms an iteration, each
     kernel's device time and its plain step's under the profiler, the
     launches (the chain's five into a CUDA graph) and replays, the bytes
     an iteration must move (pa_window's beside a count of every flag) and
     each move's members' first and last tile of owners; pa_move also on
     the largest center of the whole phase, with the L2 flushed, beside
     the PyTorch yardstick (cdist, p = 1, on float32 copies of the
     members' rows and the floored mean, then distance_d and argmin);
     pa_sums also on 1,000,000 synthetic rows of 256 counts (int8, with
     and without the dot, int16, int32, and an int8 column slice at an odd
     byte) and on the 15k corpus's rows, over a window of every slot, with
     the L2 flushed, beside its bound and the PyTorch yardstick (cdist +
     matmul on float32 copies); Phase B's four kernels (csrc/phase_b.cu)
     on Phase A's centers of the same two corpora: each kernel against
     its plain step over the 15 iterations (every value the next step
     reads), then the whole phase_b_loop (assign, centers, valid, t_hist)
     against the plain steps', in turns with their walls, launches an
     iteration and the bytes an iteration must move; each kernel's device
     time and its plain step's from the same profile child; the tiles
     pb_band and pb_dist ran on their staged and global paths; pb_band
     beside one index_add_ of its positive rows, pb_pick beside one
     scatter_reduce_ (amin) of its ties' pool positions; the same checks,
     untimed, on the 15k centers each split in two adjacent centers
     (split_centers), which must merge; the pivot-order kernel
     (csrc/pivot_order.cu) against the host chain it replaces on the 15k
     and 150k corpora: training's begin row and 150 pivot rows bit-equal,
     the chains' walls in turns, the kernel's ms a launch and its bound;
  4. run each path on the GPU with the launch counts set to 0 just before
     it, and check that it launched both kernels, kmer_hist exactly once:
     - k-mer mode: 15,000 synthetic reads of ~1 kb, --id 0.90, default
       flags; the native host libraries must have loaded, the run must have
       clustered on the device (DeviceBackend, device Phase A through its
       kernels, driven by the card: the chain's five kernels captured once
       in a CUDA graph, every iteration the device's, one readback a
       replay,
       the fused Phase B through its four kernels, each once an iteration,
       no plain step, with no replay fallback; training's pivot orders
       through the pivot-order kernel, twice, for 151 rows; its accumulate and
       phase_b seconds, absorb iterations and readbacks printed) and the
       partition must
       match the planted species (NMI >= 0.95); the same corpus rerun with
       exact=True (HostBackend, host Phase A and B) must write a
       byte-equal CLSTR file; then a small corpus clustered on the GPU and
       on the CPU (plain versions) must give byte-equal CLSTR files;
     - align mode on genomes: a 6-virus mix of 9-12 kb genomes at --id 0.50,
       NMI against the planted species >= 0.889, and 32 pairs of the run's
       identity memo re-aligned by the plain version must give the same
       identities; the same run with MESHCLUST_ALIGN_STAGE_MB=0 (each
       launch packs its own pairs) and a boundary budget of a few pairs a
       launch must write a byte-equal CLSTR;
     - align mode on short reads (--align --id 0.90): GPU and CPU CLSTR
       files must be byte-equal;
  5. checkpoint, trace and Red:
     - the 15k k-mer run with checkpoint=PREFIX must write both JSON
       files; its rerun must resume both (no train, no accumulate phase),
       cluster on DeviceBackend with the fused Phase B, launch kmer_hist
       once, each Phase B kernel once an iteration, the NW and Phase A
       kernels never, and write the same CLSTR;
     - the genome align-mode run under MESHCLUST_TRACE must write one
       trace that names the NW kernel and the kmer_hist kernel it ran, and
       the same CLSTR as without the trace;
     - Red (meshclust_tpu_torch.red, host numpy and C++) with -rpt and
       -msk on a ~13 Mbp genome of two chromosomes, one with N runs and
       one N-free run cut into three chunks: the native Viterbi must load,
       every k-mer count must equal an independent per-chunk np.bincount,
       and at least 0.9 of the planted motif bases and at most 0.05 of the
       background bases must be masked; each stage's wall is printed;
  6. ranks (parallel/dist.launch, one spawned process a rank): the 15k
     k-mer run at 2 ranks sharing the card (gloo) must write phase 4's
     CLSTR byte for byte, each rank launching kmer_hist once and
     pivot_order twice, the NW kernel as often as phase 4's run, the whole
     Phase A through the graphed chain (each of its five kernels CHUNK + 1
     times), and each Phase B kernel once an iteration on its block of the
     pool; each rank prints its device and
     backend, rows featurized, launches, featurize/train/accumulate/
     phase_b seconds and its collectives and bytes by site, and the wall
     is printed against phase 4's; the small corpus at 3 and 4 ranks and
     the short-read align-mode corpus at 2 ranks must write their single
     rank's CLSTR; with 2 or more GPUs, min(4, count) ranks over NCCL on
     the 15k corpus too; any failing rank fails the script;
  then print one JSON line per the contract (launches: the two main paths
  and the 2-rank run), the card line, and the final {"ok": true, ...} line.
"""
from __future__ import annotations

import contextlib
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
# phase 3: Phase A's kernels (csrc/phase_a.cu)
# ---------------------------------------------------------------------------

# The five of an iteration, in the order of its chain.
PHASE_A = ("pa_window", "pa_sums", "pa_absorb", "pa_move", "pa_next")
# The JAX code each Phase A kernel replaces
# (meshclust_tpu/core/accumulate_device.py; pa_next: the body of its
# lax.while_loop past the absorb and the move).
PHASE_A_REPLACES = {"pa_window": 173, "pa_sums": 237, "pa_absorb": 237,
                    "pa_move": 394, "pa_next": 87}
# Float64 operations of the classifier on one slot with the default singles
# (csrc/phase_a.cu:classify; a division or root counted as one), and one
# H100 SXM's float64 rate outside the tensor cores (NVIDIA's data sheet).
CLASSIFY_FP64_OPS = 100
FP64_OPS_PER_S = 34e12
# Centers of the profiled Phase A runs (of 150 at 15k and 1,500 at 150k).
PROFILE_CENTERS = 100
# pb_band's man and dot of int8 rows: per 32-bit word of a pair's two rows,
# one sum of the 4 bytes' absolute differences (the signed-byte
# vabsdiff4, the ALU pipe, INT32_OPS_PER_S) and one 4-way dot (IDP.4A, the
# FMA pipe), so the ALU's one bounds it; profile_port.py sass prints the
# staged block's opcodes (PERF.md). pb_dist's min sum: __vmins4 has no
# single instruction on sm_90a (pb_dist_kernelIaLi16E: 4 LOP3.LUT and a
# PRMT a word, then the IDP.4A), so five on the ALU.
BAND_ALU_OPS_PER_WORD = 1
DIST_ALU_OPS_PER_WORD = 5


@contextlib.contextmanager
def phase_a_steps(wrap):
    """ops/phase_a.steps patched so that each step bound to args runs as
    wrap(name, the bound step, args)."""
    import types
    from meshclust_tpu_torch.ops import phase_a as P
    steps = P.steps

    def binder(name, bind):
        return lambda *args: wrap(name, bind(*args), args)
    P.steps = lambda plain: types.SimpleNamespace(**{
        name: binder(name, getattr(steps(plain), name)) for name in P.STEPS})
    try:
        yield
    finally:
        P.steps = steps


@contextlib.contextmanager
def eager_chunks():
    """accumulate_device on one rank with its chunks launched step by step
    from the host, as on the plain path, in place of a CUDA graph's
    replays: the same kernels on the same state, so that the host can
    look between the steps."""
    from meshclust_tpu_torch.core import accumulate_device as A
    graph = A._Slots.graph
    A._Slots.graph = lambda self: self.chunk
    try:
        yield
    finally:
        A._Slots.graph = graph


def ranged(name, fn, prefix: str = "phase_a"):
    """fn inside the profiler range <prefix>.<name>."""
    import torch

    def call(*a, **kw):
        with torch.profiler.record_function(f"{prefix}.{name}"):
            return fn(*a, **kw)
    return call


def phase_a_inputs(dev, n: int) -> tuple:
    """(points, finalized bvec, model params) of the k-mer path's --id 0.90
    run on bench_corpus(n), from one run of it on dev."""
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.bvec import BVec
    from meshclust_tpu_torch.core.runner import run
    cfg = ClusterConfig(files=[bench_corpus(n)], similarity=0.90,
                        output=os.path.join(WORK, f"phase_a_{n}.clstr"))
    res = run(cfg, device=dev)
    ps = res["pointset"]
    bv = BVec(ps.lengths.copy(), cfg.finalize().bin_size)
    bv.bulk_insert(ps.lengths)
    bv.insert_finalize()
    return ps, bv, res["model"].params


def phase_a_run(ps, bv, params, plain: bool, cmax: int = 0) -> dict:
    """One Phase A on the card: wall s, iterations, centers, launches and
    the final slot state."""
    import torch
    from meshclust_tpu_torch import _ext
    from meshclust_tpu_torch.core.accumulate_device import accumulate_device
    from meshclust_tpu_torch.utils import perf
    perf.reset()
    _ext.reset_launches()
    state = {}
    torch.cuda.synchronize()
    t0 = time.time()
    accumulate_device(ps, bv, params, 0.90, cmax_hint=cmax, plain=plain,
                      state=state)
    torch.cuda.synchronize()
    c = perf.counters()
    return {"wall": time.time() - t0, "iters": c["accum_iters"],
            "centers": c["accum_centers"], "state": state,
            "replays": c["accum_replays"], "readbacks": c["accum_readbacks"],
            "launches": {k: _ext.launches[k] for k in PHASE_A}}


def phase_a_launches() -> dict:
    """The Phase A launches of one phase through the kernels: each kernel
    of the chain once before the capture and CHUNK times into it (the
    graph's replays launch no more)."""
    from meshclust_tpu_torch.core.accumulate_device import CHUNK
    return dict.fromkeys(PHASE_A, CHUNK + 1)


def window_bytes(act, table, last: int, live0: int, tail0: int) -> int:
    """The bytes pa_window must move for the center at slot `last` on the
    flags act (numpy bool) and its table (core/accumulate_device.
    window_ranges): the center's row (32 B), st read (3 slots) and written
    (4), and the flags (1 B) of each range its result depends on, from the
    range's start to its first live slot or from its last live slot to
    its end (the whole range where none is live). The first and last live
    slots are decided from live0 and tail0, st[LIVE] and st[TAIL] before
    the call (no live slot precedes or follows them)."""
    from meshclust_tpu_torch.ops import phase_a as P

    def scan(a, b, forward):
        """(the first or last live slot of [a, b) or -1, flags read)"""
        x = act[a:b] if forward else act[a:b][::-1]
        if b <= a or not x.any():
            return -1, max(0, b - a)
        i = int(x.argmax())
        return (a + i if forward else b - 1 - i), i + 1

    row = [int(v) for v in table[last]]
    _, flags = scan(live0, act.shape[0], True)
    tail, f = scan(0, tail0 + 1, False)
    flags += f
    nbytes = 8 * 7 + 4 * len(P.RANGES)
    hit, f = scan(row[P.GE], row[P.FRONT_END], True)
    flags += f
    if hit < 0:
        flags += scan(row[P.FRONT], row[P.GE], False)[1]
    for a, b, forward in ((P.EQ, P.GT, False), (P.GT, P.BACK_END, True),
                          (P.BACK, P.EQ, False)):
        hit, f = scan(row[a], row[b], forward)
        flags += f
        if hit >= 0:
            break
    if hit < 0 and tail >= 0:           # the truncation quirk
        nbytes += 4
        flags += scan(int(table[tail, P.BIN]), tail + 1, True)[1]
    return nbytes + flags


def phase_a_traffic(ps, bv, params, cmax: int = 0) -> tuple:
    """({kernel: bytes}, {kernel: seconds of operations at peak}) that the
    Phase A kernels must move and do, a launch, over a run of the kernel
    path on these inputs (cut at cmax centers if cmax > 0): each input
    read once, each output written once, counted from what the data made
    each launch do (a replay that reads back, after each step, the window,
    its live slots, the positives and the members); and, a launch, notes
    of the layouts' work: "pa_window (all flags)", the bytes of a pa_window
    that reads every slot's flag, and bin and len of the live ones;
    "members", a move's members; "member warps" and "member tiles", the
    32-slot and the 1,024-slot chunks of slots that hold them (a warp of 32
    slots served its members one by one in an earlier move kernel; a block
    of pa_move takes a tile); "first tile" and "last tile", the tiles of a
    move's least and greatest member, and "tiles", all of them (a scan of
    owners narrowed to the members' range would read last - first + 1 of
    them)."""
    import torch
    from meshclust_tpu_torch.core.accumulate_device import accumulate_device
    from meshclust_tpu_torch.ops import features as F
    from meshclust_tpu_torch.ops import phase_a as P
    N, V = ps.n, ps.V
    width = ps.hist_dev.element_size()
    K = 2 if {F.FEAT_PEARSON, F.FEAT_SIMRATIO} & set(params.singles) else 1
    nbytes = {k: 0.0 for k in PHASE_A}
    notes = dict.fromkeys(("pa_window (all flags)", "members",
                           "member warps", "member tiles", "first tile",
                           "last tile"), 0.0)
    tile = 2 * P.THREADS * P.OWNER_LOADS
    notes["tiles"] = float(P.owner_tiles(N))
    ops_s = {k: 0.0 for k in PHASE_A}
    calls = {k: 0 for k in PHASE_A}
    seen, tables = {}, {}

    def wrap(name, fn, a):
        st = a[0]

        def call():
            calls[f"pa_{name}"] += 1
            if int(st[P.DONE]):             # past the end: st[DONE] read
                nbytes[f"pa_{name}"] += 8
                return fn()
            if name == "window":
                last, live0, tail0 = st[[P.LAST, P.LIVE, P.TAIL]].tolist()
            npos, c = int(st[P.NPOS]), int(st[P.C])
            out = fn()
            if name == "window":
                active, ranges = a[1], a[2]
                if ranges.data_ptr() not in tables:
                    tables[ranges.data_ptr()] = ranges.cpu().numpy()
                act = active.cpu().numpy()
                w0, w1 = st[P.W0: P.W1 + 1].tolist()
                span = max(0, w1 - w0 + 1)
                win = int(act[w0: w1 + 1].sum()) if span else 0
                seen.update(span=span, win=win)
                nbytes["pa_window"] += window_bytes(
                    act, tables[ranges.data_ptr()], last, live0, tail0)
                notes["pa_window (all flags)"] += N + 16 * int(act.sum())
                # the window's active flags, its live rows and the center's,
                # their sums written
                nbytes["pa_sums"] += span + (win + 1) * V * width \
                    + 8 * K * win
                ops_s["pa_sums"] += 4.0 * win * V / DISPATCH_OPS_PER_S
            elif name == "absorb":
                span, win = seen["span"], seen["win"]
                npos = int(st[P.NPOS])
                # active; sums, mag, sq and length of the live window slots;
                # owner, stamp and active written and the row read of each
                # positive; sumvec read and written
                nbytes["pa_absorb"] += span + win * (8 * K + 24) \
                    + npos * (17 + V * width) + 16 * V
                ops_s["pa_absorb"] += win * CLASSIFY_FP64_OPS / FP64_OPS_PER_S
            elif name == "move" and not npos:
                nbytes["pa_move"] += 16     # st[DONE] and st[NPOS] read
            elif name == "move":
                members = torch.nonzero(a[1] == c).flatten()
                m = members.numel()
                notes["members"] += m
                for key, size in (("member warps", 32),
                                  ("member tiles", tile)):
                    notes[key] += torch.unique(members // size).numel()
                notes["first tile"] += int(members[0]) // tile
                notes["last tile"] += int(members[-1]) // tile
                # owner of every slot, each member's row, sumvec; each
                # member's mag and stamp read and distance written; st's
                # count read, center and two counters written
                nbytes["pa_move"] += 8 * N + m * V * width + 8 * V \
                    + 24 * m + 32
            elif name == "next":
                # st's eight slots read, ITERS and T written; where the
                # center ends its slot, MEMBERS and C; where one begins, the
                # seed's row read, sumvec written, its owner, stamp and
                # active and st's LAST and COUNT
                nbytes["pa_next"] += 80
                if not npos:
                    nbytes["pa_next"] += 24
                    if int(st[P.C]) == c + 1 and not int(st[P.DONE]):
                        nbytes["pa_next"] += V * width + 8 * V + 33
            return out
        return call

    with phase_a_steps(wrap), eager_chunks():
        accumulate_device(ps, bv, params, 0.90, cmax_hint=cmax, plain=False)
    n = {k: max(1, calls[k]) for k in PHASE_A}
    of = {"pa_window (all flags)": n["pa_window"], "tiles": 1}
    return ({k: nbytes[k] / n[k] for k in PHASE_A},
            {k: ops_s[k] / n[k] for k in PHASE_A},
            sum(nbytes.values()),
            {k: v / of.get(k, n["pa_move"]) for k, v in notes.items()})


def device_total_us(event) -> float:
    """Device time of a profiler range, its children's kernels included."""
    total = getattr(event, "device_time_total", None)
    return float(event.cuda_time_total if total is None else total)


def phase_a_device_ms(ps, bv, params, plain: bool, cmax: int) -> tuple:
    """(device ms a call of each step, device ms an iteration) of a Phase A
    cut at cmax centers under torch.profiler: on the kernel path each
    kernel's own time, on the plain path the device time of the step's
    range (its ops' kernels). A step that did not run gets 0. The kernel
    path's chunks are a CUDA graph's replays: the profiler reads its
    kernels from the device's events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from meshclust_tpu_torch.core.accumulate_device import accumulate_device
    from meshclust_tpu_torch.ops import phase_a as P
    from meshclust_tpu_torch.utils import perf
    perf.reset()
    torch.cuda.synchronize()
    with phase_a_steps(lambda name, fn, args: ranged(name, fn)), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        accumulate_device(ps, bv, params, 0.90, cmax_hint=cmax, plain=plain)
        torch.cuda.synchronize()
    iters = perf.counters()["accum_iters"]
    ka = prof.key_averages()
    out = {}
    for name in P.STEPS:
        if plain:
            evs = [e for e in prof.events() if e.name == f"phase_a.{name}"
                   and e.device_type == DeviceType.CPU]
            out[f"pa_{name}"] = (sum(device_total_us(e) for e in evs)
                                 / 1e3 / max(1, len(evs)))
        else:
            ks = [e for e in ka if e.device_type == DeviceType.CUDA
                  and f"pa_{name}_kernel" in e.key]
            out[f"pa_{name}"] = (sum(e.self_device_time_total for e in ks)
                                 / 1e3 / max(1, sum(e.count for e in ks)))
    # the ranges' own device-side annotations span their gaps: not counted
    dev_ms = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA
                 and not e.key.startswith("phase_a.")) / 1e3
    return out, dev_ms / iters


def phase_a_lockstep_errors(ps, bv, params, iters: int) -> dict:
    """Each Phase A kernel against its plain step on the same inputs, for
    the first `iters` iterations: both _Slots driven step by step as a
    chunk drives them, the max abs difference of every value the next step
    reads (state buffer with the loop's slots, owner, stamp, active,
    sumvec, center slots; sums of the window's live slots; members'
    distances), per kernel."""
    import torch
    from meshclust_tpu_torch.core import accumulate_device as A
    from meshclust_tpu_torch.ops import phase_a as P
    plain = A._Slots(ps, bv, params, 0.90, plain=True)
    kern = A._Slots(ps, bv, params, 0.90, plain=False)
    both, N = (plain, kern), plain.N
    err = {k: 0 for k in PHASE_A}

    def diff(name, *pairs):
        for a, b in pairs:
            err[name] = max(err[name], max_abs_err(
                a.to(torch.int64), b.to(torch.int64)))

    def state(name, *attrs):
        diff(name, (plain.st[: P.COUNT + 1], kern.st[: P.COUNT + 1]),
             (plain.st[P.DONE: P.T + 1], kern.st[P.DONE: P.T + 1]),
             *((getattr(plain, x), getattr(kern, x)) for x in attrs))

    for sl in both:
        sl.active[:1] = False
        sl.begin(0, 0, 0)
    done = 0
    while done < iters and not int(kern.st[P.DONE]):
        for sl in both:
            sl.window()
        state("pa_window")
        for sl in both:
            sl.sweep()
        w0, w1 = kern.st[P.W0: P.W1 + 1].tolist()
        live = torch.nonzero(kern.active[w0: w1 + 1]).flatten() + w0
        diff("pa_sums", (plain.sums[:, live], kern.sums[:, live]))
        for sl in both:
            sl.absorb_step()
        state("pa_absorb", "owner", "stamp", "active", "sumvec")
        moved = int(kern.st[P.NPOS]) > 0
        done += 1
        for sl in both:
            sl.move(None)
        if moved:
            members = torch.nonzero(kern.owner == kern.st[P.C]).flatten()
            diff("pa_move", (plain.dist[members], kern.dist[members]),
                 (plain.dist[N:], kern.dist[N:]))
        state("pa_move")
        diff("pa_move", (kern.st[P.TICKET: P.MOVE + 1],
                         torch.zeros_like(kern.st[P.TICKET: P.MOVE + 1])))
        for sl in both:
            sl.next_step()
        state("pa_next", "owner", "stamp", "active", "sumvec", "center_slot")
    return err


def phase_a_profile_child(paths: list) -> int:
    """The child process of check_phase_a: for each saved (points, bvec,
    params) file, the device ms of each Phase A step on both paths, then
    of each Phase B step (phase_b_device_ms); prints one JSON line {path:
    [kernel ms, plain ms, kernel ms an iteration, plain ms an iteration,
    Phase B's kernel ms, plain ms, kernel ms an iteration, plain ms an
    iteration]}. A process of its own, so that the smoke's later traced
    run starts with no earlier profiler session in its process."""
    import torch
    out = {}
    for path in paths:
        ps, bv, params = torch.load(path, weights_only=False)
        ms, dev_ms = phase_a_device_ms(ps, bv, params, False,
                                       PROFILE_CENTERS)
        plain_ms, plain_dev_ms = phase_a_device_ms(ps, bv, params, True,
                                                   PROFILE_CENTERS)
        pb = [phase_b_device_ms(ps, bv, params, plain)
              for plain in (False, True)]
        out[path] = [ms, plain_ms, dev_ms, plain_dev_ms,
                     pb[0][0], pb[1][0], pb[0][1], pb[1][1]]
    print(json.dumps(out), flush=True)
    return 0


def sums_case(rows, with_dot: bool, flush) -> dict:
    """pa_sums on rows [N, V] (any storage dtype; a column slice keeps its
    row stride) over the window [0, N - 1], every slot live, the center at
    slot 0: its sums against sums_plain's, its device ms with the L2
    flushed, and its bound (the rows and the active flags read once, the
    sums written once)."""
    import torch
    from meshclust_tpu_torch.ops import phase_a as P
    n, V = rows.shape
    st, _ = P.new_state(n, rows.device)
    st[P.W0], st[P.W1], st[P.LAST] = 0, n - 1, 0
    active = torch.ones(n, dtype=torch.bool, device=rows.device)
    k = 2 if with_dot else 1
    got = torch.full((k, n), -7, dtype=torch.int64, device=rows.device)
    P.sums(st, active, rows, got)
    want = torch.empty_like(got)
    P.sums_plain(st, active, rows.to(torch.int64), want)
    return {"max_abs_err": max_abs_err(got, want), "want": want,
            "ms": cold_ms(lambda: P.sums(st, active, rows, got), 10, flush),
            **bound(n + n * V * rows.element_size() + 8 * k * n,
                    4.0 * n * V / DISPATCH_OPS_PER_S)}


def sums_yardstick(rows, want, flush) -> tuple:
    """(ms with the L2 flushed, exact) of the PyTorch calls that compute
    pa_sums's two sums of rows[0] against every row: cdist (p = 1) and a
    matrix-vector product, on float32 copies made beforehand (exact while
    every partial is an integer below 2^24)."""
    import torch
    r32 = rows.to(torch.float32)
    c32 = r32[0].clone()

    def lib():
        return torch.cdist(c32[None], r32, p=1.0)[0], r32 @ c32
    man, dot = lib()
    exact = torch.equal(man.to(torch.int64), want[0]) and \
        torch.equal(dot.to(torch.int64), want[1])
    return cold_ms(lib, 10, flush), exact


def check_move(ps, bv, params, state, flush) -> dict:
    """pa_move on the largest center of a whole phase (state: its final
    owner and stamp in slot order), sumvec its members' rows summed and
    count their number: st[LAST] and the distances against move_plain's;
    its ms with the L2 flushed and warm, beside the yardstick: torch.cdist
    (p = 1) of the members' rows against cw (float32 copies gathered beforehand), then distance_d and
    argmin in float64 (argmin keeps the least slot among equal d, not the
    least stamp)."""
    import torch
    from meshclust_tpu_torch.core import accumulate_device as A
    from meshclust_tpu_torch.ops import phase_a as P
    from meshclust_tpu_torch.ops.classifier import mean_floor
    sl = A._Slots(ps, bv, params, 0.90, plain=False)
    n, dev = sl.N, sl.h.device
    owner = state["owner"]
    c = int(np.bincount(owner[owner >= 0]).argmax())
    own = torch.as_tensor(owner).to(dev)
    stamp = torch.as_tensor(state["stamp"]).to(dev)
    members = torch.nonzero(own == c).flatten()
    st, part = P.new_state(n, dev)
    st[P.COUNT], st[P.C], st[P.NPOS] = members.numel(), c, 1
    sumvec = sl.h[members].to(torch.int64).sum(0)
    got = torch.full((n + 1,), -7, dtype=torch.int64, device=dev)
    want = torch.zeros_like(got)
    st_p = st.clone()
    P.move(st, own, sl.h, sumvec, sl.mag, stamp, got, part)
    P.move_plain(st_p, own, sl.h, sumvec, sl.mag, stamp, want, part)
    at = torch.cat([members, members.new_tensor([n])])
    err = max(max_abs_err(got[at], want[at]),
              max_abs_err(st[: P.MOVE + 1], st_p[: P.MOVE + 1]))
    rows32 = sl.h[members].to(torch.float32)
    cw32 = mean_floor(sumvec, st[P.COUNT]).to(torch.float32)
    mass = rows32.sum(1).to(torch.float64) + cw32.sum().to(torch.float64)
    mag_cw = sl.mag[members] + cw32.sum().to(torch.float64)

    def lib():
        two_min = mass - torch.cdist(rows32, cw32[None], p=1.0)[:, 0]
        frac = two_min / mag_cw
        return torch.argmin(10000.0 * (1.0 - frac * frac))

    def kernel():
        P.move(st, own, sl.h, sumvec, sl.mag, stamp, got, part)
    tile = 2 * P.THREADS * P.OWNER_LOADS
    return {"members": members.numel(), "max_abs_err": err,
            "tiles": (int(members[0]) // tile, int(members[-1]) // tile,
                      P.owner_tiles(n)),
            "ms": cold_ms(kernel, 10, flush), "warm_ms": cuda_ms(kernel, 20),
            "library_ms": cold_ms(lib, 10, flush),
            "library_warm_ms": cuda_ms(lib, 20),
            "same": int(members[lib()]) == int(st_p[P.LAST])}


# pa_sums at HBM scale: 1,000,000 rows of 256 counts (a 1M-read corpus's
# rows at k = 4: 256 MB of int8, past the 50 MB L2), every slot live
PA_SUMS_ROWS = 1000000


def check_pa_sums(dev, rows_15k) -> float:
    """pa_sums against sums_plain on synthetic [PA_SUMS_ROWS, 256] rows
    (numpy seed 9, counts 0-127) as int8 with and without the dot, int16,
    int32, and an int8 column slice at an odd byte (single-byte
    pieces), each timed with the L2 flushed beside its bound and the
    int8 rows beside the PyTorch yardstick (cdist + matmul); then the 15k
    corpus's rows over a window of all its slots, whose yardstick ms is
    returned (pa_sums's library_ms)."""
    import torch
    flush = flush_l2(dev)
    rng = np.random.default_rng(9)
    rows8 = torch.from_numpy(rng.integers(
        0, 128, size=(PA_SUMS_ROWS, 256), dtype=np.int8)).to(dev)
    label = f"{PA_SUMS_ROWS} x 256"
    for name, rows, with_dot in (
            ("int8", rows8, True), ("int8 without the dot", rows8, False),
            ("int16", rows8.to(torch.int16), True),
            ("int32", rows8.to(torch.int32), True),
            ("int8 column slice [:, 1:129] (odd start)", rows8[:, 1:129],
             True)):
        r = sums_case(rows, with_dot, flush)
        line = (f"  pa_sums {label} {name}: {r['ms']:.5f} ms cold L2, bound "
                f"{r['bound_ms']:.5f} ms ({r['bound_by']}), "
                f"{r['bound_ms'] / r['ms']:.4f} of it, max abs err "
                f"{r['max_abs_err']}")
        if r["max_abs_err"]:
            fail(f"pa_sums differs from sums_plain on {label} {name}")
        if name == "int8":
            lib_ms, exact = sums_yardstick(rows, r["want"], flush)
            line += (f"; yardstick cdist + matmul {lib_ms:.5f} ms (exact "
                     f"{exact}), kernel {lib_ms / r['ms']:.2f}x faster")
        print(line, flush=True)
        del rows, r
        torch.cuda.empty_cache()
    del rows8
    torch.cuda.empty_cache()
    r = sums_case(rows_15k, True, flush)
    lib_ms, exact = sums_yardstick(rows_15k, r["want"], flush)
    print(f"  pa_sums 15k corpus rows {tuple(rows_15k.shape)} "
          f"{rows_15k.dtype}, a window of every slot: {r['ms']:.5f} ms cold "
          f"L2, bound {r['bound_ms']:.5f} ms, max abs err "
          f"{r['max_abs_err']}; yardstick cdist + matmul {lib_ms:.5f} ms "
          f"(exact {exact})", flush=True)
    if r["max_abs_err"]:
        fail("pa_sums differs from sums_plain on the 15k corpus's rows")
    return lib_ms


def check_phase_a(dev) -> list:
    """Phase A through its kernels against the plain steps on the 15k and
    150k corpora's Phase A inputs: each kernel step by step over the first
    iterations, then the whole phase (owner, stamp, center slots) bit for
    bit, timed in turns (plain, kernels, kernels, plain); then, in a child
    process, each kernel's device time and its plain step's under the
    profiler; pa_move on the largest center, timed beside its yardstick;
    and the bound. Returns the five kernels' rows (at 15k, the main path's
    shapes)."""
    import torch
    from meshclust_tpu_torch.core import accumulate_device as A
    from meshclust_tpu_torch.ops import phase_a as P
    found = {}
    for n in (15000, 150000):
        t0 = time.time()
        ps, bv, params = phase_a_inputs(dev, n)
        err = phase_a_lockstep_errors(ps, bv, params, 200)
        runs = [phase_a_run(ps, bv, params, plain)
                for plain in (True, False, False, True)]
        for r in runs[1:]:
            for key in ("owner", "stamp", "center_slot"):
                a, b = runs[0]["state"][key], r["state"][key]
                if a.shape != b.shape or not np.array_equal(a, b):
                    fail(f"Phase A at {n} reads: the kernels' {key} differs "
                         f"from the plain path's")
        if any(err.values()):
            fail(f"Phase A at {n} reads: a kernel differs from its plain "
                 f"step ({err})")
        iters, centers = runs[1]["iters"], runs[1]["centers"]
        launched = runs[1]["launches"]
        want = phase_a_launches()
        if launched != want:
            fail(f"Phase A at {n} reads launched {launched}, not {want}")
        per_launch, ops_s, total_bytes, notes = phase_a_traffic(ps, bv,
                                                                params)
        path = os.path.join(WORK, f"phase_a_inputs_{n}.pt")
        torch.save((ps, bv, params), path)
        k_it = [r["wall"] * 1e3 / iters for r in runs[1:3]]
        p_it = [r["wall"] * 1e3 / iters for r in (runs[0], runs[3])]
        print(f"  Phase A at {n} reads (k-mer path --id 0.90, "
              f"{ps.hist_dev.dtype} rows, V = {ps.V}): {iters:.0f} absorb "
              f"iterations, {centers:.0f} centers; owner, stamp and center "
              f"slots bit-equal to the plain path; each kernel bit-equal to "
              f"its plain step over the first 200 iterations", flush=True)
        print(f"    accumulate_device wall s, in turns: plain "
              f"{runs[0]['wall']:.4f}, kernels {runs[1]['wall']:.4f}, "
              f"kernels {runs[2]['wall']:.4f}, plain {runs[3]['wall']:.4f}; "
              f"ms an iteration: kernels {k_it[0]:.4f}-{k_it[1]:.4f}, plain "
              f"{p_it[0]:.4f}-{p_it[1]:.4f}; {runs[1]['replays']:.0f} "
              f"replays of {len(PHASE_A)} x {A.CHUNK} launches, "
              f"{runs[1]['readbacks']:.0f} readbacks; bound "
              f"{total_bytes / iters / HBM_BYTES_PER_S * 1e3:.5f} ms an "
              f"iteration ({total_bytes / iters:.0f} B at "
              f"{HBM_BYTES_PER_S:.3g} B/s) (took {time.time() - t0:.1f} s, "
              f"its inputs' run included)", flush=True)
        mv = check_move(ps, bv, params, runs[1]["state"], flush_l2(dev))
        print(f"    pa_move on the largest center ({mv['members']} members, "
              f"tiles {mv['tiles'][0]}-{mv['tiles'][1]} of "
              f"{mv['tiles'][2]}): {mv['ms']:.5f} ms L2 flushed, "
              f"{mv['warm_ms']:.5f} warm, max abs err {mv['max_abs_err']}; "
              f"yardstick cdist + argmin {mv['library_ms']:.5f} ms L2 flushed, "
              f"{mv['library_warm_ms']:.5f} warm (the same member "
              f"{mv['same']})", flush=True)
        if mv["max_abs_err"]:
            fail(f"pa_move differs from move_plain at {n} reads")
        b = bound(per_launch["pa_move"], ops_s["pa_move"])
        span = notes["last tile"] - notes["first tile"] + 1
        print(f"    pa_window's bound counted as PR 8's kernel read: "
              f"{notes['pa_window (all flags)']:.0f} B a launch (every "
              f"flag, bin and len of the live slots), against "
              f"{per_launch['pa_window']:.0f} B it must read; a move: "
              f"{notes['members']:.2f} members in {notes['member warps']:.2f}"
              f" warps of 32 slots and {notes['member tiles']:.2f} tiles of "
              f"{2 * P.THREADS * P.OWNER_LOADS}, its least member in tile "
              f"{notes['first tile']:.2f} and its greatest in tile "
              f"{notes['last tile']:.2f} on average, of "
              f"{notes['tiles']:.0f} tiles (a scan narrowed to the members' "
              f"range would read {span:.2f}); pa_move's bound {b['bound_ms']:.6g} ms a launch "
              f"({per_launch['pa_move']:.0f} B)", flush=True)
        INPUTS[n] = path
        found[n] = (path, err, per_launch, ops_s, mv["library_ms"])
        if n == 15000:
            sums_lib_ms = check_pa_sums(dev, ps.hist_dev)
    t0 = time.time()
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phase-a-profile",
         *(found[n][0] for n in found)], capture_output=True, text=True,
        timeout=600, cwd=ROOT)
    if child.returncode != 0:
        fail(f"the Phase A profile failed:\n{child.stderr[-3000:]}")
    timed_ = json.loads(child.stdout.strip().splitlines()[-1])
    PROFILED.update({n: timed_[found[n][0]] for n in found})
    rows = None
    for n, (path, err, per_launch, ops_s, move_lib_ms) in found.items():
        ms, plain_ms, dev_ms, plain_dev_ms = timed_[path][:4]
        print(f"  Phase A at {n} reads under the profiler (first "
              f"{PROFILE_CENTERS} centers, a child process, "
              f"{time.time() - t0:.1f} s for both corpora): device ms an "
              f"iteration: kernels {dev_ms:.5f}, plain {plain_dev_ms:.5f}",
              flush=True)
        for k in PHASE_A:
            b = bound(per_launch[k], ops_s[k])
            print(f"    {k}: {ms[k]:.5f} ms a launch (plain step "
                  f"{plain_ms[k]:.5f} ms), bound {b['bound_ms']:.6g} ms "
                  f"({b['bound_by']}, {per_launch[k]:.0f} B a launch), "
                  f"{b['bound_ms'] / ms[k] if ms[k] else 0.0:.4g} of it, "
                  f"max abs err {err[k]}", flush=True)
        if rows is None:
            # pa_sums's yardstick: cdist + matmul on float32 copies of the
            # 15k rows (check_pa_sums); pa_move's: cdist + argmin
            # (check_move). No PyTorch call computes the other kernels'
            # functions: their library_ms is null.
            lib_ms = {"pa_sums": sums_lib_ms, "pa_move": move_lib_ms}
            rows = [{"name": k, "route": "cuda",
                     "source": "meshclust_tpu_torch/csrc/phase_a.cu",
                     "replaces": "meshclust_tpu/core/accumulate_device.py:"
                                 f"{PHASE_A_REPLACES[k]}",
                     "ms": ms[k], "plain_ms": plain_ms[k],
                     "library_ms": lib_ms.get(k),
                     "max_abs_err": err[k],
                     **bound(per_launch[k], ops_s[k])} for k in PHASE_A]
    return rows


# ---------------------------------------------------------------------------
# phase 3: Phase B's kernels (csrc/phase_b.cu)
# ---------------------------------------------------------------------------

PHASE_B = ("pb_band", "pb_dist", "pb_pick", "pb_merge")
# The JAX code each Phase B kernel replaces (meshclust_tpu/core/
# classify.py:_build_phaseb: cls_body, dist_body, pos_body, the move and
# the merge).
PHASE_B_REPLACES = {"pb_band": 644, "pb_dist": 680, "pb_pick": 727,
                    "pb_merge": 742}
# Phase B's settings on the main path (ClusterConfig's defaults).
PB_DELTA, PB_ITERS = 5, 15
# check_phase_a's saved (points, bvec, params) files and its child's
# profile, by corpus size
INPUTS = {}
PROFILED = {}


@contextlib.contextmanager
def phase_b_steps(wrap):
    """ops/phase_b.steps patched so that each step runs as wrap(name, fn)."""
    import types
    from meshclust_tpu_torch.ops import phase_b as PB
    steps = PB.steps
    PB.steps = lambda plain: types.SimpleNamespace(**{
        name: wrap(name, getattr(steps(plain), name)) for name in PB.STEPS})
    try:
        yield
    finally:
        PB.steps = steps


def phase_b_inputs(ps, bv, params) -> tuple:
    """Phase A's centers of a run's points as run_phase_b_device hands them
    to phase_b_loop: (backend, members, assign, center rows)."""
    from meshclust_tpu_torch.core.accumulate_device import accumulate_device
    from meshclust_tpu_torch.core.classify import DeviceBackend
    centers = accumulate_device(ps, bv, params, 0.90)
    members = np.asarray([m for c in centers for m in c.members], np.int64)
    assign = np.repeat(np.arange(len(centers)),
                       [len(c.members) for c in centers])
    rows = np.asarray([c.center for c in centers], np.int64)
    return DeviceBackend(ps, params), members, assign, rows


def split_centers(members, assign, rows) -> tuple:
    """A Phase B input that merges, from Phase A's centers as
    phase_b_inputs gives them (members grouped by center, in order): each
    center with at least 2 members split into two adjacent centers, the
    second's row the pool's middle member and the second half of the pool
    assigned to it. Both halves are one species at ~94% identity, so most
    pairs merge in the first iteration. -> (members, assign, center rows)."""
    starts = np.flatnonzero(np.r_[True, assign[1:] != assign[:-1]])
    ends = np.r_[starts[1:], assign.shape[0]]
    new_assign = np.empty_like(assign)
    new_rows = []
    for s, e in zip(starts, ends):
        new_rows.append(rows[assign[s]])
        new_assign[s:e] = len(new_rows) - 1
        if e - s >= 2:
            new_rows.append(members[s + (e - s) // 2])
            new_assign[s + (e - s) // 2:e] = len(new_rows) - 1
    return members, new_assign, np.asarray(new_rows, np.int64)


def phase_b_device_ms(ps, bv, params, plain: bool,
                      split: bool = False) -> tuple:
    """(device ms a call of each step, device ms an iteration) of the
    fused Phase B under torch.profiler, as phase_a_device_ms takes them
    (with split, on split_centers' input)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    be, members, assign, rows = phase_b_inputs(ps, bv, params)
    if split:
        members, assign, rows = split_centers(members, assign, rows)
    torch.cuda.synchronize()
    with phase_b_steps(lambda n, f: ranged(n, f, "phase_b")), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        be.phase_b_loop(members, assign, rows, PB_DELTA, PB_ITERS,
                        plain=plain)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    out = {}
    for k in PHASE_B:
        name = k[3:]
        if plain:
            evs = [e for e in prof.events() if e.name == f"phase_b.{name}"
                   and e.device_type == DeviceType.CPU]
            out[k] = (sum(device_total_us(e) for e in evs) / 1e3
                      / max(1, len(evs)))
        else:
            ks = [e for e in ka if e.device_type == DeviceType.CUDA
                  and f"{k}_kernel" in e.key]
            out[k] = (sum(e.self_device_time_total for e in ks) / 1e3
                      / max(1, sum(e.count for e in ks)))
    dev_ms = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA
                 and not e.key.startswith("phase_b.")) / 1e3
    return out, dev_ms / PB_ITERS


def phase_b_lockstep(be, members, assign, rows) -> tuple:
    """Each Phase B kernel against its plain step on the same inputs over
    PB_ITERS iterations, both States driven as phase_b_loop drives them:
    the max abs difference of every value the next step reads (float64 as
    bit patterns), per kernel; and the bytes each launch must move and the
    seconds its float64 classifier takes at the card's rate, averaged over
    the launches, from this run's data (see phase_b_traffic); and the
    tiles pb_band and pb_dist ran on each path over the iterations
    ({PB.PATHS: count})."""
    import torch
    from meshclust_tpu_torch.ops import phase_b as PB
    both = [be._phase_b_state(members, assign, rows, PB_DELTA, PB_ITERS)
            for _ in range(2)]
    steps = (PB.steps(True), PB.steps(False))
    err = dict.fromkeys(PHASE_B, 0)
    nbytes = dict.fromkeys(PHASE_B, 0.0)
    ops_s = dict.fromkeys(PHASE_B, 0.0)

    def diff(name, *attrs):
        for x in attrs:
            a, b = (getattr(s, x) for s in both)
            if a.dtype == torch.float64:
                a, b = a.view(torch.int64), b.view(torch.int64)
            err[name] = max(err[name], max_abs_err(a.to(torch.int64),
                                                   b.to(torch.int64)))

    def run(name, *args):
        for s, step in zip(both, steps):
            getattr(step, name)(s, *args)

    for it in range(PB_ITERS):
        traffic = phase_b_traffic(both[1])
        run("band")
        diff("pb_band", "assign", "bits", "sc", "best_d", "best_pos")
        traffic.update(phase_b_traffic(both[1], banded=True))
        run("dist")
        diff("pb_dist", "dstore", "best_d")
        run("pick")
        diff("pb_pick", "best_pos", "sc")
        run("merge", it)
        diff("pb_merge", "c_idx", "c_valid", "remap")
        err["pb_merge"] = max(err["pb_merge"], max_abs_err(
            both[0].t_hist[it], both[1].t_hist[it]))
        for k, (b, o) in traffic.items():
            nbytes[k] += b / PB_ITERS
            ops_s[k] += o / PB_ITERS
    return err, nbytes, ops_s, dict(zip(PB.PATHS, both[1].paths.tolist()))


def phase_b_traffic(pb, banded: bool = False) -> dict:
    """{kernel: (bytes its launch must move, seconds of its operations at
    the card's peak)} for the iteration pb is at: before the band (banded
    False) pb_band's and pb_merge's, which depend on assign and c_valid
    (pb_merge's on the move, bounded by every valid center's row); after
    it pb_dist's and pb_pick's, which depend on the positives. Each input
    read once, each output written once: the members' rows (pb_dist: of
    the members with a positive), each valid center's row, 8 B a member of
    m_idx, assign (read and written by pb_band), remap and dstore (a
    positive's d), 24 B of mag, sq and len a member and a center, the bits
    (4 B a word), sc's rows (written by pb_band and zeroed by pb_pick: the
    centers with a positive; read by pb_dist), and 8-25 B a center of
    c_idx, c_valid, best_d, best_pos, t_hist and remap. The operations:
    pb_band's and pb_merge's classifier (CLASSIFY_FP64_OPS a pair at the
    float64 rate) and pb_band's man and dot (BAND_ALU_OPS_PER_WORD a word of
    a pair's rows on the ALU pipe), whichever takes longer; pb_dist's min
    sums (DIST_ALU_OPS_PER_WORD a word of a positive's rows)."""
    import torch
    M, V = pb.rows.shape
    C = pb.c_idx.shape[0]
    w = pb.rows.element_size()
    words = pb.bits.shape[1]
    row = V * w
    if not banded:
        a = pb.remap[pb.assign]
        valid = int(pb.c_valid.sum())
        ok = 0
        for o in range(-pb.delta, pb.delta + 1):
            j = a + o
            ok += int(((j >= 0) & (j < C)
                       & pb.c_valid[j.clamp(0, C - 1)]).sum())
        merge_pairs = 0
        idx = torch.arange(C, device=a.device)
        for o in range(1, pb.delta + 1):
            j = idx + o
            merge_pairs += int((pb.c_valid & (j < C)
                                & pb.c_valid[j.clamp(max=C - 1)]).sum())
        fp64 = CLASSIFY_FP64_OPS / FP64_OPS_PER_S
        alu = ok * (row / 4) * BAND_ALU_OPS_PER_WORD / INT32_OPS_PER_S
        return {"pb_band": (M * (row + 8 + 24 + 24 + 4 * words)
                            + valid * (row + 24) + C * (8 + 1 + 16 + 8),
                            max(ok * fp64, alu)),
                "pb_merge": (valid * (row + 24 + 8) + C * (8 + 8 + 1 + 8 + 8
                                                           + 9),
                             merge_pairs * fp64)}
    bits = pb.bits.to(torch.int64) & 0xFFFFFFFF
    per_member = torch.zeros(M, dtype=torch.int64, device=bits.device)
    for b in range(32):
        per_member += ((bits >> b) & 1).sum(1)
    pos = int(per_member.sum())
    with_pos = int((per_member > 0).sum())
    centers = int((pb.sc[:, V] > 0).sum())
    sc_row = (V + 1) * 8
    return {"pb_dist": (with_pos * (row + 16) + centers * sc_row
                        + M * (8 + 4 * words) + pos * 8 + C * 8,
                        pos * (row / 4) * DIST_ALU_OPS_PER_WORD
                        / INT32_OPS_PER_S),
            "pb_pick": (M * (8 + 4 * words) + pos * 8 + C * 16
                        + centers * sc_row, 0.0)}


def band_yardstick(pb) -> float:
    """The library call that computes pb_band's sums: index_add_ of the
    positive rows (gathered beforehand as int64) into [C, V] int64, warm,
    after a band on pb."""
    import torch
    V = pb.rows.shape[1]
    bits = pb.bits.to(torch.int64) & 0xFFFFFFFF
    ms, js = [], []
    for oi in range(2 * pb.delta + 1):
        m = torch.nonzero((bits[:, oi // 32] >> (oi % 32)) & 1).flatten()
        ms.append(m)
        js.append(pb.assign[m] + oi - pb.delta)
    m, j = torch.cat(ms), torch.cat(js)
    rows = pb.rows[m].to(torch.int64)
    out = torch.zeros((pb.c_idx.shape[0], V), dtype=torch.int64,
                      device=rows.device)
    return cuda_ms(lambda: out.index_add_(0, j, rows), 20)


def pick_yardstick(pb) -> float:
    """The library call that computes pb_pick's function: one
    scatter_reduce_ (amin) of the ties' pool positions (the positives
    whose d is their center's least, gathered beforehand) into best_pos,
    warm, after a band and a dist on pb."""
    import torch
    bits = pb.bits.to(torch.int64) & 0xFFFFFFFF
    ps, js = [], []
    for oi in range(2 * pb.delta + 1):
        m = torch.nonzero((bits[:, oi // 32] >> (oi % 32)) & 1).flatten()
        j = pb.assign[m] + oi - pb.delta
        tie = pb.dstore[oi, m] == pb.best_d[j]
        ps.append(pb.goff + m[tie])
        js.append(j[tie])
    pos, j = torch.cat(ps), torch.cat(js)
    out = torch.full_like(pb.best_pos, pb.m_all.shape[0])
    return cuda_ms(lambda: out.scatter_reduce_(0, j, pos, reduce="amin"), 20)


def check_phase_b(dev) -> list:
    """The fused Phase B through its kernels against the plain steps on
    the 15k and 150k corpora's Phase A centers (check_phase_a's inputs):
    each kernel step by step over the 15 iterations, then the whole
    phase_b_loop (assign, centers, valid, t_hist) in turns (plain, kernels,
    kernels, plain) with walls, launches an iteration and the bound; each
    kernel's device time and its plain step's from check_phase_a's profile
    child. The same checks, untimed, on the 15k centers split in two
    (split_centers), whose merges must happen. Returns the four kernels'
    rows (at 15k, the main path's shapes)."""
    import torch
    from meshclust_tpu_torch import _ext
    rows_out = None
    cases = [(n, path, False) for n, path in sorted(INPUTS.items())]
    cases.insert(1, (min(INPUTS), INPUTS[min(INPUTS)], True))
    for n, path, split in cases:
        t0 = time.time()
        ps, bv, params = torch.load(path, weights_only=False)
        be, members, assign, rows = phase_b_inputs(ps, bv, params)
        if split:
            members, assign, rows = split_centers(members, assign, rows)
        err, per_launch, ops_s, paths = phase_b_lockstep(be, members, assign,
                                                         rows)
        runs = []
        for plain in (True, False, False, True):
            _ext.reset_launches()
            torch.cuda.synchronize()
            t1 = time.time()
            out = be.phase_b_loop(members, assign, rows, PB_DELTA, PB_ITERS,
                                  plain=plain)
            torch.cuda.synchronize()
            runs.append((out, time.time() - t1,
                         {k: _ext.launches[k] for k in PHASE_B}))
        label = f"{n} reads" + (", centers split" if split else "")
        for out, _, launched in runs:
            for a, b in zip(out, runs[0][0]):
                if a.shape != b.shape or not np.array_equal(a, b):
                    fail(f"Phase B at {label}: the kernels' loop differs "
                         f"from the plain steps' (assign, centers, valid or "
                         f"t_hist)")
        want = dict.fromkeys(PHASE_B, PB_ITERS)
        for i, (_, _, launched) in enumerate(runs):
            if launched != (want if i in (1, 2) else dict.fromkeys(PHASE_B,
                                                                   0)):
                fail(f"Phase B at {label} launched {launched} (run {i})")
        if any(err.values()):
            fail(f"Phase B at {label}: a kernel differs from its plain "
                 f"step ({err})")
        merged = int((runs[1][0][3] != np.arange(rows.shape[0])).sum())
        if split:
            # the merging input: no timing, but its merges must happen
            print(f"  Phase B at {label} (--delta {PB_DELTA}, {PB_ITERS} "
                  f"iterations): {members.shape[0]} members, "
                  f"{rows.shape[0]} centers, {merged} merge targets over "
                  f"the iterations, {int(runs[1][0][2].sum())} kept; "
                  f"assign, centers, valid and t_hist bit-equal to the "
                  f"plain steps'; each kernel bit-equal to its plain step "
                  f"over all iterations (took {time.time() - t0:.1f} s)",
                  flush=True)
            if merged == 0:
                fail(f"Phase B at {label}: no center merged")
            continue
        pb = be._phase_b_state(members, assign, rows, PB_DELTA, 0)
        from meshclust_tpu_torch.ops import phase_b as PB
        PB.band(pb)
        lib_ms = band_yardstick(pb)
        PB.dist(pb)
        pick_lib_ms = pick_yardstick(pb)
        walls = [r[1] * 1e3 / PB_ITERS for r in runs]
        total = sum(per_launch.values())
        print(f"  Phase B at {n} reads (--delta {PB_DELTA}, {PB_ITERS} "
              f"iterations, {ps.hist_dev.dtype} rows, V = {ps.V}): "
              f"{members.shape[0]} members, {rows.shape[0]} centers, "
              f"{merged} merge targets over the iterations, "
              f"{int(runs[1][0][2].sum())} kept; assign, centers, valid and "
              f"t_hist bit-equal to the plain steps'; each kernel bit-equal "
              f"to its plain step over all iterations", flush=True)
        print(f"    phase_b_loop wall ms an iteration, in turns: plain "
              f"{walls[0]:.4f}, kernels {walls[1]:.4f}, kernels "
              f"{walls[2]:.4f}, plain {walls[3]:.4f}; Phase B launches an "
              f"iteration {sum(runs[1][2].values()) / PB_ITERS:.4f} "
              f"({runs[1][2]}); bound {total / HBM_BYTES_PER_S * 1e3:.5f} "
              f"ms an iteration ({total:.0f} B at {HBM_BYTES_PER_S:.3g} "
              f"B/s) (took {time.time() - t0:.1f} s)", flush=True)
        ms, plain_ms, dev_ms, plain_dev_ms = PROFILED[n][4:8]
        print(f"  Phase B at {n} reads under the profiler: device ms an "
              f"iteration: kernels {dev_ms:.5f}, plain {plain_dev_ms:.5f}; "
              f"pb_band's sums as one index_add_ of the positive rows "
              f"(gathered beforehand) {lib_ms:.5f} ms warm; pb_pick's as "
              f"one scatter_reduce_ (amin) of the ties' pool positions "
              f"{pick_lib_ms:.5f} ms warm; tiles over the {PB_ITERS} "
              f"iterations by path: {paths}", flush=True)
        if paths["band_staged"] == 0 or paths["dist_staged"] == 0:
            fail(f"Phase B at {n} reads: no tile of pb_band or pb_dist "
                 f"staged its span ({paths})")
        for k in PHASE_B:
            b = bound(per_launch[k], ops_s[k])
            print(f"    {k}: {ms[k]:.5f} ms a launch (plain step "
                  f"{plain_ms[k]:.5f} ms), bound {b['bound_ms']:.6g} ms "
                  f"({b['bound_by']}, {per_launch[k]:.0f} B a launch), "
                  f"{b['bound_ms'] / ms[k] if ms[k] else 0.0:.4g} of it, "
                  f"max abs err {err[k]}", flush=True)
        if rows_out is None:
            # pb_band's yardstick: index_add_ of its positive rows;
            # pb_pick's: scatter_reduce_ of its ties' positions; no PyTorch
            # call computes pb_dist's or pb_merge's function
            library = {"pb_band": lib_ms, "pb_pick": pick_lib_ms}
            rows_out = [{"name": k, "route": "cuda",
                         "source": "meshclust_tpu_torch/csrc/phase_b.cu",
                         "replaces": "meshclust_tpu/core/classify.py:"
                                     f"{PHASE_B_REPLACES[k]}",
                         "ms": ms[k], "plain_ms": plain_ms[k],
                         "library_ms": library.get(k),
                         "max_abs_err": err[k],
                         **bound(per_launch[k], ops_s[k])} for k in PHASE_B]
    return rows_out


def check_pivot_order(dev) -> dict:
    """The pivot-order kernel (csrc/pivot_order.cu) against the host chain
    it replaces (ops/pivot_order.orders_plain: exact device Manhattan rows,
    float64 keys on the host, libstdc++'s std::sort a row) on the 15k and
    150k k-mer corpora: Trainer._ref_order_chain's begin row and its 150
    pivot rows (the default --sample and --pivots), bit-equal; the whole
    chain (two launches or the host chain, and the readback) in turns
    (plain, kernel, kernel, plain); the kernel's device ms a launch by CUDA
    events beside its bound: the histogram's rows read once, the orders
    written (bytes), or an abs-add a row element and log2(n) compares a
    point a row at the dispatch rate (operations). Returns the kernel's row
    at 15k (the main path's shapes)."""
    import torch
    from meshclust_tpu_torch import _ext, native
    from meshclust_tpu_torch.core.points import build_points
    from meshclust_tpu_torch.io import fasta as fio
    from meshclust_tpu_torch.ops import histogram as H
    from meshclust_tpu_torch.ops import pivot_order as PO
    row = None
    for n in (15000, 150000):
        t0 = time.time()
        per = [fio.read_fasta(bench_corpus(n=n))]
        ps = build_points(per[0], H.find_k(per), dev)
        perm = np.arange(ps.n, dtype=np.int32)
        native.ref_sort_perm(perm, np.asarray(ps.lengths, np.int64))
        perm_t = torch.from_numpy(perm).to(dev)
        begin_pt = int(perm[ps.n // 2])
        slots = torch.as_tensor([i * (ps.n - 1) // 149 for i in range(150)],
                                device=dev)
        heaps = torch.zeros(1, dtype=torch.int32, device=dev)

        def chain(fn):
            kw = {"heaps": heaps} if fn is PO.orders else {}
            begin = fn(ps, [begin_pt], perm_t, **kw)[0]
            rows = begin[slots].to(torch.int64)
            return rows, PO.to_host(fn(ps, rows, begin, **kw))

        runs = []
        for fn in (PO.orders_plain, PO.orders, PO.orders, PO.orders_plain):
            _ext.reset_launches()
            heaps.zero_()
            torch.cuda.synchronize()
            t1 = time.time()
            rows, out = chain(fn)
            runs.append((rows.cpu(), out, (time.time() - t1) * 1e3,
                         _ext.launches["pivot_order"], int(heaps.item())))
        wrong = sum(int((r[1] != runs[0][1]).sum()) for r in runs)
        if wrong or any(not torch.equal(r[0], runs[0][0]) for r in runs):
            fail(f"pivot orders at {n} reads: the kernel's differ from the "
                 f"host chain's ({wrong} entries)")
        if [r[3] for r in runs] != [0, 2, 2, 0]:
            fail(f"pivot orders at {n} reads launched "
                 f"{[r[3] for r in runs]} times")
        rows = runs[0][0].to(dev)
        one_ms = cuda_ms(lambda: PO.orders(ps, [begin_pt], perm_t), 5)
        many_ms = cuda_ms(lambda: PO.orders(ps, rows, perm_t), 5)
        V, width = ps.hist_dev.shape[1], ps.hist_dev.element_size()
        P = rows.shape[0]
        b = bound(ps.n * V * width + P * ps.n * 4 + ps.n * 4,
                  P * ps.n * (V + int(np.ceil(np.log2(ps.n))))
                  / DISPATCH_OPS_PER_S)
        scratch = _ext.lib().mc_pivot_order_scratch(ps.n)
        where = (f"global scratch, {scratch} B a row" if scratch
                 else "shared memory")
        walls = [r[2] for r in runs]
        print(f"  pivot orders at {ps.n} reads ({ps.hist_dev.dtype} rows, V "
              f"= {V}, workspace in {where}): begin row + {P} pivot rows "
              f"bit-equal to the host chain; "
              f"chain wall ms in turns: plain {walls[0]:.3f}, kernel "
              f"{walls[1]:.3f}, kernel {walls[2]:.3f}, plain {walls[3]:.3f}; "
              f"heap ranges {runs[1][4]}; kernel device ms a launch: 1 row "
              f"{one_ms:.4f}, {P} rows {many_ms:.4f}; bound "
              f"{b['bound_ms']:.5f} ms ({b['bound_by']}), "
              f"{b['bound_ms'] / many_ms:.4g} of it (took "
              f"{time.time() - t0:.1f} s)", flush=True)
        if row is None:
            row = {"name": "pivot_order", "route": "cuda",
                   "source": "meshclust_tpu_torch/csrc/pivot_order.cu",
                   "replaces": "none (the host chain of "
                               "meshclust_tpu/core/trainer.py:157)",
                   "ms": many_ms, "plain_ms": (walls[0] + walls[3]) / 2,
                   "library_ms": None, "max_abs_err": wrong, **b}
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


WALLS = {}      # label -> wall seconds of drive()'s run


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
    WALLS[label] = wall
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


def spy_fused_phase_b():
    """Patch MeanShift.run_phase_b_device to record, per call, whether the
    fused Phase B's result was kept; -> (record list, undo)."""
    from meshclust_tpu_torch.core.meanshift import MeanShift
    kept_calls = []
    run_phase_b = MeanShift.run_phase_b_device

    def spy(self, centers):
        kept = run_phase_b(self, centers)
        kept_calls.append(kept is not None)
        return kept

    MeanShift.run_phase_b_device = spy

    def undo():
        MeanShift.run_phase_b_device = run_phase_b
    return kept_calls, undo


def spy_phase_b_plain():
    """Count the calls of ops/phase_b's plain steps (the wrappers call them
    for CPU tensors only); -> (counts by step, undo)."""
    from meshclust_tpu_torch.ops import phase_b as PB
    calls = dict.fromkeys(PB.STEPS, 0)
    saved = {name: getattr(PB, f"{name}_plain") for name in PB.STEPS}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    for name, fn in saved.items():
        setattr(PB, f"{name}_plain", counted(name, fn))

    def undo():
        for name, fn in saved.items():
            setattr(PB, f"{name}_plain", fn)
    return calls, undo


def main_path(dev) -> dict:
    """The k-mer path on the device, then the same corpus with exact=True
    (the float64 host classifier and the host Phase A and B): the two
    CLSTR files must be byte-equal."""
    from meshclust_tpu_torch import native
    from meshclust_tpu_torch.core.classify import DeviceBackend, HostBackend
    from meshclust_tpu_torch.utils import perf
    out = os.path.join(WORK, "smoke_15k.clstr")
    fused, undo = spy_fused_phase_b()
    plain_calls, undo_plain = spy_phase_b_plain()
    try:
        res, launches = drive(dev, "k-mer path --id 0.90", bench_corpus(),
                              out, similarity=0.90)
    finally:
        undo()
        undo_plain()
    phases, counters = perf.phases(), perf.counters()
    expect_launches("k-mer", launches)
    if native.get_lib() is None or native.get_refsort() is None:
        fail("the native fasta_parser or refsort library did not load")
    if not isinstance(res["backend"], DeviceBackend):
        fail(f"the k-mer run clustered on {type(res['backend']).__name__}, "
             f"not DeviceBackend")
    if counters.get("accum_centers", 0) <= 0:
        fail("device Phase A did not run in the k-mer run")
    if fused != [True]:
        fail(f"the fused Phase B fell back to the host or did not run "
             f"(kept per call: {fused})")
    want = phase_a_launches()
    if {k: launches[k] for k in PHASE_A} != want:
        fail(f"the k-mer run's Phase A kernels launched "
             f"{ {k: launches[k] for k in PHASE_A} }, not {want} (the "
             f"chain's five kernels once before the capture and once an "
             f"iteration into it)")
    if counters["accum_device_iters"] != counters["accum_iters"] or \
            counters["accum_readbacks"] != counters["accum_replays"] + 1:
        fail(f"the k-mer run's Phase A was not driven by the card: "
             f"{counters['accum_device_iters']:.0f} of "
             f"{counters['accum_iters']:.0f} iterations, "
             f"{counters['accum_readbacks']:.0f} readbacks in "
             f"{counters['accum_replays']:.0f} replays")
    if {k: launches[k] for k in PHASE_B} != dict.fromkeys(PHASE_B,
                                                           PB_ITERS):
        fail(f"the k-mer run's Phase B kernels launched "
             f"{ {k: launches[k] for k in PHASE_B} }, not "
             f"{PB_ITERS} each (one an iteration)")
    if any(plain_calls.values()):
        fail(f"the k-mer run took Phase B's plain steps on the card "
             f"({plain_calls})")
    if launches["pivot_order"] != 2 or counters.get("pivot_rows") != 151:
        fail(f"the k-mer run's training launched pivot_order "
             f"{launches['pivot_order']} times for "
             f"{counters.get('pivot_rows')} rows, not twice for 151")
    print(f"  Phase B: {sum(launches[k] for k in PHASE_B) / PB_ITERS:.2f} "
          f"launches an iteration ({ {k: launches[k] for k in PHASE_B} }), "
          f"no plain step", flush=True)
    print(f"  clustered on the device: accumulate "
          f"{phases.get('accumulate', 0.0):.4f} s, phase_b "
          f"{phases.get('phase_b', 0.0):.4f} s, accum_iters "
          f"{counters['accum_iters']:.0f}, accum_centers "
          f"{counters['accum_centers']:.0f}, accum_readbacks "
          f"{counters['accum_readbacks']:.0f}, accum_replays "
          f"{counters['accum_replays']:.0f}", flush=True)
    check_nmi(out, NMI_MIN)
    exact_out = os.path.join(WORK, "smoke_15k_exact.clstr")
    res, _ = drive(dev, "k-mer path --id 0.90 --exact", bench_corpus(),
                   exact_out, similarity=0.90, exact=True)
    if not isinstance(res["backend"], HostBackend):
        fail("the exact=True run did not cluster on HostBackend")
    with open(out, "rb") as a, open(exact_out, "rb") as b:
        same = a.read() == b.read()
    print(f"  k-mer path device vs exact=True (host) CLSTR byte-equal: "
          f"{same}", flush=True)
    if not same:
        fail("the k-mer run on the device and its exact=True rerun differ")
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


# Pairs a launch's boundary rows may hold at the genome corpus's longest
# record, in the unstaged rerun of the genome path
UNSTAGED_PAIRS = 8


def unstaged_genome_path(dev, staged_launches: dict) -> None:
    """The genome run again with MESHCLUST_ALIGN_STAGE_MB=0 (each NW launch
    packs its own pairs' sequences; the corpus is never staged) and a
    boundary budget of UNSTAGED_PAIRS pairs at its longest record: it must
    write the staged run's CLSTR byte for byte, with launches of at most
    that budget."""
    import torch
    from meshclust_tpu_torch.ops import align_device as AD
    from meshclust_tpu_torch.io import fasta as fio
    fasta = genome_corpus()
    lmax = max(len(seq) for _, seq in fio.iter_fasta_records(fasta))
    budget = 4 * AD._PLANES * UNSTAGED_PAIRS * (lmax + 1)
    out = os.path.join(WORK, "viral_genomes_unstaged.clstr")
    sizes, kernel, stage = [], AD.nw_align_long, AD.DeviceAligner._stage
    share, env = AD.BOUNDARY_SHARE, os.environ.get("MESHCLUST_ALIGN_STAGE_MB")

    def spy(codes, lengths, ia, ib, max_l2, **kw):
        sizes.append((ia.shape[0], 4 * AD._PLANES * ia.shape[0]
                      * (max(1, max_l2) + 1)))
        return kernel(codes, lengths, ia, ib, max_l2, **kw)

    def refuse(self):
        fail("the unstaged genome run staged the corpus")

    os.environ["MESHCLUST_ALIGN_STAGE_MB"] = "0"
    AD.BOUNDARY_SHARE = budget / torch.cuda.mem_get_info(dev)[1]
    AD.nw_align_long, AD.DeviceAligner._stage = spy, refuse
    try:
        drive(dev, "align path, genomes --id 0.50, unstaged", fasta, out,
              similarity=0.50)
    finally:
        AD.nw_align_long, AD.DeviceAligner._stage = kernel, stage
        AD.BOUNDARY_SHARE = share
        if env is None:
            del os.environ["MESHCLUST_ALIGN_STAGE_MB"]
        else:
            os.environ["MESHCLUST_ALIGN_STAGE_MB"] = env
    same = same_file(out, os.path.join(WORK, "viral_genomes.clstr"))
    pairs = [p for p, _ in sizes]
    print(f"  unstaged genome run: {len(sizes)} NW launches (staged run: "
          f"{staged_launches['nw_align_long']}) of {min(pairs)}-{max(pairs)} "
          f"pairs, boundary rows at most {max(b for _, b in sizes)} B of a "
          f"{budget} B budget; CLSTR byte-equal to the staged run's: {same}",
          flush=True)
    if any(b > budget for p, b in sizes if p > 1):
        fail("an unstaged NW launch broke its boundary budget")
    if not same:
        fail("the unstaged genome run's CLSTR differs from the staged run's")


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


# ---------------------------------------------------------------------------
# phase 5: checkpoint, trace and Red
# ---------------------------------------------------------------------------

def checkpoint_path(dev, kmer_clstr: str) -> None:
    """The 15k k-mer run with a checkpoint, then again: the second run must
    resume both milestones (no train, no accumulate), cluster on the
    device with the fused Phase B, launch kmer_hist once, each Phase B
    kernel once an iteration and no NW or Phase A kernel, and write the
    CLSTR of the first run and of phase 4's run."""
    from meshclust_tpu_torch.core.classify import DeviceBackend
    from meshclust_tpu_torch.utils import perf
    prefix = os.path.join(WORK, "ckpt_15k")
    for suffix in (".model.json", ".centers.json"):
        if os.path.exists(prefix + suffix):
            os.remove(prefix + suffix)
    outs = [os.path.join(WORK, f"ckpt_15k_{i}.clstr") for i in (1, 2)]
    _, launches = drive(dev, "k-mer path --checkpoint, first run",
                        bench_corpus(), outs[0], similarity=0.90,
                        checkpoint=prefix)
    expect_launches("checkpointed k-mer", launches)
    for suffix in (".model.json", ".centers.json"):
        if not os.path.isfile(prefix + suffix):
            fail(f"the checkpointed run did not write {prefix}{suffix}")
    kept_calls, undo = spy_fused_phase_b()
    try:
        res, launches = drive(dev, "k-mer path --checkpoint, resumed",
                              bench_corpus(), outs[1], similarity=0.90,
                              checkpoint=prefix)
    finally:
        undo()
    phases = perf.phases()
    resumed = not ({"train", "accumulate"} & set(phases))
    print(f"  resumed wall "
          f"{WALLS['k-mer path --checkpoint, resumed']:.3f} s against "
          f"{WALLS['k-mer path --checkpoint, first run']:.3f} s for the "
          f"first run", flush=True)
    print(f"  resumed both milestones: {resumed}; launches {launches}",
          flush=True)
    if not resumed:
        fail(f"the rerun did not resume its checkpoint (phases "
             f"{sorted(phases)})")
    if not isinstance(res["backend"], DeviceBackend):
        fail(f"the resumed run clustered on "
             f"{type(res['backend']).__name__}, not DeviceBackend")
    if kept_calls != [True]:
        fail(f"the resumed run's fused Phase B fell back or did not run "
             f"(kept per call: {kept_calls})")
    if launches != {**dict.fromkeys(launches, 0), "kmer_hist": 1,
                    **dict.fromkeys(PHASE_B, PB_ITERS)}:
        fail(f"the resumed run launched {launches}, not kmer_hist once, "
             f"each Phase B kernel once an iteration and no other kernel "
             f"(no NW, no Phase A)")
    texts = []
    for path in outs + [kmer_clstr]:
        with open(path, "rb") as f:
            texts.append(f.read())
    same = texts[0] == texts[1] == texts[2]
    print(f"  resumed CLSTR byte-equal to the first run's and phase 4's: "
          f"{same}", flush=True)
    if not same:
        fail("the resumed run's CLSTR differs from the uninterrupted run's")


def trace_path(dev, genome_clstr: str) -> None:
    """The genome align-mode run under MESHCLUST_TRACE: a trace file must
    be written that names the NW kernel and the kmer_hist kernel the run
    took, and the CLSTR must be phase 4's."""
    import glob
    import shutil
    from meshclust_tpu_torch.ops import histogram as H
    trace_dir = os.path.join(WORK, "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    out = os.path.join(WORK, "viral_genomes_traced.clstr")
    os.environ["MESHCLUST_TRACE"] = trace_dir
    try:
        res, launches = drive(dev, "align path, genomes, MESHCLUST_TRACE",
                              genome_corpus(), out, similarity=0.50)
    finally:
        del os.environ["MESHCLUST_TRACE"]
    expect_launches("traced genome align-mode", launches)
    label = "align path, genomes --id 0.50"
    print(f"  traced wall {WALLS['align path, genomes, MESHCLUST_TRACE']:.3f}"
          f" s against {WALLS[label]:.3f} s untraced in phase 4", flush=True)
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"MESHCLUST_TRACE wrote {len(traces)} trace files, not one")
    with open(traces[0]) as f:
        text = f.read()
    ps = res["pointset"]
    hist_kernel = ("kmer_split_kernel" if H.split_mode(ps.lengths, res["k"])
                   else "kmer_rows_kernel")
    named = {name: name in text
             for name in ("nw_align_long_kernel", hist_kernel)}
    print(f"  trace {os.path.relpath(traces[0], ROOT)}: "
          f"{os.path.getsize(traces[0])} bytes, names {named}", flush=True)
    if not all(named.values()):
        fail(f"the trace does not name every kernel of the run: {named}")
    with open(out, "rb") as a, open(genome_clstr, "rb") as b:
        same = a.read() == b.read()
    print(f"  traced CLSTR byte-equal to phase 4's: {same}", flush=True)
    if not same:
        fail("MESHCLUST_TRACE changed the genome run's CLSTR")


def random_bases(rng, n: int) -> bytes:
    """n random bases, drawn as tests/conftest.py:random_dna draws them."""
    return rng.choice(list("ACGT"), size=n).astype("S1").tobytes()


def red_genome(chr1_len: int = 10_000_000, chr2_len: int = 3_000_000):
    """Red's genome in WORK/red_genome, two files:
    - chr1: the recipe of tests/test_red.py:genome_dir_10m (seed 11, 5
      motifs of 800 bp between 3-12 kb of background, an N run of 30-200
      bp before 8% of them), until chr1_len bases;
    - chr2: the same motifs in an N-free run (seed 12) of at least
      chr2_len bases, so its run is cut into chr2_len // SEG_LENGTH
      chunks, with a motif across each cut.
    -> (directory, {name: (motif mask, N mask)})."""
    from meshclust_tpu_torch.io.fasta import SEG_LENGTH
    gdir = os.path.join(WORK, "red_genome")
    os.makedirs(gdir, exist_ok=True)
    rng = np.random.default_rng(11)
    motifs = [random_bases(rng, 800) for _ in range(5)]
    truth = {}
    for name, seed, target, n_runs in (("chr1", None, chr1_len, True),
                                       ("chr2", 12, chr2_len, False)):
        if seed is not None:
            rng = np.random.default_rng(seed)
        parts, motif_at, n_at, total = [], [], [], 0
        while total < target:
            bg = random_bases(rng, int(rng.integers(3000, 12000)))
            parts.append(bg)
            total += len(bg)
            if n_runs and rng.random() < 0.08:
                nrun = b"N" * int(rng.integers(30, 200))
                parts.append(nrun)
                n_at.append((total, len(nrun)))
                total += len(nrun)
            m = motifs[int(rng.integers(5))]
            parts.append(m)
            motif_at.append((total, len(m)))
            total += len(m)
        seq = bytearray(b"".join(parts))
        if not n_runs:
            for cut in range(SEG_LENGTH, total - SEG_LENGTH + 1, SEG_LENGTH):
                m = motifs[cut // SEG_LENGTH % 5]
                seq[cut - 400: cut + 400] = m
                motif_at.append((cut - 400, len(m)))
        motif_mask = np.zeros(total, bool)
        n_mask = np.zeros(total, bool)
        for at, ln in motif_at:
            motif_mask[at: at + ln] = True
        for at, ln in n_at:
            n_mask[at: at + ln] = True
        truth[name] = (motif_mask, n_mask)
        with open(os.path.join(gdir, f"{name}.fa"), "wb") as f:
            f.write(b">%s\n" % name.encode())
            for i in range(0, total, 70):
                f.write(bytes(seq[i: i + 70]) + b"\n")
    return gdir, truth


def per_chunk_counts(seqs, wl: int) -> np.ndarray:
    """np.bincount of the wl-mers at fasta.kmer_valid_starts: the windows
    inside one segment chunk, the reference TableBuilder's count."""
    from meshclust_tpu_torch.io import fasta as fio
    out = np.zeros(4 ** wl, np.int64)
    for s in seqs:
        n = s.length - wl + 1
        c = (s.codes & 3).astype(np.int64)
        ids = np.zeros(n, np.int64)
        for d in range(wl):
            ids = ids * 4 + c[d: d + n]
        out += np.bincount(ids[fio.kmer_valid_starts(s, wl)[:n]],
                           minlength=4 ** wl)
    return out


def red_path(chr1_len: int = 10_000_000, chr2_len: int = 3_000_000) -> None:
    """Red (python -m meshclust_tpu_torch.red's run_red) with -rpt and -msk
    on a ~13 Mbp genome: the native Viterbi must load, the k-mer counts
    must be the per-chunk counts, at least 0.9 of the motif bases and at
    most 0.05 of the background bases must be masked; the wall of each
    stage is printed. Red runs on the host."""
    from meshclust_tpu_torch import native
    from meshclust_tpu_torch.io import fasta as fio
    from meshclust_tpu_torch.red import emv, runner, scanner, scorer
    from meshclust_tpu_torch.red.hmm import HMM
    if native.get_red_viterbi() is None:
        fail("the native Red Viterbi (native/red_viterbi.cpp) did not load")
    t0 = time.time()
    gdir, truth = red_genome(chr1_len, chr2_len)
    print(f"  genome written in {time.time() - t0:.2f} s", flush=True)
    stages = {}
    counts = {}

    def timed_stage(owner, attr, stage):
        fn = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            t = time.time()
            try:
                return fn(*args, **kwargs)
            finally:
                stages[stage] = stages.get(stage, 0.0) + time.time() - t
        setattr(owner, attr, wrapped)
        return owner, attr, fn

    def keep_counts(*args, **kwargs):
        got = count_words_multi(*args, **kwargs)
        counts.update(got)
        return got

    count_words_multi = emv.count_words_multi
    emv.count_words_multi = keep_counts
    patched = [(emv, "count_words_multi", count_words_multi)] + [
        timed_stage(*spec) for spec in (
            (fio, "read_fasta", "read"),
            (emv, "build_table", "table"),
            (scorer, "score_chromosome", "scoring"),
            (runner, "detect_chromosome", "candidates"),
            (HMM, "train", "hmm_training"),
            (HMM, "normalize", "hmm_training"),
            (scorer, "take_log", "take_log"),
            (scanner, "scan_chromosome", "scanning"),
            (scanner, "write_rpt", "output"),
            (scanner, "write_masked", "output"),
            (runner, "_plain_records", "output"))]
    rpt, msk = os.path.join(WORK, "red_rpt"), os.path.join(WORK, "red_msk")
    try:
        t0 = time.time()
        res = runner.run_red(runner.RedConfig(gnm=gdir, rpt=rpt, msk=msk))
        wall = time.time() - t0
    finally:
        for owner, attr, fn in reversed(patched):
            setattr(owner, attr, fn)
    seqs = [s for f in sorted(os.listdir(gdir))
            for s in fio.read_fasta(os.path.join(gdir, f))]
    size = sum(s.length for s in seqs)
    print(f"  Red on {size} bp ({len(seqs)} sequences, "
          f"{sum(len(s.segments) for s in seqs)} segment chunks): k="
          f"{res['k']}, order {res['order']}, p {res['p']:.4f}, wall "
          f"{wall:.3f} s, native Viterbi loaded", flush=True)
    for stage, secs in stages.items():
        print(f"    stage {stage:<13s} {secs:10.4f} s", flush=True)
    k = res["k"]
    for wl in sorted(counts):
        if not np.array_equal(counts[wl], per_chunk_counts(seqs, wl)):
            fail(f"Red's {wl}-mer counts are not the per-chunk counts")
    print(f"  k-mer counts (word lengths {sorted(counts)}) equal the "
          f"per-chunk np.bincount over kmer_valid_starts", flush=True)
    if k not in counts:
        fail(f"Red did not count {k}-mers")
    masked = {s.header[1:]: np.zeros(s.length, bool) for s in seqs}
    for header, regions in res["results"]:
        for a, b in regions:
            masked[header[1:]][a: b + 1] = True
    motif_hit = motif_all = bg_hit = bg_all = 0
    for name, (motif, n_run) in truth.items():
        with open(os.path.join(msk, f"{name}.msk")) as f:
            letters = "".join(line.strip() for line in f
                              if not line.startswith(">"))
        lower = np.frombuffer(letters.encode(), np.uint8) >= ord("a")
        if not np.array_equal(lower, masked[name]):
            fail(f"{name}.msk does not lower-case the regions Red found")
        bg = ~motif & ~n_run
        motif_hit += int(masked[name][motif].sum())
        motif_all += int(motif.sum())
        bg_hit += int(masked[name][bg].sum())
        bg_all += int(bg.sum())
    recall, bg_share = motif_hit / motif_all, bg_hit / bg_all
    print(f"  motif bases masked {recall:.6f} (>= 0.9), background bases "
          f"masked {bg_share:.6f} (<= 0.05)", flush=True)
    if not (recall >= 0.9 and bg_share <= 0.05):
        fail(f"Red's masking: motif recall {recall}, background {bg_share}")


# ---------------------------------------------------------------------------
# phase 6: ranks (parallel/dist)
# ---------------------------------------------------------------------------

def rank_run(cfg: dict) -> dict:
    """One rank of a multi-rank run of core.runner.run on CUDA, with the
    launch counts and the perf counters set to 0 just before it; spawned
    by parallel/dist.launch, which imports it from this script."""
    import torch
    from meshclust_tpu_torch import _ext
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core.runner import run
    from meshclust_tpu_torch.parallel import dist
    from meshclust_tpu_torch.utils import perf
    perf.reset()
    _ext.reset_launches()
    t0 = time.time()
    res = run(ClusterConfig(**cfg))
    torch.cuda.synchronize()
    wall = time.time() - t0
    mesh = dist.get_mesh()
    return {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
            "backend": mesh.backend, "wall": wall,
            "clusterer": type(res["backend"]).__name__,
            "n_clusters": res["n_clusters"], "launches": dict(_ext.launches),
            "phases": perf.phases(), "counters": perf.counters()}


def launch_ranks(label: str, n: int, fasta: str, out: str,
                 **cfg) -> tuple:
    """n ranks of the run (rank_run) through parallel/dist.launch; any
    failing rank fails the script. -> (rank results, launch wall)."""
    from torch.multiprocessing.spawn import ProcessException
    from meshclust_tpu_torch.parallel import dist
    t0 = time.time()
    try:
        outs = dist.launch(rank_run, n, None,
                           dict(files=[fasta], output=out, **cfg))
    except ProcessException as e:
        fail(f"a rank of the {label} run failed: {e}")
    wall = time.time() - t0
    print(f"  {label}: {n} ranks, launch wall {wall:.3f} s (spawn "
          f"included)", flush=True)
    for o in outs:
        c = o["counters"]
        colls = ", ".join(
            f"{site} {c[f'coll_{site}']:.0f} ({c[f'coll_{site}_bytes']:.0f}"
            f" B)" for site in ("featurize", "accumulate", "phase_b", "run")
            if f"coll_{site}" in c)
        secs = ", ".join(f"{ph} {o['phases'].get(ph, 0.0):.4f}"
                         for ph in ("featurize", "train", "accumulate",
                                    "phase_b"))
        print(f"    rank {o['rank']}: {o['device']} {o['backend']}, "
              f"{o['clusterer']}, rows featurized "
              f"{c.get('feat_rows', 0):.0f}, wall {o['wall']:.3f} s, "
              f"launches {o['launches']}; s: {secs}; collectives: "
              f"{colls}", flush=True)
    return outs, wall


def same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def ranks_path(kmer_launches: dict) -> dict:
    """The 15k k-mer run at 2 ranks sharing the one card (gloo): its CLSTR
    must be phase 4's, each rank must launch kmer_hist once and the NW
    kernel as often as phase 4's run; the small corpus at 3 and 4 ranks
    and the short-read align-mode corpus at 2 ranks must give their single
    rank's CLSTR; where there are 2 or more GPUs, min(4, count) ranks over
    NCCL, one a GPU, on the 15k corpus. Returns the launches of the 2-rank
    15k run, summed over its ranks."""
    import torch
    out = os.path.join(WORK, "ranks2_15k.clstr")
    outs, wall = launch_ranks("k-mer path --id 0.90", 2, bench_corpus(), out,
                              similarity=0.90)
    for o in outs:
        if o["backend"] != ("gloo" if torch.cuda.device_count() < 2
                            else "nccl"):
            fail(f"rank {o['rank']} took backend {o['backend']}")
        if o["clusterer"] != "DeviceBackend":
            fail(f"rank {o['rank']} clustered on {o['clusterer']}")
        if o["launches"]["kmer_hist"] != 1:
            fail(f"rank {o['rank']} launched kmer_hist "
                 f"{o['launches']['kmer_hist']} times, not once")
        if o["launches"]["pivot_order"] != 2:
            fail(f"rank {o['rank']} launched pivot_order "
                 f"{o['launches']['pivot_order']} times, not twice")
        if o["launches"]["nw_align_long"] != kmer_launches["nw_align_long"]:
            fail(f"rank {o['rank']} launched the NW kernel "
                 f"{o['launches']['nw_align_long']} times, phase 4's run "
                 f"{kmer_launches['nw_align_long']}")
        got = {k: o["launches"][k] for k in PHASE_A}
        if got != phase_a_launches():
            fail(f"rank {o['rank']} launched Phase A's kernels {got} "
                 f"times, not {phase_a_launches()} (the graphed chain)")
        if o["counters"].get("coll_accumulate", 0):
            fail(f"rank {o['rank']} issued a collective in Phase A")
        got = [o["launches"][k] for k in PHASE_B]
        if got != [PB_ITERS] * len(PHASE_B):
            fail(f"rank {o['rank']} launched {PHASE_B} {got} times, not "
                 f"{PB_ITERS} each (one an iteration on its block of the "
                 f"pool)")
        for site in ("featurize", "phase_b"):
            if o["counters"].get(f"coll_{site}", 0) <= 0:
                fail(f"rank {o['rank']} issued no collective at {site}")
    label = "k-mer path --id 0.90"
    print(f"  2 ranks sharing one card: rank walls "
          f"{max(o['wall'] for o in outs):.3f} s against {WALLS[label]:.3f} "
          f"s for phase 4's single rank", flush=True)
    same = same_file(out, os.path.join(WORK, "smoke_15k.clstr"))
    print(f"  2-rank 15k CLSTR byte-equal to phase 4's: {same}", flush=True)
    if not same:
        fail("the 2-rank 15k run's CLSTR differs from phase 4's")
    cases = [(3, "small", os.path.join(WORK, "small.fasta"),
              os.path.join(WORK, "small_gpu.clstr"),
              dict(similarity=0.90, sample_size=300)),
             (4, "small", os.path.join(WORK, "small.fasta"),
              os.path.join(WORK, "small_gpu.clstr"),
              dict(similarity=0.90, sample_size=300)),
             (2, "short_align", os.path.join(WORK, "short_align.fasta"),
              os.path.join(WORK, "short_align_gpu.clstr"),
              dict(similarity=0.90, align=True))]
    n_gpu = torch.cuda.device_count()
    if n_gpu >= 2:
        cases.append((min(4, n_gpu), "nccl_15k", bench_corpus(),
                      os.path.join(WORK, "smoke_15k.clstr"),
                      dict(similarity=0.90)))
    for n, name, fasta, want, cfg in cases:
        got = os.path.join(WORK, f"ranks{n}_{name}.clstr")
        outs_n, _ = launch_ranks(f"{name} corpus", n, fasta, got, **cfg)
        if any(o["launches"]["kmer_hist"] != 1 for o in outs_n):
            fail(f"a rank of the {n}-rank {name} run did not launch "
                 f"kmer_hist once")
        if name == "nccl_15k" and any(o["backend"] != "nccl"
                                      for o in outs_n):
            fail("ranks with a GPU each did not take NCCL")
        same = same_file(got, want)
        print(f"  {n}-rank {name} CLSTR byte-equal to its single rank's: "
              f"{same}", flush=True)
        if not same:
            fail(f"the {n}-rank {name} run's CLSTR differs from its single "
                 f"rank's")
    return {name: sum(o["launches"][name] for o in outs)
            for name in outs[0]["launches"]}


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
    t_start = time.time()
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
    rows = [check_histogram(dev), check_nw_long(dev), *check_phase_a(dev),
            *check_phase_b(dev), check_pivot_order(dev)]

    print("phase 4: main paths", flush=True)
    kmer = main_path(dev)
    small_parity(dev)
    genome = genome_path(dev)
    unstaged_genome_path(dev, genome)
    short_align_parity(dev)
    print(f"  phases 1-4 took {time.time() - t_start:.1f} s", flush=True)

    print("phase 5: checkpoint, trace and Red", flush=True)
    t5 = time.time()
    checkpoint_path(dev, os.path.join(WORK, "smoke_15k.clstr"))
    trace_path(dev, os.path.join(WORK, "viral_genomes.clstr"))
    red_path()
    print(f"  phase 5 took {time.time() - t5:.1f} s", flush=True)

    print("phase 6: ranks", flush=True)
    t6 = time.time()
    ranks = ranks_path(kmer)
    print(f"  phase 6 took {time.time() - t6:.1f} s; all phases "
          f"{time.time() - t_start:.1f} s", flush=True)
    # each kernel's launches from the two main paths and the 2-rank run
    for row in rows:
        row["launches"] = (kmer[row["name"]] + genome[row["name"]]
                           + ranks[row["name"]])

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase-a-profile"]:
        os.environ.setdefault("MESHCLUST_QUIET", "1")
        sys.exit(phase_a_profile_child(sys.argv[2:]))
    sys.exit(main())

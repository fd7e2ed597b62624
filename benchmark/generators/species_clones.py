"""The general corpus generator: species of random bases, clones of each
with point substitutions and trimmed ends, written as FASTA.

Every traffic file under benchmark/traffic/ names this generator and gives
its parameters; a new mix is a new data file. Frozen from chip_smoke.py's
`bench_corpus` and `viral_corpus` (the recipes of bench.py's
`make_dataset` and `make_viral_dataset`), vectorised, and split in two
random streams:

- the *shape* of corpus i of the pool (how many species, how many clones
  each, the length of each species' base genome, each clone's trim and
  substitution rate) comes from `shape_seed` in the traffic file, so every
  run seed gets the same work;
- the *content* (the bases and where the substitutions fall) comes from
  the run's --seed, so runs differ in the sequences they cluster.

Parameters (all lengths in bases):
  reads            total reads of one corpus
  species_sizes    {"law": "fixed", "size": s}: reads // s species of s
                   clones; {"law": "zipf", "exponent": a, "max": m}:
                   species sizes drawn from a Zipf law of exponent a,
                   truncated at m, until `reads` reads are drawn (the last
                   species is cut to fit)
  length           {"mean": L, "spread": d}: a species' base length is
                   L + U[-d, d)
  trim_div         a clone keeps its base's first L - U[0, max(trim_min,
                   L // trim_div)) bases
  trim_min
  substitution     {"low": a, "high": b}: each clone's substitution rate
                   is drawn from [a, b) (a == b: fixed); each base is
                   substituted with that probability by one of the three
                   other bases
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


def species_sizes(law: Dict, reads: int, rng: np.random.Generator
                  ) -> List[int]:
    """Clone counts of the corpus's species, summing to `reads`."""
    if law["law"] == "fixed":
        size = int(law["size"])
        return [size] * (reads // size)
    if law["law"] == "zipf":
        a, top = float(law["exponent"]), int(law["max"])
        sizes: List[int] = []
        left = reads
        while left > 0:
            draw = rng.zipf(a, size=4096)
            for s in draw[draw <= top]:
                s = min(int(s), left)
                sizes.append(s)
                left -= s
                if left == 0:
                    break
        return sizes
    raise ValueError(f"unknown species size law {law['law']!r}")


def shape(params: Dict, index: int) -> Dict[str, np.ndarray]:
    """The corpus's sizes, drawn from the traffic's shape seed: clone
    counts, base lengths, each clone's kept length and substitution rate."""
    rng = np.random.default_rng([int(params["shape_seed"]), index])
    sizes = np.asarray(species_sizes(params["species_sizes"],
                                     int(params["reads"]), rng), np.int64)
    mean = int(params["length"]["mean"])
    spread = int(params["length"]["spread"])
    base_len = mean + rng.integers(-spread, spread, size=sizes.shape[0]) \
        if spread else np.full(sizes.shape[0], mean, np.int64)
    per_clone_len = np.repeat(base_len, sizes)
    trim_hi = np.maximum(int(params["trim_min"]),
                         per_clone_len // int(params["trim_div"]))
    keep = per_clone_len - rng.integers(0, trim_hi)
    sub = params["substitution"]
    lo, hi = float(sub["low"]), float(sub["high"])
    rate = lo + (hi - lo) * rng.random(keep.shape[0]) if hi > lo \
        else np.full(keep.shape[0], lo)
    return {"sizes": sizes, "base_len": base_len.astype(np.int64),
            "keep": keep.astype(np.int64), "rate": rate}


def make(params: Dict, seed: int, index: int, path: str) -> Dict:
    """Write corpus `index` of the pool for run seed `seed` to `path`.
    Returns its counts of reads, species, bases and segments (a read of
    20 bases or more is one segment; the parser drops shorter ones)."""
    sh = shape(params, index)
    rng = np.random.default_rng([int(seed) % (1 << 64), index])
    sizes, base_len, keep, rate = (sh["sizes"], sh["base_len"], sh["keep"],
                                   sh["rate"])
    starts = np.zeros(sizes.shape[0] + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        for s in range(sizes.shape[0]):
            L = int(base_len[s])
            per = int(sizes[s])
            base = rng.integers(0, 4, size=L, dtype=np.int8)
            seqs = np.tile(base, (per, 1))
            r = rate[starts[s]: starts[s + 1]]
            mut = rng.random((per, L)) < r[:, None]
            shift = rng.integers(1, 4, size=(per, L), dtype=np.int8)
            seqs = np.where(mut, (seqs + shift) % 4, seqs)
            rows = LETTERS[seqs]
            ends = keep[starts[s]: starts[s + 1]]
            lines = []
            for c in range(per):
                lines.append(b">s%d_c%d\n" % (s, c))
                lines.append(rows[c, : ends[c]].tobytes())
                lines.append(b"\n")
            f.write(b"".join(lines))
    return {"reads": int(sizes.sum()), "species": int(sizes.shape[0]),
            "bases": int(keep.sum()), "segments": int((keep >= 20).sum())}

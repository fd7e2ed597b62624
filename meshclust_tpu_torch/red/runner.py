"""Red pipeline driver (reference RepeatsDetector drive + nonltr::Trainer,
SURVEY R1/R5; RepeatsDetector.cpp:57-263, Trainer.cpp).

Stages:
1. adjusted k-mer table over the genome directory (emv.build_table)
2. percentage p = 100 * #(score <= t) / effective size, min 52.5
3. candidate regions (detector, t+0.1) -> HMM training -> normalize
4. scan every chromosome -> rpt/msk/scr outputs

Defaults mirror the reference: k = floor(log4(genome size)) clamped to
[12, 15]; order = floor(k/2) - 1; gau = 20 if 33% < GC < 67% else 40;
thr = 2 (1 -> 1.5); min = 3.

Red runs on the host, in numpy and the C++ Viterbi of native/: it takes no
device argument and touches no tensor. Two things differ from
meshclust_tpu.red: a k-mer counts only inside one segment chunk
(emv.chunk_tails), and the masked output takes each record's letters from
the plain reader's record of the same index.
"""
from __future__ import annotations

import dataclasses
import glob
import math
import os
from typing import List, Optional

import numpy as np

from meshclust_tpu_torch.io import fasta as fio
from meshclust_tpu_torch.red import emv, scorer as rscorer, scanner as rscanner
from meshclust_tpu_torch.red.detector import detect_chromosome
from meshclust_tpu_torch.red.hmm import HMM
from meshclust_tpu_torch.utils.log import log


@dataclasses.dataclass
class RedConfig:
    gnm: str                       # genome directory (*.fa)
    msk: Optional[str] = None      # masked output dir
    rpt: Optional[str] = None      # repeats output dir
    sco: Optional[str] = None      # scores output dir
    cnd: Optional[str] = None      # candidates output dir
    k: Optional[int] = None        # -len
    order: Optional[int] = None    # -ord
    gau: Optional[int] = None      # -gau
    thr: float = 2.0               # -thr
    min_obs: int = 3               # -min
    frm: int = 1                   # -frm


def _genome_files(d: str) -> List[str]:
    return sorted(glob.glob(os.path.join(d, "*.fa")))


def _plain_records(path: str) -> List[str]:
    """The original letters of the records that fio.read_fasta keeps, in
    its order. The reference pairs its plain and one-digit chromosome lists
    by index (RepeatsDetector.cpp); fio.encode_record drops only records
    with no sequence bytes, so those are skipped here."""
    return [pseq for _, pseq in fio.read_fasta_plain(path) if pseq]


def run_red(cfg: RedConfig) -> dict:
    files = _genome_files(cfg.gnm)
    if not files:
        raise FileNotFoundError(f"no .fa files in {cfg.gnm}")
    per_file = [fio.read_fasta(f) for f in files]
    seqs = [s for fs in per_file for s in fs]

    genome_len = sum(int(b - a + 1) for s in seqs for a, b in s.segments)
    k = cfg.k
    if k is None:
        k = int(math.floor(math.log(max(genome_len, 2)) / math.log(4.0)))
        k = min(max(k, 12), 15)
    order = cfg.order if cfg.order is not None else max(0, k // 2 - 1)
    gau = cfg.gau
    if gau is None:
        acgt = np.zeros(4, np.int64)
        for s in seqs:
            for a, b in s.segments:
                c = s.codes[a: b + 1]
                for d in range(4):
                    acgt[d] += int((c == d).sum())
        gc = (acgt[1] + acgt[2]) / max(1, acgt.sum())
        gau = 20 if 0.33 < gc < 0.67 else 40
    t = cfg.thr
    if int(t) == 1:
        t = 1.5
    log(f"Red: k={k} order={order} gau={gau} thr={t}")

    # Stage 1: table
    table, L, max_val = emv.build_table(seqs, k, order, cfg.min_obs)
    if max_val <= 0:
        raise RuntimeError("adjusted table is empty — genome too small?")

    # Stage 2: percentage
    eff = 0
    count_le = 0
    chrom_scores = []
    for s in seqs:
        sc = rscorer.score_chromosome(s, table, k)
        chrom_scores.append(sc)
        for a, b in s.segments:
            eff += b - a + 1
            count_le += int((sc[a: b + 1] <= t).sum())
    p = 100.0 * count_le / max(1, eff)
    if p < 52.5:
        p = 52.5
    log(f"Red: percentage p = {p:.2f}")

    # Stage 3: candidates + HMM training
    hmm_base = 1.5 if abs(t - 1.0) < 1e-12 else t
    state_count = 2 * (int(math.ceil(math.log(max_val) / math.log(hmm_base)))
                       + 1)
    hmm = HMM(hmm_base, state_count)
    t_detector = t + 0.1
    all_candidates = []
    for s, sc in zip(seqs, chrom_scores):
        cand = detect_chromosome(sc, s.segments, int(gau), 10, 0.0,
                                 t_detector, p, int(gau))
        all_candidates.append(cand)
        if cand:
            logged = rscorer.take_log(sc, s, t)
            hmm.train(logged, s.segments, cand)
    hmm.normalize()

    if cfg.cnd:
        os.makedirs(cfg.cnd, exist_ok=True)
        path = os.path.join(cfg.cnd, "candidates.cnd")
        with open(path, "w") as f:
            for s, cand in zip(seqs, all_candidates):
                name = s.header
                for a, b in cand:
                    f.write(f"{name}:{a}-{b + 1} \n")

    # Stage 4: scan
    results = []
    for d in (cfg.msk, cfg.rpt, cfg.sco):
        if d:
            os.makedirs(d, exist_ok=True)
    fi = 0
    plain_cache: dict = {}
    for fpath, fseqs in zip(files, per_file):
        nick = os.path.splitext(os.path.basename(fpath))[0]
        first = True
        for fi_file, s in enumerate(fseqs):
            sc = chrom_scores[fi]
            fi += 1
            logged = rscorer.take_log(sc, s, t)
            regions = rscanner.scan_chromosome(hmm, k, s, logged)
            results.append((s.header, regions))
            if cfg.rpt:
                rscanner.write_rpt(
                    os.path.join(cfg.rpt, nick + ".rpt"), s.header, regions,
                    cfg.frm, append=not first)
            if cfg.msk:
                # reference masks the ORIGINAL letters (makeChromList +
                # toUpperCase, incl. multi-line header continuation —
                # ChromListMaker.cpp:49-89), not the one-digit re-encoding
                if fpath not in plain_cache:
                    plain_cache[fpath] = _plain_records(fpath)
                plain = plain_cache[fpath]
                base = plain[fi_file] if fi_file < len(plain) else ""
                if len(base) != s.length:   # length mismatch: one-digit
                    lut = np.array(list("ACGT") + ["N"] * 252, dtype="U1")
                    base = "".join(lut[np.minimum(s.codes, 255)])
                rscanner.write_masked(
                    os.path.join(cfg.msk, nick + ".msk"), s.header, base,
                    regions, append=not first)
            if cfg.sco:
                rscanner.write_scores(
                    os.path.join(cfg.sco, nick + ".scr"), s.header, sc,
                    append=not first)
            first = False
    return {"k": k, "order": order, "gau": gau, "p": p,
            "results": results, "hmm": hmm, "table": table}

"""The plain reference of one clustering job, and the comparison that
decides `correct`.

`solve` recomputes, from the corpus file alone, k and the histograms, the
NW identities of the pairs it is given, the classifier (k-mer mode: refitted
from the program's sampled training pairs, whose identities it aligns
itself), Phase A's centers, Phase B's merges and the CLSTR text.

Two inputs follow the program's own state:
- k-mer mode: which pairs the trainer sampled (Trainer.split), because the
  reference cannot recompute them without replaying the program's native
  sort of every pivot's distance row; the reference aligns them, labels
  them and fits the model itself;
- align mode: the identities of the pairs clustering aligned, because
  aligning every one of a genome job's ~1,700 pairs in plain PyTorch takes
  longer than the window. The reference aligns a sample of them drawn from
  the seed (`nw_pairs` compares each), takes its own identity wherever it
  has one, and recomputes every decision taken from them.

`compare` gives each number it compares; `limits` beside them decide.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.reference import cluster, corpus, kmer, model as M, nw


def align_mode(flags: Dict) -> bool:
    """Whether a run of these flags clusters in align mode: `align` set, or
    an identity below 0.60 (Runner.cpp:25-39)."""
    return bool(flags.get("align")) or float(flags["similarity"]) < 0.6


def solve(fasta: str, flags: Dict, split_pairs: Optional[Sequence],
          check_pairs: Sequence[Tuple[int, int]],
          aligned: Optional[Dict[Tuple[int, int], float]], device,
          dt=np.float64, continue_first: bool = False) -> Dict:
    headers, codes = corpus.read_fasta(fasta)
    lengths = np.asarray([c.shape[0] for c in codes], np.int64)
    sim = float(flags["similarity"])
    k = int(flags["kmer"]) if flags.get("kmer") else kmer.find_k(lengths)
    hist = kmer.histograms(codes, k)
    check_pairs = [tuple(p) for p in check_pairs]
    todo = list(dict.fromkeys(check_pairs + [tuple(p) for p in
                                             (split_pairs or [])]))
    ids = dict(zip(todo, nw.identities(codes, todo, device,
                                       continue_first=continue_first)))
    misses = [0]

    def align(prs):
        # the reference's own identity first, then the program's
        known = [ids.get(tuple(p), (aligned or {}).get(tuple(p)))
                 for p in prs]
        lack = [p for p, v in zip(prs, known) if v is None]
        misses[0] += len(lack)
        got = dict(zip(lack, nw.identities(codes, lack, device)))
        return np.asarray([v if v is not None else got[tuple(p)]
                           for p, v in zip(prs, known)])

    in_align_mode = align_mode(flags)
    if in_align_mode:
        mdl = M.align_model(sim, dt)
        oracle = cluster.AlignOracle(mdl, align)
    else:
        stats = M.Stats(hist, lengths)
        sp = [tuple(p) for p in split_pairs]
        bp, bn = M.labels(sp, np.asarray([ids[p] for p in sp]), headers, sim)
        mdl = M.fit(stats, bp, bn, sim, dt)
        oracle = cluster.KmerOracle(stats, mdl, device)
    after_a, centers = cluster.run(lengths, hist, oracle, sim,
                                   int(flags["delta"]),
                                   int(flags["iterations"]), dt,
                                   in_align_mode)
    return {
        "k": k,
        "hist": hist,
        "aligned": ids,
        "model": model_params(mdl),
        "phase_a": after_a,
        "clstr": cluster.clstr_text(centers, headers, lengths),
        "oracle_misses": misses[0],
    }


# The control variants a configuration file names under "control".
CONTROLS = {"float32": {"dt": np.float32},
            "gap_continue_first": {"continue_first": True}}


def check_job(state: Dict, fasta: str, cfg: Dict, seed: int, device,
              **variant) -> Dict:
    """`solve` for a job the program ran: the pairs whose identities it
    checks drawn from the job's aligned pairs by `seed`."""
    rng = np.random.default_rng([seed % (1 << 64), 104729])
    sample = sample_pairs(list(state["aligned"]), int(cfg["check_pairs"]),
                          rng)
    return solve(fasta, cfg["flags"], state["split"], sample,
                 state["aligned"], device, **variant)


def model_params(m: M.Model) -> Dict:
    return {"lookup": list(m.lookup), "combos": [(c, list(ix))
                                                 for c, ix in m.combos],
            "mins": np.asarray(m.mins, np.float64),
            "maxs": np.asarray(m.maxs, np.float64),
            "weights": np.asarray(m.weights, np.float64)}


def model_gap(a: Dict, b: Dict) -> float:
    """The largest gap of the two models' bounds and weights, each against
    the largest magnitude of its kind in `b`; 1 when they differ in
    shape (features or combos)."""
    if a["lookup"] != b["lookup"] or a["combos"] != b["combos"]:
        return 1.0
    gap = 0.0
    for key in ("mins", "maxs", "weights"):
        x, y = np.asarray(a[key]), np.asarray(b[key])
        scale = max(float(np.abs(y).max()), 1e-300) if y.size else 1.0
        if x.size:
            gap = max(gap, float(np.abs(x - y).max()) / scale)
    return gap


def lines_off(a: str, b: str) -> int:
    la, lb = a.splitlines(), b.splitlines()
    return abs(len(la) - len(lb)) + sum(x != y for x, y in zip(la, lb))


def compare(prog: Dict, ref: Dict, align_mode: bool) -> Dict[str, float]:
    """The numbers compared, program (or control) against reference."""
    hp, hr = prog["hist"], ref["hist"]
    if hp.shape != hr.shape:
        rows = max(hp.shape[0], hr.shape[0])
    else:
        rows = int((hp != hr).any(axis=1).sum())
    nw_off = sum(1 for p, v in ref["aligned"].items()
                 if prog["aligned"].get(p) != v)
    pa, ra = prog["phase_a"], ref["phase_a"]
    out = {
        "k": abs(int(prog["k"]) - int(ref["k"])),
        "hist_rows": rows,
        "nw_pairs": nw_off,
        "phase_a": abs(len(pa) - len(ra)) + sum(
            tuple(x) != tuple(y) for x, y in zip(pa, ra)),
        "clstr_lines": lines_off(prog["clstr"], ref["clstr"]),
    }
    if not align_mode:
        out["model_gap"] = model_gap(prog["model"], ref["model"])
    return out


def sample_pairs(aligned: List[Tuple[int, int]], count: int,
                 rng: np.random.Generator) -> List[Tuple[int, int]]:
    """Up to `count` of the ordered pairs the job aligned, drawn by rng."""
    pairs = list(dict.fromkeys(tuple(p) for p in aligned))
    if len(pairs) <= count:
        return pairs
    pick = np.sort(rng.choice(len(pairs), size=count, replace=False))
    return [pairs[i] for i in pick]

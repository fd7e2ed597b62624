"""CD-HIT CLSTR output writer + parser (ref print_output,
ClusterFactory.cpp:495-520) and partition-comparison metrics for the golden
parity harness (SURVEY §4)."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def write_clstr(path: str, centers, headers: Sequence[str],
                lengths: Sequence[int]) -> None:
    """centers: iterable with .center (point idx) and .members (point idxs).

    Format per reference: '>Cluster n' then
    '<i>\\t<len>nt, <header>... [*]' with '*' marking the member whose id
    equals the center's.
    """
    with open(path, "w") as f:
        counter = 0
        for cen in centers:
            if not cen.members:
                continue
            f.write(f">Cluster {counter}\n")
            for pt, p in enumerate(cen.members):
                line = f"{pt}\t{int(lengths[p])}nt, {headers[p]}... "
                if p == cen.center:
                    line += "*"
                f.write(line + "\n")
            counter += 1


def parse_clstr(path: str) -> List[List[Tuple[str, bool]]]:
    """-> list of clusters, each a list of (header, is_representative)."""
    clusters: List[List[Tuple[str, bool]]] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">Cluster"):
                clusters.append([])
            elif line.strip():
                body = line.split("\t", 1)[1]
                rep = body.rstrip().endswith("*")
                body = body.rstrip()
                if rep:
                    body = body[:-1].rstrip()
                # strip "<len>nt, " prefix and trailing "..."
                header = body.split("nt, ", 1)[1]
                if header.endswith("..."):
                    header = header[:-3]
                clusters[-1].append((header, rep))
    return clusters


def partition_labels(clusters: List[List[Tuple[str, bool]]]
                     ) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for ci, members in enumerate(clusters):
        for header, _ in members:
            out[header] = ci
    return out


def nmi(labels_a: Dict[str, int], labels_b: Dict[str, int]) -> float:
    """Normalized mutual information between two partitions over the shared
    key set (the reference authors' external quality metric, SURVEY §4)."""
    keys = sorted(set(labels_a) & set(labels_b))
    if not keys:
        return 0.0
    a = np.asarray([labels_a[k] for k in keys])
    b = np.asarray([labels_b[k] for k in keys])
    n = len(keys)

    def entropy(x):
        _, cnt = np.unique(x, return_counts=True)
        p = cnt / n
        return float(-(p * np.log(p)).sum())

    ha, hb = entropy(a), entropy(b)
    if ha == 0.0 and hb == 0.0:
        return 1.0
    # joint
    pairs = a.astype(np.int64) * (b.max() + 1) + b
    _, cnt = np.unique(pairs, return_counts=True)
    pj = cnt / n
    hj = float(-(pj * np.log(pj)).sum())
    mi = ha + hb - hj
    denom = max(1e-12, (ha + hb) / 2.0)
    return mi / denom


def one_to_one_recovery(labels_pred: Dict[str, int],
                        labels_true: Dict[str, int]) -> float:
    """Fraction of true clusters recovered exactly 1-1 (Tables/*.csv metric)."""
    keys = set(labels_pred) & set(labels_true)
    true_groups: Dict[int, set] = {}
    pred_groups: Dict[int, set] = {}
    for k in keys:
        true_groups.setdefault(labels_true[k], set()).add(k)
        pred_groups.setdefault(labels_pred[k], set()).add(k)
    pred_sets = {frozenset(v) for v in pred_groups.values()}
    hits = sum(1 for g in true_groups.values() if frozenset(g) in pred_sets)
    return hits / max(1, len(true_groups))

"""Mean-shift clustering, recomputed: Phase A's greedy accumulation over the
length-binned store, then Phase B's update and merge sweeps, then the CLSTR
text.

Frozen from the program's host path, the float64 oracle that every device
path is held to (core/meanshift.py with core/classify.py's HostBackend in
k-mer mode and AlignBackend in align mode; ClusterFactory.cpp:290-520):

- Phase A: pop a seed; classify the store's window of lengths
  [len * sim, len / sim] against the current center; if any is positive,
  harvest the marked entries, the center becomes the member nearest the
  members' mean (get_mean), and repeat; otherwise the cluster closes and
  the window's first best f1 seeds the next one.
- Phase B, `iterations` times: every center moves to the nearest-to-mean of
  its positives among the members of centers j - delta .. j + delta (all
  read one snapshot; k-mer mode's fused Phase B breaks a distance tie by
  Phase A's member order, align mode's by the current member lists); then
  each center merges into the first best positive of the next delta
  centers, applied as a chain in index order.
- Align mode memoises identities by unordered pair; after Phase A a pair it
  has not aligned reads identity 0 (the reference's clone quirk,
  DivergencePoint.h:37-43).

The heavy integer sums of a classification run in torch on `device`; every
float operation runs in numpy in the dtype `dt`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import model as M
from benchmark.reference.bvec import BVec

DBL_MIN = 2.2250738585072014e-308
# Elements of one [pairs, V] block of the device sums.
BLOCK_ELEMENTS = 1 << 26


@dataclasses.dataclass
class Center:
    center: int
    members: List[int]
    deleted: bool = False


class KmerOracle:
    """HostBackend's decisions: raw statistics of (a, b) from integer sums,
    a the center."""

    def __init__(self, stats: M.Stats, model: M.Model, device):
        self.stats = stats
        self.model = model
        self.device = torch.device(device)
        self.hist = torch.from_numpy(stats.hist.astype(np.int32)).to(
            self.device)

    def sums(self, a: np.ndarray, b: np.ndarray):
        man = np.zeros(a.shape[0], np.int64)
        dot = np.zeros(a.shape[0], np.int64)
        step = max(1, BLOCK_ELEMENTS // self.stats.V)
        for s in range(0, a.shape[0], step):
            ia = torch.from_numpy(a[s:s + step]).to(self.device)
            ib = torch.from_numpy(b[s:s + step]).to(self.device)
            ha, hb = self.hist[ia], self.hist[ib]
            man[s:s + step] = (ha - hb).abs().sum(
                1, dtype=torch.int64).cpu().numpy()
            dot[s:s + step] = (ha * hb).sum(1, dtype=torch.int64).cpu().numpy()
        return man, dot

    def pairs(self, a: np.ndarray, b: np.ndarray, phase_b: bool = False):
        if a.shape[0] == 0:
            return np.zeros(0, bool), np.zeros(0, self.model.dt)
        man, dot = self.sums(a, b)
        raw = self.stats.raw(a, b, self.model.lookup, self.model.dt, man,
                             dot)
        cache = np.stack([raw[f] for f in self.model.lookup], axis=-1)
        return self.model.classify(cache)


class AlignOracle:
    """AlignBackend's decisions: the identity of (a, b), memoised by
    unordered pair; `align(pairs)` gives the identities of ordered pairs
    the memo lacks."""

    def __init__(self, model: M.Model, align: Callable):
        self.model = model
        self.align = align
        self.memo: Dict[Tuple[int, int], float] = {}

    def pairs(self, a: np.ndarray, b: np.ndarray, phase_b: bool = False):
        if a.shape[0] == 0:
            return np.zeros(0, bool), np.zeros(0, self.model.dt)
        keys = [(min(x, y), max(x, y)) for x, y in zip(a.tolist(),
                                                         b.tolist())]
        missing: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for k, x, y in zip(keys, a.tolist(), b.tolist()):
            if k not in self.memo and k not in missing:
                missing[k] = (x, y)
        if missing:
            vals = (np.zeros(len(missing)) if phase_b
                    else self.align(list(missing.values())))
            for k, v in zip(missing, vals):
                self.memo[k] = float(v)
        ids = np.asarray([self.memo[k] for k in keys])
        return self.model.classify(ids[:, None])


def nearest_to_mean(hist: np.ndarray, rows: np.ndarray, seg: np.ndarray,
                    n_seg: int, dt, rank=None) -> np.ndarray:
    """get_mean (ClusterFactory.cpp:382-425) for each segment of rows: the
    float mean of the members' histograms, its floor, and the member with
    the least distance_d (DivergencePoint.cpp:53-65), on ties the first in
    row order, or the least `rank` when given; -1 for an empty segment.
    rows are grouped by seg, in ascending order."""
    out = np.full(n_seg, -1, np.int64)
    if rows.shape[0] == 0:
        return out
    H = hist[rows]
    bounds = np.searchsorted(seg, np.arange(n_seg + 1))
    cs = np.zeros((rows.shape[0] + 1, H.shape[1]), np.int64)
    np.cumsum(H, axis=0, out=cs[1:])
    sums = cs[bounds[1:]] - cs[bounds[:-1]]
    cnt = (bounds[1:] - bounds[:-1]).astype(dt)
    good = cnt > 0
    c_mean = np.zeros(sums.shape, dt)
    c_mean[good] = sums[good].astype(dt) / cnt[good, None]
    cw = np.floor(c_mean).astype(np.int64)
    dist = 2 * np.minimum(H, cw[seg]).sum(axis=1)
    mag = np.floor(H.astype(dt) + c_mean[seg]).sum(axis=1)
    frac = dist.astype(dt) / mag
    d = dt(10000.0) * (dt(1.0) - frac * frac)
    dmin = np.full(n_seg, np.inf, dt)
    np.minimum.at(dmin, seg, d)
    cand = d == dmin[seg]
    order = np.arange(rows.shape[0], dtype=np.int64)
    if rank is not None:
        order = np.asarray(rank, np.int64)
    big = np.iinfo(np.int64).max
    first = np.full(n_seg, big, np.int64)
    np.minimum.at(first, seg[cand], order[cand])
    sel = good & (first < big)
    pos = np.full(int(order.max()) + 1, -1, np.int64)
    pos[order] = np.arange(rows.shape[0], dtype=np.int64)
    out[sel] = rows[pos[first[sel]]]
    return out


def phase_a(lengths: np.ndarray, hist: np.ndarray, oracle, sim: float,
            dt, center_first: bool, bin_size: int = 1000) -> List[Center]:
    """MeanShift.accumulate_all's host path."""
    bv = BVec(lengths.copy(), bin_size)
    bv.bulk_insert(lengths)
    bv.insert_finalize()
    centers: List[Center] = []
    last = bv.pop()
    while last is not None:
        current = [last]
        while True:
            length = int(lengths[last])
            front, back = bv.get_range(int(length * sim), int(length / sim))
            window, spans = bv.window(front, back)
            seed = np.full(window.shape[0], last, np.int64)
            res, f1 = (oracle.pairs(seed, window) if center_first
                       else oracle.pairs(window, seed))
            if res.any():
                bv.apply_marks(spans, res)
                current.extend(bv.remove_available(front, back))
                cur = np.asarray(current, np.int64)
                last = int(nearest_to_mean(
                    hist, cur, np.zeros(cur.shape[0], np.int64), 1, dt)[0])
                continue
            if window.shape[0] == 0:
                nxt = bv.pop()
            else:
                best = int(np.argmax(f1))
                r, c = bv.flat_to_position(spans, best)
                nxt = int(window[best])
                bv.erase(r, c)
            centers.append(Center(last, current))
            last = nxt
            break
    return centers


def update_once(centers: List[Center], hist: np.ndarray, oracle,
                delta: int, dt, orient_center_first: bool,
                slot=None) -> None:
    """One update sweep; `slot` (a point's position in Phase A's member
    order), when given, breaks distance ties in place of the pool's order,
    as the fused device Phase B does (core/classify.py:_band_argmin: its
    pools keep Phase A's member order where the host path's re-concatenated
    lists put merged members last)."""
    n = len(centers)
    sizes = np.asarray([len(c.members) for c in centers], np.int64)
    flat = np.concatenate([np.asarray(c.members, np.int64)
                           for c in centers]) if n else np.zeros(0, np.int64)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(sizes, out=off[1:])
    j = np.arange(n)
    lo = off[np.maximum(0, j - delta)]
    hi = off[np.minimum(n - 1, j + delta) + 1]
    psize = hi - lo
    if psize.sum() == 0:
        return
    pool = np.concatenate([flat[lo[t]:hi[t]] for t in range(n)])
    owner = np.repeat(j, psize)
    rows = np.asarray([c.center for c in centers], np.int64)
    if orient_center_first:
        res, _ = oracle.pairs(rows[owner], pool, phase_b=True)
    else:
        res, _ = oracle.pairs(pool, rows[owner], phase_b=True)
    rank = None if slot is None else slot[pool[res]]
    nxt = nearest_to_mean(hist, pool[res], owner[res], n, dt, rank)
    for t, c in enumerate(centers):
        if nxt[t] >= 0 and nxt[t] != c.center:
            c.center = int(nxt[t])


def merge_once(centers: List[Center], oracle, delta: int,
               orient_center_first: bool) -> None:
    n = len(centers)
    idx = np.asarray([c.center for c in centers], np.int64)
    own, cand = [], []
    for i in range(n):
        for jj in range(i + 1, min(n - 1, i + delta) + 1):
            own.append(i)
            cand.append(jj)
    own = np.asarray(own, np.int64)
    cand = np.asarray(cand, np.int64)
    if orient_center_first:
        res, f1 = oracle.pairs(idx[own], idx[cand], phase_b=True)
    else:
        res, f1 = oracle.pairs(idx[cand], idx[own], phase_b=True)
    targets = np.zeros(n, np.int64)
    best = np.full(n, DBL_MIN)
    for t in range(own.shape[0]):
        i = own[t]
        if res[t] and f1[t] > best[i]:
            best[i] = f1[t]
            targets[i] = cand[t]
    for i in range(n):
        ret = int(targets[i])
        if ret > i:
            centers[ret].members.extend(centers[i].members)
            centers[i].deleted = True
    centers[:] = [c for c in centers if not c.deleted]


def phase_b(centers: List[Center], hist: np.ndarray, oracle, delta: int,
            iterations: int, dt, orient_center_first: bool,
            fused: bool) -> None:
    slot = None
    if fused:
        order = [m for c in centers for m in c.members]
        slot = np.zeros(hist.shape[0], np.int64)
        slot[np.asarray(order, np.int64)] = np.arange(len(order))
    for _ in range(iterations):
        update_once(centers, hist, oracle, delta, dt, orient_center_first,
                    slot)
        merge_once(centers, oracle, delta, orient_center_first)


def clstr_text(centers: List[Center], headers: List[str],
               lengths: np.ndarray) -> str:
    """print_output (ClusterFactory.cpp:495-520)."""
    out = []
    counter = 0
    for cen in centers:
        if not cen.members:
            continue
        out.append(f">Cluster {counter}\n")
        for pt, p in enumerate(cen.members):
            line = f"{pt}\t{int(lengths[p])}nt, {headers[p]}... "
            if p == cen.center:
                line += "*"
            out.append(line + "\n")
        counter += 1
    return "".join(out)


def snapshot(centers: List[Center]) -> List[Tuple[int, Tuple[int, ...]]]:
    return [(c.center, tuple(c.members)) for c in centers]


def run(lengths: np.ndarray, hist: np.ndarray, oracle, sim: float,
        delta: int, iterations: int, dt, align_mode: bool
        ) -> Tuple[list, List[Center]]:
    """(Phase A's centers, the final centers)."""
    # k-mer mode classifies (center, candidate) as HostBackend.classify
    # and runs the fused device Phase B; align mode aligns (candidate,
    # center), the center second (Trainer.cpp:88, :341), and runs the
    # per-iteration Phase B
    centers = phase_a(lengths, hist, oracle, sim, dt,
                      center_first=not align_mode)
    after_a = snapshot(centers)
    phase_b(centers, hist, oracle, delta, iterations, dt,
            orient_center_first=not align_mode, fused=not align_mode)
    return after_a, centers

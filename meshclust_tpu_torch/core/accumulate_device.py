"""Phase A, mean-shift accumulation (ClusterFactory.cpp:637-714), on the
device. Twin of meshclust_tpu/core/accumulate_device.py without its TPU
machinery (chunked dispatch, live-set compaction, compile prewarm, tile
heuristics, certified float32).

The reference loop: classify a length-window of live candidates against the
current center, absorb the positives, move the center to the member closest
to the members' mean, repeat until nothing is absorbed, then seed the next
center from the most similar remaining candidate (or pop the first live
one). Here the state lives on the device, over

  slots: the finalized bvec order (bins concatenated; lengths globally
  non-decreasing). Static per slot: point row, length, bin, and the window
  limits of its length. Dynamic: active (still in the bvec), owner (center
  id of an absorbed slot), stamp (absorb iteration).

torch has no while_loop, so the host drives both loops: each absorb
iteration is a sequence of torch ops followed by ONE readback of four
scalars (positives absorbed, first-max candidate, current center slot,
first live slot). Nothing else syncs: the center slot stays a
one-element tensor (a 0-dim integer tensor used as an index is read back
by torch, like .item()), and the state is set with fill_ (assigning a
Python number copies it from the host). Every sweep covers all N slots,
masked to the live window, and the decisions are the float64 classifier
of core/classify.py, bit-equal to the host path. Ties take the first occurrence: candidates in
slot order (the reference's iteration order), members in (stamp, slot)
order (its member-list order).

Window bounds reproduce bvec::get_range (bvec.cpp:52-149, 246-278): the
window's lengths (length * sim, length / sim) are computed on the host in
float64, as MeanShift._accumulate_one computes them, and mapped to bins by
bvec::index_of once per phase; the in-bin quirks are masked reductions over
the live slots (cases in window_bounds).

With a mesh (parallel/dist) the feature axis is sharded: each rank keeps
its [N, V/n] slice of the rows (widened by the largest count of all V), and
each reduction over V is one SUM across ranks of exact int64 partials: the
Manhattan and dot sums of a sweep ([2, N]) and the mean's distance sums with
the sum of the floored mean ([N + 1]). The mean's sums stay on the slice;
the slot state is replicated and identical on every rank, so each rank
reads back the same four scalars an iteration. Phase A runs replicated when
V is not a multiple of the ranks or MESHCLUST_PHASEA_SHARD=0.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from meshclust_tpu_torch.core.classify import Scorer, mean_floor, row_dtype
from meshclust_tpu_torch.ops import features as F
from meshclust_tpu_torch.parallel import dist
from meshclust_tpu_torch.utils import perf
from meshclust_tpu_torch.utils.progress import Progress


def window_limits(lengths: np.ndarray, sim: float):
    """(lo, hi) = (int(length * sim), int(length / sim)) per length, in
    float64 as the host path computes them. (The JAX package's device Phase
    A computes them in float32, which differs at some lengths for --id
    0.60 and 0.97.)"""
    L = np.asarray(lengths, np.int64).astype(np.float64)
    return (L * sim).astype(np.int64), (L / sim).astype(np.int64)


def index_of(x: np.ndarray, begin_bounds) -> tuple:
    """bvec::index_of (low, high) of each length in x: the linear scan
    over begin_bounds (bvec.cpp:122-149) for each distinct length."""
    bb = np.asarray(begin_bounds, np.int64)
    nb = bb.shape[0]
    prev = np.concatenate([[0], bb[:-1]])
    prev_index = np.maximum(np.arange(nb) - 1, 0)
    u, inv = np.unique(np.asarray(x, np.int64), return_inverse=True)
    cond = (u[:, None] >= prev) & (u[:, None] <= bb)
    low = np.where(cond, prev_index, nb - 1).min(axis=1)
    high = np.where(cond, prev_index, 0).max(axis=1)
    high = np.where(u >= bb[-1], np.maximum(high, nb - 1), high)
    return low[inv].reshape(np.shape(x)), high[inv].reshape(np.shape(x))


class _Slots:
    """Phase A's state on the device, and its steps."""

    def __init__(self, ps, bv, params: F.FeatureParams, sim: float,
                 mesh=None):
        self.mesh = mesh
        self.point = np.concatenate([np.asarray(b, np.int64)
                                     for b in bv.idx])
        N = self.N = self.point.shape[0]
        dev = ps.device
        lens = ps.lengths[self.point]
        lo, hi = window_limits(lens, sim)
        bins = np.repeat(np.arange(len(bv.idx)), [len(b) for b in bv.idx])

        def put(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        self.len, self.lo, self.hi, self.bin = put(lens), put(lo), put(hi), \
            put(bins)
        self.front_bin = put(index_of(lo, bv.begin_bounds)[0])
        self.back_bin = put(index_of(hi, bv.begin_bounds)[1])
        sp = put(self.point)
        h = ps.hist_dev[sp]
        rows = row_dtype(int(h.max()) if h.numel() else 0)
        if mesh is not None:
            vl = ps.V // mesh.size
            h = h[:, mesh.rank * vl: (mesh.rank + 1) * vl].contiguous()
        # [N, V] rows (this rank's [N, V/n] slice) widened once per phase
        self.h = h.to(rows)
        f64 = {"dtype": torch.float64, "device": dev}
        self.mag = torch.as_tensor(ps.mag[self.point], **f64)
        self.sq = torch.as_tensor(ps.sq[self.point], **f64)
        self.lenf = torch.as_tensor(lens, **f64)
        self.scorer = Scorer(params, ps.V, dev)
        self.slots = torch.arange(N, device=dev)
        self.active = torch.ones(N, dtype=torch.bool, device=dev)
        self.owner = torch.full((N,), -1, dtype=torch.int64, device=dev)
        self.stamp = torch.zeros(N, dtype=torch.int64, device=dev)

    def first_of(self, mask):
        """The first slot of a mask, N if none (a masked min: ties never
        depend on argmax's choice)."""
        return torch.where(mask, self.slots, self.N).min()

    def last_of(self, mask):
        return torch.where(mask, self.slots, -1).max()

    def window_bounds(self, last):
        """Inclusive slot range [w0, w1] of get_range(lo, hi) of the center
        at slot `last` (a one-element tensor) on the live slots (lengths
        are sorted over slots, so every case of bvec::inner_index_of is a
        first or last live slot under a mask):
          front: the first live slot of the front bin with length >= lo;
                 none: the LAST live slot of that bin; an empty bin: the
                 first live slot overall;
          back:  the last live slot of the back bin with length == hi; else
                 its first live slot with length > hi; else its last live
                 slot; an empty bin: the FIRST live slot of the LAST
                 non-empty bin (the truncation quirk), -1 if none."""
        N, active = self.N, self.active
        in_f = active & (self.bin == self.front_bin[last])
        s_ge = self.first_of(in_f & (self.len >= self.lo[last]))
        s_last_f = self.last_of(in_f)
        w0 = torch.where(s_last_f >= 0,
                         torch.where(s_ge < N, s_ge, s_last_f),
                         self.first_of(active))
        hi = self.hi[last]
        in_b = active & (self.bin == self.back_bin[last])
        s_eq_last = self.last_of(in_b & (self.len == hi))
        s_gt = self.first_of(in_b & (self.len > hi))
        s_last_b = self.last_of(in_b)
        live_last = self.last_of(active)
        first_of_last = self.first_of(
            active & (self.bin == self.bin[live_last.clamp(min=0)
                                           .reshape(1)]))
        w1 = torch.where(
            s_last_b >= 0,
            torch.where(s_eq_last >= 0, s_eq_last,
                        torch.where(s_gt < N, s_gt, s_last_b)),
            torch.where(live_last >= 0, first_of_last, -1))
        return w0, w1

    def classify_window(self, last):
        """(positive, best): every slot classified against the center at
        slot `last` (a = the center, as in HostBackend.classify), masked to
        the live window; best is the first max of f1 over the window in
        slot order, N if the window is empty."""
        w0, w1 = self.window_bounds(last)
        ok = self.active & (self.slots >= w0) & (self.slots <= w1)
        man, dot = self.scorer.sums(self.h[last], self.h)
        if self.mesh is not None:
            both = dist.psum(torch.stack([man] if dot is None else [man, dot]),
                             self.mesh, "accumulate")
            man, dot = both[0], (None if dot is None else both[1])
        pos, f1 = self.scorer(man, dot, self.mag[last], self.mag,
                              self.sq[last], self.sq, self.lenf[last],
                              self.lenf)
        f1 = torch.where(ok, f1, float("-inf"))
        return pos & ok, self.first_of(ok & (f1 == f1.max()))

    def mean_argmin(self, c: int, sumvec, count):
        """get_mean (ClusterFactory.cpp:382-425): the slot of center c's
        member closest by distance_d to the members' mean, the first in
        (stamp, slot) order on ties."""
        cw = mean_floor(sumvec, count)
        dist_ = 2 * torch.minimum(self.h, cw.to(self.h.dtype)).sum(
            1, dtype=torch.int64)
        cw_sum = cw.sum()                  # exact: integers below 2^53
        if self.mesh is not None:
            both = dist.psum(torch.cat([dist_, cw_sum.to(torch.int64)
                                        .reshape(1)]), self.mesh,
                             "accumulate")
            dist_, cw_sum = both[:-1], both[-1].to(torch.float64)
        # floor(h + mean) = h + floor(mean) for integer h: mean_select's
        # sum(floor(h + mean)) is mag + sum(floor(mean))
        frac = dist_.to(torch.float64) / (self.mag + cw_sum)
        d = 10000.0 * (1.0 - frac * frac)      # two roundings, no FMA
        mask = self.owner == c
        d = torch.where(mask, d, float("inf"))
        cand = mask & (d == d.min())
        first_stamp = torch.where(cand, self.stamp,
                                  torch.iinfo(torch.int64).max).min()
        return self.first_of(cand & (self.stamp == first_stamp)).reshape(1)


def accumulate_device(ps, bv, params: F.FeatureParams, sim: float,
                      cmax_hint: int = 0, mesh=None):
    """Run Phase A on ps's device. `bv` must be a finalized BVec (it is
    not changed); returns the Center list in reference semantics (see
    core/meanshift.Center). cmax_hint > 0 stops after that many centers.
    mesh: shard the feature axis over its ranks (module docstring); every
    rank returns the same centers. Counters: accum_iters (absorb
    iterations), accum_centers and accum_readbacks (device-to-host
    reads)."""
    from meshclust_tpu_torch.core.meanshift import Center
    if mesh is not None and (
            ps.V % mesh.size
            or os.environ.get("MESHCLUST_PHASEA_SHARD", "1") != "1"):
        mesh = None
    if sum(len(b) for b in bv.idx) == 0:
        return []
    s = _Slots(ps, bv, params, sim, mesh)
    N = s.N
    cmax = cmax_hint or (N + 1)
    center_slot: List[int] = []
    t = seed = iters = 0
    prog = Progress(N + 1, "Accumulation")
    s.active[:1].fill_(False)                    # pop() the first seed
    while True:
        c = len(center_slot)
        s.owner[seed: seed + 1].fill_(c)
        s.stamp[seed: seed + 1].fill_(t)
        t += 1
        last = s.slots[seed: seed + 1]
        sumvec = s.h[seed].to(torch.int64)
        count = torch.ones((), dtype=torch.int64, device=sumvec.device)
        n_members = 1
        while True:
            pos, best = s.classify_window(last)
            s.owner.masked_fill_(pos, c)
            s.stamp.masked_fill_(pos, t)
            s.active &= ~pos
            n_pos = pos.sum()
            sumvec += torch.where(pos[:, None], s.h, 0).sum(
                0, dtype=torch.int64)
            count += n_pos
            n_pos, best, last_h, live = torch.cat(
                [torch.stack([n_pos, best]), last,
                 s.first_of(s.active).reshape(1)]).tolist()
            t += 1
            iters += 1
            if n_pos == 0:
                break
            n_members += n_pos
            last = s.mean_argmin(c, sumvec, count)
        center_slot.append(last_h)
        prog += n_members
        # next seed: the window's best candidate (erased), else pop()
        seed = best if best < N else live
        if seed >= N or len(center_slot) >= cmax:
            break
        s.active[seed: seed + 1].fill_(False)
    prog.end()
    owner, stamp = torch.stack([s.owner, s.stamp]).cpu().numpy()
    n_centers = len(center_slot)
    perf.add("accum_iters", float(iters))
    perf.add("accum_centers", float(n_centers))
    perf.add("accum_readbacks", float(iters + 2))

    # group members by owner keeping (stamp, slot) insertion order
    order = np.lexsort((np.arange(N), stamp))   # (stamp, slot) order
    ow = owner[order]
    pts = s.point[order]
    sel = (ow >= 0) & (ow < n_centers)
    ow = ow[sel]
    pts = pts[sel]
    grp = np.argsort(ow, kind="stable")         # per-owner, order preserved
    ow_s = ow[grp]
    pts_s = pts[grp]
    bounds = np.searchsorted(ow_s, np.arange(n_centers + 1))
    return [Center(int(s.point[center_slot[c]]),
                   pts_s[bounds[c]: bounds[c + 1]].tolist())
            for c in range(n_centers)]

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

torch has no while_loop, so the host drives both loops. Each absorb
iteration is three steps of ops/phase_a (pa_window, pa_sums, pa_absorb)
followed by ONE readback of four scalars (positives absorbed, first-max
candidate, current center slot, first live slot), and, when it absorbed,
one more (pa_move) that moves the center. On a CUDA
device the steps are hand-written kernels (csrc/phase_a.cu) that read only
the live window's rows, in their storage dtype, and the members' rows; on
the CPU, or with plain=True, they are their plain torch versions, which
sweep all N slots masked to the window. The scalars live in one int64
state buffer on the device and the state is set with fill_ (assigning a
Python number copies it from the host), so nothing else syncs. The
decisions are the float64 classifier of core/classify.py in the same op
order, bit-equal to the host path. Ties take the first occurrence:
candidates in slot order (the reference's iteration order), members in
(stamp, slot) order (its member-list order).

Window bounds reproduce bvec::get_range (bvec.cpp:52-149, 246-278): the
window's lengths (length * sim, length / sim) are computed on the host in
float64, as MeanShift._accumulate_one computes them, and mapped to bins by
bvec::index_of once per phase; the in-bin quirks are masked reductions over
the live slots (cases in ops/phase_a.window_plain). The kernel path reads
them from a table built once per phase (window_ranges): the slot ranges
that decide each center's window, whose first or last live slots it finds.

With a mesh (parallel/dist) the feature axis is sharded: each rank keeps
its [N, V/n] slice of the rows (the plain steps widen it by the largest
count of all V), and each reduction over V is one SUM across ranks of exact
int64 partials: the Manhattan and dot sums of a sweep ([2, N]) and the
mean's distance sums with the sum of the floored mean ([N + 1]). The
mean's sums stay on the slice, so there the move is two steps around that
SUM (pa_member_dist, pa_mean_argmin); the slot state is replicated and
identical on every rank, so each rank reads back the same four scalars an
iteration.
Phase A runs replicated when V is not a multiple of the ranks or
MESHCLUST_PHASEA_SHARD=0.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from meshclust_tpu_torch.core.classify import row_dtype
from meshclust_tpu_torch.ops import features as F
from meshclust_tpu_torch.ops import phase_a as P
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


def window_ranges(lens, sizes, lo, hi, front_bin, back_bin) -> np.ndarray:
    """pa_window's table [N, len(P.RANGES)] int32, a row a slot as a
    center: the slot ranges of ops/phase_a.window_table_plain. Slots are in
    bvec order (bins of `sizes` slots concatenated, lengths `lens`
    non-decreasing), so bin b is [off[b], off[b + 1]) and a bin's slots of
    length >= x start at searchsorted(lens, x) clipped to the bin."""
    lens = np.asarray(lens, np.int64)
    if np.any(np.diff(lens) < 0):
        raise ValueError("slot lengths must be non-decreasing")
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    bins = np.repeat(np.arange(len(sizes)), sizes)
    f0, f1 = off[front_bin], off[np.asarray(front_bin) + 1]
    b0, b1 = off[back_bin], off[np.asarray(back_bin) + 1]
    cols = [f0, np.clip(np.searchsorted(lens, lo), f0, f1), f1,
            b0, np.clip(np.searchsorted(lens, hi), b0, b1),
            np.clip(np.searchsorted(lens, hi, "right"), b0, b1), b1,
            off[bins]]
    return np.stack(cols, axis=1).astype(np.int32)


class _Slots:
    """Phase A's state on the device, and its two steps: absorb (pa_window,
    pa_sums, pa_absorb, one readback) and move (pa_move; under a mesh
    pa_member_dist and pa_mean_argmin), through ops/phase_a's kernels or,
    with `plain`, their plain versions (rows widened once per phase to
    row_dtype)."""

    def __init__(self, ps, bv, params: F.FeatureParams, sim: float,
                 mesh=None, plain: bool = True):
        self.mesh = mesh
        self.point = np.concatenate([np.asarray(b, np.int64)
                                     for b in bv.idx])
        N = self.N = self.point.shape[0]
        dev = ps.device
        lens = ps.lengths[self.point]
        lo, hi = window_limits(lens, sim)
        sizes = [len(b) for b in bv.idx]
        bins = np.repeat(np.arange(len(sizes)), sizes)
        front = index_of(lo, bv.begin_bounds)[0]
        back = index_of(hi, bv.begin_bounds)[1]

        def put(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        self.len, self.lo, self.hi, self.bin = put(lens), put(lo), put(hi), \
            put(bins)
        self.front_bin, self.back_bin = put(front), put(back)
        self.ranges = torch.as_tensor(
            window_ranges(lens, sizes, lo, hi, front, back), device=dev)
        # the window step's inputs past st and active: the plain step's
        # per-slot arrays, or the kernel's table
        self.window_in = ((self.bin, self.len, self.lo, self.hi,
                           self.front_bin, self.back_bin) if plain
                          else (self.ranges,))
        sp = put(self.point)
        h = ps.hist_dev[sp]
        if plain:
            rows = row_dtype(int(h.max()) if h.numel() else 0)
        if mesh is not None:
            vl = ps.V // mesh.size
            h = h[:, mesh.rank * vl: (mesh.rank + 1) * vl]
        # [N, V] rows in slot order (this rank's [N, V/n] slice): widened
        # once per phase for the plain steps; the kernels widen in registers
        self.h = h.contiguous().to(rows) if plain else h
        self.step = P.steps(plain)
        f64 = {"dtype": torch.float64, "device": dev}
        self.mag = torch.as_tensor(ps.mag[self.point], **f64)
        self.sq = torch.as_tensor(ps.sq[self.point], **f64)
        self.lenf = torch.as_tensor(lens, **f64)
        self.model = P.Model(params, ps.V, dev)
        self.active = torch.ones(N, dtype=torch.bool, device=dev)
        self.owner = torch.full((N,), -1, dtype=torch.int64, device=dev)
        self.stamp = torch.zeros(N, dtype=torch.int64, device=dev)
        self.st, self.part = P.new_state(N, dev)
        self.sums = torch.zeros((2 if self.model.with_dot else 1, N),
                                dtype=torch.int64, device=dev)
        self.dist = torch.zeros(N + 1, dtype=torch.int64, device=dev)
        self.sumvec = None
        self.wait_s = 0.0

    def window(self) -> None:
        """pa_window (or its plain step) for the center st[LAST]."""
        self.step.window(self.st, self.active, *self.window_in)

    def window_bounds(self, last):
        """(w0, w1) of the center at slot `last` (a tensor) on the live
        slots: pa_window's inclusive slot range."""
        self.st[P.LAST] = last
        self.window()
        return self.st[P.W0], self.st[P.W1]

    def begin(self, seed: int, c: int, t: int) -> None:
        """Center c starts at slot seed: its only member, stamped t."""
        self.owner[seed: seed + 1].fill_(c)
        self.stamp[seed: seed + 1].fill_(t)
        self.st[P.LAST: P.LAST + 1].fill_(seed)
        self.st[P.COUNT: P.COUNT + 1].fill_(1)
        self.sumvec = self.h[seed].to(torch.int64, copy=True)

    def absorb(self, c: int, t: int) -> list:
        """Classify the live window against the center (a = the center, as
        in HostBackend.classify) and absorb the positives into center c at
        stamp t. -> [positives, the window's first max of f1 (N if
        empty), the center's slot, the first live slot], the iteration's
        one readback. (The first live slot is taken before the absorb: it
        is read only when nothing was absorbed.)"""
        st, step = self.st, self.step
        self.window()
        step.sums(st, self.active, self.h, self.sums)
        sums = self.sums if self.mesh is None else dist.psum(
            self.sums, self.mesh, "accumulate")
        step.absorb(st, sums, self.model, self.mag, self.sq, self.lenf,
                    self.owner, self.stamp, self.active, self.h, self.sumvec,
                    c, t, self.part)
        return self.readback()

    def readback(self) -> list:
        """st[:LIVE + 1]: the iteration's one device-to-host read, which
        waits for the steps before it; the host's wait is summed in
        wait_s."""
        t = time.perf_counter()
        out = self.st[: P.LIVE + 1].tolist()
        self.wait_s += time.perf_counter() - t
        return out

    def move(self, c: int) -> None:
        """The center moves to c's member closest to the members' mean."""
        if self.mesh is None:
            self.step.move(self.st, self.owner, c, self.h, self.sumvec,
                           self.mag, self.stamp, self.dist, self.part)
            return
        self.step.member_dist(self.st, self.owner, c, self.h, self.sumvec,
                              self.dist, self.part)
        d = dist.psum(self.dist, self.mesh, "accumulate")
        self.step.mean_argmin(self.st, d, self.mag, self.owner, self.stamp,
                              c, self.part)


def accumulate_device(ps, bv, params: F.FeatureParams, sim: float,
                      cmax_hint: int = 0, mesh=None,
                      plain: Optional[bool] = None,
                      state: Optional[dict] = None):
    """Run Phase A on ps's device. `bv` must be a finalized BVec (it is
    not changed); returns the Center list in reference semantics (see
    core/meanshift.Center). cmax_hint > 0 stops after that many centers.
    mesh: shard the feature axis over its ranks (module docstring); every
    rank returns the same centers. plain: the torch steps instead of the
    CUDA kernels of ops/phase_a (default: on the CPU only; the kernels'
    wrappers take their plain versions for CPU tensors). state: a dict
    that receives the final slot state (owner, stamp, active, center_slot,
    point: numpy, in slot order), for checks. Span accum_loop: the
    absorb/move loop. Counters: accum_iters (absorb iterations),
    accum_centers, accum_readbacks (device-to-host reads) and accum_wait_s
    (host seconds blocked in the iterations' readbacks)."""
    from meshclust_tpu_torch.core.meanshift import Center
    if mesh is not None and (
            ps.V % mesh.size
            or os.environ.get("MESHCLUST_PHASEA_SHARD", "1") != "1"):
        mesh = None
    if sum(len(b) for b in bv.idx) == 0:
        return []
    s = _Slots(ps, bv, params, sim, mesh,
               ps.device.type == "cpu" if plain is None else plain)
    N = s.N
    cmax = cmax_hint or (N + 1)
    center_slot: List[int] = []
    t = seed = iters = 0
    prog = Progress(N + 1, "Accumulation")
    s.active[:1].fill_(False)                    # pop() the first seed
    with perf.phase("accum_loop"):
        while True:
            c = len(center_slot)
            s.begin(seed, c, t)
            t += 1
            n_members = 1
            while True:
                n_pos, best, last_h, live = s.absorb(c, t)
                t += 1
                iters += 1
                if n_pos == 0:
                    break
                n_members += n_pos
                s.move(c)
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
    if state is not None:
        state.update(owner=owner, stamp=stamp, active=s.active.cpu().numpy(),
                     center_slot=np.asarray(center_slot, np.int64),
                     point=s.point)
    perf.add("accum_iters", float(iters))
    perf.add("accum_centers", float(n_centers))
    perf.add("accum_readbacks", float(iters + 2))
    perf.add("accum_wait_s", s.wait_s)

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

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

The loop's control is on the device too: an iteration is a fixed chain of
five steps of ops/phase_a (pa_window, pa_sums, pa_absorb,
pa_move, which moves the center only if the iteration absorbed, and
pa_next, which ends a center, records its slot and seeds the next one, or
sets the done flag), each a no-op once the flag is set. So the host runs
CHUNK iterations at a time and reads back once a chunk: [done, iterations,
centers, members] (the members of the centers recorded, for the progress
bar). On a CUDA device the steps are hand-written kernels
(csrc/phase_a.cu) that read only the live window's rows, in their storage
dtype, and the members' rows, and a chunk is one replay of a CUDA graph
captured once a phase; on the CPU, or with plain=True, they are their
plain torch versions, which sweep all N slots masked to the window, run
eagerly a chunk at a time. A phase runs at most CHUNK - 1 iterations past
its end. The scalars live in one int64 state buffer on the device and the
state is set with fill_ (assigning a Python number copies it from the
host), so nothing else syncs. The decisions are the float64 classifier of
ops/classifier.py in the same op order, bit-equal to the host path. Ties
take the first occurrence: candidates in slot order (the reference's
iteration order), members in (stamp, slot) order (its member-list order).

Window bounds reproduce bvec::get_range (bvec.cpp:52-149, 246-278): the
window's lengths (length * sim, length / sim) are computed on the host in
float64, as MeanShift._accumulate_one computes them, and mapped to bins by
bvec::index_of once per phase; the in-bin quirks are masked reductions over
the live slots (cases in ops/phase_a.window_plain). The kernel path reads
them from a table built once per phase (window_ranges): the slot ranges
that decide each center's window, whose first or last live slots it finds.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from meshclust_tpu_torch.ops import features as F
from meshclust_tpu_torch.ops import phase_a as P
from meshclust_tpu_torch.ops.classifier import Model, widen
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


# Iterations a chunk: a replay of the graph, one readback.
CHUNK = 32


class _Slots:
    """Phase A's state on the device, and its steps bound to it once
    (ops/phase_a's binders: their checks made here, not at each launch)
    through ops/phase_a's kernels or, with `plain`, their plain versions
    (rows widened once per phase, ops/classifier.widen): iteration, the
    chain's five steps."""

    def __init__(self, ps, bv, params: F.FeatureParams, sim: float,
                 plain: bool = True, cmax: int = 0):
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
        # [N, V] rows in slot order: widened once per phase for the plain
        # steps; the kernels widen in registers
        h = ps.hist_dev[put(self.point)]
        self.h = widen(h) if plain else h
        self.step = step = P.steps(plain)
        f64 = {"dtype": torch.float64, "device": dev}
        self.mag = torch.as_tensor(ps.mag[self.point], **f64)
        self.sq = torch.as_tensor(ps.sq[self.point], **f64)
        self.lenf = torch.as_tensor(lens, **f64)
        self.model = Model(params, ps.V, dev)
        self.active = torch.ones(N, dtype=torch.bool, device=dev)
        self.owner = torch.full((N,), -1, dtype=torch.int64, device=dev)
        self.stamp = torch.zeros(N, dtype=torch.int64, device=dev)
        self.st, self.part = P.new_state(N, dev)
        self.sums = torch.zeros((2 if self.model.with_dot else 1, N),
                                dtype=torch.int64, device=dev)
        self.dist = torch.zeros(N + 1, dtype=torch.int64, device=dev)
        self.sumvec = torch.zeros(self.h.shape[1], dtype=torch.int64,
                                  device=dev)
        self.center_slot = torch.zeros(N + 1, dtype=torch.int64, device=dev)
        self.wait_s = 0.0
        self.window = step.window(self.st, self.active, *self.window_in)
        self.sweep = step.sums(self.st, self.active, self.h, self.sums)
        self.absorb_step = step.absorb(
            self.st, self.sums, self.model, self.mag, self.sq, self.lenf,
            self.owner, self.stamp, self.active, self.h, self.sumvec,
            self.part)
        self.move_step = step.move(
            self.st, self.owner, self.h, self.sumvec, self.mag, self.stamp,
            self.dist, self.part)
        self.next_step = step.next(self.st, self.active, self.owner,
                                   self.stamp, self.h, self.sumvec,
                                   self.center_slot, cmax or N + 1)

    def window_bounds(self, last):
        """(w0, w1) of the center at slot `last` (a tensor) on the live
        slots: pa_window's inclusive slot range."""
        self.st[P.LAST] = last
        self.window()
        return self.st[P.W0], self.st[P.W1]

    def begin(self, seed: int, c: int, t: int) -> None:
        """Center c starts at slot seed: its only member, stamped t; the
        next absorb's stamp is t + 1."""
        self.owner[seed: seed + 1].fill_(c)
        self.stamp[seed: seed + 1].fill_(t)
        self.st[P.LAST: P.LAST + 1].fill_(seed)
        self.st[P.COUNT: P.COUNT + 1].fill_(1)
        self.st[P.C: P.C + 1].fill_(c)
        self.st[P.T: P.T + 1].fill_(t + 1)
        self.sumvec.copy_(self.h[seed])

    def iteration(self) -> None:
        """An iteration's five steps, with no host decision."""
        self.window()
        self.sweep()
        self.absorb_step()
        self.move(None)
        self.next_step()

    def chunk(self) -> None:
        """CHUNK iterations, launched as they come."""
        for _ in range(CHUNK):
            self.iteration()

    def graph(self):
        """chunk captured in a CUDA graph: -> its replay. Every buffer is
        the phase's own, so the capture allocates nothing. Each kernel is
        launched once before it, with the done flag set (each returns at
        once), so that none is first loaded inside the capture."""
        done = self.st[P.DONE: P.DONE + 1]
        done.fill_(1)
        self.iteration()
        done.fill_(0)
        g = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream(self.st.device)
        side = torch.cuda.Stream(self.st.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            g.capture_begin(capture_error_mode="thread_local")
            try:
                self.chunk()
            finally:
                g.capture_end()
        main.wait_stream(side)
        return g.replay

    def readback(self, a: int, b: int) -> list:
        """st[a:b]: a device-to-host read, which waits for the steps before
        it; the host's wait is summed in wait_s."""
        t = time.perf_counter()
        out = self.st[a: b].tolist()
        self.wait_s += time.perf_counter() - t
        return out

    def move(self, c: Optional[int]) -> None:
        """The center moves to its member closest to the members' mean:
        pa_move, a no-op where the iteration absorbed nothing. c is None:
        st[C] alone holds the center's id."""
        self.move_step()


def _device_loop(s: _Slots, graphed: bool, prog: Progress) -> tuple:
    """The chain CHUNK iterations at a time, a CUDA graph's replay where
    `graphed`, until the done flag. -> (iterations, centers, chunks)."""
    s.active[:1].fill_(False)                    # pop() the first seed
    s.begin(0, 0, 0)
    run = s.graph() if graphed else s.chunk
    chunks = taken = 0
    while True:
        run()
        chunks += 1
        done, iters, centers, members = s.readback(P.DONE, P.MEMBERS + 1)
        prog += members - taken
        taken = members
        if done:
            return iters, centers, chunks


def accumulate_device(ps, bv, params: F.FeatureParams, sim: float,
                      cmax_hint: int = 0, mesh=None,
                      plain: Optional[bool] = None,
                      state: Optional[dict] = None):
    """Run Phase A on ps's device. `bv` must be a finalized BVec (it is
    not changed); returns the Center list in reference semantics (see
    core/meanshift.Center). cmax_hint > 0 stops after that many centers.
    mesh: unused; Phase A runs whole on every rank, each on the rows it
    holds, and every rank returns the same centers (MeanShift passes its
    mesh). plain: the torch steps instead of the CUDA kernels of
    ops/phase_a (default: on the CPU only; the kernels' wrappers take their
    plain versions for CPU tensors). state: a dict that receives the final
    slot state (owner, stamp, active, center_slot, point: numpy, in slot
    order), for checks. Span accum_loop: the absorb/move loop. Counters:
    accum_iters (absorb iterations), accum_centers, accum_readbacks
    (device-to-host reads: one a chunk and one of the final state),
    accum_wait_s (host seconds blocked in the loop's readbacks),
    accum_replays (chunks: a graph's replays on the card) and
    accum_device_iters (the iterations the device's control ran: all of
    them)."""
    from meshclust_tpu_torch.core.meanshift import Center
    if sum(len(b) for b in bv.idx) == 0:
        return []
    plain = ps.device.type == "cpu" if plain is None else plain
    s = _Slots(ps, bv, params, sim, plain, cmax_hint)
    N = s.N
    prog = Progress(N + 1, "Accumulation")
    with perf.phase("accum_loop"):
        iters, n_centers, chunks = _device_loop(
            s, s.st.device.type == "cuda" and not plain, prog)
    prog.end()
    out = torch.cat([s.owner, s.stamp, s.center_slot[:n_centers]]).cpu()
    owner, stamp = out[:N].numpy(), out[N: 2 * N].numpy()
    center_slot = out[2 * N:].numpy()
    if state is not None:
        state.update(owner=owner, stamp=stamp, active=s.active.cpu().numpy(),
                     center_slot=center_slot, point=s.point)
    perf.add("accum_iters", float(iters))
    perf.add("accum_centers", float(n_centers))
    perf.add("accum_readbacks", float(chunks + 1))
    perf.add("accum_wait_s", s.wait_s)
    perf.add("accum_replays", float(chunks))
    perf.add("accum_device_iters", float(iters))

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

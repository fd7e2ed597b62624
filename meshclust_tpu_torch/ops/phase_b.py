"""Phase B's update+merge iteration: four CUDA kernels (csrc/phase_b.cu) and
their plain PyTorch versions.

They take the place, on the card, of the torch ops of one iteration of
core/classify.py:DeviceBackend.phase_b_loop (the JAX package runs all the
iterations as one lax.scan, meshclust_tpu/core/classify.py:563
_build_phaseb). An iteration is

  band(pb)        assign mapped through the last merge's remap; for each
                  member m and offset o in [-delta, delta], center jc =
                  assign[m] + o: the classifier (a: the center, b: the
                  member), a bit a positive, and the positive rows and
                  their count added into sc [C, V + 1] (int64);
  dist(pb)        for each positive: cw = floor(sums / max(count, 1)),
                  distance_d to the mean (in dstore, offset-major) and
                  each center's least (best_d);
  pick(pb)        each center's least pool position among its positives at
                  that least d (best_pos); sc zeroed for the next band (the
                  kernel clears the rows band touched, those with a count);
and, in the fused loop,
  merge(pb, it)   the move, the merge (t_hist[it]), the chains' ends, the
                  compaction of the kept centers and remap.

Under a mesh the host sums sc after band and takes the minima of best_d
after dist and of best_pos after pick, across ranks (core/classify.py).
A wrapper takes the plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device; it never falls back. The plain
versions are the torch ops the port ran before these kernels, rearranged
only to keep the kernels' state: assign is remapped at the next band, not
at the merge, and each step reads and writes the buffers of State.
"""
from __future__ import annotations

import math
import types
from typing import Optional

import torch

from meshclust_tpu_torch import _ext
from meshclust_tpu_torch.ops.classifier import (DBL_MIN, Model, mean_floor,
                                                widen)

# pb_band's and pb_dist's tile of members (kTile) and their block
# (kTileThreads); pb_pick's and pb_merge's block (kThreads; pb_pick takes a
# member a thread).
TILE = 32
TILE_THREADS = 128
THREADS = 256
# A tile's staged rows in shared memory: at most STAGE_BYTES of member and
# center rows, at most SPAN_ROWS center rows (kStageBytes, kSpanRows).
STAGE_BYTES = 49152
SPAN_ROWS = 32
# The bits of a word of pb_band's positives (2 delta + 1 bits a member).
WORD_BITS = 32
# pb_merge's scratch: the last block's ticket, the tiles' ticket and the
# count of listed chains, then NP, the list and a look-back descriptor a
# tile, C int64 each (kTicket, kTiles, kMerged, kScratchHead).
TICKET = 0
TILES = 1
MERGED = 2
SCRATCH_HEAD = 3
# State.paths: the tiles pb_band and pb_dist ran on each path (kBandStaged,
# kBandGlobal, kDistStaged, kDistGlobal).
PATHS = ("band_staged", "band_global", "dist_staged", "dist_global")


def words(delta: int) -> int:
    """pb_band's 32-bit words of positives a member."""
    return (2 * delta + 1 + WORD_BITS - 1) // WORD_BITS


def scratch_len(C: int) -> int:
    return SCRATCH_HEAD + 3 * C


def stage_pitch(length: int) -> int:
    """A staged row's pitch in bytes (stage_pitch): its 16-byte pieces, an
    odd number of them; 0 where a tile's member rows and one center row do
    not fit STAGE_BYTES."""
    pitch = 16 * ((-(-length // 16)) | 1)
    return pitch if (TILE + 1) * pitch <= STAGE_BYTES else 0


def stage_cap(length: int, span_cap: int = -1) -> int:
    """The center rows a tile of rows of `length` bytes may stage
    (stage_cap): a tile whose span of centers is longer takes the global
    path."""
    pitch = stage_pitch(length)
    if pitch == 0:
        return 0
    cap = min(SPAN_ROWS, (STAGE_BYTES - TILE * pitch) // pitch)
    return span_cap if 0 <= span_cap < cap else cap


def n_jump(C: int) -> int:
    """The plain merge's pointer jumps: t only moves up, so ceil(log2 C)
    jumps reach each chain's end."""
    return max(1, math.ceil(math.log2(max(2, C))))


class State:
    """One Phase B's tensors on one device.

    The pool (this rank's block of it): rows [M, V], the members' histogram
    rows in their storage dtype; m_idx [M], their point rows; m_valid [M]
    bool, False on a mesh's padding (None: all valid); m_all [M_all], every
    rank's pool; goff, this block's first pool position. The points: hist
    [N, V] (storage dtype), mag, sq, lenf [N] float64, and the classifier
    (ops/classifier.Model). The centers: c_idx [C], c_valid [C] bool, remap
    [C] (identity at first) and t_hist [iterations, C]. Per iteration:
    assign [M], bits [M, words(delta)] int32, sc [C, V + 1] int64 (zero
    between iterations), dstore [2 delta + 1, M] float64 (d of the
    positives, offset-major: dstore[oi, m] is member m's at offset index
    oi), best_d [C] float64, best_pos [C] int64 and pb_merge's scratch.
    The valid centers are a dense prefix of c_idx, with c_idx 0 past it
    (the merge keeps it so; pb_merge's last block relies on it). The constructor checks what every kernel takes."""

    def __init__(self, model: Model, hist, mag, sq, lenf, rows, m_idx,
                 m_valid: Optional[torch.Tensor], m_all, goff: int, assign,
                 c_idx, delta: int, iterations: int = 0):
        dev = hist.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        if delta < 0:
            raise ValueError(f"delta {delta} < 0")
        M, V = rows.shape
        C = c_idx.shape[0]
        for name, t in (("hist", hist), ("rows", rows)):
            if t.dim() != 2 or t.dtype not in _ext._WIDTHS \
                    or t.shape[1] != V \
                    or (V > 1 and t.stride(1) != 1):
                raise ValueError(f"{name}: need [*, {V}] int8/16/32/64 with "
                                 f"unit lane stride, got {tuple(t.shape)} "
                                 f"{t.dtype}")
        if rows.dtype != hist.dtype:
            raise ValueError(f"rows {rows.dtype} and hist {hist.dtype}")
        N = hist.shape[0]
        for name, t, dtype, n in (
                ("mag", mag, torch.float64, N), ("sq", sq, torch.float64, N),
                ("lenf", lenf, torch.float64, N),
                ("m_idx", m_idx, torch.int64, M),
                ("assign", assign, torch.int64, M),
                ("c_idx", c_idx, torch.int64, C),
                ("m_all", m_all, torch.int64, m_all.shape[0])) + (
                () if m_valid is None else
                (("m_valid", m_valid, torch.bool, M),)):
            if t.dtype != dtype or t.shape != (n,) or not t.is_contiguous() \
                    or t.device != dev:
                raise ValueError(f"{name}: need contiguous [{n}] {dtype} on "
                                 f"{dev}, got {tuple(t.shape)} {t.dtype} on "
                                 f"{t.device}")
        for t in (model.spec, model.coef, rows):
            if t.device != dev:
                raise ValueError(f"tensors on {t.device} and {dev}")
        if max(M, C, N, m_all.shape[0], C * (V + 1)) >= 2 ** 31:
            raise ValueError("Phase B's kernels index members, centers and "
                             "sc's rows with int32")
        self.model, self.hist, self.mag, self.sq, self.lenf = \
            model, hist, mag, sq, lenf
        self.rows, self.m_idx, self.m_valid = rows, m_idx, m_valid
        self.m_all, self.goff, self.delta = m_all, int(goff), int(delta)
        self.assign = assign.clone()
        i64 = {"dtype": torch.int64, "device": dev}
        self.c_idx = c_idx.clone()
        self.c_valid = torch.ones(C, dtype=torch.bool, device=dev)
        self.remap = torch.arange(C, **i64)
        self.t_hist = torch.empty((iterations, C), **i64)
        self.bits = torch.zeros((M, words(delta)), dtype=torch.int32,
                                device=dev)
        self.sc = torch.zeros((C, V + 1), **i64)
        self.dstore = torch.zeros((2 * delta + 1, M), dtype=torch.float64,
                                  device=dev)
        self.best_d = torch.empty(C, dtype=torch.float64, device=dev)
        self.best_pos = torch.empty(C, **i64)
        self.scratch = torch.zeros(scratch_len(C), **i64)
        self.paths = torch.zeros(len(PATHS), **i64)
        self.span_cap = -1

    @property
    def on_cpu(self) -> bool:
        return self.hist.device.type == "cpu"

    def final_assign(self) -> torch.Tensor:
        """assign after the last merge (the next band would apply remap)."""
        return self.remap[self.assign]


def _bit(pb: State, oi: int) -> torch.Tensor:
    return ((pb.bits[:, oi // 32] >> (oi % 32)) & 1) != 0


# -- pb_band ------------------------------------------------------------------

def band(pb: State) -> None:
    """assign = remap[assign]; best_d = inf, best_pos = M_all; bits[m] the
    positives of member m over offsets -delta .. delta (bit o + delta);
    their rows and count added into sc (zero on entry)."""
    if pb.on_cpu:
        return band_plain(pb)
    M, V = pb.rows.shape
    _ext._launched(_ext.lib().mc_pb_band(
        pb.rows.data_ptr(), pb.rows.stride(0), pb.hist.data_ptr(),
        pb.hist.stride(0), V, _ext._WIDTHS[pb.rows.dtype],
        pb.m_idx.data_ptr(),
        None if pb.m_valid is None else pb.m_valid.data_ptr(), M,
        pb.assign.data_ptr(), pb.remap.data_ptr(), pb.c_idx.data_ptr(),
        pb.c_valid.data_ptr(), pb.c_idx.shape[0], pb.mag.data_ptr(),
        pb.sq.data_ptr(), pb.lenf.data_ptr(), pb.model.spec.data_ptr(),
        pb.model.spec.shape[0], pb.model.coef.data_ptr(),
        pb.model.coef.shape[0], pb.delta, pb.bits.data_ptr(),
        pb.sc.data_ptr(), pb.best_d.data_ptr(), pb.best_pos.data_ptr(),
        pb.m_all.shape[0], pb.span_cap, pb.paths.data_ptr(),
        _ext.stream_of(pb.hist)), "pb_band")


def band_plain(pb: State) -> None:
    """DeviceBackend._band_argmin's first offset loop (pos & checks,
    index_add_ of the rows and counts), with the bits recorded."""
    V = pb.rows.shape[1]
    C = pb.c_idx.shape[0]
    pb.assign.copy_(pb.remap[pb.assign])
    pb.best_d.fill_(float("inf"))
    pb.best_pos.fill_(pb.m_all.shape[0])
    pb.bits.zero_()
    h_m = widen(pb.rows)
    for oi, o in enumerate(range(-pb.delta, pb.delta + 1)):
        j = pb.assign + o
        jc = j.clamp(0, C - 1)
        pos, _ = pb.model.scorer.pairs(pb.hist, pb.mag, pb.sq, pb.lenf,
                                       pb.c_idx[jc], pb.m_idx, h_m)
        pos = pos & (j >= 0) & (j < C) & pb.c_valid[jc]
        if pb.m_valid is not None:
            pos = pos & pb.m_valid
        pb.sc[:, :V].index_add_(0, jc, torch.where(pos[:, None], h_m, 0).to(
            torch.int64))
        pb.sc[:, V].index_add_(0, jc, pos.to(torch.int64))
        pb.bits[:, oi // 32] |= pos.to(torch.int32) << (oi % 32)


# -- pb_dist ------------------------------------------------------------------

def dist(pb: State) -> None:
    """cw = floor(sums / max(count, 1)) (mean_floor); for each positive of
    member m at offset index oi, d = 10000 * (1 - frac^2), frac = 2 * sum
    min(h_m, cw) / (mag_m + sum cw), into dstore[oi, m] (other entries as
    they were), and best_d[jc] = the least d of jc's positives."""
    if pb.on_cpu:
        return dist_plain(pb)
    M, V = pb.rows.shape
    _ext._launched(_ext.lib().mc_pb_dist(
        pb.rows.data_ptr(), pb.rows.stride(0), V,
        _ext._WIDTHS[pb.rows.dtype], pb.m_idx.data_ptr(), M, pb.assign.data_ptr(), pb.mag.data_ptr(),
        pb.delta, pb.bits.data_ptr(), pb.sc.data_ptr(), pb.dstore.data_ptr(),
        pb.best_d.data_ptr(), pb.span_cap, pb.paths.data_ptr(),
        _ext.stream_of(pb.hist)), "pb_dist")


def dist_plain(pb: State) -> None:
    """_band_argmin's second offset loop."""
    V = pb.rows.shape[1]
    C = pb.c_idx.shape[0]
    cw = mean_floor(pb.sc[:, :V], pb.sc[:, V].clamp(min=1)[:, None])
    h_m = widen(pb.rows)
    cw_rows = cw.to(h_m.dtype)
    cw_sum = cw.sum(1)                 # exact: integers below 2^53
    mag_m = pb.mag[pb.m_idx]
    for oi, o in enumerate(range(-pb.delta, pb.delta + 1)):
        pos = _bit(pb, oi)
        jc = (pb.assign + o).clamp(0, C - 1)
        dist_ = 2 * torch.minimum(h_m, cw_rows[jc]).sum(1, dtype=torch.int64)
        # floor(h + mean) = h + floor(mean) for integer h, so mean_select's
        # mag, sum(floor(h + mean)), is mag + sum(floor(mean))
        frac = dist_.to(torch.float64) / (mag_m + cw_sum[jc])
        # two roundings, as mean_select: no FMA
        d = 10000.0 * (1.0 - frac * frac)
        pb.dstore[oi] = torch.where(pos, d, pb.dstore[oi])
        pb.best_d.scatter_reduce_(0, jc, torch.where(pos, d, float("inf")),
                                  reduce="amin")


# -- pb_pick ------------------------------------------------------------------

def pick(pb: State) -> None:
    """best_pos[jc] = the least pool position goff + m among jc's
    positives whose d is best_d[jc] (as it was: M_all for none); sc
    zeroed (the kernel clears only the rows with a count: band adds a
    count to every row it touches)."""
    if pb.on_cpu:
        return pick_plain(pb)
    C, Vp = pb.sc.shape
    _ext._launched(_ext.lib().mc_pb_pick(
        pb.rows.shape[0], pb.assign.data_ptr(), pb.delta, pb.bits.data_ptr(),
        pb.dstore.data_ptr(), pb.best_d.data_ptr(), pb.best_pos.data_ptr(),
        pb.goff, pb.sc.data_ptr(), C, Vp - 1, _ext.stream_of(pb.hist)),
        "pb_pick")


def pick_plain(pb: State) -> None:
    """_band_argmin's third offset loop."""
    M = pb.rows.shape[0]
    C = pb.c_idx.shape[0]
    M_all = pb.m_all.shape[0]
    pool_pos = pb.goff + torch.arange(M, device=pb.assign.device)
    for oi, o in enumerate(range(-pb.delta, pb.delta + 1)):
        jc = (pb.assign + o).clamp(0, C - 1)
        tie = (pb.dstore[oi] == pb.best_d[jc]) & _bit(pb, oi)
        pb.best_pos.scatter_reduce_(0, jc, torch.where(tie, pool_pos, M_all),
                                    reduce="amin")
    pb.sc.zero_()


# -- pb_merge -----------------------------------------------------------------

def merge(pb: State, it: int) -> None:
    """The move (c_idx[i] = m_all[best_pos[i]] where best_pos[i] < M_all
    and i is valid), then the merge (ClusterFactory.cpp:427-493,
    Trainer::merge): each valid center i takes the first max f1 among the
    classifier-positive valid centers in (i, i + delta], strictly above
    DBL_MIN (Trainer.cpp:132-135): t_hist[it, i] (i where none); the kept
    centers (valid, t = i) move to a dense prefix of c_idx and c_valid, and
    remap[i] = the new slot of the end of i's merge chain."""
    if pb.on_cpu:
        return merge_plain(pb, it)
    V = pb.rows.shape[1]
    _ext._launched(_ext.lib().mc_pb_merge(
        pb.hist.data_ptr(), pb.hist.stride(0), V,
        _ext._WIDTHS[pb.hist.dtype],
        pb.c_idx.shape[0], pb.c_idx.data_ptr(), pb.c_valid.data_ptr(),
        pb.best_pos.data_ptr(), pb.m_all.data_ptr(), pb.m_all.shape[0],
        pb.mag.data_ptr(), pb.sq.data_ptr(), pb.lenf.data_ptr(),
        pb.model.spec.data_ptr(), pb.model.spec.shape[0],
        pb.model.coef.data_ptr(), pb.model.coef.shape[0], pb.delta,
        pb.t_hist[it].data_ptr(), pb.remap.data_ptr(), pb.scratch.data_ptr(),
        _ext.stream_of(pb.hist)), "pb_merge")


def merge_plain(pb: State, it: int) -> None:
    """phase_b_loop's move, merge and compaction."""
    C = pb.c_idx.shape[0]
    M_all = pb.m_all.shape[0]
    dev = pb.c_idx.device
    c_valid = pb.c_valid
    idx_c = torch.arange(C, device=dev)
    moved = (pb.best_pos < M_all) & c_valid
    c_idx = torch.where(moved, pb.m_all[pb.best_pos.clamp(max=M_all - 1)],
                        pb.c_idx)
    best_f1 = torch.full((C,), DBL_MIN, dtype=torch.float64, device=dev)
    best_t = idx_c
    h_i = widen(pb.hist[c_idx])
    for o in range(1, pb.delta + 1):
        j = idx_c + o
        jc = j.clamp(max=C - 1)
        pos, f1 = pb.model.scorer.pairs(pb.hist, pb.mag, pb.sq, pb.lenf,
                                        c_idx[jc], c_idx, h_i)
        cand = pos & (j < C) & c_valid & c_valid[jc] & (f1 > best_f1)
        best_f1 = torch.where(cand, f1, best_f1)
        best_t = torch.where(cand, jc, best_t)
    t = torch.where(c_valid, best_t, idx_c)
    pb.t_hist[it] = t
    # follow the merge chains i -> t(i) -> ...: t only moves up, so
    # ceil(log2 C) pointer jumps reach each chain's end
    T = t
    for _ in range(n_jump(C)):
        T = T[T]
    kept = c_valid & (t == idx_c)
    newpos = torch.cumsum(kept.to(torch.int64), 0) - 1
    pb.remap.copy_(newpos[T])
    dest = torch.where(kept, newpos, C)
    pb.c_idx.copy_(torch.zeros(C + 1, dtype=torch.int64, device=dev
                               ).scatter_(0, dest, c_idx)[:C])
    pb.c_valid.copy_(torch.zeros(C + 1, dtype=torch.bool, device=dev
                                 ).scatter_(0, dest, kept)[:C])


STEPS = ("band", "dist", "pick", "merge")


def steps(plain: bool) -> types.SimpleNamespace:
    """The steps: the wrappers, or (plain) their plain versions."""
    return types.SimpleNamespace(**{
        name: globals()[f"{name}_plain" if plain else name]
        for name in STEPS})

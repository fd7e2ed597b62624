"""Phase A's absorb iteration: five CUDA kernels (csrc/phase_a.cu) and
their plain PyTorch versions.

They take the place, on the card, of the torch ops of one absorb iteration
of core/accumulate_device.py (the JAX package runs the iteration as XLA
inside build_accumulate's lax.while_loop,
meshclust_tpu/core/accumulate_device.py:87). An iteration is a fixed chain
of five steps, with no host decision in it:

  window(st, ...)       the live window [w0, w1] of the center st[LAST]
                        and the first and last live slots;
  sums(st, ...)         man and dot of the center's row against the rows
                        (the kernel: only the live rows of the window);
  absorb(st, ...)       the float64 classifier, the absorb of the positives
                        into the center st[C] at stamp st[T] (owner, stamp,
                        active, sumvec, st[COUNT]), n_pos and the first max
                        of f1;
  move(st, ...)         if it absorbed, the move of the center: the
                        members' distances to their floored mean, then the
                        member closest to it, in one launch;
  next(st, ...)         the loop's decisions: if it absorbed nothing, the
                        center's slot recorded and the next center seeded,
                        or the phase done (st[DONE]); the stamp and
                        iteration counters.

Each step does nothing once st[DONE] is set, so iterations past the phase's
end change nothing and accumulate_device can run them in chunks (a CUDA
graph of CHUNK iterations) and read back st[DONE: MEMBERS + 1] once a chunk.

The scalars live in one int64 state buffer on the device (new_state), so
nothing is read back between the steps. Each step has a binder
(bind_window ...) that checks its arguments once and returns a callable
that runs it: its plain version for tensors on the CPU, its kernel on the
current stream for tensors on a CUDA device, never a fallback; the wrapper
of the same name binds and runs at once. The plain versions compute over
all N slots, as the port's Phase A did before these kernels; they agree
with the kernels on every value the next step reads (the window's live
slots, the members) and, like them, change no state once st[DONE] is set.
"""
from __future__ import annotations

import functools
import types

import torch

from meshclust_tpu_torch import _ext
from meshclust_tpu_torch.ops.classifier import Model, mean_floor

# Slots of the state buffer, as csrc/phase_a.cu's constants give them.
# TAIL, the last live slot, is pa_window's alone (its plain step leaves it);
# TICKET, pa_absorb's ticket; MOVE, pa_move's partials drawn (the bits from
# MOVE_SHIFT up) and members counted (the bits below); slot 10 is unused.
# The loop's: DONE, set when the phase has ended; ITERS, the iterations run;
# C, the current center's id, which is also the number of centers recorded
# before it; MEMBERS, the members of the recorded centers; T, the stamp of
# the next absorb.
NPOS, BEST, LAST, LIVE, W0, W1, COUNT, TAIL = range(8)
TICKET, MOVE = 8, 9
DONE, ITERS, C, MEMBERS, T = range(11, 16)
MOVE_SHIFT = 40
# 24: an earlier phase_a.cu (built beside this one by profile_port.py
# --parts phase_a) uses slots up to 18 of the same buffer
STATE_LEN = 24
# Columns of pa_window's table (kFront ... kBin; window_table_plain and
# core/accumulate_device.window_ranges say what each holds).
RANGES = ("FRONT", "GE", "FRONT_END", "BACK", "EQ", "GT", "BACK_END", "BIN")
FRONT, GE, FRONT_END, BACK, EQ, GT, BACK_END, BIN = range(len(RANGES))
# The most blocks of pa_absorb's grid (kBlocks; the card's resident blocks,
# as pa_sums's), and the partials a block writes there (four) and a busy
# tile in pa_move (three).
BLOCKS = 528
THREADS = 256
PARTIALS = 4
# pa_sums and pa_move: the widest piece of a row a lane loads, and the loads
# a lane has in flight before it reduces (kPieceBytes, kUnroll).
PIECE_BYTES = 16
SUMS_UNROLL = 4
# pa_window: its one block's warps, a query each, and the 16-byte vectors
# of flags a lane has in flight (kWindowWarps, kWinLoads).
WINDOW_WARPS = 7
WINDOW_LOADS = 2
# pa_move: the 16-byte loads of owners a thread makes (a block's tile:
# THREADS * 2 * OWNER_LOADS slots), and the bytes of the floored mean a
# block keeps in shared memory (kOwnerLoads, kCwBytes).
OWNER_LOADS = 2
CW_BYTES = 8192


def owner_tiles(n: int) -> int:
    """The blocks of pa_move: a tile of owners each (THREADS * 2 *
    OWNER_LOADS slots)."""
    return max(1, -(-n // (THREADS * 2 * OWNER_LOADS)))


def part_len(n: int) -> int:
    """The kernels' scratch for n slots, int64: the partials, PARTIALS a
    block of pa_absorb's grid or a tile of pa_move's."""
    return PARTIALS * max(BLOCKS, owner_tiles(n))


def new_state(n: int, device) -> tuple:
    """(st [STATE_LEN] int64, part [part_len(n)] int64) for n slots:
    pa_window scans for the first live slot on from st[LIVE] and for the
    last down from st[TAIL], so they start at 0 and n - 1 (slots only die
    in a phase)."""
    st = torch.zeros(STATE_LEN, dtype=torch.int64)
    st[TAIL] = n - 1
    return (st.to(device),
            torch.zeros(part_len(n), dtype=torch.int64, device=device))


# -- checks -------------------------------------------------------------------

def _device(*ts) -> torch.device:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _vec(t: torch.Tensor, dtype, n: int, name: str) -> None:
    if t.dtype != dtype or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(f"{name}: need contiguous [{n}] {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _state(st: torch.Tensor) -> None:
    _vec(st, torch.int64, STATE_LEN, "st")


def _rows(rows: torch.Tensor, n: int) -> int:
    """The rows' element width in bytes; rows [n, V] with unit lane stride
    (a column slice keeps its row stride)."""
    if rows.dim() != 2 or rows.shape[0] != n \
            or rows.dtype not in _ext._WIDTHS \
            or (rows.shape[1] > 1 and rows.stride(1) != 1):
        raise ValueError(f"rows: need [{n}, V] int8/16/32/64 with unit lane "
                         f"stride, got {tuple(rows.shape)} {rows.dtype} "
                         f"strides {rows.stride()}")
    return _ext._WIDTHS[rows.dtype]


def _slot_arrays(n: int, active, **int64s) -> None:
    _vec(active, torch.bool, n, "active")
    for name, t in int64s.items():
        _vec(t, torch.int64, n, name)


def _kernel(name: str, entry, on: torch.Tensor, *args):
    """A callable that launches kernel `name` through the library's entry
    point on args, on the current stream of on's device. args hold the
    tensors' addresses: the caller keeps the tensors while it may run."""
    def launch():
        _ext._launched(entry(*args, _ext.stream_of(on)), name)
    return launch


def _wrapper(bind):
    """The wrapper of a binder: its checks, then one run."""
    @functools.wraps(bind)
    def run(*args):
        bind(*args)()
    run.__name__ = run.__qualname__ = bind.__name__[len("bind_"):]
    return run


def _go(st: torch.Tensor) -> torch.Tensor:
    """True (a 0-dim tensor) until st[DONE] is set: a plain step's writes
    are taken only then, as the kernels return at once after it."""
    return st[DONE] == 0


def _put(st, slots, values) -> None:
    """st[slot] = value (0-dim tensors) until st[DONE] is set."""
    go = _go(st)
    for slot, value in zip(slots, values):
        st[slot] = torch.where(go, value, st[slot])


def _first(mask: torch.Tensor, slots: torch.Tensor, n: int) -> torch.Tensor:
    """The first slot of a mask, n if none (a masked min: ties never
    depend on argmax's choice)."""
    return torch.where(mask, slots, n).min()


def _last(mask: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, slots, -1).max()


# -- pa_window ----------------------------------------------------------------

def bind_window(st, active, ranges):
    """st[W0], st[W1]: the inclusive slot range of bvec::get_range(lo, hi)
    of the center at slot st[LAST] over the live slots; st[LIVE] and
    st[TAIL]: the first and last live slots (n and -1 if none), found on
    from their values before the call, which no live slot may precede or
    follow. active bool [n]; ranges [n, len(RANGES)] int32, the table of
    core/accumulate_device.window_ranges (window_table_plain says what it
    holds). The same window as window_plain's on the per-slot arrays."""
    n = active.shape[0]
    _state(st)
    _vec(active, torch.bool, n, "active")
    if ranges.dtype != torch.int32 or ranges.shape != (n, len(RANGES)) \
            or not ranges.is_contiguous():
        raise ValueError(f"ranges: need contiguous [{n}, {len(RANGES)}] "
                         f"int32, got {tuple(ranges.shape)} {ranges.dtype}")
    if _device(st, active, ranges).type == "cpu":
        return functools.partial(window_table_plain, st, active, ranges)
    return _kernel("pa_window", _ext.lib().mc_pa_window, st, st.data_ptr(),
                   active.data_ptr(), ranges.data_ptr(), n)


window = _wrapper(bind_window)


def window_table_plain(st, active, ranges):
    """window's function on its table. The center's row names slot ranges
    [a, b) of the bvec order (bins concatenated, lengths non-decreasing):
    the front bin [FRONT, FRONT_END), its slots of length >= lo from GE;
    the back bin [BACK, BACK_END), its slots of length == hi [EQ, GT) and
    > hi from GT; BIN, a slot's own bin's first slot. Then
      w0 = the first live of [GE, FRONT_END), else the last live of
           [FRONT, GE), else the first live slot;
      w1 = the last live of [EQ, GT), else the first live of [GT,
           BACK_END), else the last live of [BACK, EQ), else (no live slot
           in the back bin) the first live of [BIN of the last live slot,
           it] (the truncation quirk), -1 if none."""
    n = active.shape[0]
    slots = torch.arange(n, device=active.device)
    row = ranges[st[LAST]].to(torch.int64)

    def span(a, b):
        return active & (slots >= a) & (slots < b)

    first_live = _first(active, slots, n)
    live_last = _last(active, slots)
    a = _first(span(row[GE], row[FRONT_END]), slots, n)
    b = _last(span(row[FRONT], row[GE]), slots)
    w0 = torch.where(a < n, a, torch.where(b >= 0, b, first_live))
    c = _last(span(row[EQ], row[GT]), slots)
    d = _first(span(row[GT], row[BACK_END]), slots, n)
    e = _last(span(row[BACK], row[EQ]), slots)
    quirk = _first(active & (slots >= ranges[live_last.clamp(min=0), BIN]),
                   slots, n)
    w1 = torch.where(c >= 0, c, torch.where(
        d < n, d, torch.where(e >= 0, e, torch.where(live_last >= 0, quirk,
                                                     -1))))
    _put(st, (W0, W1, LIVE, TAIL), (w0, w1, first_live, live_last))


def window_plain(st, active, bin_, len_, lo, hi, front_bin, back_bin):
    """Lengths and bins are sorted over slots, so every case of
    bvec::inner_index_of is a first or last live slot under a mask:
      front: the first live slot of the front bin with length >= lo;
             none: the LAST live slot of that bin; an empty bin: the first
             live slot overall;
      back:  the last live slot of the back bin with length == hi; else
             its first live slot with length > hi; else its last live slot;
             an empty bin: the FIRST live slot of the LAST non-empty bin
             (the truncation quirk), -1 if none."""
    n = active.shape[0]
    slots = torch.arange(n, device=active.device)
    last = st[LAST: LAST + 1]
    in_f = active & (bin_ == front_bin[last])
    s_ge = _first(in_f & (len_ >= lo[last]), slots, n)
    s_last_f = _last(in_f, slots)
    first_live = _first(active, slots, n)
    w0 = torch.where(s_last_f >= 0, torch.where(s_ge < n, s_ge, s_last_f),
                     first_live)
    hi_c = hi[last]
    in_b = active & (bin_ == back_bin[last])
    s_eq_last = _last(in_b & (len_ == hi_c), slots)
    s_gt = _first(in_b & (len_ > hi_c), slots, n)
    s_last_b = _last(in_b, slots)
    live_last = _last(active, slots)
    first_of_last = _first(
        active & (bin_ == bin_[live_last.clamp(min=0).reshape(1)]), slots, n)
    w1 = torch.where(
        s_last_b >= 0,
        torch.where(s_eq_last >= 0, s_eq_last,
                    torch.where(s_gt < n, s_gt, s_last_b)),
        torch.where(live_last >= 0, first_of_last, -1))
    _put(st, (W0, W1, LIVE), (w0.reshape(()), w1.reshape(()),
                              first_live))


# -- pa_sums ------------------------------------------------------------------

def bind_sums(st, active, rows, out):
    """out[0, s] = sum_v |h[c, v] - h[s, v]| and, when out has two rows,
    out[1, s] = sum_v h[c, v] * h[s, v] (int64), c = st[LAST], for every
    live slot s of [st[W0], st[W1]]; the kernel leaves the other slots as
    they were. rows [n, V] in any integer dtype (or a column slice)."""
    n = active.shape[0]
    _state(st)
    _vec(active, torch.bool, n, "active")
    width = _rows(rows, n)
    if out.dtype != torch.int64 or out.dim() != 2 \
            or out.shape[0] not in (1, 2) or out.shape[1] != n \
            or not out.is_contiguous():
        raise ValueError(f"out: need contiguous [1 or 2, {n}] int64")
    if _device(st, active, rows, out).type == "cpu":
        return functools.partial(sums_plain, st, active,
                                 rows.to(torch.int64), out)
    return _kernel("pa_sums", _ext.lib().mc_pa_sums, st, st.data_ptr(),
                   active.data_ptr(), rows.data_ptr(), rows.stride(0),
                   rows.shape[1], width, n, int(out.shape[0] == 2),
                   out.data_ptr())


sums = _wrapper(bind_sums)


def sums_plain(st, active, rows, out):
    """Every slot; rows whose products of two counts fit their dtype
    (ops/classifier.row_dtype)."""
    h_a = rows[st[LAST: LAST + 1]]
    out[0] = (h_a - rows).abs().sum(-1, dtype=torch.int64)
    if out.shape[0] == 2:
        out[1] = (h_a * rows).sum(-1, dtype=torch.int64)


# -- pa_absorb ----------------------------------------------------------------

def bind_absorb(st, sums_, model: Model, mag, sq, lenf, owner, stamp, active,
                rows, sumvec, part):
    """Classify every live slot of [st[W0], st[W1]] against the center
    st[LAST] (Scorer.__call__ on sums_, float64 mag, sq and lengths [n])
    and absorb the positives: owner = st[C], stamp = st[T], active = False,
    their rows added into sumvec [V] int64; st[NPOS] = their count, added to
    st[COUNT]; st[BEST] = the first max of f1 over the window (least slot
    among equal f1), n if the window is empty."""
    n = active.shape[0]
    _state(st)
    _slot_arrays(n, active, owner=owner, stamp=stamp)
    for name, x in (("mag", mag), ("sq", sq), ("lenf", lenf)):
        _vec(x, torch.float64, n, name)
    width = _rows(rows, n)
    _vec(sumvec, torch.int64, rows.shape[1], "sumvec")
    k = 2 if model.with_dot else 1
    if sums_.dtype != torch.int64 or sums_.shape != (k, n) \
            or not sums_.is_contiguous():
        raise ValueError(f"sums: need contiguous [{k}, {n}] int64")
    _vec(part, torch.int64, part_len(n), "part")
    dev = _device(st, sums_, model.spec, model.coef, mag, sq, lenf, owner,
                  stamp, active, rows, sumvec, part)
    if dev.type == "cpu":
        return functools.partial(absorb_plain, st, sums_, model, mag, sq,
                                 lenf, owner, stamp, active, rows, sumvec,
                                 part)
    return _kernel("pa_absorb", _ext.lib().mc_pa_absorb, st, st.data_ptr(),
                   sums_.data_ptr(), int(model.with_dot),
                   model.spec.data_ptr(), model.spec.shape[0],
                   model.coef.data_ptr(), model.coef.shape[0],
                   mag.data_ptr(), sq.data_ptr(), lenf.data_ptr(),
                   owner.data_ptr(), stamp.data_ptr(), active.data_ptr(),
                   rows.data_ptr(), rows.stride(0), rows.shape[1], width,
                   sumvec.data_ptr(), n, part.data_ptr())


absorb = _wrapper(bind_absorb)


def absorb_plain(st, sums_, model, mag, sq, lenf, owner, stamp, active,
                 rows, sumvec, part):
    n = active.shape[0]
    slots = torch.arange(n, device=active.device)
    last = st[LAST: LAST + 1]
    ok = active & (slots >= st[W0]) & (slots <= st[W1]) & _go(st)
    pos, f1 = model.scorer(sums_[0], sums_[1] if model.with_dot else None,
                           mag[last], mag, sq[last], sq, lenf[last], lenf)
    f1 = torch.where(ok, f1, float("-inf"))
    best = _first(ok & (f1 == f1.max()), slots, n)
    pos &= ok
    owner.copy_(torch.where(pos, st[C], owner))
    stamp.copy_(torch.where(pos, st[T], stamp))
    active &= ~pos
    sumvec += torch.where(pos[:, None], rows, 0).sum(0, dtype=torch.int64)
    n_pos = pos.sum()
    _put(st, (NPOS, BEST), (n_pos, best))
    st[COUNT: COUNT + 1] += n_pos


# -- pa_move ------------------------------------------------------------------

def bind_move(st, owner, rows, sumvec, mag, stamp, dist, part):
    """The move of the center st[C], in one launch: cw = floor(sumvec /
    st[COUNT]) (float64, as mean_floor); dist[s] = 2 * sum_v min(h[s, v],
    cw[v]) for every member s (owner == st[C]; the kernel leaves the other
    slots as they were) and dist[n] = sum_v cw[v], int64; then get_mean
    (ClusterFactory.cpp:382-425): st[LAST] = the member closest by
    distance_d to the members' mean, d = 10000 * (1 - frac^2), frac =
    dist[s] / (mag[s] + dist[n]) (floor(h + mean) = h + floor(mean) for
    integer h), ties to the least stamp, then the least slot (the
    reference's member-list order). Nothing where st[NPOS] is 0 (the
    iteration absorbed nothing) or st[DONE] is set. st[COUNT] must be the
    number of members, as accumulate_device keeps it."""
    n = owner.shape[0]
    _state(st)
    _vec(owner, torch.int64, n, "owner")
    width = _rows(rows, n)
    _vec(sumvec, torch.int64, rows.shape[1], "sumvec")
    _vec(mag, torch.float64, n, "mag")
    _vec(stamp, torch.int64, n, "stamp")
    _vec(dist, torch.int64, n + 1, "dist")
    _vec(part, torch.int64, part_len(n), "part")
    if _device(st, owner, rows, sumvec, mag, stamp, dist,
               part).type == "cpu":
        return functools.partial(move_plain, st, owner, rows, sumvec, mag,
                                 stamp, dist, part)
    return _kernel("pa_move", _ext.lib().mc_pa_move, st, st.data_ptr(),
                   owner.data_ptr(), rows.data_ptr(), rows.stride(0),
                   rows.shape[1], width, sumvec.data_ptr(), n,
                   mag.data_ptr(), stamp.data_ptr(), dist.data_ptr(),
                   part.data_ptr())


move = _wrapper(bind_move)


def move_plain(st, owner, rows, sumvec, mag, stamp, dist, part):
    """dist of every slot, whether it moves or not. floor(mean) is at most
    the largest count, so it fits the rows' dtype."""
    cw = mean_floor(sumvec, st[COUNT])
    dist[:-1] = 2 * torch.minimum(rows, cw.to(rows.dtype)).sum(
        1, dtype=torch.int64)
    dist[-1] = cw.sum()                # exact: integers below 2^53
    st[LAST] = torch.where(_go(st) & (st[NPOS] != 0),
                           _mean_argmin(st, dist, mag, owner, stamp),
                           st[LAST])


def _mean_argmin(st, dist, mag, owner, stamp) -> torch.Tensor:
    """The member of center st[C] least by (d, stamp, slot) on the
    distances dist (move_plain's), a 0-dim tensor."""
    n = owner.shape[0]
    slots = torch.arange(n, device=owner.device)
    frac = dist[:n].to(torch.float64) / (mag + dist[n].to(torch.float64))
    d = 10000.0 * (1.0 - frac * frac)      # two roundings, no FMA
    mask = owner == st[C]
    d = torch.where(mask, d, float("inf"))
    cand = mask & (d == d.min())
    first_stamp = torch.where(cand, stamp,
                              torch.iinfo(torch.int64).max).min()
    return _first(cand & (stamp == first_stamp), slots, n)


# -- pa_next ------------------------------------------------------------------

def bind_next(st, active, owner, stamp, rows, sumvec, center_slot,
              cmax: int):
    """The end of an iteration: st[T] + 1 spent by its absorb, st[ITERS]
    counted. If it absorbed nothing (st[NPOS] == 0), center c = st[C] ends:
    center_slot[c] = st[LAST], st[MEMBERS] += st[COUNT], st[C] = c + 1,
    and the seed is st[BEST] if < n, else st[LIVE] (the first live slot).
    With no seed (>= n) or c + 1 >= cmax, st[DONE] = 1; else the seed is
    taken from the live slots as center c + 1's one member (owner, stamp
    st[T], st[LAST], st[COUNT] = 1, sumvec = its row) and st[T] advances
    once more. Nothing once st[DONE] is set. center_slot [n + 1] int64."""
    n = active.shape[0]
    _state(st)
    _slot_arrays(n, active, owner=owner, stamp=stamp)
    width = _rows(rows, n)
    _vec(sumvec, torch.int64, rows.shape[1], "sumvec")
    _vec(center_slot, torch.int64, n + 1, "center_slot")
    if _device(st, active, owner, stamp, rows, sumvec,
               center_slot).type == "cpu":
        return functools.partial(next_plain, st, active, owner, stamp, rows,
                                 sumvec, center_slot, cmax)
    return _kernel("pa_next", _ext.lib().mc_pa_next, st, st.data_ptr(),
                   active.data_ptr(), owner.data_ptr(), stamp.data_ptr(),
                   rows.data_ptr(), rows.stride(0), rows.shape[1], width,
                   sumvec.data_ptr(), center_slot.data_ptr(), n, cmax)


next = _wrapper(bind_next)    # shadows the builtin here: pa_next


def next_plain(st, active, owner, stamp, rows, sumvec, center_slot, cmax):
    """With no read back: every decision is a mask, every write a where
    (indices as one-element tensors)."""
    n = active.shape[0]
    old = st.clone()
    go = old[DONE: DONE + 1] == 0
    ends = go & (old[NPOS: NPOS + 1] == 0)
    c = old[C: C + 1]
    t = old[T: T + 1] + 1
    seed = torch.where(old[BEST: BEST + 1] < n, old[BEST: BEST + 1],
                       old[LIVE: LIVE + 1])
    stop = ends & ((seed >= n) | (c + 1 >= cmax))
    begins = ends & ~stop
    at = seed.clamp(max=n - 1)
    center_slot[c] = torch.where(ends, old[LAST: LAST + 1], center_slot[c])
    active[at] = active[at] & ~begins
    owner[at] = torch.where(begins, c + 1, owner[at])
    stamp[at] = torch.where(begins, t, stamp[at])
    sumvec.copy_(torch.where(begins, rows[at], sumvec)[0])
    st[LAST: LAST + 1] = torch.where(begins, at, old[LAST: LAST + 1])
    st[COUNT: COUNT + 1] = torch.where(begins, 1, old[COUNT: COUNT + 1])
    st[MEMBERS: MEMBERS + 1] += torch.where(ends, old[COUNT: COUNT + 1], 0)
    st[C: C + 1] = c + ends.to(torch.int64)
    st[T: T + 1] = torch.where(go, t + begins.to(torch.int64), old[T: T + 1])
    st[ITERS: ITERS + 1] += go.to(torch.int64)
    st[DONE: DONE + 1] += stop.to(torch.int64)


STEPS = ("window", "sums", "absorb", "move", "next")


def steps(plain: bool) -> types.SimpleNamespace:
    """The steps' binders: each takes its step's arguments (those of the
    wrapper of the same name) and returns a callable that runs the step:
    the binders of the kernels (bind_window ...), or (plain) their plain
    versions' on any device."""
    def plain_binder(fn):
        return lambda *args: functools.partial(fn, *args)
    return types.SimpleNamespace(**{
        name: plain_binder(globals()[f"{name}_plain"]) if plain
        else globals()[f"bind_{name}"] for name in STEPS})

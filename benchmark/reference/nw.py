"""GlobAlignE identities in plain PyTorch, recomputed for pairs of the
corpus.

`batch_align` is frozen from the program's ops/align.py (its plain
anti-diagonal sweep, int32 state [P, R]), with the diagonal index kept on
the device so that a step can be replayed as a CUDA graph.
`continue_first` turns on the align-mode control's fault: on a tie the gap
lanes continue a gap rather than open one, against GlobAlignE's gap-begin
over gap-continue (GlobAlignE.cpp:186-193, 258-273).

Reference: GlobAlignE::findAlignment (GlobAlignE.cpp:123-292) — a two-column
rolling DP with 9 lanes: score/length/identity x {match, upperGap, lowerGap},
with fixed tie-break priorities:
  upper:  gap-begin over gap-continue              (GlobAlignE.cpp:186-193)
  match:  matched > xgapEnd(lower) > ygapEnd(upper) (GlobAlignE.cpp:207-241)
  lower:  gap-begin over gap-continue              (GlobAlignE.cpp:258-273)
  final:  matches > lowerGap > upperGap            (GlobAlignE.cpp:278-291)
identity = totalMatches / alignmentLength (GlobAlignE.cpp:301-305).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

# Elements of one launch's [P, R] state: pairs are cut into batches of
# similar length under this.
BATCH_ELEMENTS = 1 << 24
# On CUDA the sweep runs these diagonals plainly, then captures one step in
# a CUDA graph and replays it for the rest: the same operations, without a
# Python dispatch for each of a diagonal's ~70.
GRAPH_WARMUP = 3


def neg_inf_sentinel(l1: torch.Tensor, l2: torch.Tensor, mismatch: int,
                     go: int, gc: int) -> torch.Tensor:
    """The reference's finite 'negativeInf' (GlobAlignE.cpp:125-135).

    l1/l2 are the sequence LENGTHS (the C++ len1/len2 are length+1).
    """
    shorter = torch.minimum(l1, l2)
    len_diff = torch.abs(l2 - l1)
    base = mismatch * shorter - 1
    return torch.where(len_diff >= 1, base - go - len_diff * gc, base)


def batch_align(seq1: torch.Tensor, seq2: torch.Tensor, l1: torch.Tensor,
                l2: torch.Tensor, match: int = 1, mismatch: int = -1,
                go: int = 2, gc: int = 1, continue_first: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Align P pairs. seq1 [P, R-1] and seq2 [P, L2max] codes (padded), l1/l2
    [P] true lengths (R-1 >= max l1, L2max >= max l2).

    Returns (score, align_len, matches), each [P] int32. Pairs with
    l1 + l2 < 2 keep (0, 1, 0)."""
    i32 = torch.int32
    dev = seq1.device
    P = seq1.shape[0]
    R = seq1.shape[1] + 1
    L2max = seq2.shape[1]
    l1 = l1.to(i32)
    l2 = l2.to(i32)
    D = int((l1 + l2).max()) + 1 if P else 2
    neg = neg_inf_sentinel(l1, l2, mismatch, go, gc)[:, None]     # [P, 1]
    rows = torch.arange(R, dtype=i32, device=dev)[None, :]         # i index
    # A[p, i] = seq1[p, i-1] for i >= 1
    A = torch.cat([torch.zeros((P, 1), dtype=i32, device=dev),
                   seq1.to(i32)], dim=1)                           # [P, R]
    # B_d[i] = seq2[d-1-i] = brev_pad[L2max + R - d + i]
    brev = torch.flip(seq2.to(i32), dims=(1,))
    zpad = torch.zeros((P, R), dtype=i32, device=dev)
    brev_pad = torch.cat([zpad, brev, zpad], dim=1)

    negf = neg.expand(P, R)
    zeros = torch.zeros((P, R), dtype=i32, device=dev)

    def full(v):
        return torch.full((P, R), v, dtype=i32, device=dev)

    # diagonal 0: only cell (0,0): M=0, UG=LG=neg, all lens/ids 0
    M2 = torch.where(rows == 0, 0, negf)
    UG2, LG2 = negf, negf
    Ml2, Ul2, Ll2 = zeros, zeros, zeros
    Mi2, Ui2, Li2 = zeros, zeros, zeros
    # diagonal 1: boundary cells (0,1) [top] and (1,0) [left]
    M1 = negf
    UG1 = torch.where(rows == 0, -go - gc, negf)
    LG1 = torch.where(rows == 1, -go - gc, negf)
    Ml1, Ul1, Ll1 = full(1), full(1), full(1)
    Mi1, Ui1, Li1 = zeros, zeros, zeros
    # the two diagonals before d, as 18 tensors the sweep updates in place
    st = [t.contiguous().clone() for t in (
        M2, UG2, LG2, Ml2, Ul2, Ll2, Mi2, Ui2, Li2,
        M1, UG1, LG1, Ml1, Ul1, Ll1, Mi1, Ui1, Li1)]

    acc = [torch.zeros(P, dtype=i32, device=dev),
           torch.ones(P, dtype=i32, device=dev),
           torch.zeros(P, dtype=i32, device=dev)]
    at_top = rows == 0
    idx = torch.clamp(l1, 0, R - 1).to(torch.int64)[:, None]
    lsum = l1 + l2
    d = torch.full((1,), 2, dtype=i32, device=dev)
    cols = torch.arange(R, dtype=torch.int64, device=dev)

    def sh(x):
        # X[i] <- X[i-1]
        return torch.cat([torch.zeros((P, 1), dtype=i32, device=dev),
                          x[:, :-1]], dim=1)

    def pick(x):
        return torch.gather(x, 1, idx)[:, 0]

    def step():
        """Diagonal d from d - 1 and d - 2, then d += 1; reads d only on
        the device, so that one captured step replays the sweep."""
        (M2, UG2, LG2, Ml2, Ul2, Ll2, Mi2, Ui2, Li2,
         M1, UG1, LG1, Ml1, Ul1, Ll1, Mi1, Ui1, Li1) = st
        bdiag = torch.index_select(brev_pad, 1,
                                   cols + (L2max + R) - d.to(torch.int64))
        s_sub = torch.where(A == bdiag, match, mismatch).to(i32)

        # UG(i,d) from (i, d-1): same row index i
        ygap_begin = M1 - (go + gc)
        ug = torch.maximum(ygap_begin, UG1 - gc)
        take = ug == ygap_begin
        if continue_first:
            take = take & (ug != UG1 - gc)
        ul = torch.where(take, Ml1, Ul1) + 1
        ui = torch.where(take, Mi1, Ui1)

        # M(i,d) from (i-1, d-2)
        matched = sh(M2) + s_sub
        xgap_end = sh(LG2) + s_sub
        ygap_end = sh(UG2) + s_sub
        m = torch.maximum(torch.maximum(matched, xgap_end), ygap_end)
        is_m = m == matched
        is_x = (~is_m) & (m == xgap_end)
        inc = (s_sub == match).to(i32)
        ml = torch.where(is_m, sh(Ml2), torch.where(is_x, sh(Ll2),
                                                    sh(Ul2))) + 1
        mi = torch.where(is_m, sh(Mi2), torch.where(is_x, sh(Li2),
                                                    sh(Ui2))) + inc

        # LG(i,d) from (i-1, d-1)
        M1s = sh(M1)
        xgap_begin = M1s - (go + gc)
        lg = torch.maximum(xgap_begin, sh(LG1) - gc)
        take = lg == xgap_begin
        if continue_first:
            take = take & (lg != sh(LG1) - gc)
        ll = torch.where(take, sh(Ml1), sh(Ll1)) + 1
        li = torch.where(take, sh(Mi1), sh(Li1))

        # boundaries: i == 0 (j = d) and i == d (j = 0)
        at_left = rows == d
        edge = at_top | at_left
        gap_edge = -go - d * gc
        m = torch.where(edge, negf, m)
        ml = torch.where(edge, d, ml)
        mi = torch.where(edge, 0, mi)
        ug = torch.where(at_top, gap_edge, torch.where(at_left, negf, ug))
        ul = torch.where(edge, d, ul)
        ui = torch.where(edge, 0, ui)
        lg = torch.where(at_left, gap_edge, torch.where(at_top, negf, lg))
        ll = torch.where(edge, d, ll)
        li = torch.where(edge, 0, li)

        # readout when d == l1 + l2, at row i = l1: M > LG > UG
        done = lsum == d
        fm, flg, fug = pick(m), pick(lg), pick(ug)
        score = torch.maximum(torch.maximum(fm, flg), fug)
        from_m = score == fm
        from_lg = (~from_m) & (score == flg)
        alen = torch.where(from_m, pick(ml),
                           torch.where(from_lg, pick(ll), pick(ul)))
        amatch = torch.where(from_m, pick(mi),
                             torch.where(from_lg, pick(li), pick(ui)))
        acc[0].copy_(torch.where(done, score, acc[0]))
        acc[1].copy_(torch.where(done, alen, acc[1]))
        acc[2].copy_(torch.where(done, amatch, acc[2]))
        for old, new in zip(st[:9], st[9:]):
            old.copy_(new)
        for old, new in zip(st[9:], (m, ug, lg, ml, ul, ll, mi, ui, li)):
            old.copy_(new)
        d.add_(1)

    steps = D - 2
    if dev.type == "cuda" and steps > GRAPH_WARMUP:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        for _ in range(steps - GRAPH_WARMUP):
            graph.replay()
    else:
        for _ in range(steps):
            step()
    return acc[0], acc[1], acc[2]


def identities(codes: List[np.ndarray], pairs: Sequence[Tuple[int, int]],
               device, continue_first: bool = False) -> np.ndarray:
    """float64 identities of (a, b) pairs of records, a the first operand,
    computed in batches of similar l1 + l2."""
    n = len(pairs)
    out = np.zeros(n, np.float64)
    if n == 0:
        return out
    la = np.asarray([codes[a].shape[0] for a, _ in pairs], np.int64)
    lb = np.asarray([codes[b].shape[0] for _, b in pairs], np.int64)
    order = np.argsort(la + lb, kind="stable")
    s = 0
    while s < n:
        e = s + 1
        while e < n and (e - s + 1) * (int(la[order[s:e + 1]].max()) + 1) \
                <= BATCH_ELEMENTS:
            e += 1
        sel = order[s:e]
        r1, r2 = int(la[sel].max()), int(lb[sel].max())
        s1 = np.zeros((sel.shape[0], r1), np.int32)
        s2 = np.zeros((sel.shape[0], r2), np.int32)
        for row, t in enumerate(sel):
            a, b = pairs[t]
            s1[row, : la[t]] = codes[a]
            s2[row, : lb[t]] = codes[b]
        _, alen, amatch = batch_align(
            torch.from_numpy(s1).to(device), torch.from_numpy(s2).to(device),
            torch.from_numpy(la[sel]).to(device),
            torch.from_numpy(lb[sel]).to(device),
            continue_first=continue_first)
        out[sel] = amatch.cpu().numpy().astype(np.float64) / np.maximum(
            alen.cpu().numpy().astype(np.float64), 1.0)
        s = e
    return out

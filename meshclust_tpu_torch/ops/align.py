"""Batched affine-gap global alignment in plain PyTorch (GlobAlignE).

Twin of meshclust_tpu/ops/align.py:batch_align, and the plain version of
the CUDA kernel csrc/nw_align_long.cu (ops/align_device.py:nw_align_long),
which computes the same function.

Reference: GlobAlignE::findAlignment (GlobAlignE.cpp:123-292) — a two-column
rolling DP with 9 lanes: score/length/identity x {match, upperGap, lowerGap},
with fixed tie-break priorities:
  upper:  gap-begin over gap-continue              (GlobAlignE.cpp:186-193)
  match:  matched > xgapEnd(lower) > ygapEnd(upper) (GlobAlignE.cpp:207-241)
  lower:  gap-begin over gap-continue              (GlobAlignE.cpp:258-273)
  final:  matches > lowerGap > upperGap            (GlobAlignE.cpp:278-291)
identity = totalMatches / alignmentLength (GlobAlignE.cpp:301-305).

Cell recurrences ((i,j) 1-based, s = match/mismatch score):

    UG(i,j) = max(M(i,j-1) - go - gc, UG(i,j-1) - gc)
    M(i,j)  = s + max(M(i-1,j-1), LG(i-1,j-1), UG(i-1,j-1))   [priority M,LG,UG]
    LG(i,j) = max(M(i-1,j) - go - gc, LG(i-1,j) - gc)

All three depend only on anti-diagonals d-1 and d-2, so this version sweeps
diagonals d with the state held as [P, R] int32 tensors (row i on the last
axis). N bytes (78) compare equal to each other.
"""
from __future__ import annotations

from typing import Tuple

import torch


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
                go: int = 2, gc: int = 1
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

    acc_score = torch.zeros(P, dtype=i32, device=dev)
    acc_len = torch.ones(P, dtype=i32, device=dev)
    acc_match = torch.zeros(P, dtype=i32, device=dev)
    at_top = rows == 0
    idx = torch.clamp(l1, 0, R - 1).to(torch.int64)[:, None]

    def sh(x):
        # X[i] <- X[i-1]
        return torch.cat([torch.zeros((P, 1), dtype=i32, device=dev),
                          x[:, :-1]], dim=1)

    def pick(x):
        return torch.gather(x, 1, idx)[:, 0]

    for d in range(2, D):
        s0 = L2max + R - d
        bdiag = brev_pad[:, s0: s0 + R]
        s_sub = torch.where(A == bdiag, match, mismatch).to(i32)

        # UG(i,d) from (i, d-1): same row index i
        ygap_begin = M1 - (go + gc)
        ug = torch.maximum(ygap_begin, UG1 - gc)
        take = ug == ygap_begin
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
        ll = torch.where(take, sh(Ml1), sh(Ll1)) + 1
        li = torch.where(take, sh(Mi1), sh(Li1))

        # boundaries: i == 0 (j = d) and i == d (j = 0)
        at_left = rows == d
        edge = at_top | at_left
        m = torch.where(edge, negf, m)
        ml = torch.where(edge, d, ml)
        mi = torch.where(edge, 0, mi)
        ug = torch.where(at_top, -go - d * gc, torch.where(at_left, negf, ug))
        ul = torch.where(edge, d, ul)
        ui = torch.where(edge, 0, ui)
        lg = torch.where(at_left, -go - d * gc, torch.where(at_top, negf, lg))
        ll = torch.where(edge, d, ll)
        li = torch.where(edge, 0, li)

        # readout when d == l1 + l2, at row i = l1: M > LG > UG
        done = (l1 + l2) == d
        fm, flg, fug = pick(m), pick(lg), pick(ug)
        score = torch.maximum(torch.maximum(fm, flg), fug)
        from_m = score == fm
        from_lg = (~from_m) & (score == flg)
        alen = torch.where(from_m, pick(ml),
                           torch.where(from_lg, pick(ll), pick(ul)))
        amatch = torch.where(from_m, pick(mi),
                             torch.where(from_lg, pick(li), pick(ui)))
        acc_score = torch.where(done, score, acc_score)
        acc_len = torch.where(done, alen, acc_len)
        acc_match = torch.where(done, amatch, acc_match)

        M2, UG2, LG2, Ml2, Ul2, Ll2, Mi2, Ui2, Li2 = (
            M1, UG1, LG1, Ml1, Ul1, Ll1, Mi1, Ui1, Li1)
        M1, UG1, LG1, Ml1, Ul1, Ll1, Mi1, Ui1, Li1 = (
            m, ug, lg, ml, ul, ll, mi, ui, li)
    return acc_score, acc_len, acc_match


def check_operands(codes: torch.Tensor, lengths: torch.Tensor,
                   ia: torch.Tensor, ib: torch.Tensor) -> None:
    """Raise ValueError unless the operands are what the NW kernels take:
    codes [N, Lpad] contiguous int8, lengths [N] int32, ia and ib [P] int32,
    all on one device."""
    if codes.dtype != torch.int8 or codes.dim() != 2 \
            or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous 2-D int8 tensor")
    if lengths.dtype != torch.int32 or lengths.dim() != 1 \
            or lengths.shape[0] != codes.shape[0]:
        raise ValueError("lengths must be int32 [N]")
    if ia.dtype != torch.int32 or ib.dtype != torch.int32 or ia.dim() != 1 \
            or ia.shape != ib.shape:
        raise ValueError("ia and ib must be int32 [P]")
    if any(t.device != codes.device for t in (lengths, ia, ib)):
        raise ValueError("all operands must be on one device")


def align_counts_plain(codes: torch.Tensor, lengths: torch.Tensor,
                       ia: torch.Tensor, ib: torch.Tensor, match: int = 1,
                       mismatch: int = -1, go: int = 2, gc: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the nw_align_long kernel:
    (alen, amatch) [P] int32 for pairs (codes[ia[p]], codes[ib[p]]) of a
    staged corpus codes [N, Lpad] int8 with lengths [N] int32."""
    P = ia.shape[0]
    if P == 0:
        e = torch.zeros(0, dtype=torch.int32, device=codes.device)
        return e, e
    ia = ia.to(torch.int64)
    ib = ib.to(torch.int64)
    l1 = lengths[ia]
    l2 = lengths[ib]
    if int(torch.minimum(l1, l2).min()) < 1:
        raise ValueError("every sequence of a pair needs length >= 1")
    seq1 = codes[ia, : int(l1.max())]
    seq2 = codes[ib, : int(l2.max())]
    _, alen, amatch = batch_align(seq1, seq2, l1, l2, match=match,
                                  mismatch=mismatch, go=go, gc=gc)
    return alen, amatch

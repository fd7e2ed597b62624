"""2n-state transition HMM (reference HMM, SURVEY R7; HMM.cpp).

States: the log-score value at each position is the state index directly
(positive states 0..n-1, negative states n..2n-1; HMM.h:58-66). Emissions
are normalized to log(1) = 0 (HMM::normalize), so the model is priors +
transitions only. Training counts transitions along candidate/background
runs (trainHelper2); decoding is Viterbi restricted to the two reachable
states per position — O(positions), implemented as a numpy loop
(oracle) and in C++ (native/red_viterbi.cpp).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


class HMM:
    def __init__(self, base: float, state_number: int):
        if state_number % 2 != 0 or state_number == 0:
            raise ValueError("The number of states must be even and > zero.")
        self.base = base
        self.log_base = math.log(base)
        self.state_number = state_number
        self.n_pos = state_number // 2
        # add-one smoothing (initializeHelper: vectors filled with 1)
        self.priors = np.ones(state_number, np.float64)
        self.trans = np.ones((state_number, state_number), np.float64)
        self._normalized = False

    # -- training ----------------------------------------------------------
    def _pstv(self, scores, i):
        return int(scores[i])

    def _ngtv(self, scores, i):
        return int(scores[i]) + self.n_pos

    def _run(self, scores: np.ndarray, s: int, e: int, negative: bool):
        """trainPositive/trainNegative: prior at the run start + transitions
        along the run (vectorized add.at)."""
        off = self.n_pos if negative else 0
        st = scores[s: e + 1].astype(np.int64) + off
        self.priors[st[0]] += 1
        if st.shape[0] > 1:
            np.add.at(self.trans, (st[:-1], st[1:]), 1)

    def _move(self, a: int, b: int):
        self.trans[a, b] += 1

    def train(self, scores: np.ndarray, segments: np.ndarray,
              candidates: Sequence[Sequence[int]]) -> None:
        """HMM::train/trainHelper2 over one chromosome."""
        cand = list(candidates)
        if not cand:
            return
        ci = 0
        for a, b in segments:
            a, b = int(a), int(b)
            if ci >= len(cand):
                break
            cs, ce = cand[ci]
            if not (a <= ce and cs <= b):
                continue
            last = ci
            for c in range(ci, len(cand)):
                if cand[c][0] <= b and a <= cand[c][1]:
                    last = c
                else:
                    break
            self._train_segment(scores, a, b, cand, ci, last)
            ci = last + 1

    def _train_segment(self, scores, seg_start, seg_end, cand, first, last):
        f_start = cand[first][0]
        if f_start > seg_start:
            self._run(scores, seg_start, f_start - 1, True)
            self._move(self._ngtv(scores, f_start - 1),
                       self._pstv(scores, f_start))
        for i in range(first, last):
            cs, ce = cand[i]
            self._run(scores, cs, ce, False)
            self._move(self._pstv(scores, ce), self._ngtv(scores, ce + 1))
            nxt = cand[i + 1][0]
            self._run(scores, ce + 1, nxt - 1, True)
            self._move(self._ngtv(scores, nxt - 1), self._pstv(scores, nxt))
        ls, le = cand[last]
        self._run(scores, ls, le, False)
        if seg_end > le:
            self._move(self._pstv(scores, le), self._ngtv(scores, le + 1))
            self._run(scores, le + 1, seg_end, True)

    def normalize(self) -> None:
        self.priors = np.log(self.priors / self.priors.sum())
        self.trans = np.log(self.trans / self.trans.sum(axis=1,
                                                        keepdims=True))
        self._normalized = True

    # -- decoding ----------------------------------------------------------
    def decode_states(self, scores: np.ndarray, r_start: int, r_end: int
                      ) -> np.ndarray:
        """Viterbi over [r_start, r_end] restricted to the two states per
        position (HMM::decode, HMM.cpp:455-574). Returns state indices."""
        n = r_end - r_start + 1
        st = scores[r_start: r_end + 1].astype(np.int64)
        npos = self.n_pos
        if n > 1:
            from meshclust_tpu_torch import native
            got = native.red_viterbi(st, self.priors, self.trans, npos)
            if got is not None:
                return got
        vP = self.priors[st[0]]
        vN = self.priors[st[0] + npos]
        back = np.zeros((n, 2), np.int8)   # 0 = from positive, 1 = negative
        for i in range(1, n):
            pp, pn = st[i - 1], st[i - 1] + npos
            cp, cn = st[i], st[i] + npos
            p1 = vP + self.trans[pp, cp]
            p2 = vN + self.trans[pn, cp]
            p3 = vP + self.trans[pp, cn]
            p4 = vN + self.trans[pn, cn]
            if p1 > p2:
                nvP, back[i, 0] = p1, 0
            else:
                nvP, back[i, 0] = p2, 1
            if p3 > p4:
                nvN, back[i, 1] = p3, 0
            else:
                nvN, back[i, 1] = p4, 1
            vP, vN = nvP, nvN
        states = np.zeros(n, np.int64)
        cur = 0 if vP >= vN else 1
        # C++ argmax scans all states taking the strictly-greater: the
        # positive state wins ties (it has the lower index)
        states[n - 1] = st[n - 1] + (0 if vP >= vN else npos)
        is_neg = cur
        for i in range(n - 1, 0, -1):
            is_neg = int(back[i, is_neg])
            states[i - 1] = st[i - 1] + (npos if is_neg else 0)
        return states

    def decode_regions(self, scores: np.ndarray, r_start: int, r_end: int
                       ) -> List[List[int]]:
        """Positive-state runs as [start, end] regions (the decode overload
        used by Scanner)."""
        states = self.decode_states(scores, r_start, r_end)
        pos = states < self.n_pos
        # vectorized positive-run extraction (same [start, end] runs as the
        # scalar scan)
        edges = np.diff(np.concatenate(([0], pos.view(np.int8), [0])))
        starts = np.flatnonzero(edges == 1)
        ends = np.flatnonzero(edges == -1) - 1
        return [[r_start + int(a), r_start + int(b)]
                for a, b in zip(starts, ends)]

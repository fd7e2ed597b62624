"""Per-run identity classifier training (Trainer<T> re-design, SURVEY C5).

Pipeline (Trainer.cpp:527-651 `train`, :653-783 `split`, :253-333
`get_labels`, :201-243 `resize_vec`, :490-526 `bin_data`):

1. split(): pivot-based pair sampling. Pivot binary searches are sequential
   per pivot but independent across pivots — the device aligner batches one
   binary-search step for ALL pivots at a time (~log2(N) batched rounds)
   instead of the reference's per-pair scalar alignments.
2. get_labels(): glibc-exact shuffle, batched alignment labeling, class
   split at the identity cutoff, 5-bin class balancing.
3. bin_data(): 10-bin alternating train/test split.
4. Greedy feature growth over the fixed menu with the reference's
   97.5 / 90 / delta<=1 accuracy gates; least-squares GLM fit per step.

All scalar arithmetic reproduces the reference's integer/double semantics
(int divisions, round()) in float64.

Twin of meshclust_tpu/core/trainer.py; only the device touch points differ
(pivot distance orders as torch tensors, the port's DeviceAligner).
"""
from __future__ import annotations

import math
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from meshclust_tpu_torch.core import rng as crng
from meshclust_tpu_torch.core.points import PointSet
from meshclust_tpu_torch.ops import features as F
from meshclust_tpu_torch.ops import glm
from meshclust_tpu_torch.utils import perf
from meshclust_tpu_torch.utils.log import log


class TrainedModel:
    def __init__(self, feature: F.Feature, weights: np.ndarray,
                 cutoff: float, k: int):
        self.feature = feature
        self.weights = weights
        self.cutoff = cutoff
        self.k = k

    @property
    def params(self) -> F.FeatureParams:
        return self.feature.params(self.weights)


class Trainer:
    def __init__(self, ps: PointSet, n_points: int, cutoff: float,
                 max_pts_from_one: int, k: int,
                 align_batch: Optional[Callable] = None):
        """k == 0 selects align mode (ref Runner.cpp:332 `align ? 0 : k`).

        The device distance rows are exact integers, so the JAX Trainer's
        `exact` option (host rows instead of f32 device rows) has no twin."""
        self.ps = ps
        self.n_points = n_points
        self.cutoff = cutoff
        self.max_pts_from_one = max_pts_from_one
        self.k = k
        self._dev_aligner = None
        self.align_batch = align_batch or self._default_align_batch

    def _pivot_orders(self, rows: np.ndarray):
        """Distance-sort orders for each pivot, kept ON DEVICE; only gathered
        entries are transferred (the 1M-scale path avoids moving [P, N])."""
        ps = self.ps
        dev = ps.device
        order_rows = []
        for s in range(0, rows.shape[0], 16):
            d = torch.from_numpy(ps.distance_rows_device(rows[s: s + 16]))
            order_rows.append(torch.argsort(d.to(dev), dim=1, stable=True)
                              .to(torch.int32))
        orders_dev = torch.cat(order_rows, dim=0)

        class DevOrders:
            def __init__(self):
                self.orders_dev = orders_dev    # [P, N] device-resident

            def gather(self, ii, jj):
                sel_i = torch.as_tensor(np.asarray(ii, np.int64), device=dev)
                sel_j = torch.as_tensor(np.asarray(jj, np.int64), device=dev)
                return orders_dev[sel_i, sel_j].cpu().numpy().astype(
                    np.int64)

        return DevOrders()

    def _probe_aligner(self):
        """The DeviceAligner shared by labeling and the probe walk. The
        walk reads identities through it, staged or packed, so it is always
        usable."""
        if self._dev_aligner is None:
            from meshclust_tpu_torch.ops.align_device import DeviceAligner
            self._dev_aligner = DeviceAligner(self.ps.codes, self.ps.device)
        return self._dev_aligner

    # -- alignment labeling -------------------------------------------------
    def _default_align_batch(self, pairs: Sequence[Tuple[int, int]]
                             ) -> np.ndarray:
        """Batched GlobAlignE identities for index pairs through the
        DeviceAligner (ops/align_device.py)."""
        return self._probe_aligner().identities(pairs)

    def _ref_order_chain(self, num_iterations: int):
        """Reference-faithful pivot selection + per-pivot orders
        (Trainer.cpp:672-700): the SAME chained std::sort permutations as
        the binary — length sort, distance-to-median sort (whose output is
        the input order of every per-pivot sort), then per-pivot distance
        sorts — with libstdc++'s exact unstable tie order (native/refsort).
        Returns (pivots, orders) or None when unavailable (no native lib,
        or beyond MESHCLUST_REFSORT_MAX points). The device distance rows
        are exact at every size, so no exactness gate is needed."""
        from meshclust_tpu_torch import native
        ps = self.ps
        n = ps.n
        if n > int(os.environ.get("MESHCLUST_REFSORT_MAX", "200000")):
            return None
        if native.get_refsort() is None:
            return None
        dist_rows = ps.distance_rows_device

        perm = np.arange(n, dtype=np.int32)
        native.ref_sort_perm(perm, np.asarray(ps.lengths, np.int64))
        begin_pt = int(perm[n // 2])
        db = dist_rows(np.asarray([begin_pt], np.int64))[0]
        native.ref_sort_perm(perm, db.astype(np.int64))
        pivots = [int(perm[i * (n - 1) // num_iterations])
                  for i in range(num_iterations + 1)]
        pdists = dist_rows(np.asarray(pivots, np.int64)).astype(np.int64)
        orders_arr = np.tile(perm, (len(pivots), 1))
        native.ref_sort_perm_batch(orders_arr, np.ascontiguousarray(pdists))

        class RefOrders:
            def __init__(self):
                self._dev = None

            @property
            def orders_dev(self):
                if self._dev is None:
                    self._dev = torch.from_numpy(orders_arr).to(ps.device)
                return self._dev

            def gather(self, ii, jj):
                return orders_arr[np.asarray(ii, np.int64),
                                  np.asarray(jj, np.int64)].astype(np.int64)

        return pivots, RefOrders()

    # -- pair sampling ------------------------------------------------------
    def split(self) -> List[Tuple[int, int]]:
        ps = self.ps
        n = ps.n
        num_iterations = math.ceil(self.n_points / self.max_pts_from_one) - 1
        num_iterations = max(1, num_iterations)
        with perf.phase("train_pivots"):
            ref_chain = self._ref_order_chain(num_iterations)
            if ref_chain is not None:
                pivots, orders = ref_chain
                log(f"Point pairs: {len(pivots)}")
            else:
                order = np.argsort(ps.lengths, kind="stable")
                begin_pt = int(order[n // 2])
                begin_orders = self._pivot_orders(
                    np.asarray([begin_pt], np.int64))
                pivot_slots = [i * (n - 1) // num_iterations
                               for i in range(num_iterations + 1)]
                pivots = [int(x) for x in begin_orders.gather(
                    [0] * len(pivot_slots), pivot_slots)]
                log(f"Point pairs: {len(pivots)}")
                # per-pivot distance-sort orders (device-resident at scale)
                orders = self._pivot_orders(np.asarray(pivots, np.int64))

        to_add_each = self.max_pts_from_one // 2

        with perf.phase("train_probe"):
            # batched binary search by TRUE alignment (ref Trainer.cpp:702-721):
            # all pivots advance one probe per round.
            offset0 = n // 4
            pivot_pos = np.full(len(pivots), 2 * offset0, np.int64)
            offsets = np.full(len(pivots), offset0, np.int64)
            done = offsets <= 0
            fused = (self.align_batch == self._default_align_batch
                     and hasattr(orders, "orders_dev")
                     and self._probe_aligner() is not None)
            if fused:
                # Speculative probe tree: the binary search's next DEPTH probe
                # positions are fully determined by the current (pos, offset)
                # state — (p, o) branches to (p-o, o//2) and (p+o, o//2) — so
                # ONE well-packed aligner dispatch evaluates every position any
                # of the next DEPTH rounds could visit (2^DEPTH - 1 per pivot),
                # then the host walks the identical reference decisions
                # (Trainer.cpp:702-721) through the precomputed identities.
                # Bit-identical outcomes to probing one round at a time; the
                # ~log2(N) sequential rounds of ~n_pivots pairs (which left the
                # 128-lane grid kernel mostly idle) become ~log2(N)/DEPTH
                # dispatches of full blocks.
                import os as _os
                from meshclust_tpu_torch.utils import perf as _perf
                da = self._probe_aligner()
                pivot_rows = np.asarray(pivots, np.int64)
                depth = max(1, int(_os.environ.get("MESHCLUST_PROBE_DEPTH",
                                                   "4")))
                while not done.all():
                    live_idx = np.flatnonzero(~done)
                    slot: Dict[Tuple[int, int], int] = {}
                    gi: List[int] = []
                    gj: List[int] = []
                    for i in live_idx:
                        states = [(int(pivot_pos[i]), int(offsets[i]))]
                        for _ in range(depth):
                            nxt = []
                            for (p, o) in states:
                                if (i, p) not in slot:
                                    slot[(i, p)] = len(gi)
                                    gi.append(int(i))
                                    gj.append(p)
                                if o <= 0:
                                    continue
                                nxt.append((p - o, o // 2))
                                nxt.append((p + o, o // 2))
                            states = nxt
                    with _perf.phase("probe_gather"):
                        probe_pts = orders.gather(gi, gj)
                    ids_b = da.identities(
                        [(int(pivot_rows[a]), int(q))
                         for a, q in zip(gi, probe_pts)])
                    for i in live_idx:
                        for _ in range(depth):
                            if done[i]:
                                break
                            algn = float(ids_b[slot[(int(i),
                                                     int(pivot_pos[i]))]])
                            if algn < self.cutoff:
                                pivot_pos[i] -= offsets[i]
                            elif algn > self.cutoff:
                                pivot_pos[i] += offsets[i]
                            else:
                                done[i] = True
                                continue
                            offsets[i] //= 2
                            if offsets[i] <= 0:
                                done[i] = True
            while not done.all():
                live = [i for i in range(len(pivots)) if not done[i]]
                probe_pts = orders.gather(live, [int(pivot_pos[i]) for i in live])
                probe_pairs = [(pivots[i], int(q))
                               for i, q in zip(live, probe_pts)]
                ids = self.align_batch(probe_pairs)
                for i, algn in zip(live, ids):
                    if algn < self.cutoff:
                        pivot_pos[i] -= offsets[i]
                    elif algn > self.cutoff:
                        pivot_pos[i] += offsets[i]
                    else:
                        done[i] = True
                        continue
                    offsets[i] //= 2
                    if offsets[i] <= 0:
                        done[i] = True

        with perf.phase("train_pairs"):
            # pair selection around each pivot's boundary (Trainer.cpp:723-768):
            # compute all gather positions first, fetch once, then assemble.
            aerr = 0
            gather_i: List[int] = []
            gather_j: List[int] = []
            per_pivot_counts: List[int] = []
            incs: List[Tuple[float, float]] = []
            for i in range(len(pivots)):
                pivot = int(pivot_pos[i])
                before_inc = pivot / to_add_each
                after_inc = (n - pivot) / to_add_each
                incs.append((before_inc, after_inc))
                if before_inc < 1:
                    aerr = 1
                elif after_inc < 1:
                    aerr = -1
                cnt0 = 0
                before_start = 0.0
                for _ in range(to_add_each):
                    gather_i.append(i)
                    gather_j.append(int(_cxx_round(before_start)))
                    before_start += before_inc
                    cnt0 += 1
                after_start = float(pivot)
                cnt = 0
                while cnt < to_add_each and _cxx_round(after_start) < n:
                    gather_i.append(i)
                    gather_j.append(int(_cxx_round(after_start)))
                    after_start += after_inc
                    cnt += 1
                    cnt0 += 1
                per_pivot_counts.append(cnt0)
            gathered = orders.gather(gather_i, gather_j)

            seen: Dict[Tuple[str, str], None] = {}
            ordered_pairs: List[Tuple[int, int]] = []
            keys: List[Tuple[str, str]] = []
            off = 0
            for i, p in enumerate(pivots):
                buf: List[Tuple[int, int]] = []
                for t in range(per_pivot_counts[i]):
                    q = int(gathered[off + t])
                    buf.append(self._ordered(p, q))
                off += per_pivot_counts[i]
                for pr in buf:
                    key = (self.ps.headers[pr[0]], self.ps.headers[pr[1]])
                    if key not in seen:
                        seen[key] = None
                        ordered_pairs.append(pr)
                        keys.append(key)
            if aerr < 0:
                log("Warning: Alignment may be too small for sampling")
            elif aerr > 0:
                log("Warning: Alignment may be too large for sampling")
            # std::set iteration order = sorted by (header_a, header_b)
            order = sorted(range(len(ordered_pairs)), key=lambda t: keys[t])
            return [ordered_pairs[t] for t in order]

    def _ordered(self, p: int, q: int) -> Tuple[int, int]:
        """header-compare pair ordering (Trainer.cpp:746)."""
        if self.ps.headers[p] < self.ps.headers[q]:
            return (p, q)
        return (q, p)

    # -- labeling + balancing ----------------------------------------------
    def get_labels(self, vec: List[Tuple[int, int]]):
        vec = crng.random_shuffle(list(vec), seed=0)
        ids = self.align_batch(vec)
        pos, neg = [], []
        for pr, algn in zip(vec, ids):
            (pos if algn >= self.cutoff else neg).append((pr, float(algn)))
        # std::set ordered by headers; dedup by header key keeping first
        pos = self._set_order(pos)
        neg = self._set_order(neg)
        log(f"positive={len(pos)} negative={len(neg)}")
        if not pos or not neg:
            log("Identity value does not match sampled data: "
                + ("Too many sequences below identity" if not pos
                   else "Too many sequences above identity"))
            sys.exit(0)
        m_size = min(len(pos), len(neg))
        log("resizing positive")
        bp = resize_vec(pos, m_size, self.cutoff, 1.0, 5)
        log("resizing negative")
        bn = resize_vec(neg, m_size, 0.4, self.cutoff, 5)
        log(f"positive={len(bp)} negative={len(bn)}")
        return bp, bn

    def _set_order(self, items):
        seen = {}
        for (pr, algn) in items:
            key = (self.ps.headers[pr[0]], self.ps.headers[pr[1]])
            if key not in seen:
                seen[key] = (pr, algn)
        return [seen[k] for k in sorted(seen.keys())]

    # -- raw feature computation for pair lists -----------------------------
    def pair_raw(self, pairs: Sequence[Tuple[int, int]],
                 flags: Sequence[int],
                 align_vals: Optional[np.ndarray] = None
                 ) -> Dict[int, np.ndarray]:
        """Raw single-feature values for a pair list, float64-exact."""
        ps = self.ps
        a_idx = np.asarray([p for p, _ in pairs], np.int64)
        b_idx = np.asarray([q for _, q in pairs], np.int64)
        ha = ps.hist_rows(a_idx).astype(np.int64)
        hb = ps.hist_rows(b_idx).astype(np.int64)
        man = np.abs(ha - hb).sum(axis=1).astype(np.float64)
        dot = (ha * hb).sum(axis=1).astype(np.float64)
        args = dict(
            man=man, dot=dot,
            mag_a=ps.mag[a_idx].astype(np.float64),
            mag_b=ps.mag[b_idx].astype(np.float64),
            sq_a=ps.sq[a_idx].astype(np.float64),
            sq_b=ps.sq[b_idx].astype(np.float64),
            len_a=ps.lengths[a_idx].astype(np.float64),
            len_b=ps.lengths[b_idx].astype(np.float64),
            V=ps.V,
        )
        extras = {}
        if F.FEAT_SQCHORD in flags:
            a = ha.astype(np.float64)
            b = hb.astype(np.float64)
            extras["sqchord"] = (a + b - 2 * np.sqrt(a * b)).sum(axis=1)
        if F.FEAT_JENSONSHANNON in flags:
            pa = ha / args["mag_a"][:, None]
            pb = hb / args["mag_b"][:, None]
            avg = 0.5 * (pa + pb)
            extras["js"] = ((pa * np.log(pa / avg)
                             + pb * np.log(pb / avg)).sum(axis=1)) / 2.0
        if F.FEAT_RREE_K_R in flags:
            extras["rree"] = F.rree_k_r_pairs(ha, hb)
        out = {}
        for flag in flags:
            out[flag] = F.raw_from_sums(flag, extras=extras,
                                        align_val=align_vals, **args)
        return out

    def feature_matrix(self, feature: F.Feature,
                       pairs: Sequence[Tuple[int, int]],
                       align_vals=None) -> np.ndarray:
        raw = self.pair_raw(pairs, feature.lookup, align_vals)
        cache = np.stack([raw[f] for f in feature.lookup], axis=-1)
        norm = feature.normalize_cache(cache)
        cols = feature.combo_columns(norm)
        ones = np.ones((len(pairs), 1))
        return np.concatenate([ones, cols], axis=1)

    # -- the greedy training loop ------------------------------------------
    def train(self, acc_cutoff: float = 97.5) -> TrainedModel:
        feature = F.Feature(self.ps.V)
        if self.k == 0:
            # align mode: single ALIGN feature, fixed weights
            # (Trainer.cpp:570-577)
            feature.add_feature(F.FEAT_ALIGN, F.COMBO_SELF)
            feature.mins[0] = 0.0
            feature.maxs[0] = 1.0
            feature.finalize()
            weights = np.array([-1.0 * self.cutoff, 1.0])
            return TrainedModel(feature, weights, self.cutoff, self.k)

        log("Splitting data")
        data = self.split()
        with perf.phase("train_labels"):
            bp, bn = self.get_labels(data)
        dump = os.environ.get("MESHCLUST_DEBUG_DUMP")
        if dump:
            for name, lst in (("pos", bp), ("neg", bn)):
                with open(f"{dump}_{name}.txt", "w") as fdbg:
                    for (pr, algn) in lst:
                        fdbg.write(f"{self.ps.headers[pr[0]]} "
                                   f"{self.ps.headers[pr[1]]} "
                                   f"{float(algn).hex()}\n")
        train_pos, test_pos = bin_data(bp, self.cutoff, 1.0)
        train_neg, test_neg = bin_data(bn, 0.0, self.cutoff)
        log(f"training positive: {len(train_pos)}")
        log(f"training negative: {len(train_neg)}")
        log(f"testing positive: {len(test_pos)}")
        log(f"testing negative: {len(test_neg)}")
        if not test_pos or not test_neg:
            raise RuntimeError("not enough points to sample")

        menu = F.DEFAULT_FEATURE_MENU
        prev_acc = -10000.0
        saved: List[Tuple[F.Feature, np.ndarray]] = []
        weights = None
        min_no = max(1, len(menu) - 1)
        for num_features in range(min_no, len(menu) + 1):
            with perf.phase("train_features"):
                for j in range(feature.size(), min(num_features, len(menu))):
                    feature.add_feature(menu[j][0], menu[j][1])
                raw_pos = self.pair_raw(train_pos, feature.lookup)
                feature.normalize_raw(raw_pos)
                raw_neg = self.pair_raw(train_neg, feature.lookup)
                feature.normalize_raw(raw_neg)
                feature.finalize()
                for i, fl in enumerate(feature.lookup):
                    log(f"bounds[{i}]: {feature.mins[i]} to {feature.maxs[i]}")
                Xtr = self.feature_matrix(feature, train_pos + train_neg)
                ytr = np.concatenate([np.ones(len(train_pos)),
                                      -np.ones(len(train_neg))])
                Xte = self.feature_matrix(feature, test_pos + test_neg)
                yte = np.concatenate([np.ones(len(test_pos)),
                                      -np.ones(len(test_neg))])
            with perf.phase("train_glm"):
                weights = glm.train(Xtr, ytr)
            with perf.phase("train_features"):
                dump = os.environ.get("MESHCLUST_DEBUG_DUMP")
                if dump:
                    # bit-exact (hex float) dump of the training matrix,
                    # labels, and fitted weights — parity triage vs the same
                    # dump patched into the reference (PARITY round 5)
                    with open(f"{dump}_feat{num_features}.txt", "w") as fdbg:
                        fdbg.write(f"X {Xtr.shape[0]} {Xtr.shape[1]}\n")
                        for r in range(Xtr.shape[0]):
                            fdbg.write(" ".join(
                                float(v).hex() for v in Xtr[r])
                                + f" {float(ytr[r]).hex()}\n")
                        fdbg.write("W\n")
                        for v in weights:
                            fdbg.write(f"{float(v).hex()}\n")
                pte = np.where(glm.predict(Xte, weights) == 1, 1, -1)
                acc, sens, spec = glm.accuracy(yte, pte)
                log(f"Accuracy: {acc:.4g}% Sensitivity: {sens:.4g}% "
                    f"Specificity: {spec:.4g}%")
                ptr = np.where(glm.predict(Xtr, weights) == 1, 1, -1)
                glm.accuracy(ytr, ptr)
            if acc - prev_acc <= 1 and acc >= 90.0 and saved:
                feature, weights = saved[-1]
                log(f"feat size is {feature.size()}")
                break
            saved.append((feature.copy(), weights))
            prev_acc = acc
            if acc >= acc_cutoff:
                log("breaking from acc cutoff")
                break
        log(f"Final: feat size is {feature.size()}")
        log(f"Using {len(weights) - 1} features")
        return TrainedModel(feature, weights, self.cutoff, self.k)


def _cxx_round(x: float) -> int:
    """C++ round(): half away from zero (numpy rounds half to even)."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def _get_bin(x: float, min_align: float, max_align: float,
             num_bins: int) -> int:
    if x >= max_align:
        return num_bins - 1
    if x <= min_align:
        return 0
    return int(num_bins * (x - min_align) / (max_align - min_align))


def resize_vec(vec, new_size: int, min_align: float, max_align: float,
               num_bins: int):
    """Class balancing by identity bins (Trainer.cpp:201-243): repeatedly
    take ceil(remaining/num_bins) from each bin top-down until >= new_size
    (can overshoot and duplicate — faithful). vec: [(pair, identity)]."""
    if new_size == len(vec):
        return list(vec)
    bins: List[list] = [[] for _ in range(num_bins)]
    for pr, x in vec:
        bins[_get_bin(x, min_align, max_align, num_bins)].append((pr, x))
    data: list = []
    while len(data) < new_size:
        items_left = new_size - len(data)
        take = math.ceil(items_left / num_bins)
        for i in range(num_bins - 1, -1, -1):
            for j in range(min(take, len(bins[i]))):
                data.append(bins[i][j])
    return data


def bin_data(vec, min_align: float, max_align: float):
    """10-bin alternating train/test split (Trainer.cpp:490-526).

    `vec` holds (pair, identity) tuples; returns (train, test) pair lists.
    """
    n_bins = 10
    bins: List[list] = [[] for _ in range(n_bins)]
    for pr, x in vec:
        bins[_get_bin(x, min_align, max_align, n_bins)].append((pr, x))
    train, test = [], []
    last = 0
    for b in bins:
        for i, (pr, _) in enumerate(b):
            if i % 2 == last:
                train.append(pr)
            else:
                test.append(pr)
        last = 1 - last
    return train, test

"""The float64 classifier of the device paths, in one place.

The trained model (Trainer::get_close / filter / merge / raw_classify,
Trainer.cpp:34-157,334-349) evaluates, for a (center, candidate) pair:
    cache  = raw single statistics       (Feature::compute)
    norm   = (cache - min)/(max - min), inverted for distance-type singles
    col_j  = product of (squared) normalized singles   (combo columns)
    score  = w0 + sum_j w_j * col_j
    positive <=> round(sigmoid(score)) == 1 <=> score >= 0
f1 = the FIRST combo column value, the similarity used for argmax decisions.

Scorer computes it in torch, op for op as core/classify.HostBackend does in
numpy, from exact int64 sums, so decisions and f1 are bit-equal to the host
oracle's. Model packs the same classifier for the CUDA kernels
(csrc/common.cuh:classify, which pa_absorb, pb_band and pb_merge run).
SUPPORTED is the set of singles both compute. core/classify.DeviceBackend
and ops/phase_a and ops/phase_b take the classifier, mean_floor and the
rows' widening (row_dtype, widen) from here.

Float64 traps on the device, named where they bite below:
  * an integer tensor divided by a number gives float32 in torch: every
    integer statistic is cast to float64 before any division;
  * on CUDA, a float tensor divided by a Python number (a CPU scalar) is
    computed as a product with its reciprocal, one rounding off a true
    division: every divisor here is a tensor on the device, or the power
    of two 2.0, whose reciprocal product is exact;
  * torch.addcmul, lerp and torch.compile may contract a*b + c into one
    rounding (an FMA); no decision path uses them.
"""
from __future__ import annotations

import numpy as np
import torch

from meshclust_tpu_torch.ops import features as F

# The singles the device computes; the most a model may have (kMaxSingles:
# a model's singles are distinct flags, as Feature.add_feature makes them);
# and the shared memory of Model's packed arrays that a launch may take
# without an attribute.
SUPPORTED = (F.FEAT_LD, F.FEAT_MANHATTAN, F.FEAT_INTERSECTION,
             F.FEAT_PEARSON, F.FEAT_SIMRATIO, F.FEAT_KULCZYNSKI2)
MAX_SINGLES = len(SUPPORTED)
MAX_MODEL_BYTES = 48 * 1024
# The merge takes a positive center only with f1 strictly above DBL_MIN
# (Trainer.cpp:132-135).
DBL_MIN = 2.2250738585072014e-308
# 46340^2 < 2^31: rows whose counts are at most this multiply in int32.
_INT32_PRODUCT_MAX = 46340


def row_dtype(largest: int) -> torch.dtype:
    """Dtype of the histogram rows that the device classifier sums: int32
    while the product of two counts fits it, else int64. Sums are int64,
    so man, dot and the mean's sums are exact."""
    return torch.int32 if largest <= _INT32_PRODUCT_MAX else torch.int64


def widen(rows: torch.Tensor) -> torch.Tensor:
    """rows in the row_dtype of the largest count their storage dtype
    holds (int32 for int8 and int16 rows, else int64): no count is read."""
    return rows.to(row_dtype(torch.iinfo(rows.dtype).max))


def mean_floor(sums: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """floor(sums / count), float64, as the reference truncates its double
    mean (mean_select, ClusterFactory.cpp:382-425). count is an integer
    tensor that broadcasts against sums; both are cast to float64 first
    (an integer tensor divided would give float32) and the divisor stays a
    device tensor (a Python number would divide as a reciprocal product on
    CUDA)."""
    return torch.floor(sums.to(torch.float64) / count.to(torch.float64))


class Scorer:
    """The trained classifier in float64 on one device.

    __call__ is features.raw_from_sums followed by HostBackend.classify's
    normalisation and combo sum, step for step and in the same order, so
    positives and f1 are bit-equal to the host oracle's. The divisor V is a
    device tensor (a Python number would be a CPU scalar; see the module
    docstring)."""

    def __init__(self, params: F.FeatureParams, V: int, device):
        self.singles = tuple(params.singles)
        self.combos = tuple((c, tuple(ix)) for c, ix in params.combos)
        self.need_dot = bool({F.FEAT_SIMRATIO, F.FEAT_PEARSON}
                             & set(self.singles))
        f64 = {"dtype": torch.float64, "device": device}
        self.V = torch.tensor(float(V), **f64)
        self.mins = torch.as_tensor(params.mins, **f64)
        self.spans = torch.as_tensor(params.maxs - params.mins, **f64)
        self.is_sim = torch.as_tensor(params.is_sim, dtype=torch.bool,
                                      device=device)
        self.weights = [float(w) for w in params.weights]

    def sums(self, h_a: torch.Tensor, h_b: torch.Tensor):
        """(man, dot): sum |a - b| and sum a * b over the last axis, int64
        (dot None when no feature reads it). Rows in row_dtype."""
        man = (h_a - h_b).abs().sum(-1, dtype=torch.int64)
        dot = (h_a * h_b).sum(-1, dtype=torch.int64) if self.need_dot \
            else None
        return man, dot

    def pairs(self, hist, mag, sq, lenf, a: torch.Tensor, b: torch.Tensor,
              h_b=None):
        """(positive, f1) of the pairs (a[t], b[t]) of points (a may be one
        point): hist [N, V] their rows in storage dtype, mag, sq and lenf
        [N] float64. h_b: b's rows widened, when the caller holds them.
        Indices are 1-D tensors: torch reads a 0-dim index tensor back to
        the host, like .item()."""
        h_a = widen(hist[a])
        if h_b is None:
            h_b = widen(hist[b])
        man, dot = self.sums(h_a, h_b)
        return self(man, dot, mag[a], mag[b], sq[a], sq[b], lenf[a], lenf[b])

    def __call__(self, man, dot, mag_a, mag_b, sq_a, sq_b, len_a, len_b):
        """-> (positive bool, f1 float64). man and dot are int64 sums; the
        per-sequence statistics are float64 and broadcast (a: the center
        or the candidate center, b: the rows classified against it)."""
        V = self.V
        man = man.to(torch.float64)
        dot = dot.to(torch.float64) if dot is not None else None
        cols = []
        for flag in self.singles:
            if flag == F.FEAT_LD:
                v = (len_a - len_b).abs()
            elif flag == F.FEAT_MANHATTAN:
                v = man
            elif flag == F.FEAT_INTERSECTION:
                min_sum = (mag_a + mag_b - man) / 2.0
                v = 2.0 * min_sum / (mag_a + mag_b)
            elif flag == F.FEAT_KULCZYNSKI2:
                ap = mag_a / V
                aq = mag_b / V
                min_sum = (mag_a + mag_b - man) / 2.0
                coeff = V * (ap + aq) / (2.0 * ap * aq)
                v = coeff * min_sum
            elif flag == F.FEAT_SIMRATIO:
                norm2 = sq_a + sq_b - 2.0 * dot
                v = dot / (dot + torch.sqrt(torch.clamp(norm2, min=0.0)))
            elif flag == F.FEAT_PEARSON:
                # C++ round(): half away from zero (mag/V > 0 => floor(x+0.5))
                ap = torch.floor(mag_a / V + 0.5)
                aq = torch.floor(mag_b / V + 0.5)
                np_ = sq_a - 2.0 * ap * mag_a + V * ap * ap
                nq_ = sq_b - 2.0 * aq * mag_b + V * aq * aq
                dotc = dot - ap * mag_b - aq * mag_a + V * ap * aq
                v = dotc / torch.sqrt(torch.clamp(np_ * nq_, min=0.5))
            else:
                raise AssertionError(flag)
            cols.append(v)
        cache = torch.stack(cols, dim=-1)
        norm = (cache - self.mins) / self.spans
        norm = torch.where(self.is_sim, norm, 1.0 - norm)
        score = torch.full(cache.shape[:-1], self.weights[0],
                           dtype=torch.float64, device=cache.device)
        f1 = None
        for j, (combo, idx) in enumerate(self.combos):
            prod = torch.ones_like(score)
            for i in idx:
                c = norm[..., i]
                prod = prod * (c * c if combo == F.COMBO_SQUARED else c)
            if j == 0:
                f1 = prod
            score = score + self.weights[j + 1] * prod
        return score >= 0.0, f1


class Model:
    """The classifier of the Phase A and Phase B kernels: the plain
    versions' Scorer, and the kernels' packed arrays
      spec int32: S, J, singles[S], is_sim[S], kinds[J], off[J + 1], idx
      coef f64:   V, mins[S], spans[S], weights[J + 1]
    (J combos; combo j multiplies the normalized singles idx[off[j]:
    off[j + 1]])."""

    def __init__(self, params: F.FeatureParams, V: int, device):
        singles = [int(f) for f in params.singles]
        if any(f not in SUPPORTED for f in singles):
            raise ValueError(f"singles {singles}: the device kernels "
                             f"compute only {SUPPORTED}")
        if not params.combos or len(set(singles)) != len(singles):
            raise ValueError(f"{len(params.combos)} combos, singles "
                             f"{singles}: need >= 1 combo and distinct "
                             f"singles")
        self.scorer = Scorer(params, V, device)
        self.with_dot = self.scorer.need_dot
        kinds = [int(c) for c, _ in params.combos]
        idx = [int(i) for _, ix in params.combos for i in ix]
        off = np.cumsum([0] + [len(ix) for _, ix in params.combos])
        spec = ([len(singles), len(kinds)] + singles
                + [int(bool(s)) for s in params.is_sim] + kinds
                + off.tolist() + idx)
        mins = np.asarray(params.mins, np.float64)
        coef = np.concatenate([[float(V)], mins,
                               np.asarray(params.maxs, np.float64) - mins,
                               np.asarray(params.weights, np.float64)])
        if len(spec) * 4 + coef.shape[0] * 8 > MAX_MODEL_BYTES:
            raise ValueError("the classifier does not fit the kernels' "
                             "shared memory")
        self.spec = torch.as_tensor(np.asarray(spec, np.int32), device=device)
        self.coef = torch.as_tensor(coef, device=device)

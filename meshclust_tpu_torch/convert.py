"""Carry featurized points and trained classifiers across from the JAX
package (meshclust_tpu) as plain numpy arrays.

`pointset_from_numpy` turns the arrays of a meshclust_tpu PointSet (hist,
mag, sq, lengths, one_mers, codes, headers) into this package's PointSet with
the histogram on `device`; `params_from_numpy` turns the fields of a trained
meshclust_tpu FeatureParams into this package's FeatureParams. With both, one
trained model can drive the two clusterers on the same input.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from meshclust_tpu_torch.core.points import PointSet
from meshclust_tpu_torch.ops import features as F
from meshclust_tpu_torch.ops import histogram as H


def pointset_from_numpy(hist: np.ndarray, mag: np.ndarray, sq: np.ndarray,
                        lengths: np.ndarray, one_mers: np.ndarray,
                        codes: List[np.ndarray], headers: List[str], k: int,
                        device="cpu") -> PointSet:
    """PointSet with the [N, 4^k] histogram on `device` in its storage
    dtype (the dtype scan of Runner.cpp:75-89)."""
    hist = np.asarray(hist)
    largest = int(hist.max()) if hist.size else 0
    stored = np.ascontiguousarray(hist.astype(H.storage_dtype(largest)))
    return PointSet(
        hist=None,
        mag=np.asarray(mag, np.int64),
        sq=np.asarray(sq, np.int64),
        lengths=np.asarray(lengths, np.int64),
        one_mers=np.asarray(one_mers, np.int64),
        headers=list(headers),
        codes=[np.asarray(c, np.uint8) for c in codes],
        k=int(k),
        V=int(hist.shape[1]),
        hist_dev=torch.from_numpy(stored).to(torch.device(device)),
        largest=largest,
    )


def params_from_numpy(singles: Sequence[int], mins: np.ndarray,
                      maxs: np.ndarray, is_sim: np.ndarray,
                      combos: Sequence[Tuple[int, Sequence[int]]],
                      weights: np.ndarray) -> F.FeatureParams:
    """FeatureParams of a trained classifier (float64 bounds and weights,
    combo column definitions, similarity flags)."""
    return F.FeatureParams(
        singles=[int(s) for s in singles],
        mins=np.asarray(mins, np.float64),
        maxs=np.asarray(maxs, np.float64),
        is_sim=np.asarray(is_sim, bool),
        combos=[(int(c), [int(i) for i in ix]) for c, ix in combos],
        weights=np.asarray(weights, np.float64).reshape(-1),
    )

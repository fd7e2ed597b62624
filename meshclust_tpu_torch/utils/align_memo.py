"""The Phase-A alignment memo of an align-mode checkpoint.

In align mode Phase B reads only the identities that Phase A aligned: a
pair that Phase A never aligned scores identity 0 there (the reference's
phase-B clone quirk, see AlignBackend.phase_b). A run resumed from
PREFIX.centers.json alone would start Phase B with an empty memo and
cluster differently from the run that wrote the file (meshclust_tpu's
checkpoints have this fault). So an align-mode run writes the memo beside
the centers, as PREFIX.memo.json, under the centers' fingerprint, and
resumes the centers only when the memo loads too.

Format: JSON like utils/checkpoint.py, with the pair keys (lo * n + hi,
as utils/pair_memo.PairMemo keys them) and their identities, sorted by key.
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from meshclust_tpu_torch.utils import checkpoint as ckpt

_VERSION = 1


def _arrays(backend, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(keys, vals) of the backend's memo, sorted by key: AlignBackend's
    PairMemo or HostBackend's (min, max) -> identity dict."""
    memo = getattr(backend, "memo", None)
    if memo is not None:
        return memo.export()
    cache = backend._align_cache
    keys = np.asarray([a * n + b for a, b in cache], np.int64)
    vals = np.asarray(list(cache.values()), np.float64)
    order = np.argsort(keys, kind="stable")
    return keys[order], vals[order]


def _restore(backend, keys: np.ndarray, vals: np.ndarray, n: int) -> None:
    memo = getattr(backend, "memo", None)
    if memo is not None:
        memo.load(keys, vals)
        return
    backend._align_cache.update(
        {(int(k) // n, int(k) % n): float(v) for k, v in zip(keys, vals)})


def save_memo(path: str, backend, ps, k: int, cutoff: float, seed: int,
              cfg=None) -> None:
    keys, vals = _arrays(backend, ps.n)
    blob = {
        "version": _VERSION,
        "kind": "memo",
        "fingerprint": ckpt._fingerprint(ps, k, cutoff, seed, cfg,
                                         "centers"),
        "keys": [int(x) for x in keys],
        "vals": np.asarray(vals, np.float64).tolist(),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f)
    os.replace(tmp, path)


def load_memo(path: str, backend, ps, k: int, cutoff: float, seed: int,
              cfg=None) -> bool:
    """Fill the backend's memo from a matching file; False (memo left as
    it was) when the file is absent, foreign or for another run."""
    try:
        with open(path) as f:
            blob = json.load(f)
        if blob.get("kind") != "memo" or blob.get("version") != _VERSION:
            return False
        if blob["fingerprint"] != ckpt._fingerprint(ps, k, cutoff, seed,
                                                    cfg, "centers"):
            return False
        keys = np.asarray(blob["keys"], np.int64)
        vals = np.asarray(blob["vals"], np.float64)
        if keys.shape != vals.shape or np.any(np.diff(keys) <= 0):
            return False
    except (OSError, ValueError, KeyError, TypeError):
        return False
    _restore(backend, keys, vals, ps.n)
    return True

"""Checkpoint/resume for trained classifiers and Phase-A centers (SURVEY §5.4).

The reference has no checkpointing — a crashed 9-hour 1M-read run restarts
from zero (its only durable artifact is the final .clstr,
ClusterFactory.cpp:495-520).  Here the two expensive milestones are durable:

  * the trained classifier (TrainedModel: feature normalization bounds +
    GLM weights, the product of Trainer::train's alignment labeling — by far
    the slowest phase on large inputs), and
  * the Phase-A center accumulation (list of (center, members) over point
    indices, valid for the same input set + seed).

Format: one JSON file (tiny — a few KB), no pickle, so checkpoints are
portable and human-inspectable.  A fingerprint of (input sizes, k, cutoff,
seed) guards against resuming against different data.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional

import numpy as np

_VERSION = 2


def _content_hash(ps) -> str:
    """Dataset-identity digest over ALL sequence bytes + headers + lengths.

    Previously this sampled every 97th sequence's first/last 64 bytes, which
    let an edited body with unchanged header/length in a non-sampled
    position resume against different data. One sha256 pass over the full
    code bytes is cheap relative to a run (~1 GB/s; a 1M x 1kb corpus hashes
    in ~1 s) and closes that gap."""
    h = hashlib.sha256()
    h.update(np.asarray(ps.lengths, np.int64).tobytes())
    for hd in ps.headers:
        h.update(hd.encode("utf-8", "replace"))
        h.update(b"\x00")
    for c in ps.codes:
        h.update(memoryview(np.ascontiguousarray(c)))
    return h.hexdigest()


def _fingerprint(ps, k: int, cutoff: float, seed: int, cfg=None,
                 kind: str = "model") -> dict:
    fp = {
        "n": int(ps.n),
        "k": int(k),
        "cutoff": float(cutoff),
        "seed": int(seed),
        "len_sum": int(np.asarray(ps.lengths, np.int64).sum()),
        "len_first": int(ps.lengths[0]) if ps.n else 0,
        "len_last": int(ps.lengths[-1]) if ps.n else 0,
        "content": _content_hash(ps),
    }
    if cfg is not None:
        # every parameter the checkpointed artifact depends on: the model
        # depends on the scoring matrix + sampling knobs; Phase-A centers
        # additionally depend on the bvec bin size.
        fp["scoring"] = [int(cfg.match), int(cfg.mismatch),
                         int(cfg.gap_open), int(cfg.gap_continue)]
        fp["sample_size"] = int(cfg.sample_size)
        fp["pivots"] = int(cfg.pivots)
        fp["acc_cutoff"] = float(cfg.acc_cutoff)
        if kind == "centers":
            fp["bin_size"] = int(cfg.bin_size)
    return fp


def save_model(path: str, model, ps, seed: int, cfg=None) -> None:
    """Serialize a TrainedModel (classifier params) to JSON."""
    p = model.params
    blob = {
        "version": _VERSION,
        "kind": "model",
        "fingerprint": _fingerprint(ps, model.k, model.cutoff, seed, cfg,
                                    "model"),
        "k": int(model.k),
        "cutoff": float(model.cutoff),
        "singles": [int(s) for s in p.singles],
        "mins": np.asarray(p.mins, np.float64).tolist(),
        "maxs": np.asarray(p.maxs, np.float64).tolist(),
        "is_sim": np.asarray(p.is_sim, bool).astype(int).tolist(),
        "combos": [[int(c), [int(i) for i in ix]] for c, ix in p.combos],
        "weights": np.asarray(p.weights, np.float64).tolist(),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f)
    os.replace(tmp, path)


def load_model(path: str, ps, k: int, cutoff: float, seed: int, cfg=None):
    """Load a TrainedModel if the checkpoint matches this run; else None."""
    from meshclust_tpu_torch.core.trainer import TrainedModel
    from meshclust_tpu_torch.ops import features as F
    try:
        with open(path) as f:
            blob = json.load(f)
        if blob.get("kind") != "model" or blob.get("version") != _VERSION:
            return None
        if blob["fingerprint"] != _fingerprint(ps, k, cutoff, seed, cfg,
                                               "model"):
            return None
        feat = F.Feature(ps.V)
        feat.lookup = [int(s) for s in blob["singles"]]
        feat.mins = [float(x) for x in blob["mins"]]
        feat.maxs = [float(x) for x in blob["maxs"]]
        feat.is_sims = [bool(x) for x in blob["is_sim"]]
        feat.is_finalized = [True] * len(feat.lookup)
        feat.combos = [(int(c), list(ix)) for c, ix in blob["combos"]]
        for s in feat.lookup:
            feat.flags |= int(s)
        return TrainedModel(feat, np.asarray(blob["weights"], np.float64),
                            float(blob["cutoff"]), int(blob["k"]))
    except (OSError, ValueError, KeyError, TypeError):
        # unreadable, hand-edited, or foreign-writer blobs fall back to
        # retraining rather than crashing the run
        return None


def save_centers(path: str, centers: List, ps, k: int, cutoff: float,
                 seed: int, cfg=None) -> None:
    """Serialize Phase-A output: [(center_idx, member_idxs), ...]."""
    blob = {
        "version": _VERSION,
        "kind": "centers",
        "fingerprint": _fingerprint(ps, k, cutoff, seed, cfg, "centers"),
        "centers": [[int(c.center), [int(m) for m in c.members]]
                    for c in centers],
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f)
    os.replace(tmp, path)


def load_centers(path: str, ps, k: int, cutoff: float, seed: int, cfg=None
                 ) -> Optional[List]:
    from meshclust_tpu_torch.core.meanshift import Center
    try:
        with open(path) as f:
            blob = json.load(f)
        if blob.get("kind") != "centers" or blob.get("version") != _VERSION:
            return None
        if blob["fingerprint"] != _fingerprint(ps, k, cutoff, seed, cfg,
                                               "centers"):
            return None
        return [Center(int(c), [int(m) for m in ms])
                for c, ms in blob["centers"]]
    except (OSError, ValueError, KeyError, TypeError):
        return None

"""What the reference needs of a job the window ran, read at the program's
layer boundaries while `active`:

- every (a, b) pair DeviceAligner.identities aligned, with its identity;
- the pairs Trainer.split sampled for training;
- Phase A's centers as MeanShift.accumulate_all returned them;
and, once the job has returned, its k, histograms and trained model.

The wrappers are installed once, before the warm-up job, and cost one
attribute test a call while inactive. `take` keeps what it reads as the
program returned it; `settle`, once the window has closed, makes the
reference's forms of it (an align-mode job at 15k reads aligns ~1.8M pairs,
a dict of them takes seconds of Python).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Capture:
    def __init__(self):
        from meshclust_tpu_torch.core.meanshift import MeanShift
        from meshclust_tpu_torch.core.trainer import Trainer
        from meshclust_tpu_torch.ops.align_device import DeviceAligner
        self.active = False
        self._calls: List = []
        self.split: Optional[list] = None
        self.phase_a: Optional[list] = None
        self._restore = []
        cap = self

        def wrap(cls, name, after):
            orig = getattr(cls, name)

            def wrapped(obj, *a, **kw):
                out = orig(obj, *a, **kw)
                if cap.active:
                    after(a, out)
                return out
            setattr(cls, name, wrapped)
            self._restore.append((cls, name, orig))

        wrap(DeviceAligner, "identities",
             lambda a, out: cap._calls.append((list(a[0]), np.asarray(out))))
        wrap(Trainer, "split",
             lambda a, out: setattr(cap, "split", [tuple(map(int, p))
                                                   for p in out]))
        wrap(MeanShift, "accumulate_all",
             lambda a, out: setattr(cap, "phase_a", [
                 (int(c.center), tuple(int(m) for m in c.members))
                 for c in out]))

    def restore(self) -> None:
        for cls, name, orig in reversed(self._restore):
            setattr(cls, name, orig)
        self._restore = []

    def take(self, result: Dict) -> Dict:
        """The job's state, on the host, for `settle`; resets the capture
        for the next job."""
        params = result["model"].params
        state = {
            "k": int(result["k"]),
            "hist": np.asarray(result["pointset"].hist),
            "model": {"lookup": list(params.singles),
                      "combos": [(c, list(ix)) for c, ix in params.combos],
                      "mins": np.asarray(params.mins, np.float64),
                      "maxs": np.asarray(params.maxs, np.float64),
                      "weights": np.asarray(params.weights, np.float64)},
            "calls": self._calls,
            "split": self.split,
            "phase_a": self.phase_a,
        }
        self._calls, self.split, self.phase_a = [], None, None
        return state


def settle(state: Dict) -> Dict:
    """A taken state as the check reads it: int64 histograms, and the
    aligner's calls as `aligned`, {(a, b): identity} in the order the job
    first aligned each pair."""
    aligned: Dict = {}
    for pairs, ids in state.pop("calls"):
        for (a, b), v in zip(pairs, ids.tolist()):
            aligned.setdefault((int(a), int(b)), float(v))
    state["aligned"] = aligned
    state["hist"] = state["hist"].astype(np.int64)
    return state

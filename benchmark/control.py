"""The readings that the limits of `correct` are set from, on the chip.

    python3 benchmark/control.py --workload CELL --seeds 1,2,3 [--out FILE]

For each seed, one job of the cell's own size (the corpus a run of that
seed checks), then the numbers compared twice, as the run compares them:
- program: the job against the plain reference (the lower readings);
- control: the reference in the configuration's control variant, in the
  program's place, against the reference (the upper readings). The variant
  is the config file's "control": "float32" computes every float of the
  reference (features, GLM, means) in float32 in place of float64;
  "gap_continue_first" aligns with the gap lanes preferring to continue a
  gap on a tie, against GlobAlignE's order (its identities are exact at any
  precision, so a lower precision changes nothing there).
One JSON line a seed on stdout (and appended to --out).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ["MESHCLUST_QUIET"] = "1"

from benchmark import spec as S  # noqa: E402


def readings(workload: str, seeds, device: str = "cuda", out=None):
    import torch
    from meshclust_tpu_torch.config import ClusterConfig
    from meshclust_tpu_torch.core import runner
    from benchmark.capture import Capture, settle
    from benchmark.reference import solve as R
    from benchmark.run import checked_corpus
    spec = S.load()
    cell = S.cell(spec, workload)
    cfg = S.config(spec, cell["config"])
    traffic = S.traffic(cell["traffic"])
    gen = S.generator(traffic["generator"])
    flags = dict(cfg["flags"])
    align_mode = R.align_mode(flags)
    variant = R.CONTROLS[cfg["control"]]
    cap = Capture()
    rows = []
    work = tempfile.mkdtemp(prefix="meshclust_control_")
    try:
        for seed in seeds:
            ci = checked_corpus(seed, int(traffic["pool"]))
            fasta = os.path.join(work, f"c_{seed}.fasta")
            gen.make(traffic, seed, ci, fasta)
            clstr = os.path.join(work, f"c_{seed}.clstr")
            cap.active = True
            t = time.perf_counter()
            res = runner.run(ClusterConfig(files=[fasta], output=clstr,
                                           **flags), device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            job_s = time.perf_counter() - t
            cap.active = False
            st = settle(cap.take(res))
            del res
            with open(clstr) as f:
                st["clstr"] = f.read()
            t = time.perf_counter()
            ref = R.check_job(st, fasta, cfg, seed, device)
            ref_s = time.perf_counter() - t
            ctl = R.check_job(st, fasta, cfg, seed, device, **variant)
            row = {"workload": workload, "seed": seed, "corpus": ci,
                   "job_s": job_s, "reference_s": ref_s,
                   "program": R.compare(st, ref, align_mode),
                   "control": R.compare(ctl, ref, align_mode),
                   "oracle_misses": ref["oracle_misses"]}
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(line + "\n")
    finally:
        cap.restore()
        shutil.rmtree(work, ignore_errors=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    readings(args.workload, [int(s) for s in args.seeds.split(",")],
             out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

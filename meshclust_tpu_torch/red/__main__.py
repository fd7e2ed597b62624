"""Red CLI: python -m meshclust_tpu_torch.red -gnm DIR [-msk DIR] [-rpt DIR] ...

Mirrors the reference Red argument pairs (RepeatsDetector.cpp:265-400).
"""
from __future__ import annotations

import argparse
import sys

from meshclust_tpu_torch.red.runner import RedConfig, run_red


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="red-tpu", description="REpeat Detector (meshclust-tpu)",
        prefix_chars="-")
    p.add_argument("-gnm", required=True, help="input genome directory (*.fa)")
    p.add_argument("-msk", help="masked-sequence output directory")
    p.add_argument("-rpt", help="repeat-location output directory")
    p.add_argument("-sco", help="score output directory")
    p.add_argument("-cnd", help="candidate-region output directory")
    p.add_argument("-len", type=int, dest="k", help="k-mer length")
    p.add_argument("-ord", type=int, dest="order", help="Markov order")
    p.add_argument("-gau", type=int, help="Gaussian half-width")
    p.add_argument("-thr", type=float, default=2.0, help="score threshold")
    p.add_argument("-min", type=int, default=3, dest="min_obs",
                   help="minimum observed k-mers")
    p.add_argument("-frm", type=int, default=1, choices=(1, 2),
                   help="rpt format")
    a = p.parse_args(argv)
    res = run_red(RedConfig(gnm=a.gnm, msk=a.msk, rpt=a.rpt, sco=a.sco,
                            cnd=a.cnd, k=a.k, order=a.order, gau=a.gau,
                            thr=a.thr, min_obs=a.min_obs, frm=a.frm))
    total = sum(len(r) for _, r in res["results"])
    print(f"Red: {total} repeat regions across {len(res['results'])} "
          f"sequences (k={res['k']}, p={res['p']:.1f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI mirroring the reference flags (Runner::get_opts, Runner.cpp:150-263).

Usage: python -m meshclust_tpu_torch.cli *.fasta [--id 0.90] [--kmer K]
       [--delta 5] [--output output.clstr] [--iterations 15] [--align]
       [--sample 3000] [--pivot 20] [--threads N] [--exact]
       [--checkpoint PREFIX]

The flags and defaults are those of meshclust_tpu/cli.py. `--align`, or an
`--id` below 0.60, runs align mode: every clustering decision is a global
alignment on the GPU. `--exact` makes every k-mer-mode decision with the
float64 host classifier. `--checkpoint PREFIX` saves the trained
classifier and the Phase-A centers under PREFIX.{model,centers}.json (in
align mode also the Phase-A alignment memo, PREFIX.memo.json) and resumes
from them when they match the run. The run needs a CUDA device and
exits non-zero without one; `--no-pallas` is refused.

Several GPUs: the CLI starts MESHCLUST_DEVICES ranks, one process each
(default 1: one process with no group), unless it
already runs as one rank under a launcher (torchrun, or the JAX package's
MESHCLUST_COORDINATOR / MESHCLUST_NUM_PROCS / MESHCLUST_PROC_ID); see
parallel/dist.py. It exits non-zero if any rank fails.
"""
from __future__ import annotations

import argparse
import sys

from torch.multiprocessing.spawn import ProcessException

from meshclust_tpu_torch import device as D
from meshclust_tpu_torch.config import ClusterConfig
from meshclust_tpu_torch.core.runner import run
from meshclust_tpu_torch.device import DeviceUnavailableError
from meshclust_tpu_torch.parallel import dist


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="meshclust-tpu-torch",
        description="GPU DNA mean-shift clustering with PyTorch and CUDA "
                    "(MeShClust-capability engine)")
    p.add_argument("files", nargs="+", help="input FASTA files")
    p.add_argument("--id", dest="similarity", type=float, default=0.90,
                   help="identity cutoff in (0,1) (default 0.90)")
    p.add_argument("-k", "--kmer", type=int, default=None,
                   help="k-mer size (default: auto from average length)")
    p.add_argument("-o", "--output", default="output.clstr",
                   help="output CLSTR file")
    p.add_argument("-a", "--align", action="store_true",
                   help="force alignment-based classification")
    p.add_argument("-s", "--sample", dest="sample_size", type=int, default=0,
                   help="total training+testing sample pairs (default 3000)")
    p.add_argument("-p", "--pivot", dest="pivots", type=int, default=20,
                   help="max pairs from one pivot (default 20)")
    p.add_argument("-d", "--delta", type=int, default=5,
                   help="cluster look-around window (default 5)")
    p.add_argument("-i", "--iter", "--iterations", dest="iterations",
                   type=int, default=15, help="update+merge iterations")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="host thread hint (device path ignores this)")
    p.add_argument("--no-pallas", action="store_true",
                   help="refused: the plain PyTorch versions of the kernels "
                        "are test oracles, not a user path")
    p.add_argument("--exact", action="store_true",
                   help="float64 host classifier (slow, parity debugging)")
    p.add_argument("--checkpoint", default=None, metavar="PREFIX",
                   help="save/resume run milestones (trained classifier + "
                        "Phase-A centers) under PREFIX.{model,centers}.json")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (0.0 < args.similarity < 1.0):
        print("Similarity must be between 0 and 1", file=sys.stderr)
        return 1
    if args.kmer is not None and args.kmer <= 0:
        print("K must be greater than 0.", file=sys.stderr)
        return 1
    if args.no_pallas:
        print("--no-pallas is not supported: the kernels' plain PyTorch "
              "versions are test oracles, not a user path", file=sys.stderr)
        return 2
    cfg = ClusterConfig(
        files=list(args.files),
        similarity=args.similarity,
        kmer=args.kmer,
        output=args.output,
        align=args.align,
        sample_size=args.sample_size,
        pivots=args.pivots,
        delta=args.delta,
        iterations=args.iterations,
        threads=args.threads,
        exact=args.exact,
        checkpoint=args.checkpoint,
    )
    try:
        n = dist.local_ranks()
        if n > 1 and not dist.under_launcher():
            D.resolve(None)          # no CUDA: refuse before any rank starts
            n_clusters = dist.launch(cluster_rank, n, None, cfg)[0]
        else:
            n_clusters = cluster_rank(cfg)
    except DeviceUnavailableError as e:
        print(f"meshclust-tpu-torch: {e}", file=sys.stderr)
        return 2
    except ProcessException as e:
        print(f"meshclust-tpu-torch: a rank failed: {e}", file=sys.stderr)
        return 1
    print(f"Wrote {n_clusters} clusters to {cfg.output}")
    return 0


def cluster_rank(cfg: ClusterConfig) -> int:
    """One rank's run (the whole run without a group); its cluster count."""
    return run(cfg)["n_clusters"]


if __name__ == "__main__":
    sys.exit(main())

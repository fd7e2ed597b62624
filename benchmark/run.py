"""The benchmark of meshclust_tpu_torch: whole clustering jobs in a timed
window.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

A run, on one CUDA card:
1. set-up (setup_s): imports, the CUDA context, the kernel library from
   build/kernels/ (built by nvcc on a checkout's first run), the cell's pool
   of corpora generated from --seed under TMPDIR, and one warm-up job;
2. the window: whole jobs back to back through the pool, each one call of
   meshclust_tpu_torch.core.runner.run(ClusterConfig(...), device="cuda")
   ending in torch.cuda.synchronize(); no job starts once --seconds have
   passed, and the window ends when the job in progress does;
3. the check: the plain reference (benchmark/reference/) recomputes one job
   of a corpus drawn from the seed, every job's CLSTR must be valid and
   equal to the other jobs' of its corpus, and each number compared is
   printed beside its limit, as the last lines on stderr and under
   "checks" in the result;
4. the result, one JSON line on stdout: with --trace 0 the cell's
   end-to-end metrics; with --trace 1 its per-layer metrics, read by
   metrics/<name>.py from the program's utils.perf spans and counters and
   a torch.profiler trace of the window, and a breakdown.

It exits non-zero without printing a result when there is no CUDA card (or
fewer than the cell asks for), when the program is not beside it, and when
a module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ["MESHCLUST_QUIET"] = "1"
# Kernel caches at fixed places inside the checkout (the program builds its
# CUDA library into build/kernels/ there itself).
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                 "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

import numpy as np  # noqa: E402

from benchmark import spec as S  # noqa: E402

# Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "meshclust_tpu")


class NoResult(Exception):
    """The run ends with a non-zero code and prints no result."""


class Run:
    """What the window measured, for the metric readers."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.job_walls: List[float] = []
        self.jobs = 0
        self.seqs_done = 0
        self.phases: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self.job_inputs: List[Dict] = []
        self.trace: Optional[Dict] = None
        self.take_s = 0.0


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(f"[bench {time.perf_counter() - T0:8.2f}s] {msg}", file=sys.stderr,
          flush=True)


def checked_corpus(seed: int, pool_size: int) -> int:
    """The pool's corpus whose first job the reference recomputes."""
    return int(np.random.default_rng([seed % (1 << 64), 7919]).integers(
        pool_size))


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def load_library(ext) -> Optional[float]:
    """Loads the program's kernel library; the seconds nvcc took to build
    it, or None when the checkout had it built already. The build is part
    of setup_s (a run that compiles) and is also reported on its own as
    device.build_s."""
    built = os.path.exists(ext.library_path())
    t = time.perf_counter()
    ext.lib()
    return None if built else time.perf_counter() - t


def card_power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def clstr_headers(path: str) -> Optional[List[str]]:
    """The member headers of a CLSTR file, None when it is not one."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return None
    heads = []
    for line in text.splitlines():
        if line.startswith(">Cluster"):
            continue
        body = line.split("\t", 1)
        if len(body) != 2 or "nt, " not in body[1]:
            return None
        heads.append(body[1].split("nt, ", 1)[1].rstrip(" *")[:-3])
    return heads


def execute(args, device: str = "cuda", faults=None) -> Dict:
    """One run on `device`; the result dict. `faults`, for the tests, is
    called once the program is imported, to plant a fault in it."""
    import torch
    spec = S.load()
    cell = S.cell(spec, args.workload)
    cfg_file = S.config(spec, cell["config"])
    traffic = S.traffic(cell["traffic"])
    if device == "cuda":
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < int(cell["chips"]):
            seen = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            raise NoResult(f"the cell needs {cell['chips']} CUDA card(s); "
                           f"torch sees {seen}")
    try:
        from meshclust_tpu_torch import _ext
        from meshclust_tpu_torch.config import ClusterConfig
        from meshclust_tpu_torch.core import runner
        from meshclust_tpu_torch.utils import perf
    except ImportError as e:
        raise NoResult(f"meshclust_tpu_torch is not importable: {e}")
    from benchmark import tracing
    from benchmark.capture import Capture
    if faults is not None:
        faults()
    dev = torch.device(device)
    build_s = None
    if device == "cuda":
        torch.cuda.init()
        build_s = load_library(_ext)

    work = tempfile.mkdtemp(prefix=f"meshclust_bench_{args.workload}_")
    try:
        gen = S.generator(traffic["generator"])
        pool = []
        for i in range(int(traffic["pool"])):
            path = os.path.join(work, f"corpus_{i}.fasta")
            info = gen.make(traffic, args.seed, i, path)
            pool.append((path, info))
        flags = dict(cfg_file["flags"])

        def job(path: str, out: str) -> Dict:
            res = runner.run(ClusterConfig(files=[path], output=out,
                                           **flags), device=dev)
            if device == "cuda":
                torch.cuda.synchronize()
            return res

        cap = Capture()
        job(pool[0][0], os.path.join(work, "warmup.clstr"))
        target = checked_corpus(args.seed, len(pool))
        perf.reset()
        for name in _ext.launches:
            _ext.launches[name] = 0
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        run = Run()
        run.setup_s = time.perf_counter() - T0

        prof = tracing.open_profiler() if args.trace else None
        states: Dict[int, Dict] = {}
        outs = []
        failed = 0
        t_start = time.perf_counter()
        with torch.profiler.record_function(tracing.WINDOW):
            n = 0
            while time.perf_counter() - t_start < args.seconds:
                ci = n % len(pool)
                path, info = pool[ci]
                out = os.path.join(work, f"job_{n}.clstr")
                want = ci not in states and (ci == target or n == 0)
                cap.active = want
                tj = time.perf_counter()
                try:
                    res = job(path, out)
                except Exception:       # a failed job is counted, not fatal
                    traceback.print_exc()
                    res = None
                    failed += 1
                run.job_walls.append(time.perf_counter() - tj)
                cap.active = False
                if res is not None:
                    run.jobs += 1
                    run.seqs_done += info["reads"]
                    run.job_inputs.append(
                        {"reads": info["reads"], "bases": info["bases"],
                         "segments": info["segments"], "k": int(res["k"])})
                    outs.append((n, ci, out))
                    if want:
                        tt = time.perf_counter()
                        states[ci] = cap.take(res)
                        run.take_s += time.perf_counter() - tt
                del res
                n += 1
        run.window_s = time.perf_counter() - t_start
        if prof is not None:
            prof.__exit__(None, None, None)
            run.trace = tracing.reduce(tracing.raw_events(prof))
            del prof
        cap.restore()
        run.phases = perf.phases()
        run.counters = perf.counters()
        launches = dict(_ext.launches)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

        kind = "per_layer" if args.trace else "end_to_end"
        metrics = {}
        for m in S.metrics_of(spec, kind, args.workload):
            v = S.metric_reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

        # -- the check, once the window's state is freed ------------------
        if device == "cuda":
            torch.cuda.empty_cache()
        checks, info = check(args, cfg_file, pool, states, target, outs,
                             dev)
        correct = (failed == 0 and run.jobs > 0
                   and all(c["value"] <= c["limit"]
                           for c in checks.values()))
        log(f"jobs {len(run.job_walls)} failed {failed} window "
            f"{run.window_s:.3f}s setup {run.setup_s:.3f}s"
            + (f" build {build_s:.3f}s" if build_s is not None else "")
            + f" take {run.take_s:.3f}s launches {launches} {info}")
        if run.trace is not None:
            log("device busy s by span: " + json.dumps(
                run.trace["busy_by_span"]))
        for name, c in checks.items():
            print(f"check {name} {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr, flush=True)
        # after the window and the reference, in the process that prints
        bad = forbidden_modules()
        if bad:
            raise NoResult(f"modules of JAX or the JAX package were loaded: "
                           f"{bad}")
        result = {
            "correct": bool(correct),
            "attempted": len(run.job_walls),
            "failed": failed,
            "metrics": metrics,
            "device": device_info(device, int(cell["chips"]), peak, run),
        }
        if build_s is not None:
            result["device"]["build_s"] = build_s
        if run.trace is not None:
            result["breakdown"] = tracing.breakdown(run.trace)
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def device_info(device: str, chips: int, peak: int, run: Run) -> Dict:
    import torch
    if device == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak),
                "power_limit": card_power_limit()}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if run.trace is not None:
        info["busy_s"] = run.trace["busy_s"]
        info["window_s"] = run.trace["window_s"]
    return info


def check(args, cfg_file: Dict, pool, states: Dict[int, Dict], target: int,
          outs, dev):
    """(the numbers compared, each with its limit; diagnostics)."""
    from benchmark.capture import settle
    from benchmark.reference import solve as R
    limits = cfg_file["limits"]
    ci = target if target in states else min(states) if states else None
    checks: Dict[str, Dict] = {}
    info = ""
    # every job's CLSTR: valid, and equal to the first of its corpus
    digests: Dict[int, str] = {}
    repeat_off = 0
    invalid = 0
    for n, c, out in outs:
        heads = clstr_headers(out)
        if heads is None or len(heads) != pool[c][1]["reads"] \
                or len(set(heads)) != len(heads):
            invalid += 1
        with open(out, "rb") as f:
            d = hashlib.sha256(f.read()).hexdigest()
        if digests.setdefault(c, d) != d:
            repeat_off += 1
    checks["clstr_invalid"] = {"value": invalid, "limit": 0}
    checks["repeat_off"] = {"value": repeat_off, "limit": 0}
    if ci is None:
        checks["reference_job"] = {"value": 1, "limit": 0}
        return checks, "no job to check"
    t = time.perf_counter()
    st = settle(states[ci])
    settle_s = time.perf_counter() - t
    out = next(o for n, c, o in outs if c == ci)
    with open(out) as f:
        st["clstr"] = f.read()
    t = time.perf_counter()
    ref = R.check_job(st, pool[ci][0], cfg_file, args.seed, dev)
    numbers = R.compare(st, ref, R.align_mode(cfg_file["flags"]))
    for name, v in numbers.items():
        checks[name] = {"value": v, "limit": limits[name]}
    info = (f"settle {settle_s:.3f}s, "
            f"reference corpus {ci} in {time.perf_counter() - t:.3f}s, "
            f"{len(ref['aligned'])} of the job's {len(st['aligned'])} "
            f"pairs aligned, oracle misses "
            f"{ref['oracle_misses']}")
    return checks, info


def main(argv=None) -> int:
    args = parse(argv)
    try:
        result = execute(args)
    except NoResult as e:
        print(f"benchmark: no result: {e}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build and bind the port's hand-written CUDA kernels (csrc/*.cu).

`nvcc` compiles every source under csrc/ for sm_90a (Hopper) at first use,
one process per source, all started together, and links the objects into
ONE shared library with a plain C interface. The library lands in
`build/kernels/` at the repository root, named by a hash of the sources and
the flags, so an edited source is rebuilt and a stale binary is never loaded.
It is loaded with ctypes; every pointer and the stream travel as c_void_p.

Each C entry point launches on the caller's current stream and returns
`cudaGetLastError()`; `check` raises on anything but 0. The wrappers in
ops/ count their launches in `launches` (`_launched` checks and counts one),
so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launch counts by kernel name; the wrappers add one per launch.
launches: Dict[str, int] = {"kmer_hist": 0, "nw_align_long": 0,
                             "pa_window": 0, "pa_sums": 0, "pa_absorb": 0,
                             "pa_move": 0, "pa_next": 0, "pb_band": 0,
                             "pb_dist": 0, "pb_pick": 0, "pb_merge": 0,
                             "pivot_order": 0}
# The element width in bytes that an entry point's `width` takes, by the
# dtype of the rows it reads.
_WIDTHS = {torch.int8: 1, torch.int16: 2, torch.int32: 4, torch.int64: 8}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # codes, rec_off, segs, seg_off, n, k, init, split, counts, ones, mag,
    # sq, largest, stream
    "mc_kmer_hist": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                     _P],
    # codes, lpad, lengths, ia, ib, P, stride, match, mismatch, go, gc, bnd,
    # alen, amatch, stream
    "mc_nw_align_long": [_P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                         _P, _P],
    # st, active, ranges, n, stream
    "mc_pa_window": [_P, _P, _P, _I, _P],
    # st, active, rows, row stride, V, width, n, with_dot, sums, stream
    "mc_pa_sums": [_P, _P, _P, _L, _I, _I, _I, _I, _P, _P],
    # st, sums, with_dot, spec, n_spec, coef, n_coef, mag, sq, lenf, owner,
    # stamp, active, rows, row stride, V, width, sumvec, n, part, stream
    "mc_pa_absorb": [_P, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                     _L, _I, _I, _P, _I, _P, _P],
    # st, owner, rows, row stride, V, width, sumvec, n, mag, stamp, dist,
    # part, stream
    "mc_pa_move": [_P, _P, _P, _L, _I, _I, _P, _I, _P, _P, _P, _P, _P],
    # st, active, owner, stamp, rows, row stride, V, width, sumvec,
    # center_slot, n, cmax, stream
    "mc_pa_next": [_P, _P, _P, _P, _P, _L, _I, _I, _P, _P, _I, _L, _P],
    # rows, row stride, hist, hist stride, V, width, m_idx, m_valid (or
    # null), M, assign, remap, c_idx, c_valid, C, mag, sq, lenf, spec,
    # n_spec, coef, n_coef, delta, bits, sc, best_d, best_pos, M_all,
    # span_cap, paths, stream
    "mc_pb_band": [_P, _L, _P, _L, _I, _I, _P, _P, _I, _P, _P, _P, _P, _I,
                   _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _L, _I,
                   _P, _P],
    # rows, row stride, V, width, m_idx, M, assign, mag, delta, bits, sc,
    # dstore, best_d, span_cap, paths, stream
    "mc_pb_dist": [_P, _L, _I, _I, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I,
                   _P, _P],
    # M, assign, delta, bits, dstore, best_d, best_pos, goff, sc, C, V,
    # stream
    "mc_pb_pick": [_I, _P, _I, _P, _P, _P, _P, _L, _P, _I, _I, _P],
    # hist, hist stride, V, width, C, c_idx, c_valid, best_pos, m_all,
    # M_all, mag, sq, lenf, spec, n_spec, coef, n_coef, delta, t_row, remap,
    # scratch, stream
    "mc_pb_merge": [_P, _L, _I, _I, _I, _P, _P, _P, _P, _L, _P, _P, _P, _P,
                    _I, _P, _I, _I, _P, _P, _P, _P],
    # hist, hist stride, V, width, mag, rows, P, perm, n, out, scratch (or
    # null), heaps, stream
    "mc_pivot_order": [_P, _L, _I, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P],
    # n -> bytes of scratch a row (0: shared memory holds it)
    "mc_pivot_order_scratch": [_I],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def headers() -> list:
    """The headers the sources include (csrc/*.cuh): part of every
    library's hash, so an edited header rebuilds it."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def _digest(srcs: list) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + headers():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(srcs: Optional[list] = None) -> str:
    """Where build(srcs) puts its library (default: csrc/*.cu)."""
    srcs = sources() if srcs is None else list(srcs)
    return os.path.join(BUILD_DIR,
                        f"libmeshclust_kernels_{_digest(srcs)}.so")


def build_log_path(srcs: Optional[list] = None) -> str:
    return library_path(srcs)[:-3] + ".log"


def _run(cmd: list) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=600)


def build(srcs: Optional[list] = None) -> str:
    """Compile srcs (default: csrc/*.cu) unless their library exists;
    returns its path. Raises with nvcc's output when the build fails."""
    srcs = sources() if srcs is None else list(srcs)
    so = library_path(srcs)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    with ThreadPoolExecutor(len(objs)) as pool:
        runs = list(pool.map(
            lambda src, obj: _run([nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src]),
            srcs, objs))
    if all(r.returncode == 0 for r in runs):
        runs.append(_run([nvcc(), "-shared", "-o", tmp, *objs]))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    log = "".join(r.stdout + r.stderr for r in runs)
    with open(so[:-3] + ".log", "w") as f:
        f.write(log)
    failed = [r.returncode for r in runs if r.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
    os.replace(tmp, so)
    return so


def load(path: str) -> ctypes.CDLL:
    """A built kernel library, its entry points typed."""
    handle = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.mc_error_string.argtypes = [ctypes.c_int]
    handle.mc_error_string.restype = ctypes.c_char_p
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().mc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def _launched(err: int, name: str) -> None:
    """check(err, name), then one launch of kernel `name` counted."""
    check(err, name)
    launches[name] += 1


def stream_of(t) -> int:
    """Raw handle of the current CUDA stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream

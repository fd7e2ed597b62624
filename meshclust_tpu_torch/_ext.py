"""Build and bind the port's hand-written CUDA kernels (csrc/*.cu).

`nvcc` compiles every source under csrc/ for sm_90a (Hopper) at first use,
one process per source, all started together, and links the objects into
ONE shared library with a plain C interface. The library lands in
`build/kernels/` at the repository root, named by a hash of the sources and
the flags, so an edited source is rebuilt and a stale binary is never loaded.
It is loaded with ctypes; every pointer and the stream travel as c_void_p.

Each C entry point launches on the caller's current stream and returns
`cudaGetLastError()`; `check` raises on anything but 0. The wrappers in
ops/ count their launches in `launches`, so a run can show that it went
through the kernels.
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

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Launch counts by kernel name; the wrappers add one per launch.
launches: Dict[str, int] = {"kmer_hist": 0, "nw_align_long": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # packed, lengths, valid, inseg, B, Lp, k, init, counts, ones, mag, sq,
    # stream
    "mc_kmer_hist": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # codes, lpad, lengths, ia, ib, P, stride, match, mismatch, go, gc, bnd,
    # alen, amatch, stream
    "mc_nw_align_long": [_P, ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _P, _P, _P, _P],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
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


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libmeshclust_kernels_{_digest()}.so")


def build_log_path() -> str:
    return library_path()[:-3] + ".log"


def _run(cmd: list) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=600)


def build() -> str:
    """Compile csrc/*.cu unless the library for these sources exists;
    returns its path. Raises with nvcc's output when the build fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources()]
    with ThreadPoolExecutor(len(objs)) as pool:
        runs = list(pool.map(
            lambda src, obj: _run([nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src]),
            sources(), objs))
    if all(r.returncode == 0 for r in runs):
        runs.append(_run([nvcc(), "-shared", "-o", tmp, *objs]))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    log = "".join(r.stdout + r.stderr for r in runs)
    with open(build_log_path(), "w") as f:
        f.write(log)
    failed = [r.returncode for r in runs if r.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.mc_error_string.argtypes = [ctypes.c_int]
            handle.mc_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().mc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    """Raw handle of the current CUDA stream on t's device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream

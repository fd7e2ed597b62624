"""Native (C++) fast paths for host-side work.

The reference is a C++ program; its host-bound stages (FASTA parsing and
encoding — ChromListMaker/ChromosomeOneDigit) get native equivalents here,
compiled on first use with g++ and loaded via ctypes. Every native path has
a numpy fallback in the owning module, and the numpy implementation remains
the tested oracle (tests/test_native_fasta.py asserts byte-equality).

Disable with MESHCLUST_NATIVE=0.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fasta_parser.cpp")
_SO = os.path.join(_DIR, "_fasta_parser.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _needs_rebuild(so_path: str, src_path: str) -> bool:
    """Rebuild decision keyed on a hash of the SOURCE, not mtimes.

    mtimes after a fresh clone are arbitrary, which previously let a stale
    (or shipped) binary be loaded instead of one built with the LOCAL
    toolchain — defeating refsort's whole purpose (bit-parity with the local
    libstdc++ std::sort) and leaving an unauditable binary in play. The
    source hash is recorded in a sidecar `<so>.srchash`; binaries are never
    committed (gitignored), so every machine compiles its own."""
    import hashlib
    if not os.path.exists(so_path):
        return True
    sidecar = so_path + ".srchash"
    try:
        with open(src_path, "rb") as f:
            h = hashlib.sha256(f.read()).hexdigest()
        with open(sidecar) as f:
            return f.read().strip() != h
    except OSError:
        return True


def _record_srchash(so_path: str, src_path: str) -> None:
    import hashlib
    with open(src_path, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()
    with open(so_path + ".srchash", "w") as f:
        f.write(h)


class _McParseResult(ctypes.Structure):
    _fields_ = [
        ("codes", ctypes.POINTER(ctypes.c_uint8)),
        ("rec_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("headers", ctypes.c_char_p),
        ("hdr_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("segs", ctypes.POINTER(ctypes.c_int64)),
        ("seg_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_rec", ctypes.c_int64),
        ("n_seg", ctypes.c_int64),
        ("total_len", ctypes.c_int64),
        ("hdr_len", ctypes.c_int64),
        ("err_pos", ctypes.c_int64),
        ("err_char", ctypes.c_uint8),
    ]


def enabled() -> bool:
    return os.environ.get("MESHCLUST_NATIVE", "1") == "1"


def get_lib() -> Optional[ctypes.CDLL]:
    """Compile (once, cached as a .so next to the source) and load."""
    global _lib, _failed
    if _lib is not None or _failed or not enabled():
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            if _needs_rebuild(_SO, _SRC):
                tmp = _SO + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     "-o", tmp, _SRC, "-lpthread"],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, _SO)
                _record_srchash(_SO, _SRC)
            lib = ctypes.CDLL(_SO)
            lib.mc_parse_fasta.restype = ctypes.POINTER(_McParseResult)
            lib.mc_parse_fasta.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.mc_free_result.argtypes = [ctypes.POINTER(_McParseResult)]
            lib.mc_free_result.restype = None
            _lib = lib
        except Exception:
            _failed = True
    return _lib


def parse_fasta_native(path: str, n_threads: int = 0):
    """Parse + encode one FASTA file natively.

    Returns (headers list[str], codes [total] uint8, rec_offsets [n+1],
    segs [S,2] int64, seg_offsets [n+1]) or None if the native path is
    unavailable or reports an error (caller falls back to numpy, which
    also produces the reference-matching error message)."""
    lib = get_lib()
    if lib is None:
        return None
    res = lib.mc_parse_fasta(path.encode(), n_threads)
    try:
        r = res.contents
        if r.err_pos != -1:
            return None
        n = int(r.n_rec)
        total = int(r.total_len)
        n_seg = int(r.n_seg)
        codes = np.ctypeslib.as_array(r.codes, shape=(max(total, 1),))[
            :total].copy()
        rec_off = np.ctypeslib.as_array(r.rec_offsets, shape=(n + 1,)).copy()
        hdr_off = np.ctypeslib.as_array(r.hdr_offsets, shape=(n + 1,)).copy()
        hdr_blob = ctypes.string_at(r.headers, int(r.hdr_len))
        segs = np.ctypeslib.as_array(
            r.segs, shape=(max(n_seg, 1), 2))[:n_seg].copy()
        seg_off = np.ctypeslib.as_array(r.seg_offsets, shape=(n + 1,)).copy()
        headers = [
            hdr_blob[hdr_off[i]: hdr_off[i + 1]].decode("utf-8", "replace")
            for i in range(n)
        ]
        return headers, codes, rec_off, segs, seg_off
    finally:
        lib.mc_free_result(res)


# ---------------------------------------------------------------------------
# refsort: libstdc++-exact std::sort permutations (see refsort.cpp)
# ---------------------------------------------------------------------------
_RS_SRC = os.path.join(_DIR, "refsort.cpp")
_RS_SO = os.path.join(_DIR, "_refsort.so")
_rs_lib: Optional[ctypes.CDLL] = None
_rs_failed = False


def get_refsort() -> Optional[ctypes.CDLL]:
    global _rs_lib, _rs_failed
    if _rs_lib is not None or _rs_failed or not enabled():
        return _rs_lib
    with _lock:
        if _rs_lib is not None or _rs_failed:
            return _rs_lib
        try:
            if _needs_rebuild(_RS_SO, _RS_SRC):
                tmp = _RS_SO + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                     "-o", tmp, _RS_SRC],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, _RS_SO)
                _record_srchash(_RS_SO, _RS_SRC)
            lib = ctypes.CDLL(_RS_SO)
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.mc_sort_perm.restype = None
            lib.mc_sort_perm.argtypes = [i32p, i64p, ctypes.c_int64]
            lib.mc_sort_perm_batch.restype = None
            lib.mc_sort_perm_batch.argtypes = [i32p, i64p, ctypes.c_int64,
                                               ctypes.c_int64]
            _rs_lib = lib
        except Exception:
            _rs_failed = True
    return _rs_lib


def ref_sort_perm(idx: np.ndarray, keys: np.ndarray) -> bool:
    """In-place std::sort of idx by keys[idx]; False if unavailable."""
    lib = get_refsort()
    if lib is None:
        return False
    assert idx.dtype == np.int32 and idx.flags.c_contiguous
    k = np.ascontiguousarray(keys, np.int64)
    lib.mc_sort_perm(idx, k, idx.shape[0])
    return True


# ---------------------------------------------------------------------------
# bvec bulk insertion (see bvec_insert.cpp)
# ---------------------------------------------------------------------------
_BV_SRC = os.path.join(_DIR, "bvec_insert.cpp")
_BV_SO = os.path.join(_DIR, "_bvec_insert.so")
_bv_lib: Optional[ctypes.CDLL] = None
_bv_failed = False


def get_bvec_insert() -> Optional[ctypes.CDLL]:
    global _bv_lib, _bv_failed
    if _bv_lib is not None or _bv_failed or not enabled():
        return _bv_lib
    with _lock:
        if _bv_lib is not None or _bv_failed:
            return _bv_lib
        try:
            if _needs_rebuild(_BV_SO, _BV_SRC):
                tmp = _BV_SO + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     "-o", tmp, _BV_SRC],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, _BV_SO)
                _record_srchash(_BV_SO, _BV_SRC)
            lib = ctypes.CDLL(_BV_SO)
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.mc_bvec_targets.restype = None
            lib.mc_bvec_targets.argtypes = [i64p, ctypes.c_int64, i64p,
                                            ctypes.c_int64, i32p]
            _bv_lib = lib
        except Exception:
            _bv_failed = True
    return _bv_lib


def bvec_targets(lengths: np.ndarray, bounds: np.ndarray
                 ) -> Optional[np.ndarray]:
    """Target bin per point for the sequential least-filled insert rule;
    None if the native path is unavailable (caller falls back to Python)."""
    lib = get_bvec_insert()
    if lib is None:
        return None
    ln = np.ascontiguousarray(lengths, np.int64)
    bb = np.ascontiguousarray(bounds, np.int64)
    out = np.empty(ln.shape[0], np.int32)
    lib.mc_bvec_targets(ln, ln.shape[0], bb, bb.shape[0], out)
    return out


def ref_sort_perm_batch(idx: np.ndarray, keys: np.ndarray) -> bool:
    """Row-wise in-place std::sort of idx [P, N] by keys [P, N]."""
    lib = get_refsort()
    if lib is None:
        return False
    assert idx.dtype == np.int32 and idx.flags.c_contiguous
    k = np.ascontiguousarray(keys, np.int64)
    lib.mc_sort_perm_batch(idx, k, idx.shape[0], idx.shape[1])
    return True


# ---------------------------------------------------------------------------
# Red scanner Viterbi (see red_viterbi.cpp)
# ---------------------------------------------------------------------------
_RV_SRC = os.path.join(_DIR, "red_viterbi.cpp")
_RV_SO = os.path.join(_DIR, "_red_viterbi.so")
_rv_lib: Optional[ctypes.CDLL] = None
_rv_failed = False


def get_red_viterbi() -> Optional[ctypes.CDLL]:
    global _rv_lib, _rv_failed
    if _rv_lib is not None or _rv_failed or not enabled():
        return _rv_lib
    with _lock:
        if _rv_lib is not None or _rv_failed:
            return _rv_lib
        try:
            if _needs_rebuild(_RV_SO, _RV_SRC):
                tmp = _RV_SO + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                     "-o", tmp, _RV_SRC],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, _RV_SO)
                _record_srchash(_RV_SO, _RV_SRC)
            lib = ctypes.CDLL(_RV_SO)
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.mc_red_viterbi.restype = None
            lib.mc_red_viterbi.argtypes = [i64p, ctypes.c_int64, f64p, f64p,
                                           ctypes.c_int64, u8p, i64p]
            _rv_lib = lib
        except Exception:
            _rv_failed = True
    return _rv_lib


def red_viterbi(st: np.ndarray, priors: np.ndarray, trans: np.ndarray,
                npos: int) -> Optional[np.ndarray]:
    """Native 2-state Viterbi decode; None if unavailable (caller falls
    back to the numpy scalar loop, which remains the tested oracle)."""
    lib = get_red_viterbi()
    if lib is None:
        return None
    stc = np.ascontiguousarray(st, np.int64)
    pr = np.ascontiguousarray(priors, np.float64)
    tr = np.ascontiguousarray(trans, np.float64)
    n = stc.shape[0]
    back = np.empty(n * 2, np.uint8)
    out = np.empty(n, np.int64)
    lib.mc_red_viterbi(stc, n, pr, tr, npos, back, out)
    return out

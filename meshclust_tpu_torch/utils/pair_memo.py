"""Align mode's identity memo: pair (a, b) -> global-alignment identity.

The reference memoizes every alignment by id pair (Feature::align's atable,
Feature.cpp:222-243); AlignBackend asks for whole batches of pairs, a
Phase A aligner batch or a Phase B sweep at a time, and inserts each
batch's misses. A 15k-read `--id 0.90 --align` job grows the memo to ~1.8M
pairs over ~300 batches, so the storage must insert a batch in time
proportional to the batch, not to the memo.

PairMemo keeps the pairs in an open-addressing hash table in C++
(native/pair_memo.cpp, built with g++ on first use like the other native
paths), one ctypes call a batch. Where the native path is disabled
(MESHCLUST_NATIVE=0) or does not build, the same class keeps sorted arrays
and merges each batch in (np.searchsorted + np.insert): the numpy oracle
the tests hold the table to.

Semantics (those of the sorted-array memo that the JAX package keeps): a
key keeps the first value inserted for it; `found` is exact; a value is
defined only where `found` is true (it reads 0 elsewhere).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import weakref
from typing import Optional, Tuple

import numpy as np

from meshclust_tpu_torch import native
from meshclust_tpu_torch.utils import perf

_SRC = os.path.join(native._DIR, "pair_memo.cpp")
_SO = os.path.join(native._DIR, "_pair_memo.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def get_lib() -> Optional[ctypes.CDLL]:
    """Compile (once, cached as a .so next to the source) and load; None
    where the native paths are disabled or the build fails."""
    global _lib, _failed
    if not native.enabled():
        return None
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            if native._needs_rebuild(_SO, _SRC):
                tmp = _SO + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     "-o", tmp, _SRC],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, _SO)
                native._record_srchash(_SO, _SRC)
            lib = ctypes.CDLL(_SO)
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            boolp = np.ctypeslib.ndpointer(np.bool_, flags="C_CONTIGUOUS")
            vp = ctypes.c_void_p
            lib.mc_memo_new.restype = vp
            lib.mc_memo_new.argtypes = []
            lib.mc_memo_free.restype = None
            lib.mc_memo_free.argtypes = [vp]
            lib.mc_memo_live.restype = ctypes.c_int64
            lib.mc_memo_live.argtypes = []
            lib.mc_memo_size.restype = ctypes.c_int64
            lib.mc_memo_size.argtypes = [vp]
            lib.mc_memo_insert.restype = ctypes.c_int64
            lib.mc_memo_insert.argtypes = [vp, i64p, f64p, ctypes.c_int64]
            lib.mc_memo_lookup.restype = ctypes.c_int64
            lib.mc_memo_lookup.argtypes = [vp, i64p, ctypes.c_int64, f64p,
                                           boolp]
            lib.mc_memo_export.restype = None
            lib.mc_memo_export.argtypes = [vp, i64p, f64p]
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _failed = True
    return _lib


def live_tables() -> int:
    """Native tables allocated and not yet freed in this process (0 where
    the library was never loaded)."""
    return 0 if _lib is None else int(_lib.mc_memo_live())


class PairMemo:
    """(a, b) -> identity memo, keyed by lo * n + hi (lo = min(a, b)).

    lookup(keys) -> (vals, found) and insert(keys, vals) take a batch each;
    `keys` and `vals` export the contents sorted by key (a sort a call: not
    for the hot path); load(keys, vals) replaces the contents."""

    def __init__(self, n: int):
        self.n = np.int64(n)
        self._lib = get_lib()
        self._free = None
        self._reset()

    def _reset(self) -> None:
        """Empty storage: a new native table (the old one freed now) or
        empty sorted arrays."""
        if self._free is not None:
            self._free()
        self._h = None
        self._free = None
        self._keys = np.empty(0, np.int64)
        self._vals = np.empty(0, np.float64)
        if self._lib is not None:
            h = self._lib.mc_memo_new()
            if not h:
                raise MemoryError("pair memo: no memory for a table")
            self._h = ctypes.c_void_p(h)
            self._free = weakref.finalize(self, self._lib.mc_memo_free,
                                          self._h)

    def key_of(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        lo = np.minimum(a, b).astype(np.int64)
        hi = np.maximum(a, b).astype(np.int64)
        return lo * self.n + hi

    def lookup(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """-> (vals [K] float64, found [K] bool); vals is 0 where not
        found."""
        keys = np.ascontiguousarray(keys, np.int64)
        k = keys.shape[0]
        if self._h is not None:
            vals = np.empty(k, np.float64)
            found = np.empty(k, np.bool_)
            hits = self._lib.mc_memo_lookup(self._h, keys, k, vals, found)
        elif self._keys.shape[0] == 0:
            vals, found, hits = np.zeros(k), np.zeros(k, np.bool_), 0
        else:
            idx = np.minimum(np.searchsorted(self._keys, keys),
                             self._keys.shape[0] - 1)
            found = self._keys[idx] == keys
            vals = np.where(found, self._vals[idx], 0.0)
            hits = int(np.count_nonzero(found))
        perf.add("memo_hits", hits)
        return vals, found

    def insert(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Insert each absent key with its value: a key already present, or
        repeated in `keys`, keeps the first value it was given."""
        keys = np.ascontiguousarray(keys, np.int64)
        vals = np.ascontiguousarray(vals, np.float64)
        if keys.shape != vals.shape or keys.ndim != 1:
            raise ValueError(f"pair memo: keys {keys.shape} and values "
                             f"{vals.shape} must be one matching row")
        if self._h is not None:
            added = self._lib.mc_memo_insert(self._h, keys, vals,
                                             keys.shape[0])
            if added == -1:
                raise ValueError("pair memo: a negative key")
            if added < 0:
                raise MemoryError("pair memo: no memory to grow the table")
        else:
            if keys.shape[0] and keys.min() < 0:
                raise ValueError("pair memo: a negative key")
            added = self._merge(keys, vals)
        perf.add("memo_inserts", added)

    def _merge(self, keys: np.ndarray, vals: np.ndarray) -> int:
        """The sorted-array insert: the batch's new keys (each at its first
        occurrence) merged into place."""
        uk, first = np.unique(keys, return_index=True)
        pos = np.searchsorted(self._keys, uk)
        have = np.zeros(uk.shape[0], np.bool_)
        inside = pos < self._keys.shape[0]
        have[inside] = self._keys[pos[inside]] == uk[inside]
        new = ~have
        self._keys = np.insert(self._keys, pos[new], uk[new])
        self._vals = np.insert(self._vals, pos[new], vals[first[new]])
        return int(np.count_nonzero(new))

    def export(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys, vals), sorted by key: new read-only arrays."""
        if self._h is None:
            keys, vals = self._keys.view(), self._vals.view()
        else:
            size = int(self._lib.mc_memo_size(self._h))
            keys = np.empty(size, np.int64)
            vals = np.empty(size, np.float64)
            self._lib.mc_memo_export(self._h, keys, vals)
            order = np.argsort(keys)
            keys, vals = keys[order], vals[order]
        keys.flags.writeable = False
        vals.flags.writeable = False
        return keys, vals

    @property
    def keys(self) -> np.ndarray:
        return self.export()[0]

    @property
    def vals(self) -> np.ndarray:
        return self.export()[1]

    def load(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Replace the contents with these pairs (a checkpoint's memo)."""
        self._reset()
        self.insert(keys, vals)

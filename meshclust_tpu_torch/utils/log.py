"""Structured phase logging (replaces the reference's cout logs, SURVEY §5.5)."""
from __future__ import annotations

import os
import sys
import time

_VERBOSE = os.environ.get("MESHCLUST_QUIET", "0") != "1"
_START = time.time()


def log(msg: str) -> None:
    if _VERBOSE:
        print(f"[{time.time() - _START:8.2f}s] {msg}", file=sys.stderr,
              flush=True)


def set_verbose(v: bool) -> None:
    global _VERBOSE
    _VERBOSE = v

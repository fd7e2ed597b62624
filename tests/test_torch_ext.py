"""The C entry points that _ext binds must exist in the CUDA sources.

The library is built only where nvcc is, so a symbol that _ext.lib() looks
up and no source under csrc/ defines would show only on a GPU machine, as
a failed load. Each bound name must be defined `extern "C"` in exactly one
source, and each counted kernel must have its entry point.
"""
import re

import pytest

from meshclust_tpu_torch import _ext

BOUND = sorted(_ext._SIGNATURES) + ["mc_error_string"]


def _defined():
    names = []
    for path in _ext.sources():
        with open(path) as f:
            names += re.findall(r'extern "C"[^(]*?\b(mc_\w+)\s*\(', f.read())
    return names


@pytest.mark.parametrize("name", BOUND)
def test_bound_symbol_is_defined_once(name):
    assert _defined().count(name) == 1


@pytest.mark.parametrize("kernel", sorted(_ext.launches))
def test_counted_kernel_has_entry_point(kernel):
    assert f"mc_{kernel}" in _ext._SIGNATURES


def _arities():
    """{entry point: its number of parameters} in the CUDA sources."""
    out = {}
    for path in _ext.sources():
        with open(path) as f:
            for name, params in re.findall(
                    r'extern "C"[^(]*?\b(mc_\w+)\s*\(([^)]*)\)', f.read()):
                out[name] = len([p for p in params.split(",") if p.strip()])
    return out


@pytest.mark.parametrize("name", sorted(_ext._SIGNATURES))
def test_bound_signature_has_the_sources_arity(name):
    """ctypes passes what argtypes lists: a count that differs from the C
    entry point's would shift every later argument on a GPU machine."""
    assert len(_ext._SIGNATURES[name]) == _arities()[name]

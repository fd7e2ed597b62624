"""The port's carried-over host modules must not drift from the JAX package.

meshclust_tpu imports jax at package level, so the port (which runs where
there is no jax) carries its own copies of the jax-free host modules. Each
copy must equal its original once two things are normalised: the package
name, and the upstream MeShClust source prefix that the originals spell as
an absolute path in a few docstrings.

Functions and classes that the port's own modules carry over verbatim are
held to their originals the same way, by source.
"""
import inspect
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UPSTREAM_PREFIX = "/" + "root/reference/"

COPIED_FILES = [
    "config.py", "errors.py", "io/fasta.py", "io/clstr.py", "core/bvec.py",
    "core/rng.py", "core/meanshift.py", "ops/glm.py", "utils/log.py",
    "utils/progress.py", "utils/perf.py", "native/__init__.py",
    "native/fasta_parser.cpp", "native/refsort.cpp",
    "native/bvec_insert.cpp",
]

# (port module, original module, qualified name)
COPIED_OBJECTS = [
    ("core.classify", "core.classify", "HostBackend"),
    ("core.classify", "core.classify", "_PairMemo"),
    ("core.classify", "core.classify", "AlignBackend"),
    ("core.points", "core.points", "_fma_1_minus_sq"),
    ("core.points", "core.points", "PointSet.distance"),
    ("core.points", "core.points", "PointSet.distance_row"),
    ("ops.histogram", "ops.histogram", "find_k"),
    ("ops.histogram", "ops.histogram", "storage_dtype"),
    ("core.trainer", "core.trainer", "Trainer.split"),
    ("core.trainer", "core.trainer", "Trainer.get_labels"),
    ("core.trainer", "core.trainer", "Trainer.train"),
    ("core.trainer", "core.trainer", "Trainer.pair_raw"),
    ("core.trainer", "core.trainer", "resize_vec"),
    ("core.trainer", "core.trainer", "bin_data"),
]


def _read(pkg, rel):
    with open(os.path.join(ROOT, pkg, rel)) as f:
        return f.read()


def _normalise(copy_text):
    return copy_text.replace("meshclust_tpu_torch", "meshclust_tpu")


@pytest.mark.parametrize("rel", COPIED_FILES)
def test_copy_equals_original(rel):
    original = _read("meshclust_tpu", rel).replace(UPSTREAM_PREFIX, "")
    assert _normalise(_read("meshclust_tpu_torch", rel)) == original


def test_features_copy_equals_original_without_jax():
    """ops/features.py is carried over without its only jax code, the
    pair_sums_device function and the jax imports."""
    original = _read("meshclust_tpu", "ops/features.py")
    start = original.index("@jax.jit\ndef pair_sums_device")
    end = original.index("def pair_sums_exact")
    original = original[:start] + original[end:]
    original = original.replace("import jax\nimport jax.numpy as jnp\n", "")
    assert _normalise(_read("meshclust_tpu_torch", "ops/features.py")) \
        == original


def _source(module, qualname):
    import importlib
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return inspect.getsource(obj)


@pytest.mark.parametrize("port_mod,orig_mod,qualname", COPIED_OBJECTS,
                         ids=[f"{m}.{q}" for m, _, q in COPIED_OBJECTS])
def test_carried_object_equals_original(port_mod, orig_mod, qualname):
    got = _source(f"meshclust_tpu_torch.{port_mod}", qualname)
    want = _source(f"meshclust_tpu.{orig_mod}", qualname)
    assert _normalise(got) == want

"""The port's carried-over host modules must not drift from the JAX package.

meshclust_tpu imports jax at package level, so the port (which runs where
there is no jax) carries its own copies of the jax-free host modules. Each
copy must equal its original once three things are normalised: the package
name, the upstream MeShClust source prefix that the originals spell as an
absolute path in a few docstrings, and utils.perf spans and counters, which
the port opens and counts where the JAX package has none: every
`with perf.phase("..."):` (or `_perf.phase`) line holding that one item is
removed from both sides and its body dedented; every one-line
`perf.add("...", <expr>)` statement whose <expr> calls nothing but `len`,
`int` or `float` and assigns nothing, and a module-level
`from meshclust_tpu.utils import perf`, is removed from both sides.

Functions and classes that the port's own modules carry over verbatim are
held to their originals the same way, by source.
"""
import ast
import inspect
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UPSTREAM_PREFIX = "/" + "root/reference/"

COPIED_FILES = [
    "config.py", "errors.py", "io/fasta.py", "io/clstr.py", "core/bvec.py",
    "core/rng.py", "core/meanshift.py", "ops/glm.py", "utils/log.py",
    "utils/progress.py", "native/__init__.py",
    "native/fasta_parser.cpp", "native/refsort.cpp",
    "native/bvec_insert.cpp", "native/red_viterbi.cpp",
    "utils/checkpoint.py", "utils/metrics.py", "ops/align_extra.py",
    "red/__init__.py", "red/__main__.py", "red/detector.py",
    "red/scanner.py", "red/scorer.py",
]

# (port module, original module, qualified name)
COPIED_OBJECTS = [
    ("core.classify", "core.classify", "HostBackend"),
    # _PairMemo is no copy: the port's is a hash table
    # (utils/pair_memo.py), held to the original's results by
    # tests/test_torch_pair_memo.py.
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
    ("red.emv", "red.emv", "valid_mask"),
    ("red.emv", "red.emv", "count_words"),
    ("red.emv", "red.emv", "build_table"),
    ("red.runner", "red.runner", "RedConfig"),
    ("red.runner", "red.runner", "_genome_files"),
]


def _read(pkg, rel):
    with open(os.path.join(ROOT, pkg, rel)) as f:
        return f.read()


SPAN = re.compile(r'^( *)with _?perf\.phase\("[A-Za-z0-9_.]+"\):$')


def strip_spans(text):
    """`text` without its span statements, each one's body dedented by the
    indent it had under the statement (blank lines are kept as they are)."""
    out = []
    open_spans = []     # [the statement's indent, its body's shift or None]
    for line in text.split("\n"):
        if line.strip():
            ind = len(line) - len(line.lstrip(" "))
            if open_spans and open_spans[-1][1] is None:
                open_spans[-1][1] = ind - open_spans[-1][0]
                assert open_spans[-1][1] > 0, line
            while open_spans and ind <= open_spans[-1][0]:
                open_spans.pop()
            shift = sum(b for _, b in open_spans)
            m = SPAN.match(line)
            if m:
                open_spans.append([ind, None])
                continue
            line = line[shift:]
        out.append(line)
    return "\n".join(out)


COUNTER = re.compile(r'^ *_?perf\.add\("[A-Za-z0-9_.]+", .+\)$')
PERF_IMPORT = re.compile(r'^from meshclust_tpu(_torch)?\.utils import perf$')


# Nodes that would let a counter's argument act: a call (other than of
# these builtins), an assignment expression, a lambda, a yield or an await.
ACTS = (ast.Call, ast.NamedExpr, ast.Lambda, ast.Yield, ast.YieldFrom,
        ast.Await)
PURE_CALLS = ("len", "int", "float")


def _acts(node):
    return isinstance(node, ACTS) and not (
        isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
        and node.func.id in PURE_CALLS)


def _is_counter(line):
    """Whether the line, parsed, is one statement and nothing else: a call
    `perf.add("<name>", <expr>)` (or `_perf.add`) whose <expr> calls
    nothing but `len`, `int` or `float` and assigns nothing."""
    try:
        body = ast.parse(line.strip()).body
    except SyntaxError:
        return False
    if len(body) != 1 or not isinstance(body[0], ast.Expr):
        return False
    call = body[0].value
    return (isinstance(call, ast.Call)
            and isinstance(call.func, ast.Attribute)
            and call.func.attr == "add"
            and isinstance(call.func.value, ast.Name)
            and call.func.value.id in ("perf", "_perf")
            and len(call.args) == 2 and not call.keywords
            and isinstance(call.args[0], ast.Constant)
            and isinstance(call.args[0].value, str)
            and not any(_acts(n) for n in ast.walk(call.args[1])))


def _perf_line(line):
    """A one-line counter statement or the module-level import of
    utils.perf."""
    if PERF_IMPORT.match(line):
        return True
    return bool(COUNTER.match(line)) and _is_counter(line)


def strip_perf(text):
    """`text` without its counter statements, its module-level perf import
    and its span statements (`strip_spans`)."""
    return strip_spans("\n".join(line for line in text.split("\n")
                                  if not _perf_line(line)))


def _normalise(copy_text):
    return strip_perf(copy_text.replace("meshclust_tpu_torch",
                                        "meshclust_tpu"))


@pytest.mark.parametrize("rel", COPIED_FILES)
def test_copy_equals_original(rel):
    original = strip_perf(
        _read("meshclust_tpu", rel).replace(UPSTREAM_PREFIX, ""))
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


def test_red_hmm_copy_equals_original_without_jax():
    """red/hmm.py is carried over without decode_states_device, the only
    jax code (a jax.lax.scan Viterbi with no caller), and the docstring
    line that names it."""
    original = _read("meshclust_tpu", "red/hmm.py")
    start = original.index("    def decode_states_device(")
    end = original.index("    def decode_regions(")
    original = original[:start] + original[end:]
    original = original.replace(
        "implemented both as a numpy loop\n(oracle) and as a jax.lax.scan "
        "(device path).\n",
        "implemented as a numpy loop\n(oracle) and in C++ "
        "(native/red_viterbi.cpp).\n")
    copy = _normalise(_read("meshclust_tpu_torch", "red/hmm.py"))
    assert "jax" not in copy
    assert copy == original


def _masking_span(source):
    """run_red's source without its masked-output pairing: from the plain
    reader's cache fill to the one-digit fallback."""
    start = source.index("                if fpath not in plain_cache:")
    end = source.index("                    lut = np.array(")
    return source[:start] + source[end:]


def test_red_runner_equals_original_but_pairing():
    """run_red is verbatim but for the masked output's pairing (by index,
    not by header and length) and the loop index it needs."""
    got = _normalise(_source("meshclust_tpu_torch.red.runner", "run_red"))
    want = _source("meshclust_tpu.red.runner", "run_red")
    got = got.replace("for fi_file, s in enumerate(fseqs):",
                      "for s in fseqs:")
    assert _masking_span(got) == _masking_span(want)


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
    want = strip_perf(_source(f"meshclust_tpu.{orig_mod}", qualname))
    assert _normalise(got) == want


ORIGINAL = """def f(xs):
    total = 0
    for x in xs:
        total += x  # the sum

    return total
"""


@pytest.mark.parametrize("copy,equal", [
    (ORIGINAL, True),
    (ORIGINAL.replace("    for x in xs:\n        total += x",
                      "    with perf.phase(\"sum\"):\n"
                      "        for x in xs:\n            total += x"), True),
    (ORIGINAL.replace("    for x in xs:\n        total += x",
                      "    with perf.phase(\"sum\"):\n"
                      "        with _perf.phase(\"inner\"):\n"
                      "            for x in xs:\n"
                      "                total += x"), True),
    (ORIGINAL.replace("    for x in xs:\n        total += x",
                      "    with perf.phase(\"sum\"):\n"
                      "        for x in xs:\n            total -= x"), False),
    (ORIGINAL.replace("    for x in xs:\n        total += x",
                      "    with perf.phase(\"sum\"), open(\"f\"):\n"
                      "        for x in xs:\n            total += x"), False),
    (ORIGINAL.replace("    total = 0\n",
                      "    with perf.phase(\"init\"):\n"
                      "        total = 0\n"
                      "        # a note\n"), False),
], ids=["same", "span_removed", "nested_spans_removed",
        "changed_in_span_body", "span_with_two_items", "line_added_in_span"])
def test_span_normaliser(copy, equal):
    """A span added around original lines passes; anything else that
    differs, inside a span's body or in the statement itself, fails."""
    assert (strip_spans(copy) == strip_spans(ORIGINAL)) is equal


@pytest.mark.parametrize("copy,equal", [
    (ORIGINAL.replace("    total = 0\n",
                      "    total = 0\n    perf.add(\"items\", len(xs))\n"),
     True),
    (ORIGINAL.replace("        total += x",
                      "        _perf.add(\"items\", 1)\n"
                      "        total += x"), True),
    (ORIGINAL.replace("    for x in xs:\n        total += x",
                      "    with perf.phase(\"sum\"):\n"
                      "        perf.add(\"items\", len(xs))\n"
                      "        for x in xs:\n            total += x"), True),
    ("from meshclust_tpu.utils import perf\n" + ORIGINAL, True),
    ("from meshclust_tpu_torch.utils import perf\n" + ORIGINAL, True),
    (ORIGINAL.replace("    total = 0\n",
                      "    total = 1\n    perf.add(\"items\", len(xs))\n"),
     False),
    (ORIGINAL.replace("        total += x",
                      "        perf.add(\"items\", 1)\n"
                      "        total -= x"), False),
    (ORIGINAL.replace("    total = 0\n",
                      "    total = 0\n    perf.add(\"items\", len(xs))"
                      "; total += 1\n"), False),
    (ORIGINAL.replace("    total = 0\n",
                      "    total = 0\n    perf.add(\"items\", len(\n"
                      "        xs))\n"), False),
    (ORIGINAL.replace("    total = 0\n",
                      "    total = 0\n    perf.add(\"items\", 1); xs.clear()\n"),
     False),
    (ORIGINAL.replace("    total = 0\n",
                      "    total = 0\n    perf.add(\"items\", 1) or xs.clear()\n"),
     False),
    (ORIGINAL.replace("    total = 0\n",
                      "    total = 0\n    perf.add(\"items\", xs.shape[0])\n"),
     True),
    (ORIGINAL.replace("    total = 0\n",
                      "    total = 0\n    perf.add(\"items\", xs.pop())\n"),
     False),
    (ORIGINAL.replace("    total = 0\n",
                      "    total = 0\n    perf.add(\"items\", (n := 1))\n"),
     False),
    (ORIGINAL.replace("    total = 0\n",
                      "    total = 0\n    perf.add(\"items\", 1)\n"
                      "    from meshclust_tpu.utils import perf\n"), False),
    ("from meshclust_tpu.utils import log\n" + ORIGINAL, False),
], ids=["counter_removed", "counter_in_loop_removed",
        "counter_in_span_removed", "module_import_removed",
        "port_module_import_removed", "changed_line_beside_counter",
        "changed_line_after_counter", "counter_with_a_second_statement",
        "counter_over_two_lines", "counter_then_a_call_kept",
        "counter_or_a_call_kept", "counter_of_a_subscript_removed",
        "counter_calling_kept", "counter_assigning_kept",
        "indented_import_kept",
        "other_import_kept"])
def test_counter_and_import_normaliser(copy, equal):
    """Counter statements and the module-level perf import are removed from
    both sides; any other line that differs, beside them or sharing their
    line, fails."""
    assert (strip_perf(copy) == strip_perf(ORIGINAL)) is equal

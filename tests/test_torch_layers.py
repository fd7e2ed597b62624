"""The port's layers run one way, and the device classifier is defined once.

The modules under meshclust_tpu_torch/ops/ (the kernels' wrappers, their
plain versions and the classifier they share) sit below core/: none of
them imports meshclust_tpu_torch.core, at module level or inside a
function. ops/classifier.py owns the device classifier: the names below
are each defined once in the port (an assignment of another name, such as
DeviceBackend.SUPPORTED = CL.SUPPORTED, refers to a definition and is not
one). Read from each module's source with ast; nothing is imported.
"""
import ast
import glob
import os

import pytest

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "meshclust_tpu_torch")
OPS = sorted(os.path.basename(p)
             for p in glob.glob(os.path.join(PKG, "ops", "*.py")))
# name -> the one module that defines it
DEFINED_ONCE = {name: "ops/classifier.py" for name in (
    "Scorer", "Model", "SUPPORTED", "row_dtype", "widen",
    "_INT32_PRODUCT_MAX", "mean_floor", "DBL_MIN")}
DEFINED_ONCE.update(_WIDTHS="_ext.py", _launched="_ext.py")


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read(), path)


def imported_modules(path, package):
    """Every module an import statement of the file at `path` (a module of
    `package`) names, relative imports resolved, `from p import m` as
    both p and p.m."""
    out = []
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = package.split(".")
                base = ".".join(parts[: len(parts) - node.level + 1])
                mod = f"{base}.{node.module}" if node.module else base
            else:
                mod = node.module
            out.append(mod)
            out += [f"{mod}.{a.name}" for a in node.names]
    return out


def definitions(path, name):
    """The lines at which the module at `path` defines `name`: a function
    or class of that name, or an assignment to it of anything but another
    name or attribute, at module or class level."""
    lines = []
    scopes = [_tree(path)]
    while scopes:
        for node in scopes.pop().body:
            if isinstance(node, ast.ClassDef):
                scopes.append(node)
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                    and node.name == name:
                lines.append(node.lineno)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                names = [n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name)]
                if name in names and not isinstance(
                        node.value, (ast.Name, ast.Attribute)):
                    lines.append(node.lineno)
    return lines


@pytest.mark.parametrize("module", OPS)
def test_ops_module_imports_no_core(module):
    mods = imported_modules(os.path.join(PKG, "ops", module),
                            "meshclust_tpu_torch.ops")
    assert not [m for m in mods if m == "meshclust_tpu_torch.core"
                or m.startswith("meshclust_tpu_torch.core.")]


def test_import_scan_sees_core_imports():
    """core/runner.py imports core modules, absolutely: the scan finds
    them."""
    mods = imported_modules(os.path.join(PKG, "core", "runner.py"),
                            "meshclust_tpu_torch.core")
    assert "meshclust_tpu_torch.core.classify" in mods


@pytest.mark.parametrize("name", sorted(DEFINED_ONCE))
def test_defined_once_in_the_port(name):
    found = {}
    for path in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        lines = definitions(path, name)
        if lines:
            found[os.path.relpath(path, PKG)] = lines
    assert list(found) == [DEFINED_ONCE[name]]
    assert len(found[DEFINED_ONCE[name]]) == 1


def test_device_backend_supported_is_the_classifiers():
    from meshclust_tpu_torch.core.classify import DeviceBackend
    from meshclust_tpu_torch.ops import classifier as CL
    assert DeviceBackend.SUPPORTED is CL.SUPPORTED

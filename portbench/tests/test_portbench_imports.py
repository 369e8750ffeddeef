"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program either.  Top-level module names
are compared whole: the program's name begins with the JAX package's."""

import ast
import glob
import os

import pytest

from portbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "photo_search_engine_tpu"}
SOURCES = sorted(glob.glob(os.path.join(manifest.ROOT, "portbench", "**", "*.py"), recursive=True))


def imported(source: str):
    """Top-level names of every module the source imports."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, manifest.ROOT))
def test_no_jax_import(path):
    with open(path, encoding="utf-8") as f:
        assert not imported(f.read()) & FORBIDDEN


JUDGES = [os.path.join(manifest.ROOT, "portbench", "reference.py")] + sorted(
    glob.glob(os.path.join(manifest.ROOT, "portbench", "judges", "*.py")))


def imported_from(source: str):
    """Every module the source imports, by its whole dotted name (``from a
    import b`` gives ``a.b``)."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.update(f"{node.module}.{alias.name}" if node.module == "portbench" else node.module
                         for alias in node.names)
    return names


def test_the_judge_kinds_exist():
    assert {os.path.basename(p) for p in JUDGES} >= {"reference.py", "exact.py", "int8_scan.py", "int8_tier.py"}


@pytest.mark.parametrize("path", JUDGES, ids=lambda p: os.path.relpath(p, manifest.ROOT))
def test_reference_imports_nothing_of_the_program(path):
    """The reference and every judge kind import the standard typing, NumPy,
    PyTorch and, of the harness, only the reference and the manifest."""
    with open(path, encoding="utf-8") as f:
        names = imported_from(f.read())
    assert names <= {"__future__", "typing", "numpy", "torch", "portbench.reference", "portbench.manifest"}, names


@pytest.mark.parametrize("source, found", [
    ("import jax.numpy as jnp", {"jax"}),
    ("from photo_search_engine_tpu.core import x", {"photo_search_engine_tpu"}),
    ("from photo_search_engine_tpu_torch.core import x", {"photo_search_engine_tpu_torch"}),
    ("importlib.import_module('flax.linen')", {"flax"}),
])
def test_guard_compares_whole_names(source, found):
    assert imported(source) == found

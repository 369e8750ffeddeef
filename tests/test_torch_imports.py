"""The port imports nothing of JAX and nothing of the JAX package.

* A static check parses every ``.py`` file of ``photo_search_engine_tpu_torch/``,
  ``chip_smoke.py``, the helpers it imports (``tests/torch_parity.py``) and
  the port's scripts (``scripts/torch_*.py``), and fails on any import of
  ``jax``, ``jaxlib`` or
  ``photo_search_engine_tpu`` (the port's own package aside), imports
  inside functions included.
* The port keeps its own copy of each host module it needs from the JAX
  package.  Each copy must equal its JAX file once the package name in its
  import lines is mapped, so that the two do not drift apart.  A copy that
  is changed on purpose loses its case here, with the reason in CHANGES.md.
  ``core/batcher.py`` is not listed: it differs by more than its imports.
  ``scripts/torch_keyword_bench_1m.py`` is held to
  ``scripts/keyword_bench_1m.py`` the same way.
"""

import ast
import glob
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "photo_search_engine_tpu")
PORT_PKG = os.path.join(REPO, "photo_search_engine_tpu_torch")

_FORBIDDEN = ("jax", "jaxlib", "photo_search_engine_tpu")

COPIED = (
    "config.py",
    "utils/__init__.py",
    "utils/path_utils.py",
    "utils/image_parser.py",
    "services/llm_compat.py",
    "services/analysis.py",
    "services/time_parser.py",
    "services/query_formatter.py",
    "services/vision.py",
    "native/__init__.py",
    "native/loader.py",
    "native/src/bm25.cc",
    "native/src/ivf_layout.cc",
    "core/keyword_index.py",
    "core/es_keyword_index.py",
    "core/indexer.py",
    "core/searcher.py",
    "api/wsgi.py",
    "api/routes.py",
    "api/spa_contract.py",
    "tools/__init__.py",
    "tools/migrate.py",
    "templates/index.html",
)


def _port_sources():
    found = []
    for root, _, files in os.walk(PORT_PKG):
        if "_build" in root.split(os.sep) or "__pycache__" in root:
            continue
        found += [os.path.relpath(os.path.join(root, f), REPO) for f in files if f.endswith(".py")]
    scripts = [os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "scripts", "torch_*.py"))]
    # chip_smoke.py imports the shared checks of tests/torch_parity.py
    return sorted(found) + ["chip_smoke.py", os.path.join("tests", "torch_parity.py")] + sorted(scripts)


def forbidden_imports(source: str):
    """``(line, module)`` of every import of jax, jaxlib or the JAX package
    in ``source``, at any depth of the tree."""
    hits = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        hits += [(node.lineno, name) for name in names if name.split(".")[0] in _FORBIDDEN]
    return hits


@pytest.mark.parametrize("path", _port_sources())
def test_port_module_imports_no_jax(path):
    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        assert forbidden_imports(f.read()) == [], path


@pytest.mark.parametrize(
    "source",
    [
        "import jax",
        "import jax.numpy as jnp",
        "from jaxlib import xla_client",
        "def f():\n    from photo_search_engine_tpu.ops import topk\n",
        "class C:\n    def m(self):\n        import photo_search_engine_tpu.native\n",
        "from photo_search_engine_tpu import config",
    ],
)
def test_guard_finds_every_form_of_import(source):
    assert len(forbidden_imports(source)) == 1


def test_guard_passes_the_port_package():
    assert forbidden_imports("from photo_search_engine_tpu_torch.ops import topk\nimport torch\n") == []


def _map_package(text: str) -> str:
    """The JAX file's text with the package name of its import lines
    mapped to the port's."""
    return re.sub(r"(?m)^(\s*)(from|import) photo_search_engine_tpu([. ])",
                  r"\1\2 photo_search_engine_tpu_torch\3", text)


@pytest.mark.parametrize("path", COPIED)
def test_copied_module_matches_the_jax_file(path):
    with open(os.path.join(JAX_PKG, path), encoding="utf-8") as f:
        want = _map_package(f.read())
    with open(os.path.join(PORT_PKG, path), encoding="utf-8") as f:
        got = f.read()
    assert got == want, f"{path} drifted from photo_search_engine_tpu/{path}"


def test_keyword_bench_copy_matches_the_jax_script():
    with open(os.path.join(REPO, "scripts", "keyword_bench_1m.py"), encoding="utf-8") as f:
        want = _map_package(f.read())
    with open(os.path.join(REPO, "scripts", "torch_keyword_bench_1m.py"), encoding="utf-8") as f:
        assert f.read() == want, "scripts/torch_keyword_bench_1m.py drifted from scripts/keyword_bench_1m.py"


@pytest.mark.parametrize(
    "script",
    ["torch_load_test.py", "torch_bench.py", "torch_check_services.py", "torch_demo_e2e.py",
     "torch_keyword_bench_1m.py"],
)
def test_the_entry_point_scripts_are_among_the_checked_modules(script):
    assert os.path.join("scripts", script) in _port_sources()


@pytest.mark.parametrize(
    "module",
    ["parallel/__init__.py", "parallel/sharded.py", "parallel/sharded_ivf.py", "parallel/spmd_serving.py",
     "parallel/multihost.py", "core/mesh_store.py"],
)
def test_the_mesh_tier_is_among_the_checked_modules(module):
    assert os.path.join("photo_search_engine_tpu_torch", module) in _port_sources()

"""Shared pieces of the benchmark's CPU tests: a checkout copy with small
cells and configurations added as new files, and the shape of a result
line."""

import json
import os
import shutil

from portbench import manifest

TINY = {"rows": 8192, "dim": 64}
# a throwaway IVF configuration that probes every list, so that the exact kind
# judges it (VECTOR_INDEX_TYPE=ivf, IVF_NLIST=16, IVF_NPROBE=16)
IVF = {"index_type": "ivf", "ivf": {"nlist": 16, "nprobe": 16}}


def checkout_copy(tmp_path, extra_cells=()):
    """``BENCHMARK.json`` and ``portbench/`` copied under ``tmp_path``, with
    ``extra_cells`` (``(name, config, traffic dict)``) added: their mix as a
    new file and a manifest entry each."""
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(manifest.ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), root)
    for name, config, mix in extra_cells:
        add_cell(root, name, config, mix)
    return root


def add_cell(root, name, config, mix):
    """A cell ``name`` of ``config`` under ``mix`` in the checkout at
    ``root``: the mix as a new traffic file, a manifest entry, and every
    per-layer metric read in it."""
    with open(os.path.join(root, "portbench", "traffic", f"{mix['name']}.json"), "w") as f:
        json.dump(mix, f)
    book = manifest.load(root)
    book["workloads"].append({"name": name, "config": config, "traffic": mix["name"], "chips": 1, "why": "test"})
    for metric in book["per_layer"]:
        metric["workloads"].append(name)
    _save(root, book)


def add_config(root, name, **changes):
    """A new configuration file ``portbench/configs/<name>.json`` and its
    manifest entry in the checkout at ``root``: the benchmark's first
    configuration with ``changes``.  Returns the file's path in the
    checkout."""
    book = manifest.load(root)
    cfg = {**manifest.config(book, book["configs"][0]["name"], root), **changes, "name": name}
    path = f"portbench/configs/{name}.json"
    with open(os.path.join(root, path), "w") as f:
        json.dump(cfg, f)
    book["configs"].append({"name": name, "source": "test", "file": path, "reduced": [], "why": "test"})
    _save(root, book)
    return path


def _save(root, book):
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(book, f)


def small_mix(**changes):
    mix = manifest.traffic("image.r65")
    mix.update({"name": "image.test", "rate": 200, "workers": 16, "check_share": 1.0})
    mix.update(changes)
    return mix


def assert_result_shape(result, trace):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "compared"
    assert isinstance(result["correct"], bool)
    assert result["attempted"] > 0 and result["failed"] >= 0
    for name, metric in result["metrics"].items():
        assert set(metric) == {"value", "unit"}, name
    device = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(device)
    if trace and device["platform"] == "gpu":
        assert device["busy_s"] > 0 and device["window_s"] > 0
    for name, pair in result["compared"].items():
        assert set(pair) == {"value", "limit"}, name
    json.dumps(result, allow_nan=False)

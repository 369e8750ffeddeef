"""Shared pieces of the benchmark's CPU tests: a checkout copy with small
cells added as new files, and the shape of a result line."""

import json
import os
import shutil

from portbench import manifest

TINY = {"rows": 8192, "dim": 64}


def checkout_copy(tmp_path, extra_cells=()):
    """``BENCHMARK.json`` and ``portbench/`` copied under ``tmp_path``, with
    ``extra_cells`` (``(name, config, traffic dict)``) added: their mix as a
    new file and a manifest entry each."""
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(manifest.ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), root)
    book = manifest.load(root)
    for name, config, mix in extra_cells:
        with open(os.path.join(root, "portbench", "traffic", f"{mix['name']}.json"), "w") as f:
            json.dump(mix, f)
        book["workloads"].append({"name": name, "config": config, "traffic": mix["name"], "chips": 1, "why": "test"})
        for metric in book["per_layer"]:
            metric["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(book, f)
    return root


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

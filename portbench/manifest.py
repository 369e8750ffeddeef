"""Find what ``BENCHMARK.json`` names: each cell's configuration, traffic
mix, request shape, work count, judge kinds and per-layer metric readers,
every one a file of its own
looked up by its name, so that a new cell, mix or metric is a new file
and a new manifest entry, never an edit."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Any, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = "portbench"


def _read_json(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load(root: str = ROOT) -> Dict[str, Any]:
    """``BENCHMARK.json`` of the checkout at ``root``."""
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def cell(manifest: Dict[str, Any], name: str) -> Dict[str, Any]:
    for entry in manifest["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: Dict[str, Any], name: str, root: str = ROOT) -> Dict[str, Any]:
    """The configuration file of config ``name``, as it is run."""
    for entry in manifest["configs"]:
        if entry["name"] == name:
            return _read_json(os.path.join(root, entry["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, root: str = ROOT) -> Dict[str, Any]:
    """``portbench/traffic/<name>.json``: the parameters of one mix."""
    return _read_json(os.path.join(root, HERE, "traffic", f"{name}.json"))


def _module(path: str, label: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or spec.loader is None:
        raise ImportError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def work(name: str, root: str = ROOT) -> ModuleType:
    """``portbench/work/<name>.py``: ``work(batch, k, rows, dim)``."""
    return _module(os.path.join(root, HERE, "work", f"{name}.py"), f"portbench_work_{name}")


def request(name: str, root: str = ROOT) -> ModuleType:
    """``portbench/requests/<name>.py``: ``warm(...)`` and ``send(...)`` of
    one request shape."""
    return _module(os.path.join(root, HERE, "requests", f"{name}.py"), f"portbench_request_{name}")


def reader(name: str, root: str = ROOT) -> ModuleType:
    """``portbench/metrics/<name>.py``: ``read(run) -> float | None``."""
    return _module(os.path.join(root, HERE, "metrics", f"{name}.py"), f"portbench_metric_{name}")


def judge(name: str, root: str = ROOT) -> ModuleType:
    """``portbench/judges/<name>.py``: one kind of answer that a
    configuration's ``reference``, ``control`` or ``faults`` names:
    ``answer(...)`` and optionally ``numbers(...)`` (``reference.py``)."""
    return _module(os.path.join(root, HERE, "judges", f"{name}.py"), f"portbench_judge_{name}")


def metrics(manifest: Dict[str, Any], workload: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics a run of ``workload`` reports: its end-to-end ones with
    ``trace`` off, its per-layer ones with it on.  A metric without a
    ``workloads`` list belongs to every cell (a per-layer one: every cell
    that reports the end-to-end metric it moves)."""
    e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [
        m for m in manifest["per_layer"]
        if workload in m.get("workloads", [workload]) and m["moves"] in reported
    ]

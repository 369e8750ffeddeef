"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
resolves to its file."""

import json
import os
import re

import pytest

from portbench import manifest

BOOK = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BOOK["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BOOK) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BOOK["paths"] == ["portbench"]
    assert BOOK["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= BOOK["run_seconds"] <= 51
    assert 1 <= len(BOOK["configs"]) <= 24 and 1 <= len(BOOK["workloads"]) <= 24
    assert 1 <= len(BOOK["end_to_end"]) <= 16 and 1 <= len(BOOK["per_layer"]) <= 128
    assert len(json.dumps(BOOK)) < 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for group in ("configs", "workloads", "end_to_end", "per_layer") for x in BOOK[group]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for metric in BOOK["end_to_end"] + BOOK["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher"), metric
    for text in [c["why"] for c in BOOK["configs"]] + [w["why"] for w in BOOK["workloads"]] + \
            [c["source"] for c in BOOK["configs"]] + [m["layer"] for m in BOOK["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BOOK["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for metric in e2e.values():
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    entry = manifest.cell(BOOK, cell)
    assert entry["chips"] == 1 and set(entry) == {"name", "config", "traffic", "chips", "why"}
    cfg = manifest.config(BOOK, entry["config"])
    mix = manifest.traffic(entry["traffic"])
    assert mix["name"] == entry["traffic"] and cfg["name"] == entry["config"]
    assert callable(manifest.work(cfg["work"]).work)
    shape = manifest.request(mix["request"])
    assert callable(shape.warm) and callable(shape.send)
    reported = manifest.metrics(BOOK, cell, False)
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    layers = manifest.metrics(BOOK, cell, True)
    assert layers
    for metric in reported + layers:
        assert callable(manifest.reader(metric["name"]).read), metric["name"]


def test_per_layer_metrics():
    e2e = {m["name"] for m in BOOK["end_to_end"]}
    layers = {}
    for metric in BOOK["per_layer"]:
        assert metric["moves"] in e2e and metric["source"] in ("device_trace", "program_span", "program_counter",
                                                               "host_clock")
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(metric.get("workloads", [])) <= set(CELLS)
        layers.setdefault(metric["layer"], []).append(metric["name"])
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"
    assert len(layers) >= 4


@pytest.mark.parametrize("entry", BOOK["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    path = entry["file"]
    assert path.startswith("portbench/") and os.path.exists(os.path.join(manifest.ROOT, path))
    cfg = manifest.config(BOOK, entry["name"])
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["rows"] == 5_000_000 and cfg["dim"] == 1536 and cfg["metric"] == "cosine"
    assert set(cfg["limits"]) == {"regen_mismatch", "readback_err", "bad_hits", "dist_err", "rank_gap"}
    for spec in [cfg["reference"], cfg["control"], *cfg.get("faults", [])]:
        assert callable(manifest.judge(spec["kind"]).answer), spec

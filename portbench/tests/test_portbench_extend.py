"""A later change adds a configuration, a traffic mix and a request shape
as new files and manifest entries; the harness finds and runs them, and no
file that was there changes."""

import hashlib
import json
import os
import shutil

from portbench import manifest, run
from portbench.tests.helpers import checkout_copy, small_mix


def tree_digest(root):
    digest = {}
    for folder, _, files in os.walk(os.path.join(root, "portbench")):
        for name in files:
            path = os.path.join(folder, name)
            with open(path, "rb") as f:
                digest[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return digest


def test_new_config_mix_and_request_shape_as_files(tmp_path):
    root = checkout_copy(tmp_path)
    before = tree_digest(root)
    book = manifest.load(root)
    cfg = manifest.config(book, book["configs"][0]["name"], root)
    cfg.update({"name": "throwaway-flat", "rows": 4096, "dim": 32})
    cfg_file = "portbench/configs/throwaway-flat.json"
    with open(os.path.join(root, cfg_file), "w") as f:
        json.dump(cfg, f)
    shape = "portbench/requests/image_throwaway.py"
    shutil.copy(os.path.join(root, "portbench/requests/image.py"), os.path.join(root, shape))
    mix = small_mix(name="image.throwaway", rate=100, workers=4, request="image_throwaway")
    with open(os.path.join(root, "portbench", "traffic", "image.throwaway.json"), "w") as f:
        json.dump(mix, f)
    book["configs"].append({"name": "throwaway-flat", "source": "test", "file": cfg_file, "reduced": [],
                            "why": "test"})
    book["workloads"].append({"name": "throwaway.image", "config": "throwaway-flat",
                              "traffic": "image.throwaway", "chips": 1, "why": "test"})
    for metric in book["per_layer"]:
        metric["workloads"].append("throwaway.image")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(book, f)
    result = run.run_cell("throwaway.image", 7, 0.5, True, device="cpu", root=root, log=lambda s: None)
    assert result["correct"], result["compared"]
    assert {"batch_mean", "reconstruct_ms", "store_call_ms"} <= set(result["metrics"])
    after = tree_digest(root)
    assert {p: h for p, h in after.items() if p in before} == before
    assert set(after) - set(before) == {cfg_file, shape, "portbench/traffic/image.throwaway.json"}

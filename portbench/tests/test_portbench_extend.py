"""A later change adds a configuration, a traffic mix, a request shape and a
judge kind as new files and manifest entries; the harness finds and runs
them, and no file that was there changes.  A configuration's ``ivf`` block
reaches the index it builds."""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from portbench import corpus, manifest, run
from portbench.tests.helpers import IVF, TINY, add_cell, add_config, checkout_copy, small_mix

# a judge kind that only a file gives: the exact answer, and one number of its
# own beside the common four (the share of the exact top-k that a served list
# misses)
RECALL_KIND = '''
from portbench import reference


def answer(spec, corpus, queries, k):
    q_op = reference.operand(queries, corpus)
    scores, ids = reference.chunked_top(lambda a, b: q_op @ corpus[a:b].double().T, corpus.shape[0], k)
    return ids, scores


def numbers(spec, corpus, queries, served_ids, served_dists, k):
    ids, _ = answer(spec, corpus, queries, k)
    found = (ids[:, :, None] == served_ids[:, None, :]).any(dim=2)
    return {"recall_miss": float(1.0 - found.double().mean())}
'''


def tree_digest(root):
    digest = {}
    for folder, _, files in os.walk(os.path.join(root, "portbench")):
        for name in files:
            path = os.path.join(folder, name)
            with open(path, "rb") as f:
                digest[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return digest


def with_recall_kind(root):
    """The judge kind above as a new file; returns its path in the checkout."""
    path = "portbench/judges/exact_recall.py"
    with open(os.path.join(root, path), "w") as f:
        f.write(RECALL_KIND)
    return path


@pytest.mark.parametrize("recall_limit, correct", [(0.02, True), (-1.0, False)])
def test_new_config_mix_shape_and_judge_as_files(tmp_path, recall_limit, correct):
    root = checkout_copy(tmp_path)
    before = tree_digest(root)
    kind_file = with_recall_kind(root)
    book = manifest.load(root)
    limits = {**manifest.config(book, book["configs"][0]["name"], root)["limits"], "recall_miss": recall_limit}
    cfg_file = add_config(root, "throwaway-flat", rows=4096, dim=32, reference={"kind": "exact_recall"},
                          limits=limits)
    shape = "portbench/requests/image_throwaway.py"
    shutil.copy(os.path.join(root, "portbench/requests/image.py"), os.path.join(root, shape))
    add_cell(root, "throwaway.image", "throwaway-flat",
             small_mix(name="image.throwaway", rate=100, workers=4, request="image_throwaway"))
    result = run.run_cell("throwaway.image", 7, 0.5, True, device="cpu", root=root, log=lambda s: None)
    assert result["correct"] is correct, result["compared"]
    assert result["compared"]["recall_miss"]["limit"] == recall_limit
    assert {"batch_mean", "reconstruct_ms", "store_call_ms"} <= set(result["metrics"])
    after = tree_digest(root)
    assert {p: h for p, h in after.items() if p in before} == before
    assert set(after) - set(before) == {cfg_file, shape, kind_file, "portbench/traffic/image.throwaway.json"}


def test_an_ivf_config_as_a_file_runs_and_is_correct(tmp_path):
    root = checkout_copy(tmp_path)
    before = tree_digest(root)
    cfg_file = add_config(root, "throwaway-ivf", **IVF, **TINY)
    add_cell(root, "throwaway.ivf", "throwaway-ivf", small_mix(name="image.ivf", rate=100, workers=4))
    result = run.run_cell("throwaway.ivf", 7, 0.5, False, device="cpu", root=root, log=lambda s: None)
    assert result["correct"], result["compared"]
    after = tree_digest(root)
    assert {p: h for p, h in after.items() if p in before} == before
    assert set(after) - set(before) == {cfg_file, "portbench/traffic/image.ivf.json"}


@pytest.mark.parametrize("ivf", [{"nlist": 16, "nprobe": 2}, None])
def test_the_ivf_block_reaches_the_index(tmp_path, monkeypatch, ivf):
    """The block's keys reach ``VectorIndex``; a key left out keeps the
    app's default (``config.py``, with nothing set in the environment)."""
    from photo_search_engine_tpu_torch.config import load_config

    for name in ("IVF_NLIST", "IVF_NPROBE", "IVF_TARGET_RECALL"):
        monkeypatch.delenv(name, raising=False)
    app = load_config()
    root = checkout_copy(tmp_path)
    add_config(root, "throwaway-ivf", index_type="ivf", **TINY, **({"ivf": ivf} if ivf else {}))
    cfg = manifest.config(manifest.load(root), "throwaway-ivf", root)
    paths = corpus.library_paths(cfg["rows"])
    index, batcher, _ = run.build(cfg, 7, torch.device("cpu"), corpus.metadata(paths))
    try:
        expected = ivf or {"nlist": app["IVF_NLIST"], "nprobe": app["IVF_NPROBE"]}
        assert (index.ivf_nlist, index.ivf_nprobe) == (expected["nlist"], expected["nprobe"])
        assert index.ivf_target_recall == app["IVF_TARGET_RECALL"]
        if ivf:
            index.raw_search_batch(np.asarray(index.get_embedding_by_photo_path(paths[0]), np.float32), 10)
            assert index.last_route["impl"] == "ivf" and index.last_route["nprobe"] == ivf["nprobe"]
    finally:
        batcher.close()


def test_an_unknown_judge_kind_fails_before_the_run(tmp_path):
    root = checkout_copy(tmp_path)
    add_config(root, "throwaway-flat", reference={"kind": "no_such_kind"})
    add_cell(root, "throwaway.image", "throwaway-flat", small_mix())
    with pytest.raises(FileNotFoundError, match="judges/no_such_kind.py"):
        run.run_cell("throwaway.image", 7, 0.5, False, device="cpu", root=root, overrides=TINY,
                     log=lambda s: None)


def test_a_number_without_a_limit_fails(tmp_path):
    root = checkout_copy(tmp_path)
    with_recall_kind(root)
    add_config(root, "throwaway-flat", reference={"kind": "exact_recall"})
    add_cell(root, "throwaway.image", "throwaway-flat", small_mix())
    with pytest.raises(KeyError, match="recall_miss"):
        run.run_cell("throwaway.image", 7, 0.5, False, device="cpu", root=root, overrides=TINY,
                     log=lambda s: None)

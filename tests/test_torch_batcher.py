"""The port's micro-batcher against the JAX package's, over the port's index.

The cases of ``tests/test_batcher.py``: concurrent requests coalesce,
mixed k, errors reach every waiter, filtered and unfiltered requests
share grouped batches, more distinct predicates than ``mask_table_cap``,
a quantized index, and ``BatchedEmbeddingService`` over the port's hashing
embedder.  Each request's result is held against the JAX index serving
the same rows without a batcher, and the port's predicate table against
the JAX batcher's.  Last, the micro-batched filtered path runs in a
process where ``import jax`` fails."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from photo_search_engine_tpu.core.batcher import MicroBatcher as JaxMicroBatcher
from photo_search_engine_tpu.core.vector_index import VectorIndex as JaxIndex
from photo_search_engine_tpu_torch.core.batcher import (
    BatchedEmbeddingService,
    MicroBatcher,
    attach_microbatcher,
)
from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
from photo_search_engine_tpu_torch.models.hash_embedder import HashingEmbeddingService
from tests.torch_parity import unit_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 8
TIMEOUT = 60


def _run_threads(target, args_list):
    threads = [threading.Thread(target=target, args=args) for args in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)


def _indexes(tmp_path, n, seed, quantized=False):
    """The port's index with a micro-batcher, and the JAX index over the
    same rows without one (the reference for every request)."""
    rows = np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)
    metas = [{"photo_path": f"/p/{i}.jpg"} for i in range(n)]
    ours = VectorIndex(D, index_path=str(tmp_path / "p.index"), metadata_path=str(tmp_path / "p.json"),
                       metric="cosine", quantized=quantized)
    ref = JaxIndex(D, index_path=str(tmp_path / "j.index"), metadata_path=str(tmp_path / "j.json"),
                   metric="cosine", quantized=quantized)
    ours.add_batch(rows, metas)
    ref.add_batch(rows, metas)
    return rows, ours, ref


def _paths(hits):
    return [h["metadata"]["photo_path"] for h in hits]


def _exact_batch(corpus):
    def run_batch(queries, k):
        scores = queries @ corpus.T
        idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(scores, idx, axis=1), idx.astype(np.int32)

    return run_batch


def test_concurrent_requests_coalesce():
    corpus = unit_rows(np.random.default_rng(0), 50, D)
    calls = []
    exact = _exact_batch(corpus)

    def run_batch(queries, k):
        calls.append(queries.shape[0])
        return exact(queries, k)

    batcher = MicroBatcher(run_batch, max_batch=64, window_s=0.05)
    results = {}

    def worker(i):
        results[i] = int(batcher.search(corpus[i], 3)[1][0])

    _run_threads(worker, [(i,) for i in range(16)])
    batcher.close()
    assert results == {i: i for i in range(16)}
    assert len(calls) < 16 and sum(calls) == 16


def test_mixed_k_values():
    corpus = unit_rows(np.random.default_rng(1), 20, 4)
    batcher = MicroBatcher(_exact_batch(corpus), window_s=0.05)
    outs = {}

    def worker(i, k):
        dists, idx = batcher.search(corpus[i], k)
        outs[i] = (len(dists), int(idx[0]))

    _run_threads(worker, [(0, 2), (1, 5)])
    batcher.close()
    assert outs == {0: (2, 0), 1: (5, 1)}


def test_errors_propagate_to_every_waiter():
    def fail(*args):
        raise RuntimeError("device on fire")

    batcher = MicroBatcher(fail, run_grouped_batch=fail, window_s=0.05)
    errors = []

    def worker(i):
        try:
            batcher.search(np.zeros(4, np.float32), 2, mask=None if i % 2 else np.ones(10, bool))
        except RuntimeError as exc:
            errors.append(str(exc))

    _run_threads(worker, [(i,) for i in range(6)])
    batcher.close()
    assert errors == ["device on fire"] * 6
    with pytest.raises(ValueError, match="no grouped"):
        MicroBatcher(fail).search(np.zeros(4, np.float32), 2, mask=np.ones(10, bool))


def test_attach_to_vector_index(tmp_path):
    rows, index, ref = _indexes(tmp_path, 30, 2)
    batcher = attach_microbatcher(index, window_s=0.02)
    results = {}

    def worker(i):
        results[i] = index.search(rows[i].tolist(), 2)

    _run_threads(worker, [(i,) for i in range(8)])
    batcher.close()
    for i in range(8):
        assert _paths(results[i]) == _paths(ref.search(rows[i].tolist(), 2))
        assert _paths(results[i])[0] == f"/p/{i}.jpg"
    assert batcher.batches_run <= 8 and batcher.requests_served == 8
    assert index.last_route["impl"] == "exact"


@pytest.mark.parametrize("quantized", [False, True])
def test_mixed_filtered_and_unfiltered_batch(tmp_path, quantized):
    """Concurrent requests with different predicates share grouped scans
    (kernel 5, or kernel 6 on the int8 tier); each gets what the JAX index
    serves it alone."""
    rows, index, ref = _indexes(tmp_path, 40, 3, quantized=quantized)
    batcher = attach_microbatcher(index, window_s=0.1)
    even = np.arange(40) % 2 == 0
    low = np.arange(40) < 20
    masks = [None, even, low]
    results = {}

    def worker(i):
        mask = masks[i % 3]
        if mask is None:
            results[i] = index.search(rows[i].tolist(), 3)
        else:
            results[i] = index.search_masked(rows[i].tolist(), 3, mask)

    _run_threads(worker, [(i,) for i in range(9)])
    batcher.close()
    for i in range(9):
        mask = masks[i % 3]
        want = ref.search(rows[i].tolist(), 3) if mask is None else ref.search_masked(rows[i].tolist(), 3, mask)
        assert _paths(results[i]) == _paths(want), i
        np.testing.assert_allclose([h["distance"] for h in results[i]], [h["distance"] for h in want],
                                   rtol=0, atol=1e-5)
    assert batcher.grouped_batches_run >= 1 and batcher.batches_run < 9
    assert batcher.requests_served == 9


def test_many_distinct_predicates_bounded_table():
    """64 distinct predicates in one window: results stay right, and every
    grouped call sees a table within ``mask_table_cap``, on the {2, 4, 8}
    buckets."""
    corpus = unit_rows(np.random.default_rng(5), 128, D)
    tables = []

    def run_grouped(queries, k, table, ids):
        tables.append(table.shape[0])
        scores = np.where(table[ids] > 0, queries @ corpus.T, -np.inf)
        idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(scores, idx, axis=1), idx.astype(np.int32)

    batcher = MicroBatcher(_exact_batch(corpus), run_grouped_batch=run_grouped, max_batch=64,
                           window_s=0.2, pipeline=1)
    results = {}

    def worker(i):
        results[i] = sorted(batcher.search(corpus[i], 2, mask=(np.arange(128) % 64) == i)[1].tolist())

    _run_threads(worker, [(i,) for i in range(64)])
    batcher.close()
    assert results == {i: [i, i + 64] for i in range(64)}
    assert tables and max(tables) <= MicroBatcher.mask_table_cap and set(tables) <= {2, 4, 8}


@pytest.mark.parametrize("n_masks", [0, 1, 2, 3, 6, 7])
def test_factor_masks_matches_jax(n_masks):
    rng = np.random.default_rng(n_masks)
    distinct = [rng.random(50) > 0.5 for _ in range(n_masks)]
    batch = []
    for i in range(12):
        mask = None if not distinct or i % 4 == 0 else distinct[i % len(distinct)]
        batch.append(type("Pending", (), {"mask": None if mask is None else np.asarray(mask)})())
    if all(item.mask is None for item in batch):
        batch[1].mask = np.asarray(rng.random(50) > 0.5)
    keys = JaxMicroBatcher._mask_keys(batch)
    got, ref = MicroBatcher._factor_masks(batch, keys), JaxMicroBatcher._factor_masks(batch, keys)
    assert got[0].dtype == ref[0].dtype and got[1].dtype == ref[1].dtype
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_quantized_index_grouped_batch(tmp_path):
    rows, index, ref = _indexes(tmp_path, 30, 4, quantized=True)
    batcher = attach_microbatcher(index, window_s=0.02)
    mask = np.arange(30) < 10
    hits = index.search_masked(rows[0].tolist(), 3, mask)
    batcher.close()
    assert _paths(hits) == _paths(ref.search_masked(rows[0].tolist(), 3, mask))
    assert _paths(hits)[0] == "/p/0.jpg" and index.last_route["impl"] == "int8_grouped"


def test_l2_index_keeps_the_direct_masked_path(tmp_path):
    rows = unit_rows(np.random.default_rng(6), 20, D)
    index = VectorIndex(D, index_path=str(tmp_path / "l.index"), metadata_path=str(tmp_path / "l.json"),
                        metric="l2")
    index.add_batch(rows, [{"photo_path": f"/p/{i}.jpg"} for i in range(20)])
    direct = index.search_masked
    batcher = attach_microbatcher(index, window_s=0.01)
    assert index.search_masked == direct  # the grouped kernels are inner product only
    assert _paths(index.search(rows[3].tolist(), 1)) == ["/p/3.jpg"]
    batcher.close()


def test_batched_embedding_service_under_concurrency():
    inner = HashingEmbeddingService(dimension=32)
    calls = {"n": 0}
    real_batch = inner.generate_embedding_batch

    def counting_batch(texts):
        calls["n"] += 1
        return real_batch(texts)

    inner.generate_embedding_batch = counting_batch
    wrapped = BatchedEmbeddingService(inner, window_s=0.05)
    texts = [f"海边 日落 {i % 4}" for i in range(16)]
    expected = {t: inner.generate_embedding(t) for t in set(texts)}
    got = {}
    lock = threading.Lock()

    def worker(text):
        vec = wrapped.generate_embedding(text)
        with lock:
            got[text] = vec

    _run_threads(worker, [(t,) for t in texts])
    wrapped._batcher.close()
    assert got == expected and calls["n"] < 16
    with pytest.raises(ValueError):
        wrapped.generate_embedding("   ")
    assert wrapped.dimension == 32


_JAX_BLOCKED = r"""
import json, os, sys, threading
sys.modules["jax"] = None  # any import of jax now fails
sys.path.insert(0, os.environ["REPO"])
import numpy as np
from photo_search_engine_tpu_torch.core.batcher import attach_microbatcher
from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
rows = np.random.default_rng(0).normal(size=(64, 16)).astype(np.float32)
index = VectorIndex(16, index_path=os.path.join(os.environ["TMP"], "i.index"),
                    metadata_path=os.path.join(os.environ["TMP"], "m.json"), quantized=True)
index.add_batch(rows, [{"photo_path": f"/p/{i}.jpg"} for i in range(64)])
batcher = attach_microbatcher(index, window_s=0.1)
masks = [None, np.arange(64) % 2 == 0, np.arange(64) < 20]
out = {}
def worker(i):
    mask = masks[i % 3]
    hits = index.search(rows[i], 3) if mask is None else index.search_masked(rows[i], 3, mask)
    out[i] = [int(h["metadata"]["photo_path"][3:-4]) for h in hits]
threads = [threading.Thread(target=worker, args=(i,)) for i in range(9)]
for t in threads:
    t.start()
for t in threads:
    t.join(60)
batcher.close()
worker_thread = batcher._worker
if worker_thread is not None:  # let it leave torch before the interpreter exits
    worker_thread.join(60)
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
print(json.dumps({"out": out, "loaded": loaded, "grouped": batcher.grouped_batches_run}))
"""


def test_filtered_path_serves_with_jax_absent(tmp_path):
    env = dict(os.environ, REPO=REPO, TMP=str(tmp_path))
    done = subprocess.run([sys.executable, "-c", _JAX_BLOCKED], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["loaded"] == ["jax"] and result["grouped"] >= 1  # only the blocking None entry
    for i, hits in result["out"].items():
        i = int(i)
        assert len(hits) == 3
        if i % 3 == 1:
            assert all(h % 2 == 0 for h in hits)
        elif i % 3 == 2:
            assert all(h < 20 for h in hits)
        else:
            assert hits[0] == i

"""The port's IVF deployment as the app serves it (``VectorIndex(index_type=
"ivf")`` behind the micro-batcher) over rows installed on the device, on
the CPU at 8192 × 64 with nlist 64 and nprobe 8, float32 and bfloat16 rows:

* ``IVFIndex.build_on_device`` and ``IVFIndex.build`` give the same
  centroids, ``perm``, capacity and answers;
* after ``load_device_rows`` the index builds from the store's own rows:
  no ``snapshot()``, no host mirror, the layout of ``IVFIndex.build``;
* the served lists are ``probed_topk`` (the benchmark's IVF judge) on the
  index's own state: the same ids, distances within 2e-4;
* the live count is kept, not recounted over ``perm``, and stays equal to
  ``(perm >= 0).sum()`` across builds and appends, a refused one included;
* ``ivf.search`` and ``ivf.scan`` are recorded, with what kernel 7 had to
  do for the scan, only while a profiler session records;
* ``EmbeddingStore.snapshot_range`` without a mirror reads only its range.
"""

import numpy as np
import pytest
import torch

from photo_search_engine_tpu_torch import tracing
from photo_search_engine_tpu_torch.core.batcher import attach_microbatcher
from photo_search_engine_tpu_torch.core.embedding_store import EmbeddingStore
from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
from photo_search_engine_tpu_torch.models.ivf import IVFIndex
from portbench import corpus, manifest, reference

N, D, NLIST, NPROBE, K = 8192, 64, 64, 8, 20
DTYPES = ["float32", "bfloat16"]
SEED = 2 ** 31 + 1818
PROBED_TOPK = manifest.judge("ivf_recall").probed_topk


def _rows(dtype):
    """The benchmark's library at 8192 × 64 (unit rows in bursts of
    near-duplicates), in ``dtype`` on the CPU."""
    cfg = {"rows": N, "dim": D, "corpus": {"intrinsic": 16, "burst": 4, "scene_noise": 0.5, "shot_noise": 0.2}}
    return corpus.make_rows(cfg, SEED, torch.device("cpu"), getattr(torch, dtype))


def _index(tmp_path, rows, nprobe=NPROBE):
    index = VectorIndex(D, index_path=str(tmp_path / "i.index"), metadata_path=str(tmp_path / "i.json"),
                        metric="cosine", index_type="ivf", store_dtype=str(rows.dtype).replace("torch.", ""),
                        ivf_nlist=NLIST, ivf_nprobe=nprobe, device="cpu")
    index.load_device_rows(rows, corpus.metadata(corpus.library_paths(rows.shape[0])))
    return index


def _queries(rows, count=24):
    picked = np.random.default_rng(5).choice(N, count, replace=False)
    return picked, reference.normalize_queries(rows[torch.from_numpy(picked)].float().numpy())


@pytest.mark.parametrize("dtype", DTYPES)
def test_build_on_device_equals_build(dtype):
    rows = _rows(dtype)
    host = IVFIndex.build(rows.float().numpy(), NLIST, store_dtype=dtype, device="cpu")
    dev = IVFIndex.build_on_device(rows, NLIST)
    np.testing.assert_array_equal(dev.centroids, host.centroids)
    np.testing.assert_array_equal(dev.perm, host.perm)
    assert dev.capacity == host.capacity and dev._corpus.dtype == host._corpus.dtype == rows.dtype
    assert torch.equal(dev._corpus, host._corpus)
    _, queries = _queries(rows)
    for got, want in zip(dev.search(queries, K, nprobe=NPROBE), host.search(queries, K, nprobe=NPROBE)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nprobe", [NPROBE, 0], ids=["fixed", "autotuned"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_installed_rows_build_without_a_host_copy(tmp_path, monkeypatch, dtype, nprobe):
    rows = _rows(dtype)
    index = _index(tmp_path, rows, nprobe)

    def refuse(self):
        raise AssertionError("the IVF build copied the store to the host")

    monkeypatch.setattr(EmbeddingStore, "snapshot", refuse)
    _, queries = _queries(rows, 2)
    index.raw_search_batch(queries, K)
    assert index.last_route["impl"] == "ivf" and index._store._host_cache is None
    assert index._ivf._corpus.dtype == rows.dtype
    if nprobe:
        host = IVFIndex.build(rows.float().numpy(), NLIST, store_dtype=dtype, device="cpu")
        np.testing.assert_array_equal(index._ivf.perm, host.perm)
        np.testing.assert_array_equal(index._ivf.centroids, host.centroids)
    else:
        assert index.describe()["ivf_autotune"]["sample_size"] == 128


@pytest.mark.parametrize("dtype", DTYPES)
def test_served_lists_are_the_probed_top_k(tmp_path, dtype):
    rows = _rows(dtype)
    index = _index(tmp_path, rows)
    batcher = attach_microbatcher(index)
    paths = corpus.library_paths(N)
    picked, queries = _queries(rows)
    try:
        hits = [index.search(index.get_embedding_by_photo_path(paths[r]), K) for r in picked]
    finally:
        batcher.close()
    ivf = index._ivf
    ids, scores = PROBED_TOPK(rows, queries, ivf.centroids, ivf.perm, ivf.capacity, NPROBE, K)
    served = np.array([[corpus.row_of(h["metadata"]["photo_path"]) for h in row] for row in hits])
    np.testing.assert_array_equal(served, ids.numpy())
    np.testing.assert_allclose([[h["distance"] for h in row] for row in hits], scores.numpy(), rtol=0, atol=2e-4)


def test_live_count_is_kept_across_builds_and_appends(tmp_path):
    rows = _rows("float32")
    index = _index(tmp_path, rows[: N // 2].clone())
    index.raw_search_batch(rows[0].numpy(), K)
    ivf = index._ivf
    assert ivf.live_count == int((ivf.perm >= 0).sum()) == N // 2
    index.add_batch(rows[N // 2: N // 2 + 100].numpy(), [{"photo_path": f"/new/{i}.jpg"} for i in range(100)])
    index.raw_search_batch(rows[0].numpy(), K)
    assert index._ivf is ivf and ivf.live_count == int((ivf.perm >= 0).sum()) == N // 2 + 100
    free = ivf.nlist * ivf.capacity - ivf.live_count
    fill, perm = ivf._fill.copy(), ivf.perm.copy()
    assert not ivf.append(np.zeros((free + 1, D), np.float32), np.arange(free + 1))  # refused: the layout is full
    np.testing.assert_array_equal(ivf._fill, fill)
    np.testing.assert_array_equal(ivf.perm, perm)
    assert ivf.live_count == int((ivf.perm >= 0).sum())


def test_spans_are_recorded_only_while_tracing(tmp_path):
    rows = _rows("bfloat16")
    index = _index(tmp_path, rows)
    _, queries = _queries(rows, 3)
    tracing.clear()
    index.raw_search_batch(queries, K)
    assert tracing.spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        index.raw_search_batch(queries, K)
    spans = {s[0]: s for s in tracing.spans()}
    tracing.clear()
    assert set(spans) == {"ivf.search", "ivf.scan"}
    search, scan = spans["ivf.search"], spans["ivf.scan"]
    assert scan[2] == search[1] and search[5] <= scan[5] <= scan[6] <= search[6]
    ivf = index._ivf
    probes = ivf._probe(torch.from_numpy(queries).to(ivf._corpus.dtype), NPROBE).long().numpy()
    fill = (ivf.perm.reshape(NLIST, ivf.capacity) >= 0).sum(axis=1)
    assert scan[7] == {
        "queries": 3, "k": K, "lrows": ivf.capacity, "dim": D,
        "lists": len(np.unique(probes)), "list_rows": int(fill[np.unique(probes)].sum()),
        "pair_rows": int(fill[probes].sum()), "masked": False, "graph": False,
    }


def test_snapshot_range_reads_only_its_range():
    rows = _rows("bfloat16")
    store = EmbeddingStore(D, device="cpu", store_dtype="bfloat16")
    store.load_device_rows(rows)
    got = store.snapshot_range(100, 164)
    assert store._host_cache is None  # the mirror was not downloaded
    np.testing.assert_array_equal(got, rows[100:164].float().numpy())
    assert store.snapshot_range(N - 5, N + 5).shape == (5, D)
    assert store.live_rows().data_ptr() == rows.data_ptr() and store.live_rows().shape == (N, D)

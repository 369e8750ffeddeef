"""The port's mesh serving tier against the JAX package's, the JAX side on
its 8-device CPU mesh and the port on CPU shards:

* ``MeshEmbeddingStore`` (8 shards): the same hits as the JAX store for
  search, masked, grouped (f32 and int8; l2 as per-query masked scans),
  insertion-order snapshots, reconstruct and incremental appends;
* ``VectorIndex(mesh_devices=4)``, flat, int8 and IVF: ``search_batch``,
  ``search_masked`` and the grouped batch give the JAX index's hits and
  ``last_route``; the IVF sidecar says ``"kind": "mesh"`` and loads in
  both packages without retraining; a mesh checkpoint loads into a
  single-device index.

Values within 1e-5 (cosine rows), or 1e-6 relative (l2 distances of the
store's unit-normal rows); the index's clustered rows are longer, and
their l2 distances are differences of terms of size ``‖q‖²`` summed in
another order: within 2e-6 of the largest ``‖q‖²`` there."""

import json

import numpy as np
import pytest

from photo_search_engine_tpu.core.mesh_store import MeshEmbeddingStore as JaxMeshStore
from photo_search_engine_tpu.core.vector_index import VectorIndex as JaxIndex
from photo_search_engine_tpu_torch.core.embedding_store import EmbeddingStore
from photo_search_engine_tpu_torch.core.mesh_store import MeshEmbeddingStore, MeshIVFAdapter
from photo_search_engine_tpu_torch.core.vector_index import VectorIndex

D = 24


def _stores(metric="cosine", quantized=False, rows=100):
    rng = np.random.default_rng(0)
    vectors = rng.normal(size=(rows, D)).astype(np.float32)
    j = JaxMeshStore(D, metric=metric, mesh_devices=8, quantized=quantized)
    p = MeshEmbeddingStore(D, metric=metric, mesh_devices=8, quantized=quantized, device="cpu")
    j.append(vectors[:37])
    p.append(vectors[:37])
    j.search(vectors[:1], 1)
    p.search(vectors[:1], 1)
    j.append(vectors[37:])
    p.append(vectors[37:])
    return j, p, vectors, rng


def _same(jax_out, port_out, rtol=0.0):
    jv, ji = (np.asarray(a) for a in jax_out)
    pv, pi = port_out
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=rtol, atol=1e-5)


def test_mesh_store_is_eight_cpu_shards():
    _, p, _, _ = _stores()
    assert p.n_shards == 8 and p.count == 100 and p.mesh.devices[0].type == "cpu"


@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
@pytest.mark.parametrize("k", [1, 7, 100])
def test_search_and_masked_search_match_jax(metric, k):
    j, p, _, rng = _stores(metric)
    q = rng.normal(size=(5, D)).astype(np.float32)
    rtol = 1e-6 if metric == "l2" else 0.0
    _same(j.search(q, k), p.search(q, k), rtol)
    mask = (rng.random(100) < 0.3).astype(np.int32)
    _same(j.search(q, k, mask=mask), p.search(q, k, mask=mask), rtol)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("quantized", [False, True])
def test_grouped_search_matches_jax(metric, quantized):
    j, p, _, rng = _stores(metric, quantized)
    q = rng.normal(size=(5, D)).astype(np.float32)
    table = (rng.random((3, 100)) < 0.5).astype(np.int8)
    ids = np.array([0, 1, 2, 0, 1], np.int32)
    impl = "int8" if quantized and metric != "l2" else "auto"
    _same(j.grouped_search(q, 6, table, ids, impl=impl), p.grouped_search(q, 6, table, ids, impl=impl),
          1e-6 if metric == "l2" else 0.0)


def test_int8_search_matches_jax_and_needs_a_quantized_store():
    j, p, _, rng = _stores(quantized=True)
    q = rng.normal(size=(5, D)).astype(np.float32)
    mask = (rng.random(100) < 0.5).astype(np.int32)
    _same(j.search(q, 9, impl="int8"), p.search(q, 9, impl="int8"))
    _same(j.search(q, 9, impl="int8", mask=mask), p.search(q, 9, impl="int8", mask=mask))
    _, plain, _, _ = _stores()
    with pytest.raises(ValueError, match="quantized"):
        plain.grouped_search(q, 3, np.ones((1, 100), np.int8), np.zeros(5, np.int32), impl="int8")


def test_snapshots_reconstruct_and_appends_in_insertion_order():
    j, p, vectors, rng = _stores()
    np.testing.assert_array_equal(p.snapshot(), np.asarray(j.snapshot()))
    np.testing.assert_array_equal(p.snapshot_range(40, 60), np.asarray(j.snapshot_range(40, 60)))
    np.testing.assert_array_equal(p.reconstruct(63), j.reconstruct(63))
    extra = rng.normal(size=(5, D)).astype(np.float32)
    j.append(extra)
    p.append(extra)
    _same(j.search(extra, 1), p.search(extra, 1))
    assert p.search(extra, 1)[1][:, 0].tolist() == list(range(100, 105))
    with pytest.raises(IndexError):
        p.reconstruct(105)
    p.clear()
    assert p.count == 0 and p.search(extra, 3)[1].shape == (5, 0)
    single = EmbeddingStore.from_array(vectors, device="cpu")
    from_array = MeshEmbeddingStore.from_array(vectors, mesh_devices=3, device="cpu")
    np.testing.assert_array_equal(from_array.search(vectors[:4], 5)[1], single.search(vectors[:4], 5)[1])


def test_layout_masks_are_cached_by_content():
    _, p, _, rng = _stores()
    mask = (rng.random(100) < 0.5).astype(np.int32)
    first = p._layout_mask(mask)
    assert p._layout_mask(mask.copy()) is first and len(p._masks) == 1


def _paths(tmp_path, name):
    return dict(index_path=str(tmp_path / f"{name}.index"), metadata_path=str(tmp_path / f"{name}-meta.json"))


def _metas(start, n):
    return [{"photo_path": f"/photos/{start + i}.jpg"} for i in range(n)]


def _indexes(tmp_path, metric="cosine", **kwargs):
    """The JAX and the port index on a 4-shard mesh, the same 150 rows
    added in two batches."""
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(6, D)).astype(np.float32) * 3
    rows = (centers[rng.integers(0, 6, 150)] + 0.3 * rng.normal(size=(150, D))).astype(np.float32)
    j = JaxIndex(D, metric=metric, mesh_devices=4, **_paths(tmp_path, "jax"), **kwargs)
    p = VectorIndex(D, metric=metric, mesh_devices=4, **_paths(tmp_path, "port"), device="cpu", **kwargs)
    for index in (j, p):
        index.add_batch(rows[:90], _metas(0, 90))
        index.add_batch(rows[90:], _metas(90, 60))
    queries = (centers[rng.integers(0, 6, 4)] + 0.3 * rng.normal(size=(4, D))).astype(np.float32)
    return j, p, rows, queries, rng


def _hits(results):
    return [[h["metadata"]["photo_path"] for h in row] for row in results]


def _dists(results):
    return [[h["distance"] for h in row] for row in results]


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("kwargs", [{}, {"quantized": True}, {"index_type": "ivf", "ivf_nlist": 6, "ivf_nprobe": 2},
                                    {"index_type": "ivf", "ivf_nlist": 6, "ivf_nprobe": 0}],
                         ids=["flat", "int8", "ivf", "ivf_autotuned"])
def test_vector_index_on_a_mesh_matches_jax(tmp_path, metric, kwargs):
    j, p, rows, queries, rng = _indexes(tmp_path, metric, **kwargs)
    assert type(p._store).__name__ == "MeshEmbeddingStore" and p._store.n_shards == 4
    atol = max(1e-5, 2e-6 * float(np.square(queries).sum(axis=1).max())) if metric == "l2" else 1e-5
    # the first search builds the IVF; the JAX index reports the nprobe it had
    # before an autotuned build, the port the one it searched with
    j.search_batch(queries[:1], 1)
    p.search_batch(queries[:1], 1)
    for k in (1, 10, 40):
        a, b = j.search_batch(queries, k), p.search_batch(queries, k)
        assert _hits(b) == _hits(a)
        for row_b, row_a in zip(_dists(b), _dists(a)):  # rows may hold fewer than k probed hits
            np.testing.assert_allclose(row_b, row_a, rtol=0, atol=atol)
        assert p.last_route == j.last_route and p.last_route["mesh_devices"] == 4
    mask = rng.random(150) < 0.4
    a, b = j.search_masked(queries[0], 8, mask), p.search_masked(queries[0], 8, mask)
    assert _hits([b]) == _hits([a]) and p.last_route == j.last_route
    table = np.stack([mask, ~mask, np.ones(150, bool)])
    ids = np.array([0, 1, 2, 0])
    da, ia = j.raw_grouped_search_batch(queries, 7, table, ids)
    db, ib = p.raw_grouped_search_batch(queries, 7, table, ids)
    np.testing.assert_array_equal(ib, np.asarray(ia))
    np.testing.assert_allclose(db, np.asarray(da), rtol=0, atol=atol)
    assert p.describe()["mesh_devices"] == 4


def test_mesh_ivf_is_built_on_the_mesh(tmp_path):
    _, p, _, queries, _ = _indexes(tmp_path, index_type="ivf", ivf_nlist=6, ivf_nprobe=2)
    p.search_batch(queries, 5)
    assert isinstance(p._ivf, MeshIVFAdapter) and p._ivf._index.n_shards == 4
    assert p.last_route == {"impl": "ivf", "nprobe": 2, "mesh_devices": 4}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mesh_ivf_sidecar_loads_in_both_packages(tmp_path, writer, monkeypatch):
    j, p, rows, queries, _ = _indexes(tmp_path, index_type="ivf", ivf_nlist=6, ivf_nprobe=2)
    source = j if writer == "jax" else p
    source.search_batch(queries, 5)  # builds the IVF
    source.save()
    with np.load(source.ivf_sidecar_path) as payload:
        meta = json.loads(str(payload["__meta__"]))
    assert meta["kind"] == "mesh" and meta["mesh_devices"] == 4
    paths = dict(index_path=source.index_path, metadata_path=source.metadata_path)
    restored = [JaxIndex(D, mesh_devices=4, index_type="ivf", ivf_nlist=6, ivf_nprobe=2, **paths),
                VectorIndex(D, mesh_devices=4, index_type="ivf", ivf_nlist=6, ivf_nprobe=2, device="cpu", **paths)]
    built = []
    monkeypatch.setattr(MeshIVFAdapter, "__init__", lambda *a, **k: built.append(a))  # restoring must not train
    for index in restored:
        assert index.load() and index._ivf is not None
    assert built == []
    assert _hits(restored[1].search_batch(queries, 5)) == _hits(restored[0].search_batch(queries, 5))
    assert _hits(restored[1].search_batch(queries, 5)) == _hits(source.search_batch(queries, 5))


def test_a_sidecar_of_another_mesh_width_is_rebuilt(tmp_path):
    _, p, _, queries, _ = _indexes(tmp_path, index_type="ivf", ivf_nlist=6, ivf_nprobe=2)
    p.search_batch(queries, 5)
    p.save()
    paths = dict(index_path=p.index_path, metadata_path=p.metadata_path)
    for other in (0, 2):
        index = VectorIndex(D, mesh_devices=other, index_type="ivf", ivf_nlist=6, ivf_nprobe=2, device="cpu", **paths)
        assert index.load() and index._ivf is None  # the sidecar is ignored, the IVF rebuilds lazily
        assert _hits(index.search_batch(queries, 5))


def test_mesh_checkpoints_load_into_a_single_device_index_and_back(tmp_path):
    _, p, rows, queries, _ = _indexes(tmp_path)
    p.save()
    paths = dict(index_path=p.index_path, metadata_path=p.metadata_path)
    flat = VectorIndex(D, device="cpu", **paths)
    mesh = VectorIndex(D, mesh_devices=8, device="cpu", **paths)
    assert flat.load() and mesh.load()
    assert _hits(flat.search_batch(queries, 6)) == _hits(p.search_batch(queries, 6))
    assert _hits(mesh.search_batch(queries, 6)) == _hits(p.search_batch(queries, 6))
    np.testing.assert_array_equal(mesh.get_embedding_by_photo_path("/photos/33.jpg"),
                                  flat.get_embedding_by_photo_path("/photos/33.jpg"))


def test_translation_passes_unknown_ids_as_minus_one():
    _, p, _, _ = _stores()
    stride = 1 << 40
    ids = np.array([[-1, int(p._ids[17]), 99 * stride, 3 * stride + 10_000], [int(p._ids[0]), -1, -1, -1]])
    assert p._translate(ids).tolist() == [[-1, 17, -1, -1], [0, -1, -1, -1]]
    p.append(np.ones((1, D), np.float32))  # an append rebuilds the table
    assert p._translate(np.array([p._ids[-1]])).tolist() == [100]

"""The port's flat VectorIndex against the JAX package's: checkpoints load
across the two packages in both directions (base snapshot plus committed
segments) and search the same afterwards; out-of-range row ids raise; rows
installed in memory serve as rows added through ``add_batch`` do; with no
device given, the index takes the one ``PSE_PLATFORM`` names, the card when
it is unset."""

import os

import numpy as np
import pytest
import torch

from photo_search_engine_tpu.core.vector_index import VectorIndex as JaxIndex
from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
from tests.torch_parity import unit_rows

D = 48


def _paths(tmp_path, name):
    return dict(index_path=str(tmp_path / f"{name}.index"), metadata_path=str(tmp_path / f"{name}-meta.json"))


def _on_host(cls):
    """The port's index is asked for the CPU; the JAX one takes no device."""
    return {"device": "cpu"} if cls is VectorIndex else {}


def _metas(start, n):
    return [{"photo_path": f"/photos/{start + i}.jpg", "description": f"row {start + i}"} for i in range(n)]


def _fill(index, rng, with_segments):
    """Base save of 300 rows, then two committed segments of 40 and 25."""
    index.add_batch(unit_rows(rng, 300, D), _metas(0, 300))
    index.save()
    if with_segments:
        index.add_batch(unit_rows(rng, 40, D), _metas(300, 40))
        index.save_incremental()
        index.add_item(unit_rows(rng, 1, D)[0].tolist(), _metas(340, 1)[0])
        index.add_batch(unit_rows(rng, 24, D), _metas(341, 24))
        index.save_incremental()


def _assert_same_search(a, b, queries, mask):
    for k in (1, 10, 70):
        ra, rb = a.search_batch(queries, k), b.search_batch(queries, k)
        assert [[h["metadata"] for h in row] for row in ra] == [[h["metadata"] for h in row] for row in rb]
        np.testing.assert_allclose(
            [[h["distance"] for h in row] for row in ra], [[h["distance"] for h in row] for row in rb], atol=1e-6
        )
    ma, mb = a.search_masked(queries[0], 5, mask), b.search_masked(queries[0], 5, mask)
    assert [h["metadata"] for h in ma] == [h["metadata"] for h in mb]
    da, ia = a.raw_search_batch(queries, 12)
    db, ib = b.raw_search_batch(queries, 12)
    np.testing.assert_array_equal(ia, ib)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("with_segments", [False, True])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_load_across_packages(tmp_path, metric, with_segments, direction):
    rng = np.random.default_rng(3)
    writer_cls, reader_cls = (JaxIndex, VectorIndex) if direction == "jax_to_port" else (VectorIndex, JaxIndex)
    writer = writer_cls(D, metric=metric, **_paths(tmp_path, "idx"), **_on_host(writer_cls))
    _fill(writer, rng, with_segments)
    assert os.path.isdir(tmp_path / "idx.index.segments") == with_segments
    reader = reader_cls(None, metric=metric, **_paths(tmp_path, "idx"), **_on_host(reader_cls))
    assert reader.load() is True
    assert reader.get_total_items() == writer.get_total_items() == (365 if with_segments else 300)
    assert reader.metadata == writer.metadata and reader.dimension == D
    # cosine rows are normalized again on load, in either package: one ulp
    np.testing.assert_allclose(reader._store.snapshot(), writer._store.snapshot(), rtol=0, atol=1e-7)
    assert reader.has_photo_path("/photos/299.jpg")
    np.testing.assert_allclose(
        reader.get_embedding_by_photo_path("/photos/7.jpg"),
        writer.get_embedding_by_photo_path("/photos/7.jpg"), rtol=0, atol=1e-7,
    )
    queries = unit_rows(rng, 4, D)
    mask = rng.random(reader.get_total_items()) > 0.5
    _assert_same_search(reader, writer, queries, mask)
    # the reader keeps writing segments the writer's package can load back
    reader.add_batch(unit_rows(rng, 5, D), _metas(1000, 5))
    reader.save_incremental()
    again = writer_cls(None, metric=metric, **_paths(tmp_path, "idx"), **_on_host(writer_cls))
    assert again.load() and again.get_total_items() == reader.get_total_items()
    _assert_same_search(again, reader, queries, None)


def test_load_validates_sidecar(tmp_path):
    index = VectorIndex(D, metric="cosine", **_paths(tmp_path, "v"), device="cpu")
    assert index.load() is False
    _fill(index, np.random.default_rng(0), False)
    other = VectorIndex(None, metric="l2", **_paths(tmp_path, "v"), device="cpu")
    with pytest.raises(ValueError, match="metric"):
        other.load()
    os.remove(tmp_path / "v.index.meta.json")
    with pytest.raises(ValueError, match="sidecar"):
        VectorIndex(None, metric="cosine", **_paths(tmp_path, "v"), device="cpu").load()


def test_out_of_range_row_ids_raise(tmp_path):
    index = VectorIndex(D, **_paths(tmp_path, "b"), device="cpu")
    index.add_batch(unit_rows(np.random.default_rng(0), 20, D), _metas(0, 20))
    index._store.search = lambda q, k, **kw: (np.zeros((1, k), np.float32), np.full((1, k), 20, np.int32))
    with pytest.raises(RuntimeError, match="out-of-range"):
        index.raw_search_batch(np.ones((1, D), np.float32), 3)
    index._store.search = lambda q, k, **kw: (np.zeros((1, k), np.float32), np.full((1, k), -2, np.int32))
    with pytest.raises(RuntimeError, match="out-of-range"):
        index.search(np.ones(D, np.float32), 3)


def test_routes_and_unported_configurations(tmp_path):
    index = VectorIndex(D, quantized=True, **_paths(tmp_path, "r"), device="cpu")
    assert index.search_batch(np.ones((2, D), np.float32), 3) == [[], []]
    index.add_batch(unit_rows(np.random.default_rng(1), 30, D), _metas(0, 30))
    index.search(np.ones(D, np.float32), 3)
    assert index.last_route["impl"] == "int8"
    index.search_masked(np.ones(D, np.float32), 3, np.ones(30, bool))
    assert index.last_route["impl"] == "int8_masked"
    assert index.describe()["count"] == 30
    index.raw_grouped_search_batch(np.ones((1, D)), 3, np.ones((1, 30)), np.zeros(1))
    assert index.last_route["impl"] == "int8_grouped"
    assert VectorIndex(D, index_type="ivf", **_paths(tmp_path, "i"), device="cpu").index_type == "ivf"  # ported
    mesh = VectorIndex(D, mesh_devices=2, **_paths(tmp_path, "m"), device="cpu")  # ported: a mesh of 2 host shards
    mesh.add_batch(unit_rows(np.random.default_rng(1), 30, D), _metas(0, 30))
    mesh.search(np.ones(D, np.float32), 3)
    assert mesh.last_route == {"impl": "exact", "nprobe": None, "mesh_devices": 2}
    assert mesh._store.n_shards == 2 and mesh.describe()["mesh_devices"] == 2
    index.clear()
    assert index.get_total_items() == 0 and index.metadata == []


@pytest.mark.parametrize("dimension", [D, None])
def test_load_device_rows_serves_like_add_batch(tmp_path, dimension):
    rng = np.random.default_rng(5)
    rows = unit_rows(rng, 120, D)
    built = VectorIndex(D, **_paths(tmp_path, "a"), device="cpu")
    built.add_batch(rows, _metas(0, 120))
    installed = VectorIndex(dimension, **_paths(tmp_path, "b"), device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        installed.load_device_rows(torch.from_numpy(rows), _metas(0, 119))
    installed.load_device_rows(torch.from_numpy(rows), _metas(0, 120))
    assert installed.dimension == D and installed.get_total_items() == 120
    np.testing.assert_allclose(
        installed.get_embedding_by_photo_path("/photos/7.jpg"), rows[7], rtol=0, atol=1e-7
    )
    _assert_same_search(installed, built, unit_rows(rng, 4, D), rng.random(120) > 0.5)


def test_no_device_means_the_card_and_raises_without_one(tmp_path, monkeypatch):
    monkeypatch.delenv("PSE_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="PSE_PLATFORM=cpu"):
        VectorIndex(dimension=8, **_paths(tmp_path, "card"))


def test_pse_platform_cpu_gives_the_host(tmp_path, monkeypatch):
    monkeypatch.setenv("PSE_PLATFORM", "cpu")
    index = VectorIndex(dimension=8, **_paths(tmp_path, "host"))
    assert torch.device(index.device).type == "cpu" and index._store.device.type == "cpu"
    index.add_batch(unit_rows(np.random.default_rng(2), 4, 8), _metas(0, 4))
    assert index.search(unit_rows(np.random.default_rng(2), 4, 8)[1], 1)[0]["metadata"]["photo_path"] == "/photos/1.jpg"

"""The port's ``VectorIndex(index_type="ivf")`` against the JAX package's:
the ``ivf`` and ``ivf_masked`` routes, the nprobe autotune and its report,
incremental appends and the retrain once the count doubles, the
``.ivf.npz`` sidecar (each package loads the other's without
retraining), the stale-sidecar cleanup, the flat loader refusing IVF
files, ``hnsw`` mapped to ``ivf``, the ``.meta.json`` and ``/metrics``
keys, and the micro-batcher's routing over an IVF index.

Each package builds its own IVF (k-means on well-separated clusters, so
both place every row alike).  JAX serves it off the TPU through its XLA
path, the port through kernel 7's plain version.  Tolerance: ids equal
and distances within 1e-5 (float32 sums in another order)."""

import os
from unittest import mock

import numpy as np
import pytest

from photo_search_engine_tpu.core.vector_index import VectorIndex as JaxIndex
from photo_search_engine_tpu.models.ivf import IVFIndex as JaxIVF
from photo_search_engine_tpu_torch.core.batcher import attach_microbatcher
from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
from photo_search_engine_tpu_torch.models.ivf import IVFIndex

D = 32


def _paths(tmp_path, name="ps"):
    return dict(index_path=str(tmp_path / f"{name}.index"), metadata_path=str(tmp_path / f"{name}-meta.json"))


def _clustered(rng, n=320, centers=8):
    """Well-separated clusters of rows with norms between 0.5 and 2 (the
    l2 distances stay small enough for the 1e-5 tolerance)."""
    c = rng.normal(size=(centers, D)).astype(np.float32) * 3
    x = np.concatenate([p + rng.normal(scale=0.2, size=(n // centers, D)).astype(np.float32) for p in c])
    return x / np.linalg.norm(x, axis=1, keepdims=True) * rng.uniform(0.5, 2.0, size=(n, 1)).astype(np.float32)


def _metas(start, n):
    return [{"photo_path": f"/p/{start + i}.jpg"} for i in range(n)]


def _pair(tmp_path, rows, **kw):
    """The same rows in a JAX and a port IVF index."""
    out = []
    for cls, name in ((JaxIndex, "jax"), (VectorIndex, "port")):
        index = cls(D, index_type="ivf", **_paths(tmp_path, name), **kw)
        index.add_batch(rows, _metas(0, rows.shape[0]))
        out.append(index)
    return out


def _same_hits(a, b):
    assert [[h["metadata"] for h in row] for row in a] == [[h["metadata"] for h in row] for row in b]
    np.testing.assert_allclose([[h["distance"] for h in r] for r in a], [[h["distance"] for h in r] for r in b],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_ivf_routes_match_jax(tmp_path, metric):
    rng = np.random.default_rng(0)
    rows = _clustered(rng)
    jax_index, port = _pair(tmp_path, rows, metric=metric, ivf_nlist=8, ivf_nprobe=2)
    queries = rows[rng.choice(320, 6, replace=False)] + 0.05 * rng.normal(size=(6, D)).astype(np.float32)
    _same_hits(port.search_batch(queries, 7), jax_index.search_batch(queries, 7))
    assert port.last_route == jax_index.last_route == {"impl": "ivf", "nprobe": 2, "mesh_devices": 0}
    np.testing.assert_array_equal(port._ivf.perm, jax_index._ivf.perm)
    mask = rng.random(320) < 0.3
    _same_hits([port.search_masked(queries[0], 5, mask)], [jax_index.search_masked(queries[0], 5, mask)])
    assert port.last_route == jax_index.last_route == {"impl": "ivf_masked", "nprobe": 2, "mesh_devices": 0}
    dists, idx = port.raw_search_batch(queries, 4)
    assert idx.shape == (6, 4) and port.last_route["impl"] == "ivf"
    np.testing.assert_array_equal(idx, jax_index.raw_search_batch(queries, 4)[1])


def test_autotune_report_matches_jax(tmp_path):
    rows = _clustered(np.random.default_rng(1))
    jax_index, port = _pair(tmp_path, rows, ivf_nlist=8, ivf_nprobe=0, ivf_target_recall=0.95)
    assert port.effective_nprobe == 64 and port.describe()["ivf_autotune"] is None  # before the first build
    _same_hits(port.search_batch(rows[:4], 5), jax_index.search_batch(rows[:4], 5))
    report = port.describe()["ivf_autotune"]
    assert report == jax_index.describe()["ivf_autotune"]
    assert report["nprobe"] == port.effective_nprobe == port._ivf_nprobe_auto <= 8
    # the route names the nprobe the search used; the JAX index reads it
    # before its first (autotuning) build and reports the default 64
    assert port.last_route["nprobe"] == report["nprobe"] and jax_index.last_route["nprobe"] == 64
    assert report["self_recall_at_10"] >= 0.95 and 0.5 <= report["heldout_recall_at_10"] <= 1.0
    # the report rides the sidecar across a save and a load
    port.save()
    again = VectorIndex(D, index_type="ivf", ivf_nlist=8, ivf_nprobe=0, **_paths(tmp_path, "port"))
    assert again.load() and again.describe()["ivf_autotune"] == report


def test_describe_and_meta_keys_match_jax(tmp_path):
    jax_index, port = _pair(tmp_path, _clustered(np.random.default_rng(2)), ivf_nlist=8, ivf_nprobe=4)
    assert port._meta_payload() == jax_index._meta_payload()
    jax_keys = set(jax_index.describe()) - {"fetch_retries", "fetch_failures"}
    assert jax_keys <= set(port.describe())
    for key in ("ivf_nlist", "ivf_nprobe_effective", "ivf_autotune"):
        assert port.describe()[key] == jax_index.describe()[key]


def test_incremental_append_then_retrain_on_doubling(tmp_path):
    rng = np.random.default_rng(3)
    index = VectorIndex(D, index_type="ivf", ivf_nlist=8, ivf_nprobe=8, **_paths(tmp_path))
    rows = rng.normal(size=(120, D)).astype(np.float32)
    index.add_batch(rows, _metas(0, 120))
    index.search(rows[0], 1)
    built = index._ivf
    fresh = rng.normal(size=D).astype(np.float32)
    index.add_item(fresh.tolist(), {"photo_path": "/p/new.jpg"})
    assert index.search(fresh, 1)[0]["metadata"]["photo_path"] == "/p/new.jpg"
    assert index._ivf is built and index._ivf_built_at == 121  # appended in place
    assert index.search(rows[17], 1)[0]["metadata"]["photo_path"] == "/p/17.jpg"
    more = rng.normal(size=(150, D)).astype(np.float32)
    index.add_batch(more, _metas(1000, 150))
    assert index.search(more[42], 1)[0]["metadata"]["photo_path"] == "/p/1042.jpg"
    assert index._ivf is not built and index._ivf_trained_at == 271  # > 2x: retrained


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sidecar_loads_across_packages_without_retraining(tmp_path, direction):
    rng = np.random.default_rng(4)
    rows = _clustered(rng)
    writer_cls, reader_cls, reader_ivf = (
        (JaxIndex, VectorIndex, IVFIndex) if direction == "jax_to_port" else (VectorIndex, JaxIndex, JaxIVF)
    )
    writer = writer_cls(D, index_type="ivf", ivf_nlist=8, ivf_nprobe=0, **_paths(tmp_path))
    writer.add_batch(rows, _metas(0, 320))
    writer.save()
    assert not os.path.exists(writer.ivf_sidecar_path)
    queries = rows[:5] + 0.05 * rng.normal(size=(5, D)).astype(np.float32)
    expected = writer.search_batch(queries, 6)  # the first routed search builds, tunes and persists
    assert os.path.exists(writer.ivf_sidecar_path)
    reader = reader_cls(None, index_type="ivf", ivf_nlist=8, ivf_nprobe=0, **_paths(tmp_path))
    with mock.patch.object(reader_ivf, "build", side_effect=AssertionError("retrained")):
        assert reader.load()
        assert reader._ivf is not None and reader._ivf_built_at == 320
        assert reader._ivf_nprobe_auto == writer._ivf_nprobe_auto
        np.testing.assert_array_equal(reader._ivf.perm, writer._ivf.perm)
        _same_hits(reader.search_batch(queries, 6), expected)


def test_quantized_flag_consistent_across_restart(tmp_path):
    """A restored int8 deployment probes the int8 shadow, as a fresh build does."""
    rows = _clustered(np.random.default_rng(8))
    index = VectorIndex(D, index_type="ivf", ivf_nlist=8, quantized=True, **_paths(tmp_path))
    index.add_batch(rows, _metas(0, 320))
    index.save()
    expected = index.search_batch(rows[:3], 5)
    assert index._ivf.quantized and index._ivf._corpus_i8 is not None
    again = VectorIndex(None, index_type="ivf", ivf_nlist=8, quantized=True, **_paths(tmp_path))
    with mock.patch.object(IVFIndex, "build", side_effect=AssertionError("retrained")):
        assert again.load() and again._ivf.quantized
        _same_hits(again.search_batch(rows[:3], 5), expected)


def test_stale_sidecar_is_removed_on_save(tmp_path):
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(300, D)).astype(np.float32)
    index = VectorIndex(D, index_type="ivf", ivf_nlist=8, **_paths(tmp_path))
    index.add_batch(rows[:200], _metas(0, 200))
    index.save()
    index.search(rows[0], 3)
    assert os.path.exists(index.ivf_sidecar_path)
    index.add_batch(rows[200:], _metas(200, 100))
    index.save()  # the built IVF no longer matches the rows
    assert not os.path.exists(index.ivf_sidecar_path)
    again = VectorIndex(D, index_type="ivf", ivf_nlist=8, **_paths(tmp_path))
    assert again.load() and again._ivf is None
    with open(index.ivf_sidecar_path, "wb") as f:
        f.write(b"not an npz")
    assert again.load() and again._ivf is None  # a corrupt sidecar is ignored
    assert again.search(rows[11], 1)[0]["metadata"]["photo_path"] == "/p/11.jpg"


@pytest.mark.parametrize("writer_cls", [JaxIndex, VectorIndex])
def test_flat_loader_rejects_ivf_files(tmp_path, writer_cls):
    writer = writer_cls(D, index_type="ivf", ivf_nlist=8, **_paths(tmp_path))
    writer.add_batch(np.random.default_rng(6).normal(size=(40, D)).astype(np.float32), _metas(0, 40))
    writer.save()
    with pytest.raises(ValueError, match="index type"):
        VectorIndex(None, index_type="flat", **_paths(tmp_path)).load()


def test_hnsw_maps_to_ivf(tmp_path, capsys):
    index = VectorIndex(D, index_type="hnsw", **_paths(tmp_path))
    assert index.index_type == "ivf" and "using ivf" in capsys.readouterr().out
    with pytest.raises(ValueError, match="index_type"):
        VectorIndex(D, index_type="annoy", **_paths(tmp_path))


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_microbatcher_routes_through_ivf(tmp_path, metric):
    """Unfiltered batched searches take the IVF route; filtered ones take
    the grouped scan of the flat store under cosine (as the JAX batcher
    does) and ``ivf_masked`` under l2 (the batcher leaves them alone)."""
    rows = _clustered(np.random.default_rng(7))
    index = VectorIndex(D, index_type="ivf", metric=metric, ivf_nlist=8, ivf_nprobe=8, **_paths(tmp_path))
    index.add_batch(rows, _metas(0, 320))
    batcher = attach_microbatcher(index, window_s=0.001)
    try:
        assert index.search(rows[9], 3)[0]["metadata"]["photo_path"] == "/p/9.jpg"
        assert index.last_route["impl"] == "ivf" and batcher.requests_served == 1
        mask = np.zeros(320, bool)
        mask[40:80] = True
        hits = index.search_masked(rows[45], 3, mask)
        assert hits[0]["metadata"]["photo_path"] == "/p/45.jpg"
        assert index.last_route["impl"] == ("exact_grouped" if metric == "cosine" else "ivf_masked")
    finally:
        batcher.close()

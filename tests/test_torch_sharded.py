"""The port's sharded store and searches (``parallel/sharded.py``) against
the JAX package's on its 8-device CPU mesh, the port on
``make_mesh(devices=["cpu"] * 8)``: the same seeded numpy rows give the
same stable ids and per-shard counts after appends, the same hits for
ip/cosine/l2, masked and grouped, float32 and the int8 tier (scores
within 1e-5 absolute for the unit-scale metrics, 1e-6 relative for l2),
the same k-means step (centroids within 1e-5 on rows whose assignments
are not near ties); ``.npy`` checkpoints load across the two packages in
both directions, with the re-shard refusal and ``allow_reshard=True``.
The per-shard kernels run their plain versions here (CPU tensors); the
mesh's bookkeeping, merge and collectives are the code the card runs."""

import json

import numpy as np
import pytest
import torch

from photo_search_engine_tpu.parallel import sharded as jax_sharded
from photo_search_engine_tpu_torch.parallel import sharded
from photo_search_engine_tpu_torch.parallel.sharded import Mesh, ShardedEmbeddingStore, make_mesh

D = 32
N_SHARDS = 8


def _mesh():
    return make_mesh(devices=["cpu"] * N_SHARDS)


def _pair(metric, quantized=False, rows=300, seed=0, shard_block=128):
    """The JAX store and the port's store holding the same rows, appended
    in two batches with a search between (first sync, then the tail)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, D)).astype(np.float32)
    j = jax_sharded.ShardedEmbeddingStore(D, jax_sharded.make_mesh(N_SHARDS), metric=metric,
                                          quantized=quantized, shard_block=shard_block)
    p = ShardedEmbeddingStore(D, _mesh(), metric=metric, quantized=quantized, shard_block=shard_block)
    split = rows * 2 // 5
    ids_j, ids_p = [j.append(x[:split])], [p.append(x[:split])]
    j.search(x[:1], 1)
    p.search(x[:1], 1)
    ids_j.append(j.append(x[split:]))
    ids_p.append(p.append(x[split:]))
    return j, p, np.concatenate(ids_j), np.concatenate(ids_p), rng


def _assert_same(jax_out, port_out, metric):
    jv, ji = (np.asarray(a) for a in jax_out)
    pv, pi = port_out
    np.testing.assert_array_equal(pi, ji)
    if metric == "l2":
        np.testing.assert_allclose(pv, jv, rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-5)


def test_mesh_layout_of_cpu_shards():
    mesh = _mesh()
    assert mesh.n_shards == N_SHARDS and mesh.shape == {"data": N_SHARDS}
    assert list(mesh.local_shards) == list(range(N_SHARDS)) and mesh.device == torch.device("cpu")
    assert make_mesh(3, device="cpu").n_shards == 3 and make_mesh(device="cpu").n_shards == 1
    with pytest.raises(ValueError):
        Mesh([])


@pytest.mark.parametrize("rows", [1, 7, 300, 1029])
def test_append_gives_the_jax_stable_ids_and_counts(rows):
    j, p, ids_j, ids_p, _ = _pair("cosine", rows=rows)
    np.testing.assert_array_equal(ids_p, ids_j)
    np.testing.assert_array_equal(p.counts, j.counts)
    for s in range(N_SHARDS):
        np.testing.assert_array_equal(p._host_shards[s], j._host_shards[s])
    stable = int(ids_p[-1])
    np.testing.assert_array_equal(p.reconstruct(stable), j.reconstruct(stable))


@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
@pytest.mark.parametrize("impl", ["auto", "pallas", "lax", "pallas_fast"])
@pytest.mark.parametrize("k", [1, 10, 70])
def test_search_matches_jax(metric, impl, k):
    j, p, _, _, rng = _pair(metric)
    q = rng.normal(size=(5, D)).astype(np.float32)
    _assert_same(j.search(q, k, impl=impl), p.search(q, k, impl=impl), metric)


@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
@pytest.mark.parametrize("quantized", [False, True])
def test_masked_search_matches_jax(metric, quantized):
    j, p, ids_j, ids_p, rng = _pair(metric, quantized=quantized)
    keep = rng.random(ids_p.shape[0]) < 0.3
    mask_j, mask_p = j.layout_mask(ids_j, keep), p.layout_mask(ids_p, keep)
    np.testing.assert_array_equal(mask_p, mask_j)
    q = rng.normal(size=(4, D)).astype(np.float32)
    impl = "int8" if quantized else "auto"
    _assert_same(j.search(q, 9, impl=impl, mask=mask_j), p.search(q, 9, impl=impl, mask=mask_p), metric)


@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
@pytest.mark.parametrize("k", [1, 10, 64, 65])
def test_int8_tier_matches_jax(metric, k):
    j, p, _, _, rng = _pair(metric, quantized=True)
    q = rng.normal(size=(6, D)).astype(np.float32)
    _assert_same(j.search(q, k, impl="int8"), p.search(q, k, impl="int8"), metric)


@pytest.mark.parametrize("metric", ["cosine", "ip"])
@pytest.mark.parametrize("impl", ["auto", "pallas_fast", "lax", "int8"])
@pytest.mark.parametrize("k", [5, 70])
def test_grouped_search_matches_jax(metric, impl, k):
    j, p, _, _, rng = _pair(metric, quantized=True)
    _, capacity = p._sync()
    table = (rng.random((3, N_SHARDS * capacity)) < 0.4).astype(np.int8)
    table[2] = 0  # a predicate that keeps nothing
    ids = np.array([0, 1, 2, 1, 0, 5], np.int32)  # 5: outside the table, keeps nothing
    q = rng.normal(size=(6, D)).astype(np.float32)
    _assert_same(j.grouped_search(q, k, table, ids, impl=impl), p.grouped_search(q, k, table, ids, impl=impl), metric)


def test_int8_needs_a_quantized_store_and_unknown_impl_raises():
    _, p, _, _, rng = _pair("cosine")
    q = rng.normal(size=(1, D)).astype(np.float32)
    with pytest.raises(ValueError, match="quantized"):
        p.search(q, 3, impl="int8")
    with pytest.raises(ValueError, match="impl"):
        p.search(q, 3, impl="approx")


def test_empty_store_and_uneven_rows():
    p = ShardedEmbeddingStore(D, _mesh())
    v, i = p.search(np.ones((2, D), np.float32), 3)
    assert v.shape == (2, 0) and i.shape == (2, 0)
    with pytest.raises(ValueError, match="divide evenly"):
        sharded.sharded_exact_search(np.ones((9, D), np.float32), np.ones((1, D)), 3, _mesh())


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_sharded_exact_search_on_host_arrays_matches_jax(metric):
    """The function API on a whole host corpus with per-shard live counts."""
    rng = np.random.default_rng(3)
    corpus = rng.normal(size=(8 * 40, D)).astype(np.float32)
    q = rng.normal(size=(3, D)).astype(np.float32)
    counts = np.array([40, 12, 0, 40, 5, 40, 39, 1], np.int32)
    jv, ji = jax_sharded.sharded_exact_search(corpus, q, 17, jax_sharded.make_mesh(N_SHARDS), counts=counts,
                                              metric=metric)
    pv, pi = sharded.sharded_exact_search(corpus, q, 17, _mesh(), counts=counts, metric=metric)
    _assert_same((jv, ji), (pv.numpy(), pi.numpy()), metric)


def _clustered(rng, n, nc=8, spread=0.15):
    centers = rng.normal(size=(nc, D)).astype(np.float32) * 4
    return (centers[rng.integers(0, nc, n)] + spread * rng.normal(size=(n, D))).astype(np.float32), centers


@pytest.mark.parametrize("with_counts", [False, True])
def test_kmeans_step_matches_jax(with_counts):
    """Centroids within 1e-5 (the shard sums are added in another order
    than XLA's psum) on well-separated clusters; the counts equal."""
    rng = np.random.default_rng(4)
    corpus, centers = _clustered(rng, 8 * 64)
    init = corpus[rng.choice(corpus.shape[0], 8, replace=False)] + 0.5
    init[3] = 100.0  # a centroid no row picks keeps its position
    counts = np.array([64, 60, 3, 64, 0, 64, 50, 64], np.int32) if with_counts else None
    cj, tj = jax_sharded.sharded_kmeans_step(corpus, init, jax_sharded.make_mesh(N_SHARDS), counts=counts)
    cp, tp = sharded.sharded_kmeans_step(corpus, init, _mesh(), counts=counts)
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(cp.numpy()[3], init[3])


def _save_pair(tmp_path, quantized=False):
    j, p, ids_j, ids_p, rng = _pair("cosine", quantized=quantized)
    j.save(str(tmp_path / "jax"))
    p.save(str(tmp_path / "port"))
    return j, p, ids_p, rng


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_npy_checkpoints_load_across_packages(tmp_path, direction):
    j, p, ids, rng = _save_pair(tmp_path)
    with open(tmp_path / "port" / "manifest.json") as f:
        port_manifest = json.load(f)
    with open(tmp_path / "jax" / "manifest.json") as f:
        assert json.load(f) == port_manifest
    q = rng.normal(size=(4, D)).astype(np.float32)
    if direction == "jax_to_port":
        loaded = ShardedEmbeddingStore(D, _mesh(), metric="cosine", shard_block=128)
        assert loaded.load(str(tmp_path / "jax"))
        _assert_same(j.search(q, 10), loaded.search(q, 10), "cosine")
    else:
        loaded = jax_sharded.ShardedEmbeddingStore(D, jax_sharded.make_mesh(N_SHARDS), metric="cosine",
                                                   shard_block=128)
        assert loaded.load(str(tmp_path / "port"))
        _assert_same(loaded.search(q, 10), p.search(q, 10), "cosine")
    np.testing.assert_array_equal(loaded.counts, p.counts)
    np.testing.assert_array_equal(loaded.reconstruct(int(ids[5])), p.reconstruct(int(ids[5])))


@pytest.mark.parametrize("source", ["jax", "port"])
def test_reshard_needs_allow_reshard_and_splits_as_jax(tmp_path, source):
    _save_pair(tmp_path)
    four_j = jax_sharded.ShardedEmbeddingStore(D, jax_sharded.make_mesh(4), metric="cosine", shard_block=128)
    four_p = ShardedEmbeddingStore(D, make_mesh(devices=["cpu"] * 4), metric="cosine", shard_block=128)
    with pytest.raises(ValueError, match="allow_reshard"):
        four_p.load(str(tmp_path / source))
    assert four_j.load(str(tmp_path / source), allow_reshard=True)
    assert four_p.load(str(tmp_path / source), allow_reshard=True)
    np.testing.assert_array_equal(four_p.counts, four_j.counts)
    q = np.random.default_rng(9).normal(size=(3, D)).astype(np.float32)
    _assert_same(four_j.search(q, 8), four_p.search(q, 8), "cosine")


def test_quantized_store_survives_save_load(tmp_path):
    _, p, _, rng = _save_pair(tmp_path, quantized=True)
    loaded = ShardedEmbeddingStore(D, _mesh(), metric="cosine", quantized=True, shard_block=128)
    assert loaded.load(str(tmp_path / "port"))
    q = rng.normal(size=(3, D)).astype(np.float32)
    np.testing.assert_array_equal(loaded.search(q, 6, impl="int8")[1], p.search(q, 6, impl="int8")[1])


def test_orbax_is_not_ported(tmp_path):
    _, p, _, _ = _save_pair(tmp_path)
    with pytest.raises(ValueError, match="Orbax"):
        p.save(str(tmp_path / "o"), format="orbax")
    with pytest.raises(ValueError, match="npy or orbax"):
        p.save(str(tmp_path / "o"), format="zarr")
    manifest = tmp_path / "port" / "manifest.json"
    payload = json.loads(manifest.read_text())
    manifest.write_text(json.dumps(dict(payload, format="orbax")))
    with pytest.raises(ValueError, match="Orbax"):
        ShardedEmbeddingStore(D, _mesh()).load(str(tmp_path / "port"))
    assert not ShardedEmbeddingStore(D, _mesh()).load(str(tmp_path / "missing"))


def test_incremental_sync_writes_only_the_tail():
    """After the first sync an append uploads the new rows only; a
    capacity change re-uploads every shard."""
    rng = np.random.default_rng(5)
    p = ShardedEmbeddingStore(D, _mesh(), metric="ip", quantized=True, shard_block=64)
    p.append(rng.normal(size=(100, D)).astype(np.float32))
    first, capacity = p._sync()
    before = [t.clone() for t in first]
    p.append(rng.normal(size=(40, D)).astype(np.float32))
    again, capacity2 = p._sync()
    assert capacity2 == capacity and all(a is b for a, b in zip(again, first))
    for s, (old, new) in enumerate(zip(before, again)):
        n_old = p.counts[s] - 5  # 40 rows over 8 shards
        torch.testing.assert_close(new[:n_old], old[:n_old], rtol=0, atol=0)
        torch.testing.assert_close(new[: p.counts[s]], torch.from_numpy(p._host_shards[s]), rtol=0, atol=0)
    p.append(rng.normal(size=(600, D)).astype(np.float32))
    grown, capacity3 = p._sync()
    assert capacity3 > capacity and grown[0].shape[0] == capacity3
    q, s = sharded.quantize_rows_host_rule(grown[3][: p.counts[3]])
    jq, js = jax_sharded.ShardedEmbeddingStore._quantize_host(p._host_shards[3])
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(p._device_i8[3][: p.counts[3]].numpy(), jq)


def test_merge_gives_ties_to_the_lowest_shard():
    """Equal scores on several shards: the merge keeps JAX's order (shard
    major, then the rank inside the shard's partial)."""
    mesh = make_mesh(devices=["cpu"] * 4)
    row = np.ones((1, D), np.float32)
    corpus = np.repeat(row, 4 * 8, axis=0)
    vals, idx = sharded.sharded_exact_search(corpus, row, 10, mesh, metric="ip")
    jv, ji = jax_sharded.sharded_exact_search(corpus, row, 10, jax_sharded.make_mesh(4), metric="ip")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert idx.numpy().tolist() == [[0, 1, 2, 3, 4, 5, 6, 7, 8, 9]]


def test_bfloat16_store_and_auto_dtype():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(64, D)).astype(np.float32)
    p = ShardedEmbeddingStore(D, _mesh(), metric="cosine", store_dtype="bfloat16", shard_block=16)
    p.append(x)
    dev, _ = p._sync()
    assert dev[0].dtype == torch.bfloat16
    assert ShardedEmbeddingStore(D, _mesh(), store_dtype="auto").store_dtype == torch.float32  # the host
    top = p.search(x[7], 1)[1][0, 0]
    np.testing.assert_allclose(p.reconstruct(int(top)), x[7] / np.linalg.norm(x[7]), rtol=1e-6)


def test_gather_and_psum_in_one_process_keep_shard_order():
    mesh = make_mesh(devices=["cpu"] * 3)
    parts = [torch.full((2,), float(s)) for s in range(3)]
    assert sharded.gather_shards(mesh, parts).tolist() == [[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]]
    assert sharded.psum(mesh, parts).tolist() == [3.0, 3.0]
    assert sharded.distributed() is None


def test_make_mesh_takes_the_first_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh(4, device="cuda:0")
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh(1, device="cuda:0").devices == (torch.device("cuda", 0),)


def test_stage_uploads_only_the_local_rows():
    """A rank's view: shards [4, 8) of an 8-shard mesh over two ranks."""

    class _Rank1:
        rank, world, backend = 1, 2, "gloo"

    mesh = Mesh(["cpu"] * 4, context=_Rank1())
    corpus = np.arange(8 * 3 * 2, dtype=np.float32).reshape(24, 2)
    parts = sharded._stage(mesh, corpus)
    assert mesh.n_shards == 8 and list(mesh.local_shards) == [4, 5, 6, 7]
    np.testing.assert_array_equal(torch.cat(parts).numpy(), corpus[12:])

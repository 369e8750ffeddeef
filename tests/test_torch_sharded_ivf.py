"""The port's sharded IVF (``parallel/sharded_ivf.py``) against the JAX
package's on its 8-device CPU mesh, the port on
``make_mesh(devices=["cpu"] * 8)``, for ip/cosine and l2.  On clustered
rows whose assignments are not near ties: trained centroids within 1e-5
(the k-means sums are added in another order than XLA's psum), the
per-shard perms and layouts equal, and the same hits at every nprobe,
masked probing included (scores within 1e-5, or 2e-6 of ``‖q‖²``).
The state round-trips across the two packages; appends place rows in
the same slots.  Kernel 7 runs its plain version here (CPU tensors)."""

import numpy as np
import pytest
import torch

from photo_search_engine_tpu.parallel import sharded as jax_sharded
from photo_search_engine_tpu.parallel.sharded_ivf import ShardedIVFIndex as JaxIVF
from photo_search_engine_tpu_torch.ops import ivf_scan
from photo_search_engine_tpu_torch.parallel.sharded import ShardedEmbeddingStore, make_mesh
from photo_search_engine_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

D = 32
NC = 8


def _clustered(rng, n, spread=0.3):
    centers = rng.normal(size=(NC, D)).astype(np.float32) * 3
    return (centers[rng.integers(0, NC, n)] + spread * rng.normal(size=(n, D))).astype(np.float32), centers


def _built(metric, rows=400, seed=0, nlist=NC):
    rng = np.random.default_rng(seed)
    x, centers = _clustered(rng, rows)
    js = jax_sharded.ShardedEmbeddingStore(D, jax_sharded.make_mesh(8), metric=metric, shard_block=128)
    ps = ShardedEmbeddingStore(D, make_mesh(devices=["cpu"] * 8), metric=metric, shard_block=128)
    js.append(x)
    ps.append(x)
    return js, ps, JaxIVF.build(js, nlist), ShardedIVFIndex.build(ps, nlist), rng, centers


def _queries(rng, centers, metric, n=6):
    q = (centers[rng.integers(0, NC, n)] + 0.3 * rng.normal(size=(n, D))).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True) if metric == "cosine" else q


def _assert_same(jax_out, port_out, queries):
    """Ids equal; values within 1e-5, or within 2e-6 of ``‖q‖²`` per query:
    an l2 distance is ``‖q‖² − (2⟨q, c⟩ − ‖c‖²)``, terms of that size summed
    in another order, and these rows' norms are those of the queries."""
    jv, ji = (np.asarray(a) for a in jax_out)
    pv, pi = port_out
    np.testing.assert_array_equal(pi, ji)
    qn = np.square(np.atleast_2d(queries)).sum(axis=1, keepdims=True)
    finite = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(pv), finite)
    np.testing.assert_array_equal(pv[~finite], jv[~finite])
    err = np.abs(np.where(finite, pv, 0.0) - np.where(finite, jv, 0.0))
    assert (err <= np.maximum(1e-5, 2e-6 * qn)).all(), float(err.max())


@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
def test_build_matches_jax(metric):
    js, ps, ji, pi, _, _ = _built(metric)
    np.testing.assert_allclose(pi.centroids, ji.centroids, rtol=0, atol=1e-5)
    assert (pi.nlist, pi.lrows, pi.dim, pi.dp) == (ji.nlist, ji.lrows, ji.dim, ji.dp)
    np.testing.assert_array_equal(pi.perms, ji.perms)
    np.testing.assert_array_equal(pi.built_counts, ji.built_counts)
    jax_layout = np.asarray(ji._layout).reshape(8, ji.nlist * ji.lrows, ji.dp)[:, :, :D]
    for s in range(8):
        np.testing.assert_array_equal(pi._layouts[s].numpy(), jax_layout[s])
        np.testing.assert_array_equal(pi._row_valid[s].numpy(), np.asarray(ji._row_valid).reshape(8, -1)[s])


@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
@pytest.mark.parametrize("nprobe", [1, 3, NC])
@pytest.mark.parametrize("k", [1, 10, 60])
def test_search_matches_jax(metric, nprobe, k):
    _, _, ji, pi, rng, centers = _built(metric)
    q = _queries(rng, centers, metric)
    _assert_same(ji.search(q, k, nprobe), pi.search(q, k, nprobe), q)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("keep", [0.4, 0.02, 0.0])
def test_masked_probing_matches_jax(metric, keep):
    _, _, ji, pi, rng, centers = _built(metric)
    slot_mask = (rng.random(8 * pi.span) < keep).astype(np.int32)
    q = _queries(rng, centers, metric)
    _assert_same(ji.search(q, 10, 2, slot_mask=slot_mask), pi.search(q, 10, 2, slot_mask=slot_mask), q)


def test_full_probe_equals_the_sharded_exact_scan():
    js, ps, _, pi, rng, centers = _built("cosine")
    q = _queries(rng, centers, "cosine")
    _, exact = ps.search(q, 10)
    np.testing.assert_array_equal(pi.search(q, 10, NC)[1], exact)


def test_k_beyond_one_shards_slots_is_padded():
    """Fewer probed slots than k: the merge pads with -1 as JAX does."""
    _, _, ji, pi, rng, centers = _built("cosine", rows=64, nlist=4)
    q = _queries(rng, centers, "cosine", n=2)
    _assert_same(ji.search(q, 60, 1), pi.search(q, 60, 1), q)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_state_round_trips_across_packages(metric):
    js, ps, ji, pi, rng, centers = _built(metric)
    from_jax = ShardedIVFIndex.from_state(ps, ji.state())
    from_port = JaxIVF.from_state(js, pi.state())
    q = _queries(rng, centers, metric)
    _assert_same(ji.search(q, 10, 2), from_jax.search(q, 10, 2), q)
    _assert_same(from_port.search(q, 10, 2), pi.search(q, 10, 2), q)
    bad = dict(pi.state(), perms=pi.perms[:4])
    with pytest.raises(ValueError, match="shape"):
        ShardedIVFIndex.from_state(ps, bad)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_append_places_rows_as_jax(metric):
    js, ps, ji, pi, rng, centers = _built(metric)
    new, _ = _clustered(np.random.default_rng(11), 24)
    ids_j, ids_p = js.append(new), ps.append(new)
    np.testing.assert_array_equal(ids_p, ids_j)
    assert ji.append(new, ids_j) and pi.append(new, ids_p)
    np.testing.assert_array_equal(pi.perms, ji.perms)
    np.testing.assert_array_equal(pi.built_counts, ji.built_counts)
    q = _queries(rng, centers, metric)
    _assert_same(ji.search(q, 10, 2), pi.search(q, 10, 2), q)
    hit = pi.search(new[3], 1, NC)[1][0, 0]
    assert hit == ids_p[3]


def test_append_declines_a_full_cluster():
    _, ps, _, pi, _, _ = _built("cosine", rows=64, nlist=2)
    far = np.tile(pi.centroids[0, :D], (8 * pi.span + 8, 1))  # more rows than every shard's slots
    assert not pi.append(far, ps.append(far))


def test_each_shard_launches_kernel_seven_once(monkeypatch):
    """One stage-2 call per local shard per search (the card launches
    kernel 7 once per shard)."""
    _, _, _, pi, rng, centers = _built("cosine")
    calls = []
    plain = ivf_scan.ivf_block_topk

    def counted(corpus, *args, **kwargs):
        calls.append(corpus.data_ptr())
        return plain(corpus, *args, **kwargs)

    monkeypatch.setattr(ivf_scan, "ivf_block_topk", counted)
    pi.search(_queries(rng, centers, "cosine"), 10, 3)
    assert len(calls) == 8 and len(set(calls)) == 8


def test_bfloat16_layout_inherits_the_store_dtype():
    rng = np.random.default_rng(3)
    x, centers = _clustered(rng, 256)
    ps = ShardedEmbeddingStore(D, make_mesh(devices=["cpu"] * 4), metric="cosine", store_dtype="bfloat16",
                               shard_block=64)
    ps.append(x)
    pi = ShardedIVFIndex.build(ps, NC)
    assert all(t.dtype == torch.bfloat16 for t in pi._layouts)
    q = _queries(rng, centers, "cosine")
    _, exact = ps.search(q, 5)
    assert (pi.search(q, 5, NC)[1] == exact).mean() >= 0.9

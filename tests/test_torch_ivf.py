"""The port's IVF module against the JAX package's ``models/ivf.py``.

Seeded numpy inputs go through both packages.  k-means, the cluster
assignment and the balanced layout are compared directly.  The search is
compared through state carried across with ``ivf_state_from_jax`` (the
same centroids, layout and rows in both), so it is the scan that is under
test, not k-means rounding: JAX runs ``IVFIndex.search(impl="pallas")``,
kernel 7's Pallas original in interpret mode, and the port runs kernel 7's
plain version (CPU tensors).  Kernel 7's host contract (the probe-pair
groups the CUDA kernel walks) is checked here by emulating the kernel's
walk over them; the kernel itself runs only on the card
(``test_torch_kernels_cuda.py``).

Tolerances: search values within 1e-5 (float32 sums in another order, unit
rows), ids equal wherever the reference score is 1e-5 away from its
neighbours (``torch_parity.assert_topk_match``); centroids within 1e-5;
assignment, layout, the int8 query quantization and the tuned nprobe
identical.
"""

import numpy as np
import pytest
import torch

from photo_search_engine_tpu.models import ivf as jax_ivf
from photo_search_engine_tpu_torch.core.convert import ivf_state_from_jax
from photo_search_engine_tpu_torch.models import ivf
from photo_search_engine_tpu_torch.ops import ivf_scan
from photo_search_engine_tpu_torch.ops.quantized import quantize_rows
from tests.torch_parity import assert_topk_match, unit_rows

D = 64
TOL = 1e-5
_INT_MAX = np.iinfo(np.int32).max


def _clustered(rng, n=2000, d=D, centers=20):
    c = rng.normal(size=(centers, d)).astype(np.float32) * 3
    x = np.concatenate([p + rng.normal(scale=0.2, size=(n // centers, d)).astype(np.float32) for p in c])
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _port_of(jax_index):
    state = ivf_state_from_jax(jax_index)
    return ivf.IVFIndex.from_state(state["rows"], state, store_dtype=state["dtype"], quantized=state["quantized"])


def _assert_same(got, ref, metric):
    """Port ``(dists, ids)`` against JAX's: the parity rule, in the order
    of the metric (l2 distances ascend)."""
    (gv, gi), (rv, ri) = got, ref
    assert_topk_match(gv, gi, rv, ri, tol=TOL, descending=metric != "l2")


_JAX = {}


def _jax_index(metric, dtype, quantized):
    """One JAX index per configuration, built once for the module."""
    key = (metric, dtype, quantized)
    if key not in _JAX:
        rng = np.random.default_rng(2)
        corpus = unit_rows(rng, 2000, D)
        if metric == "l2":
            corpus *= rng.uniform(0.5, 2.0, size=(2000, 1)).astype(np.float32)
        _JAX[key] = (jax_ivf.IVFIndex.build(corpus, nlist=32, metric=metric, store_dtype=dtype,
                                            quantized=quantized, seed=0), corpus)
    return _JAX[key]


def _queries(corpus, rng, n=9):
    q = corpus[rng.choice(corpus.shape[0], n, replace=False)]
    return (q + 0.05 * rng.normal(size=q.shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# training, assignment, layout
# ---------------------------------------------------------------------------


def test_train_kmeans_matches_jax():
    data = _clustered(np.random.default_rng(7))
    want = jax_ivf.train_kmeans(data, 16, iters=6, seed=3)
    got = ivf.train_kmeans(data, 16, iters=6, seed=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # nlist above the row count is clamped, as in JAX
    assert ivf.train_kmeans(data[:5], 100, iters=2).shape == (5, D)


@pytest.mark.parametrize("nlist", [2, 32])
def test_assign_clusters_matches_jax(nlist):
    rng = np.random.default_rng(4)
    data, cents = unit_rows(rng, 3000, D), unit_rows(rng, nlist, D)
    got = ivf.assign_clusters(data, cents, chunk=1000)
    np.testing.assert_array_equal(got, jax_ivf.assign_clusters(data, cents))
    assert got.dtype == np.int32 and got.shape == (3000, 3)


def test_assign_clusters_breaks_ties_to_the_smallest_centroid():
    cents = np.zeros((6, 4), np.float32)
    cents[[1, 3, 4]] = [1.0, 0, 0, 0]  # three equal nearest centroids
    ranked = ivf.assign_clusters(np.array([[1.0, 0, 0, 0]], np.float32), cents)
    np.testing.assert_array_equal(ranked, [[1, 3, 4]])
    np.testing.assert_array_equal(ranked, jax_ivf.assign_clusters(np.array([[1.0, 0, 0, 0]], np.float32), cents))


@pytest.mark.parametrize("native", [True, False])
def test_balanced_layout_matches_jax(monkeypatch, native):
    rng = np.random.default_rng(5)
    ranked = rng.integers(0, 8, size=(700, 3))
    ranked[:300] = [0, 1, 2]  # crowd the first clusters: rows spill
    want = jax_ivf.balanced_layout(ranked, 8, slack=1.2)
    if not native:
        monkeypatch.setattr(ivf, "_native_layout", lambda *a: None)
    got = ivf.balanced_layout(ranked, 8, slack=1.2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == 128
    assert sorted(got[1][got[1] >= 0].tolist()) == list(range(700))


def test_build_matches_jax_end_to_end():
    """The whole build from the same rows: the same layout, then the same
    search (k-means on well-separated clusters, so no assignment flips)."""
    rng = np.random.default_rng(8)
    corpus = _clustered(rng)
    want = jax_ivf.IVFIndex.build(corpus, nlist=16, seed=1)
    got = ivf.IVFIndex.build(corpus, nlist=16, seed=1)
    np.testing.assert_array_equal(got.perm, want.perm)
    assert got.capacity == want.capacity
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=0, atol=TOL)
    queries = _queries(corpus, rng)
    _assert_same(got.search(queries, 10, nprobe=4), want.search(queries, 10, nprobe=4, impl="pallas"), "ip")
    assert set(got.build_seconds) == {"kmeans", "assign_and_upload", "placement", "layout"}


def test_build_on_device_matches_build():
    corpus = _clustered(np.random.default_rng(9))
    built = ivf.IVFIndex.build(corpus, nlist=16, seed=2)
    on_device = ivf.IVFIndex.build_on_device(torch.from_numpy(corpus), nlist=16, seed=2)
    np.testing.assert_array_equal(on_device.perm, built.perm)
    np.testing.assert_allclose(on_device.centroids, built.centroids, rtol=0, atol=TOL)
    assert on_device._corpus.dtype == torch.float32 and not on_device.quantized


# ---------------------------------------------------------------------------
# search, through state carried across from a JAX index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_search_matches_jax(metric, dtype):
    jax_index, corpus = _jax_index(metric, dtype, False)
    port = _port_of(jax_index)
    queries = _queries(corpus, np.random.default_rng(11))
    for k, nprobe in ((10, 8), (1, 1)):
        _assert_same(port.search(queries, k, nprobe=nprobe),
                     jax_index.search(queries, k, nprobe=nprobe, impl="pallas"), metric)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_quantized_search_matches_jax(metric):
    jax_index, corpus = _jax_index(metric, "float32", True)
    port = _port_of(jax_index)
    assert port.quantized
    queries = _queries(corpus, np.random.default_rng(12))
    _assert_same(port.search(queries, 10, nprobe=8), jax_index.search(queries, 10, nprobe=8, impl="pallas"), metric)
    # the int8 shadow is the JAX one, bit for bit
    np.testing.assert_array_equal(port._corpus_i8.numpy(), np.asarray(jax_index._corpus_i8)[:, :D])
    np.testing.assert_array_equal(port._cscales.numpy(), np.asarray(jax_index._cscales)[0])


@pytest.mark.parametrize("quantized", [False, True])
def test_large_k_matches_jax(quantized):
    """k > 64: JAX's int8 tier leaves its kernel for an exact scan, the
    port for kernel 7's exact variant; both are exact over the probes."""
    jax_index, corpus = _jax_index("ip", "float32", quantized)
    port = _port_of(jax_index)
    queries = _queries(corpus, np.random.default_rng(13), n=3)
    _assert_same(port.search(queries, 80, nprobe=8), jax_index.search(queries, 80, nprobe=8, impl="pallas"), "ip")


@pytest.mark.parametrize("quantized", [False, True])
def test_masked_search_matches_jax(quantized):
    jax_index, corpus = _jax_index("ip", "float32", quantized)
    port = _port_of(jax_index)
    rng = np.random.default_rng(14)
    mask = rng.random(corpus.shape[0]) < 0.2
    queries = _queries(corpus, rng)
    _assert_same(port.search(queries, 10, nprobe=4, mask=mask),
                 jax_index.search(queries, 10, nprobe=4, mask=mask, impl="pallas"), "ip")
    _, ids = port.search(queries, 10, nprobe=4, mask=mask)
    assert mask[ids[ids >= 0]].all()
    for nprobe, ratio in ((4, 0.2), (4, 0.0), (8, 1.0), (3, 0.05), (16, 0.01)):
        assert port._inflate_nprobe(nprobe, ratio, 32) == jax_index._inflate_nprobe(nprobe, ratio, 32)


def test_search_after_append_matches_jax():
    rng = np.random.default_rng(15)
    corpus = unit_rows(rng, 1000, D)
    jax_index = jax_ivf.IVFIndex.build(corpus, nlist=16, seed=0, quantized=True)
    port = _port_of(jax_index)
    port.search(corpus[:2], 5, nprobe=16)
    assert port._corpus_i8 is not None
    new = unit_rows(rng, 30, D)
    assert jax_index.append(new, np.arange(1000, 1030)) and port.append(new, np.arange(1000, 1030))
    np.testing.assert_array_equal(port.perm, jax_index.perm)
    assert port._corpus_i8 is None and port._cnorms is None  # dropped, rebuilt on the next search
    queries = np.concatenate([corpus[:4], new[:5]])
    got = port.search(queries, 10, nprobe=8)
    _assert_same(got, jax_index.search(queries, 10, nprobe=8, impl="pallas"), "ip")
    np.testing.assert_array_equal(got[1][4:, 0], np.arange(1000, 1005))  # a new row is its own neighbour
    assert not port.append(unit_rows(rng, 16 * port.capacity, D), np.arange(16 * port.capacity))  # full


def test_k_clamped_to_live_rows():
    rng = np.random.default_rng(16)
    corpus = unit_rows(rng, 6, D)
    jax_index = jax_ivf.IVFIndex.build(corpus, nlist=2, seed=0)
    port = _port_of(jax_index)
    got = port.search(corpus[:2], 50, nprobe=2)
    assert got[1].shape == (2, 6)
    _assert_same(got, jax_index.search(corpus[:2], 50, nprobe=2, impl="pallas"), "ip")
    # one probed cluster holds fewer slots than k: the rest is empty
    dists, ids = port.search(corpus[:1], 6, nprobe=1)
    assert ids.shape == (1, 6) and (ids[0] == -1).sum() == 6 - (port.perm[: port.capacity] >= 0).sum()


def test_ivf_state_from_jax_carries_the_index():
    jax_index, corpus = _jax_index("ip", "bfloat16", False)
    state = ivf_state_from_jax(jax_index)
    assert state["dtype"] == "bfloat16" and state["quantized"] is False and state["metric"] == "ip"
    # the rows come back in their original order (bf16-rounded, as stored)
    np.testing.assert_array_equal(state["rows"], torch.from_numpy(corpus).bfloat16().float().numpy())
    port = _port_of(jax_index)
    queries = _queries(corpus, np.random.default_rng(17))
    np.testing.assert_array_equal(port.search(queries, 5, nprobe=32)[1],
                                  jax_index.search(queries, 5, nprobe=32, impl="pallas")[1])


def test_query_quantization_is_bit_identical(monkeypatch):
    """The JAX IVF search quantizes its queries eagerly, where XLA divides
    by 127; the port's ``quantize_ivf_queries`` divides too.  The jitted
    ``quantize_rows`` (a product with float32(1/127)) would differ."""
    jax_index, corpus = _jax_index("ip", "float32", True)
    seen = {}
    real = jax_ivf._ivf_pallas

    def spy(corpus_ivf, queries, *args, **kwargs):
        seen["q_i8"], seen["qs"] = np.asarray(queries), np.asarray(args[5])  # qscales
        return real(corpus_ivf, queries, *args, **kwargs)

    monkeypatch.setattr(jax_ivf, "_ivf_pallas", spy)
    queries = np.random.default_rng(18).normal(size=(64, D)).astype(np.float32)
    jax_index.search(queries, 5, nprobe=4, impl="pallas")
    q_i8, qs = ivf_scan.quantize_ivf_queries(torch.from_numpy(queries))
    np.testing.assert_array_equal(q_i8.numpy(), seen["q_i8"][:64, :D])
    np.testing.assert_array_equal(qs.numpy(), seen["qs"][:64, 0])
    many = torch.from_numpy(np.random.default_rng(19).normal(size=(4096, D)).astype(np.float32))
    assert not torch.equal(quantize_rows(many)[1], ivf_scan.quantize_ivf_queries(many)[1])


def test_tune_nprobe_matches_jax():
    rng = np.random.default_rng(20)
    corpus = _clustered(rng)
    jax_index = jax_ivf.IVFIndex.build(corpus, nlist=32, seed=0)
    port = _port_of(jax_index)
    queries = corpus[rng.choice(2000, 16, replace=False)]
    got = port.tune_nprobe(queries, k=10, target_recall=0.98)
    assert got == jax_index.tune_nprobe(queries, k=10, target_recall=0.98)
    assert got[0] < 32 and got[1] >= 0.98
    assert port.tune_nprobe(queries, k=5, target_recall=1.01, max_nprobe=4)[0] == 4


def test_state_roundtrip_and_foreign_corpus():
    rng = np.random.default_rng(21)
    corpus = unit_rows(rng, 600, D)
    index = ivf.IVFIndex.build(corpus, nlist=16, metric="l2", seed=3)
    restored = ivf.IVFIndex.from_state(corpus, index.state())
    assert restored.metric == "l2"
    np.testing.assert_array_equal(restored.search(corpus[:5], 8, nprobe=4)[1], index.search(corpus[:5], 8, nprobe=4)[1])
    with pytest.raises(ValueError, match="beyond the corpus"):
        ivf.IVFIndex.from_state(corpus[:100], index.state())


# ---------------------------------------------------------------------------
# kernel 7's host contract
# ---------------------------------------------------------------------------


def _emulate_kernel(corpus, queries, probe_ids, row_valid, k, lrows, block_n):
    """Kernel 7's walk over the probe-pair groups, in numpy: one (group,
    tile) at a time, each query of the group scored against the tile and
    its top-kk written to its own partial slot."""
    groups, pair_query, pair_slot, bq = ivf_scan.probe_groups(probe_ids, corpus.shape[0] // lrows)
    nq, nprobe = probe_ids.shape
    tiles, kk = -(-lrows // block_n), min(k, block_n)
    out_v = np.full((nq, nprobe, tiles, kk), -np.inf, np.float32)
    out_i = np.full((nq, nprobe, tiles, kk), _INT_MAX, np.int32)
    seen = np.zeros((nq, nprobe), int)
    for cluster, first, size in groups:
        assert 1 <= size <= bq
        for t in range(tiles):
            lo = cluster * lrows + t * block_n
            hi = min(lo + block_n, (cluster + 1) * lrows)
            for p in range(first, first + size):
                q, j = pair_query[p], pair_slot[p]
                assert probe_ids[q, j] == cluster
                seen[q, j] += t == 0
                s = np.where(row_valid[lo:hi] > 0, corpus[lo:hi] @ queries[q], -np.inf).astype(np.float32)
                order = np.argsort(-s, kind="stable")[:kk]
                out_v[q, j, t, : order.size] = s[order]
                out_i[q, j, t, : order.size] = np.where(np.isneginf(s[order]), _INT_MAX, lo + order)
    assert (seen == 1).all()  # every (query, probe) pair in exactly one group
    return out_v, out_i


@pytest.mark.parametrize("nq,nprobe", [(1, 3), (9, 4), (40, 8)])
def test_probe_groups_emulated_walk_matches_the_plain_version(nq, nprobe):
    rng = np.random.default_rng(22)
    nlist, lrows, block_n = 8, 48, 32  # a ragged last tile of 16 slots
    corpus = unit_rows(rng, nlist * lrows, 16)
    corpus[100:110] = corpus[5]  # duplicate slots: ties to the smallest slot
    row_valid = (rng.random(nlist * lrows) < 0.8).astype(np.int8)
    probe_ids = np.sort(np.stack([rng.choice(nlist, nprobe, replace=False) for _ in range(nq)]), axis=1)
    queries = unit_rows(rng, nq, 16)
    queries[0] = corpus[5]
    for k in (1, 12, 100):
        want = _emulate_kernel(corpus, queries, probe_ids, row_valid, k, lrows, block_n)
        got = ivf_scan.ivf_block_topk(
            torch.from_numpy(corpus), torch.from_numpy(queries), torch.from_numpy(probe_ids.astype(np.int32)),
            torch.from_numpy(row_valid), k, lrows=lrows, block_n=block_n,
        )
        assert_topk_match(*got, *want, tol=TOL)


def test_probe_groups_pick_the_group_size():
    assert ivf_scan.probe_groups(np.arange(64).reshape(1, 64).astype(np.int32), 64)[3] == 8
    crowded = np.tile(np.arange(4, dtype=np.int32), (12, 1))  # 12 queries per cluster
    groups, _, _, bq = ivf_scan.probe_groups(crowded, 4)
    assert bq == 16 and groups[:, 2].tolist() == [12, 12, 12, 12]
    groups, _, _, bq = ivf_scan.probe_groups(np.tile(np.arange(2, dtype=np.int32), (70, 1)), 2)
    assert bq == 32 and groups[:, 0].tolist() == [0, 0, 0, 1, 1, 1] and groups[:, 2].tolist() == [32, 32, 6] * 2
    with pytest.raises(ValueError, match="probe ids"):
        ivf_scan.probe_groups(np.array([[4]], np.int32), 4)


def test_plain_scan_masks_and_empties():
    """Slots with row_valid 0 never come out; a query whose probed
    clusters are all masked gets an empty result; the int8 scores are the
    exact dot times the query scale, then the slot's."""
    rng = np.random.default_rng(23)
    lrows, d = 32, 16
    corpus = torch.from_numpy(unit_rows(rng, 4 * lrows, d))
    row_valid = torch.ones(4 * lrows, dtype=torch.int8)
    row_valid[:lrows] = 0  # cluster 0 empty
    row_valid[lrows + 3] = 0
    probes = torch.tensor([[0, 1], [0, 0]], dtype=torch.int32)[:, :1]
    vals, slots = ivf_scan.ivf_block_topk(corpus, corpus[:2], probes, row_valid, 5, lrows=lrows, block_n=16)
    assert torch.isneginf(vals).all() and (slots == _INT_MAX).all()
    probes = torch.tensor([[1, 2]], dtype=torch.int32)
    vals, slots = ivf_scan.ivf_block_topk(corpus, corpus[lrows + 3 : lrows + 4], probes, row_valid, 40,
                                          lrows=lrows, block_n=16)
    assert lrows + 3 not in slots.flatten().tolist() and slots.shape == (1, 2, 2, 16)
    c8, cs = quantize_rows(corpus)
    q8, qs = ivf_scan.quantize_ivf_queries(corpus[:1])
    vals, slots = ivf_scan.ivf_block_topk(c8, q8, probes, row_valid, 3, lrows=lrows, qscales=qs, cscales=cs,
                                          block_n=16)
    s = int(slots[0, 0, 0, 0])
    dot = float((q8[0].double() @ c8[s].double()))
    assert float(vals[0, 0, 0, 0]) == float(torch.tensor(dot, dtype=torch.float32) * qs[0] * cs[s])

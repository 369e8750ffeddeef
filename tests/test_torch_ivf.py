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

import contextlib
import inspect

import numpy as np
import pytest
import torch

from photo_search_engine_tpu.models import ivf as jax_ivf
from photo_search_engine_tpu_torch.core.convert import ivf_state_from_jax
from photo_search_engine_tpu_torch.models import ivf
from photo_search_engine_tpu_torch.ops import ivf_scan
from photo_search_engine_tpu_torch.ops.quantized import quantize_rows
from tests.torch_parity import assert_topk_match, plain_scan, unit_rows

D = 64
TOL = 1e-5
_INT_MAX = np.iinfo(np.int32).max


def _clustered(rng, n=2000, d=D, centers=20):
    c = rng.normal(size=(centers, d)).astype(np.float32) * 3
    x = np.concatenate([p + rng.normal(scale=0.2, size=(n // centers, d)).astype(np.float32) for p in c])
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _port_of(jax_index):
    state = ivf_state_from_jax(jax_index)
    return ivf.IVFIndex.from_state(state["rows"], state, store_dtype=state["dtype"], quantized=state["quantized"], device="cpu")


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
    got = ivf.IVFIndex.build(corpus, nlist=16, seed=1, device="cpu")
    np.testing.assert_array_equal(got.perm, want.perm)
    assert got.capacity == want.capacity
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=0, atol=TOL)
    queries = _queries(corpus, rng)
    _assert_same(got.search(queries, 10, nprobe=4), want.search(queries, 10, nprobe=4, impl="pallas"), "ip")
    assert set(got.build_seconds) == {"kmeans", "assign_and_upload", "placement", "layout"}


def test_build_on_device_matches_build():
    corpus = _clustered(np.random.default_rng(9))
    built = ivf.IVFIndex.build(corpus, nlist=16, seed=2, device="cpu")
    on_device = ivf.IVFIndex.build_on_device(torch.from_numpy(corpus), nlist=16, seed=2)
    np.testing.assert_array_equal(on_device.perm, built.perm)
    np.testing.assert_allclose(on_device.centroids, built.centroids, rtol=0, atol=TOL)
    assert on_device._corpus.dtype == torch.float32 and not on_device.quantized


# ---------------------------------------------------------------------------
# search, through state carried across from a JAX index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scan", ["wrapper", "plain"])
def test_search_matches_jax(metric, dtype, scan):
    """The search through kernel 7's wrapper (on CPU tensors: the plain
    version at the kernel's tile) and through the plain version at its own
    default, one whole-cluster tile a pair."""
    jax_index, corpus = _jax_index(metric, dtype, False)
    port = _port_of(jax_index)
    queries = _queries(corpus, np.random.default_rng(11))
    with contextlib.ExitStack() as stack:
        if scan == "plain":
            stack.enter_context(plain_scan(ivf_scan, "ivf_block_topk"))
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
    index = ivf.IVFIndex.build(corpus, nlist=16, metric="l2", seed=3, device="cpu")
    restored = ivf.IVFIndex.from_state(corpus, index.state(), device="cpu")
    assert restored.metric == "l2"
    np.testing.assert_array_equal(restored.search(corpus[:5], 8, nprobe=4)[1], index.search(corpus[:5], 8, nprobe=4)[1])
    with pytest.raises(ValueError, match="beyond the corpus"):
        ivf.IVFIndex.from_state(corpus[:100], index.state(), device="cpu")


# ---------------------------------------------------------------------------
# kernel 7's host contract
# ---------------------------------------------------------------------------


def _numpy_groups(probe_ids, nlist, bq):
    """The work list by a numpy walk, independent of the port's code:
    the pairs sorted stably by cluster (ids below 0 first, at or past nlist
    last, in no group), each cluster's run cut into groups of ``bq``.
    Returns ``(groups [n, 3]: cluster, first sorted position, size;
    order)``."""
    key = np.asarray(probe_ids, np.int64).reshape(-1)
    order = np.argsort(key, kind="stable")
    live = (key >= 0) & (key < nlist)
    counts = np.bincount(key[live], minlength=nlist)
    start = (key < 0).sum() + np.cumsum(counts) - counts  # each cluster's first sorted position
    per_cluster = -(-counts // bq)
    cluster = np.repeat(np.arange(nlist), per_cluster)
    local = np.arange(cluster.size) - (np.cumsum(per_cluster) - per_cluster)[cluster]
    first = start[cluster] + local * bq
    size = np.minimum(bq, counts[cluster] - local * bq)
    return np.stack([cluster, first, size], axis=1).astype(np.int32), order


def _emulate_kernel(corpus, queries, probe_ids, row_valid, k, lrows, block_n, bq=8):
    """Kernel 7's walk over the work list the port builds
    (``ivf_work_list``, here on CPU tensors), in numpy: one (group, tile) at
    a time, each pair of the group scored against the tile and its top-kk
    written to its own partial slot; pairs in no group stay empty."""
    nlist = corpus.shape[0] // lrows
    groups, order, _ = ivf_scan.ivf_work_list(torch.from_numpy(probe_ids.astype(np.int32)), nlist, bq)
    groups, order = groups.numpy(), order.numpy()
    nq, nprobe = probe_ids.shape
    tiles, kk = -(-lrows // block_n), min(k, block_n)
    out_v = np.full((nq, nprobe, tiles, kk), -np.inf, np.float32)
    out_i = np.full((nq, nprobe, tiles, kk), _INT_MAX, np.int32)
    seen = np.zeros((nq, nprobe), int)
    for cluster, first, size in groups:
        if size == 0:  # past the group count: the CTA leaves
            assert cluster == -1
            continue
        assert 1 <= size <= bq
        for t in range(tiles):
            lo = cluster * lrows + t * block_n
            hi = min(lo + block_n, (cluster + 1) * lrows)
            for pair in order[first: first + size]:
                q, j = divmod(int(pair), nprobe)
                assert probe_ids[q, j] == cluster
                seen[q, j] += t == 0
                s = np.where(row_valid[lo:hi] > 0, corpus[lo:hi] @ queries[q], -np.inf).astype(np.float32)
                best = np.argsort(-s, kind="stable")[:kk]
                out_v[q, j, t, : best.size] = s[best]
                out_i[q, j, t, : best.size] = np.where(np.isneginf(s[best]), _INT_MAX, lo + best)
    live = (probe_ids >= 0) & (probe_ids < nlist)
    np.testing.assert_array_equal(seen, live.astype(int))  # every live pair in exactly one group, no other
    return out_v, out_i


@pytest.mark.parametrize("nq,nprobe", [(1, 3), (9, 4), (40, 8), (7, 5)])
def test_probe_groups_emulated_walk_matches_the_plain_version(nq, nprobe):
    """The walk over the work list built from these probes (the last case
    with ids past the layout and below 0) gives the plain version's
    partials, at a ragged tile and at the default geometry."""
    rng = np.random.default_rng(22)
    nlist, lrows = 8, 48
    corpus = unit_rows(rng, nlist * lrows, 16)
    corpus[100:110] = corpus[5]  # duplicate slots: ties to the smallest slot
    row_valid = (rng.random(nlist * lrows) < 0.8).astype(np.int8)
    probe_ids = np.sort(np.stack([rng.choice(nlist, nprobe, replace=False) for _ in range(nq)]), axis=1)
    if nq == 7:
        probe_ids[2, 1], probe_ids[4, 0], probe_ids[5, 4] = nlist, -1, nlist + 9
    queries = unit_rows(rng, nq, 16)
    queries[0] = corpus[5]
    args = (torch.from_numpy(corpus), torch.from_numpy(queries), torch.from_numpy(probe_ids.astype(np.int32)),
            torch.from_numpy(row_valid))
    for k, block_n in ((1, 32), (12, 32), (100, 32), (12, None)):  # 32: a ragged last tile of 16 slots
        got = ivf_scan.ivf_block_topk(*args, k, lrows=lrows, block_n=block_n)
        bn = ivf_scan.ivf_launch(args[0], args[2], lrows, k, block_n)[1]
        want = _emulate_kernel(corpus, queries, probe_ids, row_valid, k, lrows, bn)
        assert_topk_match(*got, *want, tol=TOL)


@pytest.mark.parametrize("case", ["spread", "crowded", "overflow", "outside", "long"])
def test_probe_groups_pick_the_group_size(case):
    """The work list the port builds (on CPU tensors) is the numpy walk's,
    group for group and pair for pair, with (-1, 0, 0) past the group
    count: one query over 64 clusters; 12 queries on each of 4 clusters (a
    group each); 70 queries on 2 clusters (groups of 32, 32 and 6); ids
    outside the layout in no group; a long run of pairs cut across the
    work kernel's threads."""
    rng = np.random.default_rng(23)
    probe_ids, nlist, bq = {
        "spread": (np.arange(64, dtype=np.int32).reshape(1, 64), 64, 8),
        "crowded": (np.tile(np.arange(4, dtype=np.int32), (12, 1)), 4, 32),
        "overflow": (np.tile(np.arange(2, dtype=np.int32), (70, 1)), 2, 32),
        "outside": (np.array([[4, 0], [-1, 1], [2, 9], [0, 4]], np.int32), 4, 8),
        "long": (np.sort(rng.integers(0, 5, size=(3000, 2)), axis=1).astype(np.int32), 5, 32),
    }[case]
    groups, order, sorted_ids = ivf_scan.ivf_work_list(torch.from_numpy(probe_ids), nlist, bq)
    want, want_order = _numpy_groups(probe_ids, nlist, bq)
    n = want.shape[0]
    assert groups.shape == (ivf_scan.ivf_group_bound(*probe_ids.shape, nlist, bq), 3) and groups.dtype == torch.int32
    np.testing.assert_array_equal(groups[:n].numpy(), want)
    assert (groups[n:] == torch.tensor([-1, 0, 0], dtype=torch.int32)).all()
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(sorted_ids.numpy(), probe_ids.reshape(-1)[want_order])
    if case == "crowded":
        assert groups[:n, 2].tolist() == [12, 12, 12, 12]
    if case == "overflow":
        assert groups[:n, 0].tolist() == [0, 0, 0, 1, 1, 1] and groups[:n, 2].tolist() == [32, 32, 6] * 2
    if case == "outside":  # the pairs of ids 4, -1 and 9 are in no group
        covered = [int(pair) for _, first, size in groups[:n].tolist() for pair in order[first: first + size]]
        assert sorted(covered) == [1, 3, 4, 6]


@pytest.mark.parametrize("bq", ivf_scan.IVF_BQ)
@pytest.mark.parametrize("nq,nprobe,nlist", [(1, 64, 1024), (5, 7, 7), (70, 2, 2), (33, 16, 64), (200, 64, 64)])
def test_group_count_never_exceeds_the_bound(bq, nq, nprobe, nlist):
    """Every query on the same clusters (the fewest distinct clusters, the
    fullest groups) and every pair on its own cluster where nlist allows
    (the most partial groups): the groups never outnumber
    ``ivf_group_bound``, which the grid is sized by; at batch 1 of 64
    distinct probes with groups of 8 the bound is the count, 64."""
    rng = np.random.default_rng(24)
    same = np.tile(np.arange(nprobe, dtype=np.int32), (nq, 1))
    spread = (np.arange(nq * nprobe, dtype=np.int32) % nlist).reshape(nq, nprobe)
    shuffled = np.sort(np.stack([rng.permutation(nlist)[:nprobe] for _ in range(nq)]), axis=1).astype(np.int32)
    bound = ivf_scan.ivf_group_bound(nq, nprobe, nlist, bq)
    for probes in (same, spread, shuffled):
        groups, _, _ = ivf_scan.ivf_work_list(torch.from_numpy(probes), nlist, bq)
        live = int((groups[:, 2] > 0).sum())
        assert 0 < live <= bound == groups.shape[0]
        assert int(groups[:, 2].sum()) == nq * nprobe  # every pair in a group
    if (nq, nprobe, nlist, bq) == (1, 64, 1024, 8):
        assert bound == 64 == live


def test_group_size_and_tile_rule_read_no_probe_ids():
    """``ivf_geometry`` takes shapes only (no probe id, so no read-back):
    at nlist 1024, L 1536 and nprobe 64, the ivf phase's index, batches 1
    and 8 take groups of 8 and three tiles of 512 slots a cluster (64 or
    ~420 groups: too few CTAs for four waves), batches 32 and 128 two
    tiles, groups of 8 up to 8 queries per probed cluster, batch 256 (16 a
    cluster) groups of 32 — the sweep's fastest settings, each within 1.3 %
    (PERF.md); the f32 ring (``fma_ring``) tiles by the same rule over the
    CTAs its shared memory lets an SM hold; the FMA loop keeps its
    256-slot tile."""
    assert list(inspect.signature(ivf_scan.ivf_geometry).parameters) == [
        "nq", "nprobe", "nlist", "lrows", "loop", "sm_count"]
    geo = {q: ivf_scan.ivf_geometry(q, 64, 1024, 1536, "tensor_core") for q in (1, 8, 32, 128, 256)}
    assert geo == {1: (512, 8), 8: (512, 8), 32: (768, 8), 128: (768, 8), 256: (768, 32)}
    assert ivf_scan.ivf_geometry(256, 64, 1024, 1536, "fma") == (ivf_scan.IVF_FMA_BLOCK_N, 32)
    # the f32 ring holds one CTA an SM at groups of 32: half the slots, so whole clusters at batch 256
    assert {q: ivf_scan.ivf_geometry(q, 64, 1024, 1536, "fma_ring") for q in (1, 8, 32, 128, 256)} == {
        **geo, 256: (1536, 32)}
    assert ivf_scan.ivf_geometry(2048, 64, 1024, 1536, "tensor_core") == (1536, 32)  # many groups: whole clusters
    assert ivf_scan.ivf_geometry(1, 8, 24, 384, "tensor_core") == (128, 8)  # few groups: three tiles
    assert ivf_scan.ivf_geometry(1, 8, 24, 384, "tensor_core", sm_count=1) == (384, 8)
    with pytest.raises(ValueError, match="loop"):
        ivf_scan.ivf_geometry(1, 8, 24, 384, "dp4a")
    bf16 = torch.zeros((4, 1536), dtype=torch.bfloat16)
    assert ivf_scan.ivf_scoring_loop(bf16, 64) == "tensor_core" and ivf_scan.ivf_scoring_loop(bf16, 65) == "fma"
    assert ivf_scan.ivf_scoring_loop(torch.zeros((4, 1001), dtype=torch.bfloat16), 10) == "fma"
    assert ivf_scan.ivf_scoring_loop(torch.zeros((4, 1536), dtype=torch.int8), 64) == "tensor_core"
    assert ivf_scan.ivf_scoring_loop(torch.zeros((4, 1000), dtype=torch.int8), 10) == "fma"
    f32 = torch.zeros((4, 1536))
    assert ivf_scan.ivf_scoring_loop(f32, 64) == "fma_ring" and ivf_scan.ivf_scoring_loop(f32, 65) == "fma"
    assert ivf_scan.ivf_scoring_loop(torch.zeros((4, 1000)), 10) == "fma_ring"
    assert ivf_scan.ivf_scoring_loop(torch.zeros((4, 1002)), 10) == "fma"


def test_probe_ids_outside_the_layout_match_no_slot(monkeypatch):
    """The JAX probe matrix (``ivf.py:900-902``, ``row.at[ids].set(1)``)
    drops an id at or past nlist and wraps a negative one to ``nlist +
    id``.  The port matches no slot for either (kernel and plain version,
    so nothing outside the layout is read): the same as JAX for ids past
    nlist, a recorded difference for negative ones."""
    import jax
    import jax.numpy as jnp

    jax_index, corpus = _jax_index("ip", "float32", False)
    nlist = jax_index.nlist
    ids = np.array([[3, nlist, nlist + 5, -1]], np.int32)
    monkeypatch.setattr(jax.lax, "top_k", lambda scores, k: (scores[:, :k], jnp.asarray(ids)))
    width = jax_index._centroids_dev.shape[1]  # the JAX index pads D to its lane width
    probe_matrix = np.asarray(jax_index._probe(jnp.asarray(np.pad(corpus[:1], ((0, 0), (0, width - D)))), 4)[0])
    assert probe_matrix[0, 3] == 1 and probe_matrix[0, nlist - 1] == 1 and probe_matrix.sum() == 2
    port = _port_of(jax_index)
    q = torch.from_numpy(corpus[:1])
    vals, slots = ivf_scan.ivf_block_topk_plain(port._corpus, q, torch.from_numpy(ids), port._row_valid, 5,
                                                lrows=port.capacity)
    assert torch.isfinite(vals[0, 0]).any()  # cluster 3 is scanned
    assert torch.isneginf(vals[0, 1:]).all() and (slots[0, 1:] == _INT_MAX).all()
    groups, order, _ = ivf_scan.ivf_work_list(torch.from_numpy(ids), nlist, 8)
    assert groups[0].tolist() == [3, int(torch.nonzero(order == 0)[0, 0]), 1] and groups[1:, 2].sum() == 0


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
    # the plain version's default tile is the whole cluster: one list a pair
    whole = ivf_scan.ivf_block_topk_plain(corpus, corpus[lrows + 3 : lrows + 4], probes, row_valid, 40, lrows=lrows)
    assert whole[1].shape == (1, 2, 1, 32)
    c8, cs = quantize_rows(corpus)
    q8, qs = ivf_scan.quantize_ivf_queries(corpus[:1])
    vals, slots = ivf_scan.ivf_block_topk(c8, q8, probes, row_valid, 3, lrows=lrows, qscales=qs, cscales=cs,
                                          block_n=16)
    s = int(slots[0, 0, 0, 0])
    dot = float((q8[0].double() @ c8[s].double()))
    assert float(vals[0, 0, 0, 0]) == float(torch.tensor(dot, dtype=torch.float32) * qs[0] * cs[s])

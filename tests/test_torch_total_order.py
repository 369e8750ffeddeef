"""``lax.top_k``'s order in the port: ``ops/topk.total_order_topk`` and the
sites whose JAX counterpart is a ``lax.top_k``.

``lax.top_k`` orders by IEEE totalOrder: +NaN, +inf, ..., +0.0, -0.0,
..., -inf, -NaN, ties of identical bits to the smallest position.  The
helper is held to it on signed zeros, signed NaNs, infinities and
subnormals, on seeded arrays full of exact zeros, and on hypothesis'
floats (a derandomized profile).

Each site is then held to its JAX counterpart on inputs whose k-th place
is a tie of +0.0 and -0.0 (where a stable float sort ties them by
position):

* phase B, ``merge_partials`` (JAX ``topk.py:458-463``, grouped
  ``grouped_mask.py:270-275``), and ``rescore_pool``'s two top-ks (JAX
  ``quantized.py:311-336``): those lines run inside the Pallas impls, whose
  kernels pad D to 128 lanes, so no padded product keeps a -0.0; the test
  gives both sides the same partials and exact scores and runs the JAX
  lines (``lax.top_k``, ``take_along_axis``) as written there;
* ``plain_topk`` through ``exact_search_plain`` (the large-k path of
  ``/search_photos``) and ``grouped_mask_plain``, against
  ``exact_search_oracle`` and ``grouped_mask_oracle``; ``merge_shards``
  against JAX's ``parallel/sharded._merge_partials`` (under ``vmap`` with
  the mesh axis name); ``_assign_chunk`` against JAX's ``_assign_chunk``:
  on one-dimensional rows, where a score is one product and both libraries
  keep its sign (a dot over more lanes starts from +0.0 in both);
* the IVF probes (``IVFIndex._probe``, ``ShardedIVFIndex.probe``) against
  the JAX search's stage 1 (``models/ivf.py:883-898``: ``2 s - |c|^2``,
  then ``lax.top_k``) on the same one-dimensional centroids.

The sites that follow a Pallas kernel's float comparison (the plain block
partials, kernel 4's range merge, the plain kernel 7 tile) keep ties by
position; a case pins that order.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from photo_search_engine_tpu.models import ivf as jivf
from photo_search_engine_tpu.ops import grouped_mask as jgm
from photo_search_engine_tpu.ops import topk as jtopk
from photo_search_engine_tpu.parallel import sharded as jsharded
from photo_search_engine_tpu_torch.models import ivf as tivf
from photo_search_engine_tpu_torch.ops import grouped_mask as tgm
from photo_search_engine_tpu_torch.ops import ivf_scan as tivf_scan
from photo_search_engine_tpu_torch.ops import topk as ttopk
from photo_search_engine_tpu_torch.parallel import sharded as tsharded
from photo_search_engine_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

NAN = np.float32(np.nan)
NEG_NAN = np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0]
TINY = np.float32(1e-45)  # the smallest subnormal


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _lax(values, k):
    vals, idx = jax.lax.top_k(jnp.asarray(values), k)
    return np.asarray(vals), np.asarray(idx)


def _assert_same_order(got, want):
    """Indices equal; values equal bit for bit, NaN payloads aside."""
    (gv, gi), (wv, wi) = [(np.asarray(v), np.asarray(i)) for v, i in (got, want)]
    np.testing.assert_array_equal(gi, wi)
    nan = np.isnan(wv)
    np.testing.assert_array_equal(np.isnan(gv), nan)
    np.testing.assert_array_equal(np.signbit(gv), np.signbit(wv))
    np.testing.assert_array_equal(_bits(gv)[~nan], _bits(wv)[~nan])


SPECIAL = {
    "signed_zeros": [-0.0, 0.0, -0.0, 0.0, 0.5, -0.0],
    "nans_and_subnormals": [NAN, 1.0, NEG_NAN, 0.0, -0.0, TINY, -TINY, -np.inf],
    "infinities": [-np.inf, np.inf, 0.0, -np.inf, np.inf, -0.0, 3.0, -3.0],
    "subnormal_ladder": [-TINY, 0.0, TINY, -0.0, 2 * TINY, np.float32(1.17549435e-38), -2 * TINY, -0.0],
    "all_negative_zero": [-0.0] * 7,
}


@pytest.mark.parametrize("case", sorted(SPECIAL))
def test_helper_matches_lax_top_k_on_special_values(case):
    values = np.array([SPECIAL[case], SPECIAL[case][::-1]], np.float32)
    for k in range(1, values.shape[1] + 1):
        _assert_same_order(ttopk.total_order_topk(torch.from_numpy(values), k), _lax(values, k))


def test_helper_matches_the_examples_checked_against_jax():
    """The two orders the repo's JAX gives (checked on the CPU)."""
    x = torch.tensor([-0.0, 0.0, -0.0, 0.0, 0.5, -0.0])
    assert ttopk.total_order_topk(x, 6)[1].tolist() == [4, 1, 3, 0, 2, 5]
    assert ttopk.stable_topk(x, 6)[1].tolist() == [4, 0, 1, 2, 3, 5]
    x = torch.from_numpy(np.array([NAN, 1, NEG_NAN, 0, -0.0, TINY, -TINY, -np.inf], np.float32))
    assert ttopk.total_order_topk(x, 8)[1].tolist() == [0, 1, 5, 3, 4, 6, 7, 2]


@pytest.mark.parametrize("seed", range(6))
def test_helper_matches_lax_top_k_on_exact_zeros(seed):
    """Seeded [4, 97] arrays drawn mostly from ±0.0 with a few ±0.5, ±inf
    and subnormals: long runs of ties at every k."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, 0.0, -0.0, 0.5, -0.5, TINY, -TINY, np.inf, -np.inf], np.float32)
    values = pool[rng.integers(0, pool.size, size=(4, 97))]
    for k in (1, 2, 7, 50, 97):
        _assert_same_order(ttopk.total_order_topk(torch.from_numpy(values), k), _lax(values, k))


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.lists(st.floats(width=32, allow_nan=True, allow_infinity=True, allow_subnormal=True),
                min_size=1, max_size=40), st.integers(1, 40))
def test_helper_matches_lax_top_k_on_hypothesis_floats(xs, k):
    values = np.array([xs], np.float32)
    k = min(k, values.shape[1])
    _assert_same_order(ttopk.total_order_topk(torch.from_numpy(values), k), _lax(values, k))


# The helper's second way, ``torch.topk`` of packed int64 keys (taken from
# TOTAL_ORDER_PACKED_MIN_ROWS rows on), held to the same order.


@pytest.mark.parametrize("case", sorted(SPECIAL))
def test_packed_keys_match_lax_top_k_on_special_values(case):
    values = np.array([SPECIAL[case], SPECIAL[case][::-1]], np.float32)
    for k in range(1, values.shape[1] + 1):
        _assert_same_order(ttopk._packed_total_order_topk(torch.from_numpy(values), k), _lax(values, k))


@pytest.mark.parametrize("seed", range(4))
def test_packed_keys_match_lax_top_k_on_exact_zeros(seed):
    rng = np.random.default_rng(100 + seed)
    pool = np.array([0.0, -0.0, 0.0, -0.0, 0.5, -0.5, TINY, -TINY, np.inf, -np.inf, NAN, NEG_NAN], np.float32)
    values = pool[rng.integers(0, pool.size, size=(40, 333))]
    for k in (1, 3, 50, 333):
        _assert_same_order(ttopk._packed_total_order_topk(torch.from_numpy(values), k), _lax(values, k))


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.lists(st.floats(width=32, allow_nan=True, allow_infinity=True, allow_subnormal=True),
                min_size=1, max_size=40), st.integers(1, 40))
def test_packed_keys_match_lax_top_k_on_hypothesis_floats(xs, k):
    values = np.array([xs, xs[::-1]], np.float32)
    k = min(k, values.shape[1])
    _assert_same_order(ttopk._packed_total_order_topk(torch.from_numpy(values), k), _lax(values, k))


def test_helper_takes_the_packed_keys_from_its_row_threshold(monkeypatch):
    """Below TOTAL_ORDER_PACKED_MIN_ROWS rows the stable sort runs, from it
    on the packed keys; one result either way, also on [Q, S, n] values."""
    calls = []
    for name in ("_sorted_total_order_topk", "_packed_total_order_topk"):
        fn = getattr(ttopk, name)
        monkeypatch.setattr(ttopk, name, lambda v, k, fn=fn, name=name: calls.append(name) or fn(v, k))
    rng = np.random.default_rng(7)
    pool = np.array([0.0, -0.0, 0.25, -0.25, TINY, -np.inf], np.float32)
    rows = ttopk.TOTAL_ORDER_PACKED_MIN_ROWS
    values = torch.from_numpy(pool[rng.integers(0, pool.size, size=(rows, 2, 61))])
    assert rows >= 2
    small = ttopk.total_order_topk(values[: rows - 1, 0], 20)
    big = ttopk.total_order_topk(values, 20)
    assert calls == ["_sorted_total_order_topk", "_packed_total_order_topk"]
    _assert_same_order(small, ttopk._packed_total_order_topk(values[: rows - 1, 0], 20))
    _assert_same_order(big, ttopk._sorted_total_order_topk(values, 20))
    _assert_same_order(big, _lax(values.numpy(), 20))


# ---------------------------------------------------------------------------
# The sites
# ---------------------------------------------------------------------------


def _tied_partials(rng, q=3, nb=5, kb=4):
    """``[Q, NB, kb]`` block partials, each block sorted by float value with
    ties by position (as the kernels write them), made of 0.5, ±0.0 and
    -inf with distinct row ids: the k-th place of most merges is a ±0.0 tie."""
    pool = np.array([0.5, 0.0, -0.0, 0.0, -0.0, -np.inf], np.float32)
    vals = pool[rng.integers(0, pool.size, size=(q, nb, kb))]
    order = np.argsort(-vals, axis=2, kind="stable")
    vals = np.take_along_axis(vals, order, axis=2)
    ids = rng.permutation(q * nb * kb).reshape(q, nb, kb).astype(np.int32)
    return vals, ids


def _jax_phase_b(vals, ids, k):
    """JAX phase B (``topk.py:458-463``; ``grouped_mask.py:270-275``)."""
    q = vals.shape[0]
    v, i = jnp.asarray(vals).reshape(q, -1), jnp.asarray(ids).reshape(q, -1)
    merged_vals, positions = jax.lax.top_k(v, k)
    return np.asarray(merged_vals), np.asarray(jnp.take_along_axis(i, positions, axis=1))


@pytest.mark.parametrize("seed", range(4))
def test_merge_partials_is_jax_phase_b(seed):
    rng = np.random.default_rng(seed)
    vals, ids = _tied_partials(rng)
    for k in (1, 3, 6, 11, 20):
        got = ttopk.merge_partials(torch.from_numpy(vals), torch.from_numpy(ids), k)
        _assert_same_order(got, _jax_phase_b(vals, ids, k))


def _jax_rescore(vals, ids, corpus_ref, queries, k, cand, metric):
    """JAX ``_int8_rescore_impl``'s tail (``quantized.py:311-336``)."""
    q = vals.shape[0]
    v, i = jnp.asarray(vals).reshape(q, -1), jnp.asarray(ids).reshape(q, -1)
    cv, pos = jax.lax.top_k(v, min(cand, v.shape[1]))
    ci = jnp.take_along_axis(i, pos, axis=1)
    live = jnp.logical_not(jnp.isneginf(cv))
    rows = jnp.take(jnp.asarray(corpus_ref), jnp.clip(ci, 0, corpus_ref.shape[0] - 1), axis=0)
    exact = jnp.einsum("qd,qcd->qc", jnp.asarray(queries), rows, preferred_element_type=jnp.float32)
    if metric == "l2":
        qn = jnp.sum(jnp.square(jnp.asarray(queries)), axis=1, keepdims=True)
        exact = -(qn + jnp.sum(jnp.square(rows), axis=2) - 2.0 * exact)
    exact = jnp.where(live, exact, -jnp.inf)
    merged_vals, order = jax.lax.top_k(exact, k)
    return np.asarray(merged_vals), np.asarray(jnp.take_along_axis(ci, order, axis=1))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_rescore_pool_is_jax_rescore(seed, metric):
    """Both top-ks: the pool cut falls inside ±0.0 ties of the quantized
    partials, and the exact scores of one-dimensional rows (one product
    each, its sign kept) tie at ±0.0 again."""
    rng = np.random.default_rng(10 + seed)
    vals, ids = _tied_partials(rng)
    n = int(ids.max()) + 1
    corpus_ref = rng.choice(np.array([0.0, -0.0, 0.25, -0.25], np.float32), size=(n, 1))
    queries = np.array([[1.0], [2.0], [0.5]], np.float32)
    for k, cand in ((1, 4), (4, 4), (5, 9), (8, 20)):
        got = ttopk.rescore_pool(torch.from_numpy(vals), torch.from_numpy(ids), torch.from_numpy(corpus_ref),
                                 torch.from_numpy(queries), k, cand=cand, metric=metric)
        _assert_same_order(got, _jax_rescore(vals, ids, corpus_ref, queries, k, cand, metric))


def _zero_rows(rng, n):
    """``n`` one-dimensional rows: ±0.0 mostly, a few ±0.5."""
    return rng.choice(np.array([0.0, -0.0, 0.0, -0.0, 0.5, -0.5], np.float32), size=(n, 1))


def _oracle_scores(corpus, queries):
    """The JAX oracles' scores: a dot over one lane, which XLA computes as
    the product itself, so each ±0.0 keeps its sign."""
    return np.asarray(jax.lax.dot_general(jnp.asarray(queries), jnp.asarray(corpus), (((1,), (1,)), ((), ())),
                                          preferred_element_type=jnp.float32))


@pytest.mark.parametrize("n", [300, 70_000])  # 70,000: the ties span the plain scan's 65,536-row chunks
@pytest.mark.parametrize("k", [1, 10, 70])
def test_plain_topk_is_the_oracle(n, k):
    """``plain_topk`` (chunk-local top-k, then the merge) on the oracle's
    own scores gives ``exact_search_oracle``'s result, ±0.0 ties included."""
    rng = np.random.default_rng(n + k)
    corpus, queries = _zero_rows(rng, n), np.array([[1.0], [3.0]], np.float32)
    scores = torch.from_numpy(_oracle_scores(corpus, queries).copy())
    got = ttopk._finalize(*ttopk.plain_topk(lambda start, stop: scores[:, start:stop], n, k), "ip")
    _assert_same_order(got, jtopk.exact_search_oracle(jnp.asarray(corpus), jnp.asarray(queries), k, metric="ip"))


@pytest.mark.parametrize("k", [1, 10, 70])
def test_exact_search_plain_is_the_oracle(k):
    """The whole plain search (the large-k path of ``/search_photos``:
    ``exact_search`` at k > 64), on rows whose product keeps its sign in
    both libraries at this shape (checked first)."""
    rng = np.random.default_rng(k)
    corpus, queries = _zero_rows(rng, 300), np.array([[1.0], [3.0]], np.float32)
    assert np.array_equal(_bits(ttopk.score_chunk(torch.from_numpy(corpus), torch.from_numpy(queries), None, "ip")),
                          _bits(_oracle_scores(corpus, queries)))
    want = jtopk.exact_search_oracle(jnp.asarray(corpus), jnp.asarray(queries), k, metric="ip")
    _assert_same_order(ttopk.exact_search_plain(torch.from_numpy(corpus), torch.from_numpy(queries), k, metric="ip"),
                       want)
    _assert_same_order(ttopk.exact_search(torch.from_numpy(corpus), torch.from_numpy(queries), k, metric="ip",
                                          impl="lax" if k <= ttopk.MAX_KERNEL_K else "auto"), want)


@pytest.mark.parametrize("k", [1, 10, 70])
def test_grouped_plain_topk_is_the_grouped_oracle(k):
    """``grouped_mask_plain``'s top-k on the grouped oracle's scores."""
    rng = np.random.default_rng(k)
    n = 400
    corpus, queries = _zero_rows(rng, n), np.array([[1.0], [2.0], [0.5]], np.float32)
    table = (rng.random((2, n)) < 0.7).astype(np.int8)
    ids = np.array([0, 1, 0], np.int32)
    scores = torch.from_numpy(np.where(table[ids] > 0, _oracle_scores(corpus, queries), -np.inf).astype(np.float32))
    got = ttopk._finalize(*ttopk.plain_topk(lambda start, stop: scores[:, start:stop], n, k), "ip")
    want = jgm.grouped_mask_oracle(jnp.asarray(corpus), jnp.asarray(queries), jnp.asarray(table),
                                   jnp.asarray(ids), k)
    _assert_same_order(got, want)
    got = tgm.grouped_mask_plain(torch.from_numpy(corpus), torch.from_numpy(queries), torch.from_numpy(table),
                                 torch.from_numpy(ids), k, count=n)
    np.testing.assert_array_equal(np.sort(got[1].numpy(), axis=1), np.sort(np.asarray(want[1]), axis=1))


@pytest.mark.parametrize("seed", range(3))
def test_merge_shards_is_jax_merge_partials(seed):
    rng = np.random.default_rng(20 + seed)
    n_shards, q, kk, k = 4, 3, 5, 7
    pool = np.array([0.5, 0.0, -0.0, 0.0, -0.0, -np.inf], np.float32)
    vals = pool[rng.integers(0, pool.size, size=(n_shards, q, kk))]
    vals = -np.sort(-vals, axis=2)
    idx = rng.permutation(n_shards * q * kk).reshape(n_shards, q, kk).astype(np.int32)
    mesh = tsharded.make_mesh(devices=["cpu"] * n_shards)
    got = tsharded.merge_shards(mesh, [torch.from_numpy(v) for v in vals], [torch.from_numpy(i) for i in idx], k)
    want = jax.vmap(lambda v, i: jsharded._merge_partials(v, i, k, "shards"), axis_name="shards")(
        jnp.asarray(vals), jnp.asarray(idx))
    _assert_same_order(got, (np.asarray(want[0][0]), np.asarray(want[1][0])))


def test_assign_chunk_is_jax_assign_chunk():
    """Top-3 centroids of ``2 x c - |c|^2``: centroids ±0.0 score ±0.0 on
    every row, and rows of x = 0 tie every centroid (the products keep
    their signs in both libraries at this shape: checked first)."""
    x = np.array([[1.0], [-1.0], [0.0], [2.0], [-0.0]], np.float32)
    cents = np.array([[-0.0], [0.0], [-0.0], [0.0], [3.0]], np.float32)
    assert np.array_equal(_bits(torch.from_numpy(x) @ torch.from_numpy(cents).T), _bits(_oracle_scores(cents, x)))
    got = tivf._assign_chunk(torch.from_numpy(x), torch.from_numpy(cents), torch.from_numpy((cents * cents)[:, 0]))
    want = jivf._assign_chunk(jnp.asarray(x), jnp.asarray(cents), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_probes(queries, cents, nprobe):
    """The JAX search's stage 1 (``models/ivf.py:883-898``), sorted as the port's probe lists are."""
    scores = jax.lax.dot_general(jnp.asarray(queries), jnp.asarray(cents), (((1,), (1,)), ((), ())),
                                 preferred_element_type=jnp.float32)
    scores = 2.0 * scores - jnp.sum(jnp.square(jnp.asarray(cents)), 1)[None, :]
    return np.sort(np.asarray(jax.lax.top_k(scores, nprobe)[1]), axis=1)


@pytest.mark.parametrize("nprobe", [1, 2, 3, 4])
def test_ivf_probes_are_jax_stage_1(nprobe):
    cents = np.array([[-0.0], [0.0], [-0.5], [-0.0], [0.0], [-1.0]], np.float32)
    queries = np.array([[1.0], [0.25], [3.0]], np.float32)
    assert np.array_equal(_bits(torch.from_numpy(queries) @ torch.from_numpy(cents).T),
                          _bits(_oracle_scores(cents, queries)))
    want = _jax_probes(queries, cents, nprobe)
    dev = torch.from_numpy(cents)
    index = types.SimpleNamespace(_centroids_dev=dev, _centroid_norms=(dev * dev).sum(dim=1), nlist=cents.shape[0])
    got = tivf.IVFIndex._probe(index, torch.from_numpy(queries), nprobe)
    np.testing.assert_array_equal(got.numpy(), want)
    sharded = types.SimpleNamespace(_cents_dev=torch.from_numpy(cents))
    np.testing.assert_array_equal(ShardedIVFIndex.probe(sharded, torch.from_numpy(queries), nprobe).numpy(), want)


def test_pallas_following_sites_keep_ties_by_position():
    """The plain block partials (JAX ``_extract_block_topk``'s ``comb ==
    m``), kernel 4's range merge (``_topk_kernel``) and the plain kernel 7
    tile compare floats: +0.0 and -0.0 tie by position there, so kernel 4
    equals kernel 1 + ``merge_partials`` except where ±0.0 ties at the
    k-th place, as in the JAX package."""
    scores = torch.tensor([[-0.0, 0.0, 0.5, -0.0, 0.0, -0.0, 0.0, -0.5]])
    v, i = ttopk.plain_block_topk(lambda start, stop: scores[:, start:stop], 8, 1, 4, 8, "cpu")
    assert i[0, 0].tolist() == [2, 0, 1, 3]  # float order: -0.0 at row 0 ahead of +0.0 at row 1
    assert ttopk.total_order_topk(scores, 4)[1][0].tolist() == [2, 1, 4, 6]  # lax.top_k's: +0.0 first
    part_v = torch.tensor([[[0.5, -0.0], [0.0, -1.0]]])
    part_i = torch.tensor([[[4, 5], [6, 7]]], dtype=torch.int32)
    assert ttopk.range_partials(part_v, part_i, 2, 2)[1][0, 0].tolist() == [4, 5]
    assert ttopk.merge_partials(part_v, part_i, 2)[1][0].tolist() == [4, 6]
    # the plain kernel 7 tile: rows -0.0 and +0.0 against a query of 1.0
    rows = torch.tensor([[-0.0], [0.0], [-0.0], [0.0]])
    _, ti = tivf_scan.ivf_block_topk_plain(rows, torch.tensor([[1.0]]), torch.tensor([[0]], dtype=torch.int32),
                                           torch.ones(4, dtype=torch.int8), 2, lrows=4)
    assert ti[0, 0, 0].tolist() == [0, 1]

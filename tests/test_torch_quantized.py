"""The port's int8 tier against the JAX package's on the same seeded inputs.

``quantize_rows`` must be bit-identical, scales included.  ``int8_search``
(kernel 2's plain version on the CPU, then the exact rescore) runs the
cases of ``tests/test_quantized.py`` beside JAX ``int8_search`` (Pallas
interpret mode): final indices equal, values within 1e-6 (the rescore is
an f32 dot of unit rows in both).

The port nominates each block's top-kloc by exact float32 comparison with
ties to the smallest row; JAX uses packed int32 keys, which order the
same except inside a ±2⁻¹³ relative window.  The nominated pool is only a
superset filter for the exact rescore, so the planted cases below (well
separated similarities) give identical results in both.

``grouped_int8_search`` (kernel 6's plain version, the same pool and
rescore) runs the cases of ``tests/test_quantized.py::GroupedInt8Test``
beside JAX ``grouped_int8_search`` (Pallas interpret mode), with the same
comparison."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photo_search_engine_tpu.ops import quantized as jq
from photo_search_engine_tpu_torch.ops import quantized as tq
from tests.torch_parity import unit_rows

K = 10


def _plant(corpus, query, slots, alphas, rng):
    d = corpus.shape[1]
    for slot, alpha in zip(slots, alphas):
        r = rng.normal(size=d)
        r -= (r @ query) * query
        r /= np.linalg.norm(r)
        corpus[slot] = alpha * query + np.sqrt(1.0 - alpha * alpha) * r


def _planted(seed=1, n=5000, d=64, q=4, admissible=None):
    rng = np.random.default_rng(seed)
    corpus = unit_rows(rng, n, d)
    queries = unit_rows(rng, q, d)
    free = rng.permutation(np.arange(n) if admissible is None else admissible)
    alphas = 0.95 - 0.03 * np.arange(K)
    for qi, query in enumerate(queries):
        _plant(corpus, query, free[qi * K : (qi + 1) * K], alphas, rng)
    return corpus.astype(np.float32), queries


def _both(corpus, queries, k, **kw):
    """(port, jax) results of int8_search on the same rows."""
    mask = kw.pop("mask", None)
    jq8, js = jq.quantize_rows(jnp.asarray(corpus))
    ref = jq.int8_search(
        jq8, js, jnp.asarray(corpus), jnp.asarray(queries), k,
        mask=None if mask is None else jnp.asarray(mask), **kw,
    )
    c = torch.from_numpy(corpus)
    tq8, ts = tq.quantize_rows(c)
    got = tq.int8_search(
        tq8, ts, c, torch.from_numpy(queries), k,
        mask=None if mask is None else torch.from_numpy(mask), **kw,
    )
    return (got[0].numpy(), got[1].numpy()), (np.asarray(ref[0]), np.asarray(ref[1]))


def _assert_same(got, ref):
    np.testing.assert_array_equal(got[1], ref[1])
    finite = np.isfinite(ref[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), finite)
    np.testing.assert_allclose(got[0][finite], ref[0][finite], rtol=0, atol=1e-6)


# -- quantize_rows ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_identical(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    x[3] = 0.0                                   # zero row: scale 0, all zeros
    x[5, :8] = [127.0, 63.5, -63.5, 0.5, 1.5, 2.5, -2.5, -127.0]  # halves round to even
    x[6] = 0.0
    x[6, 0] = 3.0e38                             # ±extremes
    x[6, 1] = -3.0e38
    x[7] *= 1e-36                                # scale below the 1e-30 clamp
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jq8, js = jq.quantize_rows(jx)
    tq8, ts = tq.quantize_rows(tx)
    assert tq8.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    assert (tq8.numpy()[3] == 0).all() and ts.numpy()[3] == 0.0


# -- int8_search --------------------------------------------------------------


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_planted_matches_jax(metric):
    corpus, queries = _planted()
    _assert_same(*_both(corpus, queries, K, metric=metric))


def test_count_excludes_tail():
    count = 3000
    corpus, queries = _planted(seed=2, admissible=np.arange(count))
    got, ref = _both(corpus, queries, K, metric="ip", count=count)
    assert (got[1] < count).all()
    _assert_same(got, ref)


def test_mask_excludes_rows():
    mask = np.zeros(5000, np.int32)
    mask[::3] = 1
    corpus, queries = _planted(seed=3, admissible=np.arange(0, 5000, 3))
    got, ref = _both(corpus, queries, K, metric="ip", mask=mask)
    assert (got[1][got[1] >= 0] % 3 == 0).all()
    _assert_same(got, ref)


def test_empty_mask_yields_empty_slots():
    corpus, queries = _planted(seed=4)
    got, ref = _both(corpus, queries, K, metric="ip", mask=np.zeros(5000, np.int32))
    assert (got[1] == -1).all() and np.isneginf(got[0]).all()
    _assert_same(got, ref)


def test_single_block_burst_k_above_16():
    rng = np.random.default_rng(57)
    k = 60
    corpus = unit_rows(rng, 5000, 64)
    query = unit_rows(rng, 1, 64)
    slots = np.arange(100, 100 + k)  # all inside the first 2048-row block
    _plant(corpus, query[0], slots, 0.98 - 0.004 * np.arange(k), rng)
    got, ref = _both(corpus, query, k)
    _assert_same(got, ref)
    np.testing.assert_array_equal(got[1][0], slots)


def test_large_k_falls_back_to_exact():
    corpus, queries = _planted(seed=5)
    _assert_same(*_both(corpus, queries, 100, metric="ip"))


def test_pool_guard_takes_exact_path():
    rng = np.random.default_rng(31)
    corpus = unit_rows(rng, 1000, 64)
    _assert_same(*_both(corpus, corpus[:2].copy(), 60, kloc=8))


def test_single_query_vector_and_empty_corpus():
    corpus, queries = _planted(seed=6)
    got, ref = _both(corpus, queries[0], 5)
    assert got[1].shape == (1, 5)
    _assert_same(got, ref)
    empty = np.zeros((0, 64), np.float32)
    got, ref = _both(empty, queries, 5)
    assert got[1].shape == ref[1].shape == (4, 0)


def test_block_partials_plain_layout():
    """Kernel 2's plain version: [Q, NB, kloc] quantized scores, ties to the
    smallest row, -inf / INT_MAX where no row is valid."""
    corpus, queries = _planted(seed=7, n=3000)
    c8, cs = tq.quantize_rows(torch.from_numpy(corpus))
    q8, qs = tq.quantize_rows(torch.from_numpy(queries))
    part_v, part_i = tq.int8_block_topk(c8, cs, q8, qs, 5, count=2100, block_n=2048)
    assert tuple(part_v.shape) == (4, 2, 5)
    assert (part_i[:, 1, :] < 2100).all() and (part_i[:, 1, :] >= 2048).all()
    assert (torch.diff(part_v, dim=-1) <= 0).all()


# -- grouped_int8_search ------------------------------------------------------


def _grouped_planted(seed=21, n=4000, d=64):
    """Three predicates (all rows / even rows / rows 1000..1999) and six
    queries, each with K planted neighbours its own predicate admits."""
    rng = np.random.default_rng(seed)
    corpus = unit_rows(rng, n, d)
    queries = unit_rows(rng, 6, d)
    table = np.zeros((3, n), np.int8)
    table[0, :] = 1
    table[1, ::2] = 1
    table[2, 1000:2000] = 1
    ids = np.array([0, 1, 2, 0, 1, 2], np.int32)
    admissible = [rng.permutation(n), rng.permutation(np.arange(0, n, 2)), rng.permutation(np.arange(1000, 2000))]
    cursor = [0, 0, 0]
    for query, m in zip(queries, ids):
        _plant(corpus, query, admissible[m][cursor[m] : cursor[m] + K], 0.95 - 0.03 * np.arange(K), rng)
        cursor[m] += K
    return corpus, queries, table, ids


def _grouped_both(corpus, queries, table, ids, k, **kw):
    """(port, jax) results of grouped_int8_search on the same rows."""
    jq8, js = jq.quantize_rows(jnp.asarray(corpus))
    ref = jq.grouped_int8_search(
        jq8, js, jnp.asarray(corpus), jnp.asarray(queries), jnp.asarray(table), jnp.asarray(ids), k, **kw
    )
    c = torch.from_numpy(corpus)
    tq8, ts = tq.quantize_rows(c)
    got = tq.grouped_int8_search(
        tq8, ts, c, torch.from_numpy(queries), torch.from_numpy(table), torch.from_numpy(ids), k, **kw
    )
    return (got[0].numpy(), got[1].numpy()), (np.asarray(ref[0]), np.asarray(ref[1]))


def test_grouped_planted_matches_jax():
    corpus, queries, table, ids = _grouped_planted()
    got, ref = _grouped_both(corpus, queries, table, ids, K)
    _assert_same(got, ref)
    assert (got[1][[1, 4]] % 2 == 0).all()
    assert ((got[1][[2, 5]] >= 1000) & (got[1][[2, 5]] < 2000)).all()


def test_grouped_empty_predicate_and_count():
    corpus, queries, _, _ = _grouped_planted(seed=22)
    table = np.zeros((2, 4000), np.int8)
    table[0, :] = 1  # predicate 1 matches nothing
    got, ref = _grouped_both(corpus, queries[:2], table, np.array([0, 1], np.int32), 5, count=2000)
    assert (got[1][0] < 2000).all() and (got[1][0] >= 0).all()
    assert (got[1][1] == -1).all() and np.isneginf(got[0][1]).all()
    _assert_same(got, ref)


def test_grouped_ids_outside_the_table_match_no_row():
    corpus, queries, table, _ = _grouped_planted(seed=23)
    ids = np.array([0, 3, -1, 4, 1, 2], np.int32)
    got, ref = _grouped_both(corpus, queries, table, ids, K)
    assert (got[1][1:4] == -1).all()
    _assert_same(got, ref)


@pytest.mark.parametrize("k,kloc", [(100, None), (40, 8)])
def test_grouped_large_k_and_pool_guard_take_the_plain_path(k, kloc):
    """k above 64, and a pool (2 blocks x kloc 8) that cannot cover k=40,
    both take the exact grouped path."""
    corpus, queries, table, ids = _grouped_planted(seed=24)
    got, ref = _grouped_both(corpus, queries, table, ids, k, kloc=kloc)
    assert got[1].shape == (6, k)
    _assert_same(got, ref)


def test_grouped_block_partials_plain_equal_masked_kernel2_plain():
    """Kernel 6's plain version under one shared predicate row is kernel 2's
    plain version with that row as its mask, bit for bit."""
    corpus, queries, table, _ = _grouped_planted(seed=25, n=3000)
    c8, cs = tq.quantize_rows(torch.from_numpy(corpus))
    q8, qs = tq.quantize_rows(torch.from_numpy(queries))
    ids = torch.full((6,), 2, dtype=torch.int32)
    got = tq.int8_grouped_block_topk(c8, cs, q8, qs, torch.from_numpy(table[:, :3000]), ids, 7,
                                     count=2500, block_n=2048)
    ref = tq.int8_block_topk(c8, cs, q8, qs, 7, count=2500, mask=torch.from_numpy(table[2, :3000]), block_n=2048)
    assert tuple(got[0].shape) == (6, 2, 7)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_resolve_store_quantized():
    assert tq.resolve_store_quantized("auto") is False  # off on CUDA until an A/B says otherwise
    assert tq.resolve_store_quantized(None) is False
    assert tq.resolve_store_quantized("1") is True and tq.resolve_store_quantized(True) is True
    with pytest.raises(ValueError):
        tq.resolve_store_quantized("maybe")
    assert tq.default_block_n_int8(1536) == jq.default_block_n_int8(1536, "int8")
    assert tq.default_block_n_int8(4096) == jq.default_block_n_int8(4096, "int8")

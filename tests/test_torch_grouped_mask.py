"""The port's grouped (per-query predicate) search against the JAX package's.

The same seeded numpy inputs go to JAX ``grouped_mask_search`` (the Pallas
kernel in interpret mode, ``block_n=128, block_q=8``, as
``tests/test_grouped_mask.py`` runs it), to ``grouped_mask_oracle``, and to
the port's plain versions and ``grouped_mask_search`` (kernel 5's plain
version on the CPU).  Values agree within 1e-5 (unit rows, f32 sums in
another order); indices are equal wherever the scores around a slot differ
by more than that, and equal everywhere in the cases with planted ties.
Then the store's ``grouped_search`` and ``VectorIndex.raw_grouped_search_batch``
against the JAX store and index built from the same rows."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photo_search_engine_tpu.core.embedding_store import EmbeddingStore as JaxStore
from photo_search_engine_tpu.core.vector_index import VectorIndex as JaxIndex
from photo_search_engine_tpu.ops import grouped_mask as jg
from photo_search_engine_tpu_torch.core.convert import store_state_from_jax
from photo_search_engine_tpu_torch.core.embedding_store import EmbeddingStore
from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
from photo_search_engine_tpu_torch.ops import grouped_mask as tg
from tests.torch_parity import as_bf16_values, assert_topk_match, unit_rows

N, D = 300, 64
TOL = 1e-5


def _table(n=N):
    """Three predicates: all rows; even rows; rows 100..199."""
    table = np.zeros((3, n), np.int8)
    table[0, :] = 1
    table[1, ::2] = 1
    table[2, 100:200] = 1
    return table


def _inputs(seed, q, n=N):
    rng = np.random.default_rng(seed)
    return unit_rows(rng, n, D), unit_rows(rng, q, D)


def _jax(corpus, queries, table, ids, k, *, count=None, impl="pallas"):
    kw = dict(block_n=128, block_q=8) if impl == "pallas" else {}
    v, i = jg.grouped_mask_search(
        jnp.asarray(corpus), jnp.asarray(queries), jnp.asarray(table), jnp.asarray(ids), k,
        count=count, impl=impl, **kw,
    )
    return np.asarray(v), np.asarray(i)


def _oracle(corpus, queries, table, ids, k, *, count=None):
    v, i = jg.grouped_mask_oracle(
        jnp.asarray(corpus), jnp.asarray(queries), jnp.asarray(table), jnp.asarray(ids), k, count=count
    )
    return np.asarray(v), np.asarray(i)


def _port(corpus, queries, table, ids, k, *, count=None, dtype=torch.float32):
    c = torch.from_numpy(corpus).to(dtype)
    args = (c, torch.from_numpy(queries), torch.from_numpy(table), torch.from_numpy(ids), k)
    searched = tg.grouped_mask_search(*args, count=count, block_n=128)
    plain = tg.grouped_mask_plain(*args, count=count)
    return [(v.numpy(), i.numpy()) for v, i in (searched, plain)]


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 9])
def test_bucket_mask_table_matches_jax(m):
    table = (np.random.default_rng(m).random((m, 40)) > 0.5).astype(np.int8)
    got, ref = tg.bucket_mask_table(table), jg.bucket_mask_table(table)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("q", [1, 7, 9, 33])
def test_matches_jax_kernel_and_oracle(q):
    corpus, queries = _inputs(q, q)
    ids = (np.arange(q) % 3).astype(np.int32)
    ref = _jax(corpus, queries, _table(), ids, 7)
    oracle = _oracle(corpus, queries, jg.bucket_mask_table(_table()), ids, 7)
    for got in _port(corpus, queries, _table(), ids, 7):
        assert_topk_match(*got, *ref, tol=TOL)
        assert_topk_match(*got, *oracle, tol=TOL)
    searched = _port(corpus, queries, _table(), ids, 7)[0][1]
    for row, mask_id in zip(searched, ids):
        hits = row[row >= 0]
        assert (_table()[mask_id][hits] > 0).all()


def test_count_limit_and_bfloat16():
    corpus, queries = _inputs(3, 9)
    corpus = as_bf16_values(corpus)
    ids = (np.arange(9) % 3).astype(np.int32)
    ref = _jax(corpus.astype(jnp.bfloat16), queries, _table(), ids, 5, count=150)
    for got in _port(corpus, queries, _table(), ids, 5, count=150, dtype=torch.bfloat16):
        assert (got[1] < 150).all()
        assert_topk_match(*got, *ref, tol=TOL)


def test_empty_predicate_beside_the_all_ones_row():
    corpus, queries = _inputs(4, 4)
    table = np.zeros((2, N), np.int8)
    table[0, :] = 1  # predicate 1 matches nothing
    ids = np.array([0, 1, 0, 1], np.int32)
    ref = _jax(corpus, queries, table, ids, 5)
    for got in _port(corpus, queries, table, ids, 5):
        assert (got[1][[1, 3]] == -1).all() and np.isneginf(got[0][[1, 3]]).all()
        assert (got[1][[0, 2]] >= 0).all()
        assert_topk_match(*got, *ref, tol=TOL)


def test_ids_outside_the_table_match_no_row():
    """An id at or past M (also inside the bucket's padding) or below 0
    keeps no row, as in the JAX kernel, whose one-hot row is all zeros."""
    corpus, queries = _inputs(5, 5)
    ids = np.array([0, 3, 5, -1, 2], np.int32)
    ref = _jax(corpus, queries, _table(), ids, 6)
    for got in _port(corpus, queries, _table(), ids, 6):
        assert (got[1][1:4] == -1).all() and np.isneginf(got[0][1:4]).all()
        assert_topk_match(*got, *ref, tol=TOL)
    # ids past M agree with the oracle too; a negative id differs there
    # (jnp.take wraps it to the last row; ROADMAP.md section 3)
    oracle = _oracle(corpus, queries[:3], jg.bucket_mask_table(_table()), ids[:3], 6)
    assert_topk_match(*_port(corpus, queries[:3], _table(), ids[:3], 6)[0], *oracle, tol=TOL)
    full = np.ones((4, N), np.int8)  # M a power of two: nothing pads the wrap
    wrapped = _oracle(corpus, queries[3:4], full, ids[3:4], 6)
    assert (wrapped[1] >= 0).all()
    assert (_port(corpus, queries[3:4], full, ids[3:4], 6)[0][1] == -1).all()


def test_duplicate_rows_tie_to_the_smallest_row():
    corpus, _ = _inputs(6, 1)
    dups = [5, 127, 128, 129, 250, 299]  # across the 128-row block edges
    corpus[dups] = corpus[2]
    queries = corpus[[2, 2, 2]].copy()
    ids = np.array([0, 1, 2], np.int32)
    ref = _jax(corpus, queries, _table(), ids, 6)
    for got in _port(corpus, queries, _table(), ids, 6):
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=TOL)
    np.testing.assert_array_equal(ref[1][0], [2, 5, 127, 128, 129, 250])
    np.testing.assert_array_equal(ref[1][1][:3], [2, 128, 250])  # even rows only
    np.testing.assert_array_equal(ref[1][2][:3], [127, 128, 129])  # rows 100..199 only


@pytest.mark.parametrize("k", [65, 120, 300])
def test_large_k_takes_the_plain_path(k):
    corpus, queries = _inputs(7, 9)
    ids = (np.arange(9) % 3).astype(np.int32)
    ref = _oracle(corpus, queries, jg.bucket_mask_table(_table()), ids, min(k, N))
    for got in _port(corpus, queries, _table(), ids, k):
        assert got[1].shape == (9, min(k, N))
        assert_topk_match(*got, *ref, tol=TOL)


def test_block_partials_plain_layout():
    """Kernel 5's plain version: [Q, NB, k] inner products, only rows the
    query's predicate keeps, -inf / INT_MAX where no row is valid."""
    corpus, queries = _inputs(8, 4)
    table = torch.from_numpy(_table())
    ids = torch.tensor([1, 2, 0, 7], dtype=torch.int32)
    part_v, part_i = tg.grouped_block_topk(
        torch.from_numpy(corpus), torch.from_numpy(queries), table, ids, 5, count=280, block_n=128
    )
    assert tuple(part_v.shape) == (4, 3, 5) and part_i.dtype == torch.int32
    live = ~torch.isneginf(part_v)
    assert (part_i[live] < 280).all() and (part_i[~live] == torch.iinfo(torch.int32).max).all()
    assert (part_i[0][live[0]] % 2 == 0).all()
    assert ((part_i[1][live[1]] >= 100) & (part_i[1][live[1]] < 200)).all()
    assert not live[1, 2].any() and not live[3].any()  # block 2 holds no row of 100..199; id 7 keeps none
    assert (torch.diff(part_v[live.all(-1)], dim=-1) <= 0).all()


# -- the store and the index ----------------------------------------------------


@pytest.mark.parametrize(
    "metric,quantized,dtype",
    [("cosine", False, "float32"), ("cosine", True, "float32"), ("cosine", False, "bfloat16"),
     ("cosine", True, "bfloat16"), ("l2", False, "float32"), ("ip", False, "float32")],
)
def test_store_grouped_search_matches_jax(metric, quantized, dtype):
    rng = np.random.default_rng(11)
    corpus = unit_rows(rng, 900, D)
    corpus[300:310] = corpus[5]  # exact ties
    queries = np.concatenate([corpus[[5, 77]], unit_rows(rng, 5, D)])
    jstore = JaxStore(D, metric=metric, store_dtype=dtype, quantized=quantized)
    jstore.append(corpus[:500])
    jstore.append(corpus[500:])
    store = EmbeddingStore.from_state(store_state_from_jax(jstore), device="cpu")
    table = np.stack([np.ones(900, bool), rng.random(900) > 0.4, np.arange(900) % 7 == 0])
    ids = np.array([0, 1, 2, 1, 0, 2, 1], np.int32)
    impl = "int8" if quantized else "auto"
    for k in (10, 50, 70):
        got = store.grouped_search(queries, k, table, ids, impl=impl)
        ref = jstore.grouped_search(queries, k, table, ids, impl=impl)
        assert_topk_match(*got, np.asarray(ref[0]), np.asarray(ref[1]), tol=TOL, descending=metric != "l2")
        if dtype == "float32":
            np.testing.assert_array_equal(got[1], np.asarray(ref[1]))


def test_store_grouped_search_edges():
    store = EmbeddingStore(D, device="cpu")
    v, i = store.grouped_search(unit_rows(np.random.default_rng(0), 2, D), 3, np.ones((1, 4)), np.zeros(2))
    assert v.shape == (2, 0) and i.shape == (2, 0)
    store.append(unit_rows(np.random.default_rng(1), 4, D))
    with pytest.raises(ValueError):
        store.grouped_search(unit_rows(np.random.default_rng(2), 1, D), 3, np.ones((1, 4)), np.zeros(1),
                             impl="int8")
    v, i = store.grouped_search(unit_rows(np.random.default_rng(2), 1, D)[0], 10, np.ones((1, 4)), np.zeros(1))
    assert i.shape == (1, 4) and (i >= 0).all()


def _paths(tmp_path, name):
    return dict(index_path=str(tmp_path / f"{name}.index"), metadata_path=str(tmp_path / f"{name}-meta.json"))


@pytest.mark.parametrize("quantized", [False, True])
def test_raw_grouped_search_batch_matches_jax(tmp_path, quantized):
    rng = np.random.default_rng(3)
    rows = unit_rows(rng, 400, D)
    metas = [{"photo_path": f"/p/{i}.jpg"} for i in range(400)]
    ours = VectorIndex(D, quantized=quantized, **_paths(tmp_path, "port"), device="cpu")
    theirs = JaxIndex(D, quantized=quantized, **_paths(tmp_path, "jax"))
    assert ours.raw_grouped_search_batch(rows[:2], 3, np.ones((1, 400)), np.zeros(2))[1].shape == (2, 0)
    ours.add_batch(rows, metas)
    theirs.add_batch(rows, metas)
    table = tg.bucket_mask_table(np.stack([np.ones(400, np.int8), (np.arange(400) % 2).astype(np.int8),
                                           (np.arange(400) < 50).astype(np.int8)]))
    ids = np.array([2, 0, 1, 1, 2], np.int32)
    queries = unit_rows(rng, 5, D)
    got = ours.raw_grouped_search_batch(queries, 20, table, ids)
    ref = theirs.raw_grouped_search_batch(queries, 20, table, ids)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=TOL)
    assert ours.last_route["impl"] == ("int8_grouped" if quantized else "exact_grouped")
    assert (got[1][[0, 4]] < 50).all() and (got[1][[2, 3]] % 2 == 1).all()


def test_raw_grouped_search_batch_checks_row_ids(tmp_path):
    index = VectorIndex(D, **_paths(tmp_path, "b"), device="cpu")
    index.add_batch(unit_rows(np.random.default_rng(0), 20, D), [{"photo_path": f"/p/{i}.jpg"} for i in range(20)])
    index._store.grouped_search = lambda q, k, t, i, **kw: (np.zeros((1, k), np.float32), np.full((1, k), 20, np.int32))
    with pytest.raises(RuntimeError, match="out-of-range"):
        index.raw_grouped_search_batch(np.ones((1, D), np.float32), 3, np.ones((1, 20)), np.zeros(1))

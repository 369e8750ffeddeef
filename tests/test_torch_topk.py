"""The port's ``exact_search`` (kernel 1's plain version on the CPU) against
the JAX package's ``exact_search`` in Pallas interpret mode and its
``exact_search_oracle``, on the same seeded inputs.

Tolerances: float32 values within 1e-6 and identical indices (unit rows,
so scores differ between the two only by summation order, a few ulp);
bfloat16 values within 1e-5, indices identical wherever the scores around
the slot differ by more than 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photo_search_engine_tpu.ops import topk as jtopk
from photo_search_engine_tpu_torch.ops import topk as ttopk
from tests.torch_parity import as_bf16_values, assert_topk_match, unit_rows

N, D, Q = 300, 96, 5


def _inputs(seed=0, n=N, d=D, q=Q):
    rng = np.random.default_rng(seed)
    return unit_rows(rng, n, d), unit_rows(rng, q, d)


def _jax(corpus, queries, k, dtype, impl, **kw):
    c = jnp.asarray(corpus).astype(dtype)
    mask = kw.pop("mask", None)
    return jtopk.exact_search(
        c, jnp.asarray(queries), k, impl=impl, block_n=128, block_q=8,
        mask=None if mask is None else jnp.asarray(mask), **kw,
    )


def _port(corpus, queries, k, dtype, **kw):
    mask = kw.pop("mask", None)
    return ttopk.exact_search(
        torch.from_numpy(corpus).to(dtype), torch.from_numpy(queries), k,
        mask=None if mask is None else torch.from_numpy(mask), **kw,
    )


CASES = {
    "ip": dict(metric="ip"),
    "l2": dict(metric="l2"),
    "count": dict(metric="ip", count=123),
    "mask": dict(metric="ip", mask=(np.random.default_rng(1).random(N) > 0.5).astype(np.int32)),
    "mask_count_l2": dict(metric="l2", count=200, mask=np.tile(np.array([0, 1, 1], np.int32), N // 3)),
}


@pytest.mark.parametrize("k", [1, 10, 64, 70])
@pytest.mark.parametrize("case", sorted(CASES))
def test_float32_matches_pallas_and_oracle(case, k):
    corpus, queries = _inputs()
    kw = CASES[case]
    got_v, got_i = _port(corpus, queries, k, torch.float32, **dict(kw))
    for impl in ("pallas", "lax"):
        ref_v, ref_i = _jax(corpus, queries, k, jnp.float32, impl, **dict(kw))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i), err_msg=impl)
        np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), rtol=0, atol=1e-6, err_msg=impl)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32


@pytest.mark.parametrize("k", [1, 10, 64, 70])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_bfloat16_matches_pallas(metric, k):
    corpus, queries = _inputs(seed=2)
    corpus = as_bf16_values(corpus)
    got_v, got_i = _port(corpus, queries, k, torch.bfloat16, metric=metric)
    ref_v, ref_i = _jax(corpus, queries, k, jnp.bfloat16, "pallas", metric=metric)
    cut_v, _ = _jax(corpus, queries, k + 1, jnp.bfloat16, "lax", metric=metric)
    assert_topk_match(
        got_v.numpy(), got_i.numpy(), np.asarray(ref_v), np.asarray(ref_i),
        tol=1e-5, descending=metric != "l2", cut=np.asarray(cut_v)[:, k],
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_duplicate_rows_tie_to_smallest_index(dtype):
    corpus, queries = _inputs(seed=3)
    corpus = np.tile(corpus[:30], (10, 1))  # rows i, i+30, i+60, ... identical
    if dtype == "bfloat16":
        corpus = as_bf16_values(corpus)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    got_v, got_i = _port(corpus, corpus[[4, 17]], 12, tdt, metric="ip")
    ref_v, ref_i = _jax(corpus, corpus[[4, 17]], 12, jdt, "pallas", metric="ip")
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_i.numpy()[0, :10], 4 + 30 * np.arange(10))


def test_highly_selective_mask_fills_empty_slots():
    corpus, queries = _inputs(seed=4)
    mask = np.zeros(N, np.int32)
    mask[[7, 42, 99]] = 1
    for metric, empty in (("ip", -np.inf), ("l2", np.inf)):
        got_v, got_i = _port(corpus, queries, 10, torch.float32, metric=metric, mask=mask)
        ref_v, ref_i = _jax(corpus, queries, 10, jnp.float32, "pallas", metric=metric, mask=mask)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        assert (got_i.numpy()[:, 3:] == -1).all() and (got_v.numpy()[:, 3:] == empty).all()


def test_empty_corpus_and_k_zero_shapes():
    corpus, queries = _inputs()
    for c, k in ((corpus[:0], 5), (corpus, 0)):
        got_v, got_i = _port(c, queries, k, torch.float32)
        ref_v, ref_i = jtopk.exact_search(jnp.asarray(c), jnp.asarray(queries), k, impl="pallas")
        assert tuple(got_v.shape) == ref_v.shape and tuple(got_i.shape) == ref_i.shape


def test_single_query_vector_and_k_clamp():
    corpus, queries = _inputs()
    got_v, got_i = _port(corpus, queries[0], 3, torch.float32)
    ref_v, ref_i = _jax(corpus, queries[0], 3, jnp.float32, "pallas")
    assert tuple(got_i.shape) == (1, 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    got_v, got_i = _port(corpus[:4], queries[:1], 10, torch.float32)
    assert tuple(got_i.shape) == (1, 4)


def test_block_partials_plain_layout():
    """Kernel 1's plain version: [Q, NB, k] partials, ties to the smallest
    row, padded with -inf / INT_MAX; the stable merge gives the search."""
    corpus, queries = _inputs(seed=5)
    c, q = torch.from_numpy(corpus), torch.from_numpy(queries)
    part_v, part_i = ttopk.block_topk(c, q, 7, count=250, block_n=128)
    assert tuple(part_v.shape) == (Q, 3, 7)
    assert (part_i[:, 1, :] < 250).all()  # rows past count are never nominated
    assert (part_i[:, 2, :] == torch.iinfo(torch.int32).max).all()
    vals, idx = ttopk.merge_partials(part_v, part_i, 7)
    ref_v, ref_i = ttopk.exact_search_plain(c, q, 7, count=250, metric="ip")
    np.testing.assert_array_equal(idx.numpy(), ref_i.numpy())
    few = ttopk.block_topk(c[:130], q, 7, count=130, block_n=128)
    assert (few[0][:, 1, 2:] == -np.inf).all() and (few[1][:, 1, 2:] == torch.iinfo(torch.int32).max).all()


def test_cuda_tensor_without_kernel_raises_not_falls_back():
    """A wrapper takes the plain version only for CPU tensors: any other
    device launches the kernel or raises."""
    meta = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError):
        ttopk.block_topk(meta, meta, 1, count=8)


def test_resolve_store_dtype_and_helpers():
    assert ttopk.resolve_store_dtype("auto", "cpu") == "float32"
    assert ttopk.resolve_store_dtype("auto", "cuda") == "bfloat16"
    assert ttopk.resolve_store_dtype("BFloat16", "cpu") == "bfloat16"
    x = np.random.default_rng(6).normal(size=(4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        ttopk.l2_normalize(torch.from_numpy(x)).numpy(), np.asarray(jtopk.l2_normalize(jnp.asarray(x))), atol=1e-7
    )

"""Kernels 3 (packed-key scan) and 4 (fused running top-k) of the port
against the JAX package, on the same seeded numpy inputs.

* Packed keys: the port's ``packed_key_topk_plain`` is bit-identical to
  JAX's ``_extract_block_topk_fast`` on the same score tile (``-inf``,
  ±0, negative, subnormal and duplicate scores; 10 and 11 lane bits).
* ``exact_search(impl="pallas_fast" | "pallas_fused")`` and
  ``grouped_mask_search(impl="pallas_fast")``, kernel 3's and kernel 4's
  plain versions on the CPU, against the JAX functions in Pallas interpret
  mode (``block_n=128, block_q=8``, as ``tests/test_topk.py`` runs them):
  identical indices, values within 1e-5, the tolerance of that test (f32
  sums in another order).  Where rows are planted as exact duplicates,
  JAX's rescore einsum on the CPU can give two copies scores one ulp apart
  (the tail of its vector loop), and so another order among them: there
  the indices agree wherever the scores around a slot differ by more than
  1e-5, and the port's equal scores keep ascending row ids.
* The store's ``search`` / ``grouped_search`` with every ``impl`` against
  the JAX store built from the same rows; an unknown ``impl`` raises.
No assertion depends on wall-clock time."""

import glob
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photo_search_engine_tpu.core.embedding_store import EmbeddingStore as JaxStore
from photo_search_engine_tpu.ops import grouped_mask as jg
from photo_search_engine_tpu.ops import topk as jtopk
from photo_search_engine_tpu_torch.core.convert import store_state_from_jax
from photo_search_engine_tpu_torch.core.embedding_store import EmbeddingStore
from photo_search_engine_tpu_torch.ops import _cuda
from photo_search_engine_tpu_torch.ops import grouped_mask as tg
from photo_search_engine_tpu_torch.ops import topk as ttopk
from tests.torch_parity import as_bf16_values, assert_topk_match, unit_rows

N, D, Q = 300, 96, 5
TOL = 1e-5
INT_MAX = np.iinfo(np.int32).max
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


# ---------------------------------------------------------------------------
# packed keys
# ---------------------------------------------------------------------------


def _score_tile(rng, rows, bn):
    """Scores with every edge the key mapping has to keep in order."""
    tile = rng.normal(size=(rows, bn)).astype(np.float32)
    tile[:, ::7] = -np.inf
    tile[0, 1:5] = [0.0, -0.0, 0.0, -0.0]
    tile[1, 1:6] = np.array([1e-40, -1e-40, 1e-42, -3e-39, 1.17e-38], np.float32)  # subnormal
    tile[2, 3:12] = tile[2, 2]  # duplicates: ties go to the smallest lane
    tile[3, :] = -np.inf  # nothing valid: every slot decodes to -inf
    tile[4, 10:20] = -np.abs(tile[4, 10:20])
    return tile


@pytest.mark.parametrize("bn", [128, 1024, 2048])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_packed_keys_bit_identical_to_jax(bn, k):
    tile = _score_tile(np.random.default_rng(bn + k), 6, bn)
    col_base = 3 * bn
    kp = -(-k // 128) * 128
    ref_v, ref_i = jtopk._extract_block_topk_fast(jnp.asarray(tile), col_base, k, kp, tile.shape[0], bn)
    got_v, got_i = ttopk.packed_key_topk_plain(torch.from_numpy(tile), col_base, k)
    np.testing.assert_array_equal(got_v.numpy().view(np.int32), np.asarray(ref_v)[:, :k].view(np.int32))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i)[:, :k])
    assert got_i.dtype == torch.int32


def test_packed_keys_lane_bits_and_bounds():
    tile = torch.zeros((1, 2048))
    tile[0, 2047] = 1.0
    v, i = ttopk.packed_key_topk_plain(tile, 0, 2)
    assert i.tolist() == [[2047, 0]] and v[0, 0] >= 1.0  # quantized upward
    with pytest.raises(ValueError):
        ttopk.packed_key_topk_plain(torch.zeros((1, 4096)), 0, 1)
    with pytest.raises(ValueError):
        ttopk.packed_key_topk_plain(torch.zeros((1, 128)), 0, 129)


# ---------------------------------------------------------------------------
# exact_search: kernels 3 and 4
# ---------------------------------------------------------------------------


def _inputs(seed=0, n=N, d=D, q=Q):
    rng = np.random.default_rng(seed)
    return unit_rows(rng, n, d), unit_rows(rng, q, d)


def _jax(corpus, queries, k, jdt, impl, **kw):
    mask = kw.pop("mask", None)
    return jtopk.exact_search(
        jnp.asarray(corpus).astype(jdt), jnp.asarray(queries), k, impl=impl, block_n=128, block_q=8,
        mask=None if mask is None else jnp.asarray(mask), **kw,
    )


def _port(corpus, queries, k, tdt, impl, **kw):
    mask = kw.pop("mask", None)
    return ttopk.exact_search(
        torch.from_numpy(corpus).to(tdt), torch.from_numpy(queries), k, impl=impl, block_n=128,
        mask=None if mask is None else torch.from_numpy(mask), **kw,
    )


CASES = {
    "ip": dict(metric="ip"),
    "l2": dict(metric="l2"),
    "count": dict(metric="ip", count=123),
    "mask": dict(metric="ip", mask=(np.random.default_rng(1).random(N) > 0.5).astype(np.int32)),
    "mask_count_l2": dict(metric="l2", count=200, mask=np.tile(np.array([0, 1, 1], np.int32), N // 3)),
}


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, ref, *, ties=False, descending=True):
    got_v, got_i = _host(got[0]), _host(got[1])
    assert got_v.dtype == np.float32 and got_i.dtype == np.int32
    if not ties:
        np.testing.assert_array_equal(got_i, _host(ref[1]))
        np.testing.assert_allclose(got_v, _host(ref[0]), rtol=0, atol=TOL)
        return
    assert_topk_match(got_v, got_i, _host(ref[0]), _host(ref[1]), tol=TOL, descending=descending)
    same = (got_v[:, 1:] == got_v[:, :-1]) & np.isfinite(got_v[:, 1:])
    assert (got_i[:, 1:][same] > got_i[:, :-1][same]).all()  # equal scores: ascending rows


@pytest.mark.parametrize("impl", ["pallas_fast", "pallas_fused"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_search_matches_jax(case, k, dtype, impl):
    corpus, queries = _inputs(seed=k)
    tdt, jdt = DTYPES[dtype]
    if dtype == "bfloat16":
        corpus = as_bf16_values(corpus)
    got = _port(corpus, queries, k, tdt, impl, **dict(CASES[case]))
    ref = _jax(corpus, queries, k, jdt, impl, **dict(CASES[case]))
    _assert_same(got, ref)


@pytest.mark.parametrize("impl", ["pallas_fast", "pallas_fused"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_duplicate_rows_tie_to_smallest_index(dtype, impl):
    corpus, _ = _inputs(seed=3)
    corpus = np.tile(corpus[:30], (10, 1))  # rows i, i+30, i+60, ... identical
    tdt, jdt = DTYPES[dtype]
    if dtype == "bfloat16":
        corpus = as_bf16_values(corpus)
    got = _port(corpus, corpus[[4, 17]], 12, tdt, impl, metric="ip")
    _assert_same(got, _jax(corpus, corpus[[4, 17]], 12, jdt, impl, metric="ip"), ties=True)
    np.testing.assert_array_equal(got[1].numpy()[0, :10], 4 + 30 * np.arange(10))


@pytest.mark.parametrize("impl", ["pallas_fast", "pallas_fused"])
def test_selective_mask_fills_empty_slots(impl):
    corpus, queries = _inputs(seed=4)
    mask = np.zeros(N, np.int32)
    mask[[7, 42, 299]] = 1
    for metric, empty in (("ip", -np.inf), ("l2", np.inf)):
        got = _port(corpus, queries, 10, torch.float32, impl, metric=metric, mask=mask)
        _assert_same(got, _jax(corpus, queries, 10, jnp.float32, impl, metric=metric, mask=mask))
        assert (got[1].numpy()[:, 3:] == -1).all() and (got[0].numpy()[:, 3:] == empty).all()


def test_large_k_and_lax_take_the_plain_search():
    corpus, queries = _inputs(seed=6)
    c, q = torch.from_numpy(corpus), torch.from_numpy(queries)
    want = ttopk.exact_search_plain(c, q, 70, metric="ip")
    for impl in ttopk.IMPLS:
        got = ttopk.exact_search(c, q, 70, metric="ip", impl=impl)
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    lax = ttopk.exact_search(c, q, 10, metric="l2", impl="lax", count=150)
    ref = _jax(corpus, queries, 10, jnp.float32, "lax", metric="l2", count=150)
    _assert_same(lax, ref)


@pytest.mark.parametrize("impl", ["int8", "pallas_fused ", "fast", ""])
def test_unknown_impl_raises(impl):
    corpus, queries = _inputs()
    with pytest.raises(ValueError, match="impl"):
        ttopk.exact_search(torch.from_numpy(corpus), torch.from_numpy(queries), 5, impl=impl)
    table = torch.ones((1, N), dtype=torch.int8)
    with pytest.raises(ValueError, match="impl"):
        tg.grouped_mask_search(torch.from_numpy(corpus), torch.from_numpy(queries), table,
                               torch.zeros(Q, dtype=torch.int32), 5, impl=impl)


def test_fast_partials_hold_the_quantized_scores():
    """Kernel 3's plain partials: kernel 1's scores through the packed keys
    of each block, so every value is the window top of the exact score and
    every live id is the exact partial's."""
    corpus, queries = _inputs(seed=7)
    c, q = torch.from_numpy(corpus), torch.from_numpy(queries)
    fast_v, fast_i = ttopk.fast_block_topk(c, q, 8, count=250, block_n=128)
    exact_v, exact_i = ttopk.block_topk(c, q, 8, count=250, block_n=128)
    assert fast_v.shape == exact_v.shape == (Q, 3, 8)
    live = torch.isfinite(exact_v)
    assert (fast_v[live] >= exact_v[live]).all()
    assert ((fast_v[live] - exact_v[live]) <= exact_v[live].abs() * 2.0**-12).all()
    assert torch.isneginf(fast_v[~live]).all()
    # the -inf slots of the last block carry the columns their keys decode to
    assert (fast_i[:, 2, :] >= 256).all() and (fast_i[:, 2, :] < 384).all()


@pytest.mark.parametrize("blocks_per_range", [1, 2, 3])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_fused_partials_and_merge(metric, blocks_per_range):
    """Kernel 4's plain version: each range's top-k of kernel 1's block
    partials, and the merge of the ranges is kernel 1's search."""
    corpus, queries = _inputs(seed=8, n=700)
    c, q = torch.from_numpy(corpus), torch.from_numpy(queries)
    cnorms = ttopk.row_sq_norms(c) if metric == "l2" else None
    vals, idx, part_v, part_i = ttopk.fused_topk(c, q, 20, count=650, metric=metric, cnorms=cnorms,
                                                 block_n=128, blocks_per_range=blocks_per_range)
    ranges = -(-6 // blocks_per_range)
    assert part_v.shape == part_i.shape == (Q, ranges, 20)
    ref_v, ref_i = ttopk.merge_partials(*ttopk.block_topk(c, q, 20, count=650, metric=metric, cnorms=cnorms,
                                                          block_n=128), 20)
    np.testing.assert_array_equal(idx.numpy(), ref_i.numpy())
    np.testing.assert_array_equal(vals.numpy(), ref_v.numpy())
    for r in range(ranges):
        lo, hi = 128 * blocks_per_range * r, min(650, 128 * blocks_per_range * (r + 1))
        live = part_i[:, r, :] != INT_MAX
        assert ((part_i[:, r, :][live] >= lo) & (part_i[:, r, :][live] < hi)).all()
        assert live.sum(dim=1).tolist() == [min(20, hi - lo)] * Q


def test_fused_ranges_fill_the_card():
    assert ttopk.fused_ranges(1, 978, loop="fma") == (326, 3)  # 3 CTAs of 70 KB per SM: 396 wanted
    assert ttopk.fused_ranges(128, 978, loop="fma") == (66, 15)  # one 184 KB CTA per SM, at least 2: 4 query tiles
    assert ttopk.fused_ranges(9, 978, block_n=2048, loop="fma") == (245, 4)  # no CTA fits (kernel refuses): 2 per SM
    assert ttopk.fused_ranges(1, 3, loop="fma") == (3, 1)
    for nq, nb in ((1, 978), (128, 978), (256, 10), (9, 1)):
        ranges, per = ttopk.fused_ranges(nq, nb, loop="fma")
        assert (ranges - 1) * per < nb <= ranges * per  # no empty range


# ---------------------------------------------------------------------------
# grouped_mask_search(impl="pallas_fast")
# ---------------------------------------------------------------------------


def _table(n=N):
    """Three predicates: all rows; even rows; rows 100..199."""
    table = np.zeros((3, n), np.int8)
    table[0, :] = 1
    table[1, ::2] = 1
    table[2, 100:200] = 1
    return table


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("count", [None, 150])
def test_grouped_fast_matches_jax(count, k, dtype):
    corpus, queries = _inputs(seed=9 + k, d=64, q=7)
    tdt, jdt = DTYPES[dtype]
    if dtype == "bfloat16":
        corpus = as_bf16_values(corpus)
    corpus[250:260] = corpus[3]  # exact ties across blocks
    queries[0] = corpus[3]
    ids = np.array([0, 1, 2, 1, 0, 2, 1], np.int32)
    ref = jg.grouped_mask_search(jnp.asarray(corpus).astype(jdt), jnp.asarray(queries), jnp.asarray(_table()),
                                 jnp.asarray(ids), k, count=count, impl="pallas_fast", block_n=128, block_q=8)
    got = tg.grouped_mask_search(torch.from_numpy(corpus).to(tdt), torch.from_numpy(queries),
                                 torch.from_numpy(_table()), torch.from_numpy(ids), k, count=count,
                                 impl="pallas_fast", block_n=128)
    _assert_same(got, ref, ties=True)


def test_grouped_fast_plain_partials_match_kernel5_rows():
    corpus, queries = _inputs(seed=12, d=64, q=3)
    c, q = torch.from_numpy(corpus), torch.from_numpy(queries)
    table, ids = torch.from_numpy(_table()), torch.tensor([2, 1, 0], dtype=torch.int32)
    fast_v, fast_i = tg.fast_grouped_block_topk(c, q, table, ids, 5, count=N, block_n=128)
    exact_v, exact_i = tg.grouped_block_topk(c, q, table, ids, 5, count=N, block_n=128)
    live = torch.isfinite(exact_v)
    assert torch.equal(torch.isfinite(fast_v), live)
    assert (fast_v[live] >= exact_v[live]).all()
    assert ((fast_i[0][live[0]] >= 100) & (fast_i[0][live[0]] < 200)).all()  # predicate 2
    assert (fast_i[1][live[1]] % 2 == 0).all()  # predicate 1: even rows


def test_fast_wrappers_refuse_other_devices():
    meta = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError):
        ttopk.fast_block_topk(meta, meta, 1, count=8)
    with pytest.raises(ValueError):
        ttopk.fused_topk(meta, meta, 1, count=8, blocks_per_range=1)
    with pytest.raises(ValueError):
        tg.fast_grouped_block_topk(meta, meta, torch.empty((1, 8), dtype=torch.int8, device="meta"),
                                   torch.empty(8, dtype=torch.int32, device="meta"), 1, count=8)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def _stores(metric, dtype, quantized=False, n=900):
    rng = np.random.default_rng(21)
    corpus = unit_rows(rng, n, 64)
    corpus[300:310] = corpus[5]  # exact ties
    queries = np.concatenate([corpus[[5, 77]], unit_rows(rng, 5, 64)])
    jstore = JaxStore(64, metric=metric, store_dtype=dtype, quantized=quantized)
    jstore.append(corpus)
    return jstore, EmbeddingStore.from_state(store_state_from_jax(jstore), device="cpu"), queries, rng


@pytest.mark.parametrize("impl", ["pallas", "pallas_fast", "pallas_fused", "lax"])
@pytest.mark.parametrize("metric,dtype", [("cosine", "float32"), ("l2", "float32"), ("cosine", "bfloat16")])
def test_store_search_matches_jax(metric, dtype, impl):
    jstore, store, queries, rng = _stores(metric, dtype)
    mask = rng.random(900) > 0.3
    for k, m in ((10, None), (50, mask), (70, None)):
        got = store.search(queries, k, mask=m, impl=impl)
        ref = jstore.search(queries, k, mask=m, impl=impl)
        _assert_same(got, ref, ties=True, descending=metric != "l2")


@pytest.mark.parametrize("impl", ["pallas", "pallas_fast", "pallas_fused", "lax"])
@pytest.mark.parametrize("metric,dtype", [("cosine", "float32"), ("l2", "float32"), ("cosine", "bfloat16")])
def test_store_grouped_search_matches_jax(metric, dtype, impl):
    jstore, store, queries, rng = _stores(metric, dtype)
    table = np.stack([np.ones(900, bool), rng.random(900) > 0.4, np.arange(900) % 7 == 0])
    ids = np.array([0, 1, 2, 1, 0, 2, 1], np.int32)
    for k in (10, 50):
        got = store.grouped_search(queries, k, table, ids, impl=impl)
        ref = jstore.grouped_search(queries, k, table, ids, impl=impl)
        _assert_same(got, ref, ties=True, descending=metric != "l2")


def test_store_int8_keeps_its_meaning_and_unknown_impl_raises():
    jstore, store, queries, _ = _stores("cosine", "float32", quantized=True)
    _assert_same(store.search(queries, 10, impl="int8"), jstore.search(queries, 10, impl="int8"), ties=True)
    for bad in ("pallas-fast", "approx", "INT8"):
        with pytest.raises(ValueError, match="impl"):
            store.search(queries, 10, impl=bad)
        with pytest.raises(ValueError, match="impl"):
            store.grouped_search(queries, 10, np.ones((1, 900)), np.zeros(7), impl=bad)
    with pytest.raises(ValueError, match="impl"):
        EmbeddingStore(64, device="cpu").search(queries, 3, impl="bogus")  # even an empty store checks it


def test_every_entry_point_has_its_ctypes_signature():
    """Each ``extern "C"`` entry point of ``csrc/`` is declared in
    ``ops/_cuda.py`` with its pointer and int argument counts: an
    undeclared one would be called with its pointers cut to 32 bits."""

    def counts(args):
        params = [a.strip() for a in args.split(",")]
        assert params[-1] == "void* stream", params
        return sum("*" in a for a in params[:-1]), sum(a.startswith("int ") for a in params[:-1])

    found = {}
    for path in glob.glob(os.path.join(_cuda.SRC_DIR, "*.cu")):
        with open(path) as f:
            text = f.read().replace("\\\n", " ")  # join the lines of a macro
        for name, args in re.findall(r'extern "C" int (pse_\w+)\(([^)]*)\)', text):
            found[name] = counts(args)
        # entry points declared by a macro: #define M(name, ...) extern "C" int name(...)
        for macro, param, args in re.findall(r'#define (\w+)\((\w+)[^)]*\)\s+extern "C" int \2\(([^)]*)\)', text):
            for name in re.findall(rf"^{macro}\((pse_\w+),", text, re.M):
                found[name] = counts(args)
    assert found == _cuda._SIGNATURES


_SM_SHARED_LIMIT = 232448  # bytes of shared memory one CTA may use on the H100
_SM_SHARED = 233472  # an SM's shared memory; each resident CTA also reserves 1 KB


@pytest.mark.parametrize("which", ["small", "large"])
def test_tensor_core_tiles_fit_one_sm_and_follow_the_tma_box_rules(which):
    """The tile constants of ``csrc/block_score_tc.cuh`` (bf16 kernels 1 and
    5), parsed from the headers as the kernels compile them: every
    instantiation's shared memory fits a CTA, and two CTAs share an SM, as
    the launch bounds promise; the TMA boxes are
    128 bytes wide with the 128-byte swizzle and at most 256 elements along
    each dimension; every box starts on a swizzle atom; a pass is whole row
    tiles; the running top-k holds the largest k."""
    c = _cuda.header_constants("block_score_tc.cuh")
    s = _cuda.header_constants("block_select.cuh")
    bq = c["kSmallBQ"] if which == "small" else c["kLargeBQ"]
    assert ttopk.kernel_block_q(c["kSmallBQ"]) == c["kSmallBQ"]
    assert ttopk.kernel_block_q(c["kSmallBQ"] + 1) == c["kLargeBQ"]
    # boxes: [kRowTile, 64] bf16 of the corpus, [BQ, 64] of the queries: 128 bytes wide
    box_k = c["kSwizzleBytes"] // 2
    assert c["kSwizzleBytes"] == 128
    for rows in (c["kRowTile"], bq):
        assert 0 < rows <= 256 and rows % 8 == 0  # a box dimension; wgmma N (8..256, step 8)
    assert box_k <= 256 and c["kSwizzleBytes"] % c["kWgmmaKBytes"] == 0 and c["kWgmmaKBytes"] == 16 * 2
    assert c["kRowTile"] == 64 * (c["kConsumers"] // 128)  # one m64 tile per consumer warpgroup
    assert c["kPassTiles"] * c["kRowTile"] == c["kPassRows"]
    assert c["kRowTile"] * c["kSwizzleBytes"] % c["kAlign"] == 0 and bq * c["kSwizzleBytes"] % 1024 == 0
    assert s["kListSlots"] >= ttopk.MAX_KERNEL_K and 32 * s["kSubsets"] >= ttopk.MAX_KERNEL_K
    assert s["kThreads"] == c["kConsumers"]
    # shared memory: the header's formula, as the Python mirror computes it
    with open(os.path.join(_cuda.SRC_DIR, "block_score_tc.cuh")) as f:
        header = f.read()
    assert re.search(r"return kAlign \+ union_bytes<BQ>\(stages\) \+ BQ \* kListSlots \* 8 \+ "
                     r"8 \* \(2 \* stages \+ 2 \* kQueryStages \+ 1\);", header)
    assert re.search(r"return BQ \* \(kListSlots \+ kPassRows \+ kPitchPad\) \* 4 \+ "
                     r"8 \* \(kCandidates \+ kListSlots\) \* 8;", header)
    for stages in (2, c["kStages"], c["kSweepStages"]):
        assert ttopk.tc_shared_bytes(bq, stages) <= _SM_SHARED_LIMIT
    assert 2 * (ttopk.tc_shared_bytes(bq, c["kStages"]) + 1024) <= _SM_SHARED  # __launch_bounds__(288, 2)


def test_scoring_loop_and_alignment_rules():
    """bf16 rows whose byte stride TMA takes (D % 8 == 0) go to the tensor
    cores, f32 rows TMA takes (D % 4 == 0) to the same ring with fmaf
    consumers, every other corpus to the FMA loop; a bf16 base off a
    16-byte boundary is refused before any launch."""
    assert ttopk.scoring_loop(torch.zeros((4, 1536), dtype=torch.bfloat16)) == "tensor_core"
    assert ttopk.scoring_loop(torch.zeros((4, 1000), dtype=torch.bfloat16)) == "tensor_core"
    assert ttopk.scoring_loop(torch.zeros((4, 1001), dtype=torch.bfloat16)) == "fma"
    assert ttopk.scoring_loop(torch.zeros((4, 1536), dtype=torch.float32)) == "fma_ring"
    rows = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    _cuda.require_aligned("rows", rows[:256].view(4, 64))
    with pytest.raises(ValueError, match="16-byte"):
        _cuda.require_aligned("rows", rows[4:260].view(4, 64))

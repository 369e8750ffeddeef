"""Kernels 3 and 4 as the tensor-core scan runs them, modelled on the CPU.

* :func:`pass_key_topk_model` is a plain model of kernel 3's selection on
  the tensor cores (``select_pass_keys`` in ``csrc/block_select.cuh``, fed
  by ``csrc/block_score_tc.cuh``): the block's rows scored in passes of
  ``kPassRows``, each pass's packed keys merged with the query's running
  list of ``kListSlots`` keys (INT_MIN where empty) by the threshold of the
  ``kSubsets`` subset maxima, ``-inf`` keys kept, and a block of fewer than
  k rows filled with the ``-inf`` lanes past its rows.  It is held bit for
  bit to JAX's ``_extract_block_topk_fast`` (called on the CPU, as
  ``tests/test_topk.py`` runs the JAX package's kernels there) and to the
  port's ``packed_key_topk_plain``, at bn 128, 1024 and 2048, k 1, 10 and
  64, on random tiles, ragged and short blocks, masked rows and duplicate
  scores across a pass edge; and it checks on the way that the candidates
  of every pass fit the warp's buffer (``kKeyCandidates``).
* Kernel 4's range partials: ``fused_topk_plain``'s ranges are the block
  partials of ``exact_block_topk_plain`` at ``block_n = blocks_per_range ·
  bn`` (same ids; values within 1e-6: the plain product of a larger row
  chunk may round differently).
* ``fused_ranges`` on the tensor cores: no range empty, one wave of CTAs
  (one an SM at a query tile of 8, two at 32).
No assertion depends on wall-clock time."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photo_search_engine_tpu.ops import topk as jtopk
from photo_search_engine_tpu_torch.ops import _cuda
from photo_search_engine_tpu_torch.ops import topk as ttopk
from tests.torch_parity import unit_rows

INT_MIN = np.iinfo(np.int32).min
_TC = _cuda.header_constants("block_score_tc.cuh")
_SEL = _cuda.header_constants("block_select.cuh")
KEY_CANDIDATES = 2 * (_SEL["kCandidates"] + _SEL["kListSlots"]) - _SEL["kListSlots"]  # kKeyCandidates


def _flip(bits):
    return bits ^ ((bits >> 31) & np.int32(0x7FFFFFFF))


def pass_key_topk_model(scores, bn, col_base, k):
    """Kernel 3's tensor-core selection for one block: ``scores`` ``[rows,
    ncols]`` float32 are the block's rows (``ncols <= bn``, invalid rows
    already ``-inf``).  Returns ``[rows, k]`` quantized values and int32 ids,
    as the kernel writes its partials."""
    rows, ncols = scores.shape
    lm = np.int32((1 << max(10, (bn - 1).bit_length())) - 1)
    keys = (_flip(np.ascontiguousarray(scores, np.float32).view(np.int32)) & ~lm) | (lm - np.arange(ncols, dtype=np.int32))
    pass_rows, slots, subsets = _TC["kPassRows"], _SEL["kListSlots"], _SEL["kSubsets"]
    out_v = np.empty((rows, k), np.float32)
    out_i = np.empty((rows, k), np.int32)
    for r in range(rows):
        running = np.full(slots, INT_MIN, np.int32)
        for p0 in range(0, ncols, pass_rows):
            row = np.concatenate([running, keys[r, p0:p0 + pass_rows]])  # the list at the row's head
            u = row.view(np.uint32) ^ np.uint32(0x80000000)  # order-preserving; INT_MIN is 0
            width = 32 * subsets
            padded = np.zeros(-(-len(u) // width) * width, np.uint32)
            padded[:len(u)] = u
            maxima = padded.reshape(-1, subsets, 32).max(axis=0)  # position c: subset (c // 32) % kSubsets, lane c % 32
            threshold = np.sort(maxima, axis=None)[-k]  # the k-th largest maximum
            cand = row[(u >= threshold) & (u != 0)]
            assert len(cand) <= KEY_CANDIDATES, (len(cand), KEY_CANDIDATES)
            best = np.sort(cand)[::-1][:k]  # rank: the number of larger keys
            total = len(cand)
            running = np.full(slots, INT_MIN, np.int32)
            running[:len(best)] = best
        for s in range(k):  # the last pass decodes
            if s < total:
                key = running[s]
                out_v[r, s] = _flip(key | lm).view(np.float32)
                out_i[r, s] = col_base + lm - (key & lm)
            else:  # a lane past the block's rows, at -inf
                out_v[r, s] = -np.inf
                out_i[r, s] = col_base + ncols + s - total
    return out_v, out_i


def _tile(rng, rows, ncols, case):
    tile = rng.normal(size=(rows, ncols)).astype(np.float32)
    edges = np.array([0.0, -0.0, 1e-40, -1e-40], np.float32)  # signed zeros and subnormals keep their key order
    tile[0, : min(ncols, 4)] = edges[: min(ncols, 4)]
    if case == "masked":
        tile[:, ::3] = -np.inf
        tile[1, :] = -np.inf  # every row masked: all slots -inf, ids the lanes in order
        tile[2, 3:] = -np.inf  # three live rows
        tile[3, : min(ncols, 512)] = -np.inf  # a whole pass masked
    elif case == "dups":
        top = tile.max() + 1.0
        for c in (3, 510, 511, 512, 513, 1500, 2047):  # ties on both sides of a pass edge
            if c < ncols:
                tile[:, c] = top
        tile[4, 490:540] = tile[4, 0]
    return tile


CASES = ("random", "ragged", "short", "masked", "dups")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("bn", [128, 1024, 2048])
def test_pass_key_model_is_jax_packed_key_selection(bn, k, case):
    """The pass-wise key selection equals JAX's one-shot packed-key
    extraction over the block's tile padded with -inf to bn lanes, and the
    port's packed_key_topk_plain, bit for bit: values, ids, and the ids of
    -inf slots."""
    ncols = {"ragged": bn - 37, "short": max(1, k - 3)}.get(case, bn)
    tile = _tile(np.random.default_rng(bn * 100 + k), 6, ncols, case)
    col_base = 5 * bn
    padded = np.full((tile.shape[0], bn), -np.inf, np.float32)
    padded[:, :ncols] = tile
    got_v, got_i = pass_key_topk_model(tile, bn, col_base, k)
    kp = -(-k // 128) * 128
    ref_v, ref_i = jtopk._extract_block_topk_fast(jnp.asarray(padded), col_base, k, kp, padded.shape[0], bn)
    np.testing.assert_array_equal(got_v.view(np.int32), np.asarray(ref_v)[:, :k].view(np.int32))
    np.testing.assert_array_equal(got_i, np.asarray(ref_i)[:, :k])
    port_v, port_i = ttopk.packed_key_topk_plain(torch.from_numpy(padded), col_base, k)
    np.testing.assert_array_equal(got_v.view(np.int32), port_v.numpy().view(np.int32))
    np.testing.assert_array_equal(got_i, port_i.numpy())
    if case == "short" and k > 1:  # the slots past the block's rows hold its -inf lanes in order
        assert np.isneginf(got_v[:, ncols:]).all()
        assert (got_i[:, ncols:] == col_base + np.arange(ncols, k)).all()


def test_pass_key_model_is_kernel3_plain_partials():
    """Over a whole scan (a ragged last block shorter than k, a live count
    and a mask), the model applied block by block to the plain scores gives
    fast_block_topk_plain's partials bit for bit."""
    rng = np.random.default_rng(11)
    n, bn, k = 2 * 1024 + 40, 1024, 64
    corpus, queries = unit_rows(rng, n, 48), unit_rows(rng, 3, 48)
    mask = (rng.random(n) > 0.3).astype(np.int8)
    c, q = torch.from_numpy(corpus), torch.from_numpy(queries)
    kw = dict(count=n - 10, mask=torch.from_numpy(mask), block_n=bn)
    got_v, got_i = ttopk.fast_block_topk_plain(c, q, k, **kw)
    scores = ttopk.mask_scores(ttopk.score_chunk(c, q, None, "ip"), 0, n, n - 10, kw["mask"]).numpy()
    for b in range(3):
        want_v, want_i = pass_key_topk_model(scores[:, b * bn:(b + 1) * bn], bn, b * bn, k)
        np.testing.assert_array_equal(got_v[:, b].numpy().view(np.int32), want_v.view(np.int32))
        np.testing.assert_array_equal(got_i[:, b].numpy(), want_i)
    assert (got_i[:, 2, 40:] == 2 * bn + torch.arange(40, 64, dtype=torch.int32)).all()


@pytest.mark.parametrize("blocks_per_range", [1, 2, 3])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_fused_range_partials_are_block_partials_of_the_range(metric, blocks_per_range):
    """Kernel 4's range partials (kernel 1's block partials merged range by
    range) are the partials of one block of blocks_per_range * bn rows."""
    rng = np.random.default_rng(30 + blocks_per_range)
    corpus, queries = unit_rows(rng, 700, 32), unit_rows(rng, 4, 32)
    corpus[[130, 260, 390]] = corpus[5]  # ties across blocks: the smallest row first
    c, q = torch.from_numpy(corpus), torch.from_numpy(queries)
    cnorms = ttopk.row_sq_norms(c) if metric == "l2" else None
    mask = torch.from_numpy((rng.random(700) > 0.2).astype(np.int8))
    kw = dict(count=650, metric=metric, mask=mask, cnorms=cnorms)
    _, _, range_v, range_i = ttopk.fused_topk_plain(c, q, 20, block_n=128, blocks_per_range=blocks_per_range, **kw)
    want_v, want_i = ttopk.exact_block_topk_plain(c, q, 20, block_n=128 * blocks_per_range, **kw)
    assert range_v.shape == want_v.shape == (4, -(-6 // blocks_per_range), 20)
    np.testing.assert_array_equal(range_i.numpy(), want_i.numpy())
    np.testing.assert_allclose(range_v.numpy(), want_v.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("nq", [1, 8, 9, 33, 128, 129, 160, 256, 8448, 9000])
@pytest.mark.parametrize("nb", [1, 3, 245, 978, 4000])
def test_fused_ranges_on_the_tensor_cores_fill_one_wave(nq, nb):
    """Every range holds a block; the CTAs (query tiles x ranges) never
    outnumber the slots (one CTA an SM at a query tile of 8, two at 32, as
    the launch bounds allow; one range at least); and the ranges are as
    short as that allows: one block fewer a range would need more CTAs than
    there are slots."""
    sms = 132
    ranges, per = ttopk.fused_ranges(nq, nb, sms, loop="tensor_core")
    bq = ttopk.kernel_block_q(nq)
    tiles = -(-nq // bq)
    slots = (1 if bq == _TC["kSmallBQ"] else 2) * sms
    assert (ranges - 1) * per < nb <= ranges * per  # no empty range
    assert ranges == 1 or tiles * ranges <= slots  # one wave
    if per > 1:
        assert tiles * -(-nb // (per - 1)) > slots


def test_fused_ranges_tensor_core_reference_points():
    """The rule at 1M rows (978 blocks of 1024) on an H100's 132 SMs: one
    wave of CTAs, 132 at batch 1-8 (one an SM) and 264 above (two an SM,
    as the tensor-core launch bounds allow)."""
    assert ttopk.fused_ranges(1, 978, loop="tensor_core") == (123, 8)
    assert ttopk.fused_ranges(8, 978, loop="tensor_core") == (123, 8)
    assert ttopk.fused_ranges(128, 978, loop="tensor_core") == (66, 15)  # 4 tiles x 66 ranges
    assert ttopk.fused_ranges(256, 978, loop="tensor_core") == (33, 30)
    assert ttopk.fused_ranges(160, 978, loop="tensor_core") == (52, 19)  # 5 tiles: a ceiling of 264 / 5 would spill a wave
    assert ttopk.fused_ranges(1, 3, loop="tensor_core") == (3, 1)
    assert ttopk.TC_FUSED_CTAS_PER_SM == {_TC["kSmallBQ"]: 1, _TC["kLargeBQ"]: 2}
    assert 2 * (ttopk.tc_shared_bytes(8, _TC["kStages"]) + 1024) <= ttopk.SM_SHARED_BYTES
    assert 2 * (ttopk.tc_shared_bytes(32, _TC["kStages"]) + 1024) <= ttopk.SM_SHARED_BYTES


def test_fused_ranges_needs_the_scoring_loop():
    """The rule is never chosen apart from the loop that runs: no default,
    and an unknown loop raises."""
    with pytest.raises(TypeError):
        ttopk.fused_ranges(1, 978)
    with pytest.raises(ValueError, match="scoring loop"):
        ttopk.fused_ranges(1, 978, loop="tensor")


def test_fused_default_ranges_follow_the_scoring_loop():
    """fused_topk sizes its default ranges by the loop its corpus takes:
    bf16 rows of D % 8 == 0 and f32 rows of D % 4 == 0 by the tensor-core
    rule (the f32 ring's CTA has the same shared memory), others by the
    FMA rule (300 blocks of 8 rows at BQ 8: 132 slots give 100 ranges of 3,
    the FMA rule 300 of 1)."""
    rng = np.random.default_rng(40)
    shapes = {}
    for dtype, d, loop in ((torch.bfloat16, 16, "tensor_core"), (torch.float32, 16, "fma_ring"),
                           (torch.float32, 18, "fma")):
        corpus, queries = unit_rows(rng, 2400, d), unit_rows(rng, 2, d)
        c = torch.from_numpy(corpus).to(dtype)
        assert ttopk.scoring_loop(c) == loop
        _, _, range_v, _ = ttopk.fused_topk(c, torch.from_numpy(queries).to(dtype), 5, count=2400, block_n=8)
        ranges, _ = ttopk.fused_ranges(2, 300, ttopk.H100_SMS, block_n=8, k=5, loop=loop)
        assert range_v.shape == (2, ranges, 5)
        shapes[loop] = ranges
    assert shapes == {"tensor_core": 100, "fma_ring": 100, "fma": 300}

"""The f32 ring's rules on the CPU: which loop each float32 and bfloat16
corpus takes (``topk.scoring_loop``, ``ivf_scan.ivf_scoring_loop``), the
tests' ``fma_loop`` hook, the ring's stages, shared memory and CTAs an SM
as ``csrc/block_score_tc.cuh`` compiles them (mirrored in Python for
``fused_ranges`` and ``ivf_geometry``) and
the ctypes signatures of the entry points that take the loop.  The kernels
themselves run on the card (``tests/test_torch_kernels_cuda.py``, marked
``cuda``)."""

import inspect
import os
import re

import pytest
import torch

from photo_search_engine_tpu_torch.ops import _cuda
from photo_search_engine_tpu_torch.ops import grouped_mask as tgm
from photo_search_engine_tpu_torch.ops import ivf_scan
from photo_search_engine_tpu_torch.ops import topk as ttopk
from tests.torch_parity import fma_loop

_TC = _cuda.header_constants("block_score_tc.cuh")
_SM_SHARED_LIMIT = 232448  # bytes one CTA may use on the H100


@pytest.mark.parametrize("dtype,d,loop", [
    (torch.float32, 1536, "fma_ring"), (torch.float32, 1000, "fma_ring"), (torch.float32, 4, "fma_ring"),
    (torch.float32, 1001, "fma"), (torch.float32, 1002, "fma"), (torch.float32, 3, "fma"),
    (torch.bfloat16, 1536, "tensor_core"), (torch.bfloat16, 1000, "tensor_core"), (torch.bfloat16, 1004, "fma"),
])
def test_scoring_loop_rule(dtype, d, loop):
    """float32 rows TMA can stride (D % 4 == 0: a 16-byte row stride) take
    the f32 ring; bf16 keeps its rule (the tensor cores at D % 8 == 0).
    The three loops are those ``fused_ranges`` and ``ivf_geometry`` take."""
    assert ttopk.scoring_loop(torch.zeros((2, d), dtype=dtype)) == loop
    assert set(ttopk.SCORING_LOOPS) == {"tensor_core", "fma_ring", "fma"}


@pytest.mark.parametrize("dtype,d,k,loop", [
    (torch.float32, 1536, 64, "fma_ring"), (torch.float32, 1536, 65, "fma"), (torch.float32, 1536, 500, "fma"),
    (torch.float32, 1000, 1, "fma_ring"), (torch.float32, 1002, 10, "fma"),
    (torch.bfloat16, 1536, 64, "tensor_core"), (torch.bfloat16, 1536, 65, "fma"), (torch.bfloat16, 1001, 10, "fma"),
    (torch.int8, 1536, 64, "tensor_core"), (torch.int8, 1000, 64, "fma"),
])
def test_ivf_scoring_loop_rule(dtype, d, k, loop):
    """Kernel 7: the f32 ring for float32 rows with D % 4 == 0 and k <= 64
    (the ring's running list); candidate_k 500 stays on the FMA loop."""
    assert ivf_scan.ivf_scoring_loop(torch.zeros((2, d), dtype=dtype), k) == loop


def test_fma_loop_hook():
    """``torch_parity.fma_loop`` (the reference of the ring's bit-for-bit
    checks) sends float32 rows of any width to the FMA loop, leaves bf16
    and int8 on their rules, and restores the rules on leaving; the
    wrappers take no loop argument."""
    f32, f32_odd, bf16 = torch.zeros((4, 64)), torch.zeros((4, 66)), torch.zeros((4, 64), dtype=torch.bfloat16)
    probes = torch.zeros((2, 3), dtype=torch.int32)
    with fma_loop():
        assert ttopk.scoring_loop(f32) == ttopk.scoring_loop(f32_odd) == tgm.scoring_loop(f32) == "fma"
        assert ttopk.scoring_loop(bf16) == "tensor_core"
        assert ivf_scan.ivf_launch(f32, probes, 4, 10, 4, 8)[0] == "fma"
        assert ivf_scan.ivf_scoring_loop(torch.zeros((4, 64), dtype=torch.int8), 10) == "tensor_core"
    assert ttopk.scoring_loop(f32) == tgm.scoring_loop(f32) == "fma_ring"
    assert ivf_scan.ivf_launch(f32, probes, 4, 10)[0] == "fma_ring"
    assert ivf_scan.ivf_launch(f32, probes, 4, 100)[0] == "fma"
    for fn in (ttopk.block_topk, ttopk.fast_block_topk, ttopk.fused_topk, tgm.grouped_block_topk,
               tgm.fast_grouped_block_topk, ivf_scan.ivf_block_topk, ivf_scan.ivf_launch):
        assert "loop" not in inspect.signature(fn).parameters, fn.__name__


def test_the_plain_versions_under_the_fma_loop_hook():
    """On the CPU the wrappers run their plain versions whichever loop the
    rule names: one result inside and outside ``fma_loop``."""
    g = torch.Generator().manual_seed(0)
    corpus, queries = torch.randn((300, 16), generator=g), torch.randn((3, 16), generator=g)
    table, ids = torch.ones((1, 300), dtype=torch.int8), torch.zeros(3, dtype=torch.int32)
    calls = (lambda: ttopk.block_topk(corpus, queries, 5, count=300, block_n=128),
             lambda: ttopk.fast_block_topk(corpus, queries, 5, count=300, block_n=128),
             lambda: tgm.grouped_block_topk(corpus, queries, table, ids, 5, count=300, block_n=128),
             lambda: ttopk.fused_topk(corpus, queries, 5, count=300, block_n=128, blocks_per_range=2))
    ring = [call() for call in calls]
    with fma_loop():
        fma = [call() for call in calls]
    for a, b in zip(ring, fma):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_ring_stages_memory_and_ctas_follow_the_header():
    """The f32 ring: one stage a row tile at BQ 8 (two CTAs an SM, as the
    tensor cores'), kFfmaLargeDepth a tile at BQ 32, whose shared memory
    fits one CTA and not two (the kernel's ``__launch_bounds__(288, 1)``);
    the Python mirror reads the header's constants and formulas."""
    with open(os.path.join(_cuda.SRC_DIR, "block_score_tc.cuh")) as f:
        header = f.read()
    assert re.search(r"return kPassTiles \* \(BQ > kSmallBQ \? kFfmaLargeDepth : 1\);", header)
    assert re.search(r"return BQ > kSmallBQ \? 1 : 2;", header)
    small, large = _TC["kSmallBQ"], _TC["kLargeBQ"]
    assert ttopk.ring_stages("fma_ring", small) == _TC["kPassTiles"] == _TC["kStages"]
    assert ttopk.ring_stages("fma_ring", large) == _TC["kPassTiles"] * _TC["kFfmaLargeDepth"]
    assert ttopk.ring_stages("tensor_core", large) == _TC["kStages"]
    assert ttopk.tc_shared_bytes(large, ttopk.ring_stages("fma_ring", large)) <= _SM_SHARED_LIMIT
    assert ttopk.ring_ctas_per_sm("fma_ring", large) == 1
    assert ttopk.ring_ctas_per_sm("fma_ring", small) == ttopk.ring_ctas_per_sm("tensor_core", small) == 2
    assert ttopk.ring_ctas_per_sm("tensor_core", large) == 2
    # a box row of 32 floats is 128 bytes, as a bf16 or int8 box row
    assert _TC["kSwizzleBytes"] // 4 * 4 == 128 and _TC["kFfmaRows"] * 16 == _TC["kRowTile"]


@pytest.mark.parametrize("nq,nb", [(1, 978), (8, 978), (9, 978), (128, 978), (256, 978), (1, 3), (700, 40)])
def test_fused_ranges_on_the_f32_ring(nq, nb):
    """Kernel 4 on the f32 ring: at BQ 8 the tensor cores' ranges (the same
    CTA shared memory, one CTA an SM); at BQ 32 one CTA an SM, so half the
    ranges, each one wave of CTAs and none empty."""
    ranges, per = ttopk.fused_ranges(nq, nb, loop="fma_ring")
    tiles = -(-nq // ttopk.kernel_block_q(nq))
    assert (ranges - 1) * per < nb <= ranges * per
    if nq <= _TC["kSmallBQ"]:
        assert (ranges, per) == ttopk.fused_ranges(nq, nb, loop="tensor_core")
    else:
        assert ranges * tiles <= max(tiles, ttopk.H100_SMS) or ranges == 1
    assert ttopk.fused_ranges(128, 978, loop="fma_ring") == (33, 30)


def test_ivf_geometry_on_the_f32_ring():
    """Kernel 7 on the f32 ring tiles clusters by the ring's rule over the
    CTAs an SM it holds: two at groups of 8, one at 32."""
    for q in (1, 8, 32, 128):
        assert ivf_scan.ivf_geometry(q, 64, 1024, 1536, "fma_ring") == ivf_scan.ivf_geometry(
            q, 64, 1024, 1536, "tensor_core")
    assert ivf_scan.ivf_geometry(256, 64, 1024, 1536, "fma_ring") == (1536, 32)
    assert ivf_scan.ivf_geometry(256, 64, 1024, 1536, "fma") == (ivf_scan.IVF_FMA_BLOCK_N, 32)
    with pytest.raises(ValueError, match="loop"):
        ivf_scan.ivf_geometry(1, 8, 24, 384, "f32")


def test_entry_points_that_take_the_loop():
    """The float32 entry points take one int more than their bf16 twins
    (ring: 1 the f32 ring, 0 the FMA loop); kernel 7's three take it as
    their last int."""
    sig = _cuda._SIGNATURES
    for base in ("pse_block_topk", "pse_fast_block_topk", "pse_grouped_block_topk", "pse_fast_grouped_block_topk",
                 "pse_fused_topk"):
        assert sig[f"{base}_f32"] == (sig[f"{base}_bf16"][0], sig[f"{base}_bf16"][1] + 1), base
    assert sig["pse_ivf_topk_f32"] == sig["pse_ivf_topk_bf16"] == sig["pse_ivf_topk_int8"] == (13, 11)
    with open(os.path.join(_cuda.SRC_DIR, "ivf_topk.cu")) as f:
        assert "int l2, int ring, void* stream" in f.read().replace("\\\n", " ").replace("  ", " ")

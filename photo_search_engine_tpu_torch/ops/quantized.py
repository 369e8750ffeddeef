"""int8 corpus scan with exact rescore: kernel 2 and its host contract.

Counterpart of ``photo_search_engine_tpu/ops/quantized.py``.  The int8
shadow corpus only nominates candidates; exactness comes from rescoring
them against the full-precision rows:

    int8 scan, per-block top-kloc   (kernel 2, csrc/int8_block_topk.cu:
                                     s8 wgmma on the tensor cores)
      → merge to the top-``cand`` pool (``lax.top_k``'s order, quantized scores)
        → gather the pool's rows at full precision
          → exact float32 dot, exact order, top-k

:func:`grouped_int8_search` is the same pipeline with a predicate per
query (kernel 6, the grouped variant of kernel 2; see ``grouped_mask.py``
for the factored ``mask_table`` / ``mask_ids`` contract).

``quantize_rows`` is bit-identical to the JAX function (absmax times
float32(1/127), divide by ``max(scale, 1e-30)``, round half to even, clip
to ±127).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from photo_search_engine_tpu_torch.ops import _cuda
from photo_search_engine_tpu_torch.ops.grouped_mask import (
    grouped_mask_plain,
    grouped_mask_scores,
    predicate_inputs,
)
from photo_search_engine_tpu_torch.ops.topk import (
    _empty,
    _finalize,
    exact_search,
    mask_scores,
    plain_block_topk,
    rescore_pool,
    row_sq_norms,
)

INT8_MAX_K = 64  # larger k takes the full-precision exact path
INT8_BLOCK_N = 2048  # widest kernel-2 block (the JAX packed-key bound)


def resolve_store_quantized(value) -> bool:
    """``STORE_QUANTIZED`` → bool.  ``"auto"`` is False: the int8 tier is
    the TPU serving default, but on CUDA it stays off until the benchmark
    and recall on realistic embeddings show it wins (ROADMAP.md, "Modules
    still to port": a benchmark)."""
    if isinstance(value, bool):
        return value
    if value is None:
        return False
    text = str(value).strip().lower()
    if text in {"1", "true", "yes", "on"}:
        return True
    if text in {"auto", "", "0", "false", "no", "off", "none"}:
        return False
    raise ValueError(f"STORE_QUANTIZED must be auto or a boolean, got {value!r}")


def default_block_n_int8(dim: int = 1536) -> int:
    """Corpus rows per kernel-2 block: the JAX package's
    ``default_block_n_int8`` for the int8 feed (2048 up to D = 2048).  The
    nomination pool is ``kloc`` rows per block, so the same block size
    keeps the same pool, and the pool guard in :func:`int8_search` the
    same decision, in both packages."""
    per_row = -(-dim // 128) * 128
    rows = (8 * 1024 * 1024) // (2 * per_row)
    return max(128, min(INT8_BLOCK_N, (rows // 128) * 128))


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row absmax quantization ``x ≈ q * scale[row]``:
    ``(q [N, D] int8, scales [N] float32)``; zero rows get scale 0."""
    xf = x.float()
    # XLA compiles the JAX function's ``absmax / 127.0`` into a product with
    # float32(1/127); multiplying here gives the same scale bit for bit
    scale = xf.abs().amax(dim=1, keepdim=True) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / torch.clamp(scale, min=1e-30)), -127, 127)
    return q.to(torch.int8), scale[:, 0]


# ---------------------------------------------------------------------------
# Kernel 2: int8 per-block top-k (csrc/int8_block_topk.cu) and its plain version
# ---------------------------------------------------------------------------


def int8_scoring_loop(dim: int) -> str:
    """Which scoring loop kernels 2 and 6 run at width ``dim`` (the C entry
    points' dispatch): ``"tensor_core"`` (s8 wgmma fed by TMA,
    ``csrc/block_score_tc.cuh``) where TMA takes the row stride (D % 16 ==
    0), ``"dp4a"`` (int8x4 words) for the other widths with D % 4 == 0;
    any other width raises."""
    if dim % 16 == 0:
        return "tensor_core"
    if dim % 4 == 0:
        return "dp4a"
    raise ValueError(f"int8 scan: rows are read as int8x4 words; D={dim} must be a multiple of 4")


def _int8_launch_checks(name, corpus_i8, scales, q_i8, qs, k, block_n):
    """Checks of kernels 2 and 6 on CUDA tensors: ``(n, d, q, device,
    scoring loop)``.  The tensor cores read 16-byte-aligned bases only, the
    __dp4a loop 4-byte-aligned ones."""
    if corpus_i8.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {corpus_i8.device}")
    if corpus_i8.ndim != 2:
        raise ValueError(f"{name}: corpus must be [N, D], got {tuple(corpus_i8.shape)}")
    (n, d), nq, dev = corpus_i8.shape, q_i8.shape[0], corpus_i8.device
    _cuda.require(f"{name} corpus", corpus_i8, dev, torch.int8, (n, d))
    _cuda.require(f"{name} queries", q_i8, dev, torch.int8, (nq, d))
    _cuda.require(f"{name} scales", scales, dev, torch.float32, (n,))
    _cuda.require(f"{name} query scales", qs, dev, torch.float32, (nq,))
    loop = int8_scoring_loop(d)
    if loop == "tensor_core":
        _cuda.require_aligned(f"{name} corpus", corpus_i8)
        _cuda.require_aligned(f"{name} queries", q_i8)
    else:
        _cuda.require_aligned(f"{name} corpus", corpus_i8, 4)
        _cuda.require_aligned(f"{name} queries", q_i8, 4)
    if n == 0 or nq == 0 or not 1 <= k <= min(INT8_MAX_K, block_n):
        raise ValueError(f"{name}: n={n}, q={nq}, k={k} outside the kernel's range")
    return n, d, nq, dev, loop


def int8_block_topk_plain(
    corpus_i8: torch.Tensor,
    scales: torch.Tensor,
    q_i8: torch.Tensor,
    qs: torch.Tensor,
    k: int,
    *,
    count: int,
    metric: str = "ip",
    mask: Optional[torch.Tensor] = None,
    cnorms: Optional[torch.Tensor] = None,
    block_n: int = INT8_BLOCK_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 2, with the same outputs.

    The int32 dot is computed in float64, where it is exact
    (|sum| <= 127² * D < 2^53), then rounded to float32 as the kernel's
    ``__int2float_rn`` rounds it; the scaling is the same float32 products
    in the same order, so scores agree bit for bit."""
    qd = q_i8.double()

    def score_rows(start, stop):
        scores = _int8_scores(qd, qs, corpus_i8, scales, start, stop)
        if metric == "l2":
            scores = 2.0 * scores - cnorms[None, start:stop]
        return mask_scores(scores, start, stop, count, mask)

    return plain_block_topk(score_rows, corpus_i8.shape[0], q_i8.shape[0], k, block_n, corpus_i8.device)


def _int8_scores(qd, qs, corpus_i8, scales, start, stop) -> torch.Tensor:
    """Quantized inner products of rows ``[start, stop)``: the int32 dot
    (exact in float64), rounded to float32, times the query scale, then the
    row scale, as kernels 2 and 6 compute them."""
    acc = (qd @ corpus_i8[start:stop].double().T).float()
    return acc * qs[:, None] * scales[None, start:stop]


def int8_block_topk(
    corpus_i8: torch.Tensor,
    scales: torch.Tensor,
    q_i8: torch.Tensor,
    qs: torch.Tensor,
    k: int,
    *,
    count: int,
    metric: str = "ip",
    mask: Optional[torch.Tensor] = None,
    cnorms: Optional[torch.Tensor] = None,
    block_n: int = INT8_BLOCK_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2: per-block top-k of int8 queries over the int8 corpus.

    ``corpus_i8`` ``[N, D]`` and ``q_i8`` ``[Q, D]`` int8 with ``D % 4 ==
    0`` (D % 16 == 0 on 16-byte-aligned bases: the tensor cores);
    ``scales`` ``[N]`` and ``qs`` ``[Q]`` float32; ``mask`` int8 ``[N]``;
    ``cnorms`` float32 ``[N]`` for l2.  Outputs as in
    :func:`int8_block_topk_plain`.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (its scoring loop as
    :func:`int8_scoring_loop` says) or raises."""
    if corpus_i8.device.type == "cpu":
        return int8_block_topk_plain(
            corpus_i8, scales, q_i8, qs, k, count=count, metric=metric,
            mask=mask, cnorms=cnorms, block_n=block_n,
        )
    n, d, nq, dev, loop = _int8_launch_checks("int8_block_topk", corpus_i8, scales, q_i8, qs, k, block_n)
    nb = -(-n // block_n)  # a block_n the kernel cannot fit comes back as a CUDA error
    if mask is not None:
        _cuda.require("int8_block_topk mask", mask, dev, torch.int8, (n,))
    l2 = metric == "l2"
    if l2:
        _cuda.require("int8_block_topk cnorms", cnorms, dev, torch.float32, (n,))
    out_v = torch.empty((nq, nb, k), dtype=torch.float32, device=corpus_i8.device)
    out_i = torch.empty((nq, nb, k), dtype=torch.int32, device=corpus_i8.device)
    err = _cuda.library().pse_int8_block_topk(
        _cuda.ptr(corpus_i8), _cuda.ptr(q_i8), _cuda.ptr(qs), _cuda.ptr(scales),
        _cuda.ptr(cnorms if l2 else None), _cuda.ptr(mask),
        _cuda.ptr(out_v), _cuda.ptr(out_i),
        n, d, nq, int(min(count, n)), k, block_n, int(l2),
        _cuda.stream(corpus_i8.device),
    )
    _cuda.check(err, "int8_block_topk")
    return out_v, out_i


# ---------------------------------------------------------------------------
# Kernel 6: grouped int8 per-block top-k (csrc/int8_block_topk.cu) and its plain version
# ---------------------------------------------------------------------------


def int8_grouped_block_topk_plain(
    corpus_i8: torch.Tensor,
    scales: torch.Tensor,
    q_i8: torch.Tensor,
    qs: torch.Tensor,
    mask_table: torch.Tensor,
    mask_ids: torch.Tensor,
    k: int,
    *,
    count: int,
    block_n: int = INT8_BLOCK_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 6: kernel 2's plain version (inner
    product) under each query's predicate row, with the same outputs."""
    qd = q_i8.double()

    def score_rows(start, stop):
        scores = _int8_scores(qd, qs, corpus_i8, scales, start, stop)
        return grouped_mask_scores(scores, start, stop, count, mask_table, mask_ids)

    return plain_block_topk(score_rows, corpus_i8.shape[0], q_i8.shape[0], k, block_n, corpus_i8.device)


def int8_grouped_block_topk(
    corpus_i8: torch.Tensor,
    scales: torch.Tensor,
    q_i8: torch.Tensor,
    qs: torch.Tensor,
    mask_table: torch.Tensor,
    mask_ids: torch.Tensor,
    k: int,
    *,
    count: int,
    block_n: int = INT8_BLOCK_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 6: per-block top-k of int8 queries over the int8 corpus, each
    query under its own predicate row (inner product).

    Inputs as in :func:`int8_block_topk`, plus ``mask_table`` int8
    ``[M, N]`` and ``mask_ids`` int32 ``[Q]``.  Outputs as in
    :func:`int8_grouped_block_topk_plain`.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if corpus_i8.device.type == "cpu":
        return int8_grouped_block_topk_plain(
            corpus_i8, scales, q_i8, qs, mask_table, mask_ids, k, count=count, block_n=block_n,
        )
    n, d, nq, dev, loop = _int8_launch_checks("int8_grouped_block_topk", corpus_i8, scales, q_i8, qs, k, block_n)
    m = mask_table.shape[0]
    _cuda.require("int8_grouped_block_topk mask_table", mask_table, dev, torch.int8, (m, n))
    _cuda.require("int8_grouped_block_topk mask_ids", mask_ids, dev, torch.int32, (nq,))
    nb = -(-n // block_n)  # a block_n the kernel cannot fit comes back as a CUDA error
    out_v = torch.empty((nq, nb, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, nb, k), dtype=torch.int32, device=dev)
    err = _cuda.library().pse_int8_grouped_block_topk(
        _cuda.ptr(corpus_i8), _cuda.ptr(q_i8), _cuda.ptr(qs), _cuda.ptr(scales),
        _cuda.ptr(mask_table), _cuda.ptr(mask_ids), _cuda.ptr(out_v), _cuda.ptr(out_i),
        n, d, nq, int(min(count, n)), k, block_n, m,
        _cuda.stream(dev),
    )
    _cuda.check(err, "int8_grouped_block_topk")
    return out_v, out_i


# ---------------------------------------------------------------------------
# Search entry point
# ---------------------------------------------------------------------------


def int8_rescore_search(
    corpus_i8: torch.Tensor,
    scales: torch.Tensor,
    corpus_ref: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    *,
    kloc: int,
    cand: int,
    count: int,
    metric: str,
    mask: Optional[torch.Tensor] = None,
    block_n: int = INT8_BLOCK_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize the queries, run kernel 2, then :func:`rescore_pool`
    (JAX ``quantized.py`` :262-265 and :311-336)."""
    q_i8, qs = quantize_rows(queries)
    cnorms = None
    if metric == "l2":
        cnorms = row_sq_norms(corpus_ref)
    part_v, part_i = int8_block_topk(
        corpus_i8.contiguous(), scales.contiguous(), q_i8, qs, kloc, count=count, metric=metric,
        mask=mask, cnorms=cnorms, block_n=block_n,
    )
    return rescore_pool(part_v, part_i, corpus_ref, queries, k, cand=cand, metric=metric)


def int8_search(
    corpus_i8: torch.Tensor,
    scales: torch.Tensor,
    corpus_ref: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    *,
    count: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
    metric: str = "cosine",
    kloc: Optional[int] = None,
    cand: Optional[int] = None,
    block_n: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-rescored k-NN over an int8-quantized corpus (contract of JAX
    ``int8_search``): ``kloc`` defaults to k (clamped to 64), ``cand`` to
    ``max(32, 2k)``; k > 64, or a nomination pool that cannot cover k,
    takes :func:`exact_search` on ``corpus_ref``."""
    queries = torch.atleast_2d(queries).float()
    n, d = corpus_i8.shape
    k = min(k, n) if n else 0
    if n == 0 or k == 0:
        return _empty(queries.shape[0], corpus_i8.device)
    if k > INT8_MAX_K:
        return exact_search(corpus_ref, queries, k, count=count, mask=mask, metric=metric)
    kloc = kloc if kloc is not None else min(k, INT8_MAX_K)
    kloc = max(1, min(kloc, INT8_MAX_K))
    cand = max(cand if cand is not None else max(32, 2 * k), k)
    bn = block_n or default_block_n_int8(d)
    if -(-n // bn) * kloc < k:
        # the per-block pool cannot cover k — the exact path is cheap here
        return exact_search(corpus_ref, queries, k, count=count, mask=mask, metric=metric)
    metric = "l2" if metric == "l2" else "ip"
    if mask is not None:
        mask = (mask > 0).to(torch.int8)
    vals, idx = int8_rescore_search(
        corpus_i8, scales, corpus_ref, queries, k, kloc=min(kloc, bn), cand=cand,
        count=n if count is None else int(count), metric=metric, mask=mask,
        block_n=bn,
    )
    return _finalize(vals, idx, metric)


def grouped_int8_search(
    corpus_i8: torch.Tensor,
    scales: torch.Tensor,
    corpus_ref: torch.Tensor,
    queries: torch.Tensor,
    mask_table: torch.Tensor,
    mask_ids: torch.Tensor,
    k: int,
    *,
    count: Optional[int] = None,
    kloc: Optional[int] = None,
    cand: Optional[int] = None,
    block_n: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query filtered int8 scan + exact rescore, inner product
    (contract of JAX ``grouped_int8_search``): kernel 6, then
    :func:`rescore_pool`.  The defaults and guards are :func:`int8_search`'s;
    k > 64, or a pool that cannot cover k, takes ``grouped_mask_plain`` on
    ``corpus_ref``."""
    queries = torch.atleast_2d(queries).float()
    n, d = corpus_i8.shape
    k = min(k, n) if n else 0
    if n == 0 or k == 0:
        return _empty(queries.shape[0], corpus_i8.device)
    table, ids = predicate_inputs(mask_table, mask_ids, corpus_i8.device)
    count = n if count is None else int(count)
    kloc = max(1, min(kloc if kloc is not None else min(k, INT8_MAX_K), INT8_MAX_K))
    cand = max(cand if cand is not None else max(32, 2 * k), k)
    bn = block_n or default_block_n_int8(d)
    if k > INT8_MAX_K or -(-n // bn) * kloc < k:
        return grouped_mask_plain(corpus_ref, queries, table, ids, k, count=count)
    q_i8, qs = quantize_rows(queries)
    part_v, part_i = int8_grouped_block_topk(
        corpus_i8.contiguous(), scales.contiguous(), q_i8, qs, table, ids, min(kloc, bn),
        count=count, block_n=bn,
    )
    return _finalize(*rescore_pool(part_v, part_i, corpus_ref, queries, k, cand=cand, metric="ip"), "ip")

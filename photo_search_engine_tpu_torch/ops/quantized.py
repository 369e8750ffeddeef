"""int8 corpus scan with exact rescore: kernel 2 and its host contract.

Counterpart of ``photo_search_engine_tpu/ops/quantized.py``.  The int8
shadow corpus only nominates candidates; exactness comes from rescoring
them against the full-precision rows:

    int8 scan, per-block top-kloc   (kernel 2, csrc/int8_block_topk.cu)
      → merge to the top-``cand`` pool (stable sort, quantized order)
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
    row_sq_norms,
    stable_topk,
)

INT8_MAX_K = 64  # larger k takes the full-precision exact path
INT8_BLOCK_N = 2048  # widest kernel-2 block (the JAX packed-key bound)


def resolve_store_quantized(value) -> bool:
    """``STORE_QUANTIZED`` → bool.  ``"auto"`` is False: the int8 tier is
    the TPU serving default, but on CUDA it stays off until an A/B on the
    H100 shows it wins (ROADMAP queue 1)."""
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
    0``; ``scales`` ``[N]`` and ``qs`` ``[Q]`` float32; ``mask`` int8
    ``[N]``; ``cnorms`` float32 ``[N]`` for l2.  Outputs as in
    :func:`int8_block_topk_plain`.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel or raises."""
    if corpus_i8.device.type == "cpu":
        return int8_block_topk_plain(
            corpus_i8, scales, q_i8, qs, k, count=count, metric=metric,
            mask=mask, cnorms=cnorms, block_n=block_n,
        )
    if corpus_i8.device.type != "cuda":
        raise ValueError(f"int8_block_topk: unsupported device {corpus_i8.device}")
    if corpus_i8.ndim != 2:
        raise ValueError(f"int8_block_topk: corpus must be [N, D], got {tuple(corpus_i8.shape)}")
    (n, d), nq, dev = corpus_i8.shape, q_i8.shape[0], corpus_i8.device
    _cuda.require("int8_block_topk corpus", corpus_i8, dev, torch.int8, (n, d))
    _cuda.require("int8_block_topk queries", q_i8, dev, torch.int8, (nq, d))
    _cuda.require("int8_block_topk scales", scales, dev, torch.float32, (n,))
    _cuda.require("int8_block_topk query scales", qs, dev, torch.float32, (nq,))
    if d % 4 or corpus_i8.data_ptr() % 4 or q_i8.data_ptr() % 4:
        raise ValueError(f"int8_block_topk: rows are read as int8x4 words; D={d} and the data must align to 4")
    if n == 0 or nq == 0 or not 1 <= k <= min(INT8_MAX_K, block_n):
        raise ValueError(f"int8_block_topk: n={n}, q={nq}, k={k} outside the kernel's range")
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
    int8_block_topk.launches += 1
    return out_v, out_i


int8_block_topk.launches = 0  # kernel launches (read by chip_smoke.py)


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
    if corpus_i8.device.type != "cuda":
        raise ValueError(f"int8_grouped_block_topk: unsupported device {corpus_i8.device}")
    if corpus_i8.ndim != 2:
        raise ValueError(f"int8_grouped_block_topk: corpus must be [N, D], got {tuple(corpus_i8.shape)}")
    (n, d), nq, dev = corpus_i8.shape, q_i8.shape[0], corpus_i8.device
    m = mask_table.shape[0]
    _cuda.require("int8_grouped_block_topk corpus", corpus_i8, dev, torch.int8, (n, d))
    _cuda.require("int8_grouped_block_topk queries", q_i8, dev, torch.int8, (nq, d))
    _cuda.require("int8_grouped_block_topk scales", scales, dev, torch.float32, (n,))
    _cuda.require("int8_grouped_block_topk query scales", qs, dev, torch.float32, (nq,))
    _cuda.require("int8_grouped_block_topk mask_table", mask_table, dev, torch.int8, (m, n))
    _cuda.require("int8_grouped_block_topk mask_ids", mask_ids, dev, torch.int32, (nq,))
    if d % 4 or corpus_i8.data_ptr() % 4 or q_i8.data_ptr() % 4:
        raise ValueError(f"int8_grouped_block_topk: rows are read as int8x4 words; D={d} and the data must align to 4")
    if n == 0 or nq == 0 or not 1 <= k <= min(INT8_MAX_K, block_n):
        raise ValueError(f"int8_grouped_block_topk: n={n}, q={nq}, k={k} outside the kernel's range")
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
    int8_grouped_block_topk.launches += 1
    return out_v, out_i


int8_grouped_block_topk.launches = 0  # kernel launches (read by chip_smoke.py)


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


def rescore_pool(part_v, part_i, corpus_ref, queries, k, *, cand, metric):
    """The int8 tier's tail (JAX ``quantized.py`` :311-336 and :440-457):
    merge the scan's per-block partials to the ``cand`` pool and rescore
    the pool exactly against ``corpus_ref``.  Kernel-space values (higher
    is better) and int32 row ids; slots that found no row hold ``-inf``."""
    n = corpus_ref.shape[0]
    # the pool is a superset filter: quantized order is enough here
    nq = queries.shape[0]
    pool = min(cand, part_v.shape[1] * part_v.shape[2])
    cv, pos = stable_topk(part_v.reshape(nq, -1), pool)
    ci = torch.gather(part_i.reshape(nq, -1), 1, pos)
    live = ~torch.isneginf(cv)
    # exact rescore at reference precision: widen the gathered rows to f32
    # (bf16 is exact in f32), queries cast to the reference dtype first
    rows = corpus_ref[torch.clamp(ci, 0, n - 1).long()].float()  # [Q, pool, D]
    qref = queries.to(corpus_ref.dtype).float()
    exact = torch.einsum("qd,qcd->qc", qref, rows)
    if metric == "l2":
        qn = (queries * queries).sum(dim=1, keepdim=True)
        cn = (rows * rows).sum(dim=2)
        exact = -(qn + cn - 2.0 * exact)
    exact = torch.where(live, exact, float("-inf"))
    vals, order = stable_topk(exact, k)
    return vals, torch.gather(ci, 1, order)


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

"""Exact corpus scan + top-k: kernel 1 and its host contract.

Counterpart of ``photo_search_engine_tpu/ops/topk.py``.  The flat scan is
two-phase, as on the TPU:

* phase A, :func:`block_topk` — the hand-written CUDA kernel
  ``csrc/block_topk.cu`` (port of ``_block_topk_kernel`` with
  ``fast=False``).  For every block of ``block_n`` corpus rows it scores
  the queries and keeps the block's top-k, ties to the smallest row.
* phase B — a stable descending sort over the ``[Q, NB·k]`` partials.
  Blocks are laid out in ascending row order, so equal scores keep the
  smallest index, which makes the result identical to a full sort.

Contract (FAISS flat conventions, as in the JAX package): ``ip``/
``cosine`` distances are inner products sorted descending; ``l2``
distances are squared distances sorted ascending; an empty slot holds
index ``-1`` and ``-inf`` (``+inf`` for l2); ``count`` masks rows past
the live count; ``mask`` excludes rows where it is ``<= 0``.

For ``k > 64`` the scan leaves the kernel for :func:`exact_search_plain`:
a row-chunked float32 product plus a stable top-k, exact like the JAX
oracle.  (The JAX store's ApproxTopK route at large k was a TPU choice.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from photo_search_engine_tpu_torch.ops import _cuda

MAX_KERNEL_K = 64
DEFAULT_BLOCK_N = 1024  # corpus rows per kernel-1 block
_INT_MAX = torch.iinfo(torch.int32).max
_PLAIN_ROWS = 65536  # rows per chunk of the plain scans (bounds the f32 temp)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization in float32, returned in ``x``'s dtype."""
    xf = x.float()
    norm = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
    return (xf / torch.clamp(norm, min=eps)).to(x.dtype)


def resolve_store_dtype(store_dtype, device) -> str:
    """``"auto"`` → bfloat16 on CUDA (half the scan bytes), float32 on the
    CPU; anything else passes through lower-cased."""
    resolved = (str(store_dtype) if store_dtype else "float32").strip().lower()
    if resolved != "auto":
        return resolved
    return "bfloat16" if torch.device(device).type == "cuda" else "float32"


def bucket_queries(qn: int) -> int:
    """Next power of two ≥ max(8, qn): the padded query counts the JAX
    package compiles its kernels for (bounded shape set)."""
    bucket = 8
    while bucket < qn:
        bucket *= 2
    return bucket


def _empty(q: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.zeros((q, 0), dtype=torch.float32, device=device),
        torch.zeros((q, 0), dtype=torch.int32, device=device),
    )


def row_sq_norms(rows: torch.Tensor) -> torch.Tensor:
    """Float32 squared norm of every row, in chunks (a bf16 corpus of 1M
    rows would otherwise widen into a 6 GB temporary)."""
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=rows.device)
    for start in range(0, rows.shape[0], _PLAIN_ROWS):
        chunk = rows[start : start + _PLAIN_ROWS].float()
        out[start : start + chunk.shape[0]] = (chunk * chunk).sum(dim=1)
    return out


def mask_scores(scores, start, stop, count, mask) -> torch.Tensor:
    """``-inf`` where row ``start + j`` is at or past ``count`` or where
    ``mask <= 0``: the scan contract of both kernels."""
    valid = torch.arange(start, stop, device=scores.device) < count
    if mask is not None:
        valid = valid & (mask[start:stop] > 0)
    return torch.where(valid[None, :], scores, float("-inf"))


def stable_topk(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ties to the smallest position.
    ``torch.topk`` does not promise that order; a stable sort does."""
    vals, pos = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def _finalize(vals, idx, metric):
    """Kernel-space (higher is better) → FAISS conventions."""
    empty = torch.isneginf(vals)
    idx = torch.where(empty, torch.full_like(idx, -1), idx)
    if metric == "l2":
        vals = torch.where(empty, torch.full_like(vals, float("inf")), -vals)
    return vals, idx


def score_chunk(corpus_chunk, queries_f32, qn, metric, cn=None):
    """Float32 scores of one corpus chunk.  A bf16 chunk is widened first:
    on CUDA a bf16×bf16 matmul returns bf16 and would round the score,
    while JAX asks for an f32 result; bf16 values are exact in f32."""
    rows = corpus_chunk.float()
    scores = queries_f32 @ rows.T
    if metric == "l2":
        if cn is None:
            cn = (rows * rows).sum(dim=1)
        scores = -(qn[:, None] + cn[None, :] - 2.0 * scores)
    return scores


# ---------------------------------------------------------------------------
# Kernel 1: per-block top-k (csrc/block_topk.cu) and its plain version
# ---------------------------------------------------------------------------


def plain_block_topk(score_rows, n, nq, k, block_n, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each ``block_n``-row block's top-k of the scores ``score_rows(start,
    stop)`` gives for rows ``[start, stop)`` (invalid rows already ``-inf``):
    ``[Q, NB, k]`` values and int32 global row ids, ties to the smallest row,
    slots with no valid row ``-inf`` and ``INT_MAX``.  Scores are made in
    chunks of whole blocks, which bounds the float32 temporary."""
    nb = -(-n // block_n)
    kk = min(k, block_n)
    out_v = torch.full((nq, nb, k), float("-inf"), device=device)
    out_i = torch.full((nq, nb, k), _INT_MAX, dtype=torch.int32, device=device)
    step = max(1, _PLAIN_ROWS // block_n) * block_n
    for start in range(0, n, step):
        stop = min(n, start + step)
        blocks = -(-(stop - start) // block_n)
        scores = torch.nn.functional.pad(
            score_rows(start, stop), (0, blocks * block_n - (stop - start)), value=float("-inf")
        )
        vals, pos = stable_topk(scores.reshape(nq, blocks, block_n), kk)
        first_row = start + block_n * torch.arange(blocks, dtype=torch.int32, device=device)
        rows = pos.to(torch.int32) + first_row[None, :, None]
        b0 = start // block_n
        out_v[:, b0 : b0 + blocks, :kk] = vals
        out_i[:, b0 : b0 + blocks, :kk] = torch.where(torch.isneginf(vals), _INT_MAX, rows)
    return out_v, out_i


def exact_block_topk_plain(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    *,
    count: int,
    metric: str = "ip",
    mask: Optional[torch.Tensor] = None,
    cnorms: Optional[torch.Tensor] = None,
    block_n: int = DEFAULT_BLOCK_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 1, with the same outputs: each
    block's top-k float32 scores (higher is better; l2 as
    ``-(|q|²+|c|²-2q·c)``) and int32 global row ids, as in
    :func:`plain_block_topk`."""
    qf = queries.float()
    qn = (qf * qf).sum(dim=1)

    def score_rows(start, stop):
        cn = None if cnorms is None else cnorms[start:stop]
        return mask_scores(score_chunk(corpus[start:stop], qf, qn, metric, cn), start, stop, count, mask)

    return plain_block_topk(score_rows, corpus.shape[0], qf.shape[0], k, block_n, corpus.device)


def block_topk(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    *,
    count: int,
    metric: str = "ip",
    mask: Optional[torch.Tensor] = None,
    cnorms: Optional[torch.Tensor] = None,
    block_n: int = DEFAULT_BLOCK_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1: per-block top-k of ``queries`` over ``corpus``.

    ``corpus`` ``[N, D]`` and ``queries`` ``[Q, D]`` are float32 or
    bfloat16 (the same dtype); ``mask`` is int8 ``[N]``; ``cnorms`` is the
    float32 ``[N]`` row norms that ``metric="l2"`` needs.  Outputs as in
    :func:`exact_block_topk_plain`.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel or raises."""
    if corpus.device.type == "cpu":
        return exact_block_topk_plain(
            corpus, queries, k, count=count, metric=metric, mask=mask,
            cnorms=cnorms, block_n=block_n,
        )
    if corpus.device.type != "cuda":
        raise ValueError(f"block_topk: unsupported device {corpus.device}")
    if corpus.dtype not in (torch.float32, torch.bfloat16) or corpus.ndim != 2:
        raise ValueError(f"block_topk: corpus must be [N, D] float32 or bfloat16, got {corpus.dtype}")
    (n, d), q, dev = corpus.shape, queries.shape[0], corpus.device
    _cuda.require("block_topk corpus", corpus, dev, corpus.dtype, (n, d))
    _cuda.require("block_topk queries", queries, dev, corpus.dtype, (q, d))
    if n == 0 or q == 0 or not 1 <= k <= min(MAX_KERNEL_K, block_n):
        raise ValueError(f"block_topk: n={n}, q={q}, k={k} outside the kernel's range")
    nb = -(-n // block_n)  # a block_n the kernel cannot fit comes back as a CUDA error
    if mask is not None:
        _cuda.require("block_topk mask", mask, dev, torch.int8, (n,))
    l2 = metric == "l2"
    qnorms = None
    if l2:
        _cuda.require("block_topk cnorms", cnorms, dev, torch.float32, (n,))
        qf = queries.float()
        qnorms = (qf * qf).sum(dim=1)
    out_v = torch.empty((q, nb, k), dtype=torch.float32, device=corpus.device)
    out_i = torch.empty((q, nb, k), dtype=torch.int32, device=corpus.device)
    lib = _cuda.library()
    fn = lib.pse_block_topk_bf16 if corpus.dtype == torch.bfloat16 else lib.pse_block_topk_f32
    err = fn(
        _cuda.ptr(corpus), _cuda.ptr(queries), _cuda.ptr(qnorms),
        _cuda.ptr(cnorms if l2 else None), _cuda.ptr(mask),
        _cuda.ptr(out_v), _cuda.ptr(out_i),
        n, d, q, int(min(count, n)), k, block_n, int(l2),
        _cuda.stream(corpus.device),
    )
    _cuda.check(err, "block_topk")
    block_topk.launches += 1
    return out_v, out_i


block_topk.launches = 0  # kernel launches (read by chip_smoke.py)


def merge_partials(part_v, part_i, k):
    """Phase B: stable merge of per-block partials ``[Q, NB, kb]`` to k."""
    q = part_v.shape[0]
    vals, pos = stable_topk(part_v.reshape(q, -1), k)
    return vals, torch.gather(part_i.reshape(q, -1), 1, pos)


# ---------------------------------------------------------------------------
# Search entry points
# ---------------------------------------------------------------------------


def plain_topk(score_rows, n: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over rows ``[0, n)`` of the scores ``score_rows(start, stop)``
    gives (invalid rows already ``-inf``), in row chunks that bound the
    float32 temporary: chunk-local stable top-k, then a stable merge, so
    ties go to the smallest row as in one full stable sort.  Kernel-space
    values and int32 row ids."""
    vals_parts, idx_parts = [], []
    for start in range(0, n, _PLAIN_ROWS):
        stop = min(n, start + _PLAIN_ROWS)
        vals, pos = stable_topk(score_rows(start, stop), min(k, stop - start))
        vals_parts.append(vals)
        idx_parts.append(pos + start)
    vals, pos = stable_topk(torch.cat(vals_parts, dim=1), k)
    return vals, torch.gather(torch.cat(idx_parts, dim=1), 1, pos).to(torch.int32)


def exact_search_plain(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    *,
    count: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
    metric: str = "cosine",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain exact search (torch counterpart of ``exact_search_oracle``):
    row-chunked float32 scores, chunk-local stable top-k, stable merge.
    Queries are cast to the corpus dtype for the product; the l2 query
    norm uses them as given, as the JAX oracle does."""
    queries = torch.atleast_2d(queries)
    n = corpus.shape[0]
    k = min(k, n) if n else 0
    if n == 0 or k == 0:
        return _empty(queries.shape[0], corpus.device)
    count = n if count is None else int(count)
    qf = queries.to(corpus.dtype).float()
    q32 = queries.float()
    qn = (q32 * q32).sum(dim=1)
    metric = "l2" if metric == "l2" else "ip"

    def score_rows(start, stop):
        return mask_scores(score_chunk(corpus[start:stop], qf, qn, metric), start, stop, count, mask)

    return _finalize(*plain_topk(score_rows, n, k), metric)


def exact_search(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    *,
    count: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
    metric: str = "cosine",
    block_n: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN over ``corpus`` for ``queries`` (``[Q, D]`` or ``[D]``).

    k ≤ 64 runs kernel 1 (:func:`block_topk`) and the phase-B merge;
    larger k runs :func:`exact_search_plain`.  Rows where ``mask <= 0`` or
    at or past ``count`` are excluded.  Returns ``(distances [Q, k]
    float32, indices [Q, k] int32)`` in FAISS conventions."""
    queries = torch.atleast_2d(queries)
    n = corpus.shape[0]
    k = min(k, n) if n else 0
    if n == 0 or k == 0:
        return _empty(queries.shape[0], corpus.device)
    if k > MAX_KERNEL_K:
        return exact_search_plain(
            corpus, queries, k, count=count, mask=mask, metric=metric
        )
    metric = "l2" if metric == "l2" else "ip"
    bn = block_n or DEFAULT_BLOCK_N
    cnorms = row_sq_norms(corpus) if metric == "l2" else None
    if mask is not None:
        mask = (mask > 0).to(torch.int8)
    part_v, part_i = block_topk(
        corpus.contiguous(),
        queries.to(corpus.dtype).contiguous(),
        min(k, bn),
        count=n if count is None else int(count),
        metric=metric,
        mask=mask,
        cnorms=cnorms,
        block_n=bn,
    )
    vals, idx = merge_partials(part_v, part_i, k)
    return _finalize(vals, idx, metric)

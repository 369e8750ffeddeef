"""Per-query filtered exact search: kernel 5 and its host contract.

Counterpart of ``photo_search_engine_tpu/ops/grouped_mask.py``.  A batch
whose queries carry different predicates (season, time of day, date) is
one scan.  The filters are factored as

* ``mask_table`` — ``[M, N]`` int8, one row per distinct predicate (M ≤ 8
  in serving; the micro-batcher puts the all-ones row 0 first for its
  unfiltered requests);
* ``mask_ids`` — ``[Q]`` int32, each query's predicate row.

Query q keeps row j when ``j < count``, ``0 <= mask_ids[q] < M`` and
``mask_table[mask_ids[q], j] > 0``.  An id outside ``[0, M)`` keeps no
row, as in the TPU kernel, whose one-hot selection then matches no
predicate row.  Inner product only, as in the JAX package.

* :func:`grouped_block_topk` — kernel 5, the grouped variant of kernel 1
  in ``csrc/block_topk.cu`` (port of ``_grouped_kernel``): each query reads
  its own predicate row in the epilogue, where the TPU kernel used a
  one-hot ``[BQ, M] × [M, BN]`` product on the MXU.
* phase B — kernel 1's merge (``merge_partials``, ``lax.top_k``'s order).
* :func:`fast_grouped_block_topk` — kernel 3 through kernel 5's body
  (``grouped_mask_search(impl="pallas_fast")``): the packed-key selection,
  then the exact rescore of the k winners (inner product, as JAX's
  ``grouped_mask.py:276-285``).

Both score bfloat16 rows with D % 8 == 0 on the tensor cores and float32
rows with D % 4 == 0 with IEEE fmaf on the same TMA ring
(``csrc/block_score_tc.cuh``, 16-byte-aligned bases), every other corpus on
the FMA loop (``topk.scoring_loop``).

``impl`` takes the JAX package's values: ``"auto"``, ``"pallas"`` and
``"pallas_fused"`` run kernel 5 (the JAX function has no fused grouped
scan: ``pallas_fused`` takes its two-phase kernel), ``"pallas_fast"``
kernel 3, ``"lax"`` :func:`grouped_mask_plain`; any other value raises.
k > 64 takes :func:`grouped_mask_plain`, exact like the JAX oracle.  The
JAX store sends large k on big corpora to ApproxTopK
(``grouped_approx_large_k``), a TPU choice; off the TPU that computes the
same exact result.  The CUDA kernel does not depend on M being a power of
two: :func:`bucket_mask_table` bounds TPU compiles and is kept so that the
micro-batcher builds the same host table as the JAX one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from photo_search_engine_tpu_torch.ops import _cuda
from photo_search_engine_tpu_torch.ops.topk import (
    DEFAULT_BLOCK_N,
    FAST_MAX_BN,
    MAX_KERNEL_K,
    _empty,
    _finalize,
    check_impl,
    mask_scores,
    merge_partials,
    plain_block_topk,
    plain_topk,
    rescore_pool,
    score_chunk,
    scoring_loop,
)

_MASK_BUCKET_MIN = 2


def bucket_mask_table(mask_table: np.ndarray) -> np.ndarray:
    """Pad the predicate table's row count up to the next power of two
    (≥ 2) with all-zero rows that no id references (numpy path of the JAX
    function)."""
    m = int(mask_table.shape[0])
    target = max(_MASK_BUCKET_MIN, 1 << max(m - 1, 0).bit_length())
    if target == m:
        return mask_table
    pad = np.zeros((target - m,) + mask_table.shape[1:], mask_table.dtype)
    return np.concatenate([mask_table, pad])


def grouped_mask_scores(scores, start, stop, count, mask_table, mask_ids) -> torch.Tensor:
    """``-inf`` where row ``start + j`` is at or past ``count`` or where
    the query's own predicate drops it: the scan contract of kernels 5 and 6."""
    m = mask_table.shape[0]
    known = (mask_ids >= 0) & (mask_ids < m)
    rows = mask_table[torch.clamp(mask_ids, 0, m - 1).long(), start:stop] > 0
    keep = rows & known[:, None]
    return torch.where(keep, mask_scores(scores, start, stop, count, None), float("-inf"))


def grouped_mask_plain(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    mask_table: torch.Tensor,
    mask_ids: torch.Tensor,
    k: int,
    *,
    count: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain per-query filtered search (counterpart of
    ``grouped_mask_oracle``): row-chunked float32 scores, top-k in
    ``lax.top_k``'s order (``topk.plain_topk``).
    Queries are cast to the corpus dtype for the product.  FAISS-style
    ``(distances desc, indices)``; -1 in empty slots."""
    queries = torch.atleast_2d(queries)
    n = corpus.shape[0]
    k = min(k, n) if n else 0
    if n == 0 or k == 0:
        return _empty(queries.shape[0], corpus.device)
    count = n if count is None else int(count)
    score_rows = _grouped_score_rows(corpus, queries.to(corpus.dtype).float(), count, mask_table, mask_ids)
    return _finalize(*plain_topk(score_rows, n, k), "ip")


def _grouped_score_rows(corpus, qf, count, mask_table, mask_ids):
    """``score_rows(start, stop)``: float32 inner products of rows
    ``[start, stop)`` under each query's predicate (``grouped_mask_scores``)."""

    def score_rows(start, stop):
        scores = score_chunk(corpus[start:stop], qf, None, "ip")
        return grouped_mask_scores(scores, start, stop, count, mask_table, mask_ids)

    return score_rows


# ---------------------------------------------------------------------------
# Kernel 5: grouped per-block top-k (csrc/block_topk.cu) and its plain version
# ---------------------------------------------------------------------------


def grouped_block_topk_plain(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    mask_table: torch.Tensor,
    mask_ids: torch.Tensor,
    k: int,
    *,
    count: int,
    block_n: int = DEFAULT_BLOCK_N,
    fast: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 5 (``fast``: of kernel 3 through
    kernel 5's body), with kernel 1's outputs: ``[Q, NB, k]`` float32 inner
    products (``fast``: quantized) and int32 global row ids, ties to the
    smallest row, slots with no valid row ``-inf`` and ``INT_MAX``
    (``fast``: see ``topk.packed_key_topk_plain``)."""
    score_rows = _grouped_score_rows(corpus, queries.float(), count, mask_table, mask_ids)
    return plain_block_topk(score_rows, corpus.shape[0], queries.shape[0], k, block_n, corpus.device, fast=fast)


def fast_grouped_block_topk_plain(corpus, queries, mask_table, mask_ids, k, *, count,
                                  block_n=DEFAULT_BLOCK_N) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of grouped kernel 3."""
    return grouped_block_topk_plain(corpus, queries, mask_table, mask_ids, k, count=count,
                                    block_n=block_n, fast=True)


def _launch_grouped_scan(name, fast, corpus, queries, mask_table, mask_ids, k, count, block_n, loop):
    """Checks and launch of kernel 5 (``fast``: grouped kernel 3) on CUDA
    tensors, on the scoring loop ``loop``."""
    if corpus.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {corpus.device}")
    if corpus.dtype not in (torch.float32, torch.bfloat16) or corpus.ndim != 2:
        raise ValueError(f"{name}: corpus must be [N, D] float32 or bfloat16, got {corpus.dtype}")
    (n, d), q, dev = corpus.shape, queries.shape[0], corpus.device
    m = mask_table.shape[0]
    _cuda.require(f"{name} corpus", corpus, dev, corpus.dtype, (n, d))
    _cuda.require(f"{name} queries", queries, dev, corpus.dtype, (q, d))
    _cuda.require(f"{name} mask_table", mask_table, dev, torch.int8, (m, n))
    _cuda.require(f"{name} mask_ids", mask_ids, dev, torch.int32, (q,))
    if loop != "fma" or corpus.dtype == torch.bfloat16:
        _cuda.require_aligned(f"{name} corpus", corpus)
        _cuda.require_aligned(f"{name} queries", queries)
    if n == 0 or q == 0 or not 1 <= k <= min(MAX_KERNEL_K, block_n):
        raise ValueError(f"{name}: n={n}, q={q}, k={k} outside the kernel's range")
    if fast and block_n > FAST_MAX_BN:
        raise ValueError(f"{name}: block_n={block_n} above the packed keys' {FAST_MAX_BN}")
    nb = -(-n // block_n)  # a block_n the kernel cannot fit comes back as a CUDA error
    out_v = torch.empty((q, nb, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, nb, k), dtype=torch.int32, device=dev)
    lib = _cuda.library()
    prefix = "pse_fast_grouped_block_topk" if fast else "pse_grouped_block_topk"
    args = (_cuda.ptr(corpus), _cuda.ptr(queries), _cuda.ptr(mask_table), _cuda.ptr(mask_ids),
            _cuda.ptr(out_v), _cuda.ptr(out_i), n, d, q, int(min(count, n)), k, block_n, m)
    if corpus.dtype == torch.bfloat16:
        err = getattr(lib, f"{prefix}_bf16")(*args, _cuda.stream(dev))
    else:
        err = getattr(lib, f"{prefix}_f32")(*args, int(loop == "fma_ring"), _cuda.stream(dev))
    _cuda.check(err, name)
    return out_v, out_i


def grouped_block_topk(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    mask_table: torch.Tensor,
    mask_ids: torch.Tensor,
    k: int,
    *,
    count: int,
    block_n: int = DEFAULT_BLOCK_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 5: per-block top-k of ``queries`` over ``corpus``, each query
    under its own predicate row.

    ``corpus`` ``[N, D]`` and ``queries`` ``[Q, D]`` are float32 or
    bfloat16 (the same dtype; on 16-byte-aligned bases, except on the FMA
    loop); ``mask_table`` is int8 ``[M, N]`` and ``mask_ids`` int32
    ``[Q]``.  Outputs as in :func:`grouped_block_topk_plain`.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (its scoring
    loop as ``topk.scoring_loop`` says) or raises."""
    if corpus.device.type == "cpu":
        return grouped_block_topk_plain(
            corpus, queries, mask_table, mask_ids, k, count=count, block_n=block_n
        )
    loop = scoring_loop(corpus)
    return _launch_grouped_scan("grouped_block_topk", False, corpus, queries, mask_table, mask_ids, k,
                                count, block_n, loop)


def fast_grouped_block_topk(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    mask_table: torch.Tensor,
    mask_ids: torch.Tensor,
    k: int,
    *,
    count: int,
    block_n: int = DEFAULT_BLOCK_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped kernel 3: kernel 5 with packed-key selection (``block_n <=
    2048``).  Inputs as :func:`grouped_block_topk`; the partial values are
    quantized.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (its scoring loop as ``topk.scoring_loop`` says) or
    raises."""
    if corpus.device.type == "cpu":
        return fast_grouped_block_topk_plain(
            corpus, queries, mask_table, mask_ids, k, count=count, block_n=block_n
        )
    loop = scoring_loop(corpus)
    return _launch_grouped_scan("fast_grouped_block_topk", True, corpus, queries, mask_table, mask_ids,
                                k, count, block_n, loop)


def predicate_inputs(mask_table: torch.Tensor, mask_ids: torch.Tensor, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table and ids in the form kernels 5 and 6 take: contiguous int8
    ``(table > 0)`` and int32 ids on ``device``."""
    table = (mask_table.to(device) > 0).to(torch.int8).contiguous()
    return table, mask_ids.to(device=device, dtype=torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Search entry point
# ---------------------------------------------------------------------------


def grouped_mask_search(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    mask_table: torch.Tensor,
    mask_ids: torch.Tensor,
    k: int,
    *,
    count: Optional[int] = None,
    impl: str = "auto",
    block_n: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched per-query filtered top-k (inner product) over ``corpus``
    ``[N, D]`` for ``queries`` ``[Q, D]``, ``mask_table`` ``[M, N]`` and
    ``mask_ids`` ``[Q]``.  For k ≤ 64, ``impl`` picks the scan (module
    docstring): kernel 5 and the merge, or kernel 3 and the exact
    rescore (``"pallas_fast"``); ``"lax"`` and larger k run
    :func:`grouped_mask_plain`.  Returns FAISS-style ``(distances desc
    [Q, k], indices [Q, k] int32)``, -1 in empty slots."""
    check_impl(impl)
    queries = torch.atleast_2d(queries)
    n = corpus.shape[0]
    k = min(k, n) if n else 0
    if n == 0 or k == 0:
        return _empty(queries.shape[0], corpus.device)
    table, ids = predicate_inputs(mask_table, mask_ids, corpus.device)
    count = n if count is None else int(count)
    if impl == "lax" or k > MAX_KERNEL_K:
        return grouped_mask_plain(corpus, queries, table, ids, k, count=count)
    bn = block_n or DEFAULT_BLOCK_N
    corpus = corpus.contiguous()
    queries = queries.to(corpus.dtype).contiguous()
    if impl == "pallas_fast":
        bn = min(bn, FAST_MAX_BN)
        part_v, part_i = fast_grouped_block_topk(corpus, queries, table, ids, min(k, bn), count=count, block_n=bn)
        return _finalize(*rescore_pool(part_v, part_i, corpus, queries.float(), k, cand=k, metric="ip"), "ip")
    part_v, part_i = grouped_block_topk(corpus, queries, table, ids, min(k, bn), count=count, block_n=bn)
    return _finalize(*merge_partials(part_v, part_i, k), "ip")

"""Exact corpus scan + top-k: kernels 1, 3 and 4 and their host contract.

Counterpart of ``photo_search_engine_tpu/ops/topk.py``.  :func:`exact_search`
takes the JAX package's ``impl`` values:

* ``"auto"`` / ``"pallas"`` — the two-phase scan, as on the TPU.  Phase A,
  :func:`block_topk`, is kernel 1 (``csrc/block_topk.cu``, port of
  ``_block_topk_kernel`` with ``fast=False``): for every block of
  ``block_n`` corpus rows it scores the queries and keeps the block's
  top-k, ties to the smallest row.  Phase B is a stable descending sort
  over the ``[Q, NB·k]`` partials in ``lax.top_k``'s total order
  (:func:`total_order_topk`).  Blocks are laid out in ascending row order,
  so equal scores keep the smallest index, which makes the result
  identical to JAX's ``lax.top_k`` over every row.
* ``"pallas_fast"`` — kernel 3, :func:`fast_block_topk` (kernel 1 with the
  packed-key selection of ``_extract_block_topk_fast``, ``block_n`` at most
  2048): the partials hold quantized scores, so after the merge the k
  winners are rescored exactly and re-sorted (:func:`rescore_pool`).
* ``"pallas_fused"`` — kernel 4, :func:`fused_topk` (``csrc/fused_topk.cu``,
  port of ``_topk_kernel``): a running top-k over contiguous ranges of
  blocks, the range partials merged on the card.
* ``"lax"`` — :func:`exact_search_plain`.

Any other ``impl`` raises.

Kernels 1, 3 and 4 score bfloat16 rows with D % 8 == 0 on the tensor cores
and float32 rows with D % 4 == 0 with IEEE fmaf on the same TMA ring
(``csrc/block_score_tc.cuh``, 16-byte-aligned bases), every other corpus
on the FMA loop (:func:`scoring_loop`).

Contract (FAISS flat conventions, as in the JAX package): ``ip``/
``cosine`` distances are inner products sorted descending; ``l2``
distances are squared distances sorted ascending; an empty slot holds
index ``-1`` and ``-inf`` (``+inf`` for l2); ``count`` masks rows past
the live count; ``mask`` excludes rows where it is ``<= 0``.

For ``k > 64`` every ``impl`` takes :func:`exact_search_plain`:
a row-chunked float32 product plus a top-k in ``lax.top_k``'s order,
exact like the JAX oracle.  (The JAX store's ApproxTopK route at large k
was a TPU choice.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from photo_search_engine_tpu_torch.ops import _cuda

MAX_KERNEL_K = 64
DEFAULT_BLOCK_N = 1024  # corpus rows per kernel-1 block
FAST_MAX_BN = 2048  # packed lane ids carry at most 11 bits
IMPLS = ("auto", "pallas", "pallas_fast", "pallas_fused", "lax")
FUSED_MIN_CTAS_PER_SM = 2  # kernel 4's ranges on the FMA loop: at least two CTAs per SM
# kernel 4's CTAs an SM on the tensor cores, by query tile: at most the 2 of
# __launch_bounds__(kThreadsTc, 2); at BQ 8 one CTA an SM already keeps the
# corpus read in flight and ran fastest (scripts/torch_kernel_sweep.py
# --fused-only, PERF.md)
TC_FUSED_CTAS_PER_SM = {8: 1, 32: 2}
SM_SHARED_BYTES = 233472  # shared memory of one H100 SM (228 KB)
H100_SMS = 132  # SMs assumed when no card is asked (the plain version)
_INT_MAX = torch.iinfo(torch.int32).max
_PLAIN_ROWS = 65536  # rows per chunk of the plain scans (bounds the f32 temp)
# rows of a total-order top-k from which torch.topk of packed int64 keys
# runs instead of the stable sort of int32 keys (scripts/torch_kernel_ab.py
# times both on the card, PERF.md)
TOTAL_ORDER_PACKED_MIN_ROWS = 64


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
    """Top-k along the last axis by float comparison, ties to the smallest
    position: what the Pallas kernels' ``comb == m`` extraction gives, so
    ``+0.0`` and ``-0.0`` tie by position.  ``torch.topk`` does not promise
    that order; a stable sort does."""
    vals, pos = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def total_order_topk(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of float32 ``values`` along the last axis in ``lax.top_k``'s
    order: IEEE totalOrder, +NaN, +inf, ..., +0.0, -0.0, ..., -inf, -NaN,
    ties of identical bits to the smallest position.  Each float's bits
    become an int32 key that orders that way (:func:`_flip_key`).  From
    :data:`TOTAL_ORDER_PACKED_MIN_ROWS` rows on, the top-k of unique int64
    keys (the int32 key above the inverted position) is taken by
    ``torch.topk`` (:func:`_packed_total_order_topk`); below, where that
    is slower, the int32 keys are sorted stably
    (:func:`_sorted_total_order_topk`).  Both give the same result.  For
    the sites whose JAX counterpart is a ``lax.top_k``; the sites that
    follow a Pallas kernel's float comparison keep :func:`stable_topk`."""
    rows = values.numel() // max(1, values.shape[-1])
    if rows >= TOTAL_ORDER_PACKED_MIN_ROWS:
        return _packed_total_order_topk(values, k)
    return _sorted_total_order_topk(values, k)


def _sorted_total_order_topk(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`total_order_topk` by a stable descending sort of the int32
    keys."""
    keys = _flip_key(values.contiguous().view(torch.int32))
    pos = torch.sort(keys, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(values, -1, pos), pos


def _packed_total_order_topk(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`total_order_topk` by ``torch.topk`` of unique int64 keys: the
    int32 key in the high word, ``INT32_MAX - position`` in the low one,
    so equal keys rank by the smallest position and the order is total."""
    keys = _flip_key(values.contiguous().view(torch.int32)).to(torch.int64) << 32
    keys |= _INT_MAX - torch.arange(values.shape[-1], dtype=torch.int64, device=values.device)
    top = torch.topk(keys, k, dim=-1).values
    pos = _INT_MAX - (top & 0xFFFFFFFF)
    return torch.gather(values, -1, pos), pos


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


def _flip_key(bits: torch.Tensor) -> torch.Tensor:
    """The sign flip of the packed keys (an involution on int32): float
    order becomes int32 order."""
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def packed_key_topk_plain(scores: torch.Tensor, col_base, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row of the float32 score tile ``scores`` ``[..., bn]``
    by packed keys, bit for bit as JAX's ``_extract_block_topk_fast``
    (``topk.py:301-342``): each score's bits become a totally ordered
    int32 key whose low ``max(10, bit_length(bn - 1))`` bits are replaced
    by ``lm - lane``, so keys are unique and ties go to the smallest lane.
    Values are the winning keys' window tops with the flip inverted
    (quantized upward); ids are ``col_base + lane``, also for ``-inf``
    slots.  Requires ``k <= bn <= 2048``."""
    bn = scores.shape[-1]
    if bn > FAST_MAX_BN or not 1 <= k <= bn:
        raise ValueError(f"packed-key extraction requires k <= bn <= {FAST_MAX_BN}, got k={k}, bn={bn}")
    lm = (1 << max(10, (bn - 1).bit_length())) - 1
    lane = torch.arange(bn, dtype=torch.int32, device=scores.device)
    keys = (_flip_key(scores.contiguous().view(torch.int32)) & ~lm) | (lm - lane)
    top = torch.topk(keys, k, dim=-1).values  # unique keys: the k rounds of max
    vals = _flip_key(top | lm).view(torch.float32)
    return vals, (col_base + (lm - (top & lm))).to(torch.int32)


def plain_block_topk(score_rows, n, nq, k, block_n, device, *, fast=False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each ``block_n``-row block's top-k of the scores ``score_rows(start,
    stop)`` gives for rows ``[start, stop)`` (invalid rows already ``-inf``):
    ``[Q, NB, k]`` values and int32 global row ids, ties to the smallest row,
    slots with no valid row ``-inf`` and ``INT_MAX``.  ``fast`` selects by
    :func:`packed_key_topk_plain` instead (kernel 3).  Scores are made in
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
        scores = scores.reshape(nq, blocks, block_n)
        first_row = (start + block_n * torch.arange(blocks, dtype=torch.int32, device=device))[None, :, None]
        if fast:
            vals, rows = packed_key_topk_plain(scores, first_row, kk)
        else:
            vals, pos = stable_topk(scores, kk)
            rows = torch.where(torch.isneginf(vals), _INT_MAX, pos.to(torch.int32) + first_row)
        b0 = start // block_n
        out_v[:, b0 : b0 + blocks, :kk] = vals
        out_i[:, b0 : b0 + blocks, :kk] = rows
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
    fast: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 1 (``fast``: of kernel 3), with the
    same outputs: each block's top-k float32 scores (higher is better; l2
    as ``-(|q|²+|c|²-2q·c)``; kernel 3: quantized) and int32 global row
    ids, as in :func:`plain_block_topk`."""
    qf = queries.float()
    qn = (qf * qf).sum(dim=1)

    def score_rows(start, stop):
        cn = None if cnorms is None else cnorms[start:stop]
        return mask_scores(score_chunk(corpus[start:stop], qf, qn, metric, cn), start, stop, count, mask)

    return plain_block_topk(score_rows, corpus.shape[0], qf.shape[0], k, block_n, corpus.device, fast=fast)


def fast_block_topk_plain(corpus, queries, k, *, count, metric="ip", mask=None, cnorms=None,
                          block_n=DEFAULT_BLOCK_N) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 3: kernel 1's plain scoring, then
    :func:`packed_key_topk_plain` in every block."""
    return exact_block_topk_plain(corpus, queries, k, count=count, metric=metric, mask=mask,
                                  cnorms=cnorms, block_n=block_n, fast=True)


SCORING_LOOPS = ("tensor_core", "fma_ring", "fma")


def scoring_loop(corpus: torch.Tensor) -> str:
    """Which scoring loop kernels 1, 3, 4 and 5 run on ``corpus``, by
    whether TMA takes the rows' byte stride: ``"tensor_core"``
    (wgmma fed by the TMA ring of ``csrc/block_score_tc.cuh``) for bfloat16
    rows with D % 8 == 0; ``"fma_ring"`` (the same ring, IEEE fmaf
    consumers: float32 keeps full precision by contract) for float32 rows
    with D % 4 == 0; ``"fma"`` (``csrc/block_score.cuh``) otherwise."""
    d = corpus.shape[1]
    if corpus.dtype == torch.bfloat16 and d % 8 == 0:
        return "tensor_core"
    if corpus.dtype == torch.float32 and d % 4 == 0:
        return "fma_ring"
    return "fma"


def tc_shared_bytes(bq: int, stages: int) -> int:
    """Shared memory of one CTA of the TMA ring (``tc::smem_bytes`` in
    ``csrc/block_score_tc.cuh``, from the constants of that header and of
    ``block_select.cuh``): alignment slack, the ring of corpus and query
    boxes and a pass's score tile and candidate buffers (at BQ 32 laid over
    the ring), the running top-k lists, the mbarriers.  It does not depend
    on block_n, nor on the operand (bf16 kernels 1 and 5, int8 kernels 2
    and 6, the f32 fmaf ring): a box row is 128 bytes of any."""
    c = {**_cuda.header_constants("block_select.cuh"), **_cuda.header_constants("block_score_tc.cuh")}
    ring = stages * c["kRowTile"] * c["kSwizzleBytes"] + c["kQueryStages"] * bq * c["kSwizzleBytes"]
    tile = (bq * (c["kListSlots"] + c["kPassRows"] + c["kPitchPad"]) * 4
            + 8 * (c["kCandidates"] + c["kListSlots"]) * 8)
    over = max(ring, tile) if bq > c["kSmallBQ"] else ring + tile  # the tile over the ring at BQ 32
    return c["kAlign"] + over + bq * c["kListSlots"] * 8 + 8 * (2 * stages + 2 * c["kQueryStages"] + 1)


def ring_stages(loop: str, bq: int) -> int:
    """Corpus stages of the ring's CTA on ``loop``: ``kStages`` on the
    tensor cores; on the f32 ring one a row tile at BQ 8 and
    ``kFfmaLargeDepth`` a row tile at BQ 32 (``tc::ffma_stages``), whose
    shared memory then takes one CTA an SM."""
    c = _cuda.header_constants("block_score_tc.cuh")
    if loop == "fma_ring":
        return c["kPassTiles"] * (c["kFfmaLargeDepth"] if bq > c["kSmallBQ"] else 1)
    return c["kStages"]


def ring_ctas_per_sm(loop: str, bq: int, cap: int = 2) -> int:
    """CTAs of the ring's scan an SM holds: at most ``cap`` (the 2 of
    ``__launch_bounds__(288, 2)``), no more than :func:`tc_shared_bytes`
    lets it, each CTA with the SM's 1 KB reserve."""
    return max(1, min(cap, SM_SHARED_BYTES // (tc_shared_bytes(bq, ring_stages(loop, bq)) + 1024)))


def _launch_block_scan(name, fast, corpus, queries, k, count, metric, mask, cnorms, block_n, loop):
    """Checks and launch of kernel 1 (``fast``: kernel 3) on CUDA tensors,
    on the scoring loop ``loop``."""
    if corpus.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {corpus.device}")
    if corpus.dtype not in (torch.float32, torch.bfloat16) or corpus.ndim != 2:
        raise ValueError(f"{name}: corpus must be [N, D] float32 or bfloat16, got {corpus.dtype}")
    (n, d), q, dev = corpus.shape, queries.shape[0], corpus.device
    _cuda.require(f"{name} corpus", corpus, dev, corpus.dtype, (n, d))
    _cuda.require(f"{name} queries", queries, dev, corpus.dtype, (q, d))
    if loop != "fma" or corpus.dtype == torch.bfloat16:
        _cuda.require_aligned(f"{name} corpus", corpus)
        _cuda.require_aligned(f"{name} queries", queries)
    if n == 0 or q == 0 or not 1 <= k <= min(MAX_KERNEL_K, block_n):
        raise ValueError(f"{name}: n={n}, q={q}, k={k} outside the kernel's range")
    if fast and block_n > FAST_MAX_BN:
        raise ValueError(f"{name}: block_n={block_n} above the packed keys' {FAST_MAX_BN}")
    nb = -(-n // block_n)  # a block_n the kernel cannot fit comes back as a CUDA error
    if mask is not None:
        _cuda.require(f"{name} mask", mask, dev, torch.int8, (n,))
    l2 = metric == "l2"
    qnorms = None
    if l2:
        _cuda.require(f"{name} cnorms", cnorms, dev, torch.float32, (n,))
        qf = queries.float()
        qnorms = (qf * qf).sum(dim=1)
    out_v = torch.empty((q, nb, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, nb, k), dtype=torch.int32, device=dev)
    lib = _cuda.library()
    prefix = "pse_fast_block_topk" if fast else "pse_block_topk"
    args = (_cuda.ptr(corpus), _cuda.ptr(queries), _cuda.ptr(qnorms), _cuda.ptr(cnorms if l2 else None),
            _cuda.ptr(mask), _cuda.ptr(out_v), _cuda.ptr(out_i), n, d, q, int(min(count, n)), k, block_n, int(l2))
    if corpus.dtype == torch.bfloat16:
        err = getattr(lib, f"{prefix}_bf16")(*args, _cuda.stream(dev))
    else:
        err = getattr(lib, f"{prefix}_f32")(*args, int(loop == "fma_ring"), _cuda.stream(dev))
    _cuda.check(err, name)
    return out_v, out_i


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
    bfloat16 (the same dtype; on 16-byte-aligned bases, except on the FMA
    loop); ``mask`` is int8 ``[N]``; ``cnorms`` is the float32 ``[N]`` row
    norms that ``metric="l2"`` needs.  Outputs as in
    :func:`exact_block_topk_plain`.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (its scoring loop as
    :func:`scoring_loop` says) or raises."""
    if corpus.device.type == "cpu":
        return exact_block_topk_plain(
            corpus, queries, k, count=count, metric=metric, mask=mask,
            cnorms=cnorms, block_n=block_n,
        )
    loop = scoring_loop(corpus)
    return _launch_block_scan("block_topk", False, corpus, queries, k, count, metric, mask, cnorms, block_n, loop)


def fast_block_topk(
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
    """Kernel 3: kernel 1 with packed-key selection (``block_n <= 2048``).
    Inputs as :func:`block_topk`; the partial values are the quantized
    scores of :func:`packed_key_topk_plain`, bit for bit where the scores
    agree.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (its scoring loop as :func:`scoring_loop` says) or raises."""
    if corpus.device.type == "cpu":
        return fast_block_topk_plain(
            corpus, queries, k, count=count, metric=metric, mask=mask,
            cnorms=cnorms, block_n=block_n,
        )
    loop = scoring_loop(corpus)
    return _launch_block_scan("fast_block_topk", True, corpus, queries, k, count, metric, mask, cnorms, block_n,
                              loop)


def merge_partials(part_v, part_i, k):
    """Phase B: merge of per-block partials ``[Q, NB, kb]`` to k in
    ``lax.top_k``'s order (:func:`total_order_topk`), as JAX's phase B
    (``topk.py:462``, ``grouped_mask.py:274``)."""
    q = part_v.shape[0]
    vals, pos = total_order_topk(part_v.reshape(q, -1), k)
    return vals, torch.gather(part_i.reshape(q, -1), 1, pos)


def rescore_pool(part_v, part_i, corpus_ref, queries, k, *, cand, metric):
    """The tail of the scans whose partials hold quantized scores: the int8
    tier (JAX ``quantized.py`` :311-336 and :440-457) and kernel 3
    (``topk.py`` :457-479, ``cand = k``).  Merge the per-block partials to
    the ``cand`` pool and rescore the pool exactly against ``corpus_ref``.  Kernel-space values (higher
    is better) and int32 row ids; slots that found no row hold ``-inf``.
    Both top-ks are ``lax.top_k``'s in JAX, so both take its order
    (:func:`total_order_topk`)."""
    n = corpus_ref.shape[0]
    nq = queries.shape[0]
    pool = min(cand, part_v.shape[1] * part_v.shape[2])
    cv, pos = total_order_topk(part_v.reshape(nq, -1), pool)
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
    vals, order = total_order_topk(exact, k)
    return vals, torch.gather(ci, 1, order)


# ---------------------------------------------------------------------------
# Kernel 4: fused running top-k (csrc/fused_topk.cu) and its plain version
# ---------------------------------------------------------------------------


def kernel_block_q(nq: int) -> int:
    """Queries per CTA of kernels 1, 3 and 4 (their ``dispatch``)."""
    return 8 if nq <= 8 else 32


def fused_ranges(nq: int, nb: int, sm_count: int = H100_SMS, *, loop: str, block_n: int = DEFAULT_BLOCK_N,
                 k: int = MAX_KERNEL_K) -> Tuple[int, int]:
    """``(ranges, blocks_per_range)`` of kernel 4: contiguous runs of
    blocks, enough of them over the query tiles to fill the CTA slots of
    the SMs once, and none empty.  ``loop`` is the scoring loop that will
    run (:func:`scoring_loop` of the corpus).  On the TMA ring (``loop=
    "tensor_core"`` or ``"fma_ring"``) an SM takes
    :data:`TC_FUSED_CTAS_PER_SM` CTAs (one at a query tile of 8, two at
    32), no more than the ring's shared memory lets it hold
    (:func:`ring_ctas_per_sm`: one for the f32 ring at 32), and the CTAs
    never outnumber the slots: a second wave of CTAs that each scan a whole
    range would double the time.  On the FMA loop an SM holds as many as
    the shared memory of its score tile lets it, at least two."""
    if loop not in SCORING_LOOPS:
        raise ValueError(f"fused_ranges: unknown scoring loop {loop!r}")
    bq = kernel_block_q(nq)
    tiles = -(-nq // bq)
    if loop != "fma":
        per_sm = ring_ctas_per_sm(loop, bq, TC_FUSED_CTAS_PER_SM[bq])
        want = max(1, min(nb, per_sm * sm_count // tiles))
    else:
        cta_bytes = 4 * (bq * block_n + 32 * (bq + 1) + 32 * 257 + 2 * bq * k) + 1024  # + the SM's reserve
        per_sm = max(FUSED_MIN_CTAS_PER_SM, SM_SHARED_BYTES // cta_bytes)
        want = max(1, min(nb, -(-per_sm * sm_count // tiles)))
    per = -(-nb // want)
    return -(-nb // per), per


def fused_topk_plain(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    *,
    count: int,
    metric: str = "ip",
    mask: Optional[torch.Tensor] = None,
    cnorms: Optional[torch.Tensor] = None,
    block_n: int = DEFAULT_BLOCK_N,
    blocks_per_range: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 4, with the same outputs: the
    ``[Q, k]`` top-k and the ``[Q, S, k]`` range partials (S ranges of
    ``blocks_per_range`` blocks).  Kernel 1's plain block partials are
    merged range by range (:func:`range_partials`), which is what the
    running merge keeps, then over ranges; ties to the smallest row, empty
    slots ``-inf`` and ``INT_MAX``."""
    part_v, part_i = exact_block_topk_plain(
        corpus, queries, k, count=count, metric=metric, mask=mask, cnorms=cnorms, block_n=block_n,
    )
    range_v, range_i = range_partials(part_v, part_i, blocks_per_range, k)
    return (*merge_partials(range_v, range_i, k), range_v, range_i)


def range_partials(part_v, part_i, blocks_per_range: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 4's ``[Q, S, k]`` range partials from kernel 1's ``[Q, NB,
    k]`` block partials: the stable top-k of each run of
    ``blocks_per_range`` blocks (ties to the smallest row, empty slots
    ``-inf`` and ``INT_MAX``).  It follows the kernel's float comparison
    (:func:`stable_topk`, as JAX's ``_topk_kernel``), so kernel 4 equals
    kernel 1 + :func:`merge_partials` bit for bit except where ``+0.0`` and
    ``-0.0`` tie at the k-th place, as in the JAX package."""
    q, nb, _ = part_v.shape
    ranges = -(-nb // blocks_per_range)
    pad = ranges * blocks_per_range - nb
    part_v = torch.nn.functional.pad(part_v, (0, 0, 0, pad), value=float("-inf"))
    part_i = torch.nn.functional.pad(part_i, (0, 0, 0, pad), value=_INT_MAX)
    range_v, pos = stable_topk(part_v.reshape(q, ranges, -1), k)
    return range_v, torch.gather(part_i.reshape(q, ranges, -1), 2, pos)


def fused_topk(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    *,
    count: int,
    metric: str = "ip",
    mask: Optional[torch.Tensor] = None,
    cnorms: Optional[torch.Tensor] = None,
    block_n: int = DEFAULT_BLOCK_N,
    blocks_per_range: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 4: the fused running top-k of ``queries`` over ``corpus``.

    Inputs as :func:`block_topk`; ``blocks_per_range`` defaults to
    :func:`fused_ranges` for the card's SM count and the scoring loop.
    Returns kernel-space ``(values [Q, k], row ids [Q, k], range values
    [Q, S, k], range ids [Q, S, k])``, as :func:`fused_topk_plain`; on the
    TMA ring (bf16 and f32) they equal kernel 1's partials merged by
    :func:`range_partials` and :func:`merge_partials`, bit for bit, except
    where ``+0.0`` and ``-0.0`` tie at the k-th place (the merge on the
    card compares floats, as JAX's ``_topk_kernel``; ``merge_partials``
    follows ``lax.top_k``).  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (its scoring loop as :func:`scoring_loop`
    says) or raises."""
    n, q = corpus.shape[0], queries.shape[0]
    nb = -(-n // block_n)
    loop = scoring_loop(corpus)
    if blocks_per_range is None:
        sms = H100_SMS
        if corpus.device.type == "cuda":
            sms = torch.cuda.get_device_properties(corpus.device).multi_processor_count
        blocks_per_range = fused_ranges(q, nb, sms, block_n=block_n, k=k, loop=loop)[1]
    if corpus.device.type == "cpu":
        return fused_topk_plain(
            corpus, queries, k, count=count, metric=metric, mask=mask, cnorms=cnorms,
            block_n=block_n, blocks_per_range=blocks_per_range,
        )
    if corpus.device.type != "cuda":
        raise ValueError(f"fused_topk: unsupported device {corpus.device}")
    if corpus.dtype not in (torch.float32, torch.bfloat16) or corpus.ndim != 2:
        raise ValueError(f"fused_topk: corpus must be [N, D] float32 or bfloat16, got {corpus.dtype}")
    d, dev = corpus.shape[1], corpus.device
    _cuda.require("fused_topk corpus", corpus, dev, corpus.dtype, (n, d))
    _cuda.require("fused_topk queries", queries, dev, corpus.dtype, (q, d))
    if loop != "fma" or corpus.dtype == torch.bfloat16:
        _cuda.require_aligned("fused_topk corpus", corpus)
        _cuda.require_aligned("fused_topk queries", queries)
    if n == 0 or q == 0 or not 1 <= k <= MAX_KERNEL_K or not 1 <= blocks_per_range <= _INT_MAX // block_n:
        raise ValueError(f"fused_topk: n={n}, q={q}, k={k}, blocks_per_range={blocks_per_range} out of range")
    ranges = -(-nb // blocks_per_range)
    if mask is not None:
        _cuda.require("fused_topk mask", mask, dev, torch.int8, (n,))
    l2 = metric == "l2"
    qnorms = None
    if l2:
        _cuda.require("fused_topk cnorms", cnorms, dev, torch.float32, (n,))
        qf = queries.float()
        qnorms = (qf * qf).sum(dim=1)
    part_v = torch.empty((q, ranges, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((q, ranges, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    lib = _cuda.library()
    args = (_cuda.ptr(corpus), _cuda.ptr(queries), _cuda.ptr(qnorms), _cuda.ptr(cnorms if l2 else None),
            _cuda.ptr(mask), _cuda.ptr(part_v), _cuda.ptr(part_i), _cuda.ptr(out_v), _cuda.ptr(out_i),
            n, d, q, int(min(count, n)), k, block_n, int(l2), ranges, blocks_per_range)
    if corpus.dtype == torch.bfloat16:
        err = lib.pse_fused_topk_bf16(*args, _cuda.stream(dev))
    else:
        err = lib.pse_fused_topk_f32(*args, int(loop == "fma_ring"), _cuda.stream(dev))
    _cuda.check(err, "fused_topk")
    return out_v, out_i, part_v, part_i


# ---------------------------------------------------------------------------
# Search entry points
# ---------------------------------------------------------------------------


def plain_topk(score_rows, n: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over rows ``[0, n)`` of the scores ``score_rows(start, stop)``
    gives (invalid rows already ``-inf``), in row chunks that bound the
    float32 temporary: chunk-local top-k, then a merge, both in
    ``lax.top_k``'s order (:func:`total_order_topk`), so the result is the
    JAX oracle's one ``lax.top_k`` over every row (``exact_search_oracle``,
    ``grouped_mask_oracle``).  Kernel-space values and int32 row ids."""
    vals_parts, idx_parts = [], []
    for start in range(0, n, _PLAIN_ROWS):
        stop = min(n, start + _PLAIN_ROWS)
        vals, pos = total_order_topk(score_rows(start, stop), min(k, stop - start))
        vals_parts.append(vals)
        idx_parts.append(pos + start)
    vals, pos = total_order_topk(torch.cat(vals_parts, dim=1), k)
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
    row-chunked float32 scores, chunk-local top-k and merge in
    ``lax.top_k``'s order (:func:`plain_topk`).
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


def check_impl(impl: str, allowed=IMPLS) -> None:
    if impl not in allowed:
        raise ValueError(f"impl must be one of {allowed}, got {impl!r}")


def exact_search(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    *,
    count: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
    metric: str = "cosine",
    impl: str = "auto",
    block_n: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN over ``corpus`` for ``queries`` (``[Q, D]`` or ``[D]``).

    For k ≤ 64, ``impl`` picks the scan (module docstring): ``"auto"`` and
    ``"pallas"`` kernel 1 and the phase-B merge, ``"pallas_fast"`` kernel 3
    and the exact rescore of the k winners, ``"pallas_fused"`` kernel 4,
    ``"lax"`` :func:`exact_search_plain`; larger k always runs
    :func:`exact_search_plain`.  Rows where ``mask <= 0`` or at or past
    ``count`` are excluded.  Returns ``(distances [Q, k] float32, indices
    [Q, k] int32)`` in FAISS conventions."""
    check_impl(impl)
    queries = torch.atleast_2d(queries)
    n = corpus.shape[0]
    k = min(k, n) if n else 0
    if n == 0 or k == 0:
        return _empty(queries.shape[0], corpus.device)
    if impl == "lax" or k > MAX_KERNEL_K:
        return exact_search_plain(
            corpus, queries, k, count=count, mask=mask, metric=metric
        )
    metric = "l2" if metric == "l2" else "ip"
    bn = block_n or DEFAULT_BLOCK_N
    if impl == "pallas_fast":
        bn = min(bn, FAST_MAX_BN)
    cnorms = row_sq_norms(corpus) if metric == "l2" else None
    if mask is not None:
        mask = (mask > 0).to(torch.int8)
    corpus = corpus.contiguous()
    queries = queries.to(corpus.dtype).contiguous()
    scan = dict(count=n if count is None else int(count), metric=metric, mask=mask,
                cnorms=cnorms, block_n=bn)
    if impl == "pallas_fused":
        vals, idx, _, _ = fused_topk(corpus, queries, k, **scan)
        return _finalize(vals, idx, metric)
    if impl == "pallas_fast":
        part_v, part_i = fast_block_topk(corpus, queries, min(k, bn), **scan)
        vals, idx = rescore_pool(part_v, part_i, corpus, queries.float(), k, cand=k, metric=metric)
        return _finalize(vals, idx, metric)
    part_v, part_i = block_topk(corpus, queries, min(k, bn), **scan)
    return _finalize(*merge_partials(part_v, part_i, k), metric)

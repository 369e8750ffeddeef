"""IVF stage 2, the probed-cluster scan: kernel 7 and its host contract.

Counterpart of the stage-2 kernel of ``photo_search_engine_tpu/models/
ivf.py`` (``_ivf_kernel``, launched by ``_ivf_pallas``).  The layout is
cluster-major: cluster ``c`` owns slots ``[c·L, (c+1)·L)`` of the
``[nlist·L, D]`` corpus, and ``row_valid`` (int8 ``[nlist·L]``) marks the
live slots (padding slots, and slots a filter drops, are 0).

Each query probes ``nprobe`` clusters (``probe_ids`` ``[Q, nprobe]``
int32, stage 1 in ``models/ivf.py``).  The scan scores each query against
the live slots of its own probed clusters only, and for every (query,
probe, tile of ``block_n`` slots of the cluster) keeps the tile's top
``kk = min(k, block_n)``:

* outputs ``[Q, nprobe, T, kk]`` float32 scores and int32 global slot ids,
  ``T = ceil(L / block_n)``; slots with no valid row hold ``-inf`` and
  ``INT_MAX``; ties go to the smallest slot;
* scores (higher is better): ip ``⟨q, c⟩``; l2 ``2⟨q, c⟩ − ‖c‖²`` (the
  caller subtracts ``‖q‖²``, as the TPU kernel's caller does); int8
  ``(acc · qs) · cs`` with ``acc`` the exact int32 dot;
* a probe id outside ``[0, nlist)`` matches no slot: its partials stay
  ``-inf`` / ``INT_MAX``.  (The JAX probe matrix drops an id ``>= nlist``
  too, but wraps a negative one to ``nlist + id``.)

A tile never contributes more than its own rows, so the merge of
the partials (``ops/topk.merge_partials``) is exact for any k and any
``block_n``.  With the probe ids of each query sorted ascending
(``IVFIndex._probe`` sorts them), the partials lie in ascending slot order
and the merge gives ties to the smallest slot.

* :func:`ivf_block_topk` — kernel 7, ``csrc/ivf_topk.cu``: the work list of
  probe-pair groups built on the card (:func:`ivf_work_list`), the
  groups' queries gathered, then the scan on the TMA ring (the tensor
  cores, or fmaf consumers for float32) or the FMA loop
  (:func:`ivf_scoring_loop`), at the tile and group size of
  :func:`ivf_geometry`.  It reads nothing back to the host.
* :func:`ivf_block_topk_plain` — its plain PyTorch version, with the same
  inputs and outputs, chunked so that it runs at 1M rows.
* :func:`quantize_ivf_queries` — the int8 query quantization of the JAX
  IVF search, bit for bit.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from photo_search_engine_tpu_torch.ops import _cuda
from photo_search_engine_tpu_torch.ops.topk import H100_SMS, MAX_KERNEL_K, SCORING_LOOPS, ring_ctas_per_sm, stable_topk

IVF_FMA_BLOCK_N = 256  # cluster slots per tile of the FMA loop: its [BQ, bn] f32 score tile lives in shared memory
IVF_BQ = (8, 32)  # pairs a group: the query tiles of the tensor-core scan (m64n8 / m64n32)
# The rule of ivf_geometry, from scripts/torch_kernel_sweep.py --ivf-only
# (H100, PERF.md): groups of 8 while the expected queries per probed
# cluster stay at or under IVF_SMALL_BQ_MEAN (8 a cluster ran 3-5 % faster
# in groups of 8, 16 a cluster 5-10 % faster in groups of 32), else 32; a
# cluster cut into at most IVF_MAX_TILES tiles, as few as give
# IVF_WAVES waves of IVF_CTAS_PER_SM CTAs an SM (fewer waves left a tail:
# whole clusters at batch 32 ran 6 % slower than two tiles).
IVF_SMALL_BQ_MEAN = 12.0
IVF_MAX_TILES = 3
IVF_CTAS_PER_SM = 2  # __launch_bounds__(288, 2) of the ring's scan; the f32 ring at 32 holds one (ring_ctas_per_sm)
IVF_WAVES = 4
_INT_MAX = torch.iinfo(torch.int32).max
_PLAIN_ELEMS = 1 << 28  # gathered elements per step of the plain version (1 GB as float32)


def quantize_ivf_queries(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q_i8 [Q, D] int8, qs [Q] float32)`` as the JAX IVF search makes
    them (``ivf.py:1110-1114``).  That code runs eagerly, so XLA divides
    by 127 there, where the jitted ``quantize_rows`` multiplies by
    float32(1/127): the two scales differ in the last bit for about 4 % of
    rows, and this function divides."""
    qf = queries.float()
    qs = qf.abs().amax(dim=1, keepdim=True) / 127.0
    q_i8 = torch.clamp(torch.round(qf / torch.clamp(qs, min=1e-30)), -127, 127).to(torch.int8)
    return q_i8, qs[:, 0]


# ---------------------------------------------------------------------------
# Geometry: the scoring loop, the tile and the group size
# ---------------------------------------------------------------------------


def ivf_scoring_loop(corpus: torch.Tensor, k: int) -> str:
    """Which loop kernel 7 runs by default, when ``k <= 64`` (the running
    list of the ring's scan) and TMA takes the rows' byte stride:
    ``"tensor_core"`` (wgmma fed by the TMA ring of
    ``csrc/block_score_tc.cuh``) for bfloat16 rows with D % 8 == 0 and int8
    rows with D % 16 == 0; ``"fma_ring"`` (the same ring, IEEE fmaf
    consumers: float32 keeps full precision by contract) for float32 rows
    with D % 4 == 0; ``"fma"`` (fmaf, or __dp4a on int8x4 words) otherwise,
    where candidate_k 500 goes."""
    d = corpus.shape[1]
    if k <= MAX_KERNEL_K:
        if (corpus.dtype == torch.bfloat16 and d % 8 == 0) or (corpus.dtype == torch.int8 and d % 16 == 0):
            return "tensor_core"
        if corpus.dtype == torch.float32 and d % 4 == 0:
            return "fma_ring"
    return "fma"


def expected_probed(nq: int, nprobe: int, nlist: int) -> float:
    """Distinct clusters ``nq`` queries of ``nprobe`` probes each reach on
    average when every cluster is equally likely."""
    nprobe = min(nprobe, nlist)
    return nlist * (1.0 - (1.0 - nprobe / nlist) ** nq)


def ivf_geometry(nq: int, nprobe: int, nlist: int, lrows: int, loop: str,
                 sm_count: int = H100_SMS) -> Tuple[int, int]:
    """``(block_n, bq)`` of kernel 7, from the shapes alone (no probe id
    is read).  ``bq``: 8 pairs a group while the expected queries per
    probed cluster (:func:`expected_probed`) stay at or under
    :data:`IVF_SMALL_BQ_MEAN`, else 32, so that a group is not mostly
    padding and a crowded cluster is not read once per 8 queries.
    ``block_n``: on the TMA ring (``"tensor_core"``, ``"fma_ring"``) a
    cluster is cut into the fewest tiles (at most :data:`IVF_MAX_TILES`)
    whose CTAs, over the expected groups, make :data:`IVF_WAVES` waves of
    the CTAs an SM holds (:data:`IVF_CTAS_PER_SM`, or fewer where the
    ring's shared memory says so: ``topk.ring_ctas_per_sm``); a tile of the
    whole cluster carries a running top-k across its passes.  The FMA loop
    keeps :data:`IVF_FMA_BLOCK_N`."""
    if loop not in SCORING_LOOPS:
        raise ValueError(f"ivf_geometry: unknown scoring loop {loop!r}")
    pairs = nq * min(nprobe, nlist)
    probed = expected_probed(nq, nprobe, nlist)
    bq = IVF_BQ[0] if pairs / probed <= IVF_SMALL_BQ_MEAN else IVF_BQ[1]
    if loop == "fma":
        return IVF_FMA_BLOCK_N, bq
    groups = max(probed, pairs / bq)
    slots = IVF_WAVES * ring_ctas_per_sm(loop, bq, IVF_CTAS_PER_SM) * sm_count
    tiles = max(1, min(IVF_MAX_TILES, -(-slots // max(1, round(groups)))))
    return -(-lrows // tiles), bq


def ivf_group_bound(nq: int, nprobe: int, nlist: int, bq: int) -> int:
    """The most groups the work list can hold: ``P = nq·nprobe`` pairs over
    at most ``min(nlist, P)`` distinct clusters, each cluster's pairs cut
    into groups of ``bq``, so ``Σ⌈n_c / bq⌉ ≤ ⌊(P + min(nlist, P)·(bq −
    1)) / bq⌋``.  The grid is sized by it; CTAs past the true count leave
    at once."""
    pairs = nq * nprobe
    return max(1, (pairs + min(nlist, pairs) * (bq - 1)) // bq)


@functools.lru_cache(maxsize=None)
def _cuda_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(device) -> int:
    return _cuda_sms(torch.device(device).index or 0) if torch.device(device).type == "cuda" else H100_SMS


def ivf_launch(corpus: torch.Tensor, probe_ids: torch.Tensor, lrows: int, k: int,
               block_n: Optional[int] = None, bq: Optional[int] = None) -> Tuple[str, int, int]:
    """``(loop, block_n, bq)`` that :func:`ivf_block_topk` launches with:
    :func:`ivf_scoring_loop`'s loop, and the caller's tile and group size
    or :func:`ivf_geometry`'s for the corpus's card (an H100's SM count on
    the CPU).  A comparison of the kernel's partials with the plain
    version's passes this ``block_n`` to both."""
    loop = ivf_scoring_loop(corpus, k)
    if block_n is None or bq is None:
        nq, nprobe = probe_ids.shape
        geo_bn, geo_bq = ivf_geometry(nq, nprobe, corpus.shape[0] // max(lrows, 1), lrows, loop,
                                      _sm_count(corpus.device))
        block_n, bq = block_n or geo_bn, bq or geo_bq
    return loop, block_n, bq


def _shape(probe_ids, lrows, block_n, k):
    nq, nprobe = probe_ids.shape
    return nq, nprobe, -(-lrows // block_n), min(k, block_n)


# ---------------------------------------------------------------------------
# The work list: probe pairs in groups of one cluster
# ---------------------------------------------------------------------------


def ivf_work_list_plain(probe_ids: torch.Tensor, nlist: int, bq: int):
    """Plain PyTorch version of the work list kernel 7 walks.

    The flattened ``[Q·nprobe]`` probe ids are sorted stably (pair ``p =
    query·nprobe + probe slot``; ``order[s]`` is the pair at sorted
    position ``s``), and each cluster's run of pairs is cut into groups of
    at most ``bq``.  Returns ``(groups [G_max, 3] int32, order [P] int64,
    sorted ids [P] int32)``: group ``g`` is cluster ``groups[g, 0]``, sorted
    positions ``groups[g, 1]`` onwards, ``groups[g, 2]`` of them; groups of
    one cluster are neighbours, in sorted order; rows past the group count
    are ``(-1, 0, 0)``; an id outside ``[0, nlist)`` is in no group.
    ``G_max`` is :func:`ivf_group_bound`."""
    nq, nprobe = probe_ids.shape
    sorted_ids, order = torch.sort(probe_ids.reshape(-1), stable=True)
    pos = torch.arange(sorted_ids.numel(), device=sorted_ids.device)
    run = torch.searchsorted(sorted_ids, sorted_ids)  # first position of each position's id
    live = (sorted_ids >= 0) & (sorted_ids < nlist)
    starts = pos[live & ((pos - run) % bq == 0)]
    ends = torch.searchsorted(sorted_ids, sorted_ids[starts], right=True)
    groups = torch.tensor([-1, 0, 0], dtype=torch.int32, device=sorted_ids.device).repeat(
        ivf_group_bound(nq, nprobe, nlist, bq), 1)
    n = starts.numel()
    groups[:n, 0] = sorted_ids[starts]
    groups[:n, 1] = starts.to(torch.int32)
    groups[:n, 2] = torch.clamp(ends - starts, max=bq).to(torch.int32)
    return groups, order, sorted_ids


def ivf_work_list(probe_ids: torch.Tensor, nlist: int, bq: int):
    """The work list of :func:`ivf_work_list_plain`, built on the card for
    a CUDA tensor (``torch.sort``, then ``ivf_work_kernel`` in
    ``csrc/ivf_topk.cu``: one CTA cuts the sorted pairs into groups; no
    value is read back to the host), by the plain version for a CPU one.
    :func:`ivf_block_topk` scans the list it returns."""
    if probe_ids.device.type == "cpu":
        return ivf_work_list_plain(probe_ids, nlist, bq)
    nq, nprobe = probe_ids.shape
    _cuda.require("ivf_work_list probe_ids", probe_ids, probe_ids.device, torch.int32, (nq, nprobe))
    sorted_ids, order = torch.sort(probe_ids.reshape(-1), stable=True)
    g_max = ivf_group_bound(nq, nprobe, nlist, bq)
    groups = torch.empty((g_max, 3), dtype=torch.int32, device=probe_ids.device)
    err = _cuda.library().pse_ivf_work(_cuda.ptr(sorted_ids), _cuda.ptr(groups), nq * nprobe, nlist, bq, g_max,
                                       _cuda.stream(probe_ids.device))
    _cuda.check(err, "ivf_work_list")
    return groups, order, sorted_ids


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def ivf_block_topk_plain(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    probe_ids: torch.Tensor,
    row_valid: torch.Tensor,
    k: int,
    *,
    lrows: int,
    metric: str = "ip",
    cnorms: Optional[torch.Tensor] = None,
    qscales: Optional[torch.Tensor] = None,
    cscales: Optional[torch.Tensor] = None,
    block_n: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 7, with the same inputs and outputs
    (``block_n=None``: tiles of the whole cluster, one list a pair).

    One probe slot at a time, each query's probed cluster is gathered
    (``[Q, L, D]``, in query chunks that bound the temporary) and scored:
    float32 products for a float layout; for an int8 layout the int32 dot
    in float64, where it is exact, rounded to float32 and scaled as the
    kernel scales it, so those scores agree bit for bit."""
    block_n = block_n or lrows
    nq, nprobe, tiles, kk = _shape(probe_ids, lrows, block_n, k)
    d = corpus.shape[1]
    dev = corpus.device
    int8 = corpus.dtype == torch.int8
    out_v = torch.full((nq, nprobe, tiles, kk), float("-inf"), device=dev)
    out_i = torch.full((nq, nprobe, tiles, kk), _INT_MAX, dtype=torch.int32, device=dev)
    clusters = corpus.view(-1, lrows, d)
    nlist = clusters.shape[0]
    valid = row_valid.view(-1, lrows) > 0
    qf = queries.double() if int8 else queries.float()
    step = max(1, _PLAIN_ELEMS // (lrows * d))
    first = block_n * torch.arange(tiles, device=dev)
    for j in range(nprobe):
        for q0 in range(0, nq, step):
            q1 = min(nq, q0 + step)
            probe = probe_ids[q0:q1, j].long()
            probed = (probe >= 0) & (probe < nlist)  # an id outside the layout matches no slot
            ids = torch.clamp(probe, 0, nlist - 1)
            if int8:
                acc = torch.einsum("qd,qld->ql", qf[q0:q1], clusters[ids].double()).float()
                scores = acc * qscales[q0:q1, None] * cscales.view(-1, lrows)[ids]
            else:
                scores = torch.einsum("qd,qld->ql", qf[q0:q1], clusters[ids].float())
            if metric == "l2":
                scores = 2.0 * scores - cnorms.view(-1, lrows)[ids]
            scores = torch.where(valid[ids] & probed[:, None], scores, float("-inf"))
            scores = torch.nn.functional.pad(scores, (0, tiles * block_n - lrows), value=float("-inf"))
            vals, pos = stable_topk(scores.view(q1 - q0, tiles, block_n), kk)
            slots = (ids[:, None, None] * lrows + first[None, :, None] + pos).to(torch.int32)
            out_v[q0:q1, j] = vals
            out_i[q0:q1, j] = torch.where(torch.isneginf(vals), _INT_MAX, slots)
    return out_v, out_i


# ---------------------------------------------------------------------------
# Kernel 7 (csrc/ivf_topk.cu)
# ---------------------------------------------------------------------------


def ivf_block_topk(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    probe_ids: torch.Tensor,
    row_valid: torch.Tensor,
    k: int,
    *,
    lrows: int,
    metric: str = "ip",
    cnorms: Optional[torch.Tensor] = None,
    qscales: Optional[torch.Tensor] = None,
    cscales: Optional[torch.Tensor] = None,
    block_n: Optional[int] = None,
    bq: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 7: per-(query, probe, tile) top-k over the probed clusters.

    ``corpus`` ``[nlist·L, D]`` float32, bfloat16 or int8 and ``queries``
    ``[Q, D]`` of the same dtype; ``probe_ids`` int32 ``[Q, nprobe]``
    (distinct cluster ids per query); ``row_valid`` int8 ``[nlist·L]``;
    ``cnorms`` float32 ``[nlist·L]`` for ``metric="l2"``; ``qscales``
    ``[Q]`` and ``cscales`` ``[nlist·L]`` float32 for an int8 corpus
    (``D % 4 == 0``).  ``block_n`` and ``bq`` (8 or 32 pairs a group)
    default to :func:`ivf_launch`'s; neither changes the merged result.
    Outputs as in :func:`ivf_block_topk_plain`.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (on the loop
    :func:`ivf_scoring_loop` says) or raises, and nothing is read back to
    the host."""
    if corpus.device.type == "cpu":
        return ivf_block_topk_plain(
            corpus, queries, probe_ids, row_valid, k, lrows=lrows, metric=metric,
            cnorms=cnorms, qscales=qscales, cscales=cscales,
            block_n=ivf_launch(corpus, probe_ids, lrows, k, block_n, bq)[1],
        )
    if corpus.device.type != "cuda":
        raise ValueError(f"ivf_block_topk: unsupported device {corpus.device}")
    if corpus.dtype not in (torch.float32, torch.bfloat16, torch.int8) or corpus.ndim != 2:
        raise ValueError(f"ivf_block_topk: corpus must be [S, D] float32, bfloat16 or int8, got {corpus.dtype}")
    (slots, d), dev = corpus.shape, corpus.device
    if lrows <= 0 or slots % lrows or probe_ids.ndim != 2:
        raise ValueError(f"ivf_block_topk: slots={slots}, L={lrows} out of range")
    loop, block_n, bq = ivf_launch(corpus, probe_ids, lrows, k, block_n, bq)
    nq, nprobe, tiles, kk = _shape(probe_ids, lrows, block_n, k)
    if nq == 0 or nprobe == 0 or k < 1 or tiles > 65535 or bq not in IVF_BQ:
        raise ValueError(f"ivf_block_topk: q={nq}, nprobe={nprobe}, k={k}, block_n={block_n}, bq={bq} out of range")
    _cuda.require("ivf_block_topk corpus", corpus, dev, corpus.dtype, (slots, d))
    _cuda.require("ivf_block_topk queries", queries, dev, corpus.dtype, (nq, d))
    _cuda.require("ivf_block_topk probe_ids", probe_ids, dev, torch.int32, (nq, nprobe))
    _cuda.require("ivf_block_topk row_valid", row_valid, dev, torch.int8, (slots,))
    l2 = metric == "l2"
    if l2:
        _cuda.require("ivf_block_topk cnorms", cnorms, dev, torch.float32, (slots,))
    int8 = corpus.dtype == torch.int8
    if int8:
        _cuda.require("ivf_block_topk qscales", qscales, dev, torch.float32, (nq,))
        _cuda.require("ivf_block_topk cscales", cscales, dev, torch.float32, (slots,))
        if d % 4 or corpus.data_ptr() % 4 or queries.data_ptr() % 4:
            raise ValueError(f"ivf_block_topk: int8 rows are read as int8x4 words; D={d} and the data must align to 4")
    if loop != "fma":
        _cuda.require_aligned("ivf_block_topk corpus", corpus)
    nlist = slots // lrows
    groups, order, sorted_ids = ivf_work_list(probe_ids, nlist, bq)
    g_max = groups.shape[0]
    qbuf = torch.empty((g_max * bq, d), dtype=corpus.dtype, device=dev)
    qsbuf = torch.empty(g_max * bq, dtype=torch.float32, device=dev) if int8 else None
    out_v = torch.empty((nq, nprobe, tiles, kk), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, nprobe, tiles, kk), dtype=torch.int32, device=dev)
    lib = _cuda.library()
    fn = {torch.float32: lib.pse_ivf_topk_f32, torch.bfloat16: lib.pse_ivf_topk_bf16,
          torch.int8: lib.pse_ivf_topk_int8}[corpus.dtype]
    err = fn(
        _cuda.ptr(corpus), _cuda.ptr(queries), _cuda.ptr(qscales if int8 else None),
        _cuda.ptr(cscales if int8 else None), _cuda.ptr(cnorms if l2 else None), _cuda.ptr(row_valid),
        _cuda.ptr(sorted_ids), _cuda.ptr(order), _cuda.ptr(groups), _cuda.ptr(qbuf), _cuda.ptr(qsbuf),
        _cuda.ptr(out_v), _cuda.ptr(out_i),
        nlist, lrows, d, nq, nprobe, kk, block_n, bq, g_max, int(l2), int(loop != "fma"),
        _cuda.stream(dev),
    )
    _cuda.check(err, "ivf_block_topk")
    return out_v, out_i

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
  ``(acc · qs) · cs`` with ``acc`` the exact int32 dot.

A tile never contributes more than its own rows, so the stable merge of
the partials (``ops/topk.merge_partials``) is exact for any k.  With the
probe ids of each query sorted ascending (``IVFIndex._probe`` sorts them),
the partials lie in ascending slot order and the merge gives ties to the
smallest slot.

* :func:`ivf_block_topk` — kernel 7, ``csrc/ivf_topk.cu``; the wrapper
  builds the probe-pair groups the kernel walks (:func:`probe_groups`).
* :func:`ivf_block_topk_plain` — its plain PyTorch version, with the same
  inputs and outputs, chunked so that it runs at 1M rows.
* :func:`quantize_ivf_queries` — the int8 query quantization of the JAX
  IVF search, bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from photo_search_engine_tpu_torch.ops import _cuda
from photo_search_engine_tpu_torch.ops.topk import stable_topk

IVF_BLOCK_N = 256  # cluster slots per kernel-7 tile
_INT_MAX = torch.iinfo(torch.int32).max
_PLAIN_ELEMS = 1 << 28  # gathered elements per step of the plain version (1 GB as float32)
_BQ = (8, 16, 32)  # query-group sizes the kernel is built for


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


def _shape(probe_ids, lrows, block_n, k):
    nq, nprobe = probe_ids.shape
    return nq, nprobe, -(-lrows // block_n), min(k, block_n)


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
    block_n: int = IVF_BLOCK_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 7, with the same inputs and outputs.

    One probe slot at a time, each query's probed cluster is gathered
    (``[Q, L, D]``, in query chunks that bound the temporary) and scored:
    float32 products for a float layout; for an int8 layout the int32 dot
    in float64, where it is exact, rounded to float32 and scaled as the
    kernel scales it, so those scores agree bit for bit."""
    nq, nprobe, tiles, kk = _shape(probe_ids, lrows, block_n, k)
    d = corpus.shape[1]
    dev = corpus.device
    int8 = corpus.dtype == torch.int8
    out_v = torch.full((nq, nprobe, tiles, kk), float("-inf"), device=dev)
    out_i = torch.full((nq, nprobe, tiles, kk), _INT_MAX, dtype=torch.int32, device=dev)
    clusters = corpus.view(-1, lrows, d)
    valid = row_valid.view(-1, lrows) > 0
    qf = queries.double() if int8 else queries.float()
    step = max(1, _PLAIN_ELEMS // (lrows * d))
    first = block_n * torch.arange(tiles, device=dev)
    for j in range(nprobe):
        for q0 in range(0, nq, step):
            q1 = min(nq, q0 + step)
            ids = probe_ids[q0:q1, j].long()
            if int8:
                acc = torch.einsum("qd,qld->ql", qf[q0:q1], clusters[ids].double()).float()
                scores = acc * qscales[q0:q1, None] * cscales.view(-1, lrows)[ids]
            else:
                scores = torch.einsum("qd,qld->ql", qf[q0:q1], clusters[ids].float())
            if metric == "l2":
                scores = 2.0 * scores - cnorms.view(-1, lrows)[ids]
            scores = torch.where(valid[ids], scores, float("-inf"))
            scores = torch.nn.functional.pad(scores, (0, tiles * block_n - lrows), value=float("-inf"))
            vals, pos = stable_topk(scores.view(q1 - q0, tiles, block_n), kk)
            slots = (ids[:, None, None] * lrows + first[None, :, None] + pos).to(torch.int32)
            out_v[q0:q1, j] = vals
            out_i[q0:q1, j] = torch.where(torch.isneginf(vals), _INT_MAX, slots)
    return out_v, out_i


# ---------------------------------------------------------------------------
# Kernel 7 (csrc/ivf_topk.cu)
# ---------------------------------------------------------------------------


def probe_groups(probe_ids: np.ndarray, nlist: int):
    """The work list kernel 7 walks, from host probe ids ``[Q, nprobe]``.

    The (cluster, query, probe slot) pairs are sorted stably by cluster
    and cut into groups of at most ``bq`` queries that probe the same
    cluster.  Returns ``(groups [G, 3], pair_query [P], pair_slot [P],
    bq)``: group ``g`` is cluster ``groups[g, 0]``, pairs ``groups[g, 1]``
    onwards, ``groups[g, 2]`` of them; pair ``p`` is query
    ``pair_query[p]``'s probe slot ``pair_slot[p]``.  Each pair lies in
    exactly one group; groups of one cluster are neighbours.  ``bq`` is the
    smallest of 8, 16, 32 that holds the mean number of queries per probed
    cluster (else 32), so a group is not mostly padding."""
    nq, nprobe = probe_ids.shape
    key = np.asarray(probe_ids, np.int64).reshape(-1)
    if key.size and not 0 <= int(key.min()) <= int(key.max()) < nlist:
        raise ValueError(f"probe ids must lie in [0, {nlist})")
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=nlist)
    mean = key.size / max(int((counts > 0).sum()), 1)
    bq = next((b for b in _BQ if b >= mean), _BQ[-1])
    per_cluster = -(-counts // bq)
    cluster = np.repeat(np.arange(nlist), per_cluster)
    local = np.arange(cluster.size) - (np.cumsum(per_cluster) - per_cluster)[cluster]
    first = (np.cumsum(counts) - counts)[cluster] + local * bq
    size = np.minimum(bq, counts[cluster] - local * bq)
    groups = np.stack([cluster, first, size], axis=1).astype(np.int32)
    return groups, (order // nprobe).astype(np.int32), (order % nprobe).astype(np.int32), bq


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
    block_n: int = IVF_BLOCK_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 7: per-(query, probe, tile) top-k over the probed clusters.

    ``corpus`` ``[nlist·L, D]`` float32, bfloat16 or int8 and ``queries``
    ``[Q, D]`` of the same dtype; ``probe_ids`` int32 ``[Q, nprobe]``
    (distinct cluster ids per query); ``row_valid`` int8 ``[nlist·L]``;
    ``cnorms`` float32 ``[nlist·L]`` for ``metric="l2"``; ``qscales``
    ``[Q]`` and ``cscales`` ``[nlist·L]`` float32 for an int8 corpus
    (``D % 4 == 0``).  Outputs as in :func:`ivf_block_topk_plain`.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if corpus.device.type == "cpu":
        return ivf_block_topk_plain(
            corpus, queries, probe_ids, row_valid, k, lrows=lrows, metric=metric,
            cnorms=cnorms, qscales=qscales, cscales=cscales, block_n=block_n,
        )
    if corpus.device.type != "cuda":
        raise ValueError(f"ivf_block_topk: unsupported device {corpus.device}")
    if corpus.dtype not in (torch.float32, torch.bfloat16, torch.int8) or corpus.ndim != 2:
        raise ValueError(f"ivf_block_topk: corpus must be [S, D] float32, bfloat16 or int8, got {corpus.dtype}")
    (slots, d), dev = corpus.shape, corpus.device
    nq, nprobe, tiles, kk = _shape(probe_ids, lrows, block_n, k)
    if lrows <= 0 or slots % lrows or nq == 0 or nprobe == 0 or k < 1 or tiles > 65535:
        raise ValueError(f"ivf_block_topk: slots={slots}, L={lrows}, q={nq}, nprobe={nprobe}, k={k} out of range")
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
    groups, pair_query, pair_slot, bq = probe_groups(probe_ids.cpu().numpy(), slots // lrows)
    table = torch.from_numpy(np.concatenate([groups.reshape(-1), pair_query, pair_slot])).to(dev)
    n_groups, pairs = groups.shape[0], pair_query.shape[0]
    out_v = torch.empty((nq, nprobe, tiles, kk), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, nprobe, tiles, kk), dtype=torch.int32, device=dev)
    lib = _cuda.library()
    fn = {torch.float32: lib.pse_ivf_topk_f32, torch.bfloat16: lib.pse_ivf_topk_bf16,
          torch.int8: lib.pse_ivf_topk_int8}[corpus.dtype]
    err = fn(
        _cuda.ptr(corpus), _cuda.ptr(queries), _cuda.ptr(qscales if int8 else None),
        _cuda.ptr(cscales if int8 else None), _cuda.ptr(cnorms if l2 else None), _cuda.ptr(row_valid),
        _cuda.ptr(table), _cuda.ptr(table[3 * n_groups :]), _cuda.ptr(table[3 * n_groups + pairs :]),
        _cuda.ptr(out_v), _cuda.ptr(out_i),
        n_groups, tiles, lrows, d, nprobe, kk, block_n, bq, int(l2),
        _cuda.stream(dev),
    )
    _cuda.check(err, "ivf_block_topk")
    ivf_block_topk.launches += 1
    return out_v, out_i


ivf_block_topk.launches = 0  # kernel launches (read by chip_smoke.py)

"""Request micro-batcher of the serving path.

Counterpart of ``photo_search_engine_tpu/core/batcher.py``.  Concurrent
single-query searches are coalesced into one device scan: unfiltered ones
into kernel 1 or 2, filtered ones, with different predicates, into one
grouped scan (kernel 5 or 6, ``VectorIndex.raw_grouped_search_batch``).

The batching logic does not depend on JAX and is the JAX package's:
``CallBatcher`` and ``BatchedEmbeddingService`` are used as they are, and
:class:`MicroBatcher` subclasses the JAX one only to build its predicate
table with this package's ``bucket_mask_table`` (the JAX method imports
the JAX ``grouped_mask`` module, and with it jax).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from photo_search_engine_tpu.core import batcher as _jax_batcher
from photo_search_engine_tpu.core.batcher import BatchedEmbeddingService, CallBatcher  # noqa: F401  (re-exported)
from photo_search_engine_tpu_torch.ops.grouped_mask import bucket_mask_table


class MicroBatcher(_jax_batcher.MicroBatcher):
    """The JAX package's micro-batcher, with the predicate table built by
    this package's :func:`bucket_mask_table`."""

    @staticmethod
    def _factor_masks(batch, keys: List[Optional[bytes]]) -> Tuple[np.ndarray, np.ndarray]:
        """Dedupe per-request masks into ``(mask_table [M, N], ids [B])``:
        row 0 all ones for unfiltered requests, one row per distinct raw
        mask, M padded to the same bucket as the JAX batcher's table."""
        n = max(item.mask.shape[0] for item in batch if item.mask is not None)
        rows: List[np.ndarray] = [np.ones(n, np.int8)]
        digests: Dict[bytes, int] = {}
        ids = np.zeros(len(batch), np.int32)
        for pos, (item, key) in enumerate(zip(batch, keys)):
            if key is None:
                continue
            row = digests.get(key)
            if row is None:
                mask = np.zeros(n, np.int8)
                mask[: item.mask.shape[0]] = np.asarray(item.mask, np.int8)
                row = len(rows)
                rows.append(mask)
                digests[key] = row
            ids[pos] = row
        return bucket_mask_table(np.stack(rows)), ids


def attach_microbatcher(
    vector_index: Any, *, max_batch: int = 128, window_s: float = 0.003, pipeline: int = 2,
) -> MicroBatcher:
    """Route a VectorIndex's single-query searches, filtered and
    unfiltered, through a shared :class:`MicroBatcher` (the JAX package's
    ``attach_microbatcher``, building this package's batcher)."""

    def _pad(dists: np.ndarray, idx: np.ndarray, k: int):
        if dists.shape[1] < k:  # the store clamped k to its live count
            pad = k - dists.shape[1]
            dists = np.pad(dists, ((0, 0), (0, pad)), constant_values=-np.inf)
            idx = np.pad(idx, ((0, 0), (0, pad)), constant_values=-1)
        return dists, idx

    def run_batch(queries: np.ndarray, k: int):
        return _pad(*vector_index.raw_search_batch(queries, k), k)

    def run_grouped_batch(queries: np.ndarray, k: int, table, ids):
        return _pad(*vector_index.raw_grouped_search_batch(queries, k, table, ids), k)

    batcher = MicroBatcher(
        run_batch,
        run_grouped_batch=run_grouped_batch,
        max_batch=max_batch,
        window_s=window_s,
        dimension=getattr(vector_index, "dimension", None),
        pipeline=pipeline,
    )

    def _hits(dists, idx):
        return [
            {"metadata": vector_index.metadata[int(i)], "distance": float(d)}
            for d, i in zip(dists.tolist(), idx.tolist())
            if i >= 0
        ]

    def batched_search(query_embedding, top_k):
        if vector_index.get_total_items() == 0:
            return []
        k = min(int(top_k), vector_index.get_total_items())
        return _hits(*batcher.search(np.asarray(query_embedding, np.float32), k))

    def batched_search_masked(query_embedding, top_k, mask):
        if vector_index.get_total_items() == 0:
            return []
        k = min(int(top_k), vector_index.get_total_items())
        return _hits(*batcher.search(np.asarray(query_embedding, np.float32), k, mask=np.asarray(mask)))

    vector_index.search = batched_search
    if vector_index.metric != "l2":
        # the grouped kernels are inner product only; l2 keeps the direct path
        vector_index.search_masked = batched_search_masked
    vector_index._microbatcher = batcher
    return batcher

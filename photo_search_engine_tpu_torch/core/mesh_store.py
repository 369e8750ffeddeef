"""Mesh-backed store with the single-device EmbeddingStore's interface.

Counterpart of ``photo_search_engine_tpu/core/mesh_store.py``: lets
``VectorIndex`` (and so the whole serving stack) run over a
:class:`~photo_search_engine_tpu_torch.parallel.sharded.Mesh` by
translating between insertion-order row indices, which key
``VectorIndex.metadata``, and ``ShardedEmbeddingStore``'s stable
``shard·2^40 + local`` ids:

* appends record the stable id of every insertion-order row;
* searches translate returned stable ids back through an inverse table
  (one insertion index per (shard, local row), rebuilt after appends):
  a direct lookup, where the JAX store binary-searches the sorted ids
  (2-4 ms a batch of 128 at 1M rows);
* insertion-order filters are permuted into the corpus layout the
  sharded scans take (LRU-cached by content, under a lock).

:class:`MeshIVFAdapter` serves ``index_type=ivf`` on a mesh store through
``parallel/sharded_ivf.py`` (per-shard layouts, kernel 7 on every shard,
the gathered merge) instead of pulling the corpus onto one device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from photo_search_engine_tpu_torch.core.content_lru import ContentLRU
from photo_search_engine_tpu_torch.ops import quantized as quant_ops
from photo_search_engine_tpu_torch.parallel.sharded import ShardedEmbeddingStore, make_mesh


class MeshEmbeddingStore:
    """EmbeddingStore-compatible facade over a row-sharded corpus."""

    def __init__(
        self,
        dimension: int,
        *,
        metric: str = "cosine",
        store_dtype: str = "float32",
        mesh_devices: int = 0,
        quantized=False,
        shard_block: int = 1024,
        mesh=None,
        device=None,
    ) -> None:
        if metric not in {"cosine", "l2", "ip"}:
            raise ValueError("metric must be cosine, l2 or ip")
        self.dimension = int(dimension)
        self.metric = metric
        self.quantized = quant_ops.resolve_store_quantized(quantized)
        self._sharded = ShardedEmbeddingStore(
            dimension,
            mesh or make_mesh(mesh_devices or None, device=device),
            metric=metric,
            store_dtype=store_dtype,
            shard_block=shard_block,
            quantized=self.quantized,
        )
        # insertion-order row -> stable id, and the inverse table of _translate
        self._ids = np.zeros((0,), np.int64)
        self._inverse: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._masks = ContentLRU(16)  # layout bits by content, count and capacity

    @property
    def count(self) -> int:
        return int(self._ids.shape[0])

    @property
    def n_shards(self) -> int:
        return self._sharded.n_shards

    @property
    def mesh(self):
        return self._sharded.mesh

    def _check(self, vectors) -> np.ndarray:
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        if vectors.shape[1] != self.dimension:
            raise ValueError(f"vector dimension mismatch: {vectors.shape[1]} != {self.dimension}")
        return vectors

    def append(self, vectors) -> None:
        vectors = self._check(vectors)
        if vectors.shape[0] == 0:
            return
        self._ids = np.concatenate([self._ids, self._sharded.append(vectors)])
        self._inverse = None

    # ------------------------------------------------------------------
    def _inverse_table(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(per-shard row counts, their offsets, insertion index at
        offset[shard] + local)``, rebuilt after an append."""
        if self._inverse is None:
            stride = ShardedEmbeddingStore._ID_STRIDE
            counts = self._sharded.counts.astype(np.int64)
            offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
            table = np.empty(self.count, np.int64)
            table[offsets[self._ids // stride] + self._ids % stride] = np.arange(self.count)
            self._inverse = (counts, offsets, table)
        return self._inverse

    def _translate(self, stable: np.ndarray) -> np.ndarray:
        """Stable ids → insertion-order indices (-1 passes through, as does
        an id no row has)."""
        counts, offsets, table = self._inverse_table()
        flat = np.asarray(stable, np.int64).ravel()
        shard = flat // ShardedEmbeddingStore._ID_STRIDE
        local = flat % ShardedEmbeddingStore._ID_STRIDE
        ok = (flat >= 0) & (shard < counts.shape[0])
        ok[ok] &= local[ok] < counts[shard[ok]]
        out = np.full(flat.shape, -1, np.int64)
        out[ok] = table[offsets[shard[ok]] + local[ok]]
        return out.reshape(np.shape(stable)).astype(np.int32)

    def _layout_mask(self, mask) -> np.ndarray:
        """Insertion-order bits → corpus-layout int8 bits, LRU-cached by the
        digest of the packed bits, count and capacity (appends change the
        id set and the layout width, so no stale entry can be returned).
        The digest reads one bit a row: the filtered micro-batches of a 1M
        corpus repeat the same few predicates every request."""
        keep = np.asarray(mask)[: self.count] > 0
        _, capacity = self._sharded._sync()
        return self._masks.get(ContentLRU.key(np.packbits(keep), self.count, capacity),
                               lambda: self._sharded.layout_mask(self._ids, keep))

    # ------------------------------------------------------------------
    def search(self, queries, k: int, *, mask=None, impl: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over live rows; ``mask`` is an insertion-order filter."""
        if self.count == 0:
            q = np.atleast_2d(np.asarray(queries)).shape[0]
            return np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int32)
        layout = self._layout_mask(mask) if mask is not None else None
        vals, stable = self._sharded.search(self._check(queries), min(k, self.count), impl=impl, mask=layout)
        return vals, self._translate(stable)

    def grouped_search(self, queries, k: int, mask_table, mask_ids, *, impl: str = "auto"):
        """Per-query filtered top-k (``mask_table`` ``[M, count]`` in
        insertion order).  An l2 store runs one masked scan per query, as
        the single-device store does: the grouped kernels score by inner
        product."""
        if self.count == 0:
            q = np.atleast_2d(np.asarray(queries)).shape[0]
            return np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int32)
        if self.metric == "l2":
            queries = self._check(queries)
            mask_ids = np.asarray(mask_ids)
            outs = [self.search(queries[i], k, mask=np.asarray(mask_table)[int(mask_ids[i])], impl=impl)
                    for i in range(queries.shape[0])]
            return np.concatenate([o[0] for o in outs]), np.concatenate([o[1] for o in outs])
        table = np.stack([self._layout_mask(row) for row in np.atleast_2d(np.asarray(mask_table))])
        vals, stable = self._sharded.grouped_search(
            self._check(queries), min(k, self.count), table, np.asarray(mask_ids, np.int32), impl=impl)
        return vals, self._translate(stable)

    # ------------------------------------------------------------------
    def reconstruct(self, index: int) -> np.ndarray:
        if not 0 <= index < self.count:
            raise IndexError(index)
        return self._sharded.reconstruct(int(self._ids[index]))

    def snapshot(self) -> np.ndarray:
        """Float32 host copy of the live rows in insertion order."""
        return self.snapshot_range(0, self.count)

    def snapshot_range(self, start: int, stop: int) -> np.ndarray:
        """Float32 host copy of rows ``[start, stop)`` in insertion order."""
        ids = self._ids[start : min(stop, self.count)]
        out = np.empty((ids.shape[0], self.dimension), np.float32)
        shard = ids // ShardedEmbeddingStore._ID_STRIDE
        local = ids % ShardedEmbeddingStore._ID_STRIDE
        for s in range(self._sharded.n_shards):
            sel = shard == s
            if sel.any():
                out[sel] = self._sharded._host_shards[s][local[sel]]
        return out

    def clear(self) -> None:
        old = self._sharded
        self._sharded = ShardedEmbeddingStore(
            self.dimension, old.mesh, metric=self.metric, store_dtype=old.store_dtype_name,
            shard_block=old.shard_block, quantized=self.quantized,
        )
        self._ids = np.zeros((0,), np.int64)
        self._inverse = None
        self._masks.clear()

    @classmethod
    def from_array(
        cls,
        array,
        *,
        metric: str = "cosine",
        store_dtype: str = "float32",
        mesh_devices: int = 0,
        quantized=False,
        already_normalized: bool = False,
        mesh=None,
        device=None,
    ) -> "MeshEmbeddingStore":
        array = np.asarray(array, np.float32)
        store = cls(array.shape[1], metric=metric, store_dtype=store_dtype, mesh_devices=mesh_devices,
                    quantized=quantized, mesh=mesh, device=device)
        del already_normalized  # normalization is idempotent
        store.append(array)
        return store


class MeshIVFAdapter:
    """IVFIndex-shaped facade over :class:`ShardedIVFIndex`, so that
    ``VectorIndex._ensure_ivf`` serves ``index_type=ivf`` on a mesh store
    on the mesh.  Filters keep the cluster pruning: insertion-order bits
    permute into each shard's slot layout (:meth:`_slot_bits`) and fold
    into kernel 7's row validity on every shard."""

    def __init__(self, store: MeshEmbeddingStore, nlist: int, seed: int = 0):
        from photo_search_engine_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

        self._store = store
        self._index = ShardedIVFIndex.build(store._sharded, nlist, seed=seed)
        self.nlist = self._index.nlist

    def state(self) -> dict:
        """Trained state of the sharded index (the ``.ivf.npz`` sidecar)."""
        return self._index.state()

    @classmethod
    def from_state(cls, store: MeshEmbeddingStore, state: dict) -> "MeshIVFAdapter":
        """Restore without retraining: the store must hold the same rows in
        the same insertion order (the placement is deterministic)."""
        from photo_search_engine_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

        adapter = cls.__new__(cls)
        adapter._store = store
        adapter._index = ShardedIVFIndex.from_state(store._sharded, state)
        adapter.nlist = adapter._index.nlist
        return adapter

    def _slot_bits(self, mask) -> Tuple[np.ndarray, float]:
        """Insertion-order bits → ``[n_shards · span]`` slot-layout bits and
        the share of live slots they keep (perm → stable id → insertion
        index)."""
        bits = np.asarray(mask)[: self._store.count].astype(np.int32, copy=False)
        perm = self._index.perms  # [n_shards, span] local row or -1
        live = perm >= 0
        shard_ids = np.broadcast_to(np.arange(perm.shape[0], dtype=np.int64)[:, None], perm.shape)
        stable = np.where(live, shard_ids * ShardedEmbeddingStore._ID_STRIDE + perm, -1)
        ins = self._store._translate(stable)
        slot_bits = np.zeros(perm.shape, np.int32)
        ok = ins >= 0
        slot_bits[ok] = bits[ins[ok]]
        return slot_bits.reshape(-1), float(slot_bits.sum()) / max(int(live.sum()), 1)

    def search(self, queries, k, nprobe: int = 64, mask=None):
        if mask is None:
            vals, stable = self._index.search(queries, k, nprobe)
        else:
            slot_bits, ratio = self._slot_bits(mask)
            vals, stable = self._index.search(queries, k, nprobe, slot_mask=slot_bits, mask_ratio=ratio)
        return vals, self._store._translate(stable)

    def supports_masked_search(self) -> bool:
        return True

    def append(self, delta, ids) -> bool:
        # insertion-order ids → the store's stable ids; each row goes to a
        # free slot of its nearest cluster in its own shard (no retraining)
        stable = self._store._ids[np.asarray(ids, np.int64)]
        return self._index.append(np.asarray(delta, np.float32), stable)

    def tune_nprobe(self, queries, k, target_recall: float = 0.98, *, start_nprobe: int = 8):
        """The doubling loop of ``models/ivf.tune_nprobe_by_doubling``, as
        the single-device index tunes."""
        from photo_search_engine_tpu_torch.models.ivf import tune_nprobe_by_doubling

        queries = np.atleast_2d(np.asarray(queries, np.float32))
        k = max(1, min(int(k), self._store.count))
        return tune_nprobe_by_doubling(lambda nprobe: self.search(queries, k, nprobe=nprobe)[1], self.nlist,
                                       target_recall, start_nprobe=start_nprobe)

"""Device-resident embedding matrix with incremental append.

Counterpart of ``photo_search_engine_tpu/core/embedding_store.py``:

* The corpus lives on ``device`` as a capacity-padded ``[capacity, D]``
  tensor (capacity a multiple of the scan kernels' row blocks); ``count``
  masks the live rows.
* Appends are in-place slice writes into that tensor.  They replace the
  JAX store's donated ``dynamic_update_slice``: PyTorch tensors are
  mutable, so no donation is needed to avoid a whole-corpus copy.
  Capacity grows geometrically, with the capacity check before the
  allocation.
* A float32 host mirror is kept for persistence — checkpoints are exact
  whatever the device dtype.
* An optional int8 shadow corpus (``quantized=True``) feeds the int8 scan
  (kernel 2) and is rescored against the primary corpus.
* ``grouped_search`` scans a batch whose queries carry different
  predicates in one pass (kernel 5, or kernel 6 on the int8 tier): the
  micro-batcher's filtered path.
"""

from __future__ import annotations

import hashlib
import math
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from photo_search_engine_tpu_torch.core import capacity as capacity_mod
from photo_search_engine_tpu_torch.ops import grouped_mask as grouped_ops
from photo_search_engine_tpu_torch.ops import quantized as quant_ops
from photo_search_engine_tpu_torch.ops import topk as topk_ops

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_QUANTIZE_CHUNK = 131072  # rows per quantize step (bounds the f32 temporary)


def _round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


class EmbeddingStore:
    """Append-only device embedding matrix + search entry point."""

    _MASK_LRU_SIZE = 32

    def __init__(
        self,
        dimension: int,
        *,
        device="cpu",
        metric: str = "cosine",
        store_dtype: str = "float32",
        block_rows: Optional[int] = None,
        quantized=False,
    ) -> None:
        if metric not in {"cosine", "l2", "ip"}:
            raise ValueError("metric must be cosine, l2 or ip")
        self.dimension = int(dimension)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.metric = metric
        name = topk_ops.resolve_store_dtype(store_dtype, self.device)
        if name not in _DTYPES:
            raise ValueError(f"store_dtype must be float32 or bfloat16, got {name!r}")
        self.store_dtype = _DTYPES[name]
        self.block_rows = int(block_rows or topk_ops.DEFAULT_BLOCK_N)
        self.quantized = quant_ops.resolve_store_quantized(quantized)
        self._i8_block = quant_ops.default_block_n_int8(self.dimension)
        if self.quantized:
            self.block_rows = max(128, 1 << (self.block_rows.bit_length() - 1))
        # capacity divides both kernel blocks, as in the JAX store, so the
        # int8 scan sees the same block layout (and pool) in both packages
        self._capacity_align = (
            math.lcm(self.block_rows, self._i8_block) if self.quantized else self.block_rows
        )
        self._count = 0
        self._device: Optional[torch.Tensor] = None     # [capacity, D] store dtype
        self._device_i8: Optional[torch.Tensor] = None  # [capacity, D] int8
        self._scales: Optional[torch.Tensor] = None     # [capacity] float32
        self._host_cache: Optional[np.ndarray] = np.zeros((0, self.dimension), np.float32)
        self._mask_lru: "OrderedDict[Tuple[bytes, int], torch.Tensor]" = OrderedDict()
        self._mask_lru_lock = threading.Lock()

    # ------------------------------------------------------------------
    @property
    def _host(self) -> np.ndarray:
        """Float32 host mirror, written eagerly by ``append``; after
        ``load_device_rows`` it is downloaded from the device on first use
        (store-dtype precision)."""
        if self._host_cache is None:
            self._host_cache = self._device[: self._count].float().cpu().numpy()
        return self._host_cache

    @property
    def count(self) -> int:
        return self._count

    @property
    def capacity(self) -> int:
        return 0 if self._device is None else int(self._device.shape[0])

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.store_dtype).element_size()

    def _prepare(self, vectors) -> np.ndarray:
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        if vectors.shape[1] != self.dimension:
            raise ValueError(
                f"vector dimension mismatch: {vectors.shape[1]} != {self.dimension}"
            )
        if self.metric == "cosine":
            norms = np.linalg.norm(vectors, axis=1, keepdims=True)
            # zero vectors stay as they are
            vectors = np.where(norms > 0, vectors / np.maximum(norms, 1e-30), vectors)
        return vectors

    def _check(self, new_capacity: int, old_capacity: int, what: str, extra: int = 0) -> None:
        capacity_mod.check_store_allocation(
            new_capacity, old_capacity, self.dimension, self.itemsize,
            self.quantized, device=self.device, extra_bytes=extra, what=what,
        )

    def _grow_to(self, needed: int) -> None:
        new_capacity = _round_up(max(needed, 2 * self.capacity), self._capacity_align)
        self._check(new_capacity, self.capacity, "embedding store growth")
        fresh = torch.zeros((new_capacity, self.dimension), dtype=self.store_dtype, device=self.device)
        if self._device is not None:
            fresh[: self.capacity] = self._device
        self._device = fresh
        if self.quantized:
            fresh_i8 = torch.zeros((new_capacity, self.dimension), dtype=torch.int8, device=self.device)
            fresh_sc = torch.zeros(new_capacity, dtype=torch.float32, device=self.device)
            if self._device_i8 is not None:
                fresh_i8[: self._device_i8.shape[0]] = self._device_i8
                fresh_sc[: self._scales.shape[0]] = self._scales
            self._device_i8 = fresh_i8
            self._scales = fresh_sc

    def _quantize_all(self, capacity: int) -> None:
        self._device_i8 = torch.empty((capacity, self.dimension), dtype=torch.int8, device=self.device)
        self._scales = torch.empty(capacity, dtype=torch.float32, device=self.device)
        for start in range(0, capacity, _QUANTIZE_CHUNK):
            q, s = quant_ops.quantize_rows(self._device[start : start + _QUANTIZE_CHUNK])
            self._device_i8[start : start + q.shape[0]] = q
            self._scales[start : start + s.shape[0]] = s

    def load_device_rows(self, rows: torch.Tensor) -> None:
        """Install a corpus that is already on ``device`` into an empty store.

        The ingest path of benches and smoke runs that synthesize their
        corpus on the card.  Rows must already be L2-normalized for
        ``metric="cosine"``.  When the rows already have the store dtype,
        the capacity alignment and a contiguous layout they are ADOPTED as
        the store tensor (zero copy); the caller must not write to them
        afterwards.  The float32 host mirror is downloaded lazily."""
        if self._count:
            raise RuntimeError("load_device_rows requires an empty store")
        if rows.ndim != 2 or rows.shape[1] != self.dimension:
            raise ValueError(f"expected [N, {self.dimension}] rows, got {tuple(rows.shape)}")
        if rows.device != self.device:
            raise ValueError(f"rows are on {rows.device}, the store on {self.device}")
        n = int(rows.shape[0])
        if n == 0:
            return
        capacity = _round_up(n, self._capacity_align)
        if capacity == n and rows.dtype == self.store_dtype and rows.is_contiguous():
            self._check(capacity, 0, "device-corpus install")
            self._device = rows
        else:
            # the source stays resident while the padded tensor is filled
            # (the slice copy casts in place: no third copy, unlike JAX's astype)
            self._check(capacity, 0, "device-corpus install", extra=rows.numel() * rows.element_size())
            padded = torch.zeros((capacity, self.dimension), dtype=self.store_dtype, device=self.device)
            padded[:n] = rows
            self._device = padded
        if self.quantized:
            self._quantize_all(capacity)
        self._count = n
        self._host_cache = None

    def append(self, vectors) -> None:
        """Append rows (normalized for cosine) to the host mirror and the device."""
        vectors = self._prepare(vectors)
        n_new = vectors.shape[0]
        if n_new == 0:
            return
        self._host_cache = np.concatenate([self._host, vectors], axis=0)
        start, stop = self._count, self._count + n_new
        if stop > self.capacity:
            self._grow_to(stop)
        chunk = torch.from_numpy(vectors).to(self.device)
        self._device[start:stop] = chunk.to(self.store_dtype)
        if self.quantized:
            q, s = quant_ops.quantize_rows(chunk)
            self._device_i8[start:stop] = q
            self._scales[start:stop] = s
        self._count = stop

    def _device_mask(self, mask) -> torch.Tensor:
        """Capacity-padded int8 device mask, LRU-cached by content digest
        (repeated filters skip the host-to-device upload)."""
        mask_arr = np.zeros(self.capacity, np.int8)
        mask_arr[: self._count] = np.asarray(mask[: self._count], bool)
        key = (hashlib.blake2b(mask_arr.tobytes(), digest_size=16).digest(), self.capacity)
        with self._mask_lru_lock:
            cached = self._mask_lru.get(key)
            if cached is not None:
                self._mask_lru.move_to_end(key)
                return cached
        mask_dev = torch.from_numpy(mask_arr).to(self.device)
        with self._mask_lru_lock:
            self._mask_lru[key] = mask_dev
            while len(self._mask_lru) > self._MASK_LRU_SIZE:
                self._mask_lru.popitem(last=False)
        return mask_dev

    # ------------------------------------------------------------------
    def search(
        self,
        queries,
        k: int,
        *,
        mask=None,
        impl: str = "auto",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over live rows; returns host ``(distances, indices)``.

        ``impl="int8"`` scans the int8 shadow (kernel 2) for k ≤ 64; every
        other call scans the primary corpus exactly (kernel 1 for k ≤ 64,
        the plain chunked product above).  ``mask`` is a length-``count``
        boolean filter."""
        if self._count == 0:
            q = np.atleast_2d(np.asarray(queries)).shape[0]
            return np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int32)
        if impl == "int8" and not self.quantized:
            raise ValueError("impl='int8' requires EmbeddingStore(quantized=True)")
        queries = torch.from_numpy(self._prepare(queries)).to(self.device)
        mask_dev = None if mask is None else self._device_mask(mask)
        metric = "ip" if self.metric == "cosine" else self.metric
        k = min(k, self._count)
        if impl == "int8" and k <= quant_ops.INT8_MAX_K:
            dists, idx = quant_ops.int8_search(
                self._device_i8, self._scales, self._device, queries, k,
                count=self._count, mask=mask_dev, metric=metric, block_n=self._i8_block,
            )
        else:
            dists, idx = topk_ops.exact_search(
                self._device, queries.to(self.store_dtype), k,
                count=self._count, mask=mask_dev, metric=metric,
                block_n=self.block_rows,
            )
        return dists.cpu().numpy(), idx.cpu().numpy()

    def grouped_search(
        self,
        queries,
        k: int,
        mask_table,
        mask_ids,
        *,
        impl: str = "auto",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched per-query filtered top-k: one scan for a batch whose
        queries carry different predicates (``mask_table`` ``[M, count]``
        rows, ``mask_ids`` ``[Q]``; see ``ops/grouped_mask.py``).

        The host table is widened to the capacity, so the kernels see the
        corpus's row stride.  ``impl="int8"`` with k ≤ 64 runs kernel 6;
        every other call kernel 5 (k ≤ 64) or the plain grouped search.
        Inner product and cosine only: an l2 store runs one masked
        :meth:`search` per query."""
        if self._count == 0:
            q = np.atleast_2d(np.asarray(queries)).shape[0]
            return np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int32)
        queries = self._prepare(queries)
        if self.metric == "l2":
            outs = [
                self.search(queries[i], k, mask=np.asarray(mask_table)[mask_ids[i]],
                            impl=impl if impl != "int8" else "auto")
                for i in range(queries.shape[0])
            ]
            return np.concatenate([o[0] for o in outs]), np.concatenate([o[1] for o in outs])
        if impl == "int8" and not self.quantized:
            raise ValueError("impl='int8' requires EmbeddingStore(quantized=True)")
        k = min(k, self._count)
        table = np.zeros((len(mask_table), self.capacity), np.int8)
        table[:, : self._count] = np.asarray(mask_table)[:, : self._count] > 0
        table_dev = torch.from_numpy(table).to(self.device)
        ids = torch.from_numpy(np.asarray(mask_ids, np.int32)).to(self.device)
        queries = torch.from_numpy(queries).to(self.device)
        if impl == "int8" and k <= quant_ops.INT8_MAX_K:
            dists, idx = quant_ops.grouped_int8_search(
                self._device_i8, self._scales, self._device, queries, table_dev, ids, k,
                count=self._count, block_n=self._i8_block,
            )
        else:
            dists, idx = grouped_ops.grouped_mask_search(
                self._device, queries.to(self.store_dtype), table_dev, ids, k,
                count=self._count, block_n=self.block_rows,
            )
        return dists.cpu().numpy(), idx.cpu().numpy()

    # ------------------------------------------------------------------
    def reconstruct(self, index: int) -> np.ndarray:
        """One stored row as float32.  While the host mirror exists it is
        read from there; after ``load_device_rows`` only this one row is
        read from the device, not the whole mirror (6 GB at 1M x 1536).
        Both give the same values: the lazy mirror is the same download."""
        if not 0 <= index < self._count:
            raise IndexError(index)
        if self._host_cache is None:
            return self._device[index].float().cpu().numpy()
        return self._host_cache[index].copy()

    def snapshot(self) -> np.ndarray:
        """Float32 host copy of the live rows (for persistence)."""
        return self._host[: self._count].copy()

    def snapshot_range(self, start: int, stop: int) -> np.ndarray:
        stop = min(stop, self._count)
        return self._host[start:stop].copy()

    def clear(self) -> None:
        self._count = 0
        self._device = None
        self._device_i8 = None
        self._scales = None
        self._host_cache = np.zeros((0, self.dimension), np.float32)
        with self._mask_lru_lock:
            self._mask_lru.clear()

    @classmethod
    def from_state(cls, state: Dict[str, object], *, device="cpu") -> "EmbeddingStore":
        """A store holding exactly the rows of ``state`` (see
        ``core/convert.py``): the same float32 rows, capacity, metric, dtype
        and, when present, the same int8 shadow."""
        rows = np.asarray(state["rows"], np.float32)[: int(state["count"])]
        rows_i8 = state.get("rows_i8")
        store = cls(
            rows.shape[1], device=device, metric=str(state["metric"]),
            store_dtype=str(state["dtype"]), quantized=rows_i8 is not None,
        )
        n = rows.shape[0]
        store._grow_to(max(n, int(state.get("capacity") or 0), 1))
        store._device[:n] = torch.from_numpy(rows).to(store.device, store.store_dtype)
        if rows_i8 is not None:
            store._device_i8[:n] = torch.from_numpy(np.asarray(rows_i8, np.int8)).to(store.device)
            store._scales[:n] = torch.from_numpy(np.asarray(state["scales"], np.float32)).to(store.device)
        store._host_cache = rows.copy()
        store._count = n
        return store

"""IVF coarse-quantized index for million-scale corpora.

Counterpart of ``photo_search_engine_tpu/models/ivf.py``:

* :func:`train_kmeans` — Lloyd iterations on the device, the assignment
  in row chunks.  The sample and the initial centroids are drawn with the
  same ``np.random.default_rng(seed)`` calls, in the same order, as the
  JAX function, so both packages start from the same rows.
* :func:`assign_clusters` — each row's three nearest centroids by
  ``2s − ‖c‖²``, ties to the smallest centroid id as ``lax.top_k`` gives
  them (a stable sort; ``torch.topk`` promises no order).
* :func:`balanced_layout` — every cluster gets ``L`` slots (slack × the
  mean size); overflow rows spill to their next-nearest cluster with
  room.  It runs in the JAX package's native C++ core
  (``photo_search_engine_tpu.native``, which imports no jax), with the
  same Python fallback.
* :class:`IVFIndex` — the cluster-major layout on the device.  A search
  picks each query's ``nprobe`` clusters (stage 1, :meth:`IVFIndex._probe`)
  and scans only those (stage 2, kernel 7 in ``ops/ivf_scan.py``).  The
  layout stays full precision by default, so recall is lost to cluster
  pruning only; ``quantized=True`` adds an int8 shadow that nominates
  candidates for an exact rescore.

The layout is gathered on the device from the rows, never laid out on the
host: the JAX ``build`` holds a float32 ``laid_out`` copy (1.5 × the
corpus, 9.7 GB at 1M × 1536) beside its snapshot, this one only the
snapshot it is given.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from photo_search_engine_tpu_torch.core import capacity as capacity_mod
from photo_search_engine_tpu_torch.ops import ivf_scan
from photo_search_engine_tpu_torch.ops.quantized import (
    INT8_MAX_K,
    quantize_rows,
    rescore_pool,
    resolve_store_quantized,
)
from photo_search_engine_tpu_torch.ops.topk import (
    merge_partials,
    resolve_store_dtype,
    row_sq_norms,
    stable_topk,
)

_LANE = 128
_INT_MAX = torch.iinfo(torch.int32).max
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_CHUNK = 131072  # rows per assignment / layout / quantize step

# Cap on the k-means training subsample (the JAX package's: 64+ samples
# per list are plenty, and one Lloyd step over 1M rows buys no recall).
_TRAIN_SAMPLE_CAP = 262_144


def _round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# k-means training (device)
# ---------------------------------------------------------------------------


def _lloyd_step(x: torch.Tensor, centroids: torch.Tensor, chunk: int = 65_536):
    """One Lloyd iteration over float32 rows ``x``; the assignment runs in
    row chunks, which bounds the ``[chunk, nlist]`` score and one-hot
    temporaries.  The cluster sums are one-hot products, as in JAX (no
    atomics, so a step is deterministic)."""
    nlist = centroids.shape[0]
    cn = (centroids * centroids).sum(dim=1)
    sums = torch.zeros_like(centroids)
    counts = torch.zeros(nlist, dtype=torch.float32, device=x.device)
    for start in range(0, x.shape[0], chunk):
        xc = x[start : start + chunk]
        assign = torch.argmax(2.0 * (xc @ centroids.T) - cn[None, :], dim=1)
        onehot = torch.nn.functional.one_hot(assign, nlist).float()
        sums += onehot.T @ xc
        counts += onehot.sum(dim=0)
    fresh = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, fresh, centroids), counts


def _initial_sample(n: int, nlist: int, rng, sample_per_list: int = 256):
    """Row ids of the training sample and, within it, of the initial
    centroids: the JAX functions' ``rng.choice`` calls, in their order."""
    sample_size = min(n, max(nlist, min(nlist * sample_per_list, _TRAIN_SAMPLE_CAP)))
    sample_ids = rng.choice(n, size=sample_size, replace=False)
    return sample_ids, rng.choice(sample_size, size=nlist, replace=False)


def _kmeans(sample: torch.Tensor, init: np.ndarray, iters: int) -> torch.Tensor:
    centroids = sample[torch.from_numpy(init).to(sample.device)]
    for _ in range(iters):
        centroids, _ = _lloyd_step(sample, centroids)
    return centroids


def train_kmeans(
    data: np.ndarray,
    nlist: int,
    iters: int = 10,
    seed: int = 0,
    sample_per_list: int = 256,
    *,
    device="cpu",
) -> np.ndarray:
    """``nlist`` float32 centroids from Lloyd iterations on ``device``, on
    a subsample of ``nlist * sample_per_list`` rows capped at
    ``_TRAIN_SAMPLE_CAP`` (training cost independent of the corpus size)."""
    data = np.asarray(data, np.float32)
    nlist = min(nlist, data.shape[0])
    sample_ids, init = _initial_sample(data.shape[0], nlist, np.random.default_rng(seed), sample_per_list)
    sample = torch.from_numpy(data[sample_ids]).to(device)
    return _kmeans(sample, init, iters).cpu().numpy()


def _assign_chunk(x: torch.Tensor, centroids: torch.Tensor, cn: torch.Tensor) -> torch.Tensor:
    """Top-3 of ``2·x·cᵀ − ‖c‖²`` per row, ties to the smallest centroid."""
    _, idx = stable_topk(2.0 * (x.float() @ centroids.T) - cn[None, :], min(3, centroids.shape[0]))
    return idx


def _ranked(parts) -> np.ndarray:
    ranked = np.concatenate(parts).astype(np.int32) if parts else np.zeros((0, 1), np.int32)
    if ranked.shape[1] < 3:  # tiny nlist: repeat the only choices
        ranked = np.concatenate([ranked] * 3, axis=1)[:, :3]
    return ranked


def assign_clusters(data: np.ndarray, centroids: np.ndarray, chunk: int = _CHUNK, *, device="cpu") -> np.ndarray:
    """Top-3 nearest centroids per row (on ``device``, chunked) → ``[N, 3]`` int32."""
    data = np.asarray(data, np.float32)
    cents = torch.from_numpy(np.asarray(centroids, np.float32)).to(device)
    cn = (cents * cents).sum(dim=1)
    parts = [
        _assign_chunk(torch.from_numpy(data[start : start + chunk]).to(device), cents, cn).cpu().numpy()
        for start in range(0, data.shape[0], chunk)
    ]
    return _ranked(parts)


def balanced_layout(ranked: np.ndarray, nlist: int, slack: float = 1.5) -> Tuple[np.ndarray, np.ndarray, int]:
    """Place each row into its nearest cluster with room (capacity = slack
    × mean size, rounded up to 128); rows with no room in any of their
    three spill to the emptiest cluster.  Returns ``(cluster_of_row, perm
    [nlist·L] row ids in cluster-major order with -1 padding, L)``."""
    n = ranked.shape[0]
    capacity = _round_up(max(1, int(np.ceil(slack * n / nlist))), _LANE)
    native = _native_layout(ranked, n, nlist, capacity)
    if native is not None:
        return native
    fill = np.zeros(nlist, np.int64)
    cluster_of_row = np.full(n, -1, np.int64)
    spill = []
    for row in range(n):
        for choice in ranked[row]:
            if fill[choice] < capacity:
                cluster_of_row[row] = choice
                fill[choice] += 1
                break
        else:
            spill.append(row)
    for row in spill:
        target = int(np.argmin(fill))
        cluster_of_row[row] = target
        fill[target] += 1
    capacity = _round_up(max(capacity, int(fill.max())), _LANE)
    perm = np.full(nlist * capacity, -1, np.int64)
    cursor = np.zeros(nlist, np.int64)
    for row in range(n):
        cluster = cluster_of_row[row]
        perm[cluster * capacity + cursor[cluster]] = row
        cursor[cluster] += 1
    return cluster_of_row, perm, capacity


def _native_layout(ranked, n, nlist, capacity) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """The placement in ``native/src/ivf_layout.cc`` (about 100× the
    Python loop at 1M rows), or None when the library is unavailable."""
    from photo_search_engine_tpu.native import get_library

    lib = get_library()
    if lib is None or n == 0:
        return None
    import ctypes

    ranked32 = np.ascontiguousarray(ranked[:, :3], np.int32)
    cluster_of_row = np.empty(n, np.int64)
    perm = np.empty(nlist * capacity, np.int64)
    placed = lib.pse_balanced_layout(
        ranked32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, nlist, capacity,
        cluster_of_row.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if placed != n:  # pathological input: the Python loop handles it
        return None
    return cluster_of_row, perm, capacity


def tune_nprobe_by_doubling(search_at, nlist: int, target_recall: float, *, start_nprobe: int = 8,
                            max_nprobe: Optional[int] = None) -> Tuple[int, float]:
    """Smallest power-of-two nprobe whose recall@k against the full-probe
    result reaches ``target_recall``; ``search_at(nprobe) -> ids``."""
    cap = min(nlist, max_nprobe or nlist)
    oracle_ids = search_at(nlist)

    def recall_of(ids) -> float:
        hits = 0.0
        for got, want in zip(ids, oracle_ids):
            want_set = {int(w) for w in want if w >= 0}
            if want_set:
                hits += len({int(g) for g in got if g >= 0} & want_set) / len(want_set)
        return hits / max(len(oracle_ids), 1)

    nprobe = max(1, min(start_nprobe, cap))
    best = recall_of(search_at(nprobe))
    while best < target_recall and nprobe < cap:
        nprobe = min(2 * nprobe, cap)
        best = recall_of(search_at(nprobe))
    return nprobe, best


# ---------------------------------------------------------------------------
# IVFIndex
# ---------------------------------------------------------------------------


def _upload_rows(corpus: np.ndarray, dtype, device) -> torch.Tensor:
    """``[N, D]`` host float32 rows as a ``dtype`` tensor on ``device``, in chunks."""
    out = torch.empty(corpus.shape, dtype=dtype, device=device)
    for start in range(0, corpus.shape[0], _CHUNK):
        out[start : start + _CHUNK] = torch.from_numpy(corpus[start : start + _CHUNK]).to(device)
    return out


def _lay_out(rows: torch.Tensor, perm: np.ndarray, quantized: bool) -> torch.Tensor:
    """The cluster-major layout ``rows[perm]``, zero where ``perm < 0``,
    gathered on the rows' device in chunks."""
    total, (n, dim) = perm.shape[0], rows.shape
    capacity_mod.check_store_allocation(
        total, n, dim, rows.element_size(), quantized, device=rows.device, what="IVF layout allocation",
    )
    out = torch.empty((total, dim), dtype=rows.dtype, device=rows.device)
    perm_dev = torch.from_numpy(perm).to(rows.device)
    for start in range(0, total, _CHUNK):
        ids = perm_dev[start : start + _CHUNK]
        block = rows[torch.clamp(ids, min=0)]
        out[start : start + ids.shape[0]] = block.masked_fill_((ids < 0)[:, None], 0)
    return out


class IVFIndex:
    """Cluster-pruned exact-scoring index (layout + search) on one device."""

    _MASK_LRU_SIZE = 16

    def __init__(
        self,
        centroids: np.ndarray,
        corpus_ivf: torch.Tensor,  # [nlist * L, D] slot-major rows, padding rows zero
        perm: np.ndarray,  # [nlist * L] original row id or -1
        capacity: int,
        *,
        metric: str = "ip",
        store_dtype: str = "float32",
        quantized=False,
        device="cpu",
    ) -> None:
        self.device = _device(device)
        self.quantized = resolve_store_quantized(quantized)
        # copies: append writes perm, and neither may alias a caller's state
        self.centroids = np.array(centroids, np.float32)
        self.nlist = self.centroids.shape[0]
        self.capacity = int(capacity)
        self.perm = np.array(perm, np.int64)
        self.metric = metric
        self.dim = int(corpus_ivf.shape[1])
        dtype = _DTYPES[resolve_store_dtype(store_dtype, self.device)]
        self._corpus = corpus_ivf.to(self.device, dtype).contiguous()
        self._centroids_dev = torch.from_numpy(self.centroids).to(self.device)
        self._row_valid = torch.from_numpy((self.perm >= 0).astype(np.int8)).to(self.device)
        self._fill = self._fill_from_perm()
        self._cnorms: Optional[torch.Tensor] = None
        self._corpus_i8: Optional[torch.Tensor] = None
        self._cscales: Optional[torch.Tensor] = None
        self._mask_lru: "OrderedDict[Tuple[bytes, int], torch.Tensor]" = OrderedDict()
        self._mask_lru_lock = threading.Lock()
        self.build_seconds: Dict[str, float] = {}  # filled by build / build_on_device

    def _fill_from_perm(self) -> np.ndarray:
        return (self.perm.reshape(self.nlist, self.capacity) >= 0).sum(axis=1)

    def _ensure_quantized(self) -> None:
        """The int8 shadow of the layout, built lazily in chunks."""
        if self._corpus_i8 is not None:
            return
        corpus_i8 = torch.empty(self._corpus.shape, dtype=torch.int8, device=self.device)
        scales = torch.empty(self._corpus.shape[0], dtype=torch.float32, device=self.device)
        for start in range(0, self._corpus.shape[0], _CHUNK):
            q, s = quantize_rows(self._corpus[start : start + _CHUNK])
            corpus_i8[start : start + q.shape[0]] = q
            scales[start : start + q.shape[0]] = s
        self._corpus_i8, self._cscales = corpus_i8, scales

    def _corpus_norms(self) -> torch.Tensor:
        """``[nlist·L]`` squared row norms (the l2 operand of kernel 7),
        cached and dropped by :meth:`append`."""
        if self._cnorms is None:
            self._cnorms = row_sq_norms(self._corpus)
        return self._cnorms

    # -- construction ---------------------------------------------------
    @classmethod
    def build(
        cls,
        corpus: np.ndarray,
        nlist: int,
        *,
        metric: str = "ip",
        store_dtype: str = "float32",
        train_iters: int = 10,
        slack: float = 1.5,
        seed: int = 0,
        quantized=False,
        device="cpu",
    ) -> "IVFIndex":
        """Train, assign and lay out host float32 rows.  The rows go to the
        device once: each assignment chunk is kept there in the store
        dtype, and the layout is gathered from that copy."""
        device = _device(device)
        corpus = np.asarray(corpus, np.float32)
        n, dim = corpus.shape
        nlist = max(1, min(nlist, n))
        dtype = _DTYPES[resolve_store_dtype(store_dtype, device)]
        seconds = {}
        t = time.perf_counter()
        centroids = train_kmeans(corpus, nlist, iters=train_iters, seed=seed, device=device)
        seconds["kmeans"] = time.perf_counter() - t
        t = time.perf_counter()
        capacity_mod.check_store_allocation(
            n, 0, dim, torch.empty((), dtype=dtype).element_size(), False, device=device,
            what="IVF build upload",
        )
        rows = torch.empty((n, dim), dtype=dtype, device=device)
        cents = torch.from_numpy(centroids).to(device)
        cn = (cents * cents).sum(dim=1)
        parts = []
        for start in range(0, n, _CHUNK):
            chunk = torch.from_numpy(corpus[start : start + _CHUNK]).to(device)
            parts.append(_assign_chunk(chunk, cents, cn).cpu().numpy())
            rows[start : start + chunk.shape[0]] = chunk
        ranked = _ranked(parts)
        seconds["assign_and_upload"] = time.perf_counter() - t
        return cls._from_device_rows(rows, centroids, ranked, nlist, slack, metric, quantized, seconds)

    @classmethod
    def build_on_device(
        cls,
        corpus_dev: torch.Tensor,
        nlist: int,
        *,
        metric: str = "ip",
        train_iters: int = 10,
        slack: float = 1.5,
        seed: int = 0,
        quantized=False,
    ) -> "IVFIndex":
        """Device-resident build: the rows never go to the host; only the
        ``[N, 3]`` assignment table comes back (12 MB at 1M rows).  The
        store dtype is the rows' dtype."""
        n = corpus_dev.shape[0]
        nlist = max(1, min(nlist, n))
        seconds = {}
        t = time.perf_counter()
        sample_ids, init = _initial_sample(n, nlist, np.random.default_rng(seed))
        sample = corpus_dev[torch.from_numpy(sample_ids).to(corpus_dev.device)].float()
        cents = _kmeans(sample, init, train_iters)
        del sample
        seconds["kmeans"] = time.perf_counter() - t
        t = time.perf_counter()
        cn = (cents * cents).sum(dim=1)
        ranked = _ranked([
            _assign_chunk(corpus_dev[start : start + _CHUNK], cents, cn).cpu().numpy()
            for start in range(0, n, _CHUNK)
        ])
        seconds["assign"] = time.perf_counter() - t
        return cls._from_device_rows(corpus_dev, cents.cpu().numpy(), ranked, nlist, slack, metric, quantized, seconds)

    @classmethod
    def _from_device_rows(cls, rows, centroids, ranked, nlist, slack, metric, quantized, seconds) -> "IVFIndex":
        t = time.perf_counter()
        _, perm, capacity = balanced_layout(ranked, nlist, slack=slack)
        seconds["placement"] = time.perf_counter() - t
        t = time.perf_counter()
        laid_out = _lay_out(rows, perm, resolve_store_quantized(quantized))
        _sync(rows.device)
        seconds["layout"] = time.perf_counter() - t
        index = cls(centroids, laid_out, perm, capacity, metric=metric,
                    store_dtype=str(rows.dtype).replace("torch.", ""), quantized=quantized, device=rows.device)
        index.build_seconds = seconds
        return index

    # -- persistence -------------------------------------------------------
    def state(self) -> dict:
        """Host-side trained state (centroids, perm, capacity, metric): all
        that :meth:`from_state` needs besides the rows.  The layout is a
        gather of the rows through ``perm`` and is not included."""
        return {
            "centroids": self.centroids,
            "perm": self.perm,
            "capacity": np.int64(self.capacity),
            "metric": self.metric,
        }

    @classmethod
    def from_state(cls, corpus: np.ndarray, state: dict, *, store_dtype: str = "float32", quantized=False,
                   device="cpu") -> "IVFIndex":
        """Restore a trained index from ``state()`` and the rows in their
        original order, without training."""
        device = _device(device)
        corpus = np.asarray(corpus, np.float32)
        centroids = np.asarray(state["centroids"], np.float32)
        perm = np.asarray(state["perm"], np.int64)
        capacity = int(state["capacity"])
        if perm.shape[0] != centroids.shape[0] * capacity:
            raise ValueError("IVF state perm/capacity mismatch")
        live = perm >= 0
        if live.any() and int(perm[live].max()) >= corpus.shape[0]:
            raise ValueError("IVF state references rows beyond the corpus")
        dtype = _DTYPES[resolve_store_dtype(store_dtype, device)]
        laid_out = _lay_out(_upload_rows(corpus, dtype, device), perm, resolve_store_quantized(quantized))
        return cls(centroids, laid_out, perm, capacity, metric=str(state.get("metric", "ip")),
                   store_dtype=store_dtype, quantized=quantized, device=device)

    # -- incremental append ----------------------------------------------
    def append(self, vectors: np.ndarray, row_ids: np.ndarray) -> bool:
        """Add rows to the existing lists without retraining (FAISS
        ``IndexIVF.add``): each row takes its nearest of three clusters with
        a free slot, else the emptiest.  False when the layout is full (the
        caller rebuilds)."""
        vectors = np.asarray(vectors, np.float32)
        row_ids = np.asarray(row_ids, np.int64)
        m = vectors.shape[0]
        if m == 0:
            return True
        if int(self._fill.sum()) + m > self.nlist * self.capacity:
            return False
        ranked = assign_clusters(vectors, self.centroids, device=self.device)
        slots = np.empty(m, np.int64)
        for r in range(m):
            target = next((int(c) for c in ranked[r] if self._fill[c] < self.capacity), -1)
            if target < 0:
                target = int(np.argmin(self._fill))
                if self._fill[target] >= self.capacity:
                    return False
            slots[r] = target * self.capacity + self._fill[target]
            self._fill[target] += 1
        self.perm[slots] = row_ids
        slots_dev = torch.from_numpy(slots).to(self.device)
        # an in-place index_copy_ stands in for the JAX package's donated
        # scatter: the multi-GB layout is written, not copied
        self._corpus.index_copy_(0, slots_dev, torch.from_numpy(vectors).to(self.device, self._corpus.dtype))
        self._row_valid[slots_dev] = 1
        self._cnorms = None  # the norm cache and the int8 shadow cover the old rows only
        self._corpus_i8 = None
        self._cscales = None
        return True

    # -- nprobe autotune --------------------------------------------------
    def tune_nprobe(self, queries: np.ndarray, k: int, target_recall: float = 0.98, *, start_nprobe: int = 8,
                    max_nprobe: Optional[int] = None) -> Tuple[int, float]:
        """Smallest power-of-two nprobe whose recall@k on ``queries``
        against the full-probe result reaches ``target_recall``; returns
        ``(nprobe, achieved recall)``."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        k = max(1, min(k, int((self.perm >= 0).sum())))
        return tune_nprobe_by_doubling(
            lambda nprobe: self.search(queries, k, nprobe=nprobe)[1], self.nlist, target_recall,
            start_nprobe=start_nprobe, max_nprobe=max_nprobe,
        )

    # -- filters ----------------------------------------------------------
    def supports_masked_search(self) -> bool:
        """A filter folds into kernel 7's row validity, for every metric."""
        return True

    def _slot_mask(self, mask: np.ndarray) -> Tuple[torch.Tensor, float]:
        """Filter bits in original row order → int8 ``[nlist·L]`` slot mask
        on the device (LRU-cached by content; the micro-batcher's two
        pipeline threads share the cache under its lock), and the share of
        live rows the filter keeps."""
        bits = np.asarray(mask).astype(np.int8, copy=False)
        live = self.perm >= 0
        slot_bits = np.zeros(self.perm.shape[0], np.int8)
        slot_bits[live] = bits[np.clip(self.perm[live], 0, bits.shape[0] - 1)]
        ratio = float(slot_bits.sum(dtype=np.int64)) / max(int(live.sum()), 1)
        key = (hashlib.blake2b(slot_bits.tobytes(), digest_size=16).digest(), slot_bits.shape[0])
        with self._mask_lru_lock:
            cached = self._mask_lru.get(key)
            if cached is not None:
                self._mask_lru.move_to_end(key)
                return cached, ratio
        dev = torch.from_numpy(slot_bits).to(self.device)
        with self._mask_lru_lock:
            self._mask_lru[key] = dev
            while len(self._mask_lru) > self._MASK_LRU_SIZE:
                self._mask_lru.popitem(last=False)
        return dev, ratio

    @staticmethod
    def _inflate_nprobe(nprobe: int, ratio: float, nlist: int) -> int:
        """A selective filter thins out the probed lists: widen the probe
        set by about 1/selectivity (at most 16×), to a power-of-two
        multiple of nprobe, capped at nlist."""
        target = min(nlist, nprobe * min(int(np.ceil(1.0 / max(ratio, 1e-3))), 16))
        eff = nprobe
        while eff < target:
            eff *= 2
        return min(eff, nlist)

    # -- search -----------------------------------------------------------
    def _probe(self, queries: torch.Tensor, nprobe: int) -> torch.Tensor:
        """Stage 1: each query's ``nprobe`` nearest centroids by
        ``2s − ‖c‖²`` (for both metrics: rows were assigned by L2), ties to
        the smallest id, as int32 ``[Q, nprobe]`` sorted ascending (so the
        scan's partials lie in slot order).  ``queries`` are in the store
        dtype: the JAX search probes with store-dtype queries too."""
        nprobe = max(1, min(nprobe, self.nlist))
        cents = self._centroids_dev
        scores = 2.0 * (queries.float() @ cents.T) - (cents * cents).sum(dim=1)[None, :]
        _, ids = stable_topk(scores, nprobe)
        return torch.sort(ids, dim=1).values.to(torch.int32).contiguous()

    def search(self, queries: np.ndarray, k: int, nprobe: int = 64, *, mask: Optional[np.ndarray] = None):
        """``(distances, original row ids)``, ``-1`` in empty slots; ip
        distances descending, l2 squared distances ascending.

        ``mask`` (original row order) filters without losing the pruning:
        it folds into the slot validity, and nprobe widens by about
        1/selectivity.  The int8 tier (``quantized``) nominates
        ``min(max(2k, 20), 64, L)`` candidates and rescores them exactly;
        k > 64 scans the full-precision layout (JAX leaves its kernel for
        an exact XLA scan there: the same result)."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        q = queries.shape[0]
        k = min(k, int((self.perm >= 0).sum()))
        if k == 0:
            return np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int64)
        qdev = torch.from_numpy(queries).to(self.device).to(self._corpus.dtype).contiguous()
        row_valid = self._row_valid
        if mask is not None:
            slot_mask, ratio = self._slot_mask(mask)
            row_valid = row_valid * slot_mask
            nprobe = self._inflate_nprobe(nprobe, ratio, self.nlist)
        probe_ids = self._probe(qdev, nprobe)
        metric = "l2" if self.metric == "l2" else "ip"
        cnorms = self._corpus_norms() if metric == "l2" else None
        qf = qdev.float()
        if self.quantized and k <= INT8_MAX_K:
            self._ensure_quantized()
            k_kern = min(max(2 * k, 20), INT8_MAX_K, self.capacity)
            q_i8, qs = ivf_scan.quantize_ivf_queries(qf)
            part_v, part_i = ivf_scan.ivf_block_topk(
                self._corpus_i8, q_i8, probe_ids, row_valid, k_kern, lrows=self.capacity, metric=metric,
                cnorms=cnorms, qscales=qs, cscales=self._cscales,
            )
            vals, idx = rescore_pool(
                part_v.reshape(q, -1, part_v.shape[-1]), part_i.reshape(q, -1, part_i.shape[-1]),
                self._corpus, qf, k, cand=k_kern, metric=metric,
            )
        else:
            part_v, part_i = ivf_scan.ivf_block_topk(
                self._corpus, qdev, probe_ids, row_valid, k, lrows=self.capacity, metric=metric, cnorms=cnorms,
            )
            vals, idx = merge_partials(part_v, part_i, k)
            if metric == "l2":
                # the kernel merged by 2<q,c> - |c|²; subtract |q|² to restore -(squared l2)
                vals = torch.where(torch.isneginf(vals), vals, vals - (qf * qf).sum(dim=1, keepdim=True))
        if vals.shape[1] < k:  # fewer probed slots than k
            pad = k - vals.shape[1]
            vals = torch.nn.functional.pad(vals, (0, pad), value=float("-inf"))
            idx = torch.nn.functional.pad(idx, (0, pad), value=_INT_MAX)
        return self._to_rows(vals.cpu().numpy(), idx.cpu().numpy())

    def _to_rows(self, vals: np.ndarray, idx: np.ndarray):
        """Slot ids → original row ids (-1 where empty), kernel-space
        values → the distance conventions of :meth:`search`."""
        empty = ~np.isfinite(vals) if self.metric == "ip" else np.isneginf(vals)
        original = np.where((idx >= 0) & ~empty, self.perm[np.clip(idx, 0, len(self.perm) - 1)], -1)
        if self.metric == "l2":
            return np.where(empty, np.inf, -vals).astype(np.float32), original
        return np.where(empty, -np.inf, vals).astype(np.float32), original

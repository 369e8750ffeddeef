"""IVF coarse-quantized index for million-scale corpora.

Counterpart of ``photo_search_engine_tpu/models/ivf.py``:

* :func:`train_kmeans` — Lloyd iterations on the device, the assignment
  in row chunks.  The sample and the initial centroids are drawn with the
  same ``np.random.default_rng(seed)`` calls, in the same order, as the
  JAX function, so both packages start from the same rows.
* :func:`assign_clusters` — each row's three nearest centroids by
  ``2s − ‖c‖²`` in ``lax.top_k``'s order (``ops.topk.total_order_topk``:
  a stable sort of total-order keys, ties to the smallest centroid id;
  ``torch.topk`` promises no order).
* :func:`balanced_layout` — every cluster gets ``L`` slots (slack × the
  mean size); overflow rows spill to their next-nearest cluster with
  room.  It runs in the native C++ host library (``native/``, a copy of
  the JAX package's), with the same Python fallback.
* :class:`IVFIndex` — the cluster-major layout on the device.  A search
  picks each query's ``nprobe`` clusters (stage 1, :meth:`IVFIndex._probe`)
  and scans only those (stage 2, kernel 7 in ``ops/ivf_scan.py``).  The
  layout stays full precision by default, so recall is lost to cluster
  pruning only; ``quantized=True`` adds an int8 shadow that nominates
  candidates for an exact rescore.  On a card, an unfiltered search of a
  few queries replays its scan as one CUDA graph (:func:`replays_graph`).

The layout is gathered on the device from the rows, never laid out on the
host: the JAX ``build`` holds a float32 ``laid_out`` copy (1.5 × the
corpus, 9.7 GB at 1M × 1536) beside its snapshot, this one only the
snapshot it is given.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from photo_search_engine_tpu_torch import tracing
from photo_search_engine_tpu_torch.core import capacity as capacity_mod
from photo_search_engine_tpu_torch.core.content_lru import ContentLRU
from photo_search_engine_tpu_torch.device import resolve_device
from photo_search_engine_tpu_torch.ops import ivf_scan
from photo_search_engine_tpu_torch.ops.quantized import (
    INT8_MAX_K,
    quantize_rows,
    resolve_store_quantized,
)
from photo_search_engine_tpu_torch.ops.topk import (
    merge_partials,
    rescore_pool,
    resolve_store_dtype,
    row_sq_norms,
    total_order_topk,
)

_LANE = 128
_INT_MAX = torch.iinfo(torch.int32).max
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_CHUNK = 131072  # rows per assignment / layout / quantize step

# Cap on the k-means training subsample (the JAX package's: 64+ samples
# per list are plenty, and one Lloyd step over 1M rows buys no recall).
_TRAIN_SAMPLE_CAP = 262_144

# Query counts whose scan replays a CUDA graph: kernel 7's small query
# group (ops/ivf_scan.IVF_BQ), where enqueueing the scan's ~40 launches
# takes longer than the kernel.  Larger batches run eager.
GRAPH_MAX_QUERIES = 8


def _round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


def _device(device) -> torch.device:
    """``device``, or the one ``PSE_PLATFORM`` names when it is None."""
    device = resolve_device() if device is None else torch.device(device)
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
    _, idx = total_order_topk(2.0 * (x.float() @ centroids.T) - cn[None, :], min(3, centroids.shape[0]))
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
    from photo_search_engine_tpu_torch.native import get_library

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


def replays_graph(device, queries: int, masked: bool) -> bool:
    """Whether :meth:`IVFIndex.search` replays a CUDA graph of its scan: on
    a CUDA device, with no filter, for at most :data:`GRAPH_MAX_QUERIES`
    queries.  Any other call runs the scan eagerly."""
    return torch.device(device).type == "cuda" and not masked and 0 < queries <= GRAPH_MAX_QUERIES


class _ScanGraph:
    """:meth:`IVFIndex._scan` of one ``(q, k, nprobe)``, captured as a CUDA
    graph (:meth:`IVFIndex._capture`).

    The graph reads float32 queries from ``dev_in`` and leaves ``[q, 2k +
    nprobe]`` int32 in ``dev_out``: the values' bits, the slot ids and the
    probe ids, so one download brings all three.  It holds the addresses of
    the index's tensors, not references, so ``keep`` holds those that
    :meth:`IVFIndex.append` replaces.  ``lock`` gives the static buffers to
    one call at a time, from the upload to the results on the host."""

    def __init__(self, graph, dev_in, dev_out, k, keep) -> None:
        self.graph, self.dev_in, self.dev_out, self.k, self.keep = graph, dev_in, dev_out, k, keep
        self.host_in = torch.empty(dev_in.shape, dtype=dev_in.dtype, pin_memory=True)
        self.host_out = torch.empty(dev_out.shape, dtype=dev_out.dtype, pin_memory=True)
        self.lock = threading.Lock()

    def run(self, queries: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(vals, slot ids, probe ids)`` on the host for float32
        ``[q, D]`` queries: a pinned upload, the replay and one pinned
        download on the current stream, then one synchronisation."""
        with self.lock:
            self.host_in.numpy()[...] = queries
            self.dev_in.copy_(self.host_in, non_blocking=True)
            self.graph.replay()
            self.host_out.copy_(self.dev_out, non_blocking=True)
            torch.cuda.current_stream(self.dev_in.device).synchronize()
            out = self.host_out.numpy().copy()
        k = self.k
        return out[:, :k].view(np.float32), out[:, k : 2 * k], out[:, 2 * k :]


class IVFIndex:
    """Cluster-pruned exact-scoring index (layout + search) on one device."""

    _GRAPH_LRU_SIZE = 16

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
        device=None,
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
        self._centroid_norms = (self._centroids_dev * self._centroids_dev).sum(dim=1)  # ‖c‖² of the probe
        self._row_valid = torch.from_numpy((self.perm >= 0).astype(np.int8)).to(self.device)
        self._fill = self._fill_from_perm()
        self._cnorms: Optional[torch.Tensor] = None
        self._corpus_i8: Optional[torch.Tensor] = None
        self._cscales: Optional[torch.Tensor] = None
        self._masks = ContentLRU(16)  # slot masks by content
        # captured scans by (q, k, nprobe, kernel 7's wrapper); None: the capture failed, the shape runs eager
        self._graphs: "OrderedDict[tuple, Optional[_ScanGraph]]" = OrderedDict()
        self._graph_lock = threading.Lock()  # the cache, a capture, and append's replacement of what graphs read
        self.build_seconds: Dict[str, float] = {}  # filled by build / build_on_device

    def _fill_from_perm(self) -> np.ndarray:
        return (self.perm.reshape(self.nlist, self.capacity) >= 0).sum(axis=1)

    @property
    def live_count(self) -> int:
        """Live slots of the layout, ``(perm >= 0).sum()``, from the
        per-list fill that construction and :meth:`append` keep (a sum over
        ``nlist`` counts, not a pass over ``perm``)."""
        return int(self._fill.sum())

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

    def _kernel_layout(self, k: int) -> Tuple[torch.Tensor, int]:
        """The layout kernel 7 scans for a top-``k`` search, and its k: for
        ``quantized`` and k <= 64 the int8 shadow (built here on first use),
        which nominates ``min(max(2k, 20), 64, L)`` candidates for the
        rescore; else the layout itself, at k."""
        if self.quantized and k <= INT8_MAX_K:
            self._ensure_quantized()
            return self._corpus_i8, min(max(2 * k, 20), INT8_MAX_K, self.capacity)
        return self._corpus, k

    def _prepare_scan(self, k: int) -> None:
        """Build what a top-``k`` scan reads besides the layout (the int8
        shadow, the l2 norms)."""
        if self.metric == "l2":
            self._corpus_norms()
        self._kernel_layout(k)

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
        device=None,
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
                   device=None) -> "IVFIndex":
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
        if self.live_count + m > self.nlist * self.capacity:
            return False
        ranked = assign_clusters(vectors, self.centroids, device=self.device)
        slots = np.empty(m, np.int64)
        fill = self._fill.copy()  # kept only if every row finds a slot
        for r in range(m):
            target = next((int(c) for c in ranked[r] if fill[c] < self.capacity), -1)
            if target < 0:
                target = int(np.argmin(fill))
                if fill[target] >= self.capacity:
                    return False
            slots[r] = target * self.capacity + fill[target]
            fill[target] += 1
        self._fill = fill
        self.perm[slots] = row_ids
        slots_dev = torch.from_numpy(slots).to(self.device)
        # an in-place index_copy_ stands in for the JAX package's donated
        # scatter: the multi-GB layout is written, not copied
        self._corpus.index_copy_(0, slots_dev, torch.from_numpy(vectors).to(self.device, self._corpus.dtype))
        self._row_valid[slots_dev] = 1
        with self._graph_lock:  # the norm cache and the int8 shadow cover the old rows only
            self._cnorms = None
            self._corpus_i8 = None
            self._cscales = None
            self._graphs.clear()  # graphs read the replaced tensors; the next call of a shape recaptures
        return True

    # -- nprobe autotune --------------------------------------------------
    def tune_nprobe(self, queries: np.ndarray, k: int, target_recall: float = 0.98, *, start_nprobe: int = 8,
                    max_nprobe: Optional[int] = None) -> Tuple[int, float]:
        """Smallest power-of-two nprobe whose recall@k on ``queries``
        against the full-probe result reaches ``target_recall``; returns
        ``(nprobe, achieved recall)``."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        k = max(1, min(k, self.live_count))
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
        dev = self._masks.get(ContentLRU.key(slot_bits, slot_bits.shape[0]),
                              lambda: torch.from_numpy(slot_bits).to(self.device))
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
        scores = 2.0 * (queries.float() @ self._centroids_dev.T) - self._centroid_norms[None, :]
        _, ids = total_order_topk(scores, nprobe)
        return torch.sort(ids, dim=1).values.to(torch.int32).contiguous()

    def search(self, queries: np.ndarray, k: int, nprobe: int = 64, *, mask: Optional[np.ndarray] = None):
        """``(distances, original row ids)``, ``-1`` in empty slots; ip
        distances descending, l2 squared distances ascending.

        ``mask`` (original row order) filters without losing the pruning:
        it folds into the slot validity, and nprobe widens by about
        1/selectivity.  The int8 tier (``quantized``) nominates
        ``min(max(2k, 20), 64, L)`` candidates and rescores them exactly;
        k > 64 scans the full-precision layout (JAX leaves its kernel for
        an exact XLA scan there: the same result).

        An unfiltered call on a CUDA device with at most
        :data:`GRAPH_MAX_QUERIES` queries (:func:`replays_graph`) replays a
        CUDA graph of the scan, one per ``(q, k, nprobe)``: the first call
        of a shape runs eagerly, then captures it (:meth:`_capture`).  The
        replay runs the same kernels on the same inputs, so it returns the
        eager scan's results bit for bit.  Filtered calls, larger batches
        and the CPU run the scan eagerly.

        While a ``torch.profiler`` session records, the call records the
        span ``ivf.search`` (``tracing.py``) and, inside it, ``ivf.scan``:
        the probe, kernel 7, the merge and the download of the results, with
        what kernel 7 had to do for the call (:meth:`_scan_attrs`)."""
        with tracing.span("ivf.search"):
            queries = np.atleast_2d(np.asarray(queries, np.float32))
            q = queries.shape[0]
            k = min(k, self.live_count)
            if k == 0:
                return np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int64)
            row_valid = self._row_valid
            if mask is not None:
                slot_mask, ratio = self._slot_mask(mask)
                row_valid = row_valid * slot_mask
                nprobe = self._inflate_nprobe(nprobe, ratio, self.nlist)
            use_graph = replays_graph(self.device, q, mask is not None)
            traced = tracing.on()
            start = time.perf_counter_ns() if traced else 0
            graph = self._graph(q, k, nprobe) if use_graph else None
            if graph is not None:
                vals, idx, probes = graph.run(queries)
            else:
                vals, idx, probes = self._scan(torch.from_numpy(queries).to(self.device), k, nprobe, row_valid)
                vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
            if traced:
                end = time.perf_counter_ns()
                up = tracing.current()
                ids = probes if graph is not None else probes.cpu().numpy()
                tracing.record("ivf.scan", start, end, parent=up.id, req=up.req, batch=up.batch,
                               **self._scan_attrs(ids, k, mask is not None, graph is not None))
            if use_graph and graph is None:
                self._capture(q, k, nprobe)
            return self._to_rows(vals, idx)

    def _scan_attrs(self, probes: np.ndarray, k: int, masked: bool, graph: bool) -> dict:
        """What kernel 7 had to do for one scan, from the per-list fill and
        the host copy of the probe ids (an eager scan downloads them after
        its results, so only while tracing): ``queries``, ``k``, ``lrows``
        (slots a list), ``dim``, ``lists`` (distinct lists probed),
        ``list_rows`` (their live rows, each counted once), ``pair_rows``
        (live rows summed over the (query, list) pairs: the rows scored),
        ``masked`` (a filter, which the fill does not see, thinned the rows)
        and ``graph`` (the scan was a CUDA graph's replay)."""
        ids = probes.astype(np.int64)
        ids = ids[(ids >= 0) & (ids < self.nlist)]
        distinct = np.unique(ids)
        return {
            "queries": int(probes.shape[0]), "k": int(k), "lrows": self.capacity, "dim": self.dim,
            "lists": int(distinct.size), "list_rows": int(self._fill[distinct].sum()),
            "pair_rows": int(self._fill[ids].sum()), "masked": bool(masked), "graph": bool(graph),
        }

    def _graph_key(self, q: int, k: int, nprobe: int) -> tuple:
        # kernel 7's wrapper is part of the key: a graph replays the launches
        # of the function it captured, and a caller may swap in the plain
        # version (tests.torch_parity.plain_scan)
        return q, k, max(1, min(nprobe, self.nlist)), ivf_scan.ivf_block_topk

    def _graph(self, q: int, k: int, nprobe: int) -> Optional[_ScanGraph]:
        """The captured scan of ``(q, k, nprobe)``, or None (not captured
        yet, or the capture failed)."""
        key = self._graph_key(q, k, nprobe)
        with self._graph_lock:
            graph = self._graphs.get(key)
            if graph is not None:
                self._graphs.move_to_end(key)
            return graph

    def _capture(self, q: int, k: int, nprobe: int) -> None:
        """Capture :meth:`_scan` of ``(q, k, nprobe)`` unless the cache has
        the shape, under the index's graph lock, keeping the last
        ``_GRAPH_LRU_SIZE`` shapes.  What the scan reads is built first; one
        eager scan on the capture stream sets up cuBLAS's and the sorts'
        workspaces there; the capture is ``thread_local``, so other threads'
        launches, copies and synchronisations during it neither join nor
        break it."""
        key = self._graph_key(q, k, nprobe)
        with self._graph_lock:
            if key in self._graphs:
                return
            self._prepare_scan(k)
            current = torch.cuda.current_stream(self.device)
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(current)
            dev_in = torch.zeros((q, self.dim), dtype=torch.float32, device=self.device)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.stream(stream):
                    self._scan(dev_in, k, nprobe, self._row_valid)
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        vals, idx, probes = self._scan(dev_in, k, nprobe, self._row_valid)
                        dev_out = torch.cat([vals.view(torch.int32), idx, probes], dim=1)
                    finally:
                        graph.capture_end()
                current.wait_stream(stream)
                entry = _ScanGraph(graph, dev_in, dev_out, k, (self._cnorms, self._corpus_i8, self._cscales))
            except RuntimeError as exc:  # a capture CUDA refused: the shape keeps the eager scan
                print(f"[WARN] IVF scan of {q} queries, k={k}, nprobe={nprobe} not captured as a CUDA graph: {exc}")
                entry = None
            self._graphs[key] = entry
            while len(self._graphs) > self._GRAPH_LRU_SIZE:
                self._graphs.popitem(last=False)

    def _scan(self, queries: torch.Tensor, k: int, nprobe: int, row_valid: torch.Tensor):
        """Stages 1 and 2 on the device for ``queries`` on it: kernel-space
        ``(vals [Q, k], slot ids [Q, k], probe ids [Q, nprobe])``, ``-inf``
        / ``INT_MAX`` in empty slots; nothing is read back.  The int8 tier
        runs for ``quantized`` and k <= 64 (its shadow is built here on
        first use)."""
        q = queries.shape[0]
        qdev = queries.to(self._corpus.dtype).contiguous()
        probe_ids = self._probe(qdev, nprobe)
        metric = "l2" if self.metric == "l2" else "ip"
        cnorms = self._corpus_norms() if metric == "l2" else None
        qf = qdev.float()
        layout, k_kern = self._kernel_layout(k)
        if layout.dtype == torch.int8:
            q_i8, qs = ivf_scan.quantize_ivf_queries(qf)
            part_v, part_i = ivf_scan.ivf_block_topk(
                layout, q_i8, probe_ids, row_valid, k_kern, lrows=self.capacity, metric=metric,
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
        return vals, idx, probe_ids

    # -- device-only search (benchmark / composition surface) -------------
    def device_search_fn(self, k: int, nprobe: int, batch: int):
        """``fn(queries) -> (vals, slot_idx)``: the search of :meth:`search`
        for ``[batch, D]`` queries already on the index's device, all of it
        on the device with no host synchronisation, for timing launches
        back to back and for composing into larger device programs.

        What depends on the shapes is fixed here: k (at most the live
        rows), nprobe (at most nlist), and the int8 shadow and l2 norms the
        scan will read, built now.  ``fn`` returns float32 ``[batch, k]``
        kernel-space values (higher is better; l2 as ``-‖q − c‖²``) and
        int32 slot ids of the layout (``perm`` maps them to row ids),
        ``-inf`` / ``INT_MAX`` in empty slots, on the device."""
        nprobe = max(1, min(nprobe, self.nlist))
        k = max(1, min(k, self.live_count))
        self._prepare_scan(k)
        shape = (batch, self.dim)

        def fn(queries: torch.Tensor):
            if tuple(queries.shape) != shape or queries.device != self.device:
                raise ValueError(f"device_search_fn: expected {shape} queries on {self.device}, "
                                 f"got {tuple(queries.shape)} on {queries.device}")
            return self._scan(queries, k, nprobe, self._row_valid)[:2]

        return fn

    def _to_rows(self, vals: np.ndarray, idx: np.ndarray):
        """Slot ids → original row ids (-1 where empty), kernel-space
        values → the distance conventions of :meth:`search`."""
        empty = ~np.isfinite(vals) if self.metric == "ip" else np.isneginf(vals)
        original = np.where((idx >= 0) & ~empty, self.perm[np.clip(idx, 0, len(self.perm) - 1)], -1)
        if self.metric == "l2":
            return np.where(empty, np.inf, -vals).astype(np.float32), original
        return np.where(empty, -np.inf, vals).astype(np.float32), original

"""Vector index: metadata-carrying wrapper over the device EmbeddingStore.

Counterpart of ``photo_search_engine_tpu/core/vector_index.py``, flat
(exact) and IVF index.  The on-disk format is the JAX package's: a float32
``.npy`` of the rows, a metadata JSON list, a ``.meta.json`` sidecar that
``load`` validates, committed per-batch segments (``<index>.segments/``,
see :meth:`VectorIndex.save_incremental`) and, for ``index_type=ivf``, the
trained IVF in ``<index>.ivf.npz``.  Each package loads the other's
checkpoints, the IVF sidecar included (no retraining).

``index_type=ivf`` (and ``hnsw``, which maps to it as in the JAX package)
keeps the flat store beside an IVF layout built on the first routed
search (``models/ivf.py``): unfiltered searches and, off the
micro-batcher, filtered ones scan only the probed clusters (kernel 7).
``raw_grouped_search_batch`` is the micro-batcher's filtered path: one
scan of the flat store for queries with different predicates
(``core/batcher.py``).

``mesh_devices`` N >= 1 row-shards the corpus over a mesh of N shards
(``core/mesh_store.py``, ``parallel/sharded.py``; 1 is the degenerate mesh
on the same code path), and ``index_type=ivf`` then builds the sharded IVF
on the mesh (``parallel/sharded_ivf.py``); its sidecar says ``"kind":
"mesh"``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from photo_search_engine_tpu_torch.core.embedding_store import EmbeddingStore
from photo_search_engine_tpu_torch.core.mesh_store import MeshEmbeddingStore, MeshIVFAdapter
from photo_search_engine_tpu_torch.device import resolve_device
from photo_search_engine_tpu_torch.models.ivf import IVFIndex
from photo_search_engine_tpu_torch.ops.quantized import resolve_store_quantized
from photo_search_engine_tpu_torch.ops.topk import resolve_store_dtype
from photo_search_engine_tpu_torch.parallel.sharded import distributed

_FORMAT_VERSION = 1


class VectorIndex:
    """Flat or IVF vector index over one device or a mesh (reference
    VectorStore API)."""

    def __init__(
        self,
        dimension: Optional[int],
        index_path: str,
        metadata_path: str,
        metric: str = "cosine",
        index_type: str = "flat",
        store_dtype: str = "float32",
        ivf_nlist: int = 1024,
        ivf_nprobe: int = 64,
        ivf_target_recall: float = 0.98,
        store_block_rows: Optional[int] = None,
        quantized: Any = False,
        mesh_devices: int = 0,
        device=None,
    ) -> None:
        self.dimension = dimension
        self.index_path = index_path
        self.metadata_path = metadata_path
        self.meta_path = f"{self.index_path}.meta.json"
        self.metric = (metric or "l2").strip().lower()
        if self.metric not in {"l2", "cosine"}:
            raise ValueError("metric must be l2 or cosine")
        self.index_type = (index_type or "flat").strip().lower()
        if self.index_type == "hnsw":
            # reference configs use hnsw; the IVF index fills the approximate
            # role here, as in the JAX package
            print("[WARN] index_type=hnsw has no native analogue here; using ivf (coarse-quantized ANN) instead")
            self.index_type = "ivf"
        if self.index_type not in {"flat", "ivf"}:
            raise ValueError("index_type must be flat, ivf, or hnsw")
        # 0: one device; N >= 1: row-shard the corpus over a mesh of N shards
        self.mesh_devices = max(0, int(mesh_devices or 0))
        self.device = resolve_device() if device is None else device
        self.store_dtype = resolve_store_dtype(store_dtype, self.device)
        self.store_block_rows = store_block_rows or None
        self.quantized = resolve_store_quantized(quantized)
        self.ivf_nlist = max(1, int(ivf_nlist))
        # nprobe 0 = autotune: after each (re)build, the smallest power-of-two
        # nprobe reaching ivf_target_recall@10 on a sample of stored rows
        self.ivf_nprobe = max(0, int(ivf_nprobe))
        self.ivf_target_recall = float(ivf_target_recall)
        self._ivf_nprobe_auto: Optional[int] = None
        # which device path served the last search (surfaced in search_debug)
        self.last_route: Optional[Dict[str, Any]] = None
        self.metadata: List[Dict[str, Any]] = []
        self._store: Optional[EmbeddingStore] = (
            self._create_store(dimension) if dimension else None
        )
        self._path_to_index: Dict[str, int] = {}
        self._ivf = None
        self._ivf_built_at = -1
        self._ivf_trained_at = -1
        self._ivf_autotune_report: Optional[Dict[str, Any]] = None  # the last autotune, for /metrics
        self.ivf_sidecar_path = f"{self.index_path}.ivf.npz"
        self.segments_dir = f"{self.index_path}.segments"
        self._manifest_path = os.path.join(self.segments_dir, "manifest.json")
        self._durable_count = 0
        # the micro-batcher's two pipeline threads can route searches at once;
        # the lock keeps them from running two IVF builds
        self._ivf_lock = threading.Lock()

    def _create_store(self, dimension: int):
        if self.mesh_devices:
            return MeshEmbeddingStore(
                dimension,
                metric=self.metric,
                store_dtype=self.store_dtype,
                mesh_devices=self.mesh_devices,
                quantized=self.quantized,
                device=self.device,
            )
        return EmbeddingStore(
            dimension,
            device=self.device,
            metric=self.metric,
            store_dtype=self.store_dtype,
            block_rows=self.store_block_rows,
            quantized=self.quantized,
        )

    @property
    def _search_impl(self) -> str:
        return "int8" if self.quantized else "auto"

    def _rebuild_path_index(self) -> None:
        self._path_to_index = {
            item["photo_path"]: i
            for i, item in enumerate(self.metadata)
            if isinstance(item.get("photo_path"), str) and item.get("photo_path")
        }

    # ------------------------------------------------------------------
    def add_item(self, embedding: List[float], metadata: Dict[str, Any]) -> None:
        """Append one vector and its metadata in lockstep."""
        if embedding is None:
            raise ValueError("embedding must not be empty")
        self.add_batch(np.asarray(embedding, np.float32)[None, :], [metadata])

    def add_batch(self, embeddings, metadatas: List[Dict[str, Any]]) -> None:
        """Batched append: one device write for the whole batch."""
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.ndim == 1:
            embeddings = embeddings[None, :]
        if len(metadatas) != embeddings.shape[0]:
            raise ValueError("embeddings/metadata length mismatch")
        if self._store is None:
            self.dimension = embeddings.shape[1]
            self._store = self._create_store(self.dimension)
        if embeddings.shape[1] != self.dimension:
            raise ValueError(
                f"vector dimension mismatch: {embeddings.shape[1]} != {self.dimension}"
            )
        base = len(self.metadata)
        self._store.append(embeddings)
        self.metadata.extend(metadatas)
        for offset, item in enumerate(metadatas):
            path = item.get("photo_path")
            if isinstance(path, str) and path:
                self._path_to_index[path] = base + offset

    def load_device_rows(self, rows, metadatas: List[Dict[str, Any]]) -> None:
        """Serve ``rows``, a ``[N, D]`` corpus already on this index's
        device, with one metadata entry per row, from an empty index (see
        ``EmbeddingStore.load_device_rows``: rows of the store's dtype and
        alignment are adopted without a copy)."""
        if rows.shape[0] != len(metadatas):
            raise ValueError("rows/metadata length mismatch")
        if self._store is None:
            self.dimension = int(rows.shape[1])
            self._store = self._create_store(self.dimension)
        self._store.load_device_rows(rows)
        self.metadata = list(metadatas)
        self._rebuild_path_index()

    # ------------------------------------------------------------------
    def _ensure_ivf(self):
        """Build, or extend in place, the IVF layout (the first routed
        search builds it).  New rows are appended to the trained lists
        (FAISS ``IndexIVF.add``); a full rebuild runs when there is no
        index, rows went away, the layout is full, or the count has more
        than doubled since training.  Serialized: the fast path rechecks
        under the lock."""
        with self._ivf_lock:
            return self._ensure_ivf_locked()

    def _ensure_ivf_locked(self):
        count = self._store.count
        if self._ivf is not None and self._ivf_built_at == count:
            return self._ivf
        if self._ivf is not None and self._ivf_built_at < count <= 2 * self._ivf_trained_at:
            delta = self._store.snapshot_range(self._ivf_built_at, count)
            if self._ivf.append(delta, np.arange(self._ivf_built_at, count, dtype=np.int64)):
                self._ivf_built_at = count
                self._persist_ivf_if_fresh(count)
                return self._ivf
        nlist = max(1, min(self.ivf_nlist, count // 8 or 1))
        if self.mesh_devices:
            # a mesh store builds the IVF on the mesh (per-shard layouts,
            # kernel 7 on every shard, the gathered merge)
            self._ivf = MeshIVFAdapter(self._store, nlist)
        else:
            # from the store's own rows on the device: no host copy of the
            # corpus and no second copy on the device (the rows upcast are
            # the host mirror's values where the mirror was downloaded)
            self._ivf = IVFIndex.build_on_device(
                self._store.live_rows(), nlist=nlist, metric="ip" if self.metric == "cosine" else self.metric,
                quantized=self.quantized,
            )
        self._ivf_built_at = count
        self._ivf_trained_at = count
        if self.ivf_nprobe == 0:
            # autotune on a sample of stored rows, leave-self-in on both the
            # probed and the full-probe side: what it measures is the
            # cluster-pruning loss alone
            rng = np.random.default_rng(0)
            sample = self._stored_rows(rng.choice(count, size=min(128, count), replace=False))
            if self.metric == "cosine":
                sample = sample / np.maximum(np.linalg.norm(sample, axis=1, keepdims=True), 1e-30)
            nprobe, achieved = self._ivf.tune_nprobe(sample, k=10, target_recall=self.ivf_target_recall)
            self._ivf_nprobe_auto = nprobe
            heldout = self._heldout_recall(sample, nprobe, rng)
            self._ivf_autotune_report = {
                "nprobe": nprobe,
                "target_recall": self.ivf_target_recall,
                "self_recall_at_10": round(float(achieved), 4),
                "heldout_recall_at_10": round(float(heldout), 4),
                "sample_size": int(sample.shape[0]),
                "nlist": nlist,
            }
            print(
                f"[INFO] IVF nprobe autotune: nprobe={nprobe} (recall@10 {achieved:.3f} self / "
                f"{heldout:.3f} held-out vs target {self.ivf_target_recall:.2f}, nlist={nlist})"
            )
        self._persist_ivf_if_fresh(count)
        return self._ivf

    def _stored_rows(self, ids: np.ndarray) -> np.ndarray:
        """Float32 host copies of the stored rows ``ids``: read from the
        device on one device, from the host copy on a mesh."""
        if self.mesh_devices:
            return self._store.snapshot()[ids]
        rows = self._store.live_rows()
        return rows[torch.from_numpy(np.asarray(ids, np.int64)).to(rows.device)].float().cpu().numpy()

    def _heldout_recall(self, sample: np.ndarray, nprobe: int, rng) -> float:
        """Recall@10 of ``nprobe`` on perturbed sample rows against their
        full-probe result: an estimate for unseen queries (the stored row is
        no longer the query, so self-hits cannot inflate it)."""
        noise = rng.normal(size=sample.shape).astype(np.float32)
        noise /= np.maximum(np.linalg.norm(noise, axis=1, keepdims=True), 1e-30)
        perturbed = sample + 0.15 * np.linalg.norm(sample, axis=1, keepdims=True) * noise
        if self.metric == "cosine":
            perturbed /= np.maximum(np.linalg.norm(perturbed, axis=1, keepdims=True), 1e-30)
        _, probed = self._ivf.search(perturbed, 10, nprobe=nprobe)
        _, full = self._ivf.search(perturbed, 10, nprobe=self._ivf.nlist)
        hits, rows = 0.0, 0
        for got, want in zip(probed, full):
            want_set = {int(w) for w in np.asarray(want).ravel() if w >= 0}
            if want_set:
                hits += len({int(g) for g in np.asarray(got).ravel() if g >= 0} & want_set) / len(want_set)
                rows += 1
        return hits / max(rows, 1)

    def _persist_ivf_if_fresh(self, count: int) -> None:
        """The IVF builds lazily, usually after the indexer's last save:
        write its sidecar now when it matches the rows already on disk
        (base plus committed segments)."""
        try:
            if os.path.exists(self.meta_path) and self._durable_count == count:
                self._save_ivf_sidecar()
        except Exception as exc:  # noqa: BLE001 — persistence is best-effort
            print(f"[WARN] IVF sidecar write skipped ({exc})")

    @property
    def effective_nprobe(self) -> int:
        """The serving nprobe: the configured one when > 0, else the last
        autotuned one (64 until the first autotuned build)."""
        if self.ivf_nprobe > 0:
            return self.ivf_nprobe
        return self._ivf_nprobe_auto or 64

    # ------------------------------------------------------------------
    def describe(self) -> Dict[str, Any]:
        """Operational snapshot for the ``/metrics`` route."""
        return {
            "count": len(self.metadata),
            "dimension": self.dimension,
            "metric": self.metric,
            "index_type": self.index_type,
            "store_dtype": self.store_dtype,
            "quantized": self.quantized,
            "mesh_devices": self.mesh_devices,
            "ivf_nlist": self.ivf_nlist,
            "ivf_nprobe_effective": self.effective_nprobe if self.index_type == "ivf" else None,
            # self- and held-out recall of the last autotune
            "ivf_autotune": self._ivf_autotune_report,
            "device": str(self.device),
        }

    def _checked(self, search, impl: str, nprobe: Optional[int] = None):
        """Run ``search`` under the route name ``impl`` (``last_route``) and
        check the row ids it returns against the live count: an id out of
        range raises instead of serving a row that does not exist."""
        self.last_route = {"impl": impl, "nprobe": nprobe, "mesh_devices": self.mesh_devices}
        dists, idx = search()
        if idx.size and (int(idx.max()) >= self._store.count or int(idx.min()) < -1):
            raise RuntimeError(
                f"search returned out-of-range row ids (max {int(idx.max())}, "
                f"min {int(idx.min())}, count {self._store.count})"
            )
        return dists, idx

    def _route_search(self, queries: np.ndarray, k: int, mask):
        """The one routing point of every single-predicate search entry: the
        IVF index when configured (a filter folds into its scan), the flat
        store otherwise."""
        if self.index_type == "ivf":
            if self.metric == "cosine":
                norms = np.linalg.norm(queries, axis=1, keepdims=True)
                queries = np.where(norms > 0, queries / np.maximum(norms, 1e-30), queries)
            ivf = self._ensure_ivf()
            if mask is None or ivf.supports_masked_search():
                nprobe = self.effective_nprobe
                return self._checked(
                    lambda: ivf.search(queries, k, nprobe=nprobe, mask=mask),
                    "ivf" if mask is None else "ivf_masked", nprobe,
                )
        impl = ("int8" if self.quantized else "exact") + ("_masked" if mask is not None else "")
        return self._checked(
            lambda: self._store.search(queries, k, mask=mask, impl=self._search_impl), impl
        )

    def search(self, query_embedding, top_k: int) -> List[Dict[str, Any]]:
        """Single-query search → ``[{metadata, distance}]``."""
        batches = self.search_batch(np.asarray(query_embedding, np.float32), top_k)
        return batches[0] if batches else []

    def search_batch(self, query_embeddings, top_k: int, mask=None) -> List[List[Dict[str, Any]]]:
        if self._store is None or self._store.count == 0:
            return [[] for _ in range(np.atleast_2d(np.asarray(query_embeddings)).shape[0])]
        queries = np.atleast_2d(np.asarray(query_embeddings, np.float32))
        if queries.shape[1] != self.dimension:
            raise ValueError(
                f"vector dimension mismatch: {queries.shape[1]} != {self.dimension}"
            )
        dists, idx = self._route_search(queries, min(int(top_k), self._store.count), mask)
        return [
            [
                {"metadata": self.metadata[i], "distance": float(d)}
                for d, i in zip(row_d.tolist(), row_i.tolist())
                if i >= 0
            ]
            for row_d, row_i in zip(dists, idx)
        ]

    def raw_search_batch(self, query_embeddings, top_k: int, mask=None):
        """Batched search returning ``(distances, row indices)`` directly."""
        queries = np.atleast_2d(np.asarray(query_embeddings, np.float32))
        if self._store is None or self._store.count == 0:
            q = queries.shape[0]
            return np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int32)
        return self._route_search(queries, min(int(top_k), self._store.count), mask)

    def raw_grouped_search_batch(self, query_embeddings, top_k: int, mask_table, mask_ids):
        """Batched per-query filtered search (distinct predicates per query,
        one device scan), returning ``(distances, row indices)``: the
        micro-batcher's filtered path."""
        queries = np.atleast_2d(np.asarray(query_embeddings, np.float32))
        if self._store is None or self._store.count == 0:
            q = queries.shape[0]
            return np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int32)
        k = min(int(top_k), self._store.count)
        return self._checked(
            lambda: self._store.grouped_search(queries, k, mask_table, mask_ids, impl=self._search_impl),
            "int8_grouped" if self.quantized else "exact_grouped",
        )

    def search_masked(self, query_embedding, top_k: int, mask) -> List[Dict[str, Any]]:
        """Search with a per-row boolean filter fused into the device scan."""
        batches = self.search_batch(np.asarray(query_embedding, np.float32), top_k, mask=mask)
        return batches[0] if batches else []

    # ------------------------------------------------------------------
    def get_embedding_by_photo_path(self, photo_path: str) -> Optional[List[float]]:
        i = self._path_to_index.get(photo_path)
        if i is None or self._store is None:
            return None
        return self._store.reconstruct(i).tolist()

    def has_photo_path(self, photo_path: str) -> bool:
        return photo_path in self._path_to_index

    def get_total_items(self) -> int:
        return 0 if self._store is None else self._store.count

    # ------------------------------------------------------------------
    def _meta_payload(self) -> Dict[str, Any]:
        return {
            "format_version": _FORMAT_VERSION,
            "index_type": self.index_type,
            "metric": self.metric,
            "dimension": self.dimension,
            "store_dtype": self.store_dtype,
            "count": self.get_total_items(),
            "ivf_nlist": self.ivf_nlist,
            "ivf_nprobe": self.ivf_nprobe,
            "quantized": self.quantized,
        }

    @staticmethod
    def _write_durable(path: str, writer) -> None:
        """tmp + fsync + atomic rename: the old file or the whole new one."""
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @staticmethod
    def _json_bytes(payload, **kwargs) -> bytes:
        return json.dumps(payload, ensure_ascii=False, **kwargs).encode("utf-8")

    def save(self) -> None:
        """Full (compacting) save: metadata → rows → meta sidecar (the
        commit point) → segment cleanup."""
        if self._store is None:
            raise ValueError("index not initialized")
        for directory in {os.path.dirname(self.index_path), os.path.dirname(self.metadata_path)}:
            if directory:
                os.makedirs(directory, exist_ok=True)
        self._write_durable(
            self.metadata_path, lambda f: f.write(self._json_bytes(self.metadata, indent=2))
        )
        self._write_durable(self.index_path, lambda f: np.save(f, self._store.snapshot()))
        self._write_durable(
            self.meta_path, lambda f: f.write(self._json_bytes(self._meta_payload(), indent=2))
        )
        self._durable_count = self.get_total_items()
        self._remove_segments()
        self._save_ivf_sidecar()

    def _remove_segments(self) -> None:
        if os.path.isdir(self.segments_dir):
            shutil.rmtree(self.segments_dir, ignore_errors=True)

    def _read_manifest(self) -> Optional[Dict[str, Any]]:
        if not os.path.exists(self._manifest_path):
            return None
        try:
            with open(self._manifest_path, "r", encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError):  # a torn manifest commits no segment
            return None
        if not isinstance(manifest, dict) or not isinstance(manifest.get("segments"), list):
            return None
        return manifest

    def _rows_on_disk(self, manifest) -> Optional[int]:
        """Rows the base snapshot plus committed segments hold, or None
        when the disk does not hold a consistent base."""
        if not os.path.exists(self.meta_path):
            return None
        try:
            with open(self.meta_path, "r", encoding="utf-8") as f:
                base_count = int(json.load(f).get("count", -1))
        except (OSError, ValueError, TypeError, AttributeError):
            return None
        if manifest is None:
            return base_count
        if int(manifest.get("base_count", -1)) != base_count:
            return None  # stale segments over a rewritten base
        segments = manifest["segments"]
        return int(segments[-1]["count_after"]) if segments else base_count

    def save_incremental(self) -> None:
        """Per-batch durability at O(batch) cost: the rows added since the
        last save go to ``seg_NNNNN.npy`` + metadata JSONL, committed by an
        atomic manifest replace.  Falls back to a full :meth:`save` when
        the disk does not continue the in-memory state."""
        if self._store is None:
            raise ValueError("index not initialized")
        count = self.get_total_items()
        manifest = self._read_manifest()
        on_disk = self._rows_on_disk(manifest)
        if on_disk is None or on_disk != self._durable_count or on_disk > count:
            self.save()
            return
        if count == self._durable_count:
            return
        os.makedirs(self.segments_dir, exist_ok=True)
        if manifest is None:
            manifest = {"format_version": _FORMAT_VERSION, "base_count": on_disk, "segments": []}
        seg_name = f"seg_{len(manifest['segments']):05d}"
        rows = self._store.snapshot_range(self._durable_count, count)
        metas = self.metadata[self._durable_count : count]
        self._write_durable(
            os.path.join(self.segments_dir, f"{seg_name}.npy"), lambda f: np.save(f, rows)
        )
        self._write_durable(
            os.path.join(self.segments_dir, f"{seg_name}.jsonl"),
            lambda f: f.write(b"".join(self._json_bytes(m) + b"\n" for m in metas)),
        )
        manifest["segments"].append(
            {"name": seg_name, "rows": int(rows.shape[0]), "count_after": count}
        )
        # the commit record: segment files exist for load() only after this
        self._write_durable(self._manifest_path, lambda f: f.write(self._json_bytes(manifest)))
        self._durable_count = count

    def _apply_segments(self, base_rows: int) -> None:
        """Replay committed segments over the freshly loaded base."""
        manifest = self._read_manifest()
        if manifest is None:
            return
        if int(manifest.get("base_count", -1)) != base_rows:
            print("[WARN] segment manifest does not match the base snapshot; ignoring segments")
            return
        expected = base_rows
        for seg in manifest["segments"]:
            with open(os.path.join(self.segments_dir, f"{seg['name']}.npy"), "rb") as f:
                rows = np.load(f)
            with open(os.path.join(self.segments_dir, f"{seg['name']}.jsonl"), "r", encoding="utf-8") as f:
                metas = [json.loads(line) for line in f if line.strip()]
            if rows.shape[0] != int(seg["rows"]) or len(metas) != rows.shape[0]:
                raise ValueError(f"segment {seg['name']} corrupt; rebuild the index")
            if rows.size:
                self._store.append(rows.astype(np.float32))
            self.metadata.extend(metas)
            expected += rows.shape[0]
            if expected != int(seg["count_after"]):
                raise ValueError(f"segment {seg['name']} count mismatch; rebuild the index")

    # -- IVF sidecar --------------------------------------------------------
    def _save_ivf_sidecar(self) -> None:
        """Write the trained IVF (centroids, layout perm, autotuned nprobe)
        next to the ``.npy`` so that ``load`` restores it without
        retraining; written atomically, and removed when there is no current
        trained index (a stale sidecar must never outlive the rows it
        indexed).  The format is the JAX package's.  In a multi-process job
        every rank holds the same index and rank 0 alone writes."""
        context = distributed()
        if context is not None and context.rank != 0:
            return
        current = self.index_type == "ivf" and self._ivf is not None and self._ivf_built_at == self.get_total_items()
        if not current:
            if os.path.exists(self.ivf_sidecar_path):
                os.remove(self.ivf_sidecar_path)
            return
        state = dict(self._ivf.state())
        meta = {
            "format_version": _FORMAT_VERSION,
            "kind": "mesh" if self.mesh_devices else "single",
            "metric": str(state.pop("metric", self.metric)),
            "mesh_devices": self.mesh_devices,
            "built_at": self._ivf_built_at,
            "trained_at": self._ivf_trained_at,
            "nprobe_auto": self._ivf_nprobe_auto,
            "autotune_report": self._ivf_autotune_report,
        }
        tmp = f"{self.ivf_sidecar_path}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **state)
        os.replace(tmp, self.ivf_sidecar_path)

    def _load_ivf_sidecar(self) -> None:
        """Restore the trained IVF when the sidecar matches the loaded rows;
        any mismatch (count, kind, corrupt file) leaves the lazy rebuild:
        the sidecar saves time and is never needed for a right answer."""
        if self.index_type != "ivf" or not os.path.exists(self.ivf_sidecar_path):
            return
        try:
            with np.load(self.ivf_sidecar_path, allow_pickle=False) as payload:
                meta = json.loads(str(payload["__meta__"]))
                state = {key: payload[key] for key in payload.files if key != "__meta__"}
            if (
                meta.get("kind") != ("mesh" if self.mesh_devices else "single")
                or int(meta.get("mesh_devices", 0)) != self.mesh_devices
                or int(meta.get("built_at", -1)) != self.get_total_items()
            ):
                raise ValueError("IVF sidecar does not match the loaded index")
            state["metric"] = meta.get("metric", self.metric)
            if self.mesh_devices:
                self._ivf = MeshIVFAdapter.from_state(self._store, state)
            else:
                self._ivf = IVFIndex.from_state(
                    self._store.snapshot(), state, store_dtype=self.store_dtype,
                    quantized=self.quantized, device=self.device,
                )
            self._ivf_built_at = int(meta["built_at"])
            self._ivf_trained_at = int(meta.get("trained_at", meta["built_at"]))
            nprobe_auto = meta.get("nprobe_auto")
            self._ivf_nprobe_auto = int(nprobe_auto) if nprobe_auto is not None else None
            self._ivf_autotune_report = meta.get("autotune_report")
        except Exception as exc:  # noqa: BLE001 — deliberate fail-soft
            print(f"[WARN] IVF sidecar ignored ({exc}); index will rebuild")
            self._reset_ivf()

    def _reset_ivf(self) -> None:
        self._ivf = None
        self._ivf_built_at = -1
        self._ivf_trained_at = -1

    def load(self) -> bool:
        """Load and validate; False when absent, ValueError on any
        config or count mismatch."""
        if not os.path.exists(self.index_path) or not os.path.exists(self.metadata_path):
            return False
        if not os.path.exists(self.meta_path):
            raise ValueError("index meta sidecar missing; rebuild the index")
        with open(self.meta_path, "r", encoding="utf-8") as f:
            payload = json.load(f)
        if not isinstance(payload, dict):
            raise ValueError("index meta sidecar corrupt; rebuild the index")
        if str(payload.get("index_type") or "").strip().lower() != self.index_type:
            raise ValueError("index type differs from config; rebuild the index")
        if str(payload.get("metric") or "").strip().lower() != self.metric:
            raise ValueError("index metric differs from config; rebuild the index")
        with open(self.index_path, "rb") as f:
            array = np.load(f)
        with open(self.metadata_path, "r", encoding="utf-8") as f:
            self.metadata = json.load(f)
        if array.shape[0] != len(self.metadata):
            raise ValueError("index/metadata count mismatch; rebuild the index")
        expected_count = payload.get("count")
        if expected_count is not None and int(expected_count) != array.shape[0]:
            raise ValueError("index row count differs from sidecar; rebuild the index")
        self._reset_ivf()
        self.dimension = int(array.shape[1]) if array.size else payload.get("dimension")
        self._store = self._create_store(self.dimension)
        if array.size:
            self._store.append(array.astype(np.float32))
        self._apply_segments(array.shape[0])
        self._durable_count = self.get_total_items()
        self._rebuild_path_index()
        self._load_ivf_sidecar()
        return True

    def clear(self) -> None:
        self._store = self._create_store(self.dimension) if self.dimension else None
        self.metadata = []
        self._path_to_index = {}
        self._reset_ivf()
        self._durable_count = 0

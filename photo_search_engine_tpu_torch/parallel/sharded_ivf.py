"""Sharded IVF: cluster-pruned search over a row-sharded corpus.

Counterpart of ``photo_search_engine_tpu/parallel/sharded_ivf.py``:

* global centroids trained data-parallel over the mesh
  (``sharded_kmeans_step``: per-shard sums, ``psum``);
* a cluster-major layout per shard, of that shard's own rows
  (``models/ivf.balanced_layout``, a common slot count ``L`` per
  cluster), gathered on the shard's device from the store's rows;
* stage 1 (the ``nprobe`` nearest centroids of each query, float32,
  sorted ascending) is the same on every shard; stage 2 is kernel 7
  (``ops/ivf_scan.ivf_block_topk``) on every shard, each launch with that
  shard's layout and the probes of stage 1; the ``[Q, k]`` partials merge
  as the exact sharded path merges them.

The JAX program hands its kernel a probe matrix and the union of probed
clusters; kernel 7 takes ``probe_ids`` ``[Q, nprobe]`` directly.  Metrics:
ip/cosine and l2, which merges in the ``2⟨q, c⟩ − ‖c‖²`` space with
``‖q‖²`` restored after the merge.  The mesh IVF scans the store dtype
(JAX's ``int8=False``).  Filters fold into each shard's row validity and
widen ``nprobe`` by about 1/selectivity, as in ``models/ivf.py``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from photo_search_engine_tpu_torch.core.content_lru import ContentLRU
from photo_search_engine_tpu_torch.models.ivf import IVFIndex, _lay_out, _round_up, assign_clusters, balanced_layout
from photo_search_engine_tpu_torch.ops import ivf_scan
from photo_search_engine_tpu_torch.ops.topk import merge_partials, row_sq_norms, total_order_topk
from photo_search_engine_tpu_torch.parallel.sharded import ShardedEmbeddingStore, _scan_shards, sharded_kmeans_step

_LANE = 128


class ShardedIVFIndex:
    """Cluster-pruned search over a :class:`ShardedEmbeddingStore`.
    ``search`` returns ``(distances, stable ids)`` in the store's id
    convention (``shard · 2^40 + local``)."""


    def __init__(
        self,
        mesh,
        centroids: np.ndarray,           # [nlist, dp] f32, dims zero-padded to a multiple of 128
        layouts: List[torch.Tensor],     # this process's shards, [nlist · L, D] store dtype
        perms,                           # [n_shards, nlist · L] local row or -1
        nlist: int,
        lrows: int,
        dim: int,
        built_counts,                    # per-shard live rows at build time
        metric: str = "cosine",
    ) -> None:
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        self.nlist, self.lrows, self.dim = int(nlist), int(lrows), int(dim)
        self.dp = centroids.shape[1]
        self.centroids = np.asarray(centroids, np.float32)
        self.metric = metric
        self._cents_dev = torch.from_numpy(self.centroids[:, : self.dim].copy()).to(mesh.device)
        self._layouts = layouts
        # one [n_shards, span] matrix: search indexes it, append writes it in place
        self.perms = np.stack(perms) if isinstance(perms, list) else np.asarray(perms, np.int64)
        self._row_valid = [torch.from_numpy((self.perms[s] >= 0).astype(np.int8)).to(dev)
                           for s, dev in zip(mesh.local_shards, mesh.devices)]
        self.built_counts = np.asarray(built_counts, np.int64)
        self._cnorms: Optional[List[torch.Tensor]] = None  # l2: squared layout-row norms, per local shard
        self._masks = ContentLRU(16)  # staged shard masks by content

    @property
    def span(self) -> int:
        return self.nlist * self.lrows

    # -- build ------------------------------------------------------------
    @staticmethod
    def _layouts_from(store: ShardedEmbeddingStore, perms: np.ndarray) -> List[torch.Tensor]:
        """Each local shard's layout, gathered on its device from the
        store's rows (the store dtype; zero where ``perm < 0``)."""
        rows, _ = store._sync()
        return [_lay_out(rows[j], perms[s], False) for j, s in enumerate(store.mesh.local_shards)]

    @classmethod
    def build(
        cls,
        store: ShardedEmbeddingStore,
        nlist: int,
        *,
        train_iters: int = 8,
        slack: float = 1.5,
        seed: int = 0,
    ) -> "ShardedIVFIndex":
        if store.metric not in ("cosine", "ip", "l2"):
            raise ValueError("sharded IVF supports ip/cosine/l2")
        mesh = store.mesh
        dim = store.dimension
        counts = store.counts.astype(np.int64)
        total = int(counts.sum())
        if total == 0:
            raise ValueError("cannot build sharded IVF on an empty store")
        nlist = max(1, min(int(nlist), total))
        rng = np.random.default_rng(seed)
        # global centroids: data-parallel Lloyd on the store's own device rows
        rows_dev, _ = store._sync()
        pool = np.concatenate([r for r in store._host_shards if r.shape[0]])
        cents = torch.from_numpy(pool[rng.choice(total, size=nlist, replace=False)].astype(np.float32))
        for _ in range(train_iters):
            cents, _ = sharded_kmeans_step(rows_dev, cents, mesh, counts=counts)
        cents = cents.cpu().numpy()
        # per-shard cluster-major placement (every rank places every shard:
        # the perms are replicated host state), a common slot count L
        placed = [
            balanced_layout(assign_clusters(rows, cents, device=mesh.device), nlist, slack=slack)
            if rows.shape[0] else (None, np.full(nlist, -1, np.int64), 1)
            for rows in store._host_shards
        ]
        lrows = _round_up(max(p[2] for p in placed), _LANE)
        perms = np.full((store.n_shards, nlist * lrows), -1, np.int64)
        for s, (_, perm_s, cap_s) in enumerate(placed):
            if perm_s.shape[0] == nlist * cap_s:  # re-space [nlist, cap_s] → [nlist, L]
                perms[s].reshape(nlist, lrows)[:, :cap_s] = perm_s.reshape(nlist, cap_s)
        dp = _round_up(dim, _LANE)
        cents_p = np.zeros((nlist, dp), np.float32)
        cents_p[:, :dim] = cents
        return cls(mesh, cents_p, cls._layouts_from(store, perms), perms, nlist, lrows, dim, counts,
                   metric=store.metric)

    # -- persistence -------------------------------------------------------
    def state(self) -> dict:
        """Host state (centroids, per-shard perms, shapes), the format of
        the JAX index's ``state``; the layouts are gathers of the store's
        rows through the perms and are not included."""
        return {
            "centroids": self.centroids,
            "perms": self.perms,
            "nlist": np.int64(self.nlist),
            "lrows": np.int64(self.lrows),
            "dim": np.int64(self.dim),
            "built_counts": self.built_counts,
            "metric": self.metric,
        }

    @classmethod
    def from_state(cls, store: ShardedEmbeddingStore, state: dict) -> "ShardedIVFIndex":
        """Restore from :meth:`state` and a store re-appended in the same
        insertion order (the placement is deterministic, so each perm's
        local rows stay valid; checked against the per-shard counts)."""
        nlist, lrows, dim = int(state["nlist"]), int(state["lrows"]), int(state["dim"])
        perms = np.asarray(state["perms"], np.int64)
        if perms.shape != (store.n_shards, nlist * lrows):
            raise ValueError("sharded IVF state shape mismatch with mesh")
        if dim != store.dimension:
            raise ValueError("sharded IVF state dimension mismatch")
        counts = store.counts.astype(np.int64)
        for s in range(store.n_shards):
            live = perms[s] >= 0
            if live.any() and int(perms[s][live].max()) >= int(counts[s]):
                raise ValueError(f"sharded IVF state references rows beyond shard {s} ({int(counts[s])} rows)")
        return cls(store.mesh, np.asarray(state["centroids"], np.float32), cls._layouts_from(store, perms), perms,
                   nlist, lrows, dim, np.asarray(state["built_counts"], np.int64),
                   metric=str(state.get("metric", store.metric)))

    # -- incremental append ----------------------------------------------
    def append(self, rows, stable_ids) -> bool:
        """FAISS ``IndexIVF.add`` on the mesh: each new row goes to a free
        slot of its nearest trained cluster (of three) in its own shard
        (the stable id names the shard).  False when one is full there
        (the caller rebuilds; partial perm writes are then replaced)."""
        rows = np.atleast_2d(np.asarray(rows, np.float32))
        stable_ids = np.asarray(stable_ids, np.int64)
        if rows.shape[0] == 0:
            return True
        if self.metric == "cosine":
            # the store normalizes its copy on append; the layout must hold the same row
            norms = np.linalg.norm(rows, axis=1, keepdims=True)
            rows = np.where(norms > 0, rows / np.maximum(norms, 1e-30), rows)
        top = assign_clusters(rows, self.centroids[:, : self.dim], device=self.mesh.device)
        shards = stable_ids // ShardedEmbeddingStore._ID_STRIDE
        slots = np.empty(rows.shape[0], np.int64)
        for i in range(rows.shape[0]):
            perm = self.perms[int(shards[i])]
            for c in top[i]:
                base = int(c) * self.lrows
                free = np.flatnonzero(perm[base : base + self.lrows] < 0)
                if free.size:
                    slots[i] = base + int(free[0])
                    perm[slots[i]] = int(stable_ids[i] % ShardedEmbeddingStore._ID_STRIDE)
                    break
            else:
                return False
        for j, s in enumerate(self.mesh.local_shards):
            sel = shards == s
            if sel.any():
                slot_dev = torch.from_numpy(slots[sel]).to(self.mesh.devices[j])
                layout = self._layouts[j]
                layout.index_copy_(0, slot_dev, torch.from_numpy(rows[sel]).to(layout.device, layout.dtype))
                self._row_valid[j][slot_dev] = 1
        self.built_counts = self.built_counts + np.bincount(shards, minlength=self.n_shards)
        self._cnorms = None  # the norm cache covers the old rows only
        return True

    # -- search -----------------------------------------------------------
    def _corpus_norms(self) -> List[torch.Tensor]:
        if self._cnorms is None:
            self._cnorms = [row_sq_norms(layout) for layout in self._layouts]
        return self._cnorms

    def _stage_mask(self, slot_mask) -> List[torch.Tensor]:
        """``[n_shards · span]`` slot bits → this process's int8 shard
        masks on their devices, LRU-cached by content digest."""
        bits = np.ascontiguousarray(slot_mask, np.int8)

        def stage() -> List[torch.Tensor]:
            per_shard = bits.reshape(self.n_shards, self.span)
            return [torch.from_numpy(per_shard[s].copy()).to(d)
                    for s, d in zip(self.mesh.local_shards, self.mesh.devices)]

        return self._masks.get(ContentLRU.key(bits, bits.shape[0]), stage)

    def probe(self, queries: torch.Tensor, nprobe: int) -> torch.Tensor:
        """Stage 1: each query's ``nprobe`` nearest centroids by ``2s −
        ‖c‖²`` on float32 queries (as the JAX mesh program ranks them), ties
        to the smallest id, sorted ascending: int32 ``[Q, nprobe]``."""
        cents = self._cents_dev
        scores = 2.0 * (queries.float() @ cents.T) - (cents * cents).sum(dim=1)[None, :]
        _, ids = total_order_topk(scores, nprobe)
        return torch.sort(ids, dim=1).values.to(torch.int32).contiguous()

    def search(self, queries, k: int, nprobe: int, *, slot_mask=None, mask_ratio: Optional[float] = None):
        """Probed k-NN: host ``(scores desc, or ascending squared distances
        for l2; stable ids)``, -1 in empty slots.  ``slot_mask`` (bits in
        the sharded slot layout, see ``MeshIVFAdapter``) folds into each
        shard's row validity, and ``nprobe`` widens by about 1/selectivity."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        q, dim = queries.shape
        if dim != self.dim:
            raise ValueError(f"dimension mismatch: {dim} != {self.dim}")
        k = max(1, min(int(k), int(self.built_counts.sum())))
        nprobe = max(1, min(int(nprobe), self.nlist))
        valid = self._row_valid
        if slot_mask is not None:
            if mask_ratio is None:
                mask_ratio = float(np.asarray(slot_mask).sum()) / max(int(self.built_counts.sum()), 1)
            nprobe = IVFIndex._inflate_nprobe(nprobe, mask_ratio, self.nlist)
            valid = [v * m for v, m in zip(valid, self._stage_mask(slot_mask))]
        vals, slots = self._scan(torch.from_numpy(queries).to(self.mesh.device), k, nprobe, valid)
        vals, slots = vals.cpu().numpy(), slots.cpu().numpy()
        if self.metric == "l2":
            # merged in 2<q,c> - |c|² space; restore ascending squared distances
            qn = np.sum(np.square(queries), axis=1, keepdims=True)
            vals = np.where(np.isneginf(vals), np.inf, qn - vals)
        ids = np.full(slots.shape, -1, np.int64)
        live = slots >= 0
        shard = slots[live] // self.span
        ids[live] = shard * ShardedEmbeddingStore._ID_STRIDE + self.perms[shard, slots[live] % self.span]
        return vals, ids

    def _scan(self, queries: torch.Tensor, k: int, nprobe: int, valid: List[torch.Tensor]):
        """Stage 1 once, kernel 7 on every local shard, the merge:
        kernel-space ``(vals [Q, k], global slot ids [Q, k])`` with -1 in
        empty slots."""
        probes = self.probe(queries, nprobe)
        k_local = min(k, self.span)  # a shard contributes at most its slots
        metric = "l2" if self.metric == "l2" else "ip"
        cnorms = self._corpus_norms() if metric == "l2" else [None] * len(self._layouts)

        def scan(j, s):
            layout = self._layouts[j]
            part_v, part_i = ivf_scan.ivf_block_topk(
                layout, queries.to(layout.device, layout.dtype).contiguous(), probes.to(layout.device),
                valid[j], k_local, lrows=self.lrows, metric=metric, cnorms=cnorms[j],
            )
            v, i = merge_partials(part_v, part_i, k_local)
            if v.shape[1] < k_local:  # fewer probed slots than k
                pad = k_local - v.shape[1]
                v = torch.nn.functional.pad(v, (0, pad), value=float("-inf"))
                i = torch.nn.functional.pad(i, (0, pad), value=-1)
            return v, torch.where(torch.isneginf(v), torch.full_like(i, -1), i)

        # kernel space is higher-is-better for both metrics: merged as ip
        return _scan_shards(self.mesh, k, self.span, "ip", scan)

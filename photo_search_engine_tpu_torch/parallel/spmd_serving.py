"""SPMD request fan-in: multi-process serving behind one HTTP listener.

Counterpart of ``photo_search_engine_tpu/parallel/spmd_serving.py``.  In a
``torch.distributed`` job every rank holds the same host state (metadata,
config, the float32 mirror of every shard) and its own device shards, and
every device op that collects across ranks (the gathered merge, the
k-means ``psum``) must be entered by all ranks in the same order.

* :class:`SPMDVectorIndex` — a ``VectorIndex`` whose device-entering entry
  points (``_route_search``, ``raw_grouped_search_batch``, ``add_batch``)
  and host-state ops (``load``, ``clear``) broadcast an op header and its
  payload from rank 0 before they run.
* :meth:`SPMDVectorIndex.follow` — the loop of every other rank: receive
  an op, replay the same call on the local replica, until rank 0
  broadcasts shutdown.

Rank 0 therefore runs the whole single-process serving stack unchanged
(searcher, micro-batcher, WSGI app, HTTP listener).  The broadcasts are
host data and always go over the job's default group (gloo), whatever
backend the device collectives use.

Protocol: header ``int64[8]`` (op, then op-specific sizes), then the
payload arrays, whose shapes and dtypes the header determines.  Ops: 0
shutdown · 1 search(queries [Q, D] f32, k, mask? [N] u8) · 2 grouped(
queries [Q, D], k, table [M, N] u8, ids [Q] i64) · 3 add_batch(embeddings
[B, D] f32, metadata JSON bytes) · 4 reload (``load()`` from the shared
index files) · 5 clear.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
from photo_search_engine_tpu_torch.parallel.sharded import distributed

_OP_SHUTDOWN = 0
_OP_SEARCH = 1
_OP_GROUPED = 2
_OP_ADD = 3
_OP_RELOAD = 4
_OP_CLEAR = 5


def _broadcast(value: np.ndarray) -> np.ndarray:
    """Rank 0 → every rank broadcast of one host array over the default
    group (every rank passes the same shape and dtype; other ranks' values
    are ignored)."""
    tensor = torch.from_numpy(np.ascontiguousarray(value).copy())
    dist.broadcast(tensor, src=0)
    return tensor.numpy()


class SPMDVectorIndex(VectorIndex):
    """``VectorIndex`` with the rank-0 fan-in over a ``torch.distributed``
    job (rank 0 calls the normal API; the other ranks sit in
    :meth:`follow`).  Without a job every broadcast is skipped and this is
    a plain ``VectorIndex``.  Flat exact, int8, masked, grouped and IVF
    routes: the lazy IVF build is the same on every rank (seeded k-means
    over the replicated mirror), and rank 0 alone writes its sidecar."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        context = distributed()
        self._spmd_rank = context.rank if context else 0
        self._spmd_world = context.world if context else 1
        # rank 0 serves from many threads (HTTP, the micro-batcher); the
        # broadcast order must be the device-entry order, so each op holds
        # this lock across its broadcast and its run
        self._spmd_lock = threading.RLock()
        # after shutdown the followers have left follow(): a late op must
        # neither fan out nor run (its collectives would wait for ranks that
        # are gone), so it raises
        self._spmd_shutdown = False
        self.spmd_ops_replayed = 0

    # -- rank 0: fan-out --------------------------------------------------
    def _check_live(self) -> None:
        if self._spmd_shutdown and self._spmd_world > 1:
            raise RuntimeError("SPMD serving is shut down: the followers have exited, "
                               "a mesh-wide device op can no longer run")

    def _fans_out(self) -> bool:
        return self._spmd_world > 1 and self._spmd_rank == 0 and not self._spmd_shutdown

    def _announce(self, header: List[int]) -> None:
        if not self._fans_out():
            return
        if os.environ.get("SPMD_DEBUG"):
            print(f"[spmd-debug] announce {header}", file=sys.stderr, flush=True)
        _broadcast(np.asarray((header + [0] * 8)[:8], np.int64))

    def _send(self, arr: np.ndarray) -> None:
        if self._fans_out():
            _broadcast(arr)

    def _route_search(self, queries: np.ndarray, k: int, mask):
        with self._spmd_lock:
            self._check_live()
            if self._fans_out():
                q = np.atleast_2d(np.asarray(queries, np.float32))
                mask_len = 0 if mask is None else int(np.asarray(mask).shape[0])
                self._announce([_OP_SEARCH, q.shape[0], q.shape[1], int(k), mask_len])
                self._send(q)
                if mask is not None:
                    self._send(np.asarray(mask, np.uint8))
            return super()._route_search(queries, k, mask)

    def raw_grouped_search_batch(self, query_embeddings, top_k: int, mask_table, mask_ids):
        with self._spmd_lock:
            self._check_live()
            if self._fans_out():
                q = np.atleast_2d(np.asarray(query_embeddings, np.float32))
                table = np.asarray(mask_table, np.uint8)
                self._announce([_OP_GROUPED, q.shape[0], q.shape[1], int(top_k), table.shape[0], table.shape[1]])
                self._send(q)
                self._send(table)
                self._send(np.asarray(mask_ids, np.int64))
            return super().raw_grouped_search_batch(query_embeddings, top_k, mask_table, mask_ids)

    def add_batch(self, embeddings, metadatas: List[Dict[str, Any]]) -> None:
        # add_item goes through add_batch in VectorIndex, so it fans out too
        with self._spmd_lock:
            self._check_live()
            if self._fans_out():
                emb = np.atleast_2d(np.asarray(embeddings, np.float32))
                blob = json.dumps(metadatas, ensure_ascii=False).encode("utf-8")
                self._announce([_OP_ADD, emb.shape[0], emb.shape[1], len(blob)])
                self._send(emb)
                self._send(np.frombuffer(blob, np.uint8))
            super().add_batch(embeddings, metadatas)

    def load(self) -> bool:
        with self._spmd_lock:
            self._check_live()
            self._announce([_OP_RELOAD])
            return super().load()

    def clear(self) -> None:
        with self._spmd_lock:
            self._check_live()
            self._announce([_OP_CLEAR])
            super().clear()

    def shutdown_followers(self) -> None:
        """Release every follower from :meth:`follow` (rank 0; idempotent).
        Afterwards device ops of a multi-process job raise."""
        with self._spmd_lock:
            if self._spmd_shutdown:
                return
            self._announce([_OP_SHUTDOWN])
            self._spmd_shutdown = True

    # -- other ranks: replay ------------------------------------------------
    def follow(self) -> int:
        """Replay rank 0's ops until shutdown; returns how many were replayed."""
        if self._spmd_rank == 0:
            raise RuntimeError("follow() is for the ranks other than 0")
        while True:
            header = _broadcast(np.zeros(8, np.int64))
            op = int(header[0])
            if op == _OP_SHUTDOWN:
                return self.spmd_ops_replayed
            if op == _OP_SEARCH:
                q_n, dim, k, mask_len = (int(x) for x in header[1:5])
                queries = _broadcast(np.zeros((q_n, dim), np.float32))
                mask = _broadcast(np.zeros(mask_len, np.uint8)).astype(bool) if mask_len else None
                super()._route_search(queries, k, mask)
            elif op == _OP_GROUPED:
                q_n, dim, k, n_masks, n_rows = (int(x) for x in header[1:6])
                queries = _broadcast(np.zeros((q_n, dim), np.float32))
                table = _broadcast(np.zeros((n_masks, n_rows), np.uint8))
                ids = _broadcast(np.zeros(q_n, np.int64))
                super().raw_grouped_search_batch(queries, k, table.astype(bool), ids)
            elif op == _OP_ADD:
                b_n, dim, blob_len = (int(x) for x in header[1:4])
                emb = _broadcast(np.zeros((b_n, dim), np.float32))
                blob = _broadcast(np.zeros(blob_len, np.uint8))
                super().add_batch(emb, json.loads(blob.tobytes().decode("utf-8")))
            elif op == _OP_RELOAD:
                super().load()
            elif op == _OP_CLEAR:
                super().clear()
            else:
                raise RuntimeError(f"unknown SPMD op {op}")
            self.spmd_ops_replayed += 1

"""Sharded retrieval over a mesh of devices.

Counterpart of ``photo_search_engine_tpu/parallel/sharded.py``.  JAX's
``Mesh`` + ``shard_map`` + ``all_gather`` / ``psum`` become a small explicit
structure:

* :class:`Mesh` — this process's shard devices in shard order (several
  shards may share one device) and, in a ``torch.distributed`` job, the
  process group the mesh spans.  Rank ``r`` holds shards ``[r·n_local,
  (r+1)·n_local)``.
* The corpus is sharded on the row axis: every shard holds
  ``shard_rows`` rows (padding rows masked by per-shard live counts).
  Each shard's partial top-k runs its own kernel launch on its own device
  (kernel 1, 2, 5 or 6 through ``ops/``); the ``[n_local, Q, k]`` partials
  go to the mesh's first device once per call, are ``all_gather``-ed over
  the process group when there is one, and one top-k in ``lax.top_k``'s
  order merges them
  over the shard-major flattening (JAX's ``lax.top_k`` order: ties to the
  lowest shard, then the lowest rank in the shard's partial).
* ``psum`` (the k-means step) is a sum over the local shards in shard
  order, then ``all_reduce``.

Collectives follow one rule, decided once by :func:`init_distributed`: the
host data of the serving fan-in and every collective of a job whose ranks
share a card (or run on the host) go through gloo, staged through host
memory; a job whose ranks each own a card runs its device collectives on
NCCL.  NCCL refuses two ranks on one card ("Duplicate GPU detected").

Nothing here falls back to a plain scan on the card: ``impl`` "auto" and
"pallas" launch the kernels; any other ``impl`` takes the plain branch,
as JAX's ``_local_topk`` does; k > 64 takes ``exact_search_plain`` inside
``ops/`` as in the single-device store.  Orbax checkpoints are not ported:
``save`` and ``load`` read and write the ``.npy`` + ``manifest.json``
format of the JAX store, and each package loads the other's.
"""

from __future__ import annotations

import json
import os
import socket
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from photo_search_engine_tpu_torch.core.embedding_store import _DTYPES, STORE_IMPLS
from photo_search_engine_tpu_torch.device import resolve_device
from photo_search_engine_tpu_torch.ops import grouped_mask as grouped_ops
from photo_search_engine_tpu_torch.ops import quantized as quant_ops
from photo_search_engine_tpu_torch.ops import topk as topk_ops

DATA_AXIS = "data"
_CHUNK = 131072  # rows per upload / quantize / k-means step
_ORBAX = "Orbax checkpoints are not ported to the PyTorch port; save with format='npy'"


# ---------------------------------------------------------------------------
# The distributed runtime and the mesh
# ---------------------------------------------------------------------------


class DistContext(NamedTuple):
    """A joined ``torch.distributed`` job: this rank's device and the
    backend of its device collectives.  It holds no process group: host
    data goes over the default group, the partials and the k-means sums
    over ``_DEVICE_GROUP``."""

    rank: int
    world: int
    device: torch.device
    backend: str


_CONTEXT: Optional[DistContext] = None  # the process's job, like torch.distributed's default group
# The NCCL group of the device collectives when every rank has a card of its
# own, else None (the default gloo group).  Only here and in torch.distributed's
# registry: a group that outlives shutdown_distributed is freed while the
# interpreter finalizes, and its worker threads can then abort the process
# ("terminate called without an active exception").
_DEVICE_GROUP = None


def distributed() -> Optional[DistContext]:
    """The job :func:`init_distributed` joined, or None."""
    return _CONTEXT


def init_distributed(init_method: str, world_size: int, rank: int, platform: Optional[str] = None) -> DistContext:
    """Join a ``torch.distributed`` job (``init_method`` such as
    ``tcp://host:port``) and decide its collectives once:

    * the default group is gloo: the serving fan-in's headers and payloads
      are host data;
    * each rank takes card ``rank % device_count`` (or the host);
    * when every rank holds a card of its own (distinct host name and card
      index, exchanged over gloo), the device collectives run on a NCCL
      group; otherwise (the host, or ranks sharing a card) on gloo, which
      stages CUDA tensors through host memory.

    The choice is printed.  Returns the job's :class:`DistContext`."""
    global _CONTEXT, _DEVICE_GROUP
    if _CONTEXT is not None:
        raise RuntimeError("torch.distributed is already initialised in this process")
    device = resolve_device(platform)
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("gloo", init_method=init_method, world_size=world_size, rank=rank)
    cards = [None] * world_size
    dist.all_gather_object(cards, (socket.gethostname(), device.index) if device.type == "cuda" else None)
    own_card = device.type == "cuda" and len(set(cards)) == world_size
    _DEVICE_GROUP = dist.new_group(backend="nccl") if own_card else None
    backend = "nccl" if own_card else "gloo"
    why = "a card per rank" if own_card else ("ranks on the host" if device.type == "cpu" else "ranks share a card")
    print(f"[INFO] torch.distributed: rank {rank}/{world_size} via {init_method} on {device}; "
          f"device collectives on {backend} ({why})", flush=True)
    _CONTEXT = DistContext(rank, world_size, device, backend)
    return _CONTEXT


def shutdown_distributed() -> None:
    """Leave the job :func:`init_distributed` joined (no-op without one).
    With the last references gone, the groups are freed here, before the
    interpreter exits."""
    global _CONTEXT, _DEVICE_GROUP
    if _CONTEXT is not None:
        _DEVICE_GROUP = None
        dist.destroy_process_group()
        _CONTEXT = None


def _as_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """One mesh axis over this process's shard devices (``devices``, in
    shard order; repeats allowed) and, in a ``torch.distributed`` job, the
    other ranks' shards: ``n_shards = world · len(devices)``."""

    def __init__(self, devices: Sequence, axis: str = DATA_AXIS, *, context: Optional[DistContext] = None) -> None:
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(_as_device(d) for d in devices)
        self.axis = axis
        self.context = context
        self.rank = context.rank if context else 0
        self.world = context.world if context else 1
        self.n_local = len(self.devices)
        self.n_shards = self.world * self.n_local
        self.first = self.rank * self.n_local  # global id of this process's first shard
        self.device = self.devices[0]  # where the partials merge
        self.shape = {axis: self.n_shards}

    @property
    def local_shards(self) -> range:
        return range(self.first, self.first + self.n_local)

    def __repr__(self) -> str:
        return f"Mesh({self.n_shards} shards, local {[str(d) for d in self.devices]}, rank {self.rank}/{self.world})"


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS, *, devices=None, device=None) -> Mesh:
    """A mesh over ``devices`` (this process's shards), else over the first
    ``n_devices`` shards of the platform ``device`` names (default:
    ``PSE_PLATFORM``): the first visible cards, as JAX's ``make_mesh``
    takes ``jax.devices()[:n]`` (at most as many as there are); the host
    holds any number of logical shards (default 1), as XLA's forced host
    device count gives the JAX package.  In a job :func:`init_distributed`
    joined, ``n_devices`` counts the shards of every rank: each rank holds
    ``n_devices / world`` of them on its own device."""
    context = distributed()
    if devices is not None:
        return Mesh(devices, axis, context=context)
    if context is not None:
        n = n_devices or context.world
        if n % context.world:
            raise ValueError(f"{n} mesh shards do not divide over {context.world} ranks")
        return Mesh([context.device] * (n // context.world), axis, context=context)
    base = resolve_device() if device is None else _as_device(device)
    if base.type == "cuda":
        count = torch.cuda.device_count()
        return Mesh([torch.device("cuda", i) for i in range(min(n_devices or count, count))], axis)
    return Mesh([base] * (n_devices or 1), axis)


def _host_rows(mesh: Mesh, x) -> List[torch.Tensor]:
    """This process's row slices of a host ``[n_shards · R, ...]`` array."""
    x = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    if x.shape[0] % mesh.n_shards:
        raise ValueError(f"corpus rows {x.shape[0]} must divide evenly over {mesh.n_shards} shards")
    rows = x.shape[0] // mesh.n_shards
    return [x[s * rows : (s + 1) * rows] for s in mesh.local_shards]


def _stage(mesh: Mesh, x, dtype=None) -> List[torch.Tensor]:
    """Row-shard ``x`` onto the mesh: a list or tuple is taken as this
    process's shards already placed; a whole array (numpy or torch) is cut
    into ``n_shards`` equal row slices and only this process's slices are
    uploaded, each to its shard's device (every rank passes the same whole
    value; none touches another rank's rows)."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.n_local:
            raise ValueError(f"expected {mesh.n_local} local shards, got {len(x)}")
        return list(x)
    return [part.to(dev, dtype) for part, dev in zip(_host_rows(mesh, x), mesh.devices)]


def _keep_on(part: torch.Tensor, device) -> torch.Tensor:
    """A filter slice as int8 ``(x > 0)`` on ``device``: uploaded as it
    is, compared there (not on the host)."""
    return (part.contiguous().to(device) > 0).to(torch.int8)


def _stage_mask(mesh: Mesh, mask, rows: int) -> List[torch.Tensor]:
    """``[n_shards · rows]`` filter → this process's int8 ``(mask > 0)``
    slices on their devices."""
    mask = torch.as_tensor(np.asarray(mask) if not isinstance(mask, torch.Tensor) else mask)
    if mask.shape[0] != rows * mesh.n_shards:
        raise ValueError(f"mask has {mask.shape[0]} rows, the mesh {rows * mesh.n_shards}")
    return [_keep_on(mask[s * rows : (s + 1) * rows], dev) for s, dev in zip(mesh.local_shards, mesh.devices)]


def _stage_table(mesh: Mesh, table, rows: int) -> List[torch.Tensor]:
    """``[M, n_shards · rows]`` predicates → this process's int8 column
    slices on their devices."""
    table = torch.as_tensor(np.asarray(table) if not isinstance(table, torch.Tensor) else table)
    if table.ndim != 2 or table.shape[1] != rows * mesh.n_shards:
        raise ValueError(f"mask table {tuple(table.shape)} does not cover {rows * mesh.n_shards} rows")
    return [_keep_on(table[:, s * rows : (s + 1) * rows], dev) for s, dev in zip(mesh.local_shards, mesh.devices)]


def _per_device(mesh: Mesh, x: torch.Tensor) -> dict:
    """``x`` copied once to each distinct device of the mesh."""
    return {dev: x.to(dev) for dev in dict.fromkeys(mesh.devices)}


def _counts(mesh: Mesh, counts, rows: int) -> np.ndarray:
    counts = np.full(mesh.n_shards, rows, np.int64) if counts is None else np.asarray(counts, np.int64)
    if counts.shape != (mesh.n_shards,):
        raise ValueError(f"counts must hold one live count per shard ({mesh.n_shards})")
    return counts


def _rows_per_shard(mesh: Mesh, shards: List[torch.Tensor]) -> int:
    rows = {int(s.shape[0]) for s in shards}
    if len(rows) != 1:
        raise ValueError(f"every shard must hold the same rows, got {sorted(rows)}")
    return rows.pop()


def _host_staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective of this mesh takes: host memory on gloo."""
    return t.cpu() if mesh.context.backend == "gloo" else t


def gather_shards(mesh: Mesh, local: List[torch.Tensor]) -> torch.Tensor:
    """``all_gather`` over the mesh axis: every shard's ``[...]`` tensor
    (this process's, in shard order) → ``[n_shards, ...]`` on the mesh's
    first device, copied there once per call."""
    stacked = torch.stack([t.to(mesh.device) for t in local])
    if mesh.world == 1:
        return stacked
    staged = _host_staged(mesh, stacked).contiguous()
    out = [torch.empty_like(staged) for _ in range(mesh.world)]
    dist.all_gather(out, staged, group=_DEVICE_GROUP)
    return torch.cat(out).to(mesh.device)


def psum(mesh: Mesh, local: List[torch.Tensor]) -> torch.Tensor:
    """``psum`` over the mesh axis: the local shards' tensors summed in
    shard order on the mesh's first device, then ``all_reduce``-d over the
    ranks.  The order differs from XLA's, so sums differ in the last bits."""
    total = local[0].to(mesh.device).clone()
    for t in local[1:]:
        total += t.to(mesh.device)
    if mesh.world == 1:
        return total
    staged = _host_staged(mesh, total).contiguous()
    dist.all_reduce(staged, group=_DEVICE_GROUP)
    return staged.to(mesh.device)


# ---------------------------------------------------------------------------
# Per-shard scans and the merge
# ---------------------------------------------------------------------------


def _shard_block_n(shard_rows: int, dim: int = 1536) -> Optional[int]:
    """Largest int8 kernel block that divides the shard rows, capped at
    ``default_block_n_int8`` (the JAX function's choice, so the nomination
    pool is the same); None lets ``int8_search`` pick."""
    cap = quant_ops.default_block_n_int8(dim)
    for bn in (2048, 1024, 512, 256, 128):
        if bn <= cap and shard_rows % bn == 0:
            return bn
    return None


def _local_topk(corpus_shard, queries, count: int, k: int, metric: str, impl: str, mask_shard=None):
    """One shard's partial top-k (FAISS conventions, shard-local rows):
    ``impl`` "auto" and "pallas" scan with kernel 1 (``exact_search``); any
    other takes the plain scan, as JAX's ``else`` branch does."""
    if impl in ("auto", "pallas"):
        return topk_ops.exact_search(corpus_shard, queries, k, count=count, mask=mask_shard, metric=metric,
                                     impl="pallas")
    return topk_ops.exact_search_plain(corpus_shard, queries, k, count=count, mask=mask_shard, metric=metric)


def merge_shards(mesh: Mesh, vals: List[torch.Tensor], idx: List[torch.Tensor], k: int):
    """Gather the local shards' ``[Q, k_s]`` partials (higher is better,
    global ids) and merge them: one top-k in ``lax.top_k``'s order over the
    shard-major flattening ``[Q, n_shards · k_s]`` (JAX ``sharded.py:186``);
    -1 where the merged value is ``-inf``."""
    all_v, all_i = gather_shards(mesh, vals), gather_shards(mesh, idx)
    n_shards, q, kk = all_v.shape
    flat_v = all_v.permute(1, 0, 2).reshape(q, n_shards * kk)
    flat_i = all_i.permute(1, 0, 2).reshape(q, n_shards * kk)
    merged, pos = topk_ops.total_order_topk(flat_v, k)
    merged_i = torch.gather(flat_i, 1, pos)
    return merged, torch.where(torch.isneginf(merged), torch.full_like(merged_i, -1), merged_i)


def _scan_shards(mesh: Mesh, k: int, rows: int, metric: str, scan) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scan(j, shard)`` on every local shard (its FAISS-convention
    top-k of shard-local rows), then the merge.  l2 distances merge
    re-negated (``+inf`` as ``-inf``) and come back ascending; row ids
    become global (``shard · rows + local``, -1 stays)."""
    l2 = metric == "l2"
    vals, idx = [], []
    for j, s in enumerate(mesh.local_shards):
        v, i = scan(j, s)
        if l2:
            v = torch.where(torch.isposinf(v), torch.full_like(v, float("-inf")), -v)
        i = i.long()
        vals.append(v)
        idx.append(torch.where(i >= 0, i + s * rows, torch.full_like(i, -1)))
    merged, merged_i = merge_shards(mesh, vals, idx, k)
    if l2:
        merged = torch.where(torch.isneginf(merged), torch.full_like(merged, float("inf")), -merged)
    return merged, merged_i


def _queries(queries, dtype=torch.float32) -> torch.Tensor:
    q = queries if isinstance(queries, torch.Tensor) else torch.from_numpy(np.asarray(queries, np.float32))
    return torch.atleast_2d(q).to(dtype)


def sharded_exact_search(
    corpus,
    queries,
    k: int,
    mesh: Mesh,
    *,
    counts=None,
    metric: str = "ip",
    impl: str = "auto",
    mask=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN over a row-sharded corpus (this process's shards, or a
    whole host array that :func:`_stage` places); returns ``(distances,
    global row ids)`` on the mesh's first device, the same on every rank,
    in FAISS conventions.  ``mask`` (``[n_shards · shard_rows]``, > 0 keeps)
    rides inside each shard's scan."""
    topk_ops.check_impl(impl)
    shards = _stage(mesh, corpus)
    rows = _rows_per_shard(mesh, shards)
    counts = _counts(mesh, counts, rows)
    k = min(k, rows * mesh.n_shards)
    metric = "ip" if metric == "cosine" else metric
    masks = _stage_mask(mesh, mask, rows) if mask is not None else [None] * mesh.n_local
    q = _per_device(mesh, _queries(queries))
    return _scan_shards(mesh, k, rows, metric, lambda j, s: _local_topk(
        shards[j], q[mesh.devices[j]], int(counts[s]), min(k, rows), metric, impl, masks[j]))


def sharded_int8_search(
    corpus_i8,
    scales,
    corpus_ref,
    queries,
    k: int,
    mesh: Mesh,
    *,
    counts=None,
    metric: str = "ip",
    mask=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded int8 scan + exact rescore: ``ops/quantized.int8_search``
    (kernel 2 and ``rescore_pool``) on every shard, then the merge of the
    rescored partials.  Conventions of :func:`sharded_exact_search`."""
    i8 = _stage(mesh, corpus_i8, torch.int8)
    sc = _stage(mesh, scales, torch.float32)
    ref = _stage(mesh, corpus_ref)
    rows = _rows_per_shard(mesh, i8)
    counts = _counts(mesh, counts, rows)
    k = min(k, rows * mesh.n_shards)
    metric = "ip" if metric == "cosine" else metric
    block_n = _shard_block_n(rows, i8[0].shape[1])
    masks = _stage_mask(mesh, mask, rows) if mask is not None else [None] * mesh.n_local
    q = _per_device(mesh, _queries(queries))
    return _scan_shards(mesh, k, rows, metric, lambda j, s: quant_ops.int8_search(
        i8[j], sc[j], ref[j], q[mesh.devices[j]], min(k, rows), count=int(counts[s]), mask=masks[j],
        metric=metric, block_n=block_n))


def sharded_grouped_search(
    corpus,
    queries,
    mask_table,
    mask_ids,
    k: int,
    mesh: Mesh,
    *,
    counts=None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query filtered top-k (inner product) over the sharded corpus:
    each shard runs ``ops/grouped_mask.grouped_mask_search`` (kernel 5, or
    grouped kernel 3 for ``impl="pallas_fast"``) on its column slice of
    the ``[M, n_shards · shard_rows]`` predicate table, then the merge."""
    topk_ops.check_impl(impl)
    shards = _stage(mesh, corpus)
    rows = _rows_per_shard(mesh, shards)
    counts = _counts(mesh, counts, rows)
    k = min(k, rows * mesh.n_shards)
    tables = _stage_table(mesh, mask_table, rows)
    q = _per_device(mesh, _queries(queries))
    ids = _per_device(mesh, torch.as_tensor(np.asarray(mask_ids), dtype=torch.int32))
    return _scan_shards(mesh, k, rows, "ip", lambda j, s: grouped_ops.grouped_mask_search(
        shards[j], q[mesh.devices[j]], tables[j], ids[mesh.devices[j]], min(k, rows), count=int(counts[s]),
        impl=impl))


def sharded_grouped_int8_search(
    corpus_i8,
    scales,
    corpus_ref,
    queries,
    mask_table,
    mask_ids,
    k: int,
    mesh: Mesh,
    *,
    counts=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 sibling of :func:`sharded_grouped_search`: each shard runs
    ``ops/quantized.grouped_int8_search`` (kernel 6 and the exact
    rescore), then the merge.  Inner product."""
    i8 = _stage(mesh, corpus_i8, torch.int8)
    sc = _stage(mesh, scales, torch.float32)
    ref = _stage(mesh, corpus_ref)
    rows = _rows_per_shard(mesh, i8)
    counts = _counts(mesh, counts, rows)
    k = min(k, rows * mesh.n_shards)
    tables = _stage_table(mesh, mask_table, rows)
    block_n = _shard_block_n(rows, i8[0].shape[1])
    q = _per_device(mesh, _queries(queries))
    ids = _per_device(mesh, torch.as_tensor(np.asarray(mask_ids), dtype=torch.int32))
    return _scan_shards(mesh, k, rows, "ip", lambda j, s: quant_ops.grouped_int8_search(
        i8[j], sc[j], ref[j], q[mesh.devices[j]], tables[j], ids[mesh.devices[j]], min(k, rows),
        count=int(counts[s]), block_n=block_n))


def sharded_kmeans_step(corpus, centroids, mesh: Mesh, *, counts=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration, data-parallel: each shard assigns its live rows
    (nearest by ``2⟨x, c⟩ − ‖c‖²``) and sums them per centroid with a
    one-hot product (in row chunks; no atomics, so a step is
    deterministic); :func:`psum` adds the shards' sums and counts; empty
    centroids keep their position.  Returns ``(centroids [nlist, D] f32,
    counts [nlist])`` on the mesh's first device."""
    shards = _stage(mesh, corpus)
    rows = _rows_per_shard(mesh, shards)
    counts = _counts(mesh, counts, rows)
    cents = _queries(centroids)
    nlist = cents.shape[0]
    per_dev = _per_device(mesh, cents)
    sums, totals = [], []
    for j, s in enumerate(mesh.local_shards):
        c = per_dev[mesh.devices[j]]
        cn = (c * c).sum(dim=1)
        local_sums = torch.zeros_like(c)
        local_counts = torch.zeros(nlist, dtype=torch.float32, device=c.device)
        for start in range(0, int(counts[s]), _CHUNK):
            x = shards[j][start : min(int(counts[s]), start + _CHUNK)].float()
            assign = torch.argmax(2.0 * (x @ c.T) - cn[None, :], dim=1)
            onehot = torch.nn.functional.one_hot(assign, nlist).float()
            local_sums += onehot.T @ x
            local_counts += onehot.sum(dim=0)
        sums.append(local_sums)
        totals.append(local_counts)
    total_sums, total_counts = psum(mesh, sums), psum(mesh, totals)
    fresh = total_sums / torch.clamp(total_counts, min=1.0)[:, None]
    return torch.where(total_counts[:, None] > 0, fresh, cents.to(mesh.device)), total_counts


# ---------------------------------------------------------------------------
# The sharded store
# ---------------------------------------------------------------------------


def quantize_rows_host_rule(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 quantization of the JAX sharded store
    (``_quantize_host``: ``absmax / 127`` as a division, unlike
    ``quantize_rows``' product), on ``x``'s device, bit for bit."""
    xf = x.float()
    scale = xf.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(xf / torch.clamp(scale, min=1e-30)), -127, 127)
    return q.to(torch.int8), scale[:, 0]


class ShardedEmbeddingStore:
    """Row-sharded corpus over a mesh, with the search entry points.

    Every shard has the same capacity (padding rows masked by per-shard
    counts), so appends never re-lay existing shards: the balanced fill
    puts new rows on the shards with the fewest live rows.  The float32
    host mirror of every shard is kept on every rank (checkpoints, IVF
    builds, reconstruct); each rank's device holds its own shards."""

    # Stable id encoding: shard * _ID_STRIDE + local row.  Independent of
    # the (growing) device capacity, so ids stored by callers stay valid.
    _ID_STRIDE = 1 << 40

    def __init__(
        self,
        dimension: int,
        mesh: Optional[Mesh] = None,
        *,
        metric: str = "cosine",
        store_dtype: str = "float32",
        shard_block: int = 1024,
        quantized=False,
    ) -> None:
        self.dimension = int(dimension)
        self.mesh = mesh or make_mesh()
        self.metric = metric
        name = topk_ops.resolve_store_dtype(store_dtype, self.mesh.device)
        if name not in _DTYPES:
            raise ValueError(f"store_dtype must be float32 or bfloat16, got {name!r}")
        self.store_dtype_name = name
        self.store_dtype = _DTYPES[name]
        self.shard_block = int(shard_block)
        self.quantized = quant_ops.resolve_store_quantized(quantized)
        self.n_shards = self.mesh.n_shards
        self._host_shards = [np.zeros((0, self.dimension), np.float32) for _ in range(self.n_shards)]
        self._device: Optional[List[torch.Tensor]] = None  # this process's shards, [capacity, D]
        self._device_i8: Optional[List[torch.Tensor]] = None
        self._scales: Optional[List[torch.Tensor]] = None
        self._capacity = 0
        self._dirty = True
        # per-shard live rows already on the device: _sync uploads the tail only
        self._synced_counts: Optional[np.ndarray] = None

    @property
    def counts(self) -> np.ndarray:
        return np.array([shard.shape[0] for shard in self._host_shards], np.int32)

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def append(self, vectors) -> np.ndarray:
        """Append rows; returns their stable ids.  Placement is the greedy
        balanced fill (each row to the shard with the fewest live rows, ties
        to the lowest shard), computed at once: a water-fill decides how many
        rows each shard takes, one lexsort recovers the greedy order."""
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        n_new = vectors.shape[0]
        if n_new == 0:
            return np.zeros((0,), np.int64)
        if self.metric == "cosine":
            norms = np.linalg.norm(vectors, axis=1, keepdims=True)
            vectors = np.where(norms > 0, vectors / np.maximum(norms, 1e-30), vectors)
        counts = self.counts.astype(np.int64)
        take = np.zeros(self.n_shards, np.int64)
        level = counts + take
        remaining = n_new
        while remaining > 0:  # raise the lowest level until every row is placed
            low = level.min()
            at_low = np.flatnonzero(level == low)
            above = level[level > low]
            step = (int(above.min()) - int(low)) if above.size else remaining
            fill = min(step * at_low.size, remaining)
            per, extra = divmod(fill, at_low.size)
            take[at_low] += per
            take[at_low[:extra]] += 1  # greedy ties go to the lowest shards
            level = counts + take
            remaining -= fill
        slot_shard = np.repeat(np.arange(self.n_shards, dtype=np.int64), take)
        slot_local = np.concatenate([counts[s] + np.arange(take[s], dtype=np.int64) for s in range(self.n_shards)])
        order = np.lexsort((slot_shard, slot_local))  # greedy order: (local level, shard)
        ids = slot_shard[order] * self._ID_STRIDE + slot_local[order]
        for s in range(self.n_shards):
            if take[s]:
                # within one shard the greedy order is local-ascending
                self._host_shards[s] = np.concatenate([self._host_shards[s], vectors[slot_shard[order] == s]])
        self._dirty = True
        return ids

    def _shard_capacity_hint(self) -> int:
        rows = max((s.shape[0] for s in self._host_shards), default=0)
        return max(self.shard_block, -(-rows // self.shard_block) * self.shard_block)

    def _upload(self, j: int, start: int, stop: int) -> None:
        """Host rows ``[start, stop)`` of local shard ``j`` → its device
        buffers (cast to the store dtype; int8 shadow quantized from the
        float32 rows, as the JAX store quantizes its host rows)."""
        s = self.mesh.first + j
        for a in range(start, stop, _CHUNK):
            b = min(stop, a + _CHUNK)
            chunk = torch.from_numpy(self._host_shards[s][a:b]).to(self.mesh.devices[j])
            self._device[j][a:b] = chunk.to(self.store_dtype)
            if self.quantized:
                q, sc = quantize_rows_host_rule(chunk)
                self._device_i8[j][a:b] = q
                self._scales[j][a:b] = sc

    def _sync(self) -> Tuple[List[torch.Tensor], int]:
        """Mirror the host shards into the device buffers: the appended tail
        only, written in place, unless this is the first sync, the capacity
        grew or rows went away (then every local shard is re-uploaded)."""
        capacity = self._shard_capacity_hint()
        if not self._dirty and self._device is not None and self._capacity == capacity:
            return self._device, capacity
        counts = self.counts.astype(np.int64)
        full = (self._device is None or self._capacity != capacity or self._synced_counts is None
                or np.any(counts < self._synced_counts))
        if full:
            zeros = lambda dtype, *shape: [torch.zeros(shape, dtype=dtype, device=d) for d in self.mesh.devices]  # noqa: E731
            self._device = zeros(self.store_dtype, capacity, self.dimension)
            if self.quantized:
                self._device_i8 = zeros(torch.int8, capacity, self.dimension)
                self._scales = zeros(torch.float32, capacity)
            self._capacity = capacity
            for j, s in enumerate(self.mesh.local_shards):
                self._upload(j, 0, int(counts[s]))
        else:
            for j, s in enumerate(self.mesh.local_shards):
                self._upload(j, int(self._synced_counts[s]), int(counts[s]))
        self._synced_counts = counts.copy()
        self._dirty = False
        return self._device, capacity

    def layout_mask(self, stable_ids, bits) -> np.ndarray:
        """Corpus-layout (``[n_shards · capacity]``, int8) filter from
        (stable id, keep-bit) pairs: the shape ``search(mask=...)`` expects."""
        _, capacity = self._sync()
        out = np.zeros(self.n_shards * capacity, np.int8)
        stable_ids = np.asarray(stable_ids, np.int64)
        out[(stable_ids // self._ID_STRIDE) * capacity + stable_ids % self._ID_STRIDE] = np.asarray(bits) > 0
        return out

    def _prepare_queries(self, queries) -> np.ndarray:
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if self.metric == "cosine":
            norms = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = np.where(norms > 0, queries / np.maximum(norms, 1e-30), queries)
        return queries

    def search(self, queries, k: int, impl: str = "auto", *, mask=None) -> Tuple[np.ndarray, np.ndarray]:
        """Returns host ``(distances, stable ids)``; -1 in empty slots.
        ``impl="int8"`` (a quantized store) runs the int8 tier for k ≤ 64;
        every other call the exact scan with ``impl`` ("int8" as "auto")."""
        topk_ops.check_impl(impl, STORE_IMPLS)
        if self.count == 0:
            q = np.atleast_2d(queries).shape[0]
            return np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int64)
        corpus, capacity = self._sync()
        queries = self._prepare_queries(queries)
        if impl == "int8" and not self.quantized:
            raise ValueError("impl='int8' requires ShardedEmbeddingStore(quantized=True)")
        k = min(k, self.count)
        if impl == "int8" and k <= quant_ops.INT8_MAX_K:
            vals, idx = sharded_int8_search(self._device_i8, self._scales, corpus, queries, k, self.mesh,
                                            counts=self.counts, metric=self.metric, mask=mask)
        else:
            vals, idx = sharded_exact_search(corpus, queries, k, self.mesh, counts=self.counts, metric=self.metric,
                                             impl="auto" if impl == "int8" else impl, mask=mask)
        return vals.cpu().numpy(), self._rebase(idx.cpu().numpy(), capacity)

    def _rebase(self, raw: np.ndarray, capacity: int) -> np.ndarray:
        """Capacity-relative device row ids → stable ids."""
        raw = np.asarray(raw, np.int64)
        return np.where(raw >= 0, (raw // capacity) * self._ID_STRIDE + raw % capacity, -1)

    def grouped_search(self, queries, k: int, mask_table, mask_ids, *, impl: str = "auto"):
        """Batched per-query filtered top-k over the mesh (``mask_table``
        ``[M, n_shards · capacity]``, ``mask_ids`` ``[Q]``); inner product
        and cosine.  ``impl="int8"`` runs kernel 6 per shard (a quantized
        store, k ≤ 64); every other call ``grouped_mask_search(impl=...)``."""
        topk_ops.check_impl(impl, STORE_IMPLS)
        if self.count == 0:
            q = np.atleast_2d(queries).shape[0]
            return np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int64)
        corpus, capacity = self._sync()
        queries = self._prepare_queries(queries)
        if impl == "int8" and not self.quantized:
            raise ValueError("impl='int8' requires ShardedEmbeddingStore(quantized=True)")
        k = min(k, self.count)
        table = np.asarray(mask_table, np.int8)
        ids = np.asarray(mask_ids, np.int32)
        if impl == "int8" and k <= quant_ops.INT8_MAX_K:
            vals, idx = sharded_grouped_int8_search(self._device_i8, self._scales, corpus, queries, table, ids, k,
                                                    self.mesh, counts=self.counts)
        else:
            vals, idx = sharded_grouped_search(corpus, queries, table, ids, k, self.mesh, counts=self.counts,
                                               impl="auto" if impl == "int8" else impl)
        return vals.cpu().numpy(), self._rebase(idx.cpu().numpy(), capacity)

    def global_id_to_shard_local(self, global_id: int) -> Tuple[int, int]:
        return global_id // self._ID_STRIDE, global_id % self._ID_STRIDE

    def reconstruct(self, global_id: int) -> np.ndarray:
        shard, local = self.global_id_to_shard_local(int(global_id))
        return self._host_shards[shard][local].copy()

    # -- checkpoints: one .npy per shard plus manifest.json (the JAX format)
    def save(self, directory: str, *, format: str = "npy") -> None:
        if format == "orbax":
            raise ValueError(_ORBAX)
        if format != "npy":
            raise ValueError("format must be npy or orbax")
        os.makedirs(directory, exist_ok=True)
        for shard_id, shard in enumerate(self._host_shards):
            with open(os.path.join(directory, f"shard_{shard_id:04d}.npy"), "wb") as f:
                np.save(f, shard)
        manifest = {
            "format_version": 1,
            "format": format,
            "dimension": self.dimension,
            "metric": self.metric,
            "store_dtype": self.store_dtype_name,
            "shard_block": self.shard_block,
            "n_shards": self.n_shards,
            "counts": self.counts.tolist(),
        }
        with open(os.path.join(directory, "manifest.json"), "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=2)

    def load(self, directory: str, *, allow_reshard: bool = False) -> bool:
        """Restore the shards of a checkpoint directory (False when it has
        none).  A checkpoint of another shard count is re-split evenly, which
        reassigns every stable id; that needs ``allow_reshard=True``."""
        manifest_path = os.path.join(directory, "manifest.json")
        if not os.path.exists(manifest_path):
            return False
        with open(manifest_path, "r", encoding="utf-8") as f:
            manifest = json.load(f)
        if manifest.get("dimension") != self.dimension:
            raise ValueError("checkpoint dimension differs; rebuild the store")
        if manifest.get("format") == "orbax":
            raise ValueError(_ORBAX)
        saved_shards = int(manifest.get("n_shards", 0))
        counts = manifest.get("counts") or []
        shards = []
        for shard_id in range(saved_shards):
            path = os.path.join(directory, f"shard_{shard_id:04d}.npy")
            if not os.path.exists(path):
                raise ValueError(f"checkpoint shard missing: {path}")
            with open(path, "rb") as f:
                shards.append(np.load(f))
        for shard, count in zip(shards, counts):
            if shard.shape[0] != count:
                raise ValueError("checkpoint shard count mismatch; rebuild")
        if saved_shards == self.n_shards:
            self._host_shards = shards
        else:
            if not allow_reshard:
                raise ValueError(
                    f"checkpoint has {saved_shards} shards but mesh has {self.n_shards}; re-sharding "
                    "reassigns every stable id — pass allow_reshard=True only if no persisted ids "
                    "reference this store")
            rows = [s for s in shards if s.size]
            rows = np.concatenate(rows) if rows else np.zeros((0, self.dimension), np.float32)
            self._host_shards = [np.ascontiguousarray(s, np.float32) for s in np.array_split(rows, self.n_shards)]
        self._dirty = True
        self._synced_counts = None  # host shards replaced: force a full upload
        return True

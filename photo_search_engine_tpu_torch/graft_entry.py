"""Entry points of the PyTorch port (the port of ``__graft_entry__.py``).

* :func:`entry` - the single-device forward step of the flagship model:
  the corpus-scoring + top-k retrieval over a device-resident embedding
  matrix (8192 × 1536 float32 unit rows, 16 queries, top-10), through
  ``ops.topk.exact_search(impl="auto")``: kernel 1 on the float32 ring.
* :func:`dryrun_multichip` - the mesh step on ``n`` shards: one
  data-parallel IVF k-means (Lloyd) update summed over the shards with the
  sharded exact search (partial top-k per shard + merge), then every other
  check of the JAX dry run: the sharded int8 search, the sharded IVF at
  full probe (masked and unmasked), the grouped search, the large-k route
  and the ``.npy`` + manifest save → load round trip, each against a numpy
  oracle, on tiny shapes (64 rows a shard, D 128, nlist 4, 8 queries, k 5).

Both run on the CUDA card unless the caller passes ``device="cpu"`` or sets
``PSE_PLATFORM=cpu``; ``dryrun_multichip`` puts its ``n`` shards on that one
device (``make_mesh(devices=[device] * n)``), each shard's scan its own
kernel launch.  Not carried over: the JAX script's forcing of the CPU
platform and of XLA's host device count, and its ``jit`` of the step.  The
large-k check runs the port's default impl (the port has no ApproxTopK;
off the TPU the JAX ``impl="approx"`` computes exactly, so the oracle is
the same); each shard's k there is min(96, 64 rows) = 64.

Run:  python -m photo_search_engine_tpu_torch.graft_entry
"""

from __future__ import annotations

import shutil
import tempfile

import numpy as np
import torch

from photo_search_engine_tpu_torch.device import resolve_device


def entry(device=None):
    """``(forward, (corpus, queries))``: ``forward(corpus, queries)`` is the
    exact top-10 search (inner product) of the queries over the corpus."""
    from photo_search_engine_tpu_torch.ops.topk import exact_search, l2_normalize

    device = resolve_device() if device is None else torch.device(device)
    n_rows, dim, n_queries, k = 8192, 1536, 16, 10
    gen = torch.Generator(device=device).manual_seed(0)
    corpus = l2_normalize(torch.randn((n_rows, dim), generator=gen, device=device))
    queries = l2_normalize(torch.randn((n_queries, dim), generator=gen, device=device))

    def forward(corpus, queries):
        return exact_search(corpus, queries, k, metric="ip", impl="auto")

    return forward, (corpus, queries)


def _require(ok, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _kmeans_oracle(x: np.ndarray, cents: np.ndarray) -> np.ndarray:
    """One Lloyd update in numpy (float64): nearest by ``2<x, c> - |c|^2``,
    empty centroids keep their position."""
    x, cents = x.astype(np.float64), cents.astype(np.float64)
    assign = np.argmax(2.0 * x @ cents.T - (cents * cents).sum(axis=1)[None, :], axis=1)
    out = cents.copy()
    for c in range(cents.shape[0]):
        if (assign == c).any():
            out[c] = x[assign == c].mean(axis=0)
    return out


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The mesh dry run on ``n_devices`` shards of ``device``; raises on any
    disagreement with the oracles, prints one line when every check passed."""
    from photo_search_engine_tpu_torch.parallel.sharded import (
        ShardedEmbeddingStore,
        make_mesh,
        quantize_rows_host_rule,
        sharded_exact_search,
        sharded_grouped_search,
        sharded_int8_search,
        sharded_kmeans_step,
    )
    from photo_search_engine_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex

    device = resolve_device() if device is None else torch.device(device)
    mesh = make_mesh(devices=[device] * n_devices)
    rows_per_shard, dim, nlist, n_queries, k = 64, 128, 4, 8, 5
    total_rows = rows_per_shard * n_devices
    rng = np.random.default_rng(0)
    corpus_host = rng.normal(size=(total_rows, dim)).astype(np.float32)
    centroids = rng.normal(size=(nlist, dim)).astype(np.float32)
    queries_host = rng.normal(size=(n_queries, dim)).astype(np.float32)

    # --- training: one data-parallel k-means update, summed over the shards ---
    new_cents, _ = sharded_kmeans_step(corpus_host, centroids, mesh)
    _require(tuple(new_cents.shape) == (nlist, dim), f"centroids {tuple(new_cents.shape)}")
    np.testing.assert_allclose(new_cents.cpu().numpy(), _kmeans_oracle(corpus_host, centroids), rtol=0, atol=1e-4)
    # --- serving: sharded exact search (partial top-k per shard + merge) ---
    vals, idx = sharded_exact_search(corpus_host, queries_host, k, mesh, metric="ip")
    _require(tuple(vals.shape) == (n_queries, k), f"top-k {tuple(vals.shape)}")
    ref = np.argsort(-(queries_host @ corpus_host.T), axis=1)[:, :k]
    _require((idx.cpu().numpy() == ref).all(), "sharded top-k mismatch vs oracle")

    # --- int8 serving path over the same mesh (scan + exact rescore) ---
    q_rows, scales = quantize_rows_host_rule(torch.from_numpy(corpus_host))
    _, idx8 = sharded_int8_search(q_rows, scales, corpus_host, queries_host, k, mesh)
    idx8 = idx8.cpu().numpy()
    overlap = np.mean([len(set(idx8[q].tolist()) & set(ref[q].tolist())) / k for q in range(n_queries)])
    _require(overlap >= 0.8, f"sharded int8 recall {overlap} vs oracle")

    # --- sharded IVF over the same mesh: full probe equals the exact oracle ---
    store = ShardedEmbeddingStore(dim, mesh, metric="cosine")
    corpus_unit = corpus_host / np.linalg.norm(corpus_host, axis=1, keepdims=True)
    ids = store.append(corpus_unit)
    sivf = ShardedIVFIndex.build(store, nlist=nlist, train_iters=2, seed=0)
    q_unit = queries_host / np.linalg.norm(queries_host, axis=1, keepdims=True)
    _, sids = sivf.search(q_unit, k, nprobe=nlist)
    stable_ref = ids[np.argsort(-(q_unit @ corpus_unit.T), axis=1)[:, :k]]
    for q in range(n_queries):
        _require(set(sids[q].tolist()) == set(stable_ref[q].tolist()),
                 f"sharded IVF full-probe mismatch at query {q}")

    # --- masked sharded IVF: filter bits permuted into the slot layout ---
    keep = (rng.random(total_rows) < 0.5).astype(np.int32)
    shard_of = (ids // ShardedEmbeddingStore._ID_STRIDE).astype(np.int64)
    local_of = (ids % ShardedEmbeddingStore._ID_STRIDE).astype(np.int64)
    slot_bits = np.zeros(sivf.perms.shape, np.int32)
    for s in range(n_devices):
        sel = shard_of == s
        if not sel.any():
            continue
        local_bits = np.zeros(int(local_of[sel].max()) + 1, np.int32)
        local_bits[local_of[sel]] = keep[sel]
        live = sivf.perms[s] >= 0
        src = sivf.perms[s][live]
        row_bits = np.zeros(int(live.sum()), np.int32)
        inb = src < local_bits.shape[0]
        row_bits[inb] = local_bits[src[inb]]
        slot_bits[s, live] = row_bits
    _, msids = sivf.search(q_unit, k, nprobe=nlist, slot_mask=slot_bits.reshape(-1), mask_ratio=float(keep.mean()))
    scores_masked = q_unit @ corpus_unit.T
    scores_masked[:, keep == 0] = -np.inf
    stable_mref = ids[np.argsort(-scores_masked, axis=1)[:, :k]]
    for q in range(n_queries):
        _require(set(msids[q].tolist()) == set(stable_mref[q].tolist()),
                 f"masked sharded IVF full-probe mismatch at query {q}")

    # --- grouped (per-query filtered) search over the mesh ---
    n_masks = 3
    mask_table = (rng.random((n_masks, total_rows)) < 0.6).astype(np.int8)
    mask_ids = rng.integers(0, n_masks, size=n_queries).astype(np.int32)
    _, gidx = sharded_grouped_search(corpus_host, queries_host, mask_table, mask_ids, k, mesh)
    gidx = gidx.cpu().numpy()
    gscores = queries_host @ corpus_host.T
    gscores[mask_table[mask_ids] == 0] = -np.inf
    gref = np.argsort(-gscores, axis=1)[:, :k]
    for q in range(n_queries):
        got = [int(i) for i in gidx[q] if i >= 0]
        _require(all(mask_table[mask_ids[q], i] for i in got),
                 f"grouped mesh search leaked a filtered row at query {q}")
        want = [int(i) for i in gref[q] if np.isfinite(gscores[q, i])][: len(got)]
        _require(set(got) == set(want), f"grouped mesh search mismatch at query {q}")

    # --- large k: the serving over-fetch size, through the default impl ---
    big_k = 96
    _, aidx = sharded_exact_search(corpus_host, queries_host, big_k, mesh, metric="ip")
    aidx = aidx.cpu().numpy()
    aref = np.argsort(-(queries_host @ corpus_host.T), axis=1)[:, :big_k]
    for q in range(n_queries):
        got = set(int(i) for i in aidx[q] if i >= 0)
        _require(got == set(aref[q].tolist()), f"sharded large-k mismatch at query {q}")

    # --- mesh save -> load round trip: per-shard .npy + manifest ---
    ckpt_dir = tempfile.mkdtemp(prefix="pse_dryrun_ckpt_")
    try:
        store.save(ckpt_dir)
        restored = ShardedEmbeddingStore(dim, mesh, metric="cosine")
        _require(restored.load(ckpt_dir), "mesh checkpoint load returned False")
        d0, i0 = store.search(q_unit, k)
        d1, i1 = restored.search(q_unit, k)
        _require((np.asarray(i0) == np.asarray(i1)).all(), "mesh save->load roundtrip changed search ids")
        _require(np.allclose(np.asarray(d0), np.asarray(d1), atol=1e-6),
                 "mesh save->load roundtrip changed search scores")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    print(
        f"dryrun_multichip ok: {n_devices} shards on {device}, centroids {tuple(new_cents.shape)} "
        f"== numpy Lloyd step, topk {tuple(vals.shape)} verified against oracle, int8 recall {overlap:.2f}, "
        f"sharded IVF full-probe == exact (masked + unmasked), "
        f"grouped-mask mesh == oracle (no leaks), "
        f"sharded large-k (k={big_k}) == oracle, "
        f"mesh save->load roundtrip identical"
    )


if __name__ == "__main__":
    dryrun_multichip(8)
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", [tuple(o.shape) for o in out])

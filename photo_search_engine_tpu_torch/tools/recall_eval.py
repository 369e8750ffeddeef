"""Recall + latency evaluation over a migrated corpus, or a synthetic one.

Counterpart of ``photo_search_engine_tpu/tools/recall_eval.py``.  It
evaluates the configurations that need no external model service:

* :func:`evaluate` — image-to-image retrieval over the corpus's own
  embeddings (leave-one-out: query with each stored vector, exclude self):
  the exact path's recall@k against a NumPy brute-force oracle (FAISS-flat
  parity; expected 1.0), the IVF path's and the int8 tier's recall@k, and
  time-filtered masked searches against a host-filtered oracle;
* :func:`evaluate_synthetic` — IVF recall and latency at million scale on
  a corpus of low intrinsic dimension, at an autotuned nprobe, with an
  optional (nprobe, batch) sweep.

Both run on the device ``PSE_PLATFORM`` names: the card when it is unset,
the host with ``PSE_PLATFORM=cpu``.  Latency is measured with CUDA events
around ``iters`` launches of :meth:`IVFIndex.device_search_fn` on distinct
queries after a warm-up (host wall-clock time on the CPU).

Usage:
  python -m photo_search_engine_tpu_torch.tools.recall_eval --data-dir ./data_tpu [--k 10]
  python -m photo_search_engine_tpu_torch.tools.recall_eval --synthetic-rows 1000000 \\
      --sweep 16,32,64 --sweep-batches 1,8,128
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np


def _host_oracle(corpus: np.ndarray, k_eval: int, chunk: int = 4096) -> np.ndarray:
    """Self-excluded cosine top-k per row, computed in row chunks so host
    memory stays O(chunk·n) — a whole-corpus score matrix plus argsort is
    ~120 GB at 100k photos."""
    n = corpus.shape[0]
    oracle = np.empty((n, k_eval), np.int64)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        scores = corpus[start:stop] @ corpus.T
        scores[np.arange(stop - start), np.arange(start, stop)] = -np.inf
        top = np.argpartition(-scores, k_eval, axis=1)[:, : k_eval + 1]
        order = np.take_along_axis(scores, top, 1).argsort(1, kind="stable")[:, ::-1]
        oracle[start:stop] = np.take_along_axis(top, order, 1)[:, :k_eval]
    return oracle


def _recall(got_rows, oracle: np.ndarray, k_eval: int) -> float:
    """Mean share of each row's oracle neighbours among its first
    ``k_eval`` results, the row itself and empty slots left out."""
    hits = 0
    for row, got in enumerate(got_rows):
        got = [i for i in got if i != row and i >= 0][:k_eval]
        hits += len(set(got) & set(oracle[row].tolist()))
    return hits / (len(oracle) * k_eval)


def evaluate(data_dir: str, k: int = 10, nprobe: int = 8) -> Dict[str, Any]:
    from photo_search_engine_tpu_torch.core.embedding_store import EmbeddingStore
    from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
    from photo_search_engine_tpu_torch.models.ivf import IVFIndex

    # read the sidecar first: a deployment saved with VECTOR_METRIC=l2 or
    # VECTOR_INDEX_TYPE=ivf must be opened with matching config, or load()
    # refuses it ("index type differs from config")
    index_path = os.path.join(data_dir, "photo_search.index")
    sidecar: Dict[str, Any] = {}
    try:
        with open(index_path + ".meta.json", "r", encoding="utf-8") as f:
            sidecar = json.load(f)
    except OSError:
        pass
    vector_index = VectorIndex(
        dimension=None,
        index_path=index_path,
        metadata_path=os.path.join(data_dir, "metadata.json"),
        metric=sidecar.get("metric") or "cosine",
        index_type=sidecar.get("index_type") or "flat",
    )
    if not vector_index.load():
        raise FileNotFoundError(f"no index at {data_dir}")
    corpus = vector_index._store.snapshot()
    metadata = vector_index.metadata
    n = corpus.shape[0]
    k_eval = min(k, n - 1)
    if k_eval < 1:
        return {
            "corpus": {"count": n, "dimension": int(corpus.shape[1])},
            "note": "fewer than 2 photos — recall undefined",
            "k": 0,
        }

    # oracle: brute-force cosine, excluding self (chunked)
    oracle = _host_oracle(corpus, k_eval)

    # exact path (kernel 1), k+1 then drop self
    vector_index.search_batch(corpus, k_eval + 1)  # warm-up (the kernels' build)
    started = time.perf_counter()
    batches = vector_index.search_batch(corpus, k_eval + 1)
    exact_elapsed = time.perf_counter() - started
    path_to_row = {m.get("photo_path"): i for i, m in enumerate(metadata)}
    exact_recall = _recall(
        [[path_to_row.get(h["metadata"]["photo_path"], -1) for h in hits] for hits in batches], oracle, k_eval
    )

    # IVF path (kernel 7)
    ivf_recall = None
    if n >= 32:
        nlist = max(2, min(64, n // 8))
        index = IVFIndex.build(corpus, nlist=nlist, seed=0)
        _, ivf_idx = index.search(corpus, k_eval + 1, nprobe=min(nprobe, nlist))
        ivf_recall = _recall(ivf_idx.tolist(), oracle, k_eval)

    # int8 scan + exact rescore (kernel 2) on the corpus's own distribution
    q_store = EmbeddingStore.from_array(corpus, metric="cosine", quantized=True, already_normalized=True)
    _, i8_idx = q_store.search(corpus, k_eval + 1, impl="int8")
    int8_recall = _recall(i8_idx.tolist(), oracle, k_eval)

    # masked (time-filtered) search vs host-filtered oracle
    mask_checks = 0
    mask_correct = 0
    seasons = sorted(
        {(m.get("time_info") or {}).get("season") for m in metadata if (m.get("time_info") or {}).get("season")}
    )
    for season in seasons:
        mask = np.array([1 if (m.get("time_info") or {}).get("season") == season else 0 for m in metadata], np.int32)
        if mask.sum() == 0:
            continue
        query_row = int(np.argmax(mask))
        k_mask = min(k_eval, int(mask.sum()))
        hits = vector_index.search_masked(corpus[query_row].tolist(), k_mask, mask.astype(bool))
        # true host-filtered oracle: top-k of the masked score vector (not
        # just containment — wrong-but-allowed results must fail)
        scores = corpus @ corpus[query_row]
        scores[mask == 0] = -np.inf
        want_rows = np.argsort(-scores, kind="stable")[:k_mask]
        want = {metadata[int(r)].get("photo_path") for r in want_rows}
        allowed = {m.get("photo_path") for m, flag in zip(metadata, mask) if flag}
        got = {h["metadata"]["photo_path"] for h in hits}
        mask_checks += 1
        # strict oracle match, with one-slot tolerance for dtype near-ties
        if got <= allowed and len(got & want) >= max(1, k_mask - 1):
            mask_correct += 1

    return {
        "corpus": {"count": n, "dimension": int(corpus.shape[1])},
        "exact_recall_at_k": round(exact_recall, 4),
        "exact_batch_seconds": round(exact_elapsed, 4),
        "ivf_recall_at_k": None if ivf_recall is None else round(ivf_recall, 4),
        "int8_recall_at_k": round(int8_recall, 4),
        "masked_search_checks": mask_checks,
        "masked_search_correct": mask_correct,
        "k": k_eval,
    }


def synthetic_corpus(rows: int, dim: int, intrinsic: int, rng: np.random.Generator, seed: int, device, dtype):
    """``(corpus [rows, dim] on device, basis or None)``: unit rows
    ``normalize(z @ B)`` with ``B`` ``[intrinsic, dim]`` Gaussian over
    sqrt(intrinsic) and ``z`` Gaussian, drawn from ``rng`` by the JAX
    tool's own calls in its order (the same seed gives both packages the
    same rows); ``intrinsic=0`` draws iid rows on the device from a
    ``torch.Generator`` seeded ``seed * 1000 + chunk``.  Made in 16 chunks,
    which bounds the float32 temporary."""
    import torch

    from photo_search_engine_tpu_torch.ops.topk import l2_normalize

    chunk_rows = max(1, rows // 16)
    corpus = torch.empty((rows, dim), dtype=dtype, device=device)
    basis = None
    if intrinsic and intrinsic > 0:
        basis = torch.from_numpy(
            (rng.normal(size=(intrinsic, dim)).astype(np.float32) / np.sqrt(intrinsic)).astype(np.float32)
        ).to(device)
        for i in range(0, rows, chunk_rows):
            m = min(chunk_rows, rows - i)
            z = torch.from_numpy(rng.normal(size=(m, intrinsic)).astype(np.float32)).to(device)
            corpus[i : i + m] = l2_normalize(z @ basis).to(dtype)
    else:
        for ci, i in enumerate(range(0, rows, chunk_rows)):
            m = min(chunk_rows, rows - i)
            gen = torch.Generator(device=device).manual_seed(seed * 1000 + ci)
            corpus[i : i + m] = l2_normalize(torch.randn((m, dim), generator=gen, device=device)).to(dtype)
    return corpus, basis


def evaluate_synthetic(
    rows: int,
    dim: int = 1536,
    intrinsic: int = 32,
    nlist: int = 1024,
    k: int = 10,
    target_recall: float = 0.98,
    n_queries: int = 256,
    seed: int = 0,
    sweep: Optional[List[int]] = None,
    sweep_batches: Optional[List[int]] = None,
) -> Dict[str, Any]:
    """Million-scale IVF recall + latency at an autotuned nprobe.

    ``intrinsic`` controls data hardness: real photo/CLIP-style embeddings
    have low intrinsic dimension (points near a low-dim manifold), where
    IVF probing is informative; ``intrinsic=0`` generates iid unit-sphere
    noise — the adversarial case where centroid distances carry almost no
    information about neighbor placement and any IVF (FAISS included)
    needs a large nprobe.  Queries are held-out perturbations of corpus
    rows (never the rows themselves).  The rows are bfloat16 on the card,
    float32 on the host.

    The oracle is the exact scan (kernel 1 on the card); the IVF index is
    built on the device, its nprobe tuned, and the optional sweep gives
    recall and latency over a grid of (nprobe, batch).  Latency: CUDA
    events around ``iters`` launches of ``device_search_fn`` on distinct
    queries after one warm-up launch (host wall-clock time on the CPU)."""
    import torch

    from photo_search_engine_tpu_torch.device import resolve_device
    from photo_search_engine_tpu_torch.models.ivf import IVFIndex
    from photo_search_engine_tpu_torch.ops.topk import exact_search

    device = resolve_device()
    on_card = device.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    rng = np.random.default_rng(seed)
    # small --synthetic-rows values must not crash rng.choice/k-means
    n_queries = max(1, min(n_queries, rows))
    nlist = max(1, min(nlist, rows))
    k = max(1, min(k, rows))

    def _stage(msg: str) -> None:
        print(f"[recall_eval] {msg}", flush=True)

    def _sync() -> None:
        if on_card:
            torch.cuda.synchronize(device)

    _stage(f"staging {rows}x{dim} corpus (intrinsic={intrinsic}) on {device}")
    corpus_dev, basis = synthetic_corpus(rows, dim, intrinsic, rng, seed, device, dtype)
    _sync()

    # held-out queries: perturbed corpus rows
    picks = rng.choice(rows, size=n_queries, replace=False)
    base = corpus_dev[torch.from_numpy(picks).to(device)].float().cpu().numpy()
    if basis is not None:
        noise = rng.normal(size=(n_queries, intrinsic)).astype(np.float32)
        queries = base + 0.1 * (torch.from_numpy(noise).to(device) @ basis).cpu().numpy()
    else:
        queries = base + 0.1 * rng.normal(size=(n_queries, dim)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    queries = queries.astype(np.float32)

    _stage("computing exact oracle")
    _, oracle = exact_search(corpus_dev, torch.from_numpy(queries).to(device).to(dtype), k)
    oracle = oracle.cpu().numpy()

    _stage("building IVF index on device")
    build_started = time.perf_counter()
    index = IVFIndex.build_on_device(corpus_dev, nlist, metric="ip", seed=seed)
    _sync()
    build_seconds = time.perf_counter() - build_started

    _stage("autotuning nprobe")
    tune_started = time.perf_counter()
    nprobe, tuned_recall = index.tune_nprobe(queries[: min(64, n_queries)], k, target_recall=target_recall)
    tune_seconds = time.perf_counter() - tune_started

    def _recall_at(nprobe_val: int) -> float:
        _, got = index.search(queries, k, nprobe=nprobe_val)
        return float(np.mean([len(set(got[i].tolist()) & set(oracle[i].tolist())) / k for i in range(n_queries)]))

    _stage(f"scoring recall at nprobe={int(nprobe)}")
    recall = _recall_at(nprobe)

    def _latency(nprobe_val: int, batch: int, iters: int = 32) -> float:
        """Seconds per batch: ``iters`` launches of ``device_search_fn``
        back to back on distinct queries (a search of the same queries
        again would time the same work), after one warm-up launch."""
        search_fn = index.device_search_fn(k, nprobe_val, batch)
        q_pool = queries[rng.integers(0, n_queries, size=(iters + 1) * batch)].reshape(iters + 1, batch, dim)
        qstack = torch.from_numpy(q_pool + 1e-4 * rng.normal(size=q_pool.shape).astype(np.float32)).to(device)
        search_fn(qstack[0])
        if not on_card:
            started = time.perf_counter()
            for i in range(iters):
                search_fn(qstack[i + 1])
            return max((time.perf_counter() - started) / iters, 1e-9)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for i in range(iters):
            search_fn(qstack[i + 1])
        end.record()
        torch.cuda.synchronize(device)
        return max(start.elapsed_time(end) / 1e3 / iters, 1e-9)

    # optional sweep: recall + latency over a grid of (nprobe, batch)
    sweep_rows: List[Dict[str, Any]] = []
    for np_val in sweep or []:
        np_val = max(1, min(int(np_val), nlist))
        _stage(f"sweep nprobe={np_val}")
        r = _recall_at(np_val)
        for b in sweep_batches or [8]:
            secs = _latency(np_val, b)
            sweep_rows.append(
                {
                    "nprobe": np_val,
                    "recall_at_k": round(r, 4),
                    "batch": b,
                    "latency_ms_per_batch": round(secs * 1e3, 3),
                    "qps": round(b / secs, 1),
                }
            )

    # latency at serving batch 8
    batch = 8
    _stage("measuring latency")
    per_batch = _latency(nprobe, batch)

    return {
        "rows": rows,
        "dim": dim,
        "intrinsic_dim": intrinsic,
        "nlist": nlist,
        "k": k,
        "target_recall": target_recall,
        "tuned_nprobe": int(nprobe),
        "tune_sample_recall_vs_full_probe": round(float(tuned_recall), 4),
        "recall_at_k_vs_exact": round(recall, 4),
        "ivf_build_seconds": round(build_seconds, 2),
        "tune_seconds": round(tune_seconds, 2),
        "batch": batch,
        "latency_ms_per_batch": round(per_batch * 1e3, 3),
        "qps": round(batch / per_batch, 1),
        **({"sweep": sweep_rows} if sweep_rows else {}),
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data-dir")
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--nprobe", type=int, default=8)
    parser.add_argument(
        "--synthetic-rows", type=int, default=0,
        help="evaluate IVF recall/latency on a synthetic corpus of this "
        "many rows (autotuned nprobe) instead of a migrated data dir",
    )
    parser.add_argument("--dim", type=int, default=1536)
    parser.add_argument(
        "--intrinsic", type=int, default=32,
        help="intrinsic dimension of the synthetic corpus (0 = iid noise, the adversarial case)",
    )
    parser.add_argument("--nlist", type=int, default=1024)
    parser.add_argument("--target-recall", type=float, default=0.98)
    parser.add_argument("--sweep", default="", help="comma-separated nprobe values to sweep (recall + latency each)")
    parser.add_argument(
        "--sweep-batches", default="1,8", help="comma-separated batch sizes for the sweep's latency column",
    )
    args = parser.parse_args(argv)
    if args.synthetic_rows:
        result = evaluate_synthetic(
            args.synthetic_rows,
            dim=args.dim,
            intrinsic=args.intrinsic,
            nlist=args.nlist,
            k=args.k,
            target_recall=args.target_recall,
            sweep=[int(s) for s in args.sweep.split(",") if s.strip()],
            sweep_batches=[int(s) for s in args.sweep_batches.split(",") if s.strip()],
        )
    else:
        if not args.data_dir:
            parser.error("--data-dir is required without --synthetic-rows")
        result = evaluate(args.data_dir, args.k, args.nprobe)
    print(json.dumps(result, ensure_ascii=False, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

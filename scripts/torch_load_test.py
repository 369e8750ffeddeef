"""Route-level concurrent load test of the PyTorch port: N threads hammering
POST /search_photos over real HTTP against a synthetic million-row corpus.

The port of ``scripts/load_test.py``, with the same stack, flags and
output: ThreadingWSGIServer → the port's api.routes → Searcher →
micro-batcher (``attach_microbatcher``, max_batch 128) → VectorIndex →
the CUDA kernels, with the LLM-side services replaced by the
deterministic local backends (query embedding via
HashingEmbeddingService; no expansion/reflection, so every request costs
exactly one scan).  Query texts cycle through a pool of 512 distinct
strings so the query cache cannot short-circuit the device work.

It runs on the CUDA card unless ``PSE_PLATFORM=cpu`` asks for the host;
``--fake-device-ms`` runs on the host because that flag asks for it (the
device is a stub there).  The default corpus is made on the card from a
seeded ``torch.Generator`` in 8 chunks, l2-normalized in the store's
dtype, and installed with ``VectorIndex.load_device_rows``;
``--host-corpus`` keeps the numpy ``default_rng(0)`` rows and
``add_batch``, so both packages build the same rows.

The JSON line has the JAX script's keys.  At 1M rows ``/search_photos``
over-fetches ``candidate_k = 500``, above the kernels' k of 64, so the
flat store answers it with the plain exact scan; the IVF store runs
kernel 7 on its FMA loop for k > 64.

Not carried over from the JAX script (TPU-only workarounds): the XLA
compile cache, forcing the JAX CPU platform for ``--fake-device-ms``, and
the long first-compile timeouts' rationale (the first request here builds
the kernels with nvcc when they are not built yet, and the IVF index).

Usage:
  python scripts/torch_load_test.py [--rows 1000000] [--dim 1536] [--threads 16]
                                    [--requests 2000] [--quantized] [--index-type ivf]

Prints a human table + one machine-readable JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_stack(
    rows: int, dim: int, quantized: bool, index_type: str,
    host_corpus: bool = False, window_ms: float = 3.0, pipeline: int = 2,
    fake_device_ms: float = 0.0, keyword_rows: int = 0,
):
    import torch

    from photo_search_engine_tpu_torch.api.app import create_app
    from photo_search_engine_tpu_torch.core.batcher import attach_microbatcher
    from photo_search_engine_tpu_torch.core.searcher import Searcher
    from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
    from photo_search_engine_tpu_torch.device import resolve_device
    from photo_search_engine_tpu_torch.models.hash_embedder import (
        HashingEmbeddingService,
    )
    from photo_search_engine_tpu_torch.services.time_parser import TimeParser

    # the stub device of --fake-device-ms is host code: only that flag
    # puts the stack on the host; otherwise PSE_PLATFORM or the card
    device = torch.device("cpu") if fake_device_ms > 0 else resolve_device()
    tmp = tempfile.mkdtemp(prefix="pse_load_")
    vector_index = VectorIndex(
        dimension=dim,
        index_path=os.path.join(tmp, "load.index"),
        metadata_path=os.path.join(tmp, "load-meta.json"),
        metric="cosine",
        store_dtype="auto",
        quantized=quantized,
        index_type=index_type,
        ivf_nlist=4096,
        ivf_nprobe=0,
        device=device,
    )
    def _metas(start: int, n: int):
        return [
            {
                "photo_path": f"/photos/{start + i}.jpg",
                "file_name": f"IMG_{start + i:07d}.jpg",
                "description": f"synthetic row {start + i}",
            }
            for i in range(n)
        ]

    t0 = time.perf_counter()
    if fake_device_ms > 0:
        # STACK-ONLY mode: the device is replaced by a stub that sleeps the
        # given per-batch scan latency (GIL released, so concurrent batches
        # overlap like real launches) and returns deterministic valid row
        # indices; everything else (ThreadingWSGI → routes → Searcher →
        # micro-batcher → fusion/top-k assembly) is the production code
        # path, so the measured QPS is the stack's ceiling with a device of
        # that latency
        metas = _metas(0, rows)
        vector_index.metadata.extend(metas)
        for i, meta in enumerate(metas):
            vector_index._path_to_index[meta["photo_path"]] = i

        class _FakeStore:
            count = rows
            dimension = dim

        vector_index._store = _FakeStore()

        def _fake_scan(queries, k, mask=None):
            q = np.atleast_2d(np.asarray(queries, np.float32))
            b = q.shape[0]
            time.sleep(fake_device_ms / 1e3)
            seed = (np.abs(q).sum(axis=1) * 1e4).astype(np.int64)
            idx = (
                (seed[:, None] + np.arange(k)[None, :]) % max(rows, 1)
            ).astype(np.int32)
            dists = np.broadcast_to(
                np.linspace(0.95, 0.5, k, dtype=np.float32)[None, :], (b, k)
            ).copy()
            vector_index.last_route = {
                "impl": f"fake_device_{fake_device_ms:g}ms",
                "nprobe": None,
                "mesh_devices": 1,
            }
            return dists, idx

        vector_index.raw_search_batch = _fake_scan
        vector_index.raw_grouped_search_batch = (
            lambda queries, k, table, ids: _fake_scan(queries, k)
        )
        print(f"  corpus {rows}/{rows} (metadata-only, fake device)", flush=True)
    elif host_corpus:
        # the production ingest path (host rows → add_batch): the same rows
        # as the JAX script's --host-corpus, for parity checks
        rng = np.random.default_rng(0)
        chunk = 100_000
        for start in range(0, rows, chunk):
            n = min(chunk, rows - start)
            block = rng.normal(size=(n, dim)).astype(np.float32)
            block /= np.linalg.norm(block, axis=1, keepdims=True)
            vector_index.add_batch(block, _metas(start, n))
            print(f"  corpus {start + n}/{rows}", flush=True)
    else:
        # synthesize the corpus ON DEVICE, chunk by chunk into one buffer,
        # and install it via the store's ingest bypass; the HTTP serving
        # path under test is identical either way
        from photo_search_engine_tpu_torch.ops.topk import l2_normalize

        dtype = getattr(torch, vector_index.store_dtype)  # bfloat16 on the card, float32 on the host
        n_chunks = 8
        per = -(-rows // n_chunks)
        rows_dev = torch.empty((rows, dim), dtype=dtype, device=device)
        for i in range(n_chunks):
            start, stop = i * per, min(rows, (i + 1) * per)
            if start >= stop:
                break
            gen = torch.Generator(device=device).manual_seed(i)
            rows_dev[start:stop] = l2_normalize(
                torch.randn((stop - start, dim), generator=gen, device=device, dtype=dtype)
            )
        vector_index.load_device_rows(rows_dev, _metas(0, rows))
        del rows_dev
        print(f"  corpus {rows}/{rows} (device-generated)", flush=True)
    build_s = time.perf_counter() - t0

    from photo_search_engine_tpu_torch.core.batcher import BatchedEmbeddingService

    embedding = BatchedEmbeddingService(
        HashingEmbeddingService(dimension=dim, device=device),
        window_s=window_ms / 1000.0,
        pipeline=pipeline,
    )
    keyword_index = None
    if keyword_rows > 0:
        # HYBRID mode: a real KeywordIndex over the same photo_paths as
        # the vector metadata (scene/subject text matching the load
        # queries), so /search_photos exercises the full two-channel
        # fusion: BM25 under the FIFO admission gate + vector scan
        from torch_keyword_bench_1m import build as build_keyword

        t_kw = time.perf_counter()
        keyword_index, _ = build_keyword(keyword_rows)
        print(
            f"  keyword corpus {keyword_rows} docs in "
            f"{time.perf_counter() - t_kw:.1f}s", flush=True,
        )

    searcher = Searcher(
        embedding=embedding,
        time_parser=TimeParser(backend="local"),
        vector_index=vector_index,
        keyword_index=keyword_index,
        data_dir=tmp,
        top_k=10,
        query_expansion_enabled=False,
        query_multi_round_enabled=False,
        query_reflection_enabled=False,
        query_cache_enabled=False,
        embedding_cache_enabled=False,
    )
    # the corpus was built in memory (never save()d), so mark it served
    searcher.index_loaded = True
    attach_microbatcher(
        vector_index, max_batch=128, window_s=window_ms / 1000.0,
        pipeline=pipeline,
    )

    class _ReadyIndexer:
        """Route contract stub: the corpus is pre-built in-process, so the
        indexer is permanently 'ready' (routes gate every search on
        indexer.get_status())."""

        def get_status(self):
            return {
                "status": "ready",
                "message": "synthetic corpus",
                "total_count": rows,
                "indexed_count": rows,
                "failed_count": 0,
            }

    app = create_app(
        {
            "config": {"TOP_K": 10, "DEFAULT_SEARCH_MODE": "balanced"},
            "indexer": _ReadyIndexer(),
            "searcher": searcher,
            "text_rerank_service": None,
            "visual_rerank_service": None,
        }
    )
    return app, vector_index, build_s


def serve(app):
    from socketserver import ThreadingMixIn
    from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

    class QuietHandler(WSGIRequestHandler):
        def log_message(self, *args):  # per-request stderr lines skew timing
            pass

    class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
        daemon_threads = True
        request_queue_size = 128  # default backlog of 5 resets under load

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    server = make_server(
        "127.0.0.1", port, app, server_class=ThreadingWSGIServer,
        handler_class=QuietHandler,
    )
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, port


SCENES = ["海边", "雪山", "城市", "公园", "森林", "沙滩", "湖泊", "街道"]
SUBJECTS = ["日落", "人像", "合影", "夜景", "建筑", "美食", "花朵", "宠物"]


def query_pool():
    """The 512 distinct query texts the load cycles through."""
    return [f"{SCENES[i % 8]} {SUBJECTS[(i // 8) % 8]} 变体{i}" for i in range(512)]


def post_search(port: int, query: str, timeout_s: float = 300):
    """POST /search_photos {query, top_k 10}; the response JSON."""
    request = urllib.request.Request(
        f"http://127.0.0.1:{port}/search_photos",
        data=json.dumps({"query": query, "top_k": 10}).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(request, timeout=timeout_s) as resp:
        return json.loads(resp.read())


def warmup_requests(threads: int, total_requests: int) -> int:
    return min(4 * threads, total_requests)


def run_load(port: int, threads: int, total_requests: int):
    queries = query_pool()
    latencies: list = []
    errors: list = []
    lock = threading.Lock()
    counter = {"next": 0}

    def run_phase(n_requests: int, offset: int, timeout_s: float):
        counter["next"] = 0

        def worker():
            while True:
                with lock:
                    i = counter["next"]
                    if i >= n_requests:
                        return
                    counter["next"] = i + 1
                body = json.dumps(
                    {"query": queries[(offset + i) % len(queries)], "top_k": 10}
                ).encode()
                request = urllib.request.Request(
                    f"http://127.0.0.1:{port}/search_photos",
                    data=body,
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                t0 = time.perf_counter()
                try:
                    with urllib.request.urlopen(request, timeout=timeout_s) as resp:
                        resp.read()
                        code = resp.status
                except urllib.error.HTTPError as exc:
                    detail = b""
                    try:
                        detail = exc.read()[:300]
                    except Exception:  # noqa: BLE001
                        pass
                    with lock:
                        errors.append(f"http {exc.code}: {detail!r}")
                    continue
                except Exception as exc:  # noqa: BLE001
                    with lock:
                        errors.append(str(exc))
                    continue
                dt = time.perf_counter() - t0
                with lock:
                    latencies.append(dt)
                    if code != 200:
                        errors.append(f"http {code}")

        pool = [threading.Thread(target=worker) for _ in range(threads)]
        t_wall0 = time.perf_counter()
        for t in pool:
            t.start()
        for t in pool:
            t.join()
        return time.perf_counter() - t_wall0

    # untimed warmup at FULL concurrency: organic micro-batch sizes reach
    # the card before the measured window
    warm = warmup_requests(threads, total_requests)
    warm_wall = run_phase(warm, 0, timeout_s=1800)
    print(f"warmup: {warm} requests in {warm_wall:.1f}s", flush=True)
    latencies.clear()
    errors.clear()

    wall = run_phase(total_requests, warm, timeout_s=300)
    lat = np.sort(np.asarray(latencies, np.float64))
    if not len(lat):
        lat = np.asarray([float("nan")])
    return {
        "requests_ok": len(latencies),
        "errors": len(errors),
        "wall_s": round(wall, 2),
        "qps": round(len(latencies) / wall, 1),
        "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 1),
        "p90_ms": round(float(np.percentile(lat, 90)) * 1e3, 1),
        "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 1),
    }, errors[:3]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rows", type=int, default=1_000_000)
    parser.add_argument("--dim", type=int, default=1536)
    parser.add_argument("--threads", type=int, default=16)
    parser.add_argument("--requests", type=int, default=2000)
    parser.add_argument("--quantized", action="store_true")
    parser.add_argument("--index-type", default="flat", choices=["flat", "ivf"])
    parser.add_argument(
        "--window-ms", type=float, default=3.0,
        help="micro-batch linger window; batches grow with it "
        "(QPS ~ batch_size / (scan time + window))",
    )
    parser.add_argument(
        "--pipeline", type=int, default=2,
        help="in-flight batch depth (SEARCH_MICROBATCH_PIPELINE)",
    )
    parser.add_argument(
        "--host-corpus", action="store_true",
        help="build via the production add_batch upload path (the JAX "
        "script's rows) instead of on-device generation",
    )
    parser.add_argument(
        "--fake-device-ms", type=float, default=0.0,
        help="STACK-ONLY mode: replace the device scan with a stub that "
        "sleeps this long per batch (GIL released) and returns valid "
        "indices, measuring the serving stack's own ceiling with a device "
        "of that latency; runs on the host",
    )
    parser.add_argument(
        "--keyword", action="store_true",
        help="HYBRID mode: also build a real BM25 keyword index over the "
        "same corpus (scene/subject text matching the load queries) so "
        "the measured route is the two-channel fusion path",
    )
    return parser.parse_args(argv)


def measure(args):
    """Build the stack, serve it, send one request, run the load.  Returns
    ``(stats, error sample, server, port, vector_index)``; the server is
    still up (the caller shuts it down)."""
    app, vector_index, build_s = build_stack(
        args.rows, args.dim, args.quantized, args.index_type,
        host_corpus=args.host_corpus, window_ms=args.window_ms,
        pipeline=args.pipeline, fake_device_ms=args.fake_device_ms,
        keyword_rows=args.rows if args.keyword else 0,
    )
    print(f"corpus built: {args.rows}×{args.dim} in {build_s:.1f}s")
    server, port = serve(app)
    # one blocking request before the clock starts: it builds the kernels
    # on first use and, for --index-type ivf, the IVF index and its nprobe
    t0 = time.perf_counter()
    post_search(port, "预热 编译", timeout_s=1800)
    print(f"first request: {time.perf_counter() - t0:.1f}s")
    ivf = getattr(vector_index, "_ivf", None)
    if ivf is not None:
        print(f"ivf build seconds {getattr(ivf, 'build_seconds', {})}, "
              f"autotune {vector_index._ivf_autotune_report}")

    stats, err_sample = run_load(port, args.threads, args.requests)
    batcher = getattr(vector_index, "_microbatcher", None)
    stats.update(
        rows=args.rows,
        dim=args.dim,
        threads=args.threads,
        quantized=bool(args.quantized),
        index_type=args.index_type,
        window_ms=args.window_ms,
        pipeline=args.pipeline,
        fake_device_ms=args.fake_device_ms,
        keyword=bool(args.keyword),
        route=vector_index.last_route,
    )
    if batcher is not None and batcher.batches_run:
        # served requests per device scan: the aggregation the serving
        # stack controls
        stats["scan_batches"] = batcher.batches_run
        stats["avg_scan_batch"] = round(
            batcher.requests_served / batcher.batches_run, 1
        )
    return stats, err_sample, server, port, vector_index


def main(argv=None) -> int:
    args = parse_args(argv)
    stats, err_sample, server, _, vector_index = measure(args)
    server.shutdown()
    server.server_close()
    vector_index._microbatcher.close()
    for key in ("qps", "p50_ms", "p90_ms", "p99_ms", "requests_ok", "errors"):
        print(f"{key:14s} {stats[key]}")
    if err_sample:
        print("sample errors:", err_sample)
    print(json.dumps(stats))
    return 0 if not stats["errors"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Multi-process dry-runs: the distributed tier, proven on one machine.

Counterpart of ``photo_search_engine_tpu/parallel/multihost.py``.  Every
worker is its own process joined into one ``torch.distributed`` job over
TCP on localhost (``parallel/sharded.init_distributed``: gloo on the host
and where ranks share a card, NCCL device collectives where each rank has
a card of its own), exactly as ranks on several hosts would join:

* :func:`worker_main` — the bare sharded search: every rank derives the
  same seeded corpus, uploads ONLY its own rows to its shards, and checks
  the gathered result against a numpy oracle of the whole corpus;
* :func:`worker_serving_main` — ``VectorIndex`` over the job's mesh:
  appends (the second one the incremental tail sync), exact, masked, IVF
  (autotuned, masked, appended) and int8 searches against the oracle;
* :func:`worker_http_main` — rank 0 serves HTTP over an
  ``SPMDVectorIndex``, the other ranks replay its ops;
* :func:`launch_dryrun` spawns the workers of one of those modes;
  :func:`launch_app_dryrun` spawns instances of the real server entry point
  (``python -m photo_search_engine_tpu_torch.api.app``) joined through
  ``DIST_*`` and drives rank 0 over HTTP.

Each launcher kills every child it started when one fails or the time
limit passes, and returns True only when every rank passed.

Run:        python -m photo_search_engine_tpu_torch.parallel.multihost [--serving | --http] [--device cuda]
As a worker: python -m photo_search_engine_tpu_torch.parallel.multihost \\
                 --coordinator 127.0.0.1:PORT --num-processes 2 --process-id 0 --local-devices 4
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
from typing import List, Optional

import numpy as np

_OK_MARKER = "MULTIHOST_DRYRUN_OK"
_SERVING_OK_MARKER = "MULTIHOST_SERVING_OK"
_HTTP_OK_MARKER = "MULTIHOST_HTTP_OK"
_BACKEND = re.compile(r"device collectives on (\w+)")


def _join(coordinator: str, num_processes: int, process_id: int, device: str):
    from photo_search_engine_tpu_torch.parallel.sharded import init_distributed

    return init_distributed(f"tcp://{coordinator}", num_processes, process_id, device)


def _oracle(corpus: np.ndarray, queries: np.ndarray, k: int):
    scores = queries @ corpus.T
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, idx, axis=1), idx


def worker_main(coordinator: str, num_processes: int, process_id: int, local_devices: int = 4,
                rows: int = 1024, dim: int = 64, k: int = 10, device: str = "cpu") -> None:
    """One rank of the bare sharded search; prints the OK marker after the
    gathered result matched the oracle of the whole corpus."""
    import torch

    from photo_search_engine_tpu_torch.parallel.sharded import make_mesh, sharded_exact_search, shutdown_distributed

    context = _join(coordinator, num_processes, process_id, device)
    try:
        mesh = make_mesh(devices=[context.device] * local_devices)
        assert mesh.n_shards == num_processes * local_devices, mesh
        # the same corpus on every rank (one seed); each uploads only its rows
        rng = np.random.default_rng(0)
        corpus = rng.normal(size=(rows, dim)).astype(np.float32)
        queries = rng.normal(size=(8, dim)).astype(np.float32)
        per_shard = rows // mesh.n_shards
        local = [torch.from_numpy(corpus[s * per_shard : (s + 1) * per_shard]).to(dev)
                 for s, dev in zip(mesh.local_shards, mesh.devices)]
        vals, idx = sharded_exact_search(local, queries, k, mesh, metric="ip")
        want_v, want_i = _oracle(corpus, queries, k)
        np.testing.assert_allclose(vals.cpu().numpy(), want_v, rtol=1e-5, atol=1e-5)
        agree = float((idx.cpu().numpy() == want_i).mean())  # ids may differ only inside exact ties
        assert agree >= 0.99, f"index agreement {agree}"
        print(f"{_OK_MARKER} process={process_id} shards={mesh.n_shards} backend={context.backend}", flush=True)
    finally:
        shutdown_distributed()


def worker_serving_main(coordinator: str, num_processes: int, process_id: int, local_devices: int = 4,
                        rows: int = 1024, dim: int = 32, k: int = 10, device: str = "cpu") -> None:
    """The serving slice of one rank: ``VectorIndex.search_batch`` (store →
    per-shard kernels → gathered merge → metadata) over the job's mesh,
    every rank running the same calls in the same order."""
    from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
    from photo_search_engine_tpu_torch.parallel.sharded import shutdown_distributed

    context = _join(coordinator, num_processes, process_id, device)
    try:
        n_shards = num_processes * local_devices
        rng = np.random.default_rng(0)
        corpus = rng.normal(size=(rows, dim)).astype(np.float32)
        queries = rng.normal(size=(8, dim)).astype(np.float32)
        tmp = tempfile.mkdtemp(prefix=f"mh_serving_{process_id}_")
        paths = lambda name: dict(index_path=f"{tmp}/{name}.index", metadata_path=f"{tmp}/{name}-meta.json")  # noqa: E731
        metas = lambda a, b: [{"photo_path": f"/p/{i}.jpg"} for i in range(a, b)]  # noqa: E731
        vi = VectorIndex(dimension=dim, metric="cosine", mesh_devices=n_shards, device=context.device, **paths("mh"))
        split = rows // 2
        vi.add_batch(corpus[:split], metas(0, split))
        vi.search(corpus[0].tolist(), 1)  # the first sync
        vi.add_batch(corpus[split:], metas(split, rows))  # the incremental tail sync
        shards = vi._store._sharded._device
        assert len(shards) == local_devices and all(t.device == context.device for t in shards), \
            "the store holds shards this rank should not"

        unit = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
        scores = (queries / np.linalg.norm(queries, axis=1, keepdims=True)) @ unit.T
        oracle = np.argsort(-scores, axis=1, kind="stable")[:, :k]

        def paths_of(hits):
            return [h["metadata"]["photo_path"] for h in hits]

        for qi, hits in enumerate(vi.search_batch(queries, k)):
            assert paths_of(hits) == [f"/p/{j}.jpg" for j in oracle[qi]], f"query {qi}"
        mask = np.zeros(rows, bool)
        mask[100:300] = True
        masked_scores = np.where(mask, scores[0], -np.inf)
        want_masked = [f"/p/{j}.jpg" for j in np.argsort(-masked_scores, kind="stable")[:k]]
        assert paths_of(vi.search_masked(queries[0].tolist(), k, mask)) == want_masked, "masked"

        # IVF on the job's mesh: the lazy build is the same on every rank;
        # autotune on iid rows escalates to the full probe, so hits equal the oracle
        vi_ivf = VectorIndex(dimension=dim, metric="cosine", mesh_devices=n_shards, index_type="ivf",
                             ivf_nlist=16, ivf_nprobe=0, device=context.device, **paths("mh_ivf"))
        vi_ivf.add_batch(corpus, metas(0, rows))
        batches = vi_ivf.search_batch(queries, k)
        assert vi_ivf.last_route["impl"] == "ivf", vi_ivf.last_route
        for qi, hits in enumerate(batches):
            assert paths_of(hits) == [f"/p/{j}.jpg" for j in oracle[qi]], f"ivf query {qi}"
        assert paths_of(vi_ivf.search_masked(queries[0].tolist(), k, mask)) == want_masked, "ivf masked"
        assert vi_ivf.last_route["impl"] == "ivf_masked", vi_ivf.last_route
        probe = rng.normal(size=(1, dim)).astype(np.float32)
        vi_ivf.add_batch(probe, [{"photo_path": "/p/new.jpg"}])  # appended into the trained lists
        hits = vi_ivf.search(probe[0].tolist(), 1)
        assert hits and hits[0]["metadata"]["photo_path"] == "/p/new.jpg", hits

        vi_i8 = VectorIndex(dimension=dim, metric="cosine", mesh_devices=n_shards, quantized=True,
                            device=context.device, **paths("mh_i8"))
        vi_i8.add_batch(corpus, metas(0, rows))
        batches = vi_i8.search_batch(queries, k)
        assert vi_i8.last_route["impl"] == "int8", vi_i8.last_route
        overlap = np.mean([len(set(paths_of(hits)) & {f"/p/{j}.jpg" for j in oracle[qi]}) / k
                           for qi, hits in enumerate(batches)])
        assert overlap >= 0.9, f"int8 recall {overlap}"
        shutil.rmtree(tmp, ignore_errors=True)
        print(f"{_SERVING_OK_MARKER} process={process_id} shards={n_shards} backend={context.backend}", flush=True)
    finally:
        shutdown_distributed()


def worker_http_main(coordinator: str, num_processes: int, process_id: int, local_devices: int = 4,
                     rows: int = 512, dim: int = 32, k: int = 5, device: str = "cpu") -> None:
    """Multi-process HTTP serving: rank 0 runs the single-process stack
    (searcher → micro-batcher → WSGI app → HTTP listener) over an
    ``SPMDVectorIndex``; every other rank replays the fanned-out ops."""
    import threading

    from photo_search_engine_tpu_torch.parallel.sharded import shutdown_distributed
    from photo_search_engine_tpu_torch.parallel.spmd_serving import SPMDVectorIndex

    context = _join(coordinator, num_processes, process_id, device)
    try:
        n_shards = num_processes * local_devices
        tmp = tempfile.mkdtemp(prefix=f"mh_http_{process_id}_")
        vi = SPMDVectorIndex(dimension=dim, index_path=f"{tmp}/mh.index", metadata_path=f"{tmp}/mh-meta.json",
                             metric="cosine", mesh_devices=n_shards, device=context.device)
        if process_id != 0:
            replayed = vi.follow()
            assert vi.get_total_items() == rows, f"the follower holds {vi.get_total_items()} rows, want {rows}"
            assert replayed >= 7, f"only {replayed} ops replayed"  # 2 adds, 3 HTTP searches, masked, grouped
            print(f"{_HTTP_OK_MARKER} process={process_id} replayed={replayed}", flush=True)
            return

        from socketserver import ThreadingMixIn
        from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

        from photo_search_engine_tpu_torch.api.app import create_app
        from photo_search_engine_tpu_torch.core.batcher import attach_microbatcher
        from photo_search_engine_tpu_torch.core.searcher import Searcher
        from photo_search_engine_tpu_torch.models.hash_embedder import HashingEmbeddingService
        from photo_search_engine_tpu_torch.services.time_parser import TimeParser

        embedding = HashingEmbeddingService(dimension=dim, device=context.device)
        texts = [f"照片 场景 {i}" for i in range(rows)]
        vecs = np.stack([np.asarray(embedding.generate_embedding(t), np.float32) for t in texts])
        metas = [{"photo_path": f"/p/{i}.jpg", "description": texts[i]} for i in range(rows)]
        vi.add_batch(vecs[: rows // 2], metas[: rows // 2])
        vi.add_batch(vecs[rows // 2 :], metas[rows // 2 :])  # the incremental tail sync, replayed
        searcher = Searcher(embedding=embedding, time_parser=TimeParser(backend="local"), vector_index=vi,
                            keyword_index=None, data_dir=tmp, top_k=k, query_expansion_enabled=False,
                            query_multi_round_enabled=False, query_reflection_enabled=False,
                            query_cache_enabled=False, embedding_cache_enabled=False)
        searcher.index_loaded = True
        attach_microbatcher(vi, max_batch=16, window_s=0.002)

        class _ReadyIndexer:
            def get_status(self):
                return {"status": "ready", "message": "spmd corpus", "total_count": rows,
                        "indexed_count": rows, "failed_count": 0}

        app = create_app({"config": {"TOP_K": k, "DEFAULT_SEARCH_MODE": "fast"}, "indexer": _ReadyIndexer(),
                          "searcher": searcher, "text_rerank_service": None, "visual_rerank_service": None})

        class QuietHandler(WSGIRequestHandler):
            def log_message(self, *args):
                pass

        class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
            daemon_threads = True
            request_queue_size = 128

        server = make_server("127.0.0.1", _free_port(), app, server_class=ThreadingWSGIServer,
                             handler_class=QuietHandler)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        unit = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)

        def row_of(path: str) -> int:
            return int(path.rsplit("/", 1)[1].split(".")[0])

        try:
            # hash embeddings near-tie at small widths: hold the top hit's
            # score to the oracle's best, not its identity
            for qi in (3, 71, 200):
                payload = _post(f"http://127.0.0.1:{server.server_port}", "/search_photos",
                                {"query": texts[qi], "top_k": k})
                got = [r["photo_path"] for r in payload["results"]]
                qv = np.asarray(embedding.generate_embedding(texts[qi]), np.float32)
                sims = unit @ (qv / np.linalg.norm(qv))
                assert got, f"q{qi}: empty results"
                assert float(sims[row_of(got[0])]) >= float(sims.max()) - 1e-5, f"q{qi}: {got[0]}"
            mask = np.zeros(rows, bool)
            mask[64:256] = True
            scores = np.where(mask, unit @ unit[70], -np.inf)
            hits = vi.search_masked(vecs[70].tolist(), k, mask)
            top = row_of(hits[0]["metadata"]["photo_path"])
            assert mask[top] and float(scores[top]) >= float(scores.max()) - 1e-5, hits[0]
            _, gidx = vi.raw_grouped_search_batch(vecs[70:72], k, np.stack([mask, ~mask]), np.asarray([0, 1]))
            g0 = int(gidx[0, 0])
            assert mask[g0] and float(scores[g0]) >= float(scores.max()) - 1e-5, g0
        finally:
            server.shutdown()
            vi._microbatcher.close()
            vi.shutdown_followers()
        print(f"{_HTTP_OK_MARKER} process=0 shards={n_shards} backend={context.backend}", flush=True)
    finally:
        shutdown_distributed()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(base: str, path: str, payload: dict, timeout: float = 120) -> dict:
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _kill_all(procs: List[subprocess.Popen]) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
    for proc in procs:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def _wait_all(procs: List[subprocess.Popen], deadline: float) -> bool:
    """Wait for every process until ``deadline``; False (and every one
    killed) when one failed or the time ran out."""
    pending = list(procs)
    while pending:
        for proc in list(pending):
            if proc.poll() is not None:
                pending.remove(proc)
                if proc.returncode != 0:
                    _kill_all(procs)
                    return False
        if time.time() > deadline:
            _kill_all(procs)
            return False
        time.sleep(0.1)
    return True


def _read(path: str) -> str:
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            return f.read()
    except OSError:
        return ""


def launch_dryrun(num_processes: int = 2, local_devices: int = 4, timeout: float = 120.0,
                  port: Optional[int] = None, serving: bool = False, http: bool = False,
                  device: str = "cpu") -> bool:
    """Spawn ``num_processes`` workers on localhost (``worker_main``, or
    ``worker_serving_main`` / ``worker_http_main``) on ``device`` ("cpu", or
    "cuda": rank r takes card r % count) and check that every one passed.
    Prints each rank's output on failure, and the collectives' backend."""
    rows = 512 if http else 1024
    if rows % (num_processes * local_devices):
        raise ValueError(f"corpus rows ({rows}) must divide evenly by num_processes x local_devices "
                         f"({num_processes} x {local_devices})")
    port = port or _free_port()
    marker, flags = ((_HTTP_OK_MARKER, ["--http"]) if http else
                     (_SERVING_OK_MARKER, ["--serving"]) if serving else (_OK_MARKER, []))
    root = tempfile.mkdtemp(prefix="mh_dryrun_")
    env = dict(os.environ, PSE_PLATFORM=device)
    logs = [os.path.join(root, f"rank{pid}.log") for pid in range(num_processes)]
    procs: List[subprocess.Popen] = []
    try:
        for pid in range(num_processes):
            with open(logs[pid], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "photo_search_engine_tpu_torch.parallel.multihost",
                     "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(num_processes),
                     "--process-id", str(pid), "--local-devices", str(local_devices), "--device", device] + flags,
                    env=env, stdout=log, stderr=subprocess.STDOUT, text=True))
        ok = _wait_all(procs, time.time() + timeout)
        outs = [_read(path) for path in logs]
        ok = ok and all(marker in out for out in outs)
        backend = _BACKEND.search(outs[0])
        print(f"[multihost] {num_processes} ranks x {local_devices} shards on {device}, device collectives on "
              f"{backend.group(1) if backend else 'unknown'}: {'OK' if ok else 'FAILED'}", flush=True)
        if not ok:
            for pid, out in enumerate(outs):
                print(f"--- rank {pid} (rc={procs[pid].returncode}) ---\n{out or '<no output>'}", flush=True)
        return ok
    finally:
        _kill_all(procs)
        shutil.rmtree(root, ignore_errors=True)


def _write_photos(photo_dir: str, n_photos: int) -> None:
    from PIL import Image

    colors = [(200, 30, 30), (30, 200, 30), (30, 30, 200), (220, 220, 40)]
    for i in range(n_photos):
        img = Image.new("RGB", (48, 36), colors[i % len(colors)])
        exif = Image.Exif()
        exif[306] = f"2024:0{1 + i % 8}:15 12:00:00"
        img.save(os.path.join(photo_dir, f"photo_{i}.jpg"), exif=exif)


def launch_app_dryrun(num_processes: int = 2, local_devices: int = 4, timeout: float = 120.0,
                      n_photos: int = 4, device: str = "cpu") -> bool:
    """The multi-process deployment: ``num_processes`` instances of ``python
    -m photo_search_engine_tpu_torch.api.app`` joined through ``DIST_*``
    (``MESH_DEVICES`` = ranks x ``local_devices``, ``VECTOR_INDEX_TYPE=ivf``,
    nprobe autotuned), driven over HTTP on rank 0: ``/init_index`` on a
    PIL photo directory, ``/index_status`` until ready, ``/search_photos``
    (the ivf route, then a time-filtered one); SIGINT releases the
    followers, whose replay counts must be above 0."""
    root = tempfile.mkdtemp(prefix="mh_app_")
    photo_dir, data_dir = os.path.join(root, "photos"), os.path.join(root, "data")
    os.makedirs(photo_dir)
    os.makedirs(data_dir)
    _write_photos(photo_dir, n_photos)
    http_port = _free_port()
    base_env = dict(
        os.environ, PSE_PLATFORM=device, DIST_COORDINATOR=f"127.0.0.1:{_free_port()}",
        DIST_NUM_PROCESSES=str(num_processes), PHOTO_DIR=photo_dir, DATA_DIR=data_dir,
        RUNTIME_DATA_DIR=data_dir, SERVER_HOST="127.0.0.1", SERVER_PORT=str(http_port),
        EMBEDDING_DIMENSION="64", MESH_DEVICES=str(num_processes * local_devices),
        INDEX_BACKGROUND_MODE="thread", VECTOR_INDEX_TYPE="ivf", IVF_NLIST="8", IVF_NPROBE="0",
    )
    logs = [os.path.join(root, f"rank{pid}.log") for pid in range(num_processes)]
    procs: List[subprocess.Popen] = []
    deadline = time.time() + timeout

    def fail(why: str) -> bool:
        print(f"[multihost-app] FAIL: {why}", flush=True)
        for pid, path in enumerate(logs):
            print(f"--- rank {pid} log ---\n{_read(path) or '<empty>'}", flush=True)
        return False

    try:
        for pid in range(num_processes):
            with open(logs[pid], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "photo_search_engine_tpu_torch.api.app"],
                    env=dict(base_env, DIST_PROCESS_ID=str(pid)), stdout=log, stderr=subprocess.STDOUT, text=True))
        while "serving on http://" not in _read(logs[0]):
            if time.time() > deadline or any(p.poll() is not None for p in procs):
                return fail("rank 0 never started serving")
            time.sleep(0.25)
        base = f"http://127.0.0.1:{http_port}"
        try:
            _post(base, "/init_index", {"mode": "full"})
            while True:
                with urllib.request.urlopen(f"{base}/index_status", timeout=30) as r:
                    status = json.loads(r.read())
                state = str(status.get("status") or "")
                if state in {"ready", "success", "completed"}:
                    break
                if state in {"failed", "error"} or time.time() > deadline:
                    return fail(f"indexing ended in state {state!r}: {status}")
                time.sleep(0.25)
            payload = _post(base, "/search_photos", {"query": "红色 照片", "top_k": 3})
            if not payload.get("results"):
                return fail(f"empty search results: {payload}")
            route = (payload.get("search_debug") or {}).get("index_route") or {}
            if route.get("impl") != "ivf" or route.get("mesh_devices") != num_processes * local_devices:
                return fail(f"expected the ivf route on the mesh, served {route}")
            _post(base, "/search_photos", {"query": "一月 的 照片", "top_k": 3})  # the time-filtered path
        except (OSError, ValueError) as exc:
            return fail(f"the launcher failed: {exc!r}")
        procs[0].send_signal(signal.SIGINT)
        if not _wait_all(procs, deadline):
            return fail("a rank failed or did not exit after SIGINT")
        replayed = [re.search(r"replayed (\d+) ops", _read(path)) for path in logs[1:]]
        if not all(m and int(m.group(1)) > 0 for m in replayed):
            return fail("a follower replayed no op")
        backend = _BACKEND.search(_read(logs[0]))
        print(f"[multihost-app] {num_processes} ranks on {device}, device collectives on "
              f"{backend.group(1) if backend else 'unknown'}; follower replays "
              f"{[int(m.group(1)) for m in replayed]}: OK", flush=True)
        return True
    finally:
        _kill_all(procs)
        shutil.rmtree(root, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--coordinator")
    parser.add_argument("--num-processes", type=int, default=2)
    parser.add_argument("--process-id", type=int)
    parser.add_argument("--local-devices", type=int, default=4)
    parser.add_argument("--device", default="cpu", help="cpu, or cuda (rank r takes card r % count)")
    parser.add_argument("--serving", action="store_true", help="the VectorIndex serving slice")
    parser.add_argument("--http", action="store_true", help="the HTTP serving slice (rank-0 listener + fan-in)")
    args = parser.parse_args(argv)
    if args.coordinator is not None and args.process_id is not None:
        worker = worker_http_main if args.http else worker_serving_main if args.serving else worker_main
        worker(args.coordinator, args.num_processes, args.process_id, args.local_devices, device=args.device)
        return 0
    ok = launch_dryrun(args.num_processes, args.local_devices, serving=args.serving, http=args.http,
                       device=args.device)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

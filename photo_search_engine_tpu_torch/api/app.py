"""Composition root + server entry point of the PyTorch port.

Counterpart of ``photo_search_engine_tpu/api/app.py``: ``initialize_services``
builds every service from the config, ``create_app`` registers the routes,
``main`` serves them.  The host modules (config, routes, WSGI, searcher,
indexer, keyword index, time parser, query formatter, vision) are this
package's copies of the JAX package's, which differ only in their import
lines; the port imports nothing of the JAX package.

Both profiles of the JAX app are served on one device:

* offline: the hashing embedder, the local text and visual reranks;
* online: an OpenAI-compatible embedding backend (``EMBEDDING_BACKEND=
  openai``, or ``auto`` with ``EMBEDDING_BASE_URL``), the API text rerank
  (``TEXT_RERANK_BACKEND`` ``api`` or ``chat``, or ``auto`` with
  ``TEXT_RERANK_BASE_URL``) and the LLM visual rerank
  (``VISUAL_RERANK_BASE_URL`` with ``VISUAL_RERANK_API_KEY``).

Each rerank service is built inside try/except: one that fails to build
is served as ``None`` with a ``[WARN]`` line, as in the JAX app.  The
micro-batcher (``SEARCH_MICROBATCH_ENABLED``, on by default) coalesces
concurrent scans into one device scan and concurrent query embeds into
one ``generate_embedding_batch`` call (one ``/v1/embeddings`` request
with a list input on the online profile).  Both vector indexes are
served: ``VECTOR_INDEX_TYPE=flat`` and ``ivf`` (``hnsw`` maps to
``ivf``; ``IVF_NLIST``, ``IVF_NPROBE`` and ``IVF_TARGET_RECALL`` as in the
JAX app).

``MESH_DEVICES`` row-shards the corpus over a mesh (``parallel/``): 0 one
device, N the first N cards (clamped, with a warning, to those visible),
-1 every visible card; the host holds any number of logical shards (-1
there is one a process).  ``DIST_COORDINATOR`` (``host:port``),
``DIST_NUM_PROCESSES`` and ``DIST_PROCESS_ID`` join a ``torch.distributed``
job (``parallel/sharded.init_distributed``): rank 0 serves HTTP over an
``SPMDVectorIndex`` and the other ranks replay its device ops
(``parallel/spmd_serving.py``).

Run:  PSE_PLATFORM=gpu python -m photo_search_engine_tpu_torch.api.app
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
from typing import Any, Dict, Optional, Tuple

import torch

from photo_search_engine_tpu_torch.api.routes import register_routes
from photo_search_engine_tpu_torch.api.wsgi import App
from photo_search_engine_tpu_torch.config import get_config
from photo_search_engine_tpu_torch.config import load_config as _load_env_config
from photo_search_engine_tpu_torch.config import reset_config_cache
from photo_search_engine_tpu_torch.core.indexer import Indexer
from photo_search_engine_tpu_torch.core.keyword_index import KeywordIndex
from photo_search_engine_tpu_torch.core.searcher import Searcher
from photo_search_engine_tpu_torch.services.query_formatter import QueryFormatter
from photo_search_engine_tpu_torch.services.time_parser import TimeParser
from photo_search_engine_tpu_torch.services.vision import LocalVisionService, OpenAIVisionService
from photo_search_engine_tpu_torch.core.batcher import BatchedEmbeddingService, attach_microbatcher
from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
from photo_search_engine_tpu_torch.device import resolve_device
from photo_search_engine_tpu_torch.models.hash_embedder import HashingEmbeddingService
from photo_search_engine_tpu_torch.parallel.sharded import distributed, init_distributed, shutdown_distributed
from photo_search_engine_tpu_torch.services.embedding import (
    DeviceTextRerankService,
    OpenAICompatibleEmbeddingService,
    TextRerankService,
)
from photo_search_engine_tpu_torch.services.rerank import LocalVisualRerankService, VisualRerankService

def load_config(overrides: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """The runtime configuration (environment + ``.env``), with
    ``overrides`` laid over the environment for this call only.  It also
    keeps ``PSE_PLATFORM``, which ``initialize_services`` would otherwise
    read from the environment."""
    saved = dict(os.environ)
    os.environ.update(overrides or {})
    try:
        reset_config_cache()
        config = _load_env_config()
        config["PSE_PLATFORM"] = os.environ.get("PSE_PLATFORM")
        return config
    finally:
        os.environ.clear()
        os.environ.update(saved)
        reset_config_cache()


def _build_embedding_service(config: Dict[str, Any], device):
    backend = str(config.get("EMBEDDING_BACKEND") or "auto").strip().lower()
    if backend == "auto":
        backend = "openai" if config.get("EMBEDDING_BASE_URL") else "local"
    if backend == "openai":
        return OpenAICompatibleEmbeddingService(
            api_key=config.get("EMBEDDING_API_KEY") or "",
            model_name=config["EMBEDDING_MODEL"],
            base_url=config["EMBEDDING_BASE_URL"],
            timeout=config["TIMEOUT"],
            max_retries=config["MAX_RETRIES"],
            dimension=config.get("EMBEDDING_DIMENSION"),
        )
    return HashingEmbeddingService(dimension=config.get("EMBEDDING_DIMENSION") or 1536, device=device)


def _build_text_rerank_service(config: Dict[str, Any], device):
    backend = str(config.get("TEXT_RERANK_BACKEND") or "auto").strip().lower()
    if backend in {"api", "chat"} or (backend == "auto" and config.get("TEXT_RERANK_BASE_URL")):
        return TextRerankService(
            api_key=config.get("TEXT_RERANK_API_KEY") or "",
            model_name=config["TEXT_RERANK_MODEL"],
            base_url=config["TEXT_RERANK_BASE_URL"],
            timeout=config["TEXT_RERANK_TIMEOUT"],
            max_retries=config["MAX_RETRIES"],
            backend=backend,
        )
    # device: deterministic embedding cross-similarity
    return DeviceTextRerankService(dimension=config.get("EMBEDDING_DIMENSION") or 1536, device=device)


def _build_visual_rerank_service(config: Dict[str, Any], device):
    if config.get("VISUAL_RERANK_BASE_URL") and config.get("VISUAL_RERANK_API_KEY"):
        return VisualRerankService(
            api_key=config["VISUAL_RERANK_API_KEY"],
            model_name=config["VISUAL_RERANK_MODEL"],
            base_url=config["VISUAL_RERANK_BASE_URL"],
            reasoning_effort=config["VISUAL_RERANK_REASONING_EFFORT"],
            timeout=config["VISUAL_RERANK_TIMEOUT"],
            max_retries=config["MAX_RETRIES"],
            image_max_size=config["RERANK_IMAGE_MAX_SIZE"],
            image_quality=config["RERANK_IMAGE_QUALITY"],
            image_format=config["RERANK_IMAGE_FORMAT"],
            max_images=config["RERANK_MAX_IMAGES"],
        )
    return LocalVisualRerankService(dimension=config.get("EMBEDDING_DIMENSION") or 1536, device=device)


def _build_vision_service(config: Dict[str, Any]):
    backend = str(config.get("VISION_BACKEND") or "auto").strip().lower()
    if backend == "auto":
        backend = (
            "openai" if config.get("VISION_BASE_URL") and config.get("VISION_API_KEY") else "local"
        )
    if backend == "openai":
        return OpenAIVisionService(
            api_key=config.get("VISION_API_KEY") or "",
            model_name=config["VISION_MODEL"],
            base_url=config["VISION_BASE_URL"],
            timeout=config["TIMEOUT"],
            max_retries=config["MAX_RETRIES"],
            image_max_size=config["IMAGE_MAX_SIZE"],
            image_quality=config["IMAGE_QUALITY"],
            image_format=config["IMAGE_FORMAT"],
            reasoning_effort=config["VISION_REASONING_EFFORT"],
            enhanced_reasoning_effort=config["VISION_ENHANCED_REASONING_EFFORT"],
            base_max_output_tokens=config["VISION_BASE_MAX_TOKENS"],
            enhanced_max_output_tokens=config["VISION_ENHANCED_MAX_TOKENS"],
            repair_max_output_tokens=config["VISION_REPAIR_MAX_TOKENS"],
            enhanced_analysis_enabled=config["ENHANCED_ANALYSIS_ENABLED"],
        )
    return LocalVisionService()


def _resolve_mesh_devices(requested, device) -> int:
    """``MESH_DEVICES``: 0 one device, N >= 1 a mesh of N shards, -1 every
    visible device.  On CUDA the visible devices are the cards (one a rank
    in a ``torch.distributed`` job), and N above them is clamped with the
    JAX app's warning; the host holds any number of logical shards, and -1
    there is one a process."""
    requested = int(requested or 0)
    if requested == 0:
        return 0
    context = distributed()
    world = context.world if context else 1
    if torch.device(device).type != "cuda":
        return requested if requested > 0 else world
    available = world if context else torch.cuda.device_count()
    if requested < 0:
        return available
    if requested > available:
        print(f"[WARN] MESH_DEVICES={requested} but only {available} device(s) visible; using {available}")
        return available
    return requested


def _vector_index_class_and_knobs(config: Dict[str, Any], device):
    """``VectorIndex`` in one process; in a ``torch.distributed`` job
    ``SPMDVectorIndex`` (the rank-0 fan-in), whose mesh must span every
    rank (``MESH_DEVICES=0`` there takes one shard a rank, with a warning).
    ``index_type`` passes through: the IVF build is the same on every rank
    (replicated host mirror, seeded k-means, the same collectives in the
    same order)."""
    mesh_devices = _resolve_mesh_devices(config.get("MESH_DEVICES", 0), device)
    context = distributed()
    if context is None or context.world <= 1:
        return VectorIndex, mesh_devices
    from photo_search_engine_tpu_torch.parallel.spmd_serving import SPMDVectorIndex

    if mesh_devices == 0:
        mesh_devices = context.world
        print(f"[WARN] multi-process run with MESH_DEVICES=0; using one shard a rank ({mesh_devices})")
    return SPMDVectorIndex, mesh_devices


def initialize_services(
    config: Optional[Dict[str, Any]] = None,
    device=None,
    vector_index: Optional[VectorIndex] = None,
) -> Dict[str, Any]:
    """Construct and wire every service on ``device`` (default: the one
    ``PSE_PLATFORM`` names, see ``device.py``).  ``vector_index``, when
    given, is an index already installed in memory (for example rows
    adopted on the card by ``EmbeddingStore.load_device_rows``): it is
    served as it is instead of one loaded from ``INDEX_PATH``."""
    config = config or get_config()
    device = resolve_device(config.get("PSE_PLATFORM")) if device is None else device
    microbatch = config.get("SEARCH_MICROBATCH_ENABLED")
    batch_options = {
        "max_batch": config.get("SEARCH_MICROBATCH_MAX_BATCH", 128),
        "window_s": config.get("SEARCH_MICROBATCH_WINDOW_MS", 3.0) / 1000.0,
        "pipeline": config.get("SEARCH_MICROBATCH_PIPELINE", 2),
    }

    embedding_service = _build_embedding_service(config, device)
    installed = vector_index is not None
    index_cls, mesh_devices = _vector_index_class_and_knobs(config, device)
    vector_index = vector_index if installed else index_cls(
        dimension=config.get("EMBEDDING_DIMENSION"),
        index_path=config["INDEX_PATH"],
        metadata_path=config["METADATA_PATH"],
        metric=config["VECTOR_METRIC"],
        index_type=config["VECTOR_INDEX_TYPE"],
        store_dtype=config.get("STORE_DTYPE", "float32"),
        ivf_nlist=config.get("IVF_NLIST", 1024),
        ivf_nprobe=config.get("IVF_NPROBE", 64),
        ivf_target_recall=config.get("IVF_TARGET_RECALL", 0.98),
        store_block_rows=config.get("TOPK_BLOCK_N") or None,
        quantized=config.get("STORE_QUANTIZED", "auto"),
        mesh_devices=mesh_devices,
        device=device,
    )

    keyword_index = None
    keyword_backend = str(config.get("KEYWORD_BACKEND") or "builtin").lower()
    if keyword_backend == "builtin":
        try:
            keyword_index = KeywordIndex(config["KEYWORD_INDEX_PATH"])
            keyword_index.load()
        except Exception as exc:  # noqa: BLE001 — the keyword channel degrades
            print(f"[WARN] keyword index disabled: {exc}")
            keyword_index = None
    elif keyword_backend == "elasticsearch":
        try:
            from photo_search_engine_tpu_torch.core.es_keyword_index import ElasticsearchKeywordIndex

            keyword_index = ElasticsearchKeywordIndex(
                host=config.get("ELASTICSEARCH_HOST", "localhost"),
                port=config.get("ELASTICSEARCH_PORT", 9200),
                index_name=config.get("ELASTICSEARCH_INDEX", "photo_keywords"),
                username=config.get("ELASTICSEARCH_USERNAME"),
                password=config.get("ELASTICSEARCH_PASSWORD"),
            )
        except Exception as exc:  # noqa: BLE001 — the keyword channel degrades
            print(f"[WARN] elasticsearch keyword backend unavailable: {exc}")
            keyword_index = None

    time_parser = TimeParser(
        api_key=config.get("TIME_PARSE_API_KEY") or "",
        model_name=config["TIME_PARSE_MODEL"],
        base_url=config.get("TIME_PARSE_BASE_URL") or "",
        reasoning_effort=config["TIME_PARSE_REASONING_EFFORT"],
        max_retries=config["MAX_RETRIES"],
        backend=config.get("TIME_PARSE_BACKEND", "auto"),
    )
    query_formatter = None
    if config.get("QUERY_FORMAT_ENABLED", True):
        try:
            query_formatter = QueryFormatter(
                api_key=config.get("QUERY_FORMAT_API_KEY") or "",
                model_name=config["QUERY_FORMAT_MODEL"],
                base_url=config.get("QUERY_FORMAT_BASE_URL") or "",
                reasoning_effort=config["QUERY_FORMAT_REASONING_EFFORT"],
                max_retries=config["MAX_RETRIES"],
                backend=config.get("QUERY_FORMAT_BACKEND", "auto"),
            )
        except Exception as exc:  # noqa: BLE001 — the formatter is optional
            print(f"[WARN] query formatter disabled: {exc}")
            query_formatter = None

    try:
        text_rerank_service = _build_text_rerank_service(config, device)
    except Exception as exc:  # noqa: BLE001 — the rerank is optional
        print(f"[WARN] text rerank disabled: {exc}")
        text_rerank_service = None

    visual_rerank_service = None
    if config.get("VISUAL_RERANK_ENABLED", True):
        try:
            visual_rerank_service = _build_visual_rerank_service(config, device)
        except Exception as exc:  # noqa: BLE001 — the rerank is optional
            print(f"[WARN] visual rerank disabled: {exc}")
            visual_rerank_service = None
    indexer = Indexer(
        photo_dir=config.get("PHOTO_DIR") or "",
        vector_index=vector_index,
        vision_service=_build_vision_service(config),
        embedding_service=embedding_service,
        keyword_index=keyword_index,
        batch_size=config["BATCH_SIZE"],
        max_retries=config["MAX_RETRIES"],
        timeout=config["TIMEOUT"],
        data_dir=config["RUNTIME_DATA_DIR"],
        background_mode=config["INDEX_BACKGROUND_MODE"],
        worker_python_executable=sys.executable,
        worker_entrypoint=["-m", "photo_search_engine_tpu_torch.api.app"],
    )
    # concurrent query embeds coalesce into one batch call (one device
    # embed, or one /v1/embeddings request), as the scans coalesce into one
    # device scan (attach_microbatcher below)
    search_embedding = embedding_service
    if microbatch and embedding_service is not None and hasattr(embedding_service, "generate_embedding_batch"):
        search_embedding = BatchedEmbeddingService(embedding_service, **batch_options)
    searcher = Searcher(
        embedding=search_embedding,
        time_parser=time_parser,
        vector_index=vector_index,
        keyword_index=keyword_index,
        query_formatter=query_formatter,
        data_dir=config["RUNTIME_DATA_DIR"],
        top_k=config["TOP_K"],
        vector_weight=config["VECTOR_WEIGHT"],
        keyword_weight=config["KEYWORD_WEIGHT"],
        query_expansion_enabled=config["QUERY_EXPANSION_ENABLED"],
        query_expansion_max_alternatives=config["QUERY_EXPANSION_MAX_ALTERNATIVES"],
        query_multi_round_enabled=config["QUERY_MULTI_ROUND_ENABLED"],
        query_reflection_enabled=config["QUERY_REFLECTION_ENABLED"],
        query_max_reflection_rounds=config["QUERY_MAX_REFLECTION_ROUNDS"],
        query_dynamic_threshold_floor=config["QUERY_DYNAMIC_THRESHOLD_FLOOR"],
        query_strict_floor_min=config["QUERY_STRICT_FLOOR_MIN"],
        query_broad_floor_min=config["QUERY_BROAD_FLOOR_MIN"],
        time_parse_strategy=config["TIME_PARSE_STRATEGY"],
        validate_file_exists=config["SEARCH_VALIDATE_FILE_EXISTS"],
        query_cache_enabled=config["QUERY_CACHE_ENABLED"],
        query_cache_size=config["QUERY_CACHE_SIZE"],
        embedding_cache_enabled=config["EMBEDDING_CACHE_ENABLED"],
        embedding_cache_size=config["EMBEDDING_CACHE_SIZE"],
        default_search_mode=config["DEFAULT_SEARCH_MODE"],
    )
    if installed:  # an installed index has no files to load
        searcher.index_loaded = True
        searcher._refresh_metadata_cache()
    if microbatch:
        attach_microbatcher(vector_index, **batch_options)
    return {
        "config": config,
        "device": device,
        "embedding_service": embedding_service,
        "vision_service": indexer.vision_service,
        "vector_index": vector_index,
        "keyword_index": keyword_index,
        "time_parser": time_parser,
        "query_formatter": query_formatter,
        "text_rerank_service": text_rerank_service,
        "visual_rerank_service": visual_rerank_service,
        "indexer": indexer,
        "searcher": searcher,
    }


def create_app(services: Optional[Dict[str, Any]] = None) -> App:
    services = services or initialize_services()
    app = App()
    register_routes(
        app,
        indexer=services["indexer"],
        searcher=services["searcher"],
        config=services["config"],
        text_rerank_service=services.get("text_rerank_service"),
        visual_rerank_service=services.get("visual_rerank_service"),
    )
    return app


def _probe_port(host: str, port: int) -> bool:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as probe:
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            probe.bind((host, port))
            return True
        except OSError:
            return False


def pick_port(host: str, preferred: int, attempts: int = 10) -> Tuple[int, bool]:
    """The preferred port, else the next free one."""
    for offset in range(attempts + 1):
        if _probe_port(host, preferred + offset):
            return preferred + offset, offset > 0
    raise OSError(f"no free port near {preferred}")


def _apply_distributed(config: Dict[str, Any]) -> int:
    """Join the ``torch.distributed`` job the ``DIST_*`` triplet names;
    returns this process's rank (0 without one).  Runs before any device
    use: each rank takes its card by rank."""
    coordinator = config.get("DIST_COORDINATOR") or ""
    if not coordinator:
        return 0
    num_processes = int(config.get("DIST_NUM_PROCESSES") or 0)
    process_id = int(config.get("DIST_PROCESS_ID", -1))
    if num_processes < 2 or process_id < 0:
        raise ValueError("DIST_COORDINATOR is set but DIST_NUM_PROCESSES/DIST_PROCESS_ID are not a valid pair")
    init_distributed(f"tcp://{coordinator}", num_processes, process_id, config.get("PSE_PLATFORM"))
    return process_id


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description="photo_search_engine_tpu_torch server")
    parser.add_argument("--index-worker", action="store_true")
    parser.add_argument("--force-rebuild", action="store_true")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    args = parser.parse_args(argv)

    config = load_config()
    if not config.get("PHOTO_DIR"):
        raise ValueError("PHOTO_DIR 未配置，请设置要索引的照片目录")
    if args.index_worker:
        services = initialize_services(config)
        status = services["indexer"].build_index(
            force_rebuild=args.force_rebuild, lock_already_held=True
        )
        return 0 if status.get("status") in {"success", "ready"} else 1
    rank = _apply_distributed(config)
    try:
        return _serve_rank(args, config, initialize_services(config), rank)
    finally:
        shutdown_distributed()


def _serve_rank(args, config: Dict[str, Any], services: Dict[str, Any], rank: int) -> int:
    """Rank 0 (or the only process) serves HTTP; another rank replays rank
    0's device ops until it broadcasts shutdown."""
    index = services["vector_index"]
    if rank != 0:
        print(f"[INFO] dist follower {rank} entering replay loop", flush=True)
        replayed = index.follow()
        print(f"[INFO] dist follower {rank} replayed {replayed} ops", flush=True)
        return 0
    app = create_app(services)
    host = args.host or config["SERVER_HOST"]
    port, fell_back = pick_port(host, args.port or config["SERVER_PORT"])
    if fell_back:
        print(f"[WARN] preferred port busy; falling back to {port}")

    from socketserver import ThreadingMixIn
    from wsgiref.simple_server import WSGIServer, make_server

    class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
        daemon_threads = True
        request_queue_size = 128  # the default backlog of 5 resets bursts

    server = make_server(host, port, app, server_class=ThreadingWSGIServer)
    print(f"[INFO] serving on http://{host}:{port} ({services['device']})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if hasattr(index, "shutdown_followers"):
            index.shutdown_followers()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

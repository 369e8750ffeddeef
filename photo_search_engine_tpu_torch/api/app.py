"""Composition root + server entry point of the PyTorch port.

Counterpart of ``photo_search_engine_tpu/api/app.py``: ``initialize_services``
builds every service from the config, ``create_app`` registers the routes,
``main`` serves them.  The host modules of the JAX package that do not
depend on JAX are reused as they are (config, routes, WSGI, searcher,
indexer, keyword index, time parser, query formatter, vision); the
device-side ones are this package's.

The offline profile is what is ported, with the micro-batcher
(``SEARCH_MICROBATCH_ENABLED``, on by default) wired as in the JAX app,
and both vector indexes: ``VECTOR_INDEX_TYPE=flat`` and ``ivf`` (``hnsw``
maps to ``ivf``; ``IVF_NLIST``, ``IVF_NPROBE`` and ``IVF_TARGET_RECALL``
as in the JAX app).  These configurations raise ``NotImplementedError``
at startup, naming what they wait for in ROADMAP.md: an
OpenAI-compatible embedding backend, an API-backed text or visual rerank,
``MESH_DEVICES != 0`` and ``DIST_*``.

Run:  PSE_PLATFORM=gpu python -m photo_search_engine_tpu_torch.api.app
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
from typing import Any, Dict, Optional, Tuple

from photo_search_engine_tpu.api.routes import register_routes
from photo_search_engine_tpu.api.wsgi import App
from photo_search_engine_tpu.config import get_config
from photo_search_engine_tpu.config import load_config as _load_env_config
from photo_search_engine_tpu.config import reset_config_cache
from photo_search_engine_tpu.core.indexer import Indexer
from photo_search_engine_tpu.core.keyword_index import KeywordIndex
from photo_search_engine_tpu.core.searcher import Searcher
from photo_search_engine_tpu.services.query_formatter import QueryFormatter
from photo_search_engine_tpu.services.time_parser import TimeParser
from photo_search_engine_tpu.services.vision import LocalVisionService, OpenAIVisionService
from photo_search_engine_tpu_torch.core.batcher import BatchedEmbeddingService, attach_microbatcher
from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
from photo_search_engine_tpu_torch.device import resolve_device
from photo_search_engine_tpu_torch.models.hash_embedder import HashingEmbeddingService
from photo_search_engine_tpu_torch.services.embedding import DeviceTextRerankService
from photo_search_engine_tpu_torch.services.rerank import LocalVisualRerankService

_ONLINE = "ROADMAP.md, queue 3: online embedding and rerank services"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch port yet ({item})")


def _check_ported(config: Dict[str, Any]) -> None:
    """Raise for every configuration the port does not serve yet."""
    backend = str(config.get("EMBEDDING_BACKEND") or "auto").strip().lower()
    if backend == "openai" or (backend == "auto" and config.get("EMBEDDING_BASE_URL")):
        raise _not_ported("the OpenAI-compatible embedding backend", _ONLINE)
    backend = str(config.get("TEXT_RERANK_BACKEND") or "auto").strip().lower()
    if backend in {"api", "chat"} or (backend == "auto" and config.get("TEXT_RERANK_BASE_URL")):
        raise _not_ported("the API-backed text rerank", _ONLINE)
    if config.get("VISUAL_RERANK_ENABLED", True) and (
        config.get("VISUAL_RERANK_BASE_URL") and config.get("VISUAL_RERANK_API_KEY")
    ):
        raise _not_ported("the API-backed visual rerank", _ONLINE)
    if int(config.get("MESH_DEVICES") or 0) != 0:
        raise _not_ported("MESH_DEVICES != 0", "ROADMAP.md, queue 3: mesh and multi-host")
    if config.get("DIST_COORDINATOR"):
        raise _not_ported("DIST_* multi-host serving", "ROADMAP.md, queue 3: mesh and multi-host")


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
    _check_ported(config)
    device = resolve_device(config.get("PSE_PLATFORM")) if device is None else device
    dimension = config.get("EMBEDDING_DIMENSION") or 1536
    microbatch = config.get("SEARCH_MICROBATCH_ENABLED")
    batch_options = {
        "max_batch": config.get("SEARCH_MICROBATCH_MAX_BATCH", 128),
        "window_s": config.get("SEARCH_MICROBATCH_WINDOW_MS", 3.0) / 1000.0,
        "pipeline": config.get("SEARCH_MICROBATCH_PIPELINE", 2),
    }

    embedding_service = HashingEmbeddingService(dimension=dimension, device=device)
    installed = vector_index is not None
    vector_index = vector_index if installed else VectorIndex(
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
            from photo_search_engine_tpu.core.es_keyword_index import ElasticsearchKeywordIndex

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

    text_rerank_service = DeviceTextRerankService(dimension=dimension, device=device)
    visual_rerank_service = (
        LocalVisualRerankService(dimension=dimension, device=device)
        if config.get("VISUAL_RERANK_ENABLED", True)
        else None
    )
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
    # concurrent query embeds coalesce into one batch call, as the scans
    # coalesce into one device scan (attach_microbatcher below)
    search_embedding = (
        BatchedEmbeddingService(embedding_service, **batch_options) if microbatch else embedding_service
    )
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
    services = initialize_services(config)
    if args.index_worker:
        status = services["indexer"].build_index(
            force_rebuild=args.force_rebuild, lock_already_held=True
        )
        return 0 if status.get("status") in {"success", "ready"} else 1

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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

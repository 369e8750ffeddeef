"""Environment-driven configuration.

Behavioral parity with reference config.py:1-175 — typed getters, layered
key-fallback chains (generic LLM_* keys fall through to per-service
overrides), cached module-level ``get_config()``.  TPU-specific keys are
added for the device retrieval core (store dtype, kernel block sizes, mesh
shape, index kind).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

try:  # optional, mirrors reference config.py:6-9
    from dotenv import load_dotenv
except ImportError:  # pragma: no cover
    load_dotenv = None

_CONFIG_CACHE: Optional[Dict[str, Any]] = None


_TRUTHY = frozenset({"1", "true", "yes", "on"})


def _env(name, default, parse, kind):
    """Read env var ``name``; empty/unset -> ``default``, else ``parse`` it."""
    raw = os.getenv(name)
    if raw is None or raw == "":
        return default
    try:
        return parse(raw)
    except ValueError as exc:
        raise ValueError(f"{name} must be {kind}") from exc


def _get_int(name: str, default: int) -> int:
    return _env(name, default, int, "an integer")


def _get_float(name: str, default: float) -> float:
    return _env(name, default, float, "a number")


def _get_bool(name: str, default: bool) -> bool:
    return _env(name, default, lambda raw: raw.lower() in _TRUTHY, "a boolean")


def load_config() -> Dict[str, Any]:
    """Load runtime configuration from environment variables (+ .env)."""
    if load_dotenv is not None:
        load_dotenv()

    data_dir = os.getenv("DATA_DIR", "./data")
    runtime_data_dir = os.getenv("RUNTIME_DATA_DIR", data_dir)

    # Key fallback chains (reference config.py:48-68).
    llm_api_key = (
        os.getenv("LLM_API_KEY")
        or os.getenv("SU8_API_KEY")
        or os.getenv("OPENAI_API_KEY")
    )
    llm_base_url = os.getenv("LLM_BASE_URL") or os.getenv("SU8_BASE_URL", "")
    vision_api_key = os.getenv("VISION_API_KEY") or llm_api_key
    vision_base_url = os.getenv("VISION_BASE_URL") or llm_base_url
    time_parse_api_key = os.getenv("TIME_PARSE_API_KEY") or llm_api_key
    time_parse_base_url = os.getenv("TIME_PARSE_BASE_URL") or llm_base_url
    visual_rerank_api_key = os.getenv("VISUAL_RERANK_API_KEY") or vision_api_key
    visual_rerank_base_url = os.getenv("VISUAL_RERANK_BASE_URL") or vision_base_url
    query_format_api_key = os.getenv("QUERY_FORMAT_API_KEY") or llm_api_key
    query_format_base_url = os.getenv("QUERY_FORMAT_BASE_URL") or llm_base_url
    embedding_api_key = os.getenv("EMBEDDING_API_KEY") or llm_api_key
    embedding_base_url = os.getenv("EMBEDDING_BASE_URL") or llm_base_url
    text_rerank_api_key = os.getenv("TEXT_RERANK_API_KEY") or embedding_api_key
    text_rerank_base_url = os.getenv("TEXT_RERANK_BASE_URL") or embedding_base_url

    query_max_expansion_rounds = _get_int(
        "QUERY_MAX_EXPANSION_ROUNDS",
        _get_int("QUERY_EXPANSION_MAX_ALTERNATIVES", 2),
    )
    query_max_reflection_rounds = _get_int("QUERY_MAX_REFLECTION_ROUNDS", 2)

    config: Dict[str, Any] = {
        "PHOTO_DIR": os.getenv("PHOTO_DIR"),
        "DATA_DIR": data_dir,
        "RUNTIME_DATA_DIR": runtime_data_dir,
        "INDEX_PATH": os.getenv(
            "INDEX_PATH", os.path.join(runtime_data_dir, "photo_search.index")
        ),
        "METADATA_PATH": os.getenv(
            "METADATA_PATH", os.path.join(runtime_data_dir, "metadata.json")
        ),
        "VECTOR_METRIC": os.getenv("VECTOR_METRIC", "cosine"),
        # flat (exact, recall-gold) | ivf (coarse-quantized, million-scale)
        "VECTOR_INDEX_TYPE": os.getenv("VECTOR_INDEX_TYPE", "flat"),
        "VECTOR_WEIGHT": _get_float("VECTOR_WEIGHT", 0.8),
        "KEYWORD_WEIGHT": _get_float("KEYWORD_WEIGHT", 0.2),
        "TOP_K": _get_int("TOP_K", 12),
        "BATCH_SIZE": _get_int("BATCH_SIZE", 8),
        "MAX_RETRIES": _get_int("MAX_RETRIES", 3),
        "TIMEOUT": _get_int("TIMEOUT", 45),
        "INDEX_BACKGROUND_MODE": os.getenv("INDEX_BACKGROUND_MODE", "thread").strip().lower(),
        "SERVER_HOST": os.getenv("SERVER_HOST", "127.0.0.1"),
        "SERVER_PORT": _get_int("SERVER_PORT", 10001),
        "SECRET_KEY": os.getenv("SECRET_KEY", "dev-secret-key"),
        "USE_BASE64": _get_bool("USE_BASE64", True),
        "IMAGE_MAX_SIZE": _get_int("IMAGE_MAX_SIZE", 1024),
        "IMAGE_QUALITY": _get_int("IMAGE_QUALITY", 85),
        "IMAGE_FORMAT": os.getenv("IMAGE_FORMAT", "WEBP").upper(),
        "LLM_API_KEY": llm_api_key,
        "LLM_BASE_URL": llm_base_url,
        "VISION_API_KEY": vision_api_key,
        "VISION_BASE_URL": vision_base_url,
        "VISION_MODEL": os.getenv("VISION_MODEL", "gpt-5.4"),
        "VISION_BACKEND": os.getenv("VISION_BACKEND", "auto"),  # auto|openai|local
        "VISION_REASONING_EFFORT": os.getenv("VISION_REASONING_EFFORT", "medium"),
        "VISION_ENHANCED_REASONING_EFFORT": os.getenv("VISION_ENHANCED_REASONING_EFFORT", "low"),
        "VISION_BASE_MAX_TOKENS": _get_int("VISION_BASE_MAX_TOKENS", 700),
        "VISION_ENHANCED_MAX_TOKENS": _get_int("VISION_ENHANCED_MAX_TOKENS", 420),
        "VISION_REPAIR_MAX_TOKENS": _get_int("VISION_REPAIR_MAX_TOKENS", 420),
        "STRUCTURED_ANALYSIS_ENABLED": _get_bool("STRUCTURED_ANALYSIS_ENABLED", True),
        "ENHANCED_ANALYSIS_ENABLED": _get_bool("ENHANCED_ANALYSIS_ENABLED", True),
        "TAG_MIN_CONFIDENCE": _get_float("TAG_MIN_CONFIDENCE", 0.65),
        "IDENTITY_TEXT_MIN_CONFIDENCE": _get_float("IDENTITY_TEXT_MIN_CONFIDENCE", 0.7),
        "IDENTITY_VISUAL_MIN_CONFIDENCE": _get_float("IDENTITY_VISUAL_MIN_CONFIDENCE", 0.92),
        "TIME_PARSE_API_KEY": time_parse_api_key,
        "TIME_PARSE_BASE_URL": time_parse_base_url,
        "TIME_PARSE_MODEL": os.getenv("TIME_PARSE_MODEL", "gpt-5.1"),
        "TIME_PARSE_BACKEND": os.getenv("TIME_PARSE_BACKEND", "auto"),  # auto|openai|local
        "TIME_PARSE_REASONING_EFFORT": os.getenv("TIME_PARSE_REASONING_EFFORT", "low"),
        "TIME_PARSE_STRATEGY": os.getenv("TIME_PARSE_STRATEGY", "local_first"),
        "QUERY_FORMAT_ENABLED": _get_bool("QUERY_FORMAT_ENABLED", True),
        "QUERY_FORMAT_API_KEY": query_format_api_key,
        "QUERY_FORMAT_BASE_URL": query_format_base_url,
        "QUERY_FORMAT_MODEL": os.getenv("QUERY_FORMAT_MODEL", "gpt-5.1"),
        "QUERY_FORMAT_BACKEND": os.getenv("QUERY_FORMAT_BACKEND", "auto"),
        "QUERY_FORMAT_REASONING_EFFORT": os.getenv("QUERY_FORMAT_REASONING_EFFORT", "low"),
        "QUERY_EXPANSION_ENABLED": _get_bool("QUERY_EXPANSION_ENABLED", True),
        "QUERY_EXPANSION_MAX_ALTERNATIVES": query_max_expansion_rounds,
        "QUERY_MAX_EXPANSION_ROUNDS": query_max_expansion_rounds,
        "QUERY_MULTI_ROUND_ENABLED": _get_bool("QUERY_MULTI_ROUND_ENABLED", False),
        "QUERY_REFLECTION_ENABLED": _get_bool("QUERY_REFLECTION_ENABLED", False),
        "QUERY_MAX_REFLECTION_ROUNDS": query_max_reflection_rounds,
        "QUERY_DYNAMIC_THRESHOLD_FLOOR": _get_float("QUERY_DYNAMIC_THRESHOLD_FLOOR", 0.05),
        "QUERY_STRICT_FLOOR_MIN": _get_float("QUERY_STRICT_FLOOR_MIN", 0.22),
        "QUERY_BROAD_FLOOR_MIN": _get_float("QUERY_BROAD_FLOOR_MIN", 0.12),
        "QUERY_CACHE_ENABLED": _get_bool("QUERY_CACHE_ENABLED", True),
        "QUERY_CACHE_SIZE": _get_int("QUERY_CACHE_SIZE", 2000),
        "EMBEDDING_CACHE_ENABLED": _get_bool("EMBEDDING_CACHE_ENABLED", True),
        "EMBEDDING_CACHE_SIZE": _get_int("EMBEDDING_CACHE_SIZE", 5000),
        "EMBEDDING_API_KEY": embedding_api_key,
        "EMBEDDING_BASE_URL": embedding_base_url,
        "EMBEDDING_MODEL": os.getenv("EMBEDDING_MODEL", "Qwen/Qwen3-Embedding-8B"),
        # auto: openai-compatible HTTP when a base URL is configured,
        # otherwise the on-device hashing embedder (models/hash_embedder.py).
        "EMBEDDING_BACKEND": os.getenv("EMBEDDING_BACKEND", "auto"),
        "EMBEDDING_DIMENSION": _get_int("EMBEDDING_DIMENSION", 1536),
        "TEXT_RERANK_API_KEY": text_rerank_api_key,
        "TEXT_RERANK_BASE_URL": text_rerank_base_url,
        "TEXT_RERANK_MODEL": os.getenv("TEXT_RERANK_MODEL", "Qwen/Qwen3-Reranker-8B"),
        "TEXT_RERANK_BACKEND": os.getenv("TEXT_RERANK_BACKEND", "auto"),
        "TEXT_RERANK_TIMEOUT": _get_int("TEXT_RERANK_TIMEOUT", 45),
        "VISUAL_RERANK_ENABLED": _get_bool("VISUAL_RERANK_ENABLED", True),
        "VISUAL_RERANK_API_KEY": visual_rerank_api_key,
        "VISUAL_RERANK_BASE_URL": visual_rerank_base_url,
        "VISUAL_RERANK_MODEL": os.getenv("VISUAL_RERANK_MODEL", os.getenv("VISION_MODEL", "gpt-5.4")),
        "VISUAL_RERANK_REASONING_EFFORT": os.getenv("VISUAL_RERANK_REASONING_EFFORT", "medium"),
        "VISUAL_RERANK_TIMEOUT": _get_int("VISUAL_RERANK_TIMEOUT", 60),
        "RERANK_IMAGE_MAX_SIZE": _get_int("RERANK_IMAGE_MAX_SIZE", 512),
        "RERANK_IMAGE_QUALITY": _get_int("RERANK_IMAGE_QUALITY", 75),
        "RERANK_IMAGE_FORMAT": os.getenv("RERANK_IMAGE_FORMAT", "WEBP").upper(),
        "RERANK_MAX_IMAGES": _get_int("RERANK_MAX_IMAGES", 12),
        # Keyword channel: builtin (device-adjacent host inverted index,
        # default) | elasticsearch (real-ES adapter, reference parity) |
        # none.  Replaces the reference's hard Elasticsearch dependency
        # while preserving the degrade-when-absent contract.
        "KEYWORD_BACKEND": os.getenv("KEYWORD_BACKEND", "builtin"),
        "KEYWORD_INDEX_PATH": os.getenv(
            "KEYWORD_INDEX_PATH", os.path.join(runtime_data_dir, "keyword_index.json")
        ),
        # real-ES adapter connection (reference config.py:158-162)
        "ELASTICSEARCH_HOST": os.getenv("ELASTICSEARCH_HOST", "localhost"),
        "ELASTICSEARCH_PORT": _get_int("ELASTICSEARCH_PORT", 9200),
        "ELASTICSEARCH_INDEX": os.getenv("ELASTICSEARCH_INDEX", "photo_keywords"),
        "ELASTICSEARCH_USERNAME": os.getenv("ELASTICSEARCH_USERNAME"),
        "ELASTICSEARCH_PASSWORD": os.getenv("ELASTICSEARCH_PASSWORD"),
        "SEARCH_VALIDATE_FILE_EXISTS": _get_bool("SEARCH_VALIDATE_FILE_EXISTS", False),
        # serving-path request micro-batching (core/batcher.py) — ON by
        # default: it is the configuration validated under concurrent load
        # (docs/DESIGN.md load section); single-request latency cost is one
        # window (3 ms)
        "SEARCH_MICROBATCH_ENABLED": _get_bool("SEARCH_MICROBATCH_ENABLED", True),
        "SEARCH_MICROBATCH_WINDOW_MS": _get_float("SEARCH_MICROBATCH_WINDOW_MS", 3.0),
        "SEARCH_MICROBATCH_MAX_BATCH": _get_int("SEARCH_MICROBATCH_MAX_BATCH", 128),
        # in-flight batch depth: overlaps batch N+1's dispatch with batch
        # N's result fetch (core/batcher.py); 1 = strict serial
        "SEARCH_MICROBATCH_PIPELINE": _get_int("SEARCH_MICROBATCH_PIPELINE", 2),
        "DEFAULT_SEARCH_MODE": os.getenv("DEFAULT_SEARCH_MODE", "balanced").strip().lower(),
        # --- TPU retrieval-core knobs (no reference equivalent) ---
        # auto = bfloat16 on TPU (the benchmarked serving config; persistence
        # stays float32), float32 elsewhere
        "STORE_DTYPE": os.getenv("STORE_DTYPE", "auto"),  # auto|float32|bfloat16
        # int8 shadow scan + exact rescore (~1.4-2× scan QPS;
        # ops/quantized.py).  auto = on for TPU backends (the validated
        # fastest serving tier: recall@10 0.996 iid / exact on realistic
        # gaps, docs/ABLATION_INT8.md), off elsewhere; 0/1 pin it.  The
        # recall-gold exact tier stays one flag away (STORE_QUANTIZED=0).
        "STORE_QUANTIZED": os.getenv("STORE_QUANTIZED", "auto"),
        # kernel corpus-block rows; 0 = auto (VMEM-budget-aware by dim/dtype)
        "TOPK_BLOCK_N": _get_int("TOPK_BLOCK_N", 0),
        "IVF_NLIST": _get_int("IVF_NLIST", 1024),
        # 0 = autotune nprobe to IVF_TARGET_RECALL (recall@10 vs full probe
        # on a held-out sample) after every (re)build
        "IVF_NPROBE": _get_int("IVF_NPROBE", 64),
        "IVF_TARGET_RECALL": _get_float("IVF_TARGET_RECALL", 0.98),
        # mesh shape: 0 = single-device store; N>=1 = row-shard the corpus
        # over a jax.sharding.Mesh of the first N devices (per-shard
        # partial top-k + all_gather merge over ICI; parallel/sharded.py);
        # -1 = all visible devices
        "MESH_DEVICES": _get_int("MESH_DEVICES", 0),
        # multi-host (DCN) serving: set all three on every process to run
        # one jax.distributed job — rank 0 serves HTTP, other ranks replay
        # device ops in SPMD lockstep (parallel/spmd_serving.py).  DATA_DIR
        # must be a shared filesystem.  Empty coordinator = single-host.
        "DIST_COORDINATOR": os.getenv("DIST_COORDINATOR", "").strip(),
        "DIST_NUM_PROCESSES": _get_int("DIST_NUM_PROCESSES", 0),
        "DIST_PROCESS_ID": _get_int("DIST_PROCESS_ID", -1),
        # persistent XLA compilation cache: pins kernel schedules across
        # processes (the int8 kernel's 47-68k QPS compile-session variance
        # freezes to ±0.2% — docs/ABLATION_INT8.md) and removes restart
        # compile cost.  Empty = disabled; JAX_COMPILATION_CACHE_DIR env
        # takes precedence (native JAX knob).
        "COMPILE_CACHE_DIR": os.getenv("COMPILE_CACHE_DIR", ""),
    }
    return config


def get_config() -> Dict[str, Any]:
    """Return the cached configuration (reference config.py:170-175)."""
    global _CONFIG_CACHE
    if _CONFIG_CACHE is None:
        _CONFIG_CACHE = load_config()
    return _CONFIG_CACHE


def reset_config_cache() -> None:
    """Test helper: drop the cached config."""
    global _CONFIG_CACHE
    _CONFIG_CACHE = None

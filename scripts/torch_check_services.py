#!/usr/bin/env python
"""Service health check of the PyTorch port (the port of
scripts/check_services.py; reference parity: artifacts/check_services.ps1).

Reports, for the current environment/config:
  * the device the port serves on (``device.resolve_device()``: the CUDA
    card unless ``PSE_PLATFORM=cpu``) + the CUDA cards by name (``cpu``
    when the host was asked for); with no card and no ``PSE_PLATFORM``
    the backend is an error, ``ok`` is false and the exit code 1
  * native C++ library availability
  * configured LLM endpoints (reachability probed when configured)
  * index artifacts on disk (vector index, metadata, keyword index,
    ready marker, lock state)
  * HTTP server liveness on the configured port
"""

from __future__ import annotations

import json
import os
import sys


def main() -> int:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from photo_search_engine_tpu_torch.config import get_config

    config = get_config()
    report = {"ok": True}

    try:
        import torch

        from photo_search_engine_tpu_torch.device import resolve_device

        device = resolve_device()
        report["backend"] = device.type
        report["devices"] = (
            [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
            if device.type == "cuda" else ["cpu"]
        )
    except Exception as exc:
        report["backend"] = f"ERROR: {exc}"
        report["ok"] = False

    try:
        from photo_search_engine_tpu_torch.native import native_available

        report["native_library"] = native_available()
    except Exception as exc:
        report["native_library"] = f"ERROR: {exc}"

    endpoints = {}
    for label, url_key in (
        ("vision", "VISION_BASE_URL"),
        ("embedding", "EMBEDDING_BASE_URL"),
        ("query_format", "QUERY_FORMAT_BASE_URL"),
        ("text_rerank", "TEXT_RERANK_BASE_URL"),
    ):
        url = config.get(url_key)
        if not url:
            endpoints[label] = "local backend (no endpoint configured)"
            continue
        try:
            import requests

            response = requests.get(url, timeout=5)
            endpoints[label] = f"{url} -> HTTP {response.status_code}"
        except Exception as exc:
            endpoints[label] = f"{url} -> UNREACHABLE ({type(exc).__name__})"
    report["endpoints"] = endpoints

    data_dir = config["RUNTIME_DATA_DIR"]
    artifacts = {}
    for name, path in (
        ("vector_index", config["INDEX_PATH"]),
        ("vector_meta", config["INDEX_PATH"] + ".meta.json"),
        ("metadata", config["METADATA_PATH"]),
        ("keyword_index", config["KEYWORD_INDEX_PATH"]),
        ("ready_marker", os.path.join(data_dir, "index_ready.marker")),
        ("lock", os.path.join(data_dir, "indexing.lock")),
        ("status", os.path.join(data_dir, "index_status.status")),
        ("timing_log", os.path.join(data_dir, "index_timing.jsonl")),
    ):
        artifacts[name] = (
            f"{os.path.getsize(path)}B" if os.path.exists(path) else "absent"
        )
    report["artifacts"] = artifacts

    host = config["SERVER_HOST"]
    port = config["SERVER_PORT"]
    try:
        import requests

        response = requests.get(f"http://{host}:{port}/index_status", timeout=3)
        report["server"] = f"http://{host}:{port} -> {response.json().get('status')}"
        metrics = requests.get(f"http://{host}:{port}/metrics", timeout=3).json()
        report["metrics"] = {
            "index": metrics.get("index"),
            "routes": {
                route: entry.get("requests")
                for route, entry in (metrics.get("routes") or {}).items()
            },
        }
    except Exception:
        report["server"] = f"http://{host}:{port} -> not running"

    print(json.dumps(report, indent=2, ensure_ascii=False))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

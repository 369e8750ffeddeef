"""HTTP route contracts.

Behavior-parity target: reference api/routes.py —
* ``/`` serves the SPA; ``/init_index`` (400 while processing, cache
  invalidation, incremental|full modes, 105-127); ``/search_photos``,
  ``/search_by_image``, ``/search_by_uploaded_image`` all return 409 while
  indexing (133-145, 213-225, 295-307) and carry ``search_debug`` +
  rerank flags; ``/open_photo_location``; ``/index_status``; ``/photo``
  with path-traversal guard + extension whitelist (418-462).
* ``_apply_rerank_pipeline`` (37-82): text rerank over the full candidate
  pool, then visual rerank (reference image takes priority over the text
  query), final cut to rerank_top_k only when a rerank actually ran,
  visual-rerank failure is non-fatal.
* ``_enrich_results`` (23-34): photo_url, file_name, display path.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import quote, unquote

from photo_search_engine_tpu_torch.api.wsgi import App, Request, Response, json_response
from photo_search_engine_tpu_torch.utils.image_parser import is_valid_image
from photo_search_engine_tpu_torch.utils.path_utils import (
    ensure_display_path,
    normalize_local_path,
    open_in_file_manager,
)

class ServingMetrics:
    """Per-route request counters + latency reservoirs for ``/metrics``.

    Net-new operational surface (the reference has none — SURVEY.md §5
    notes observability is print-tags + a status file).  Windowed
    reservoir (last N) rather than unbounded history; percentiles are
    computed on read, so the record path is O(1) per request."""

    def __init__(self, window: int = 1024) -> None:
        from collections import deque

        self._window = window
        self._deque = deque
        self.requests: Dict[str, int] = {}
        self.errors: Dict[str, int] = {}
        self.latencies: Dict[str, Any] = {}

    def record(self, route: str, seconds: float, error: bool = False) -> None:
        self.requests[route] = self.requests.get(route, 0) + 1
        if error:
            self.errors[route] = self.errors.get(route, 0) + 1
        bucket = self.latencies.get(route)
        if bucket is None:
            bucket = self.latencies[route] = self._deque(maxlen=self._window)
        bucket.append(seconds)

    def snapshot(self) -> Dict[str, Any]:
        routes: Dict[str, Any] = {}
        for route, count in self.requests.items():
            lats = sorted(self.latencies.get(route) or ())
            entry: Dict[str, Any] = {
                "requests": count,
                "errors": self.errors.get(route, 0),
            }
            if lats:
                def pct(p: float) -> float:
                    return round(
                        lats[min(len(lats) - 1, int(p * len(lats)))] * 1e3, 2
                    )

                entry["latency_ms"] = {
                    "p50": pct(0.50),
                    "p90": pct(0.90),
                    "p99": pct(0.99),
                    "window": len(lats),
                }
            routes[route] = entry
        return routes


_PHOTO_EXTENSIONS = {".jpg", ".jpeg", ".png", ".webp"}
_MIME_BY_EXT = {
    ".jpg": "image/jpeg",
    ".jpeg": "image/jpeg",
    ".png": "image/png",
    ".webp": "image/webp",
}


def enrich_results(results: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """(reference routes.py:23-34)"""
    enriched = []
    for item in results:
        result = dict(item)
        photo_path = result.get("photo_path", "")
        normalized = normalize_local_path(photo_path)
        result["photo_path"] = ensure_display_path(photo_path)
        result["photo_url"] = f"/photo?path={quote(normalized)}" if normalized else ""
        result["file_name"] = os.path.basename(normalized) if normalized else ""
        result["match_summary"] = dict(result.get("match_summary") or {})
        enriched.append(result)
    return enriched


def apply_rerank_pipeline(
    *,
    results: List[Dict[str, Any]],
    top_k: int,
    rerank_top_k: int,
    enable_text_rerank: bool,
    enable_visual_rerank: bool,
    text_query: Optional[str],
    reference_image_path: Optional[str],
    text_rerank_service: Any,
    visual_rerank_service: Any,
) -> Tuple[List[Dict[str, Any]], Dict[str, bool]]:
    """(reference routes.py:37-82)"""
    normalized_top_k = max(1, min(int(top_k), 50))
    normalized_rerank_top_k = max(1, min(int(rerank_top_k), normalized_top_k))
    state = {"text_reranked": False, "visual_reranked": False}
    reranked = list(results)
    pool_size = len(reranked)

    if (
        enable_text_rerank
        and text_query
        and text_rerank_service
        and text_rerank_service.is_enabled()
    ):
        reranked = text_rerank_service.rerank(text_query, reranked, pool_size)
        state["text_reranked"] = True

    if enable_visual_rerank and visual_rerank_service and visual_rerank_service.is_enabled():
        try:
            if reference_image_path:
                reranked = visual_rerank_service.rerank_by_reference_image(
                    reference_image_path, reranked, pool_size
                )
                state["visual_reranked"] = True
            elif text_query:
                reranked = visual_rerank_service.rerank(text_query, reranked, pool_size)
                state["visual_reranked"] = True
        except Exception as exc:
            # visual rerank is best-effort; the search must still succeed
            print(f"Warning: visual rerank skipped: {exc}")

    final_limit = normalized_rerank_top_k if any(state.values()) else normalized_top_k
    reranked = reranked[:final_limit]
    for rank, item in enumerate(reranked, start=1):
        item["rank"] = rank
    return reranked, state


def _error_payload(
    message: str, started: float, *, log_traceback: bool = False
) -> Dict[str, Any]:
    # unexpected 500s print their stack server-side (the reference tags
    # failures with [ERROR] prints throughout) — a bare exception string
    # like "list index out of range" is undebuggable from the client
    if log_traceback:
        import traceback

        print(f"[ERROR] {message}")
        traceback.print_exc()
    return {
        "status": "error",
        "message": message,
        "results": [],
        "total_results": 0,
        "elapsed_time": round(time.time() - started, 4),
        "text_reranked": False,
        "visual_reranked": False,
    }


def _indexing_in_progress_response(started: float):
    return json_response(
        _error_payload("索引仍在构建中，请稍后再搜索", started), 409
    )


def register_routes(
    app: App,
    indexer: Any,
    searcher: Any,
    config: Dict[str, Any],
    text_rerank_service: Any = None,
    visual_rerank_service: Any = None,
) -> None:
    templates_dir = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "templates")
    )
    metrics = ServingMetrics()

    def _timed(route_name: str):
        """Record request count / error count / latency for /metrics."""

        def decorate(handler):
            def wrapper(request: Request):
                started = time.time()
                error = True
                try:
                    resp = handler(request)
                    error = (
                        isinstance(resp, tuple)
                        and len(resp) == 2
                        and isinstance(resp[1], int)
                        and resp[1] >= 400
                    )
                    return resp
                finally:
                    metrics.record(route_name, time.time() - started, error)

            return wrapper

        return decorate

    @app.route("/")
    def index(request: Request):
        page = os.path.join(templates_dir, "index.html")
        if os.path.exists(page):
            with open(page, "rb") as f:
                return Response(f.read(), content_type="text/html; charset=utf-8")
        return Response(b"photo_search_engine_tpu", content_type="text/html")

    @app.route("/init_index", methods=["POST"])
    def init_index(request: Request):
        try:
            status = indexer.get_status()
            if status.get("status") == "processing":
                return status, 400
            data = request.get_json(silent=True) or {}
            mode = str(data.get("mode") or "incremental").strip().lower()
            searcher.index_loaded = False  # cache invalidation
            return indexer.start_build_in_background(force_rebuild=(mode == "full"))
        except Exception as exc:
            return (
                {
                    "status": "failed",
                    "message": f"索引构建异常: {exc}",
                    "total_count": 0,
                    "indexed_count": 0,
                    "failed_count": 0,
                    "fallback_ratio": 0.0,
                    "elapsed_time": 0.0,
                },
                500,
            )

    @app.route("/search_photos", methods=["POST"])
    @_timed("search_photos")
    def search_photos(request: Request):
        started = time.time()
        try:
            if indexer.get_status().get("status") == "processing":
                return _indexing_in_progress_response(started)
            data = request.get_json()
            if data is None:
                return {"status": "error", "message": "请求体必须为JSON格式"}, 400
            query = (data.get("query") or "").strip()
            if not query:
                return {"status": "error", "message": "查询内容不能为空"}, 400
            search_mode = str(
                data.get("search_mode") or config.get("DEFAULT_SEARCH_MODE", "balanced")
            ).strip().lower()
            top_k = min(int(data.get("top_k", config.get("TOP_K", 12))), 50)
            rerank_top_k = min(max(1, int(data.get("rerank_top_k", top_k))), top_k)
            results = searcher.search(query, top_k, search_mode=search_mode)
            results, rerank_state = apply_rerank_pipeline(
                results=results,
                top_k=top_k,
                rerank_top_k=rerank_top_k,
                enable_text_rerank=bool(data.get("enable_text_rerank", False)),
                enable_visual_rerank=bool(data.get("enable_visual_rerank", False)),
                text_query=query,
                reference_image_path=None,
                text_rerank_service=text_rerank_service,
                visual_rerank_service=visual_rerank_service,
            )
            enriched = enrich_results(results)
            return {
                "status": "success",
                "results": enriched,
                "total_results": len(enriched),
                "elapsed_time": round(time.time() - started, 4),
                "search_debug": searcher.get_last_search_debug(),
                **rerank_state,
            }
        except ValueError as exc:
            return _error_payload(str(exc), started), 400
        except Exception as exc:
            return _error_payload(f"搜索异常: {exc}", started, log_traceback=True), 500

    @app.route("/search_by_image", methods=["POST"])
    @_timed("search_by_image")
    def search_by_image(request: Request):
        started = time.time()
        try:
            if indexer.get_status().get("status") == "processing":
                return _indexing_in_progress_response(started)
            data = request.get_json()
            if data is None:
                return {"status": "error", "message": "请求体必须为JSON格式"}, 400
            image_path = normalize_local_path((data.get("image_path") or "").strip())
            if not image_path:
                return {"status": "error", "message": "图片路径不能为空"}, 400
            top_k = min(int(data.get("top_k", config.get("TOP_K", 12))), 50)
            rerank_top_k = min(max(1, int(data.get("rerank_top_k", top_k))), top_k)
            query_hint = (data.get("query_hint") or "").strip() or None
            results = searcher.search_by_image_path(image_path, top_k)
            results, rerank_state = apply_rerank_pipeline(
                results=results,
                top_k=top_k,
                rerank_top_k=rerank_top_k,
                enable_text_rerank=bool(data.get("enable_text_rerank", False)),
                enable_visual_rerank=bool(data.get("enable_visual_rerank", False)),
                text_query=query_hint,
                reference_image_path=image_path,
                text_rerank_service=text_rerank_service,
                visual_rerank_service=visual_rerank_service,
            )
            enriched = enrich_results(results)
            return {
                "status": "success",
                "query_image_path": ensure_display_path(image_path),
                "results": enriched,
                "total_results": len(enriched),
                "elapsed_time": round(time.time() - started, 4),
                "search_debug": searcher.get_last_search_debug(),
                **rerank_state,
            }
        except ValueError as exc:
            return _error_payload(str(exc), started), 400
        except Exception as exc:
            return _error_payload(f"以图搜图异常: {exc}", started, log_traceback=True), 500

    @app.route("/search_by_uploaded_image", methods=["POST"])
    @_timed("search_by_uploaded_image")
    def search_by_uploaded_image(request: Request):
        started = time.time()
        temp_path = ""
        try:
            if indexer.get_status().get("status") == "processing":
                return _indexing_in_progress_response(started)
            uploaded = request.files.get("image")
            if uploaded is None or not uploaded.filename:
                return {"status": "error", "message": "请上传图片文件"}, 400
            suffix = os.path.splitext(uploaded.filename)[1] or ".jpg"
            with tempfile.NamedTemporaryFile(delete=False, suffix=suffix) as tmp:
                tmp.write(uploaded.content)
                temp_path = tmp.name
            if not is_valid_image(temp_path):
                raise ValueError("上传的文件不是有效图片")
            form = request.form
            top_k = min(int(form.get("top_k", config.get("TOP_K", 12))), 50)
            rerank_top_k = min(max(1, int(form.get("rerank_top_k", top_k))), top_k)
            enable_text = str(form.get("enable_text_rerank", "")).lower() in {"true", "1", "on"}
            enable_visual = str(form.get("enable_visual_rerank", "")).lower() in {"true", "1", "on"}
            query_hint = (form.get("query_hint") or "").strip() or None
            analysis = indexer.generate_analysis(temp_path, count_fallback=False)
            results = searcher.search_by_uploaded_image(temp_path, analysis=analysis, top_k=top_k)
            results, rerank_state = apply_rerank_pipeline(
                results=results,
                top_k=top_k,
                rerank_top_k=rerank_top_k,
                enable_text_rerank=enable_text,
                enable_visual_rerank=enable_visual,
                text_query=query_hint,
                reference_image_path=temp_path,
                text_rerank_service=text_rerank_service,
                visual_rerank_service=visual_rerank_service,
            )
            enriched = enrich_results(results)
            return {
                "status": "success",
                "query_image_path": ensure_display_path(temp_path),
                "query_image_name": uploaded.filename,
                "results": enriched,
                "total_results": len(enriched),
                "elapsed_time": round(time.time() - started, 4),
                "search_debug": searcher.get_last_search_debug(),
                **rerank_state,
            }
        except ValueError as exc:
            return _error_payload(str(exc), started), 400
        except Exception as exc:
            return _error_payload(f"上传图片检索异常: {exc}", started), 500
        finally:
            if temp_path and os.path.exists(temp_path):
                try:
                    os.remove(temp_path)
                except OSError:
                    pass

    @app.route("/open_photo_location", methods=["POST"])
    def open_photo_location(request: Request):
        try:
            data = request.get_json()
            if data is None:
                return {"status": "error", "message": "请求体必须为JSON格式"}, 400
            image_path = (data.get("image_path") or "").strip()
            if not image_path:
                return {"status": "error", "message": "图片路径不能为空"}, 400
            open_in_file_manager(image_path)
            return {"status": "success", "message": "已尝试打开文件所在位置"}
        except ValueError as exc:  # malformed JSON body
            return {"status": "error", "message": str(exc)}, 400
        except FileNotFoundError as exc:
            return {"status": "error", "message": str(exc)}, 404
        except Exception as exc:
            return {"status": "error", "message": f"打开文件位置失败: {exc}"}, 500

    @app.route("/metrics")
    def metrics_route(request: Request):
        """Serving metrics (net-new; no reference equivalent): per-route
        request/error counters and latency percentiles over a sliding
        window, the store's operational snapshot, indexing status, and the
        last search's per-stage timing."""
        payload: Dict[str, Any] = {"routes": metrics.snapshot()}
        try:
            payload["index"] = searcher.vector_index.describe()
        except Exception:
            payload["index"] = None
        try:
            payload["indexing"] = indexer.get_status()
        except Exception:
            payload["indexing"] = None
        try:
            payload["last_search_timing"] = (
                searcher.get_last_search_debug() or {}
            ).get("timing")
        except Exception:
            payload["last_search_timing"] = None
        return payload

    @app.route("/index_status")
    def index_status(request: Request):
        try:
            return indexer.get_status()
        except Exception as exc:
            return (
                {
                    "status": "failed",
                    "message": f"获取状态失败: {exc}",
                    "total_count": 0,
                    "indexed_count": 0,
                    "failed_count": 0,
                    "elapsed_time": 0.0,
                },
                500,
            )

    @app.route("/photo")
    def get_photo(request: Request):
        try:
            raw = request.query.get("path", "")
            if not raw:
                return Response("缺少path参数".encode("utf-8"), status=400)
            decoded = unquote(raw)
            normalized = normalize_local_path(decoded)
            if ".." in os.path.normpath(decoded).split(os.sep):
                return Response("拒绝访问：非法路径".encode("utf-8"), status=403)
            if not os.path.isabs(normalized):
                return Response("路径必须为绝对路径".encode("utf-8"), status=400)
            if not os.path.isfile(normalized):
                return Response(f"文件不存在: {decoded}".encode("utf-8"), status=404)
            ext = os.path.splitext(normalized)[1].lower()
            if ext not in _PHOTO_EXTENSIONS:
                return Response("不支持的文件格式".encode("utf-8"), status=400)
            with open(normalized, "rb") as f:
                content = f.read()
            return Response(content, content_type=_MIME_BY_EXT.get(ext, "image/webp"))
        except Exception as exc:
            return Response(f"获取图片失败: {exc}".encode("utf-8"), status=500)

    @app.errorhandler(404)
    def not_found(request: Request):
        return {"status": "error", "message": "接口不存在"}, 404

    @app.errorhandler(500)
    def internal_error(request: Request):
        return {"status": "error", "message": "服务器内部错误"}, 500

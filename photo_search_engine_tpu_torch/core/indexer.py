"""Index build pipeline + job control.

Behavior-parity target: reference core/indexer.py —
* ``scan_photos``: recursive walk, mtime-sorted (232-253)
* ``generate_analysis``: cached-analysis reuse, vision retry, local
  filename fallback with a tracked fallback counter (255-330)
* per-photo processing: analysis → EXIF → time_info → embedding, with
  per-step timings (387-489); EXIF-only time tags — season by month and
  the 7-band time-of-day table (535-629); **no mtime fallback** (606-617)
* ``build_index`` (647-1036): pid-lock → index-text schema-version gate
  triggering auto full rebuild (631-705) → cached-analysis preload
  (707-737) → incremental diff vs indexed paths (754-772) → batch loop
  writing vector + keyword stores → save after every successful batch
  (942-956) → acceptance gate: fail when success < min(100, total) or
  fallback_ratio >= 0.1 (982-1008) → ready marker + status + timing log
* background modes thread|process with a spawned worker (104-223)
* JSON pid-lock with stale-lock reaping via os.kill(pid, 0) (1079-1245)
* status file + ready marker + ``index_timing.jsonl`` structured log +
  EXIF-coverage stat in get_status (80-103, 338-385, 1038-1072).

TPU-first difference: embeddings are generated **batched** (one HTTP call
or one device pass per batch) and appended to the vector index as one
batched device update, instead of per-photo round-trips.  Per-photo
failure isolation is preserved for the analysis/EXIF stage.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import threading
import time
from datetime import datetime
from typing import Any, Dict, List, Optional
from uuid import uuid4

from photo_search_engine_tpu_torch.services.analysis import (
    INDEX_TEXT_VERSION,
    normalize_analysis_payload,
)
from photo_search_engine_tpu_torch.utils.image_parser import (
    extract_exif_metadata,
    generate_fallback_description,
    get_file_time,
    is_valid_image,
)

SEASON_BY_MONTH = {
    3: "春天", 4: "春天", 5: "春天",
    6: "夏天", 7: "夏天", 8: "夏天",
    9: "秋天", 10: "秋天", 11: "秋天",
    12: "冬天", 1: "冬天", 2: "冬天",
}
# 7-band time-of-day table (reference indexer.py:583-598)
TIME_PERIOD_BANDS = (
    (0, 5, "凌晨"),
    (5, 8, "早晨"),
    (8, 12, "上午"),
    (12, 14, "中午"),
    (14, 17, "下午"),
    (17, 19, "傍晚"),
    (19, 24, "夜晚"),
)
WEEKDAY_NAMES = ("星期一", "星期二", "星期三", "星期四", "星期五", "星期六", "星期日")


def extract_time_info(
    exif_data: Optional[Dict[str, Any]], file_time: Optional[str] = None
) -> Dict[str, Any]:
    """Structured time tags from EXIF datetime ONLY — file mtime must not
    fabricate season/time-of-day tags (reference indexer.py:566-617)."""
    info: Dict[str, Any] = {
        "year": None, "month": None, "day": None, "hour": None,
        "season": None, "time_period": None, "weekday": None,
        "datetime_str": None,
    }
    del file_time  # accepted for interface parity; deliberately unused
    raw = (exif_data or {}).get("datetime")
    if not raw:
        return info
    try:
        moment = datetime.fromisoformat(raw)
    except Exception:
        return info
    info.update(
        year=moment.year, month=moment.month, day=moment.day, hour=moment.hour,
        datetime_str=moment.isoformat(),
        season=SEASON_BY_MONTH.get(moment.month),
        weekday=WEEKDAY_NAMES[moment.weekday()],
    )
    for low, high, label in TIME_PERIOD_BANDS:
        if low <= moment.hour < high:
            info["time_period"] = label
            break
    return info


class Indexer:
    """Build pipeline with crash-tolerant incremental indexing."""

    def __init__(
        self,
        photo_dir: str,
        vector_index: Any,
        vision_service: Any,
        embedding_service: Any,
        keyword_index: Optional[Any] = None,
        batch_size: int = 8,
        max_retries: int = 3,
        timeout: int = 45,
        data_dir: str = "./data",
        background_mode: str = "thread",
        worker_python_executable: Optional[str] = None,
        worker_entrypoint: Optional[List[str]] = None,
        worker_log_path: Optional[str] = None,
    ) -> None:
        self.photo_dir = photo_dir
        self.vector_index = vector_index
        self.vision_service = vision_service
        self.embedding_service = embedding_service
        self.keyword_index = keyword_index
        self.batch_size = max(1, int(batch_size))
        self.max_retries = max(1, int(max_retries))
        self.timeout = max(1, int(timeout))
        self.data_dir = data_dir
        os.makedirs(self.data_dir, exist_ok=True)
        mode = str(background_mode or "thread").strip().lower()
        self.background_mode = mode if mode in {"thread", "process"} else "thread"
        self.worker_python_executable = worker_python_executable
        self.worker_entrypoint = worker_entrypoint  # argv list after the executable
        self._worker_log_path = worker_log_path or os.path.join(self.data_dir, "index_worker.log")

        self._status_path = os.path.join(self.data_dir, "index_status.status")
        self._lock_path = os.path.join(self.data_dir, "indexing.lock")
        self._ready_path = os.path.join(self.data_dir, "index_ready.marker")
        self._timing_log_path = os.path.join(self.data_dir, "index_timing.jsonl")
        self._fallback_count = 0
        self._run_id: Optional[str] = None
        self._background_thread: Optional[threading.Thread] = None
        self._background_process: Optional[subprocess.Popen] = None
        self._background_lock = threading.Lock()
        self._cached_analyses: Dict[str, Dict[str, Any]] = {}
        self._status: Dict[str, Any] = {
            "status": "idle",
            "message": "索引尚未开始构建",
            "total_count": 0,
            "indexed_count": 0,
            "failed_count": 0,
            "fallback_ratio": 0.0,
            "index_path": vector_index.index_path,
            "elapsed_time": 0.0,
            "timing_log_path": self._timing_log_path,
        }

    # ------------------------------------------------------------------
    # Scanning & analysis
    # ------------------------------------------------------------------
    def scan_photos(self, validate: bool = True) -> List[str]:
        """Recursive scan of valid images, oldest-mtime first
        (reference indexer.py:232-253).

        ``validate=False`` checks extensions only — the HTTP-blocking
        count scan in start_build_in_background must not PIL-verify a
        50k-photo library twice (the build's own scan still does)."""
        if not os.path.isdir(self.photo_dir):
            return []
        exts = {".jpg", ".jpeg", ".png", ".webp"}
        found: List[str] = []
        for root, _, files in os.walk(self.photo_dir):
            for name in files:
                path = os.path.abspath(os.path.join(root, name))
                if validate:
                    if is_valid_image(path):
                        found.append(path)
                elif os.path.splitext(name)[1].lower() in exts:
                    found.append(path)

        def mtime(path: str) -> float:
            try:
                return os.path.getmtime(path)
            except Exception:
                return 0.0

        found.sort(key=mtime)
        return found

    def generate_analysis(
        self, photo_path: str, *, count_fallback: bool = True
    ) -> Dict[str, Any]:
        """Vision analysis with cache reuse, retries, and a local fallback
        (reference indexer.py:255-330).

        ``count_fallback=False`` is for the upload-search request path
        (routes.py): its fallbacks must not bleed into a concurrent
        build's acceptance-gate counter."""
        cached = self._cached_analyses.get(photo_path)
        if cached and cached.get("retrieval_text"):
            print(f"[INFO] reusing cached analysis: {photo_path}")
            return cached

        last_error: Optional[Exception] = None
        for attempt in range(self.max_retries):
            try:
                analysis = self.vision_service.analyze_image(photo_path)
                if not analysis or not analysis.get("retrieval_text"):
                    raise ValueError("structured analysis came back empty")
                metrics = None
                getter = getattr(self.vision_service, "get_last_analysis_metrics", None)
                if callable(getter):
                    try:
                        metrics = getter()
                    except Exception:
                        metrics = None
                if isinstance(metrics, dict):
                    analysis.setdefault("_timing_metrics", {})["vision_service"] = metrics
                return analysis
            except Exception as exc:
                last_error = exc
                print(f"[WARN] vision analysis failed (attempt {attempt + 1}): {exc}")
                time.sleep(0.5)

        print("[FALLBACK] vision unavailable; using filename-derived analysis")
        del last_error
        if count_fallback:
            self._fallback_count += 1
        caption = generate_fallback_description(photo_path)
        fallback = normalize_analysis_payload(
            {
                "description": caption,
                "outer_scene_summary": caption,
                "inner_content_summary": "",
                "media_types": ["photo"],
                "tags": [],
                "ocr_text": "",
                "person_roles": [],
                "identity_candidates": [],
                "analysis_flags": {},
            },
            tag_min_confidence=0.65,
            identity_text_threshold=0.7,
            identity_visual_threshold=0.92,
        )
        fallback["_timing_metrics"] = {"vision_service": {"used_fallback": True}}
        fallback["_used_fallback"] = True
        return fallback

    # ------------------------------------------------------------------
    # Batch processing (batched embedding, per-photo isolation elsewhere)
    # ------------------------------------------------------------------
    def process_batch(self, photo_paths: List[str]) -> List[Dict[str, Any]]:
        """Analyze each photo (isolated), then embed all embedding_texts in
        ONE batched call (reference per-photo loop: indexer.py:387-489)."""
        staged: List[Dict[str, Any]] = []
        for photo_path in photo_paths:
            started = time.perf_counter()
            timings: Dict[str, float] = {}
            try:
                t0 = time.perf_counter()
                analysis = self.generate_analysis(photo_path)
                timings["generate_analysis"] = time.perf_counter() - t0
                retrieval_text = str(analysis.get("retrieval_text") or "").strip()
                embedding_text = str(analysis.get("embedding_text") or retrieval_text).strip()

                t0 = time.perf_counter()
                exif_data = extract_exif_metadata(photo_path)
                file_time = get_file_time(photo_path)
                timings["extract_exif"] = time.perf_counter() - t0

                t0 = time.perf_counter()
                time_info = extract_time_info(exif_data, file_time)
                timings["extract_time_info"] = time.perf_counter() - t0

                staged.append(
                    {
                        "photo_path": photo_path,
                        "description": str(analysis.get("description") or ""),
                        "embedding_text": embedding_text,
                        "retrieval_text": retrieval_text,
                        "analysis": analysis,
                        "embedding": None,
                        "exif_data": exif_data,
                        "file_time": file_time,
                        "time_info": time_info,
                        "status": "success",
                        "error": None,
                        "step_timings": timings,
                        "processing_elapsed": time.perf_counter() - started,
                    }
                )
            except Exception as exc:
                staged.append(
                    {
                        "photo_path": photo_path,
                        "description": None,
                        "embedding_text": None,
                        "retrieval_text": None,
                        "analysis": None,
                        "embedding": None,
                        "exif_data": None,
                        "file_time": None,
                        "time_info": None,
                        "status": "failed",
                        "error": f"photo processing failed: {exc}",
                        "step_timings": timings,
                        "processing_elapsed": time.perf_counter() - started,
                    }
                )

        pending = [item for item in staged if item["status"] == "success"]
        if pending:
            t0 = time.perf_counter()
            try:
                vectors = self.embedding_service.generate_embedding_batch(
                    [item["embedding_text"] for item in pending]
                )
                if len(vectors) != len(pending):
                    raise ValueError("batch embedding count mismatch")
                for item, vector in zip(pending, vectors):
                    item["embedding"] = list(vector)
            except Exception:
                # degrade to per-item embedding with isolation
                for item in pending:
                    try:
                        item["embedding"] = list(
                            self.embedding_service.generate_embedding(item["embedding_text"])
                        )
                    except Exception as exc:
                        item["status"] = "failed"
                        item["error"] = f"embedding failed: {exc}"
            batch_elapsed = time.perf_counter() - t0
            share = batch_elapsed / max(1, len(pending))
            for item in pending:
                item["step_timings"]["generate_embedding"] = share
                item["processing_elapsed"] += share

        for item in staged:
            item["step_timings"] = {k: round(v, 4) for k, v in item["step_timings"].items()}
            item["processing_elapsed"] = round(item["processing_elapsed"], 4)
            self._log_photo_timing(
                item["photo_path"],
                item["step_timings"],
                item["processing_elapsed"],
                status=item["status"],
                details={"error": item["error"]} if item["error"] else {
                    "used_fallback_analysis": bool((item.get("analysis") or {}).get("_used_fallback")),
                },
            )
        return staged

    # ------------------------------------------------------------------
    # Schema gate & cache preload
    # ------------------------------------------------------------------
    @staticmethod
    def _metadata_matches_schema(metadata: Dict[str, Any]) -> bool:
        return (
            metadata.get("index_text_version") == INDEX_TEXT_VERSION
            and bool(str(metadata.get("embedding_text") or "").strip())
        )

    def _existing_index_requires_rebuild(self) -> bool:
        if not self.vector_index.metadata:
            return False
        return any(
            not isinstance(item, dict) or not self._metadata_matches_schema(item)
            for item in self.vector_index.metadata
        )

    def _preload_cached_analyses(self) -> None:
        self._cached_analyses.clear()
        for item in self.vector_index.metadata or []:
            if not isinstance(item, dict):
                # corrupt entries are exactly what triggers the auto
                # rebuild — they must not crash the preload that precedes it
                continue
            path = item.get("photo_path")
            retrieval_text = item.get("retrieval_text")
            if not path or not isinstance(retrieval_text, str) or not retrieval_text:
                continue
            self._cached_analyses[path] = {
                "description": item.get("description"),
                "outer_scene_summary": item.get("outer_scene_summary"),
                "inner_content_summary": item.get("inner_content_summary"),
                "media_types": item.get("media_types") or [],
                "tags": item.get("top_tags") or item.get("tags") or [],
                "ocr_text": item.get("ocr_text") or "",
                "person_roles": item.get("person_roles") or [],
                "identity_candidates": item.get("identity_candidates") or [],
                "identity_names": item.get("identity_names") or [],
                "identity_evidence": item.get("identity_evidence") or [],
                "analysis_flags": item.get("analysis_flags") or {},
                "embedding_text": item.get("embedding_text") or retrieval_text,
                "retrieval_text": retrieval_text,
            }

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------
    def build_index(
        self, force_rebuild: bool = False, lock_already_held: bool = False
    ) -> Dict[str, Any]:
        if not lock_already_held and not self._create_lock():
            return self._finish("processing", "索引构建正在进行中")

        start_wall = time.time()
        self._run_id = f"index-run-{datetime.now().isoformat()}-{uuid4().hex[:8]}"
        self._append_timing(
            {
                "event": "build_started",
                "force_rebuild": force_rebuild,
                "index_text_version": INDEX_TEXT_VERSION,
                "batch_size": self.batch_size,
                "photo_dir": self.photo_dir,
            }
        )
        try:
            if force_rebuild:
                self._clear_stores()
            elif self.vector_index.get_total_items() == 0:
                try:
                    self.vector_index.load()
                except Exception as exc:
                    print(f"[WARN] existing index unreadable, full rebuild: {exc}")
                    self.vector_index.clear()
                if self.keyword_index is not None:
                    try:
                        self.keyword_index.load()
                    except Exception as exc:
                        print(f"[WARN] keyword index unreadable: {exc}")

            # schema-version gate → automatic full rebuild
            if not force_rebuild and self._existing_index_requires_rebuild():
                print("[INFO] stale index-text schema detected; full rebuild")
                self._append_timing(
                    {
                        "event": "build_stage_timing",
                        "stage": "auto_rebuild_for_text_schema",
                        "details": {"index_text_version": INDEX_TEXT_VERSION},
                    }
                )
                self._preload_cached_analyses()  # reuse analyses, re-embed
                self._clear_stores(keep_cached_analyses=True)
                force_rebuild = True
            else:
                self._preload_cached_analyses()

            self._fallback_count = 0
            success_count = self.vector_index.get_total_items()
            failed_count = 0

            self._remove_ready_marker()
            scan_started = time.perf_counter()
            photo_paths = self.scan_photos()
            self._append_timing(
                {
                    "event": "build_stage_timing",
                    "stage": "scan_photos",
                    "elapsed_seconds": round(time.perf_counter() - scan_started, 4),
                    "details": {"photo_count": len(photo_paths)},
                }
            )
            total_count = len(photo_paths)
            if total_count == 0:
                return self._finish("failed", "未找到可索引的图片文件")

            if force_rebuild:
                new_paths = photo_paths
            else:
                new_paths = [
                    p for p in photo_paths if not self.vector_index.has_photo_path(p)
                ]
            self._set_status("processing", "索引构建中", total_count, success_count, 0, 0.0, 0.0)

            if not new_paths:
                self._create_ready_marker()
                return self._finish(
                    "success",
                    "索引已是最新，无新增图片需要处理",
                    total_count=total_count,
                    indexed_count=success_count,
                    elapsed=time.time() - start_wall,
                )

            for batch_start in range(0, len(new_paths), self.batch_size):
                batch = new_paths[batch_start : batch_start + self.batch_size]
                batch_started = time.perf_counter()
                self._set_status(
                    "processing",
                    f"正在处理第 {batch_start + 1}-{batch_start + len(batch)} 张",
                    total_count, success_count, failed_count,
                    self._fallback_ratio(success_count), time.time() - start_wall,
                )
                results = self.process_batch(batch)
                batch_success = [r for r in results if r["status"] == "success"]
                failed_count += len(results) - len(batch_success)

                if batch_success:
                    try:
                        import numpy as np

                        embeddings = np.asarray(
                            [r["embedding"] for r in batch_success], np.float32
                        )
                        metadatas = [self._build_metadata(r) for r in batch_success]
                        write_started = time.perf_counter()
                        self.vector_index.add_batch(embeddings, metadatas)
                        if self.keyword_index is not None:
                            for r in batch_success:
                                self.keyword_index.add_document(
                                    hashlib.md5(r["photo_path"].encode()).hexdigest(),
                                    self._build_keyword_document(r),
                                )
                        self._append_timing(
                            {
                                "event": "photo_persist_timing",
                                "batch_start_index": batch_start,
                                "count": len(batch_success),
                                "elapsed_seconds": round(
                                    time.perf_counter() - write_started, 4
                                ),
                            }
                        )
                        success_count += len(batch_success)
                    except Exception as exc:
                        return self._finish("failed", f"索引写入失败: {exc}")

                    # durability: persist after every successful batch —
                    # same contract as the reference (indexer.py:942-956)
                    # at O(batch) cost: new rows flush as an append-only
                    # segment committed by an atomic manifest replace; the
                    # final save below compacts segments into the base
                    try:
                        save_started = time.perf_counter()
                        self.vector_index.save_incremental()
                        if self.keyword_index is not None:
                            try:
                                # per-batch durability save: the builtin
                                # index throttles its postings sidecar here
                                # (full export every batch is O(N²/B))
                                self.keyword_index.save(final=False)
                            except TypeError:
                                self.keyword_index.save()
                            except Exception as exc:
                                print(f"[WARN] keyword index save failed: {exc}")
                        self._append_timing(
                            {
                                "event": "build_stage_timing",
                                "stage": "save_vector_store_batch",
                                "elapsed_seconds": round(
                                    time.perf_counter() - save_started, 4
                                ),
                                "details": {"batch_start_index": batch_start},
                            }
                        )
                    except Exception as exc:
                        return self._finish("failed", f"索引保存失败: {exc}")

                self._set_status(
                    "processing", "索引构建中",
                    total_count, success_count, failed_count,
                    self._fallback_ratio(success_count), time.time() - start_wall,
                )
                self._append_timing(
                    {
                        "event": "build_stage_timing",
                        "stage": "process_batch",
                        "elapsed_seconds": round(time.perf_counter() - batch_started, 4),
                        "details": {
                            "batch_start_index": batch_start,
                            "batch_size": len(batch),
                            "batch_success_count": len(batch_success),
                        },
                    }
                )

            try:
                self.vector_index.save()
                if self.keyword_index is not None:
                    try:
                        self.keyword_index.save()
                    except Exception as exc:
                        print(f"[WARN] keyword index save failed: {exc}")
            except Exception as exc:
                return self._finish("failed", f"索引保存失败: {exc}")

            fallback_ratio = self._fallback_ratio(success_count)
            elapsed = time.time() - start_wall
            # acceptance gate (reference indexer.py:982-1008)
            if success_count < min(100, total_count) or fallback_ratio >= 0.1:
                return self._finish(
                    "failed",
                    "索引构建未达标（成功数量不足或降级占比过高）",
                    total_count=total_count,
                    indexed_count=success_count,
                    failed_count=failed_count,
                    fallback_ratio=fallback_ratio,
                    elapsed=elapsed,
                )
            self._create_ready_marker()
            return self._finish(
                "success",
                "索引构建成功",
                total_count=total_count,
                indexed_count=success_count,
                failed_count=failed_count,
                fallback_ratio=fallback_ratio,
                elapsed=elapsed,
            )
        except Exception as exc:
            # the thread runner has this net; the PROCESS worker path does
            # not — without it an unexpected crash releases the lock but
            # leaves the status file 'processing' forever (no lock to reap,
            # no ready marker), blocking every search/build route
            return self._finish("failed", f"索引构建异常: {exc}")
        finally:
            self._release_lock()
            self._run_id = None

    def _clear_stores(self, keep_cached_analyses: bool = False) -> None:
        self.vector_index.clear()
        if self.keyword_index is not None:
            try:
                self.keyword_index.clear()
            except Exception as exc:
                print(f"[WARN] keyword index clear failed: {exc}")
        if not keep_cached_analyses:
            self._cached_analyses.clear()

    @staticmethod
    def _build_metadata(item: Dict[str, Any]) -> Dict[str, Any]:
        analysis = item["analysis"]
        return {
            "photo_path": item["photo_path"],
            "description": item["description"],
            "outer_scene_summary": analysis.get("outer_scene_summary"),
            "inner_content_summary": analysis.get("inner_content_summary"),
            "media_types": analysis.get("media_types") or [],
            "top_tags": analysis.get("tags") or [],
            "ocr_text": analysis.get("ocr_text") or "",
            "person_roles": analysis.get("person_roles") or [],
            "identity_candidates": analysis.get("identity_candidates") or [],
            "identity_names": analysis.get("identity_names") or [],
            "identity_evidence": analysis.get("identity_evidence") or [],
            "analysis_flags": analysis.get("analysis_flags") or {},
            "embedding_text": item["embedding_text"],
            "retrieval_text": item["retrieval_text"],
            "index_text_version": INDEX_TEXT_VERSION,
            "exif_data": item["exif_data"],
            "file_time": item["file_time"],
            "time_info": item["time_info"],
        }

    @staticmethod
    def _build_keyword_document(item: Dict[str, Any]) -> Dict[str, Any]:
        analysis = item["analysis"]
        time_info = item.get("time_info") or {}
        exif_data = item.get("exif_data") or {}
        return {
            "photo_path": item["photo_path"],
            "description": item["description"],
            "outer_scene_summary": analysis.get("outer_scene_summary"),
            "inner_content_summary": analysis.get("inner_content_summary"),
            "retrieval_text": item["retrieval_text"],
            "ocr_text": analysis.get("ocr_text") or "",
            "file_name": os.path.basename(item["photo_path"]),
            "media_types": analysis.get("media_types") or [],
            "tags": analysis.get("tags") or [],
            "identity_names": analysis.get("identity_names") or [],
            "identity_evidence": analysis.get("identity_evidence") or [],
            "year": time_info.get("year"),
            "month": time_info.get("month"),
            "day": time_info.get("day"),
            "hour": time_info.get("hour"),
            "season": time_info.get("season"),
            "time_period": time_info.get("time_period"),
            "weekday": time_info.get("weekday"),
            "camera": exif_data.get("camera"),
            "datetime": time_info.get("datetime_str"),
        }

    # ------------------------------------------------------------------
    # Background modes
    # ------------------------------------------------------------------
    def start_build_in_background(self, force_rebuild: bool = False) -> Dict[str, Any]:
        """Start a build without blocking (reference indexer.py:104-160)."""
        with self._background_lock:
            self._clear_stale_lock_if_needed()
            if os.path.exists(self._lock_path):
                return self.get_status()

            total_count = len(self.scan_photos(validate=False))
            indexed_count = 0 if force_rebuild else self.vector_index.get_total_items()
            self._remove_ready_marker()
            self._set_status(
                "processing", "索引构建中", total_count, indexed_count, 0, 0.0, 0.0
            )

            if (
                self.background_mode == "process"
                and self.worker_python_executable
                and self.worker_entrypoint
            ):
                return self._spawn_worker(force_rebuild, total_count, indexed_count)

            if not self._create_lock():
                return self.get_status()

            def runner() -> None:
                try:
                    self.build_index(force_rebuild=force_rebuild, lock_already_held=True)
                except Exception as exc:
                    self._finish("failed", f"索引构建异常: {exc}")
                    self._release_lock()
                finally:
                    with self._background_lock:
                        self._background_thread = None

            self._background_thread = threading.Thread(
                target=runner, name="photo-index-build", daemon=True
            )
            self._background_thread.start()
            return dict(self._status)

    def _spawn_worker(
        self, force_rebuild: bool, total_count: int, indexed_count: int
    ) -> Dict[str, Any]:
        command = [str(self.worker_python_executable)] + list(self.worker_entrypoint)
        command.append("--index-worker")
        if force_rebuild:
            command.append("--force-rebuild")
        # claim the lock atomically BEFORE spawning (the worker runs with
        # lock_already_held=True — spawn-then-lock left a window where a
        # second build could also start), then hand the lock to the child
        if not self._create_lock():
            return self.get_status()
        try:
            log_dir = os.path.dirname(self._worker_log_path)
            if log_dir:
                os.makedirs(log_dir, exist_ok=True)
            with open(self._worker_log_path, "a", encoding="utf-8") as log_file:
                log_file.write(
                    f"\n[{datetime.now().isoformat()}] spawn index worker "
                    f"force_rebuild={force_rebuild}\n"
                )
                log_file.flush()
                process = subprocess.Popen(
                    command, stdout=log_file, stderr=subprocess.STDOUT
                )
        except Exception as exc:
            self._release_lock()
            self._set_status(
                "failed", f"后台索引进程启动失败: {exc}",
                total_count, indexed_count, 0, 0.0, 0.0,
            )
            return dict(self._status)

        self._update_lock_pid(process.pid)
        self._background_process = process
        self._append_timing(
            {
                "event": "background_worker_spawned",
                "mode": "process",
                "worker_pid": process.pid,
                "force_rebuild": force_rebuild,
            }
        )
        return dict(self._status)

    # ------------------------------------------------------------------
    # Status / locks / markers / timing log
    # ------------------------------------------------------------------
    def get_status(self) -> Dict[str, Any]:
        """Status file + lock file + ready marker + EXIF coverage
        (reference indexer.py:1038-1072)."""
        cleared_stale = self._clear_stale_lock_if_needed()
        status = self._read_status_file()
        metadata = self.vector_index.metadata or []
        if metadata:
            with_exif = sum(
                1 for item in metadata if (item.get("exif_data") or {}).get("datetime")
            )
            status["exif_coverage"] = round(with_exif / len(metadata), 4)
        else:
            status["exif_coverage"] = 0.0
        if os.path.exists(self._lock_path):
            status["status"] = "processing"
            status["message"] = "索引构建中"
            return status
        if cleared_stale and status.get("status") == "processing":
            status["status"] = "failed"
            status["message"] = "检测到上次索引任务已中断，请重新开始"
            self._status = {**self._status, **status}
            self._write_status_file(self._status)
        if os.path.exists(self._ready_path):
            status["status"] = "ready"
            status["message"] = "索引已就绪"
        return status

    def _fallback_ratio(self, success_count: int) -> float:
        # NOTE: on incremental builds success_count includes pre-existing
        # items, so the acceptance gate is diluted by corpus size — kept
        # verbatim from the reference (indexer.py:741, 1077) for parity
        if success_count <= 0:
            return 0.0
        return round(self._fallback_count / float(success_count), 4)

    def _create_lock(self, owner_pid: Optional[int] = None) -> bool:
        self._clear_stale_lock_if_needed()
        try:
            now = datetime.now().isoformat()
            # O_CREAT|O_EXCL: exists-check-then-open raced concurrent
            # builds in multi-process servers (both saw no lock, both won)
            fd = os.open(
                self._lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644
            )
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(
                    {
                        "pid": int(owner_pid if owner_pid is not None else os.getpid()),
                        "created_at": now,
                        "updated_at": now,
                    },
                    f,
                )
            return True
        except FileExistsError:
            return False
        except Exception:
            return False

    def _update_lock_pid(self, pid: int) -> None:
        """Re-point an already-held lock at the worker's pid (the parent
        claims atomically BEFORE spawning, then hands ownership over)."""
        payload = self._read_lock_payload()
        payload.pop("legacy", None)
        payload["pid"] = int(pid)
        payload["updated_at"] = datetime.now().isoformat()
        try:
            with open(self._lock_path, "w", encoding="utf-8") as f:
                json.dump(payload, f)
        except Exception:
            pass

    def _release_lock(self) -> None:
        try:
            if os.path.exists(self._lock_path):
                os.remove(self._lock_path)
        except Exception:
            pass

    def _read_lock_payload(self) -> Dict[str, Any]:
        if not os.path.exists(self._lock_path):
            return {}
        try:
            with open(self._lock_path, "r", encoding="utf-8") as f:
                raw = f.read().strip()
        except Exception:
            return {}
        if not raw:
            # a 0-byte lock (crash between create and json.dump) is
            # definitionally stale — reap it like a legacy lock, or builds
            # block forever
            return {"legacy": True}
        try:
            payload = json.loads(raw)
        except json.JSONDecodeError:
            return {"legacy": True}
        return payload if isinstance(payload, dict) else {"legacy": True}

    def _clear_stale_lock_if_needed(self) -> bool:
        """Reap locks whose owner pid is dead (reference indexer.py:1203-1245)."""
        if self._background_process is not None:
            # reap a finished child: a zombie still answers os.kill(pid, 0),
            # which would keep its lock "alive" forever
            self._background_process.poll()
        payload = self._read_lock_payload()
        if not payload:
            return False
        if not payload.get("legacy"):
            pid = payload.get("pid")
            if not isinstance(pid, int):
                # malformed payload — no live owner to respect
                self._release_lock()
                return True
            if self._pid_exists(pid):
                return False
        self._release_lock()
        return True

    @staticmethod
    def _pid_exists(pid: int) -> bool:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            return True
        except OSError:
            return False
        return True

    def _create_ready_marker(self) -> None:
        try:
            with open(self._ready_path, "w", encoding="utf-8") as f:
                f.write("ready")
        except Exception:
            pass

    def _remove_ready_marker(self) -> None:
        try:
            if os.path.exists(self._ready_path):
                os.remove(self._ready_path)
        except Exception:
            pass

    def _set_status(
        self,
        status: str,
        message: str,
        total_count: int,
        indexed_count: int,
        failed_count: int,
        fallback_ratio: float,
        elapsed_time: float,
    ) -> None:
        self._status = {
            "status": status,
            "message": message,
            "total_count": total_count,
            "indexed_count": indexed_count,
            "failed_count": failed_count,
            "fallback_ratio": fallback_ratio,
            "index_path": self.vector_index.index_path,
            "elapsed_time": round(elapsed_time, 4),
            "timing_log_path": self._timing_log_path,
        }
        self._write_status_file(self._status)

    def _finish(self, status: str, message: str, **fields: Any) -> Dict[str, Any]:
        self._set_status(
            status,
            message,
            fields.get("total_count", self._status.get("total_count", 0)),
            fields.get("indexed_count", self._status.get("indexed_count", 0)),
            fields.get("failed_count", self._status.get("failed_count", 0)),
            fields.get("fallback_ratio", self._status.get("fallback_ratio", 0.0)),
            fields.get("elapsed", self._status.get("elapsed_time", 0.0)),
        )
        self._append_timing(
            {
                "event": "build_finished",
                "status": status,
                "details": {
                    "total_count": self._status["total_count"],
                    "indexed_count": self._status["indexed_count"],
                    "failed_count": self._status["failed_count"],
                    "fallback_ratio": self._status["fallback_ratio"],
                    "message": message,
                },
            }
        )
        return dict(self._status)

    def _write_status_file(self, payload: Dict[str, Any]) -> None:
        try:
            with open(self._status_path, "w", encoding="utf-8") as f:
                json.dump(payload, f, ensure_ascii=False, indent=2)
        except Exception:
            pass

    def _read_status_file(self) -> Dict[str, Any]:
        if not os.path.exists(self._status_path):
            return dict(self._status)
        try:
            with open(self._status_path, "r", encoding="utf-8") as f:
                data = json.load(f)
            return {**self._status, **data}
        except Exception:
            return dict(self._status)

    def _append_timing(self, payload: Dict[str, Any]) -> None:
        record = {"timestamp": datetime.now().isoformat(), "run_id": self._run_id}
        record.update(payload)
        try:
            with open(self._timing_log_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(record, ensure_ascii=False) + "\n")
        except Exception:
            pass

    def _log_photo_timing(
        self,
        photo_path: str,
        steps: Dict[str, float],
        total: float,
        *,
        status: str,
        event: str = "photo_timing",
        details: Optional[Dict[str, Any]] = None,
    ) -> None:
        self._append_timing(
            {
                "event": event,
                "photo_path": photo_path,
                "status": status,
                "total_seconds": round(total, 4),
                "steps": {k: round(v, 4) for k, v in steps.items()},
                "details": details or {},
            }
        )

"""Visual rerank services (second-stage precision ranking over images).

Counterpart of ``photo_search_engine_tpu/services/rerank.py``:

* ``rank_to_score_map`` (rank r of n scores ``(n - r + 1) / n``) and
  ``parse_ranking_text`` (JSON ``ranking``, else the bare numbers);
* ``VisualRerankService``: the LLM-backed rerank.  A prompt and up to
  ``max_images`` base64 candidate images go to a vision model that
  answers ``{"ranking": [...]}``; more candidates than that run a
  tournament (chunks of ``max_images``, then a final round over the
  survivors); reference-image mode puts the query image first; a gateway
  that refuses multimodal lists gets the content as a JSON string;
  unreadable files are left out of the visual pass and back-filled by
  ``merge_with_unprocessed``;
* ``LocalVisualRerankService``: the deterministic offline backend,
  thumbnail similarity or hashing-embedder similarity on ``device``.

The prompts are the JAX package's, byte for byte.
"""

from __future__ import annotations

import base64
import json
import re
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from photo_search_engine_tpu_torch.models.hash_embedder import HashEmbedder
from photo_search_engine_tpu_torch.services.llm_compat import (
    OpenAIHttpClient,
    build_image_url_content,
    create_chat_completion,
    extract_response_text,
    normalize_openai_base_url,
    requires_api_key,
    resolve_api_key,
)
from photo_search_engine_tpu_torch.utils.image_parser import resize_and_optimize_image
from photo_search_engine_tpu_torch.utils.path_utils import normalize_local_path


def rank_to_score_map(ranking: List[int], num_images: int) -> Dict[int, float]:
    """rank r of n → (n - r + 1) / n (reference rerank_service.py:93-103)."""
    if num_images <= 0:
        return {}
    scores: Dict[int, float] = {}
    for rank, candidate_index in enumerate(ranking, start=1):
        if candidate_index < 0 or candidate_index >= num_images or candidate_index in scores:
            continue
        scores[candidate_index] = (num_images - rank + 1.0) / num_images
    return scores


def parse_ranking_text(response_text: str, num_images: int) -> List[int]:
    """JSON ranking parse with bare-number fallback
    (reference rerank_service.py:177-194)."""
    cleaned = (response_text or "").strip()
    if cleaned.startswith("```"):
        cleaned = re.sub(r"```(?:json)?\s*", "", cleaned).rstrip("`").strip()
    try:
        data = json.loads(cleaned)
        ranking = data.get("ranking", [])
        indexes = [int(v) - 1 for v in ranking if 1 <= int(v) <= num_images]
        if indexes:
            return indexes
    except Exception:
        pass
    numbers = re.findall(r"\d+", cleaned)
    indexes = [int(v) - 1 for v in numbers if 1 <= int(v) <= num_images]
    if indexes:
        return indexes
    raise ValueError("cannot parse visual rerank response")


def merge_with_unprocessed(
    reranked: List[Dict[str, Any]],
    original: List[Dict[str, Any]],
    rerank_top_k: int,
) -> List[Dict[str, Any]]:
    """Back-fill candidates that were left out of the visual pass, with
    photo paths deduplicated in normalized form."""
    if rerank_top_k <= 0:
        return []
    merged: List[Dict[str, Any]] = []
    seen: set = set()
    for source in (reranked, original):
        for item in source:
            path = normalize_local_path(str(item.get("photo_path") or ""))
            if path and path in seen:
                continue
            merged.append(dict(item))
            if path:
                seen.add(path)
            if len(merged) >= rerank_top_k:
                break
        if len(merged) >= rerank_top_k:
            break
    for rank, item in enumerate(merged, start=1):
        item["rank"] = rank
    return merged


def _readable_candidates(candidates: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Keep candidates whose image file is actually readable
    (reference rerank_service.py:196-213)."""
    out = []
    for candidate in candidates:
        path = candidate.get("photo_path")
        normalized = normalize_local_path(path) if path else ""
        if not normalized or not normalized.strip():
            continue
        try:
            with open(normalized, "rb"):
                pass
        except Exception:
            continue
        keep = dict(candidate)
        keep["photo_path"] = normalized
        out.append(keep)
    return out


class VisualRerankService:
    """LLM-backed visual rerank with chunked tournament."""

    def __init__(
        self,
        api_key: str,
        model_name: str,
        base_url: str,
        reasoning_effort: str = "medium",
        timeout: int = 60,
        max_retries: int = 3,
        image_max_size: int = 512,
        image_quality: int = 75,
        image_format: str = "WEBP",
        max_images: int = 12,
        client: Optional[Any] = None,
    ) -> None:
        if requires_api_key(base_url) and not api_key:
            raise ValueError("VISUAL_RERANK_API_KEY is not set")
        if not model_name:
            raise ValueError("VISUAL_RERANK_MODEL is not set")
        resolved = resolve_api_key(api_key, base_url)
        self.api_key = resolved
        self.model_name = model_name
        self.base_url = normalize_openai_base_url(base_url)
        self.reasoning_effort = reasoning_effort
        self.timeout = timeout
        self.max_retries = max(1, max_retries)
        self.image_max_size = max(256, min(2048, image_max_size))
        self.image_quality = max(1, min(100, image_quality))
        fmt = (image_format or "WEBP").upper()
        self.image_format = fmt if fmt in {"JPEG", "PNG", "WEBP"} else "WEBP"
        self.max_images = max(1, min(20, max_images))
        self.client = client or OpenAIHttpClient(resolved, self.base_url, timeout)

    def is_enabled(self) -> bool:
        return bool(self.api_key and self.model_name)

    # ------------------------------------------------------------------
    def _image_data_url(self, image_path: str) -> str:
        blob = resize_and_optimize_image(
            image_path,
            max_size=self.image_max_size,
            quality=self.image_quality,
            format=self.image_format,
        )
        mime = {"JPEG": "image/jpeg", "PNG": "image/png", "WEBP": "image/webp"}.get(
            self.image_format, "image/webp"
        )
        return f"data:{mime};base64,{base64.b64encode(blob).decode('utf-8')}"

    @staticmethod
    def _text_prompt(query: str, num_images: int) -> str:
        return (
            f'用户在检索与查询最相关的照片："{query}"\n'
            f"你将看到 {num_images} 张候选图片，编号从 1 到 {num_images}。"
            "请按与查询的视觉相关性从高到低排序。"
            "优先判断图片是否直接呈现了用户要找的主体、场景、动作、构图或载体组合；"
            "只通过文字、界面或二次载体间接相关的图片应排在更直接满足目标的图片后面。\n"
            '只返回 JSON：{"ranking": [1, 3, 2]}'
        )

    @staticmethod
    def _reference_prompt(num_images: int) -> str:
        return (
            "第一张图片是查询图。\n"
            f"后面依次给出 {num_images} 张候选图片，编号从 1 到 {num_images}。"
            "请按与查询图在主体、场景、构图和视觉风格上的相似度从高到低排序。\n"
            '只返回 JSON：{"ranking": [2, 1, 3]}'
        )

    def _chat(self, content: List[Dict[str, Any]]) -> Any:
        messages = [{"role": "user", "content": content}]
        try:
            return create_chat_completion(
                self.client,
                model=self.model_name,
                messages=messages,
                timeout=self.timeout,
                reasoning_effort=self.reasoning_effort,
            )
        except Exception:
            # strict gateways refuse multimodal lists; fall back to a JSON string
            return create_chat_completion(
                self.client,
                model=self.model_name,
                messages=[{"role": "user", "content": json.dumps(content, ensure_ascii=False)}],
                timeout=self.timeout,
                reasoning_effort=self.reasoning_effort,
            )

    def _rerank_chunk(
        self, content: List[Dict[str, Any]], chunk: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        num_images = len(chunk)
        last_error: Optional[Exception] = None
        for attempt in range(self.max_retries):
            try:
                response = self._chat(content)
                ranking = parse_ranking_text(extract_response_text(response), num_images)
                scores = rank_to_score_map(ranking, num_images)
                out = []
                for index, candidate in enumerate(chunk):
                    item = dict(candidate)
                    item["visual_rerank_score"] = round(scores.get(index, 0.0), 6)
                    out.append(item)
                out.sort(
                    key=lambda it: (
                        float(it.get("visual_rerank_score", 0.0)),
                        float(it.get("score", 0.0)),
                    ),
                    reverse=True,
                )
                return out
            except Exception as exc:
                last_error = exc
                if attempt < self.max_retries - 1:
                    time.sleep(1)
        raise ValueError(f"visual rerank failed: {last_error}") from last_error

    def _tournament(
        self,
        candidates: List[Dict[str, Any]],
        build_content: Callable[[List[Dict[str, Any]]], List[Dict[str, Any]]],
    ) -> List[Dict[str, Any]]:
        """Chunks of max_images, then a final merge round over survivors
        (reference rerank_service.py:144-175)."""
        if not candidates:
            return []
        if len(candidates) <= self.max_images:
            return self._rerank_chunk(build_content(candidates), candidates)
        chunk_results: List[Dict[str, Any]] = []
        for start in range(0, len(candidates), self.max_images):
            chunk = candidates[start : start + self.max_images]
            if len(chunk) <= 1:
                ranked = [dict(chunk[0])] if chunk else []
                for item in ranked:
                    item["visual_rerank_score"] = round(float(item.get("score", 0.0)), 6)
            else:
                ranked = self._rerank_chunk(build_content(chunk), chunk)
            for item in ranked:
                item["visual_rerank_batch"] = start // self.max_images + 1
            chunk_results.extend(ranked)
        if len(chunk_results) <= 1:
            return chunk_results
        return self._rerank_chunk(build_content(chunk_results), chunk_results)

    # ------------------------------------------------------------------
    def rerank(
        self, query: str, candidates: List[Dict[str, Any]], rerank_top_k: int
    ) -> List[Dict[str, Any]]:
        if not candidates:
            return []
        if not query or not query.strip():
            return candidates[:rerank_top_k]
        usable = _readable_candidates(candidates)
        if len(usable) <= 1:
            return candidates[:rerank_top_k]

        def build_content(chunk: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
            content: List[Dict[str, Any]] = [
                {"type": "text", "text": self._text_prompt(query, len(chunk))}
            ]
            for index, candidate in enumerate(chunk, start=1):
                path = candidate.get("photo_path")
                if not path:
                    continue
                content.append({"type": "text", "text": f"候选图片 {index}"})
                content.append(
                    build_image_url_content(self._image_data_url(path), self.base_url)
                )
            return content

        reranked = self._tournament(usable, build_content)
        return merge_with_unprocessed(reranked, candidates, rerank_top_k)

    def rerank_by_reference_image(
        self,
        reference_image_path: str,
        candidates: List[Dict[str, Any]],
        rerank_top_k: int,
    ) -> List[Dict[str, Any]]:
        if not candidates:
            return []
        reference_image_path = normalize_local_path(reference_image_path)
        usable = _readable_candidates(candidates)
        if len(usable) <= 1:
            return candidates[:rerank_top_k]

        def build_content(chunk: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
            content: List[Dict[str, Any]] = [
                {"type": "text", "text": self._reference_prompt(len(chunk))},
                {"type": "text", "text": "查询图片"},
                build_image_url_content(
                    self._image_data_url(reference_image_path), self.base_url
                ),
            ]
            for index, candidate in enumerate(chunk, start=1):
                path = candidate.get("photo_path")
                if not path:
                    continue
                content.append({"type": "text", "text": f"候选图片 {index}"})
                content.append(
                    build_image_url_content(self._image_data_url(path), self.base_url)
                )
            return content

        reranked = self._tournament(usable, build_content)
        return merge_with_unprocessed(reranked, candidates, rerank_top_k)


class LocalVisualRerankService:
    """Deterministic offline visual rerank: 16×16 grayscale thumbnail
    similarity in reference-image mode, hashing-embedder similarity of the
    candidate texts (on ``device``, default the one ``PSE_PLATFORM`` names)
    in text mode.  Interface-compatible with VisualRerankService."""

    _THUMB = 16

    def __init__(self, dimension: int = 1536, device=None) -> None:
        self._embedder = HashEmbedder(dimension=dimension, device=device)

    def is_enabled(self) -> bool:
        return True

    def _thumbnail_vector(self, path: str) -> Optional[np.ndarray]:
        try:
            from PIL import Image, ImageOps

            with Image.open(path) as img:
                gray = ImageOps.exif_transpose(img).convert("L").resize((self._THUMB, self._THUMB))
                vec = np.asarray(gray, np.float32).reshape(-1)
        except (OSError, ValueError):  # unreadable or not an image
            return None
        vec -= vec.mean()
        norm = np.linalg.norm(vec)
        return vec / norm if norm > 0 else vec

    def _score_sort(self, scored, candidates, top_k) -> List[Dict[str, Any]]:
        scored.sort(
            key=lambda it: (float(it.get("visual_rerank_score", 0.0)), float(it.get("score", 0.0))),
            reverse=True,
        )
        return merge_with_unprocessed(scored, candidates, top_k)

    def rerank(self, query: str, candidates: List[Dict[str, Any]], rerank_top_k: int) -> List[Dict[str, Any]]:
        if not candidates:
            return []
        if not query or not query.strip():
            return candidates[:rerank_top_k]
        texts = [
            str(
                c.get("retrieval_text")
                or c.get("description")
                or (c.get("match_summary") or {}).get("ocr_excerpt")
                or ""
            )
            for c in candidates
        ]
        vectors = self._embedder.embed_batch([query] + [t or " " for t in texts])
        sims = vectors[1:] @ vectors[0]
        scored = []
        for candidate, sim in zip(candidates, sims):
            item = dict(candidate)
            item["visual_rerank_score"] = round(float(sim), 6)
            scored.append(item)
        return self._score_sort(scored, candidates, rerank_top_k)

    def rerank_by_reference_image(
        self, reference_image_path: str, candidates: List[Dict[str, Any]], rerank_top_k: int
    ) -> List[Dict[str, Any]]:
        if not candidates:
            return []
        reference = self._thumbnail_vector(normalize_local_path(reference_image_path))
        if reference is None:
            return candidates[:rerank_top_k]
        scored = []
        for candidate in candidates:
            path = candidate.get("photo_path")
            vec = self._thumbnail_vector(normalize_local_path(path)) if path else None
            item = dict(candidate)
            item["visual_rerank_score"] = round(float(vec @ reference), 6) if vec is not None else 0.0
            scored.append(item)
        return self._score_sort(scored, candidates, rerank_top_k)

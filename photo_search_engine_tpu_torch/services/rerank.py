"""Local visual rerank service.

Counterpart of ``LocalVisualRerankService`` and ``merge_with_unprocessed``
in ``photo_search_engine_tpu/services/rerank.py`` (that module imports the
JAX hashing embedder).  The LLM-backed visual rerank is not ported yet
(ROADMAP.md, queue 3: online services).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from photo_search_engine_tpu.utils.path_utils import normalize_local_path
from photo_search_engine_tpu_torch.models.hash_embedder import HashEmbedder


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


class LocalVisualRerankService:
    """Deterministic offline visual rerank: 16×16 grayscale thumbnail
    similarity in reference-image mode, hashing-embedder similarity of the
    candidate texts in text mode."""

    _THUMB = 16

    def __init__(self, dimension: int = 1536, device="cpu") -> None:
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

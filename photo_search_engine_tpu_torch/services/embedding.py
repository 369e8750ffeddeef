"""Local text rerank service.

Counterpart of ``DeviceTextRerankService`` and ``_candidate_documents`` in
``photo_search_engine_tpu/services/embedding.py`` (that module imports the
JAX hashing embedder).  The OpenAI-compatible embedding and rerank
backends are not ported yet (ROADMAP.md, queue 3: online services).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from photo_search_engine_tpu_torch.models.hash_embedder import HashEmbedder


def _candidate_documents(candidates: List[Dict[str, Any]]) -> List[str]:
    """Rerank document text of each candidate."""
    return [
        item.get("retrieval_text")
        or item.get("description")
        or (item.get("match_summary") or {}).get("ocr_excerpt")
        or item.get("photo_path")
        or ""
        for item in candidates
    ]


class DeviceTextRerankService:
    """Model-free rerank: query-vs-candidate cross-similarity of hashing
    embeddings computed on ``device``."""

    def __init__(self, dimension: int = 1536, seed: int = 7, device="cpu") -> None:
        self._embedder = HashEmbedder(dimension=dimension, seed=seed, device=device)

    def is_enabled(self) -> bool:
        return True

    def rerank(self, query: str, candidates: List[Dict[str, Any]], top_k: int) -> List[Dict[str, Any]]:
        if not candidates:
            return []
        if not query or not query.strip():
            return candidates[:top_k]
        vectors = self._embedder.embed_batch([query] + _candidate_documents(candidates))
        scores = vectors[1:] @ vectors[0]
        order = np.argsort(-scores, kind="stable")
        reranked = []
        for rank, pos in enumerate(order[:top_k], start=1):
            candidate = dict(candidates[int(pos)])
            candidate["text_rerank_score"] = round(float(scores[int(pos)]), 6)
            candidate["rank"] = rank
            reranked.append(candidate)
        return reranked

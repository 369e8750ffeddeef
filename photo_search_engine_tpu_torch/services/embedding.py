"""Embedding + text-rerank services.

Counterpart of ``photo_search_engine_tpu/services/embedding.py``, which
it follows line for line apart from the device of the local rerank:

* ``EmbeddingService`` (ABC) and ``OpenAICompatibleEmbeddingService``:
  ``/v1/embeddings`` with ``dimensions`` when set (a service without one
  takes its width from the first response), ``max_retries`` tries with a
  1 s sleep, a failed batch falling back to one call per item, blanks in
  a batch sent as ``"."`` so rows stay aligned with the inputs;
* ``TextRerankService``: the ``api`` backend posts ``{base}/rerank``
  (Jina/Cohere payload), the ``chat`` backend asks a chat model for JSON
  ``ranking``; ``auto`` picks ``chat`` for Ollama URLs;
* ``DeviceTextRerankService``: the model-free rerank, hashing-embedding
  cross-similarity on ``device``.

HTTP goes through ``services/llm_compat.py`` (``OpenAIHttpClient``) and
``requests``; tests inject mock clients and sessions.
"""

from __future__ import annotations

import json
import time
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

try:
    import requests
except ImportError:  # pragma: no cover
    requests = None

import numpy as np

from photo_search_engine_tpu_torch.models.hash_embedder import HashEmbedder
from photo_search_engine_tpu_torch.services.llm_compat import (
    OpenAIHttpClient,
    create_chat_completion,
    extract_response_text,
    is_ollama_base_url,
    normalize_openai_base_url,
    requires_api_key,
    resolve_api_key,
    safe_get_attr,
)


class EmbeddingService(ABC):
    """Abstract embedding interface (reference embedding_service.py:21-32)."""

    dimension: Optional[int] = None

    @abstractmethod
    def generate_embedding(self, text: str) -> List[float]:
        ...

    @abstractmethod
    def generate_embedding_batch(self, texts: List[str]) -> List[List[float]]:
        ...


def _embedding_rows(response: Any) -> List[List[float]]:
    """Pull data[i].embedding out of dict- or attr-shaped responses."""
    data = safe_get_attr(response, "data")
    if data is None:
        raise ValueError("embedding response carries no data")
    rows = []
    for item in data:
        emb = safe_get_attr(item, "embedding")
        if emb is None:
            raise ValueError("embedding response item carries no embedding")
        rows.append(list(emb))
    return rows


class OpenAICompatibleEmbeddingService(EmbeddingService):
    """HTTP /v1/embeddings backend (reference embedding_service.py:35-114)."""

    def __init__(
        self,
        api_key: str,
        model_name: str,
        base_url: str,
        timeout: int = 30,
        max_retries: int = 3,
        client: Optional[Any] = None,
        dimension: Optional[int] = None,
    ) -> None:
        if requires_api_key(base_url) and not api_key:
            raise ValueError("EMBEDDING_API_KEY is not set")
        resolved = resolve_api_key(api_key, base_url)
        self.api_key = resolved
        self.model_name = model_name
        self.base_url = normalize_openai_base_url(base_url)
        self.timeout = timeout
        self.max_retries = max(1, max_retries)
        self.client = client or OpenAIHttpClient(resolved, self.base_url, timeout)
        self.dimension = dimension

    def _request(self, payload_input: Any) -> List[List[float]]:
        request: Dict[str, Any] = {
            "model": self.model_name,
            "input": payload_input,
            "timeout": self.timeout,
        }
        if self.dimension:
            request["dimensions"] = self.dimension
        response = self.client.embeddings.create(**request)
        rows = _embedding_rows(response)
        if rows and self.dimension is None:
            self.dimension = len(rows[0])
        return rows

    def generate_embedding(self, text: str) -> List[float]:
        if not text or not text.strip():
            raise ValueError("text to embed must not be empty")
        for attempt in range(self.max_retries):
            try:
                return self._request(text)[0]
            except Exception as exc:
                if attempt == self.max_retries - 1:
                    raise ValueError(f"embedding generation failed: {exc}") from exc
                time.sleep(1)
        raise ValueError("embedding generation failed")

    def generate_embedding_batch(self, texts: List[str]) -> List[List[float]]:
        if not texts:
            return []
        # keep ROW ALIGNMENT with the input: dropping blanks silently
        # misaligns any caller that zips texts with the result — blanks
        # are substituted with a neutral placeholder instead
        cleaned = [t if (t and t.strip()) else "." for t in texts]
        if not any(t.strip() for t in cleaned):
            raise ValueError("texts to embed must not be empty")
        for attempt in range(self.max_retries):
            try:
                return self._request(cleaned)
            except Exception:
                if attempt == self.max_retries - 1:
                    break
                time.sleep(1)
        # degrade to per-item calls (reference embedding_service.py:109-114)
        return [self.generate_embedding(t) for t in cleaned]


def _candidate_documents(candidates: List[Dict[str, Any]]) -> List[str]:
    """Rerank document text per candidate
    (reference embedding_service.py:155-166)."""
    docs = []
    for item in candidates:
        docs.append(
            item.get("retrieval_text")
            or item.get("description")
            or (item.get("match_summary") or {}).get("ocr_excerpt")
            or item.get("photo_path")
            or ""
        )
    return docs


# Back-compat alias (reference embedding_service.py:117 keeps the legacy
# provider name wired to the generic OpenAI-compatible implementation).
TumuerEmbeddingService = OpenAICompatibleEmbeddingService


class TextRerankService:
    """Rerank via a /rerank API or a chat model
    (reference embedding_service.py:121-298)."""

    def __init__(
        self,
        api_key: str,
        model_name: str,
        base_url: str,
        timeout: int = 30,
        max_retries: int = 3,
        session: Optional[Any] = None,
        client: Optional[Any] = None,
        backend: str = "auto",
    ) -> None:
        if requires_api_key(base_url) and not api_key:
            raise ValueError("TEXT_RERANK_API_KEY is not set")
        resolved = resolve_api_key(api_key, base_url)
        self.api_key = resolved
        self.model_name = model_name
        self.base_url = normalize_openai_base_url(base_url)
        self.http_base_url = (base_url or "").rstrip("/")
        self.timeout = timeout
        self.max_retries = max(1, max_retries)
        self.session = session or (requests.Session() if requests else None)
        self.client = client or OpenAIHttpClient(resolved, self.base_url, timeout)
        self.backend = (backend or "auto").strip().lower()

    def is_enabled(self) -> bool:
        return bool(self.api_key and self.model_name and self.base_url)

    def _resolve_backend(self) -> str:
        if self.backend in {"api", "chat"}:
            return self.backend
        return "chat" if is_ollama_base_url(self.http_base_url) else "api"

    def _api_backend(
        self, query: str, candidates: List[Dict[str, Any]], top_k: int
    ) -> List[Dict[str, Any]]:
        documents = _candidate_documents(candidates)
        payload = {
            "model": self.model_name,
            "query": query,
            "documents": documents,
            "top_n": min(max(1, top_k), len(documents)),
            "return_documents": False,
        }
        response = self.session.post(
            f"{self.http_base_url}/rerank",
            json=payload,
            headers={
                "Authorization": f"Bearer {self.api_key}",
                "Content-Type": "application/json",
            },
            timeout=self.timeout,
        )
        response.raise_for_status()
        data = response.json()
        results = data.get("results") or data.get("data") or []
        if not isinstance(results, list):
            raise ValueError("malformed rerank response")
        reranked = []
        for rank, item in enumerate(results, start=1):
            index = item.get("index")
            if index is None or not 0 <= index < len(candidates):
                continue
            candidate = dict(candidates[index])
            score = item.get("relevance_score")
            if score is not None:
                candidate["text_rerank_score"] = round(float(score), 6)
            candidate["rank"] = rank
            reranked.append(candidate)
        if not reranked:
            raise ValueError("rerank returned no usable results")
        return reranked[:top_k]

    def _chat_backend(
        self, query: str, candidates: List[Dict[str, Any]], top_k: int
    ) -> List[Dict[str, Any]]:
        documents = _candidate_documents(candidates)
        numbered = [{"index": i + 1, "text": d} for i, d in enumerate(documents)]
        prompt = (
            "你是照片搜索结果的文本重排器。"
            "请根据 query 和候选文档内容，将最相关的候选按从高到低排序。"
            '只返回 JSON，格式固定为 {"ranking":[{"index":1,"score":0.98}]}。'
            "index 从 1 开始，score 为 0 到 1 之间的小数。"
            f"只返回前 {min(max(1, top_k), len(documents))} 个结果。\n"
            f"query: {query}\n"
            f"documents: {json.dumps(numbered, ensure_ascii=False)}"
        )
        response = create_chat_completion(
            self.client,
            model=self.model_name,
            messages=[{"role": "user", "content": prompt}],
            timeout=self.timeout,
            temperature=0,
            response_format={"type": "json_object"},
        )
        payload = json.loads(extract_response_text(response))
        ranking = payload.get("ranking") or []
        if not isinstance(ranking, list):
            raise ValueError("malformed chat rerank response")
        reranked = []
        for rank, item in enumerate(ranking, start=1):
            if not isinstance(item, dict) or item.get("index") is None:
                continue
            pos = int(item["index"]) - 1
            if not 0 <= pos < len(candidates):
                continue
            candidate = dict(candidates[pos])
            if item.get("score") is not None:
                candidate["text_rerank_score"] = round(float(item["score"]), 6)
            candidate["rank"] = rank
            reranked.append(candidate)
        if not reranked:
            raise ValueError("chat rerank returned no usable results")
        return reranked[:top_k]

    def rerank(
        self, query: str, candidates: List[Dict[str, Any]], top_k: int
    ) -> List[Dict[str, Any]]:
        if not candidates:
            return []
        if not query or not query.strip():
            return candidates[:top_k]
        last_error: Optional[Exception] = None
        for attempt in range(self.max_retries):
            try:
                if self._resolve_backend() == "api":
                    return self._api_backend(query, candidates, top_k)
                return self._chat_backend(query, candidates, top_k)
            except Exception as exc:
                last_error = exc
                if attempt == self.max_retries - 1:
                    break
                time.sleep(1)
        raise ValueError(f"text rerank failed: {last_error}") from last_error


class DeviceTextRerankService:
    """Model-free rerank: query-vs-candidate cross-similarity of hashing
    embeddings computed on ``device`` (default: the one ``PSE_PLATFORM``
    names).  Same interface as TextRerankService so routes can swap them
    freely."""

    def __init__(self, dimension: int = 1536, seed: int = 7, device=None) -> None:
        self._embedder = HashEmbedder(dimension=dimension, seed=seed, device=device)

    def is_enabled(self) -> bool:
        return True

    def rerank(
        self, query: str, candidates: List[Dict[str, Any]], top_k: int
    ) -> List[Dict[str, Any]]:
        if not candidates:
            return []
        if not query or not query.strip():
            return candidates[:top_k]
        documents = _candidate_documents(candidates)
        vectors = self._embedder.embed_batch([query] + documents)
        scores = vectors[1:] @ vectors[0]
        order = np.argsort(-scores, kind="stable")
        reranked = []
        for rank, pos in enumerate(order[:top_k], start=1):
            candidate = dict(candidates[int(pos)])
            candidate["text_rerank_score"] = round(float(scores[int(pos)]), 6)
            candidate["rank"] = rank
            reranked.append(candidate)
        return reranked

"""Deterministic hashing text embedder (feature hashing, device math).

Counterpart of ``photo_search_engine_tpu/models/hash_embedder.py``: the
offline embedding backend and the scoring model of the local reranks.
Tokens are hashed on the host with blake2b (stable across processes and
machines); signed tf weights are scatter-added into D buckets on
``device`` and each row is L2-normalized there.

:meth:`HashEmbedder._features` is a copy of the JAX module's featurizer
(that module imports jax); a test pins that the two copies agree.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from photo_search_engine_tpu.core.keyword_index import tokenize

_SUBLINEAR = True


def _stable_hash(token: str, seed: int) -> int:
    digest = hashlib.blake2b(
        token.encode("utf-8"), digest_size=8, salt=seed.to_bytes(8, "little")
    ).digest()
    return int.from_bytes(digest, "little")


class HashEmbedder:
    """Deterministic text → unit vector embedder."""

    def __init__(self, dimension: int = 1536, seed: int = 7, device="cpu") -> None:
        self.dimension = int(dimension)
        self.seed = int(seed)
        self.device = torch.device(device)

    def _features(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        """(bucket indices, signed tf weights) for one text."""
        tokens = tokenize(text)
        # token bigrams add word-order signal on top of the base stream
        tokens = tokens + [a + "␟" + b for a, b in zip(tokens, tokens[1:])]
        if not tokens:
            return np.zeros(0, np.int32), np.zeros(0, np.float32)
        counts: dict = {}
        for token in tokens:
            counts[token] = counts.get(token, 0) + 1
        idx = np.empty(len(counts), np.int32)
        weight = np.empty(len(counts), np.float32)
        for slot, (token, tf) in enumerate(counts.items()):
            h = _stable_hash(token, self.seed)
            idx[slot] = h % self.dimension
            sign = 1.0 if (h >> 62) & 1 else -1.0
            weight[slot] = sign * (1.0 + np.log(tf) if _SUBLINEAR and tf > 1 else float(tf))
        return idx, weight

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        """``[len(texts), D]`` float32 unit rows (zero rows for empty texts)."""
        feats = [self._features(t) for t in texts]
        width = max((len(i) for i, _ in feats), default=0)
        indices = np.zeros((len(feats), max(width, 1)), np.int64)
        weights = np.zeros((len(feats), max(width, 1)), np.float32)
        for row, (idx, wgt) in enumerate(feats):
            indices[row, : len(idx)] = idx
            weights[row, : len(wgt)] = wgt  # padded slots add 0 to bucket 0
        vecs = torch.zeros((len(feats), self.dimension), dtype=torch.float32, device=self.device)
        vecs.scatter_add_(
            1, torch.from_numpy(indices).to(self.device), torch.from_numpy(weights).to(self.device)
        )
        norms = torch.linalg.vector_norm(vecs, dim=-1, keepdim=True)
        return (vecs / torch.clamp(norms, min=1e-12)).cpu().numpy()

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]


class HashingEmbeddingService:
    """EmbeddingService-shaped adapter over :class:`HashEmbedder`."""

    def __init__(self, dimension: int = 1536, seed: int = 7, device="cpu") -> None:
        self.dimension = int(dimension)
        self._embedder = HashEmbedder(dimension=dimension, seed=seed, device=device)

    def generate_embedding(self, text: str) -> List[float]:
        if not text or not str(text).strip():
            raise ValueError("text to embed must not be empty")
        return self._embedder.embed(str(text)).tolist()

    def generate_embedding_batch(self, texts: List[str]) -> List[List[float]]:
        cleaned = [str(t) for t in texts if t and str(t).strip()]
        if not texts:
            return []
        if not cleaned:
            raise ValueError("texts to embed must not be empty")
        return self._embedder.embed_batch(cleaned).tolist()

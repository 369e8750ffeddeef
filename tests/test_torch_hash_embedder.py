"""The port's hashing embedder and local rerank services against the JAX
package's, on a fixed set of texts (CJK among them): vectors within 1e-6
(scatter-add order may differ in the last ulp where tokens share a
bucket), the two copies of the featurizer identical."""

import numpy as np
import pytest

from photo_search_engine_tpu.models import hash_embedder as jh
from photo_search_engine_tpu.services.embedding import DeviceTextRerankService as JaxTextRerank
from photo_search_engine_tpu.services.rerank import LocalVisualRerankService as JaxVisualRerank
from photo_search_engine_tpu.services.rerank import merge_with_unprocessed as jax_merge
from photo_search_engine_tpu_torch.models import hash_embedder as th
from photo_search_engine_tpu_torch.services.embedding import DeviceTextRerankService
from photo_search_engine_tpu_torch.services.rerank import (
    LocalVisualRerankService,
    merge_with_unprocessed,
)

TEXTS = [
    "beach sunset sea",
    "海边 日落 的 照片",
    "夏天 海边 海边 海边 日落",
    "city night buildings, neon lights and rain",
    "雪山 湖泊 合影 2024年2月",
    "",
    "   ",
    "dog dog dog grass park 公园 小狗",
    "mountain_lake_snow.jpg",
]


@pytest.mark.parametrize("dimension", [64, 256, 1536])
def test_vectors_match_jax(dimension):
    got = th.HashEmbedder(dimension=dimension).embed_batch(TEXTS)
    ref = jh.HashEmbedder(dimension=dimension).embed_batch(TEXTS)
    assert got.shape == ref.shape == (len(TEXTS), dimension)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    norms = np.linalg.norm(got, axis=1)
    assert np.allclose(norms[norms > 0], 1.0, atol=1e-6)


@pytest.mark.parametrize("seed", [7, 11])
def test_featurizer_copies_agree(seed):
    port, ref = th.HashEmbedder(dimension=512, seed=seed), jh.HashEmbedder(dimension=512, seed=seed)
    for text in TEXTS:
        got_i, got_w = port._features(text)
        ref_i, ref_w = ref._features(text)
        np.testing.assert_array_equal(got_i, ref_i)
        np.testing.assert_array_equal(got_w, ref_w)


def test_embedding_service_contract():
    port, ref = th.HashingEmbeddingService(dimension=128), jh.HashingEmbeddingService(dimension=128)
    np.testing.assert_allclose(port.generate_embedding("海边"), ref.generate_embedding("海边"), atol=1e-6)
    np.testing.assert_allclose(
        port.generate_embedding_batch(["a b", "", "c"]), ref.generate_embedding_batch(["a b", "", "c"]), atol=1e-6
    )
    assert port.generate_embedding_batch([]) == []
    with pytest.raises(ValueError):
        port.generate_embedding("  ")
    with pytest.raises(ValueError):
        port.generate_embedding_batch(["", " "])


CANDIDATES = [
    {"photo_path": "/p/a.jpg", "description": "beach sunset over the sea", "score": 0.4},
    {"photo_path": "/p/b.jpg", "retrieval_text": "city night neon", "score": 0.5},
    {"photo_path": "/p/c.jpg", "match_summary": {"ocr_excerpt": "sunset sea beach"}, "score": 0.3},
    {"photo_path": "/p/d.jpg", "score": 0.2},
]


def test_text_rerank_matches_jax():
    got = DeviceTextRerankService(dimension=256).rerank("sunset beach", CANDIDATES, 3)
    ref = JaxTextRerank(dimension=256).rerank("sunset beach", CANDIDATES, 3)
    assert [c["photo_path"] for c in got] == [c["photo_path"] for c in ref]
    assert [c["rank"] for c in got] == [1, 2, 3]
    np.testing.assert_allclose(
        [c["text_rerank_score"] for c in got], [c["text_rerank_score"] for c in ref], atol=1e-6
    )


def test_visual_rerank_text_mode_and_merge_match_jax():
    got = LocalVisualRerankService(dimension=256).rerank("sunset beach", CANDIDATES, 4)
    ref = JaxVisualRerank(dimension=256).rerank("sunset beach", CANDIDATES, 4)
    assert [c["photo_path"] for c in got] == [c["photo_path"] for c in ref]
    np.testing.assert_allclose(
        [c["visual_rerank_score"] for c in got], [c["visual_rerank_score"] for c in ref], atol=1e-6
    )
    reranked = [dict(CANDIDATES[2], photo_path="/p/./c.jpg"), CANDIDATES[0]]
    assert merge_with_unprocessed(reranked, CANDIDATES, 3) == jax_merge(reranked, CANDIDATES, 3)
    assert merge_with_unprocessed(reranked, CANDIDATES, 0) == []


def test_visual_rerank_reference_image_matches_jax(tmp_path):
    from PIL import Image

    paths = []
    for i, color in enumerate([(240, 170, 80), (20, 24, 60), (235, 165, 85)]):
        path = tmp_path / f"{i}.jpg"
        image = Image.new("RGB", (64, 48), color)
        image.paste((255, 255, 255), (0, 0, 16 * (i + 1), 12))
        image.save(path)
        paths.append(str(path))
    candidates = [{"photo_path": p, "score": 0.1 * i} for i, p in enumerate(paths[1:])]
    candidates.append({"photo_path": str(tmp_path / "missing.jpg"), "score": 0.9})
    got = LocalVisualRerankService(dimension=64).rerank_by_reference_image(paths[0], candidates, 3)
    ref = JaxVisualRerank(dimension=64).rerank_by_reference_image(paths[0], candidates, 3)
    assert got == ref

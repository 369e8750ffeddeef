"""The port's online services against the JAX package's.

Each test hands one mock client or session, built as ``tests/test_services.py``
builds its mocks, to the JAX class and to the port's, and holds the two to
the same requests sent and the same results (or the same error) back:
``OpenAICompatibleEmbeddingService``, ``TextRerankService`` (``api``,
``chat`` and ``auto``), ``VisualRerankService`` (one chunk, the tournament,
reference mode, the fallback to a JSON string) and, property-tested,
``parse_ranking_text`` and ``rank_to_score_map``."""

import json
import os
import time
from unittest.mock import Mock

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from photo_search_engine_tpu.services import embedding as jax_embedding
from photo_search_engine_tpu.services import rerank as jax_rerank
from photo_search_engine_tpu_torch.services import embedding as port_embedding
from photo_search_engine_tpu_torch.services import rerank as port_rerank
from tests.test_services import _chat_response

PACKAGES = (jax_embedding, port_embedding)
RERANKS = (jax_rerank, port_rerank)


@pytest.fixture()
def sleeps(monkeypatch):
    """``time.sleep`` recorded instead of slept."""
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    return slept


def _outcome(call):
    """What ``call()`` returns, or the type and message of what it raises."""
    try:
        return ("ok", call())
    except Exception as exc:  # noqa: BLE001 — the error is the outcome compared
        return ("raised", type(exc).__name__, str(exc))


def _calls(mock):
    return [(call.args, call.kwargs) for call in mock.call_args_list]


# ---------------------------------------------------------------------------
# OpenAICompatibleEmbeddingService
# ---------------------------------------------------------------------------


def _embed_client(dim=8, fail=lambda n, inputs: False):
    """A client whose ``embeddings.create`` answers ``dim``-wide rows (row
    i filled with i + the length of its text) and raises where ``fail(call
    number, inputs)`` says."""
    state = {"calls": 0}

    def create(**kwargs):
        state["calls"] += 1
        inputs = kwargs["input"]
        if fail(state["calls"], inputs):
            raise RuntimeError(f"boom {state['calls']}")
        inputs = [inputs] if isinstance(inputs, str) else inputs
        return {"data": [{"embedding": [float(i + len(t))] * dim} for i, t in enumerate(inputs)]}

    client = Mock()
    client.embeddings.create = Mock(side_effect=create)
    return client


def _run_embed(module, client_factory, call, **kw):
    client = client_factory()
    svc = module.OpenAICompatibleEmbeddingService("k", "m", "https://x", client=client, **kw)
    return _outcome(lambda: call(svc)), _calls(client.embeddings.create), svc.dimension


@pytest.mark.parametrize("dimension", [None, 16])
def test_embedding_payload_matches_jax(dimension, sleeps):
    def call(svc):
        return svc.generate_embedding("sunset"), svc.generate_embedding_batch(["a", "bb", "ccc"])

    got = _run_embed(port_embedding, _embed_client, call, dimension=dimension, timeout=7)
    want = _run_embed(jax_embedding, _embed_client, call, dimension=dimension, timeout=7)
    assert got == want
    # without dimensions the request carries none and the width is the first response's
    sent = got[1][0][1]
    assert ("dimensions" in sent) == (dimension is not None) and sent["timeout"] == 7
    assert got[2] == (dimension or 8) and sleeps == []


def test_embedding_retries_then_succeeds(sleeps):
    def factory():
        return _embed_client(fail=lambda n, _: n <= 2)

    got = _run_embed(port_embedding, factory, lambda svc: svc.generate_embedding("text"), max_retries=3)
    port_sleeps = list(sleeps)
    want = _run_embed(jax_embedding, factory, lambda svc: svc.generate_embedding("text"), max_retries=3)
    assert got == want and len(got[1]) == 3
    assert port_sleeps == [1, 1] and sleeps == [1, 1, 1, 1]


def test_embedding_gives_up_after_max_retries(sleeps):
    def factory():
        return _embed_client(fail=lambda n, _: True)

    got = _run_embed(port_embedding, factory, lambda svc: svc.generate_embedding("text"), max_retries=2)
    want = _run_embed(jax_embedding, factory, lambda svc: svc.generate_embedding("text"), max_retries=2)
    assert got == want and got[0][0] == "raised" and "embedding generation failed" in got[0][2]


def test_embedding_batch_falls_back_to_one_call_per_item(sleeps):
    def factory():
        return _embed_client(fail=lambda n, inputs: isinstance(inputs, list))

    def call(svc):
        return svc.generate_embedding_batch(["one", "two", "three"])

    got = _run_embed(port_embedding, factory, call, max_retries=2)
    want = _run_embed(jax_embedding, factory, call, max_retries=2)
    assert got == want
    assert [c[1]["input"] for c in got[1]] == [["one", "two", "three"]] * 2 + ["one", "two", "three"]


def test_embedding_batch_keeps_blanks_aligned(sleeps):
    def call(svc):
        return svc.generate_embedding_batch(["a", "", "   ", "b"])

    got = _run_embed(port_embedding, _embed_client, call)
    assert got == _run_embed(jax_embedding, _embed_client, call)
    assert got[1][0][1]["input"] == ["a", ".", ".", "b"] and len(got[0][1]) == 4


@pytest.mark.parametrize("call, sent", [
    (lambda svc: svc.generate_embedding("   "), None),
    (lambda svc: svc.generate_embedding(""), None),
    # the JAX check for an all-blank batch tests the texts after the blanks
    # became ".", so it never fires: the placeholders are sent
    (lambda svc: svc.generate_embedding_batch(["", "  "]), [".", "."]),
    (lambda svc: svc.generate_embedding_batch([]), None),
], ids=["blank", "empty", "all-blank-batch", "no-texts"])
def test_embedding_empty_input(call, sent, sleeps):
    got = _run_embed(port_embedding, _embed_client, call)
    assert got == _run_embed(jax_embedding, _embed_client, call)
    if sent is None:
        assert got[1] == [] and (got[0][0] == "raised" or got[0][1] == [])  # nothing is sent
    else:
        assert got[0][0] == "ok" and got[1][0][1]["input"] == sent


def test_embedding_keys_match_jax():
    for module in PACKAGES:
        with pytest.raises(ValueError, match="EMBEDDING_API_KEY"):
            module.OpenAICompatibleEmbeddingService("", "m", "https://remote")
        svc = module.OpenAICompatibleEmbeddingService("", "m", "http://localhost:11434", client=Mock())
        assert (svc.api_key, svc.base_url) == ("ollama", "http://localhost:11434/v1")


# ---------------------------------------------------------------------------
# TextRerankService
# ---------------------------------------------------------------------------

CANDIDATES = [
    {"photo_path": "/a.jpg", "retrieval_text": "海边", "score": 0.9},
    {"photo_path": "/b.jpg", "description": "城市", "score": 0.8},
    {"photo_path": "/c.jpg", "match_summary": {"ocr_excerpt": "草地"}, "score": 0.7},
    {"photo_path": "/d.jpg", "score": 0.6},
]


def _session(payload):
    session = Mock()
    response = Mock()
    response.json.return_value = payload
    response.raise_for_status.return_value = None
    session.post.return_value = response
    return session


def _chat_client(text):
    client = Mock()
    client.chat.completions.create = Mock(return_value=_chat_response(text))
    return client


def _run_rerank(module, backend, payload, query="草地", top_k=3, base_url="https://x"):
    session = _session(payload) if backend != "chat" else Mock()
    client = _chat_client(payload) if backend == "chat" else Mock()
    svc = module.TextRerankService("k", "m", base_url, session=session, client=client,
                                   backend=backend, max_retries=2, timeout=9)
    out = _outcome(lambda: svc.rerank(query, CANDIDATES, top_k))
    return out, _calls(session.post), _calls(client.chat.completions.create)


@pytest.mark.parametrize("payload", [
    {"results": [{"index": 2, "relevance_score": 0.95}, {"index": 0, "relevance_score": 0.6}]},
    {"data": [{"index": 3, "relevance_score": 0.5}, {"index": 1}]},  # the "data" key, a missing score
    {"results": [{"index": 7, "relevance_score": 0.9}, {"index": 1, "relevance_score": 0.2}]},  # out of range
    {"results": [{"index": 9}]},  # nothing usable
    {"results": {"index": 1}},  # not a list
    {},
], ids=["results", "data", "out-of-range", "unusable", "not-a-list", "empty"])
def test_text_rerank_api_matches_jax(payload, sleeps):
    got = _run_rerank(port_embedding, "api", payload)
    assert got == _run_rerank(jax_embedding, "api", payload)
    url, sent = got[1][0][0][0], got[1][0][1]
    assert url == "https://x/rerank" and sent["timeout"] == 9
    assert sent["json"]["documents"] == ["海边", "城市", "草地", "/d.jpg"] and sent["json"]["top_n"] == 3
    assert sent["headers"]["Authorization"] == "Bearer k"


@pytest.mark.parametrize("text", [
    json.dumps({"ranking": [{"index": 3, "score": 0.9}, {"index": 1, "score": 0.4}, {"index": 2}]}),
    json.dumps({"ranking": [{"index": 9, "score": 0.9}, "x", {"score": 1}, {"index": 4, "score": 0.1}]}),
    json.dumps({"ranking": {"index": 1}}),
    json.dumps({"ranking": []}),
    "not json",
], ids=["ranking", "partly-malformed", "not-a-list", "empty", "not-json"])
def test_text_rerank_chat_matches_jax(text, sleeps):
    got = _run_rerank(port_embedding, "chat", text, query="城市 草地", top_k=2)
    assert got == _run_rerank(jax_embedding, "chat", text, query="城市 草地", top_k=2)
    prompt = got[2][0][1]["messages"][0]["content"]
    assert "只返回前 2 个结果" in prompt and prompt.endswith(json.dumps(
        [{"index": i + 1, "text": d} for i, d in enumerate(["海边", "城市", "草地", "/d.jpg"])], ensure_ascii=False))


@pytest.mark.parametrize("base_url, backend, want", [
    ("http://localhost:11434", "auto", "chat"),
    ("https://api.ollama.com", "auto", "chat"),
    ("https://x", "auto", "api"),
    ("http://localhost:11434", "api", "api"),
    ("https://x", "chat", "chat"),
])
def test_text_rerank_auto_backend_matches_jax(base_url, backend, want):
    picked = [module.TextRerankService("k", "m", base_url, session=Mock(), client=Mock(),
                                       backend=backend)._resolve_backend() for module in PACKAGES]
    assert picked == [want, want]


def test_text_rerank_passthrough_and_keys_match_jax():
    for module in PACKAGES:
        svc = module.TextRerankService("k", "m", "https://x", session=Mock(), client=Mock())
        assert svc.rerank("", CANDIDATES, 2) == CANDIDATES[:2] and svc.rerank("q", [], 2) == []
        assert svc.is_enabled()
        with pytest.raises(ValueError, match="TEXT_RERANK_API_KEY"):
            module.TextRerankService("", "m", "https://remote", session=Mock(), client=Mock())


# ---------------------------------------------------------------------------
# VisualRerankService
# ---------------------------------------------------------------------------


@pytest.fixture()
def images(tmp_path):
    paths = []
    for i, color in enumerate([(250, 0, 0), (0, 250, 0), (0, 0, 250), (250, 250, 0), (0, 250, 250)]):
        path = str(tmp_path / f"img{i}.jpg")
        Image.new("RGB", (40, 30), color).save(path)
        paths.append(path)
    return paths


def _visual_client(answer, refuse_lists=False):
    """``chat.completions.create`` answering ``answer(call number)``; with
    ``refuse_lists`` a multimodal content list raises, as on a strict
    gateway."""
    state = {"calls": 0}

    def create(**kwargs):
        state["calls"] += 1
        if refuse_lists and isinstance(kwargs["messages"][0]["content"], list):
            raise RuntimeError("multimodal content refused")
        return _chat_response(answer(state["calls"]))

    client = Mock()
    client.chat.completions.create = Mock(side_effect=create)
    return client


def _run_visual(module, candidates, answer, reference=None, refuse_lists=False, **kw):
    client = _visual_client(answer, refuse_lists)
    svc = module.VisualRerankService("k", "m", "https://x", client=client, max_retries=2, **kw)
    if reference is None:
        out = _outcome(lambda: svc.rerank("红色 图片", candidates, 4))
    else:
        out = _outcome(lambda: svc.rerank_by_reference_image(reference, candidates, 4))
    return out, _calls(client.chat.completions.create)


def _candidates(paths):
    return [{"photo_path": p, "score": 0.5 - 0.01 * i} for i, p in enumerate(paths)]


def test_visual_rerank_one_chunk_matches_jax(images, sleeps):
    def answer(_):
        return 'Here: {"ranking": [3, 1, 2]}'  # not clean JSON: the bare-number fallback

    got = _run_visual(port_rerank, _candidates(images[:3]), answer)
    assert got == _run_visual(jax_rerank, _candidates(images[:3]), answer)
    (out_kind, out), calls = got
    assert out_kind == "ok" and [c["photo_path"] for c in out[:3]] == [images[2], images[0], images[1]]
    content = calls[0][1]["messages"][0]["content"]
    assert content[0]["text"] == jax_rerank.VisualRerankService._text_prompt("红色 图片", 3)
    assert content[2]["image_url"]["url"].startswith("data:image/webp;base64,")


def test_visual_rerank_tournament_matches_jax(images, sleeps):
    def answer(n):
        return json.dumps({"ranking": [2, 1]}) if n % 2 else "1 2"

    candidates = _candidates(images) + [{"photo_path": "/missing.jpg", "score": 0.99}]
    got = _run_visual(port_rerank, candidates, answer, max_images=2)
    assert got == _run_visual(jax_rerank, candidates, answer, max_images=2)
    (_, out), calls = got
    # chunks of 2, 2 and 1 (the single one is not sent), then the final round of 5
    assert len(calls) == 3 and len(out) == 4
    assert all("visual_rerank_batch" in c for c in out if c["photo_path"] != "/missing.jpg")


def test_visual_rerank_reference_mode_matches_jax(images, sleeps):
    def answer(_):
        return json.dumps({"ranking": [2, 3, 1, 4]})

    got = _run_visual(port_rerank, _candidates(images[1:]), answer, reference=images[0])
    assert got == _run_visual(jax_rerank, _candidates(images[1:]), answer, reference=images[0])
    content = got[1][0][1]["messages"][0]["content"]
    assert content[0]["text"] == jax_rerank.VisualRerankService._reference_prompt(4)
    assert content[1]["text"] == "查询图片"


def test_visual_rerank_falls_back_to_a_json_string(images, sleeps):
    def answer(_):
        return json.dumps({"ranking": [1, 2]})

    got = _run_visual(port_rerank, _candidates(images[:2]), answer, refuse_lists=True)
    assert got == _run_visual(jax_rerank, _candidates(images[:2]), answer, refuse_lists=True)
    calls = got[1]
    assert isinstance(calls[-1][1]["messages"][0]["content"], str) and got[0][0] == "ok"
    assert json.loads(calls[-1][1]["messages"][0]["content"]) == calls[0][1]["messages"][0]["content"]


def test_visual_rerank_retries_then_raises_as_jax(images, sleeps):
    def answer(_):
        return "no ranking here"

    got = _run_visual(port_rerank, _candidates(images[:2]), answer)
    assert got == _run_visual(jax_rerank, _candidates(images[:2]), answer)
    assert got[0][0] == "raised" and "visual rerank failed" in got[0][2] and len(got[1]) == 2


def test_visual_rerank_few_readable_and_settings_match_jax(images, tmp_path):
    for module in RERANKS:
        svc = module.VisualRerankService("k", "m", "https://x", client=Mock(), image_max_size=9999,
                                         image_quality=0, image_format="gif", max_images=99)
        assert (svc.image_max_size, svc.image_quality, svc.image_format, svc.max_images) == (2048, 1, "WEBP", 20)
        few = [{"photo_path": images[0]}, {"photo_path": str(tmp_path / "nope.jpg")}]
        assert svc.rerank("q", few, 1) == few[:1]
        with pytest.raises(ValueError, match="VISUAL_RERANK_MODEL"):
            module.VisualRerankService("k", "", "https://x", client=Mock())
    assert os.path.exists(images[0])


# ---------------------------------------------------------------------------
# parse_ranking_text and rank_to_score_map
# ---------------------------------------------------------------------------

_ranking_texts = st.one_of(
    st.text(max_size=40),
    st.lists(st.integers(-3, 30), max_size=12).map(lambda r: json.dumps({"ranking": r})),
    st.lists(st.integers(-3, 30), max_size=12).map(lambda r: "```json\n" + json.dumps({"ranking": r}) + "\n```"),
    st.lists(st.integers(0, 30), max_size=12).map(lambda r: " then ".join(map(str, r))),
    st.lists(st.one_of(st.integers(-3, 30), st.text(max_size=3)), max_size=6).map(
        lambda r: json.dumps({"ranking": r})),
)


@settings(max_examples=300, deadline=None)
@given(text=_ranking_texts, num_images=st.integers(0, 25))
def test_parse_ranking_text_matches_jax(text, num_images):
    got = _outcome(lambda: port_rerank.parse_ranking_text(text, num_images))
    assert got == _outcome(lambda: jax_rerank.parse_ranking_text(text, num_images))


@settings(max_examples=300, deadline=None)
@given(ranking=st.lists(st.integers(-5, 30), max_size=30), num_images=st.integers(-2, 25))
def test_rank_to_score_map_matches_jax(ranking, num_images):
    assert port_rerank.rank_to_score_map(ranking, num_images) == jax_rerank.rank_to_score_map(ranking, num_images)

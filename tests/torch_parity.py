"""Shared helpers of the ``test_torch_*`` parity tests and of
``chip_smoke.py``: seeded inputs made with numpy and handed to both
packages, the top-k comparisons, the spy on the kernel wrappers, the route
flows both apps run, and a local stand-in for an OpenAI-compatible
server (embeddings, /rerank, chat completions) with the rules it answers
by.  Imports no jax (a test runs it with jax absent)."""

from __future__ import annotations

import collections
import contextlib
import functools
import hashlib
import importlib
import io
import json
import os
import re
import threading
import time

import numpy as np


def unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def slow_scans(index, seconds=0.02):
    """Make each batched scan of ``index`` (the micro-batcher's unfiltered
    and grouped calls) take ``seconds`` longer, as a scan of a large corpus
    on the card does, so that requests sent together arrive while one is in
    flight and queue for the micro-batcher's collector instead of each
    finding it idle."""
    for name in ("raw_search_batch", "raw_grouped_search_batch"):
        def slow(*args, _scan=getattr(index, name), **kwargs):
            time.sleep(seconds)
            return _scan(*args, **kwargs)

        setattr(index, name, slow)


def as_bf16_values(x):
    """float32 array holding ``x`` rounded to bfloat16 (exact in f32), so
    both packages start from the same bf16 values."""
    import torch

    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _host(x):
    """numpy view of a numpy array, a jax array or a torch tensor on any device."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def assert_topk_match(got_v, got_i, ref_v, ref_i, *, tol, descending=True, cut=None, exact=False):
    """The top-k comparison rule of the port's tests and of ``chip_smoke.py``.

    Values within ``tol``; indices equal wherever the reference score of
    the slot differs from its neighbours by more than ``tol``.  ``cut`` is
    the reference's (k+1)-th score per row (None: the last slot counts as
    isolated from below).  Empty slots (±inf, index -1 or INT_MAX) must
    agree exactly.  ``exact`` asks for identical values and indices in
    every slot.  Returns the largest value error."""
    got_v, ref_v = _host(got_v).astype(np.float64), _host(ref_v).astype(np.float64)
    got_i, ref_i = _host(got_i), _host(ref_i)
    assert got_v.shape == ref_v.shape and got_i.shape == ref_i.shape, (got_v.shape, ref_v.shape)
    tol = 0.0 if exact else tol
    finite = np.isfinite(ref_v)
    np.testing.assert_array_equal(np.isfinite(got_v), finite)
    np.testing.assert_array_equal(got_v[~finite], ref_v[~finite])
    np.testing.assert_allclose(got_v[finite], ref_v[finite], rtol=0, atol=tol)
    s = ref_v if descending else -ref_v
    inf = np.full(s.shape[:-1] + (1,), np.inf)
    after = -inf if cut is None else (_host(cut).astype(np.float64) * (1 if descending else -1))[..., None]
    prev = np.concatenate([inf, s[..., :-1]], axis=-1)
    nxt = np.concatenate([s[..., 1:], after], axis=-1)
    with np.errstate(invalid="ignore"):
        isolated = (np.abs(prev - s) > tol) & (np.abs(s - nxt) > tol)
    must = np.ones_like(finite) if exact else isolated | ~finite
    np.testing.assert_array_equal(got_i[must], ref_i[must])
    return float(np.abs(got_v[finite] - ref_v[finite]).max(initial=0.0))


def assert_window_match(got_v, got_i, ref_v, ref_i, *, tol, window=2.0 ** -12):
    """The comparison rule of kernel 3's searches (``[Q, k]``, higher is
    better) against the same searches on its plain version.  The two score
    rows in another summation order, and a score's last bits can move it
    across a packed-key window, so another row may be nominated near the
    k-th place: ids agree, except where both slots' scores lie inside the
    ``window`` (relative, plus ``tol``) of the reference's k-th score;
    values within ``tol`` where the ids agree; empty slots agree.  Returns
    the largest value error where the ids agree."""
    got_v, ref_v = _host(got_v).astype(np.float64), _host(ref_v).astype(np.float64)
    got_i, ref_i = _host(got_i), _host(ref_i)
    assert got_v.shape == ref_v.shape and got_i.shape == ref_i.shape, (got_v.shape, ref_v.shape)
    np.testing.assert_array_equal(np.isneginf(got_v), np.isneginf(ref_v))
    same = got_i == ref_i
    live = same & np.isfinite(ref_v)
    np.testing.assert_allclose(got_v[live], ref_v[live], rtol=0, atol=tol)
    kth = ref_v[..., -1:]
    with np.errstate(invalid="ignore"):
        reach = np.abs(kth) * window + tol
        near = (np.abs(got_v - kth) <= reach) & (np.abs(ref_v - kth) <= reach)
    assert (same | near).all(), "an id differs outside the packed-key window of the k-th score"
    return float(np.abs(got_v[live] - ref_v[live]).max(initial=0.0))


def assert_same_bits(what, got, ref):
    """``(values, ids)`` of a kernel equal to ``ref``'s bit for bit (values
    compared as int32 bits, so -0.0, +0.0 and the -inf slots count too)."""
    import torch

    same_v = got[0].view(torch.int32) == ref[0].view(torch.int32)
    same_i = got[1] == ref[1]
    bad = int((~(same_v & same_i)).sum())
    assert got[0].shape == ref[0].shape and bad == 0, f"{what}: {bad} slots differ from the reference's bits"


# The port's kernel wrappers, by the ``ops`` module that holds each.
KERNEL_WRAPPERS = {
    "block_topk": "topk", "fast_block_topk": "topk", "fused_topk": "topk",
    "grouped_block_topk": "grouped_mask", "fast_grouped_block_topk": "grouped_mask",
    "int8_block_topk": "quantized", "int8_grouped_block_topk": "quantized",
    "ivf_block_topk": "ivf_scan",
}


class Launches:
    """What :func:`spy_launches` saw, by wrapper: every call, and of those
    the launches.  A call launches its kernel when it runs on card tensors
    outside a CUDA graph's capture: on CPU tensors the wrapper runs its
    plain version, and under capture the work is recorded into the graph,
    whose replays call no wrapper.  Calls may come from several threads at
    once (the micro-batcher's executors and an inline caller), so each
    record takes a lock."""

    def __init__(self, names) -> None:
        self.names = tuple(names)
        self._lock = threading.Lock()
        self._calls = collections.Counter()
        self._launches = collections.Counter()

    def record(self, name: str, launched: bool) -> None:
        with self._lock:
            self._calls[name] += 1
            self._launches[name] += launched

    def reset(self) -> None:
        with self._lock:
            self._calls.clear()
            self._launches.clear()

    def calls(self) -> dict:
        with self._lock:
            return {name: self._calls[name] for name in self.names}

    def launches(self) -> dict:
        with self._lock:
            return {name: self._launches[name] for name in self.names}


def _launched(args, kwargs) -> bool:
    import torch

    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in (*args, *kwargs.values()))
    return on_card and not torch.cuda.is_current_stream_capturing()


def _spy_on(module, name, seen):
    wrapper = getattr(module, name)

    @functools.wraps(wrapper)
    def spy(*args, **kwargs):
        out = wrapper(*args, **kwargs)  # a call that raises launched nothing
        seen.record(name, _launched(args, kwargs))
        return out

    return wrapper, spy


@contextlib.contextmanager
def spy_launches(names=tuple(KERNEL_WRAPPERS)):
    """Inside, each kernel wrapper named in ``names`` (default: all of
    :data:`KERNEL_WRAPPERS`) is replaced in its module by a spy that calls
    it and records the call; yields the :class:`Launches`.  Only calls that
    look the wrapper up in its module are seen, as every caller in the port
    does.  The scoring loop a launch ran is the loop rule's answer for its
    inputs (``topk.scoring_loop``, ``quantized.int8_scoring_loop``,
    ``ivf_scan.ivf_scoring_loop``), which the caller checks.  The wrappers
    are restored on leaving; spies nest."""
    seen = Launches(names)
    swapped = []
    try:
        for name in names:
            module = importlib.import_module(f"photo_search_engine_tpu_torch.ops.{KERNEL_WRAPPERS[name]}")
            wrapper, spy = _spy_on(module, name, seen)
            setattr(module, name, spy)
            swapped.append((module, name, wrapper))
        yield seen
    finally:
        for module, name, wrapper in reversed(swapped):
            setattr(module, name, wrapper)


def launch_once(wrapper, call):
    """``call()``, which must launch ``wrapper``'s kernel once
    (:func:`spy_launches`); returns what it returns."""
    import torch

    name = wrapper.__name__
    with spy_launches((name,)) as seen:
        out = call()
    torch.cuda.synchronize()
    assert seen.launches()[name] == 1, f"{name}: expected one launch, saw {seen.launches()[name]}"
    return out


@contextlib.contextmanager
def fma_loop():
    """Inside, float32 rows take the FMA loop of ``csrc/block_score.cuh``
    (the f32 C entries' ``ring = 0``) in kernels 1, 3, 4, 5 and 7: the loop
    rules ``topk.scoring_loop`` (also as ``grouped_mask`` imported it) and
    ``ivf_scan.ivf_scoring_loop`` answer ``"fma"`` for float32, so the
    wrappers launch it.  The reference of the f32 ring's bit-for-bit
    checks."""
    import torch

    from photo_search_engine_tpu_torch.ops import grouped_mask, ivf_scan, topk

    def fma_for_f32(rule):
        return lambda corpus, *args: "fma" if corpus.dtype == torch.float32 else rule(corpus, *args)

    rules = [(topk, "scoring_loop"), (grouped_mask, "scoring_loop"), (ivf_scan, "ivf_scoring_loop")]
    saved = [getattr(module, name) for module, name in rules]
    for (module, name), rule in zip(rules, saved):
        setattr(module, name, fma_for_f32(rule))
    try:
        yield
    finally:
        for (module, name), rule in zip(rules, saved):
            setattr(module, name, rule)


@contextlib.contextmanager
def plain_scan(module, name, plain=None):
    """Inside, ``module.name`` is its plain version (``plain``, default
    ``module.<name>_plain``): the search around the scan (probes, merge,
    rescore) runs the same code."""
    kernel = getattr(module, name)
    setattr(module, name, plain or getattr(module, name + "_plain"))
    try:
        yield
    finally:
        setattr(module, name, kernel)


def _upload_bytes():
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (320, 240), (235, 165, 85)).save(buf, format="JPEG")
    return buf.getvalue()


def run_flow(client, photo_dir):
    """Build the index through the routes, then the five searches."""
    assert client.post("/init_index", json_body={"mode": "full"}).status_code == 200
    deadline = time.time() + 60
    while time.time() < deadline:
        status = client.get("/index_status").get_json()
        if status["status"] in {"success", "ready", "failed"}:
            break
        time.sleep(0.05)
    assert status["status"] in {"success", "ready"}, status
    out = {"status": {k: status[k] for k in ("status", "indexed_count", "total_count")}}
    out["text"] = client.post("/search_photos", json_body={"query": "beach sunset sea", "top_k": 3}).get_json()
    out["season"] = client.post("/search_photos", json_body={"query": "夏天的照片", "top_k": 6}).get_json()
    # search text plus a season: without a keyword index this is the masked
    # vector search (the grouped scan under the micro-batcher)
    out["season_text"] = client.post("/search_photos", json_body={"query": "夏天 海边", "top_k": 6}).get_json()
    out["image"] = client.post(
        "/search_by_image", json_body={"image_path": os.path.join(photo_dir, "beach_sunset_sea.jpg"), "top_k": 3}
    ).get_json()
    out["upload"] = client.post(
        "/search_by_uploaded_image", data={"top_k": "3"}, files={"image": ("fresh.jpg", _upload_bytes())}
    ).get_json()
    for name in ("text", "season", "image", "upload"):
        assert out[name]["status"] == "success" and out[name]["results"], (name, out[name])
    # the keyword channel's relevance floors may rightly leave this one empty
    assert out["season_text"]["status"] == "success", out["season_text"]
    return out


def run_online_flow(post, photo_dir):
    """The searches of the online profile: a text search with the text and
    visual reranks, an image search and an upload search with the visual
    rerank.  ``post(path, body, files=None)`` returns the decoded JSON.
    Each response must report the reranks it asked for."""
    out = {}
    out["text"] = post("/search_photos", {"query": "beach sunset sea", "top_k": 4,
                                          "enable_text_rerank": True, "enable_visual_rerank": True})
    out["image"] = post("/search_by_image", {"image_path": os.path.join(photo_dir, "beach_sunset_sea.jpg"),
                                             "top_k": 3, "enable_visual_rerank": True})
    out["upload"] = post("/search_by_uploaded_image", {"top_k": "3", "enable_visual_rerank": "1"},
                         files={"image": ("fresh.jpg", _upload_bytes())})
    for name, flags in (("text", ("text_reranked", "visual_reranked")), ("image", ("visual_reranked",)),
                        ("upload", ("visual_reranked",))):
        payload = out[name]
        assert payload["status"] == "success" and payload["results"], (name, str(payload)[:300])
        assert all(payload[flag] for flag in flags), (name, {f: payload.get(f) for f in flags})
        for flag in flags:
            field = flag.replace("reranked", "rerank_score")
            assert all(field in hit for hit in payload["results"]), (name, field)
    return out


# ---------------------------------------------------------------------------
# The stand-in for an OpenAI-compatible server
# ---------------------------------------------------------------------------

_TOKEN = re.compile(r"[a-z0-9]+|[^\x00-\x7f]")


def standin_tokens(text):
    """Lower-case ASCII words and single non-ASCII characters."""
    return _TOKEN.findall(str(text).lower())


def _seeded(key, dim):
    seed = int.from_bytes(hashlib.blake2b(key.encode("utf-8"), digest_size=8, key=b"pse-standin").digest(), "little")
    return np.random.default_rng(seed).normal(size=dim)


def standin_vector(text, dim):
    """The stand-in's embedding: the sum of one seeded Gaussian vector per
    token (the text itself when it has none), as a float32 unit vector, so
    that texts sharing words lie close."""
    tokens = standin_tokens(text) or [str(text)]
    vec = np.zeros(dim)
    for token in tokens:
        vec += _seeded(token, dim)
    vec = vec.astype(np.float32)
    return vec / np.linalg.norm(vec)


def standin_scores(query, documents):
    """The share of the query's tokens in each document (the rule of
    /rerank and of the text chat rerank)."""
    want = set(standin_tokens(query))
    return [len(want & set(standin_tokens(doc))) / max(len(want), 1) for doc in documents]


def standin_rerank(body):
    """The answer of ``POST /rerank``: every document scored, best first,
    ties to the smaller index, ``top_n`` kept."""
    scores = standin_scores(body["query"], body["documents"])
    order = sorted(range(len(scores)), key=lambda i: (-scores[i], i))[: int(body.get("top_n") or len(scores))]
    return {"results": [{"index": i, "relevance_score": round(scores[i], 4)} for i in order]}


def standin_chat(body):
    """The answer of ``POST /chat/completions``: a JSON ``ranking``.  A
    visual prompt (a content list, or the JSON string of one) ranks its
    candidate images by a seeded hash of their data URLs; a text rerank
    prompt ranks its documents by :func:`standin_scores`."""
    content = body["messages"][0]["content"]
    if isinstance(content, str) and content.startswith("["):
        content = json.loads(content)
    if isinstance(content, list):
        urls = []
        for part, after in zip(content, content[1:]):
            if part.get("type") == "text" and str(part.get("text", "")).startswith("候选图片"):
                image = after.get("image_url")
                urls.append(image["url"] if isinstance(image, dict) else image)
        ranking = sorted(range(1, len(urls) + 1),
                         key=lambda i: hashlib.blake2b(urls[i - 1].encode(), digest_size=8).digest())
        answer = {"ranking": ranking}
    else:
        query = re.search(r"^query: (.*)$", content, re.M).group(1)
        documents = json.loads(re.search(r"^documents: (.*)$", content, re.M).group(1))
        scores = standin_scores(query, [d["text"] for d in documents])
        order = sorted(range(len(scores)), key=lambda i: (-scores[i], i))
        answer = {"ranking": [{"index": documents[i]["index"], "score": round(scores[i], 4)} for i in order]}
    return {"choices": [{"message": {"role": "assistant", "content": json.dumps(answer)}}]}


class StandInServer:
    """A local stand-in for an OpenAI-compatible server on 127.0.0.1, in a
    thread: ``/v1/embeddings`` (:func:`standin_vector` of each input, of
    the requested ``dimensions``, else ``dim``), ``/v1/rerank``
    (:func:`standin_rerank`) and ``/v1/chat/completions``
    (:func:`standin_chat`).  It counts the calls of each path and the
    inputs of each embeddings call.  Use it as a context manager."""

    def __init__(self, dim=1536):
        self.dim = dim
        self.calls = {"/v1/embeddings": 0, "/v1/rerank": 0, "/v1/chat/completions": 0}
        self.embed_inputs = []  # inputs of each /v1/embeddings call
        self._lock = threading.Lock()
        self._server = None
        self._thread = None

    @property
    def base_url(self):
        return f"http://127.0.0.1:{self._server.server_address[1]}/v1"

    def _answer(self, path, body):
        if path == "/v1/embeddings":
            inputs = body["input"] if isinstance(body["input"], list) else [body["input"]]
            with self._lock:
                self.embed_inputs.append(len(inputs))
            dim = int(body.get("dimensions") or self.dim)
            return {"object": "list", "model": body.get("model"),
                    "data": [{"object": "embedding", "index": i, "embedding": standin_vector(t, dim).tolist()}
                             for i, t in enumerate(inputs)]}
        if path == "/v1/rerank":
            return standin_rerank(body)
        if path == "/v1/chat/completions":
            return standin_chat(body)
        return None

    def __enter__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — the http.server hook
                body = json.loads(self.rfile.read(int(self.headers.get("Content-Length") or 0)) or b"{}")
                answer = outer._answer(self.path, body)
                if answer is None:
                    self.send_error(404)
                    return
                with outer._lock:
                    outer.calls[self.path] += 1
                data = json.dumps(answer).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(10)
        return False

"""The slice as a whole: the same PIL photo library served by the JAX app
and by the port's app, without the micro-batcher and with it (the default:
the season-filtered search then takes the grouped scan).  Index build, a
text search, a season-filtered search, an image search and an upload
search return the same route JSON, timing fields dropped and float fields
within 1e-5.  Then the port's app runs the same flow in a process where
importing ``jax`` or the JAX package fails.  The port's own config loader and an index installed
in memory (as ``chip_smoke.py`` serves its large corpus) are wired by the
same ``initialize_services``.  The online profile (OpenAI-compatible
embeddings, the API text rerank and the LLM visual rerank) is served by
both apps with the same mocked clients, and by the port over HTTP to a
local stand-in server; a rerank service that fails to build is served as
``None`` with the JAX app's ``[WARN]`` line."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from photo_search_engine_tpu.api.app import create_app as jax_create_app
from photo_search_engine_tpu.api.app import initialize_services as jax_initialize
from photo_search_engine_tpu.config import load_config, reset_config_cache
from photo_search_engine_tpu_torch.api.app import create_app, initialize_services
from photo_search_engine_tpu_torch.api.app import load_config as port_load_config
from photo_search_engine_tpu_torch.core.batcher import BatchedEmbeddingService, MicroBatcher
from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
from photo_search_engine_tpu_torch.device import resolve_device
from tests.torch_parity import (
    StandInServer,
    run_flow,
    run_online_flow,
    standin_chat,
    standin_rerank,
    standin_vector,
    unit_rows,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from demo_e2e import make_library  # noqa: E402  (stdlib + PIL only)

_CLEARED = ("LLM_", "VISION_", "EMBEDDING_", "QUERY_", "TEXT_", "VISUAL_", "TIME_", "SEARCH_",
            "KEYWORD_", "PHOTO_", "DATA_", "RUNTIME_", "INDEX_", "METADATA_", "STORE_",
            "VECTOR_", "MESH_", "DIST_", "PSE_")
_TIMING_KEYS = {"elapsed_time", "timing", "latency_ms"}


def _config(monkeypatch, photo_dir, data_dir, **extra):
    for key in list(os.environ):
        if key.startswith(_CLEARED):
            monkeypatch.delenv(key)
    env = {"PHOTO_DIR": photo_dir, "DATA_DIR": data_dir, "RUNTIME_DATA_DIR": data_dir,
           "EMBEDDING_DIMENSION": "256", "SEARCH_MICROBATCH_ENABLED": "0", "PSE_PLATFORM": "cpu", **extra}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    reset_config_cache()
    return load_config()


def _normalize(value):
    if isinstance(value, dict):
        return {k: _normalize(v) for k, v in value.items() if k not in _TIMING_KEYS}
    if isinstance(value, list):
        return [_normalize(v) for v in value]
    return value


def _assert_close(got, ref, path="$"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and got.keys() == ref.keys(), (path, sorted(got), sorted(ref))
        for key in ref:
            _assert_close(got[key], ref[key], f"{path}.{key}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_close(g, r, f"{path}[{i}]")
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert isinstance(got, (int, float)) and abs(got - ref) <= 1e-5, (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


def _drop_upload_temp_paths(payload):
    """The upload route names its temporary copy; the name is random."""
    for key in ("query_image_path",):
        payload.pop(key, None)
    debug = payload.get("search_debug") or {}
    debug.get("base_intent", {}).pop("image_path", None)
    return payload


@pytest.fixture()
def library(tmp_path):
    photo_dir = tmp_path / "photos"
    photo_dir.mkdir()
    make_library(str(photo_dir))
    return tmp_path, str(photo_dir)


def _close_batchers(services):
    index = services["vector_index"]
    if hasattr(index, "_microbatcher"):
        index._microbatcher.close()
        services["searcher"].embedding_service._batcher.close()


_TIED = 0.5  # the vector_score of a row whose cosine to the query is exactly 0


def _blank_exact_ties(value):
    """The route JSON with the identity of every result whose similarity to
    the query is exactly 0 blanked (its scores stay).  The hashing embedder
    gives rows that share no token with the query a cosine of exactly 0, so
    such rows tie; which of them fills a slot is the merge's tie order, and
    the JAX package's sharded top_k orders +0.0 above -0.0, whose sign is
    that of XLA's accumulation order (it changed under a loaded host)."""
    if isinstance(value, dict):
        out = {k: _blank_exact_ties(v) for k, v in value.items()}
        if out.get("vector_score") == _TIED and "photo_path" in out:
            out.update({k: "<tie>" for k in ("photo_path", "file_name", "description", "photo_url",
                                              "match_summary") if k in out})
        return out
    if isinstance(value, list):
        return [_blank_exact_ties(v) for v in value]
    return value


def _compare_apps(library, monkeypatch, grouped_route=None, canonical=None, **extra):
    """Run the flow through the JAX app and the port's app on the same
    library and config; the route JSON must agree.  Returns both services.

    ``grouped_route``: the route name the port reports for the season
    search with text, which the micro-batcher runs as a grouped scan.  It
    is taken out of both debugs first: the JAX grouped path leaves
    ``last_route`` as the previous search set it.  ``canonical``, when
    given, is applied to both outputs before they are compared."""
    tmp, photo_dir = library
    # the upload route analyses its temporary copy, whose name feeds the
    # local analysis: give both apps the same name
    import tempfile

    monkeypatch.setattr(tempfile, "_get_candidate_names", lambda: iter(["pse_upload"]))
    jax_services = jax_initialize(_config(monkeypatch, photo_dir, str(tmp / "jax_data"), **extra))
    jax_out = run_flow(jax_create_app(jax_services).test_client(), photo_dir)
    services = initialize_services(_config(monkeypatch, photo_dir, str(tmp / "port_data"), **extra))
    assert services["device"] == torch.device("cpu")
    port_out = run_flow(create_app(services).test_client(), photo_dir)
    for name in ("upload",):
        _drop_upload_temp_paths(jax_out[name])
        _drop_upload_temp_paths(port_out[name])
    if grouped_route is not None:
        jax_out["season_text"]["search_debug"].pop("index_route")
        assert port_out["season_text"]["search_debug"].pop("index_route")["impl"] == grouped_route
    if canonical is not None:
        jax_out, port_out = canonical(jax_out), canonical(port_out)
    _assert_close(_normalize(port_out), _normalize(jax_out))
    return jax_services, services


def test_route_json_matches_jax_app(library, monkeypatch):
    _, services = _compare_apps(library, monkeypatch)
    assert services["vector_index"].last_route["impl"] in {"exact", "exact_masked"}


@pytest.mark.parametrize("keyword_backend", ["builtin", "none"])
def test_route_json_matches_jax_app_microbatched(library, monkeypatch, keyword_backend):
    """Both apps with the micro-batcher on.  Without a keyword index the
    searcher sends the season filter to ``search_masked``, which the
    micro-batcher runs as a grouped scan."""
    jax_services, services = _compare_apps(
        library, monkeypatch, grouped_route="exact_grouped" if keyword_backend == "none" else None,
        SEARCH_MICROBATCH_ENABLED="1", KEYWORD_BACKEND=keyword_backend,
    )
    grouped = services["vector_index"]._microbatcher.grouped_batches_run
    assert grouped == jax_services["vector_index"]._microbatcher.grouped_batches_run
    assert grouped == (1 if keyword_backend == "none" else 0)
    assert services["vector_index"]._microbatcher.requests_served >= 3
    _close_batchers(jax_services)
    _close_batchers(services)


@pytest.mark.parametrize("microbatch", ["0", "1"])
def test_route_json_matches_jax_app_ivf(library, monkeypatch, microbatch):
    """``VECTOR_INDEX_TYPE=ivf`` in both apps: unfiltered searches report
    the ``ivf`` route and, off the micro-batcher, the season search with
    text reports ``ivf_masked`` (under it, the grouped scan of the flat
    store, as in the JAX batcher)."""
    jax_services, services = _compare_apps(
        library, monkeypatch, grouped_route="exact_grouped" if microbatch == "1" else None,
        VECTOR_INDEX_TYPE="ivf", IVF_NPROBE="4", KEYWORD_BACKEND="none", SEARCH_MICROBATCH_ENABLED=microbatch,
    )
    index = services["vector_index"]
    assert index.index_type == "ivf" and index._ivf is not None
    assert index.last_route == {"impl": "ivf", "nprobe": 4, "mesh_devices": 0}
    assert index.describe()["ivf_nprobe_effective"] == 4 and index.ivf_nlist == 1024
    _close_batchers(jax_services)
    _close_batchers(services)


_JAX_BLOCKED = r"""
import json, os, sys
# any import of jax or of the JAX package now fails
sys.modules["jax"] = None
sys.modules["photo_search_engine_tpu"] = None
sys.path.insert(0, os.environ["REPO"])
from tests.torch_parity import run_flow
from photo_search_engine_tpu_torch.api.app import create_app, initialize_services, load_config
services = initialize_services(load_config())
out = run_flow(create_app(services).test_client(), os.environ["PHOTO_DIR"])
loaded = sorted(m for m in sys.modules if m in ("jax", "photo_search_engine_tpu")
                or m.startswith(("jax.", "jaxlib", "photo_search_engine_tpu.")))
print(json.dumps({"device": str(services["device"]), "loaded": loaded,
                  "route": services["vector_index"].last_route,
                  "counts": {k: len(out[k]["results"]) for k in ("text", "season", "image", "upload")}}))
"""


def _serve_with_jax_absent(library, **extra):
    tmp, photo_dir = library
    env = {k: v for k, v in os.environ.items() if not k.startswith(_CLEARED)}
    env.update(PHOTO_DIR=photo_dir, DATA_DIR=str(tmp / "data"), RUNTIME_DATA_DIR=str(tmp / "data"),
               EMBEDDING_DIMENSION="256", SEARCH_MICROBATCH_ENABLED="0", PSE_PLATFORM="cpu", REPO=REPO, **extra)
    done = subprocess.run([sys.executable, "-c", _JAX_BLOCKED], env=env, cwd=str(tmp),
                          capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    # only the blocking None entries
    assert result["device"] == "cpu" and result["loaded"] == ["jax", "photo_search_engine_tpu"]
    assert all(n > 0 for n in result["counts"].values()), result
    return result


def test_port_app_serves_with_jax_absent(library):
    _serve_with_jax_absent(library)


def test_port_app_serves_ivf_with_jax_absent(library):
    result = _serve_with_jax_absent(library, VECTOR_INDEX_TYPE="ivf", IVF_NPROBE="2")
    assert result["route"] == {"impl": "ivf", "nprobe": 2, "mesh_devices": 0}


def test_gpu_platform_needs_cuda(monkeypatch):
    monkeypatch.setenv("PSE_PLATFORM", "gpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert torch.backends.cuda.matmul.allow_tf32 is False
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
    with pytest.raises(ValueError):
        resolve_device("tpu")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize(
    "env",
    [
        {"VECTOR_INDEX_TYPE": "ivf", "MESH_DEVICES": "2"},
        {"MESH_DEVICES": "2"},
        {"DIST_COORDINATOR": "localhost:1234", "DIST_NUM_PROCESSES": "2", "DIST_PROCESS_ID": "0"},
    ],
)
def test_unported_configurations_raise(library, monkeypatch, env):
    """The configurations the port once refused are served now: a mesh of
    two host shards (flat and IVF), and a ``DIST_*`` config, which only
    ``main`` joins (``initialize_services`` alone serves one process, as
    in the JAX app); ``_apply_distributed`` refuses an invalid triplet."""
    tmp, photo_dir = library
    cfg = _config(monkeypatch, photo_dir, str(tmp / "data"), **env)
    services = initialize_services(cfg)
    index = services["vector_index"]
    out = run_flow(create_app(services).test_client(), photo_dir)
    assert all(out[k]["results"] for k in ("text", "image")), out
    assert index.mesh_devices == (0 if "DIST_COORDINATOR" in env else 2)
    assert index.last_route["mesh_devices"] == index.mesh_devices
    assert type(index._store).__name__ == ("EmbeddingStore" if "DIST_COORDINATOR" in env else "MeshEmbeddingStore")
    if "DIST_COORDINATOR" in env:
        from photo_search_engine_tpu_torch.api.app import _apply_distributed

        with pytest.raises(ValueError, match="DIST_NUM_PROCESSES"):
            _apply_distributed(dict(cfg, DIST_NUM_PROCESSES=1))


@pytest.mark.parametrize("mesh_devices, want", [("0", 0), ("3", 3), ("-1", 1)])
def test_mesh_devices_on_the_host(mesh_devices, want):
    """The host holds any number of logical shards; -1 there is one."""
    from photo_search_engine_tpu_torch.api.app import _resolve_mesh_devices

    assert _resolve_mesh_devices(mesh_devices, torch.device("cpu")) == want


def test_mesh_devices_on_cards_are_clamped(monkeypatch, capsys):
    from photo_search_engine_tpu_torch.api.app import _resolve_mesh_devices

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert _resolve_mesh_devices(-1, torch.device("cuda", 0)) == 2
    assert _resolve_mesh_devices(1, torch.device("cuda", 0)) == 1
    assert _resolve_mesh_devices(4, torch.device("cuda", 0)) == 2
    assert "MESH_DEVICES=4 but only 2 device(s) visible" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [{}, {"SEARCH_MICROBATCH_ENABLED": "1", "KEYWORD_BACKEND": "none"},
                                   {"VECTOR_INDEX_TYPE": "ivf", "IVF_NPROBE": "4"}],
                         ids=["flat", "microbatched_grouped", "ivf"])
def test_route_json_matches_jax_app_on_a_mesh(library, monkeypatch, extra):
    """``MESH_DEVICES=4`` in both apps (JAX: 4 of its 8 CPU devices; the
    port: 4 host shards): the same route JSON, ``mesh_devices`` 4 in the
    routes the searches report.  Results that tie at a similarity of
    exactly 0 are compared by their scores (``_blank_exact_ties``)."""
    grouped = "exact_grouped" if extra.get("KEYWORD_BACKEND") == "none" else None
    jax_services, services = _compare_apps(library, monkeypatch, grouped_route=grouped,
                                           canonical=_blank_exact_ties, MESH_DEVICES="4", **extra)
    index = services["vector_index"]
    assert index.mesh_devices == 4 and index._store.n_shards == 4
    assert index.last_route["mesh_devices"] == 4
    _close_batchers(jax_services)
    _close_batchers(services)


_ONLINE_KEYS = {"EMBEDDING_API_KEY": "k", "TEXT_RERANK_API_KEY": "k"}


@pytest.mark.parametrize(
    "env, services",
    [
        ({"EMBEDDING_BACKEND": "openai", "EMBEDDING_BASE_URL": "http://localhost:1/v1"},
         ("OpenAICompatibleEmbeddingService", "TextRerankService", "LocalVisualRerankService")),
        ({"TEXT_RERANK_BACKEND": "api"},  # no base URL and no key: served as None
         ("HashingEmbeddingService", None, "LocalVisualRerankService")),
        ({"TEXT_RERANK_BACKEND": "chat", "TEXT_RERANK_BASE_URL": "http://localhost:1/v1"},
         ("HashingEmbeddingService", "TextRerankService", "LocalVisualRerankService")),
        ({"VISUAL_RERANK_BASE_URL": "http://localhost:1/v1", "VISUAL_RERANK_API_KEY": "k"},
         ("HashingEmbeddingService", "DeviceTextRerankService", "VisualRerankService")),
        ({"EMBEDDING_BASE_URL": "http://localhost:1/v1"},  # the auto backend with a base URL
         ("OpenAICompatibleEmbeddingService", "TextRerankService", "LocalVisualRerankService")),
    ],
)
def test_online_configurations_are_served_as_jax_serves_them(library, monkeypatch, env, services):
    """The online profile starts (no request is sent), with the services
    the JAX app builds for the same configuration."""
    tmp, photo_dir = library
    cfg = _config(monkeypatch, photo_dir, str(tmp / "data"), **_ONLINE_KEYS, **env)
    if env.get("TEXT_RERANK_BACKEND") == "api":
        cfg["TEXT_RERANK_API_KEY"] = ""
    port, jax = initialize_services(cfg), jax_initialize(cfg)
    for wired in (port, jax):
        built = tuple(None if wired[key] is None else type(wired[key]).__name__
                      for key in ("embedding_service", "text_rerank_service", "visual_rerank_service"))
        assert built == services
    embedder = port["embedding_service"]
    if hasattr(embedder, "model_name"):
        for attr in ("model_name", "base_url", "timeout", "max_retries", "dimension", "api_key"):
            assert getattr(embedder, attr) == getattr(jax["embedding_service"], attr), attr


@pytest.mark.parametrize("env", [
    {"EMBEDDING_BACKEND": "openai", "EMBEDDING_BASE_URL": "https://e.example/v1", "EMBEDDING_API_KEY": "k",
     "EMBEDDING_MODEL": "Qwen/Qwen3-Embedding-8B", "TIMEOUT": "17", "MAX_RETRIES": "5"},
    {"EMBEDDING_BASE_URL": "http://localhost:11434"},  # auto, an Ollama URL: keyless
    {"EMBEDDING_BACKEND": "openai", "EMBEDDING_BASE_URL": "https://e.example/v1", "EMBEDDING_API_KEY": "k",
     "EMBEDDING_DIMENSION": ""},  # no dimension: the width comes from the first response
    {"EMBEDDING_BACKEND": "local"},
    {},
])
def test_build_embedding_service_matches_jax(library, monkeypatch, env):
    from photo_search_engine_tpu.api.app import _build_embedding_service as jax_build
    from photo_search_engine_tpu_torch.api.app import _build_embedding_service

    tmp, photo_dir = library
    cfg = _config(monkeypatch, photo_dir, str(tmp / "data"), **env)
    port, jax = _build_embedding_service(cfg, torch.device("cpu")), jax_build(cfg)
    assert type(port).__name__ == type(jax).__name__
    keys = ("model_name", "base_url", "timeout", "max_retries", "api_key") if hasattr(jax, "model_name") else ()
    for attr in keys + ("dimension",):
        assert getattr(port, attr) == getattr(jax, attr), attr


@pytest.mark.parametrize("broken, line", [
    ({"TEXT_RERANK_BACKEND": "api", "TEXT_RERANK_BASE_URL": "https://r.example/v1"},
     "[WARN] text rerank disabled: TEXT_RERANK_API_KEY is not set"),
    ({"VISUAL_RERANK_BASE_URL": "https://v.example/v1", "VISUAL_RERANK_API_KEY": "k", "VISUAL_RERANK_MODEL": "",
      "VISION_MODEL": ""},
     "[WARN] visual rerank disabled: VISUAL_RERANK_MODEL is not set"),
])
def test_rerank_that_fails_to_build_is_served_as_none(library, monkeypatch, capsys, broken, line):
    tmp, photo_dir = library
    cfg = _config(monkeypatch, photo_dir, str(tmp / "data"), **broken)
    key = "text_rerank_service" if "TEXT" in line else "visual_rerank_service"
    for init in (jax_initialize, initialize_services):
        capsys.readouterr()
        assert init(cfg)[key] is None
        assert line in capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("service", ["DeviceTextRerankService", "LocalVisualRerankService"])
def test_local_rerank_that_fails_to_build_is_served_as_none(library, monkeypatch, capsys, service):
    from photo_search_engine_tpu_torch.api import app as port_app

    def broken(*args, **kwargs):
        raise RuntimeError("no device memory")

    monkeypatch.setattr(port_app, service, broken)
    tmp, photo_dir = library
    services = initialize_services(_config(monkeypatch, photo_dir, str(tmp / "data")))
    key = "text_rerank_service" if service.startswith("Device") else "visual_rerank_service"
    what = "text" if key.startswith("text") else "visual"
    assert services[key] is None
    assert f"[WARN] {what} rerank disabled: no device memory" in capsys.readouterr().out.splitlines()
    # the app serves without it: an asked-for rerank reports that it did not run
    client = create_app(services).test_client()
    run_flow(client, photo_dir)
    got = client.post("/search_photos", json_body={"query": "beach sunset sea", "top_k": 3,
                                                   "enable_text_rerank": True, "enable_visual_rerank": True}).get_json()
    assert got["status"] == "success" and not got[f"{what}_reranked"]


class _StandInClient:
    """An ``OpenAIHttpClient`` stand-in answering by the rules of
    ``tests/torch_parity.py``'s stand-in server, without a socket."""

    def __init__(self, api_key, base_url, timeout=60):
        from types import SimpleNamespace

        self.embeddings = SimpleNamespace(create=self._embed)
        self.chat = SimpleNamespace(completions=SimpleNamespace(create=lambda **kw: standin_chat(kw)))

    @staticmethod
    def _embed(**kw):
        inputs = kw["input"] if isinstance(kw["input"], list) else [kw["input"]]
        return {"data": [{"embedding": standin_vector(t, int(kw.get("dimensions") or 256)).tolist()}
                         for t in inputs]}


class _StandInSession:
    def post(self, url, json=None, headers=None, timeout=None):
        from unittest.mock import Mock

        response = Mock()
        response.json.return_value = standin_rerank(json)
        response.raise_for_status.return_value = None
        return response


def _patch_online_clients(monkeypatch):
    from types import SimpleNamespace

    from photo_search_engine_tpu.services import embedding as jax_embedding
    from photo_search_engine_tpu.services import rerank as jax_rerank
    from photo_search_engine_tpu_torch.services import embedding as port_embedding
    from photo_search_engine_tpu_torch.services import rerank as port_rerank

    for module in (jax_embedding, jax_rerank, port_embedding, port_rerank):
        monkeypatch.setattr(module, "OpenAIHttpClient", _StandInClient)
    for module in (jax_embedding, port_embedding):
        monkeypatch.setattr(module, "requests", SimpleNamespace(Session=_StandInSession))


def _test_client_post(client):
    def post(path, body, files=None):
        if files:
            return client.post(path, data=body, files=files).get_json()
        return client.post(path, json_body=body).get_json()

    return post


_ONLINE = {"EMBEDDING_BASE_URL": "https://standin.example/v1", "EMBEDDING_API_KEY": "k",
           "VISUAL_RERANK_BASE_URL": "https://standin.example/v1", "VISUAL_RERANK_API_KEY": "k",
           "RERANK_MAX_IMAGES": "2"}


@pytest.mark.parametrize("text_backend", ["api", "chat"])
def test_online_route_json_matches_jax_app(library, monkeypatch, text_backend):
    """The online profile in both apps, with the same mocked clients: the
    embeddings, the text rerank (``api`` or ``chat``) and the visual rerank
    (a tournament over chunks of two) give the same route JSON."""
    import tempfile

    _patch_online_clients(monkeypatch)
    monkeypatch.setattr(tempfile, "_get_candidate_names", lambda: iter(["pse_upload"]))
    tmp, photo_dir = library
    outs = []
    for init, create, name in ((jax_initialize, jax_create_app, "jax"), (initialize_services, create_app, "port")):
        services = init(_config(monkeypatch, photo_dir, str(tmp / f"{name}_data"), TEXT_RERANK_BACKEND=text_backend,
                                **_ONLINE))
        assert type(services["embedding_service"]).__name__ == "OpenAICompatibleEmbeddingService"
        client = create(services).test_client()
        out = run_flow(client, photo_dir)
        out.update({f"online_{k}": v for k, v in run_online_flow(_test_client_post(client), photo_dir).items()})
        for key in ("upload", "online_upload"):
            _drop_upload_temp_paths(out[key])
        outs.append(out)
    _assert_close(_normalize(outs[1]), _normalize(outs[0]))


def test_online_profile_against_a_local_standin_server(library, monkeypatch):
    """The port's online profile over real HTTP (``OpenAIHttpClient``) to
    the stand-in server on 127.0.0.1, the micro-batcher on: the routes run
    the reranks, and concurrent text searches reach ``/v1/embeddings`` as
    coalesced list calls."""
    import threading

    tmp, photo_dir = library
    with StandInServer(dim=256) as standin:
        cfg = _config(monkeypatch, photo_dir, str(tmp / "data"), SEARCH_MICROBATCH_ENABLED="1",
                      SEARCH_MICROBATCH_WINDOW_MS="200", QUERY_CACHE_ENABLED="0", EMBEDDING_CACHE_ENABLED="0",
                      EMBEDDING_BASE_URL=standin.base_url, EMBEDDING_API_KEY="k", TEXT_RERANK_BACKEND="chat",
                      VISUAL_RERANK_BASE_URL=standin.base_url, VISUAL_RERANK_API_KEY="k")
        services = initialize_services(cfg)
        try:
            client = create_app(services).test_client()
            run_flow(client, photo_dir)
            run_online_flow(_test_client_post(client), photo_dir)
            assert standin.calls["/v1/chat/completions"] >= 4 and standin.calls["/v1/rerank"] == 0
            before = len(standin.embed_inputs)
            start = threading.Barrier(6)
            answers = {}

            def search(i):
                start.wait(30)
                answers[i] = client.post("/search_photos", json_body={"query": f"beach sea {i}", "top_k": 3}).get_json()

            threads = [threading.Thread(target=search, args=(i,)) for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert all(answers[i]["status"] == "success" for i in range(6))
            sizes = standin.embed_inputs[before:]
            assert sum(sizes) == 6 and max(sizes) > 1, sizes  # coalesced list calls
        finally:
            _close_batchers(services)


def test_microbatch_default_attaches_batchers(library, monkeypatch):
    """With the knob at its default, the batched embedder and the
    micro-batcher are wired as the JAX app wires them."""
    tmp, photo_dir = library
    cfg = _config(monkeypatch, photo_dir, str(tmp / "data"), SEARCH_MICROBATCH_WINDOW_MS="7",
                  SEARCH_MICROBATCH_MAX_BATCH="16", SEARCH_MICROBATCH_PIPELINE="3")
    monkeypatch.delenv("SEARCH_MICROBATCH_ENABLED")
    reset_config_cache()
    cfg = load_config()
    assert cfg["SEARCH_MICROBATCH_ENABLED"] is True  # the config default
    services = initialize_services(cfg)
    jax_services = jax_initialize(cfg)
    for wired in (services, jax_services):
        batcher = wired["vector_index"]._microbatcher
        assert (batcher.window_s, batcher.max_batch, batcher.pipeline) == (0.007, 16, 3)
        assert type(wired["searcher"].embedding_service).__name__ == "BatchedEmbeddingService"
        assert wired["embedding_service"] is wired["indexer"].embedding_service
    assert isinstance(services["vector_index"]._microbatcher, MicroBatcher)
    assert isinstance(services["searcher"].embedding_service, BatchedEmbeddingService)
    assert services["indexer"].worker_entrypoint == ["-m", "photo_search_engine_tpu_torch.api.app"]
    _close_batchers(services)
    _close_batchers(jax_services)


def test_port_load_config_keeps_its_overrides(monkeypatch, tmp_path):
    for key in list(os.environ):
        if key.startswith(_CLEARED):
            monkeypatch.delenv(key)
    cfg = port_load_config({"DATA_DIR": str(tmp_path), "TOP_K": "7", "PSE_PLATFORM": "cpu",
                            "SEARCH_MICROBATCH_ENABLED": "0"})
    assert cfg["TOP_K"] == 7 and cfg["PSE_PLATFORM"] == "cpu"
    assert cfg["SEARCH_MICROBATCH_ENABLED"] is False
    assert "PSE_PLATFORM" not in os.environ and "TOP_K" not in os.environ  # restored
    assert not hasattr(initialize_services(cfg)["vector_index"], "_microbatcher")
    services = initialize_services(port_load_config({"DATA_DIR": str(tmp_path), "PSE_PLATFORM": "cpu",
                                                     "SEARCH_MICROBATCH_ENABLED": "1"}))
    assert isinstance(services["vector_index"]._microbatcher, MicroBatcher)
    _close_batchers(services)
    # the device comes from the config, not from the environment at call time
    assert initialize_services(cfg)["device"] == torch.device("cpu")


def test_installed_index_serves_the_routes(monkeypatch, tmp_path):
    for key in list(os.environ):
        if key.startswith(_CLEARED):
            monkeypatch.delenv(key)
    rng = np.random.default_rng(11)
    rows = unit_rows(rng, 64, 256)
    index = VectorIndex(256, index_path=str(tmp_path / "i.index"), metadata_path=str(tmp_path / "m.json"),
                        quantized=True, device=torch.device("cpu"))
    index.load_device_rows(torch.from_numpy(rows), [
        {"photo_path": f"/photos/{i}.jpg", "file_name": f"IMG_{i:04d}.jpg", "description": f"row {i}"}
        for i in range(64)
    ])
    cfg = port_load_config({"DATA_DIR": str(tmp_path), "RUNTIME_DATA_DIR": str(tmp_path),
                            "EMBEDDING_DIMENSION": "256", "PSE_PLATFORM": "cpu", "SEARCH_MICROBATCH_ENABLED": "0"})
    services = initialize_services(cfg, vector_index=index)
    assert services["vector_index"] is index and services["searcher"].index_loaded
    client = create_app(services).test_client()
    got = client.post("/search_by_image", json_body={"image_path": "/photos/5.jpg", "top_k": 3}).get_json()
    assert got["status"] == "success" and got["results"], got
    assert index.last_route["impl"] == "int8"
    # the image search's vector results are the plain exact search's
    want = np.argsort(-(rows @ rows[5]), kind="stable")[:3]
    np.testing.assert_array_equal(index.raw_search_batch(rows[5:6], 3)[1][0], want)

"""The slice as a whole: the same PIL photo library served by the JAX app
and by the port's app, without the micro-batcher and with it (the default:
the season-filtered search then takes the grouped scan).  Index build, a
text search, a season-filtered search, an image search and an upload
search return the same route JSON, timing fields dropped and float fields
within 1e-5.  Then the port's app runs the same flow in a process where
``import jax`` fails.  The port's own config loader and an index installed
in memory (as ``chip_smoke.py`` serves its large corpus) are wired by the
same ``initialize_services``."""

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
from tests.torch_parity import run_flow, unit_rows

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


def _compare_apps(library, monkeypatch, grouped_route=None, **extra):
    """Run the flow through the JAX app and the port's app on the same
    library and config; the route JSON must agree.  Returns both services.

    ``grouped_route``: the route name the port reports for the season
    search with text, which the micro-batcher runs as a grouped scan.  It
    is taken out of both debugs first: the JAX grouped path leaves
    ``last_route`` as the previous search set it."""
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
sys.modules["jax"] = None  # any import of jax now fails
sys.path.insert(0, os.environ["REPO"])
from tests.torch_parity import run_flow
from photo_search_engine_tpu.config import load_config
from photo_search_engine_tpu_torch.api.app import create_app, initialize_services
services = initialize_services(load_config())
out = run_flow(create_app(services).test_client(), os.environ["PHOTO_DIR"])
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
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
    assert result["device"] == "cpu" and result["loaded"] == ["jax"]  # only the blocking None entry
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
        {"EMBEDDING_BACKEND": "openai", "EMBEDDING_BASE_URL": "http://localhost:1/v1"},
        {"TEXT_RERANK_BACKEND": "api"},
        {"VISUAL_RERANK_BASE_URL": "http://localhost:1/v1", "VISUAL_RERANK_API_KEY": "k"},
        {"VECTOR_INDEX_TYPE": "ivf", "MESH_DEVICES": "2"},  # IVF is ported, the mesh is not
        {"MESH_DEVICES": "2"},
        {"DIST_COORDINATOR": "localhost:1234", "DIST_NUM_PROCESSES": "2", "DIST_PROCESS_ID": "0"},
        {"EMBEDDING_BASE_URL": "http://localhost:1/v1"},  # the auto backend with a base URL
    ],
)
def test_unported_configurations_raise(library, monkeypatch, env):
    tmp, photo_dir = library
    cfg = _config(monkeypatch, photo_dir, str(tmp / "data"), **env)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        initialize_services(cfg)


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

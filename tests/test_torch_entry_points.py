"""The port's entry points against the JAX scripts on the same numpy inputs:
the load test (``scripts/torch_load_test.py`` against
``scripts/load_test.py``: both stacks served and sent the same queries),
the headline bench (``scripts/torch_bench.py``: each variant's search step
against the JAX bench's call), the graft entry
(``photo_search_engine_tpu_torch/graft_entry.py`` against
``__graft_entry__.py``), the health check and the demo.  The JAX side runs
on the CPU, its Pallas kernels in interpret mode as its own tests run
them; the port's with ``PSE_PLATFORM=cpu`` (or ``device="cpu"``), on the
kernels' plain versions.  Ids equal, values within 1e-5."""

import contextlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from photo_search_engine_tpu_torch import graft_entry
from tests.torch_parity import assert_topk_match, unit_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import check_services as jax_check  # noqa: E402
import load_test as jax_load  # noqa: E402
import torch_bench  # noqa: E402
import torch_check_services as port_check  # noqa: E402
import torch_demo_e2e  # noqa: E402
import torch_load_test as port_load  # noqa: E402

TOL = 1e-5
_TIMING_KEYS = {"elapsed_time", "timing", "latency_ms"}
_CLEARED = ("LLM_", "VISION_", "EMBEDDING_", "QUERY_", "TEXT_", "VISUAL_", "TIME_", "SEARCH_", "KEYWORD_",
            "PHOTO_", "DATA_", "RUNTIME_", "INDEX_", "METADATA_", "STORE_", "VECTOR_", "MESH_", "DIST_", "PSE_",
            "BENCH_", "SERVER_")


@pytest.fixture()
def clean_env(monkeypatch):
    """No configuration from the environment; the port on the host."""
    for key in list(os.environ):
        if key.startswith(_CLEARED):
            monkeypatch.delenv(key)
    monkeypatch.setenv("PSE_PLATFORM", "cpu")
    return monkeypatch


def _normalize(value):
    if isinstance(value, dict):
        return {k: _normalize(v) for k, v in value.items() if k not in _TIMING_KEYS}
    if isinstance(value, list):
        return [_normalize(v) for v in value]
    return value


def _assert_close(got, ref, path="$"):
    """The same JSON, floats within ``TOL``."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and got.keys() == ref.keys(), (path, sorted(got), sorted(ref))
        for key in ref:
            _assert_close(got[key], ref[key], f"{path}.{key}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_close(g, r, f"{path}[{i}]")
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert isinstance(got, (int, float)) and abs(got - ref) <= TOL, (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


# ---------------------------------------------------------------------------
# the load test
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _served(module, rows, dim, **kwargs):
    app, vector_index, _ = module.build_stack(rows, dim, False, kwargs.pop("index_type", "flat"), **kwargs)
    server, port = module.serve(app)
    try:
        yield port, vector_index
    finally:
        server.shutdown()
        server.server_close()
        vector_index._microbatcher.close()


def _responses(port, n=8):
    return [_normalize(port_load.post_search(port, q)) for q in port_load.query_pool()[:n]]


def _compare_stacks(rows, dim, **kwargs):
    with _served(jax_load, rows, dim, **dict(kwargs)) as (jax_port, _):
        want = _responses(jax_port)
    with _served(port_load, rows, dim, **dict(kwargs)) as (port, index):
        got = _responses(port)
        route = dict(index.last_route or {})
    for g, w in zip(got, want):
        assert g["status"] == "success" and g["results"], g
        assert [r["photo_path"] for r in g["results"]] == [r["photo_path"] for r in w["results"]]
    _assert_close(got, want)
    return route


@pytest.mark.parametrize("rows, want_k", [(400, 50), (2048, 100)], ids=["kernel_k50", "large_k100"])
def test_load_test_routes_match_jax(clean_env, rows, want_k):
    """400 rows over-fetch 50 candidates (the kernel's path: its plain
    version here), 2048 rows 100 (the plain large-k path)."""
    from photo_search_engine_tpu_torch.core.searcher import Searcher

    class _Sized:
        vector_index = type("Index", (), {"get_total_items": lambda self: rows})()

    assert Searcher._calculate_candidate_k(_Sized(), 10, False) == want_k
    assert _compare_stacks(rows, 64, host_corpus=True)["impl"] == "exact"


def test_fake_device_matches_jax(clean_env):
    clean_env.delenv("PSE_PLATFORM")  # the flag alone puts the stack on the host
    route = _compare_stacks(400, 64, fake_device_ms=1.0)
    assert route["impl"] == "fake_device_1ms"


def test_keyword_mode_matches_jax(clean_env):
    _compare_stacks(400, 64, host_corpus=True, keyword_rows=400)


def test_run_load_keys_are_the_jax_keys_and_launches(clean_env):
    with _served(port_load, 400, 64) as (port, _):
        stats, errors = port_load.run_load(port, 4, 32)
        # the JAX script's load loop, driving the port's server: its keys
        jax_stats, _ = jax_load.run_load(port, 2, 4)
    assert errors == [] and stats["errors"] == 0 and stats["requests_ok"] == 32
    assert set(stats) == set(jax_stats)


def test_ivf_mode_serves(clean_env):
    with _served(port_load, 2048, 64, index_type="ivf") as (port, index):
        stats, errors = port_load.run_load(port, 4, 32)
        route = index.last_route
    assert errors == [] and stats["errors"] == 0 and stats["requests_ok"] == 32
    assert route["impl"].startswith("ivf") and route["nprobe"] >= 1


def test_main_prints_the_jax_line_plus_launches(clean_env, capsys):
    assert port_load.main(["--rows", "400", "--dim", "64", "--threads", "2", "--requests", "8"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["errors"] == 0 and stats["rows"] == 400 and "launches" not in stats and "avg_scan_batch" in stats


# ---------------------------------------------------------------------------
# the headline bench
# ---------------------------------------------------------------------------


def _clustered(rng, n, d, centers=32):
    c = unit_rows(rng, centers, d)
    rows = c[rng.integers(0, centers, n)] + 0.25 * rng.normal(size=(n, d)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def _jax_bench_call(variant, corpus, queries, k, *, nlist, nprobe, ivf_quantized):
    """bench.py's call for ``variant`` on the JAX package (off the TPU:
    float32 rows, the Pallas kernels in interpret mode)."""
    import jax.numpy as jnp

    from photo_search_engine_tpu.models.ivf import IVFIndex
    from photo_search_engine_tpu.ops.quantized import int8_search, quantize_rows
    from photo_search_engine_tpu.ops.topk import _pallas_twophase_impl

    rows, dim = corpus.shape
    nq = queries.shape[0]
    c, q = jnp.asarray(corpus), jnp.asarray(queries)
    if variant in ("exact", "fast"):
        count = jnp.full((1, 1), rows, jnp.int32)
        vals, idx = _pallas_twophase_impl(c, q, count, jnp.zeros((1, rows), jnp.float32),
                                          jnp.ones((1, rows), jnp.int32), k, "ip", nq, 512, True, False,
                                          fast=variant == "fast")
        return np.asarray(vals)[:, :k], np.asarray(idx)[:, :k]
    if variant == "int8":
        c8, sc = quantize_rows(c)
        vals, idx = int8_search(c8, sc, c, q, k, count=rows, block_q=nq)
        return np.asarray(vals), np.asarray(idx)
    index = IVFIndex.build_on_device(c, nlist=nlist, quantized=ivf_quantized)
    vals, slots = (np.asarray(x) for x in index.device_search_fn(k, nprobe, nq)(q))
    return vals, np.where(slots >= 0, index.perm[np.clip(slots, 0, len(index.perm) - 1)], -1)


@pytest.mark.parametrize("variant, ivf_quantized", [("exact", False), ("fast", False), ("int8", False),
                                                     ("ivf", False), ("ivf", True)])
def test_bench_search_matches_jax(variant, ivf_quantized):
    rng = np.random.default_rng(21)
    corpus = _clustered(rng, 4096, 128) if variant == "ivf" else unit_rows(rng, 4096, 128)
    queries = corpus[:8] + 0.05 * rng.normal(size=(8, 128)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    k, nlist, nprobe = 10, 16, 4
    want_v, want_i = _jax_bench_call(variant, corpus, queries, k, nlist=nlist, nprobe=nprobe,
                                     ivf_quantized=ivf_quantized)
    s = {"variant": variant, "k": k, "n_queries": 8, "nlist": nlist, "nprobe": nprobe, "ivf_quantized": ivf_quantized}
    search, library, _ = torch_bench.make_search(s, torch.from_numpy(corpus))
    vals, ids = (x.numpy() for x in search(torch.from_numpy(queries)))
    if variant == "ivf":
        perm = search.index.perm
        ids = np.where(ids >= 0, perm[np.clip(ids, 0, len(perm) - 1)], -1)
    np.testing.assert_array_equal(ids, want_i)
    np.testing.assert_allclose(vals, want_v, rtol=0, atol=TOL)
    if variant in ("exact", "fast"):  # the library composition computes the same top-k
        lib_v, lib_i = library(torch.from_numpy(queries))
        assert_topk_match(lib_v.numpy(), lib_i.numpy(), want_v, want_i, tol=TOL)
    else:
        library(torch.from_numpy(queries))


@pytest.mark.parametrize("variant, ivf_quantized", [("exact", False), ("fast", False), ("ivf", False)])
def test_bench_search_at_another_depth(variant, ivf_quantized):
    """``search(q, k + 1)``, the depth phase entry holds the bench's
    kernels against, is the bench's own search one slot deeper."""
    rng = np.random.default_rng(22)
    corpus = torch.from_numpy(_clustered(rng, 4096, 128))
    s = {"variant": variant, "k": 10, "n_queries": 8, "nlist": 16, "nprobe": 4, "ivf_quantized": ivf_quantized}
    search, _, _ = torch_bench.make_search(s, corpus)
    queries = corpus[:8] + 0.05 * torch.from_numpy(rng.normal(size=(8, 128)).astype(np.float32))
    vals, ids = search(queries)
    deep_v, deep_i = search(queries, 11)
    assert vals.shape == (8, 10) and deep_v.shape == (8, 11)
    assert_topk_match(vals, ids, deep_v[:, :10], deep_i[:, :10], tol=TOL, cut=deep_v[:, 10])


@pytest.mark.parametrize("sync", [None, "called a synchronizing CUDA operation"])
def test_bench_report_lines(sync):
    out = {"metric": "exact_search_qps_4k_x_128d_top10_batch8", "value": 10.0, "unit": "qps", "vs_baseline": 0.5,
           "ms": 800.0, "library_ms": 400.0, "library_qps": 20.0, "library": "lib", "host_sync": sync}
    lines = torch_bench.report(out)
    assert len(lines) == (3 if sync else 2) and lines[-2].startswith("# search")
    assert json.loads(lines[-1]) == {key: out[key] for key in torch_bench.HEADLINE_KEYS}
    assert (sync is not None) == lines[0].startswith("# host sync")


@pytest.mark.parametrize("env, name", [
    ({"BENCH_IMPL": "exact"}, "exact_search_qps_4k_x_128d_top10_batch8"),
    ({"BENCH_FAST": "1"}, "packedkey_search_qps_4k_x_128d_top10_batch8"),
    ({"BENCH_INT8": "1"}, "int8_rescore_search_qps_4k_x_128d_top10_batch8"),
    ({"BENCH_IMPL": "ivf", "BENCH_IVF_QUANTIZED": "1"}, "ivf_int8_search_qps_4k_x_128d_top10_batch8"),
    ({}, "exact_search_qps_4k_x_128d_top10_batch8"),
], ids=["exact", "fast", "int8", "ivf_int8", "default"])
def test_bench_main_prints_one_json_line(clean_env, capsys, env, name):
    for key, value in {"BENCH_ROWS": "4096", "BENCH_DIM": "128", "BENCH_Q": "8", "BENCH_ITERS": "2",
                       "BENCH_IVF_NLIST": "16", "BENCH_IVF_NPROBE": "4", **env}.items():
        clean_env.setenv(key, value)
    assert torch_bench.main() == 0
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline"} and out["metric"] == name
    assert out["unit"] == "qps" and out["value"] > 0 and out["vs_baseline"] > 0


def test_bench_defaults_follow_bench_py(clean_env):
    s = torch_bench.settings({})
    assert (s["rows"], s["dim"], s["n_queries"], s["k"], s["iters"]) == (1_000_000, 1536, 256, 10, 40)
    assert s["variant"] == "exact"  # resolve_store_quantized("auto") is False
    ivf = torch_bench.settings({"BENCH_IMPL": "ivf"})
    assert (ivf["n_queries"], ivf["nprobe"], ivf["nlist"], ivf["ivf_quantized"]) == (8, 16, 1024, False)
    with pytest.raises(ValueError):
        torch_bench.settings({"BENCH_IMPL": "approx"})


def test_bench_without_a_card_prints_backend_unavailable(clean_env, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the bench would run on it")
    clean_env.delenv("PSE_PLATFORM")
    assert torch_bench.main() == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "backend_unavailable" and out["value"] == 0


# ---------------------------------------------------------------------------
# the graft entry
# ---------------------------------------------------------------------------


def test_entry_forward_matches_jax_entry():
    jax_forward, (corpus, queries) = jax_graft.entry()
    want_v, want_i = (np.asarray(x) for x in jax_forward(corpus, queries))
    forward, (port_corpus, port_queries) = graft_entry.entry(device="cpu")
    assert tuple(port_corpus.shape) == (8192, 1536) and tuple(port_queries.shape) == (16, 1536)
    vals, ids = forward(torch.from_numpy(np.array(corpus)), torch.from_numpy(np.array(queries)))
    np.testing.assert_array_equal(ids.numpy(), want_i)
    np.testing.assert_allclose(vals.numpy(), want_v, rtol=0, atol=TOL)


def test_dryrun_multichip_on_the_host(capsys):
    graft_entry.dryrun_multichip(8, device="cpu")
    assert "dryrun_multichip ok: 8 shards on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the health check and the demo
# ---------------------------------------------------------------------------


def _report(module, capsys):
    """``module.main()``'s exit code and JSON report, read with the config
    the environment gives now (both packages cache theirs)."""
    from photo_search_engine_tpu.config import reset_config_cache as reset_jax
    from photo_search_engine_tpu_torch.config import reset_config_cache

    reset_jax()
    reset_config_cache()
    rc = module.main()
    return rc, json.loads(capsys.readouterr().out)


def _closed_port():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def test_check_services_reports_the_jax_keys(clean_env, capsys):
    clean_env.setenv("SERVER_PORT", str(_closed_port()))  # no server answers: both reports have the same keys
    rc, report = _report(port_check, capsys)
    assert rc == 0 and report["ok"] and report["backend"] == "cpu" and report["devices"] == ["cpu"]
    _, jax_report = _report(jax_check, capsys)
    assert set(report) == set(jax_report)
    assert set(report["artifacts"]) == set(jax_report["artifacts"])


def test_check_services_without_a_card_fails(clean_env, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    clean_env.delenv("PSE_PLATFORM")
    rc, report = _report(port_check, capsys)
    assert rc == 1 and not report["ok"] and report["backend"].startswith("ERROR")


@pytest.mark.parametrize("platform", [None, "cpu", "gpu"])
def test_demo_server_is_the_port_app_on_the_callers_platform(clean_env, platform):
    clean_env.delenv("PSE_PLATFORM")
    if platform:
        clean_env.setenv("PSE_PLATFORM", platform)
    assert torch_demo_e2e.server_command()[1:] == ["-m", "photo_search_engine_tpu_torch.api.app"]
    env = torch_demo_e2e.server_env("/p", "/d", 1234)
    assert env.get("PSE_PLATFORM") == platform
    assert (env["PHOTO_DIR"], env["DATA_DIR"], env["SERVER_PORT"]) == ("/p", "/d", "1234")


def test_demo_runs_every_mode_on_the_host(clean_env):
    env = {k: v for k, v in os.environ.items()}
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "torch_demo_e2e.py")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    for label in ("text: beach sunset", "season filter", "season+period", "autumn date range",
                  "image-to-image", "upload-to-search", "all demo flows completed"):
        assert label in out.stdout
    assert "ERROR" not in out.stdout

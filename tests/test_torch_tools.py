"""The port's tools against the JAX package's: ``migrate`` and
``recall_eval.evaluate`` on one fake FAISS directory, ``evaluate_synthetic``
on one seeded corpus, ``EmbeddingStore.from_array`` and
``IVFIndex.device_search_fn`` (against ``IVFIndex.search`` on the plain
kernel 7, and against the JAX ``device_search_fn``).  The JAX side runs on
the CPU, its Pallas kernels in interpret mode as its own tests run them;
the port's with ``PSE_PLATFORM=cpu``, on the plain versions.

The exact recall is 1.0 in both packages.  The IVF and int8 recalls are
held within 0.01 absolute: the two k-means sum in another order, so a row
on a cluster border may land in another cluster.  On these inputs they
have so far been equal."""

import json
import os

import numpy as np
import pytest
import torch

from photo_search_engine_tpu.core.embedding_store import EmbeddingStore as JaxStore
from photo_search_engine_tpu.models import ivf as jax_ivf
from photo_search_engine_tpu.tools import migrate as jax_migrate
from photo_search_engine_tpu.tools import recall_eval as jax_recall
from photo_search_engine_tpu_torch.core.embedding_store import EmbeddingStore
from photo_search_engine_tpu_torch.models import ivf
from photo_search_engine_tpu_torch.ops import ivf_scan
from photo_search_engine_tpu_torch.tools import migrate as port_migrate
from photo_search_engine_tpu_torch.tools import recall_eval as port_recall
from tests.test_migrate import _fake_faiss_binary
from tests.torch_parity import assert_topk_match, plain_scan, unit_rows

_SEASONS = ("春天", "夏天", "秋天", "冬天")


@pytest.fixture()
def on_host(monkeypatch):
    """The port's tools run where ``PSE_PLATFORM`` says: here the host."""
    monkeypatch.setenv("PSE_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def faiss_dir(tmp_path_factory):
    """A reference-format corpus: a fake FAISS flat binary of 200 clustered
    unit rows of width 32, its sidecar and a metadata.json with
    stringified fields and seasons."""
    tmp = tmp_path_factory.mktemp("faiss")
    rng = np.random.default_rng(7)
    centers = unit_rows(rng, 12, 32)
    rows = centers[rng.integers(0, 12, 200)] + 0.3 * rng.normal(size=(200, 32)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    _fake_faiss_binary(str(tmp / "photo_search.index"), rows)
    with open(tmp / "photo_search.index.meta.json", "w", encoding="utf-8") as f:
        json.dump({"metric": "cosine", "dimension": 32}, f)
    metadata = [
        {"photo_path": f"/photos/{i}.jpg", "description": f"photo {i}", "tags": "['海边', '日落']",
         "time_info": str({"season": _SEASONS[i % 4], "year": 2020 + i % 3, "month": 1 + i % 12})}
        for i in range(200)
    ]
    with open(tmp / "metadata.json", "w", encoding="utf-8") as f:
        json.dump(metadata, f, ensure_ascii=False)
    return tmp, rows


def _migrated(module, faiss_dir, out):
    src, _ = faiss_dir
    return module.migrate(str(src / "photo_search.index"), str(src / "metadata.json"), str(out))


def test_migrate_matches_jax(faiss_dir, tmp_path, on_host):
    want = _migrated(jax_migrate, faiss_dir, tmp_path / "jax")
    got = _migrated(port_migrate, faiss_dir, tmp_path / "port")
    assert {k: v for k, v in got.items() if k not in ("out_dir", "vector_index", "keyword_index")} == {
        k: v for k, v in want.items() if k not in ("out_dir", "vector_index", "keyword_index")}
    for name in ("photo_search.index", "photo_search.index.meta.json", "metadata.json", "keyword_index.json"):
        assert os.path.exists(tmp_path / "port" / name) and os.path.exists(tmp_path / "jax" / name), name
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "photo_search.index"),
                                  np.load(tmp_path / "jax" / "photo_search.index"))
    with open(tmp_path / "port" / "metadata.json", encoding="utf-8") as f:
        port_meta = json.load(f)
    with open(tmp_path / "jax" / "metadata.json", encoding="utf-8") as f:
        assert port_meta == json.load(f)
    assert port_meta[5]["time_info"]["season"] == "夏天" and port_meta[0]["tags"] == ["海边", "日落"]


def test_evaluate_matches_jax(faiss_dir, tmp_path, on_host):
    _migrated(jax_migrate, faiss_dir, tmp_path / "jax")
    _migrated(port_migrate, faiss_dir, tmp_path / "port")
    want = jax_recall.evaluate(str(tmp_path / "jax"), k=10, nprobe=8)
    got = port_recall.evaluate(str(tmp_path / "port"), k=10, nprobe=8)
    assert got["exact_recall_at_k"] == want["exact_recall_at_k"] == 1.0
    assert abs(got["ivf_recall_at_k"] - want["ivf_recall_at_k"]) <= 0.01
    assert abs(got["int8_recall_at_k"] - want["int8_recall_at_k"]) <= 0.01
    assert got["masked_search_checks"] == want["masked_search_checks"] == 4
    assert got["masked_search_correct"] == got["masked_search_checks"]
    assert (got["corpus"], got["k"]) == (want["corpus"], want["k"]) == ({"count": 200, "dimension": 32}, 10)


def test_evaluate_needs_the_card_unless_asked_for_the_host(tmp_path, monkeypatch):
    monkeypatch.delenv("PSE_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="PSE_PLATFORM=cpu"):
        port_recall.evaluate(str(tmp_path), k=3)
    with pytest.raises(RuntimeError, match="PSE_PLATFORM=cpu"):
        port_recall.evaluate_synthetic(64, dim=8, intrinsic=2, nlist=4)


def test_evaluate_tiny_corpus_matches_jax(tmp_path, on_host):
    rows = unit_rows(np.random.default_rng(1), 1, 8)
    out = []
    for module, migrate, name in ((jax_recall, jax_migrate, "jax"), (port_recall, port_migrate, "port")):
        _fake_faiss_binary(str(tmp_path / f"{name}.index"), rows)
        with open(tmp_path / f"{name}.json", "w", encoding="utf-8") as f:
            json.dump([{"photo_path": "/p/0.jpg"}], f)
        migrate.migrate(str(tmp_path / f"{name}.index"), str(tmp_path / f"{name}.json"), str(tmp_path / name),
                        dimension=8)
        out.append(module.evaluate(str(tmp_path / name)))
    assert out[0] == out[1] and out[1]["k"] == 0


def test_synthetic_corpus_is_the_jax_tools_draws(on_host):
    rng = np.random.default_rng(3)
    corpus, basis = port_recall.synthetic_corpus(100, 24, 4, rng, 3, torch.device("cpu"), torch.float32)
    again = np.random.default_rng(3)
    want_basis = (again.normal(size=(4, 24)).astype(np.float32) / np.sqrt(4)).astype(np.float32)
    # 16 chunks of 100 // 16 rows, and the rest
    want = np.concatenate([again.normal(size=(min(6, 100 - i), 4)).astype(np.float32) @ want_basis
                           for i in range(0, 100, 6)])
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    np.testing.assert_array_equal(basis.numpy(), want_basis)
    np.testing.assert_allclose(corpus.numpy(), want, rtol=0, atol=1e-6)
    # the next draw of both generators is the same: the queries follow
    assert rng.integers(1 << 30) == again.integers(1 << 30)
    iid, none = port_recall.synthetic_corpus(40, 16, 0, np.random.default_rng(0), 5, torch.device("cpu"),
                                             torch.float32)
    assert none is None and np.allclose(torch.linalg.vector_norm(iid, dim=1).numpy(), 1.0, atol=1e-6)


def test_evaluate_synthetic_matches_jax(on_host, capsys):
    kw = dict(dim=64, intrinsic=8, nlist=16, k=10, n_queries=64, seed=0, sweep=[4], sweep_batches=[1])
    want = jax_recall.evaluate_synthetic(4096, **kw)
    got = port_recall.evaluate_synthetic(4096, **kw)
    assert abs(got["recall_at_k_vs_exact"] - want["recall_at_k_vs_exact"]) <= 0.01
    assert abs(got["tune_sample_recall_vs_full_probe"] - want["tune_sample_recall_vs_full_probe"]) <= 0.01
    assert got["tuned_nprobe"] == want["tuned_nprobe"]
    assert got.keys() == want.keys()
    for mine, theirs in zip(got["sweep"], want["sweep"]):
        assert (mine["nprobe"], mine["batch"]) == (theirs["nprobe"], theirs["batch"])
        assert abs(mine["recall_at_k"] - theirs["recall_at_k"]) <= 0.01
        assert mine["latency_ms_per_batch"] > 0 and mine["qps"] > 0
    assert "[recall_eval] building IVF index on device" in capsys.readouterr().out


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_from_array_matches_jax(metric, quantized):
    rows = 0.5 * unit_rows(np.random.default_rng(2), 300, 32)  # off the unit sphere, l2 distances near 1
    store = EmbeddingStore.from_array(rows, metric=metric, quantized=quantized, already_normalized=False,
                                      device="cpu")
    ref = JaxStore.from_array(rows, metric=metric, quantized=quantized)
    assert store.count == ref.count and store.device.type == "cpu"
    np.testing.assert_allclose(store.snapshot(), ref.snapshot(), rtol=0, atol=1e-7)
    queries = unit_rows(np.random.default_rng(3), 5, 32)
    impl = "int8" if quantized else "auto"
    got, want = store.search(queries, 7, impl=impl), ref.search(queries, 7, impl=impl)
    descending = metric != "l2"
    assert_topk_match(got[0], got[1], want[0], want[1], tol=1e-5, descending=descending)


def test_from_array_defaults_to_the_card(monkeypatch):
    monkeypatch.delenv("PSE_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="PSE_PLATFORM=cpu"):
        EmbeddingStore.from_array(np.ones((2, 4), np.float32))
    monkeypatch.setenv("PSE_PLATFORM", "cpu")
    assert EmbeddingStore.from_array(np.ones((2, 4), np.float32)).device.type == "cpu"


def _clustered(rng, n=600, d=32):
    centers = unit_rows(rng, 20, d)
    rows = centers[rng.integers(0, 20, n)] + 0.25 * rng.normal(size=(n, d)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


@pytest.mark.parametrize("k", [5, 70])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_device_search_fn_equals_search(metric, quantized, k):
    rng = np.random.default_rng(11)
    rows = _clustered(rng)
    index = ivf.IVFIndex.build(rows, nlist=16, metric=metric, seed=0, quantized=quantized, device="cpu")
    queries = rows[:9] + 0.05 * rng.normal(size=(9, 32)).astype(np.float32)
    fn = index.device_search_fn(k, 4, 9)
    with plain_scan(ivf_scan, "ivf_block_topk"):
        vals, slots = fn(torch.from_numpy(queries))
        want_d, want_i = index.search(queries, k, nprobe=4)
    assert vals.shape == (9, k) and vals.dtype == torch.float32 and slots.dtype == torch.int32
    got_d, got_i = index._to_rows(vals.numpy(), slots.numpy())
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="expected"):
        fn(torch.from_numpy(queries[:3]))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_device_search_fn_matches_jax(metric, quantized):
    rng = np.random.default_rng(12)
    rows = _clustered(rng)
    jax_index = jax_ivf.IVFIndex.build(rows, nlist=16, metric=metric, seed=0, quantized=quantized)
    state = jax_index.state()
    index = ivf.IVFIndex.from_state(rows, state, quantized=quantized, device="cpu")
    queries = rows[10:18] + 0.05 * rng.normal(size=(8, 32)).astype(np.float32)
    want_v, want_slots = (np.asarray(x) for x in jax_index.device_search_fn(6, 4, 8)(queries))
    vals, slots = index.device_search_fn(6, 4, 8)(torch.from_numpy(queries))
    # the JAX Pallas merge breaks ties in visit order: the top-k rule of the port's tests
    assert_topk_match(vals.numpy(), slots.numpy(), want_v, want_slots, tol=1e-5)

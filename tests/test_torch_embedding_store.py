"""The port's EmbeddingStore and capacity model against the JAX package's,
and the content-keyed cache of its filtered scans."""

import sys
import threading

import numpy as np
import pytest
import torch

from photo_search_engine_tpu.core import capacity as jcap
from photo_search_engine_tpu.core.embedding_store import EmbeddingStore as JaxStore
from photo_search_engine_tpu_torch.core import capacity as tcap
from photo_search_engine_tpu_torch.core.content_lru import ContentLRU
from photo_search_engine_tpu_torch.core.convert import store_state_from_jax
from photo_search_engine_tpu_torch.core.embedding_store import EmbeddingStore
from tests.torch_parity import assert_topk_match, unit_rows

D = 64


def _rows(seed, n, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_append_growth_and_alignment():
    store = EmbeddingStore(D, device="cpu")
    assert store.capacity == 0 and store.count == 0
    store.append(_rows(0, 10))
    assert store.count == 10 and store.capacity == 1024
    store.append(_rows(1, 1500))
    assert store.count == 1510 and store.capacity == 2048  # doubled, block aligned
    store.append(_rows(2, 3000))
    assert store.capacity == 5120 and store.capacity % store.block_rows == 0
    host = np.concatenate([_rows(0, 10), _rows(1, 1500), _rows(2, 3000)])
    host /= np.linalg.norm(host, axis=1, keepdims=True)
    np.testing.assert_allclose(store.snapshot(), host, atol=1e-7)
    np.testing.assert_allclose(store._device[: store.count].numpy(), host, atol=1e-7)
    assert not store._device[store.count :].any()  # rows past count stay zero
    q = EmbeddingStore(3072, quantized=True, device="cpu")
    assert q._capacity_align % q.block_rows == 0 and q._capacity_align % q._i8_block == 0
    zero = EmbeddingStore(4, metric="cosine", device="cpu")
    zero.append(np.zeros((2, 4), np.float32))
    assert not zero.snapshot().any()  # zero vectors stay as they are
    with pytest.raises(ValueError):
        store.append(_rows(3, 2, d=D + 1))


def test_capacity_error_with_budget(monkeypatch):
    monkeypatch.setenv("PSE_HBM_BYTES", str(2 * 1024 * 1024))
    store = EmbeddingStore(256, quantized=True, device="cpu")
    with pytest.raises(tcap.DeviceCapacityError) as err:
        store.append(_rows(0, 3000, d=256))
    assert "STORE_QUANTIZED=0" in str(err.value)
    assert store.count == 0  # nothing was half-appended
    monkeypatch.setenv("PSE_HBM_BYTES", "0")
    assert tcap.device_hbm_budget("cpu") is None
    monkeypatch.delenv("PSE_HBM_BYTES")
    assert tcap.device_hbm_budget("cpu") is None


@pytest.mark.parametrize("quantized", [False, True])
def test_capacity_arithmetic_matches_jax(quantized, monkeypatch):
    for cap, dim, item in ((4096, 1536, 2), (1_000_448, 1536, 2), (2048, 256, 4)):
        assert tcap.store_bytes(cap, dim, item, quantized) == jcap.store_bytes(cap, dim, item, quantized)
        for budget in (16 * 1024**3, 80 * 10**9):
            assert tcap.max_rows_for_budget(dim, item, quantized, budget) == jcap.max_rows_for_budget(
                dim, item, quantized, budget
            )
    monkeypatch.setenv("PSE_HBM_BYTES", str(10**9))
    with pytest.raises(jcap.DeviceCapacityError) as ref:
        jcap.check_store_allocation(400_000, 200_000, 1536, 2, quantized)
    with pytest.raises(tcap.DeviceCapacityError) as got:
        tcap.check_store_allocation(400_000, 200_000, 1536, 2, quantized)
    assert str(got.value).split(" Single-")[0] == str(ref.value).split(" Single-")[0]


def test_load_device_rows_adopts_aligned_rows():
    rows = torch.from_numpy(unit_rows(np.random.default_rng(0), 2048, D))
    store = EmbeddingStore(D, device="cpu")
    store.load_device_rows(rows)
    assert store._device is rows and store.count == 2048  # zero-copy adoption
    assert store._host_cache is None  # the mirror downloads lazily
    np.testing.assert_array_equal(store.reconstruct(5), rows[5].numpy())
    assert store._host_cache is None  # one row read, not the whole mirror
    np.testing.assert_array_equal(store.snapshot(), rows.numpy())
    with pytest.raises(RuntimeError):
        store.load_device_rows(rows)

    ragged = torch.from_numpy(unit_rows(np.random.default_rng(1), 1500, D))
    q = EmbeddingStore(D, store_dtype="bfloat16", quantized=True, device="cpu")
    q.load_device_rows(ragged)
    assert q._device is not ragged and q.capacity == 2048 and q.count == 1500
    assert q._device.dtype == torch.bfloat16
    i8, sc = q._device_i8, q._scales
    from photo_search_engine_tpu_torch.ops.quantized import quantize_rows

    ref_i8, ref_sc = quantize_rows(ragged.to(torch.bfloat16))
    assert torch.equal(i8[:1500], ref_i8) and torch.equal(sc[:1500], ref_sc)
    assert not i8[1500:].any() and not sc[1500:].any()


def test_mask_lru_is_bounded_and_thread_safe():
    store = EmbeddingStore(D, device="cpu")
    store.append(_rows(0, 100))
    m = np.zeros(100, bool)
    m[::2] = True
    first = store._device_mask(m)
    assert store._device_mask(m.copy()) is first  # cached by content
    assert first.dtype == torch.int8 and first.shape == (store.capacity,)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(50):
                store._device_mask(rng.random(100) > 0.5)
        except Exception as exc:  # noqa: BLE001 — collected for the assert
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(store._masks) <= store._masks.size == 32


@pytest.mark.parametrize(
    "metric,quantized,dtype",
    [("cosine", False, "float32"), ("l2", False, "float32"), ("cosine", True, "float32"),
     ("l2", True, "float32"), ("cosine", False, "bfloat16"), ("cosine", True, "bfloat16")],
)
def test_from_jax_state_searches_the_same(metric, quantized, dtype):
    rng = np.random.default_rng(11)
    corpus = unit_rows(rng, 900, D)
    corpus[300:310] = corpus[5]  # exact ties
    queries = np.concatenate([corpus[[5, 77]], unit_rows(rng, 3, D)])
    jstore = JaxStore(D, metric=metric, store_dtype=dtype, quantized=quantized)
    jstore.append(corpus[:500])
    jstore.append(corpus[500:])
    state = store_state_from_jax(jstore)
    assert state["count"] == 900 and state["capacity"] == jstore.capacity
    store = EmbeddingStore.from_state(state, device="cpu")
    assert store.count == 900 and store.capacity == jstore.capacity and store.quantized == quantized
    if quantized:
        assert np.array_equal(store._device_i8[:900].numpy(), state["rows_i8"])
    mask = (rng.random(900) > 0.4)
    impl = "int8" if quantized else "auto"
    for k, m in ((10, None), (20, mask), (70, None)):
        got = store.search(queries, k, mask=m, impl=impl)
        ref = jstore.search(queries, k, mask=m, impl=impl)
        tol = 1e-5 if dtype == "bfloat16" else 1e-6
        assert_topk_match(*got, np.asarray(ref[0]), np.asarray(ref[1]), tol=tol, descending=metric != "l2")
        if dtype == "float32":
            np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_array_equal(store.reconstruct(42), jstore.reconstruct(42))


def test_search_contract_edges():
    store = EmbeddingStore(D, device="cpu")
    v, i = store.search(_rows(0, 3), 5)
    assert v.shape == (3, 0) and i.shape == (3, 0)
    store.append(_rows(1, 4))
    v, i = store.search(_rows(2, 1)[0], 10)
    assert i.shape == (1, 4)
    with pytest.raises(ValueError):
        store.search(_rows(2, 1), 3, impl="int8")
    v, i = store.grouped_search(_rows(2, 1), 3, np.ones((1, 4)), np.zeros(1))
    assert i.shape == (1, 3) and (i >= 0).all()  # one predicate that keeps every row
    store.clear()
    assert store.count == 0 and store.capacity == 0 and store.snapshot().shape == (0, D)


def test_content_lru_keys_bound_and_eviction_order():
    """The one cache of the four filtered paths: keyed on the bytes and
    what else the value depends on, bounded, least recently used out
    first, a hit made most recent."""
    lru = ContentLRU(3)
    built = []

    def get(bits, *extra):
        return lru.get(ContentLRU.key(np.asarray(bits, np.int8), *extra), lambda: built.append(bits) or len(built))

    a = get([1, 0, 1])
    assert get(np.array([1, 0, 1])) == a and len(built) == 1  # a copy with the same content hits
    assert get([1, 0, 1], 4) == 2  # another capacity is another entry
    b = get([0, 1, 1])
    assert get([1, 0, 1]) == a and len(built) == 3  # a hit: now the most recent
    c = get([1, 1, 0])  # evicts ([1, 0, 1], 4), the least recently used
    assert len(lru) == 3 and get([1, 0, 1], 4) == 5  # built again; evicts [0, 1, 1]
    assert (get([1, 0, 1]), get([1, 1, 0])) == (a, c) and len(built) == 5
    assert get([0, 1, 1]) == 6 != b and len(lru) == 3
    lru.clear()
    assert len(lru) == 0 and get([0, 1, 1]) == 7


def test_content_lru_shared_by_threads():
    """Threads looking up and building at once: every answer is the value
    of its own key, and the cache stays within its bound."""
    lru = ContentLRU(4)
    keys = [np.array([i, i >> 1, i >> 2], np.int8) for i in range(8)]
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for i in rng.integers(0, len(keys), 400):
                got = lru.get(ContentLRU.key(keys[i]), lambda i=i: ("value", int(i)))
                if got != ("value", int(i)):
                    errors.append((i, got))
        except Exception as exc:  # noqa: BLE001 — collected for the assert
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(s,)) for s in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads) and len(lru) <= 4

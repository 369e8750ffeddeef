"""The spy on the kernel wrappers (``tests/torch_parity.spy_launches``) and
the routes it checks on the CPU.  A CPU tensor goes through the same
wrapper as a card tensor, which then runs its plain version, so the spy
sees which wrapper each public entry point sends a call to; the loop rule
says on which scoring loop the card would run it.  The launches
themselves are counted on the card (``tests/test_torch_kernels_cuda.py``,
``tests/test_torch_ivf_graph.py``, ``chip_smoke.py``)."""

import sys
import threading

import numpy as np
import pytest
import torch

from photo_search_engine_tpu_torch.core.embedding_store import EmbeddingStore
from photo_search_engine_tpu_torch.models.ivf import IVFIndex
from photo_search_engine_tpu_torch.ops import grouped_mask, ivf_scan, quantized, topk
from tests.torch_parity import KERNEL_WRAPPERS, spy_launches, unit_rows

D = 64  # float32 rows the f32 ring takes, int8 rows the tensor cores take
MODULES = {"topk": topk, "grouped_mask": grouped_mask, "quantized": quantized, "ivf_scan": ivf_scan}


def _seen(launches):
    """The wrappers called, each with its calls (on the CPU, none launched)."""
    assert not any(launches.launches().values())
    return {name: n for name, n in launches.calls().items() if n}


def _store(n=300):
    store = EmbeddingStore(D, device="cpu", quantized=True)
    store.append(unit_rows(np.random.default_rng(0), n, D))
    return store


def test_the_spy_restores_the_wrappers_and_nests():
    before = {name: getattr(MODULES[module], name) for name, module in KERNEL_WRAPPERS.items()}
    corpus = torch.from_numpy(unit_rows(np.random.default_rng(1), 100, D))
    with spy_launches() as outer:
        assert all(getattr(MODULES[m], name) is not before[name] for name, m in KERNEL_WRAPPERS.items())
        with spy_launches(("block_topk",)) as inner:
            topk.block_topk(corpus, corpus[:2], 5, count=100)
        with pytest.raises(ValueError):  # a call that raises launched nothing
            topk.block_topk(torch.empty((8, 4), device="meta"), torch.empty((1, 4), device="meta"), 1, count=8)
        quantized.int8_block_topk(*quantized.quantize_rows(corpus), *quantized.quantize_rows(corpus[:2]), 5,
                                  count=100)
    assert {name: getattr(MODULES[m], name) for name, m in KERNEL_WRAPPERS.items()} == before
    assert _seen(inner) == {"block_topk": 1}
    assert outer.calls() == dict.fromkeys(KERNEL_WRAPPERS, 0) | {"block_topk": 1, "int8_block_topk": 1}
    assert outer.launches() == dict.fromkeys(KERNEL_WRAPPERS, 0)  # CPU tensors: the plain versions ran
    outer.reset()
    assert sum(outer.calls().values()) == 0


def test_the_spy_loses_no_call_under_contention():
    """Threads calling wrappers at once, as the micro-batcher's executors
    and an inline caller do: every call is counted."""
    corpus = torch.from_numpy(unit_rows(np.random.default_rng(2), 64, D))
    threads_n, calls = 12, 40
    errors = []

    def worker():
        try:
            for _ in range(calls):
                topk.block_topk(corpus, corpus[:1], 1, count=64)
        except Exception as exc:  # noqa: BLE001 — collected for the assert
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spy_launches(("block_topk",)) as seen:
            threads = [threading.Thread(target=worker) for _ in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert seen.calls()["block_topk"] == threads_n * calls


@pytest.mark.parametrize("impl,k,want", [
    ("auto", 10, {"block_topk": 1}),
    ("pallas", 10, {"block_topk": 1}),
    ("pallas_fast", 10, {"fast_block_topk": 1}),
    ("pallas_fused", 10, {"fused_topk": 1}),
    ("int8", 10, {"int8_block_topk": 1}),
    ("lax", 10, {}),
    ("auto", 100, {}),  # k > 64: the plain chunked product
    ("int8", 100, {}),
])
def test_store_search_sends_each_impl_to_its_wrapper(impl, k, want):
    store = _store()
    queries = unit_rows(np.random.default_rng(3), 3, D)
    mask = np.arange(store.count) % 3 != 0
    with spy_launches() as seen:
        store.search(queries, k, impl=impl)
        store.search(queries, k, impl=impl, mask=mask)
    assert _seen(seen) == {name: 2 * n for name, n in want.items()}


@pytest.mark.parametrize("impl,want", [
    ("auto", {"grouped_block_topk": 1}),
    ("pallas", {"grouped_block_topk": 1}),
    ("pallas_fused", {"grouped_block_topk": 1}),  # no fused grouped scan, as in JAX
    ("pallas_fast", {"fast_grouped_block_topk": 1}),
    ("int8", {"int8_grouped_block_topk": 1}),
    ("lax", {}),
])
def test_grouped_search_sends_each_impl_to_its_wrapper(impl, want):
    store = _store()
    queries = unit_rows(np.random.default_rng(4), 4, D)
    table = np.stack([np.arange(store.count) % 2 == 0, np.arange(store.count) % 5 != 0])
    with spy_launches() as seen:
        store.grouped_search(queries, 10, table, np.array([0, 1, 1, 0]), impl=impl)
    assert _seen(seen) == want


@pytest.mark.parametrize("tier,k,loop", [
    ("float32", 10, "fma_ring"), ("bfloat16", 10, "tensor_core"), ("int8", 10, "tensor_core"),
    ("bfloat16", 100, "fma"),  # k > 64: the FMA loop, where candidate_k 500 goes
])
def test_ivf_search_calls_kernel_7_once(tier, k, loop):
    corpus = unit_rows(np.random.default_rng(5), 1200, D)
    index = IVFIndex.build(corpus, 16, store_dtype="float32" if tier == "float32" else "bfloat16", seed=0,
                           quantized=tier == "int8", device="cpu")
    queries = corpus[:2] + 0.01
    assert ivf_scan.ivf_scoring_loop(*index._kernel_layout(k)) == loop
    with spy_launches() as seen:
        index.search(queries, k, nprobe=4)
        index.search(queries, k, nprobe=4, mask=np.arange(1200) % 2 == 0)
    assert _seen(seen) == {"ivf_block_topk": 2}

"""The IVF scan replayed as a CUDA graph (``models/ivf.py``:
``replays_graph``, ``IVFIndex._capture``, ``_ScanGraph``).

On the CPU: which calls take the graph, that a CPU index never captures and
answers as the eager scan does, that ``append`` empties the graph cache, and
the ``ivf_graph_pct`` reader.  Marked ``cuda`` (skipped without a card):
the replay against the eager scan bit for bit, the calls that stay eager,
recapture after ``append``, concurrent callers, a capture beside another
thread's copies, and that a replay calls no kernel wrapper.  This file
imports no jax; on a machine with a card and without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_ivf_graph.py
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from photo_search_engine_tpu_torch import tracing
from photo_search_engine_tpu_torch.models import ivf
from photo_search_engine_tpu_torch.ops import ivf_scan
from portbench import manifest
from tests.torch_parity import spy_launches, unit_rows

D = 64
NLIST = 16
NPROBE = 4
TIERS = {"ip": dict(metric="ip", quantized=False), "l2": dict(metric="l2", quantized=False),
         "int8": dict(metric="ip", quantized=True)}


def _index(tier, device, n=1200, d=D, nlist=NLIST, seed=0):
    rng = np.random.default_rng(seed)
    corpus = unit_rows(rng, n, d)
    if TIERS[tier]["metric"] == "l2":
        corpus *= rng.uniform(0.5, 2.0, size=(n, 1)).astype(np.float32)
    index = ivf.IVFIndex.build(corpus, nlist, store_dtype="bfloat16", seed=0, device=device, **TIERS[tier])
    return index, corpus


def _queries(corpus, q, seed=1):
    rng = np.random.default_rng(seed)
    rows = corpus[rng.choice(corpus.shape[0], q, replace=False)]
    return (rows + 0.05 * rng.normal(size=rows.shape)).astype(np.float32)


def _eager(index, queries, k, nprobe=NPROBE):
    """The eager scan's ``(vals, slot ids, probe ids)`` on the host."""
    v, i, p = index._scan(torch.from_numpy(queries).to(index.device), k, nprobe, index._row_valid)
    return v.cpu().numpy(), i.cpu().numpy(), p.cpu().numpy()


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device, queries, masked, replays", [
    ("cuda", 1, False, True),
    ("cuda:0", 8, False, True),
    ("cuda", 9, False, False),  # above kernel 7's small query group: eager
    ("cuda", 3, True, False),  # a filter: eager
    ("cuda", 0, False, False),
    ("cpu", 1, False, False),
    ("cpu", 8, True, False),
])
def test_which_calls_replay_a_graph(device, queries, masked, replays):
    assert ivf.replays_graph(torch.device(device), queries, masked) is replays


@pytest.mark.parametrize("q", [1, 3, ivf.GRAPH_MAX_QUERIES])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_a_cpu_index_never_captures_and_answers_as_the_eager_scan(monkeypatch, tier, q):
    def no_graph(*args, **kwargs):
        raise AssertionError("a CPU index captured a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    index, corpus = _index(tier, "cpu")
    queries = _queries(corpus, q)
    for _ in range(2):  # the second call of a shape is where a card would replay
        dists, ids = index.search(queries, 10, nprobe=NPROBE)
        want_d, want_i = index._to_rows(*_eager(index, queries, 10)[:2])
        np.testing.assert_array_equal(ids, want_i)
        np.testing.assert_array_equal(dists, want_d)
    assert not index._graphs


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("room", [True, False])
def test_append_empties_the_graph_cache(tier, room):
    index, corpus = _index(tier, "cpu")
    index.search(corpus[:2], 10, nprobe=NPROBE)  # builds the l2 norms or the int8 shadow
    sentinel = object()
    index._graphs[(1, 10, NPROBE, ivf_scan.ivf_block_topk)] = sentinel
    free = index.nlist * index.capacity - index.live_count
    m = 5 if room else free + 1  # no room: append refuses and replaces nothing
    rows = unit_rows(np.random.default_rng(3), m, D)
    assert index.append(rows, np.arange(corpus.shape[0], corpus.shape[0] + m)) is room
    if room:
        assert not index._graphs
        assert index._cnorms is None and index._corpus_i8 is None and index._cscales is None
    else:
        assert list(index._graphs.values()) == [sentinel]


HOST_START = 1000.0


def _ns(seconds):
    return round(seconds * 1e9)


@pytest.mark.parametrize("flags, want", [
    ([True, True], 100.0),
    ([True, False, False, False], 25.0),
    ([False], 0.0),
    ([], None),  # no span carries the attribute
])
def test_ivf_graph_pct_reads_the_graph_attribute(flags, want):
    tracing.clear()
    attrs = {"queries": 1, "k": 50, "masked": False}
    for j, flag in enumerate(flags):
        tracing.record("ivf.scan", _ns(1000.1 + 0.01 * j), _ns(1000.105 + 0.01 * j), **attrs, graph=flag)
    tracing.record("ivf.scan", _ns(1000.9), _ns(1000.901), **{**attrs, "masked": True}, graph=False)  # filtered
    tracing.record("ivf.scan", _ns(999.0), _ns(999.001), **attrs, graph=False)  # before the window
    tracing.record("ivf.scan", _ns(1000.95), _ns(1000.951), **attrs)  # a program without the graph path
    run = SimpleNamespace(traced=SimpleNamespace(host_start=HOST_START, host_stop=HOST_START + 2.0, device=None))
    try:
        assert manifest.reader("ivf_graph_pct").read(run) == want
    finally:
        tracing.clear()


# ---------------------------------------------------------------------------
# CUDA
# ---------------------------------------------------------------------------

CUDA_ROWS, CUDA_DIM, CUDA_NLIST, CUDA_NPROBE = 20000, 256, 64, 8


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel 7 and CUDA graphs have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _cuda_index(tier, card):
    return _index(tier, card, n=CUDA_ROWS, d=CUDA_DIM, nlist=CUDA_NLIST)


def _assert_bits(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.ascontiguousarray(g).view(np.int32), np.ascontiguousarray(w).view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 50])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_replay_equals_the_eager_scan_bit_for_bit(card, tier, k):
    index, corpus = _cuda_index(tier, card)
    for q in (1, 3, 8):
        queries = _queries(corpus, q, seed=q)
        first = index.search(queries, k, nprobe=CUDA_NPROBE)  # eager, then the capture
        graph = index._graph(q, k, CUDA_NPROBE)
        assert graph is not None, f"q={q}: not captured"
        replayed = graph.run(queries)
        _assert_bits(replayed, _eager(index, queries, k, CUDA_NPROBE))
        second = index.search(queries, k, nprobe=CUDA_NPROBE)  # the replay, through search
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["masked", "nine_queries"])
def test_filtered_calls_and_larger_batches_run_eager(card, case):
    index, corpus = _cuda_index("ip", card)
    q, mask = (1, np.ones(CUDA_ROWS, np.int8)) if case == "masked" else (9, None)
    queries = _queries(corpus, q)
    for _ in range(2):
        index.search(queries, 10, nprobe=CUDA_NPROBE, mask=mask)
    assert not index._graphs


@pytest.mark.cuda
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_append_recaptures_and_the_replay_finds_the_new_rows(card, tier):
    index, corpus = _cuda_index(tier, card)
    nprobe = CUDA_NLIST  # every list: a row that append spilled out of a full list is found too
    queries = _queries(corpus, 2)
    for _ in range(2):
        index.search(queries, 10, nprobe=nprobe)
    old = index._graph(2, 10, nprobe)
    assert old is not None
    new_ids = np.arange(CUDA_ROWS, CUDA_ROWS + 2)
    assert index.append(queries, new_ids)  # each query's own row: its nearest for ip, l2 and the tier
    assert not index._graphs
    first = index.search(queries, 10, nprobe=nprobe)  # eager, then the recapture
    graph = index._graph(2, 10, nprobe)
    assert graph is not None and graph is not old
    if tier == "l2":
        assert graph.keep[0] is index._cnorms and old.keep[0] is not index._cnorms
    if tier == "int8":
        assert graph.keep[1] is index._corpus_i8 and old.keep[1] is not index._corpus_i8
    dists, ids = index.search(queries, 10, nprobe=nprobe)
    np.testing.assert_array_equal(ids, first[1])
    assert [new_ids[j] in ids[j] for j in range(2)] == [True, True]
    _assert_bits(graph.run(queries), _eager(index, queries, 10, nprobe))


def _run_threads(targets, timeout=120):
    threads = [threading.Thread(target=t) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


@pytest.mark.cuda
def test_concurrent_searches_each_get_their_own_answer(card):
    index, corpus = _cuda_index("ip", card)
    qs = [_queries(corpus, 1, seed=s) for s in (11, 12)]
    wants = [index._to_rows(*_eager(index, q, 10, CUDA_NPROBE)[:2]) for q in qs]
    index.search(qs[0], 10, nprobe=CUDA_NPROBE)  # the capture
    assert index._graph(1, 10, CUDA_NPROBE) is not None
    errors = []

    def searcher(q, want):
        def run():
            for _ in range(200):
                got = index.search(q, 10, nprobe=CUDA_NPROBE)
                if not (np.array_equal(got[1], want[1]) and np.array_equal(got[0], want[0])):
                    errors.append(got)
        return run

    _run_threads([searcher(q, w) for q, w in zip(qs, wants)])
    assert not errors


@pytest.mark.cuda
def test_a_capture_beside_another_threads_copies(card):
    index, corpus = _cuda_index("ip", card)
    src = torch.arange(CUDA_DIM, dtype=torch.float32, device=card)
    want_row = src.cpu().numpy()
    stop, copies, bad = threading.Event(), [0], []

    def reconstruct():  # a handler reading one row back, as get_embedding_by_photo_path does
        while not stop.is_set():
            if not np.array_equal(src.cpu().numpy(), want_row):
                bad.append(copies[0])
            copies[0] += 1

    queries = _queries(corpus, 5)
    want = index._to_rows(*_eager(index, queries, 10, CUDA_NPROBE)[:2])
    copier = threading.Thread(target=reconstruct)
    copier.start()
    try:
        got = [index.search(queries, 10, nprobe=CUDA_NPROBE) for _ in range(3)]  # eager, capture, replays
    finally:
        stop.set()
        copier.join(60)
    assert not copier.is_alive() and copies[0] > 0 and not bad
    assert index._graph(5, 10, CUDA_NPROBE) is not None, "the capture failed"
    for dists, ids in got:
        np.testing.assert_array_equal(ids, want[1])
        np.testing.assert_array_equal(dists, want[0])


@pytest.mark.cuda
def test_a_replay_calls_no_kernel_wrapper(card):
    """The graph replays kernel 7 without its wrapper: the first search of
    a shape calls it three times and launches it twice (the eager scan and
    the capture stream's warm-up; the capture only records), a replay calls
    it never."""
    index, corpus = _cuda_index("ip", card)
    queries = _queries(corpus, 1)
    assert ivf_scan.ivf_scoring_loop(*index._kernel_layout(10)) == "tensor_core"
    with spy_launches() as seen:
        index.search(queries, 10, nprobe=CUDA_NPROBE)
        assert index._graph(1, 10, CUDA_NPROBE) is not None, "the capture failed"
        assert seen.calls()["ivf_block_topk"] == 3 and seen.launches()["ivf_block_topk"] == 2
        seen.reset()
        index.search(queries, 10, nprobe=CUDA_NPROBE)
    assert sum(seen.calls().values()) == 0, seen.calls()

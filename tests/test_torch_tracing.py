"""The port's spans (``photo_search_engine_tpu_torch/tracing.py``) and the
benchmark's readers of them (``portbench/metrics/``), on the CPU.

* Off (no ``torch.profiler`` session) the search path records nothing,
  reads no ``perf_counter_ns`` and makes no CUDA event.
* The switch is process-wide: under the profiler, ``tracing.on()`` is True
  on a thread that did not start it.
* Concurrent searches through the micro-batcher give every request its
  spans under one ``req``, nested in time, and every batch its own; the
  filtered path records the batcher's spans alone.
* The ring keeps the newest ``CAPACITY`` spans and counts the rest.
* Each reader gives its known value on hand-built spans and a hand-built
  device trace (with a clock offset), and nothing without spans; a traced
  run of each cell at a small size reports the ``program_span`` metrics.
"""

import math
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from photo_search_engine_tpu_torch import tracing
from photo_search_engine_tpu_torch.core.batcher import attach_microbatcher
from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
from portbench import manifest, run as portbench_run
from portbench.tests.helpers import TINY
from tests.torch_parity import slow_scans

D = 8
N = 64
TIMEOUT = 60
BOOK = manifest.load()
SEED = 2 ** 31 + 4242


def _profiling():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _index(tmp_path, quantized=False):
    rows = np.random.default_rng(7).normal(size=(N, D)).astype(np.float32)
    index = VectorIndex(D, index_path=str(tmp_path / "i.index"), metadata_path=str(tmp_path / "i.json"),
                        metric="cosine", quantized=quantized, device="cpu")
    index.add_batch(rows, [{"photo_path": f"/p/{i}.jpg"} for i in range(N)])
    return index


def _serve(index, masked, threads=4, each=6):
    """``each`` "find similar" requests from each of ``threads`` threads,
    through the index's micro-batched search (filtered with ``masked``)."""
    mask = np.arange(N) % 2 == 0
    errors = []

    def worker(w):
        try:
            for i in range(each):
                vector = index.get_embedding_by_photo_path(f"/p/{w * each + i}.jpg")
                if masked:
                    index.search_masked(vector, 3, mask)
                else:
                    index.search(vector, 3)
        except Exception as exc:  # noqa: BLE001 — reported by the assert below
            errors.append(exc)

    pool = [threading.Thread(target=worker, args=(w,)) for w in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in pool) and not errors, errors
    return threads * each


def test_off_records_nothing_reads_no_clock_and_makes_no_event(tmp_path, monkeypatch):
    index = _index(tmp_path, quantized=True)
    batcher = attach_microbatcher(index, window_s=0.005)
    tracing.clear()

    def refuse(*args, **kwargs):
        raise AssertionError("called with the tracer off")

    with monkeypatch.context() as m:
        m.setattr(time, "perf_counter_ns", refuse)
        m.setattr(torch.cuda, "Event", refuse)
        assert not tracing.on()
        _serve(index, masked=False)
        _serve(index, masked=True)
        index.search_batch(np.ones((2, D), np.float32), 3)  # the unbatched path
        index._store.search(np.ones((2, D), np.float32), 3, impl="int8")
    batcher.close()
    assert tracing.spans() == [] and tracing.dropped() == 0
    assert tracing.span("a") is tracing.span("b") is tracing.current()


def test_on_is_process_wide_under_the_profiler():
    seen = []
    assert not tracing.on()
    with _profiling():
        t = threading.Thread(target=lambda: seen.append(tracing.on()))
        t.start()
        t.join(timeout=TIMEOUT)
        assert tracing.on()
    assert seen == [True] and not tracing.on()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s[0], []).append(s)
    return out


def _covered(intervals, lo, hi):
    """Nanoseconds of ``[lo, hi]`` that the union of ``intervals`` covers."""
    total, reach = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            total += b - a
            reach = b
    return total


@pytest.mark.parametrize("mode", ["flat", "filtered", "inline"])
def test_request_and_batch_spans(tmp_path, mode):
    """Every request: a ``batcher.queue`` and a ``batcher.wake`` naming its
    batch; every batch: one ``batcher.dispatch`` and one ``batcher.execute``,
    a root, naming its requests and whether it ran inline.  On the flat
    batched search, every request also has a ``vector_index.search`` root
    whose queue, wake and ``vector_index.hits`` share its ``req`` and lie
    inside it, and which they cover with its batch's dispatch and execute
    to at least 90 % over all requests; every batch an
    ``embedding_store.scan`` inside its execute.  The filtered path records
    the batcher's spans alone.  Flat and filtered send requests from four
    threads at once, on scans slowed to overlap, so the collector cuts
    batches (``inline=False``) besides the requests that found the batcher
    idle; inline sends them one at a time, so every batch runs on its
    caller's thread (``inline=True``) under the caller's open
    ``vector_index.search``."""
    index = _index(tmp_path)
    if mode != "inline":
        slow_scans(index, 0.005)
    batcher = attach_microbatcher(index, window_s=0.003)
    tracing.clear()
    with _profiling():
        threads, each = (1, 24) if mode == "inline" else (4, 6)
        sent = _serve(index, mode == "filtered", threads, each)
    batcher.close()
    spans = _by_name(tracing.spans())
    dispatch = {s[4]: s for s in spans["batcher.dispatch"]}
    execute = {s[4]: s for s in spans["batcher.execute"]}
    assert len(dispatch) == len(spans["batcher.dispatch"]) == len(execute) == batcher.batches_run
    assert all(e[1] == e[4] and e[2] is None and d[5] <= d[6] <= e[5] for d, e in
               ((dispatch[b], execute[b]) for b in execute))
    inline = [e[7]["inline"] for e in execute.values()]
    assert all(isinstance(i, bool) for i in inline) and sum(inline) == batcher.inline_batches
    assert all(len(e[7]["reqs"]) == 1 for e in execute.values() if e[7]["inline"])
    if mode == "inline":
        assert all(inline) and batcher.batches_run == sent
    else:
        assert any(inline) and not all(inline), inline
    for name in ("batcher.queue", "batcher.wake"):
        assert len(spans[name]) == sent and all(s[4] in execute for s in spans[name]), name
    served = [r for e in execute.values() for r in e[7]["reqs"]]
    assert sorted(served, key=str) == sorted((s[3] for s in spans["batcher.queue"]), key=str)
    if mode == "filtered":
        assert set(spans) == {"batcher.queue", "batcher.wake", "batcher.dispatch", "batcher.execute"}
        return
    roots = spans["vector_index.search"]
    assert len(roots) == sent and all(r[2] is None and r[3] == r[1] for r in roots)
    # each request served once; a request may overtake one that opened its
    # root earlier but reached the batcher later
    assert sorted(served) == sorted(r[1] for r in roots)
    by_req = {}
    for name in ("batcher.queue", "batcher.wake", "vector_index.hits"):
        assert len(spans[name]) == sent, name
        for s in spans[name]:
            by_req.setdefault(s[3], {})[name] = s
            assert s[2] == s[3]  # a child of the request's root
    covered = total = 0
    for root in roots:
        children = by_req[root[1]]
        batch = children["batcher.queue"][4]
        assert children["batcher.wake"][4] == batch
        for s in children.values():
            assert root[5] <= s[5] <= s[6] <= root[6], s
        parts = [children[n][5:7] for n in children] + [dispatch[batch][5:7], execute[batch][5:7]]
        covered += _covered(parts, root[5], root[6])
        total += root[6] - root[5]
    assert covered >= 0.9 * total, covered / total
    scans = spans["embedding_store.scan"]
    assert sorted(s[4] for s in scans) == sorted(execute)
    for scan in scans:
        up = execute[scan[4]]
        assert scan[2] == up[1] and up[5] <= scan[5] <= scan[6] <= up[6]


def test_the_ring_drops_the_oldest_and_counts_them():
    tracing.clear()
    extra = 10
    for i in range(tracing.CAPACITY + extra):
        tracing.record("x", i, i + 1)
    kept = tracing.spans()
    assert len(kept) == tracing.CAPACITY and tracing.dropped() == extra
    assert kept[0][5] == extra and kept[-1][5] == tracing.CAPACITY + extra - 1
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

HOST_START = 1000.0  # the window on the host clock, seconds
DEVICE_START_US = 5e6  # the window mark on the trace's clock: an offset of -995 s


def _ns(seconds):
    return round(seconds * 1e9)


GAPS_HOST = [(1000.10, 1000.171), (1000.176, 1000.52), (1000.54, 1000.5415), (1000.547, 1002.0)]


def _run_with(gaps_host=GAPS_HOST):
    """A run whose traced window is [1000, 1002] s on the host's clock, with
    the device idle over ``gaps_host``, given on the trace's clock."""
    offset_s = DEVICE_START_US * 1e-6 - HOST_START
    device = {"start_us": DEVICE_START_US, "window_s": 2.0, "busy_s": 0.0, "kernel_s": 0.0, "ops": [],
              "gaps_us": [((lo + offset_s) * 1e6, (hi + offset_s) * 1e6) for lo, hi in gaps_host]}
    return SimpleNamespace(traced=SimpleNamespace(host_start=HOST_START, host_stop=HOST_START + 2.0, device=device))


def _hand_built_run():
    """Two requests in the traced window and one before it, the device busy
    between ``GAPS_HOST``; the expected values:

    * queue_wait_ms: (100 + 30) / 2 = 65;
    * handoff_ms: ((10 + 2) + (5 + 1)) / 2 = 9;
    * hits_ms: (0.1 + 0.4) / 2 = 0.25;
    * scan_event_ms: (5 + 11) / 2 = 8: the first scan holds the busy
      stretch 1000.171–1000.176, the second is busy from its start
      (1000.536, clipped) to 1000.547; the scan before the window is left
      out;
    * idle_batcher_pct: gap 1 ∩ request A's wait 60 ms + gap 2 ∩ B's 20 ms
      over a 2 s window = 4.0.
    """
    tracing.clear()
    for batch, (queued, cut, started, woken, woke, hits) in {
        1: (1000.05, 1000.15, 1000.16, 1000.200, 1000.202, (1000.203, 1000.2031)),
        2: (1000.50, 1000.53, 1000.535, 1000.600, 1000.601, (1000.602, 1000.6024)),
        3: (999.00, 999.10, 999.2, 999.3, 999.31, (999.32, 999.33)),
    }.items():
        req = 100 + batch
        tracing.record("batcher.queue", _ns(queued), _ns(cut), parent=req, req=req, batch=batch)
        tracing.record("batcher.dispatch", _ns(cut), _ns(started), batch=batch)
        tracing.record("batcher.wake", _ns(woken), _ns(woke), parent=req, req=req, batch=batch)
        tracing.record("vector_index.hits", _ns(hits[0]), _ns(hits[1]), parent=req, req=req)
    for lo, hi in ((1000.17, 1000.178), (1000.536, 1000.550), (999.21, 999.29)):
        tracing.record("embedding_store.scan", _ns(lo), _ns(hi), parent=0, batch=0)
    return _run_with()


@pytest.mark.parametrize("metric, value", [
    ("queue_wait_ms", 65.0), ("handoff_ms", 9.0), ("hits_ms", 0.25), ("scan_event_ms", 8.0),
    ("idle_batcher_pct", 4.0),
])
def test_reader_on_hand_built_spans(metric, value):
    reader = manifest.reader(metric)
    run = _hand_built_run()
    assert reader.read(run) == pytest.approx(value, rel=1e-6)
    tracing.clear()
    assert reader.read(run) is None  # a program that recorded nothing: no value, no error


@pytest.mark.parametrize("scans, value", [
    ([(1000.30, 1000.31)], None),
    ([(1000.17, 1000.178), (1000.30, 1000.31)], 5.0),
    ([(1000.09, 1000.18)], 86.0),
], ids=["idle-throughout", "idle-scan-left-out", "first-to-last"])
def test_scan_event_ms_spans_the_first_to_the_last_device_activity(scans, value):
    """Per scan, from the first to the last busy instant inside it (an idle
    stretch between them counted); a scan the device was idle in is left
    out, and with no other, nothing is reported."""
    tracing.clear()
    for lo, hi in scans:
        tracing.record("embedding_store.scan", _ns(lo), _ns(hi))
    got = manifest.reader("scan_event_ms").read(_run_with())
    tracing.clear()
    assert got == (None if value is None else pytest.approx(value, rel=1e-6))


@pytest.mark.parametrize("flags, value", [
    ([True, True, False, True], 75.0),
    ([None, None], None),
], ids=["share", "no-attribute"])
def test_inline_pct_reads_the_share_of_inline_batches(flags, value):
    """Of the ``batcher.execute`` spans wholly in the window, the share
    whose ``inline`` is True; a batch before the window is left out, and a
    program that records no ``inline`` attribute gives nothing."""
    tracing.clear()
    for i, flag in enumerate(flags):
        attrs = {"reqs": [i]} if flag is None else {"reqs": [i], "inline": flag}
        tracing.record("batcher.execute", _ns(1000.1 + 0.1 * i), _ns(1000.15 + 0.1 * i), batch=i, **attrs)
    tracing.record("batcher.execute", _ns(999.0), _ns(999.1), batch=99, reqs=[99], inline=False)
    got = manifest.reader("inline_pct").read(_run_with())
    tracing.clear()
    assert got == (None if value is None else pytest.approx(value))


def _span_metrics(cell):
    return {m["name"]: m["unit"] for m in manifest.metrics(BOOK, cell, True) if m["source"] == "program_span"}


@pytest.mark.parametrize("cell", [w["name"] for w in BOOK["workloads"]])
def test_traced_cpu_run_reports_the_span_metrics(cell):
    """Every ``program_span`` metric of the cell is reported: a time is
    above 0, and a share (``%``) lies in [0, 100], where 0 is a reading too
    (on a loaded host a backlog can keep the micro-batcher busy all through
    the window, so that no batch runs inline)."""
    span_metrics = _span_metrics(cell)
    assert span_metrics
    result = portbench_run.run_cell(cell, SEED, 0.5, True, device="cpu", overrides=TINY, log=lambda _: None)
    assert result["correct"], result["compared"]
    for name, unit in sorted(span_metrics.items()):
        value = result["metrics"][name]["value"]
        assert value is not None and math.isfinite(value), (name, value)
        assert 0 <= value <= 100 if unit == "%" else value > 0, (name, value)

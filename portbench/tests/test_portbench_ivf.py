"""The IVF configuration ``openai1536-ivf-5m`` and what it brought, on the
CPU at 8192 × 64: its cell runs correct; the ``int8_scan`` control fails
``dist_err`` and the ``exact_thinned`` fault fails ``recall_miss``; the
judge's ``probed_topk`` is the IVF semantics by hand; kernel 7's work by
hand; and the three IVF readers on a hand-built traced run, with nothing
read from a program that records no IVF span."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from photo_search_engine_tpu_torch import tracing
from portbench import control, manifest, peaks, run
from portbench.tests.helpers import TINY

BOOK = manifest.load()
CELL = "ivf-5m.image.r65"
CFG = manifest.config(BOOK, "openai1536-ivf-5m")
SEED = 2 ** 31 + 1818


def quiet(_line):
    pass


def test_the_cell_runs_correct():
    result = run.run_cell(CELL, SEED, 0.5, False, device="cpu", overrides=TINY, log=quiet)
    assert result["correct"], result["compared"]
    assert set(result["compared"]) == set(CFG["limits"]) and "recall_miss" in result["compared"]


def test_the_control_fails_dist_err_and_the_fault_recall_miss():
    limits = CFG["limits"]
    for line in control.readings(CELL, [SEED, SEED + 1], 0.5, device="cpu", overrides=TINY, log=quiet):
        assert all(line["program"][n] <= limits[n] for n in limits), line["program"]
        assert line["control"]["dist_err"] > limits["dist_err"], line["control"]
        (fault,) = line["faults"]
        assert fault["readings"]["recall_miss"] > limits["recall_miss"], fault


def fewer_probes(nprobe):
    """A fault of the timed path: the index probes ``nprobe`` lists, not
    the configuration's."""
    def fault(route):
        route.__self__.ivf_nprobe = nprobe
        return route
    return fault


def thinned_lists(share):
    """A fault of the timed path: a seeded ``share`` of the layout's slots
    left out of every scan, from the routed call that builds the index on."""
    def fault(route):
        index = route.__self__
        thinned = []

        def call(queries, k, mask=None):
            ivf = index._ensure_ivf()
            if not thinned:
                gen = torch.Generator(device="cpu")
                gen.manual_seed(1)
                keep = torch.rand(ivf._row_valid.shape, generator=gen) >= share
                ivf._row_valid.mul_(keep.to(ivf._row_valid))
                thinned.append(share)
            return route(queries, k, mask)
        return call
    return fault


# At 8192 rows the lists hold 8 rows and the program misses 2-6 % of the exact
# top-50, so the faults here are coarser than the ones the limit was set
# against at 5M (PERF.md section 4): 48 probes, a tenth of the slots.
@pytest.mark.parametrize("fault", [fewer_probes(8), thinned_lists(0.5)], ids=["fewer_probes", "thinned_lists"])
def test_a_scan_of_less_than_the_probed_lists_is_not_correct(fault):
    result = run.run_cell(CELL, SEED, 0.5, False, device="cpu", overrides=TINY, route_fault=fault, log=quiet)
    miss = result["compared"]["recall_miss"]
    assert not result["correct"] and miss["value"] > miss["limit"], result["compared"]


def test_probed_topk_by_hand():
    """Two lists of capacity 3 on a line; the query probes the nearer list
    only, so the best row of the other list is left out."""
    judge = manifest.judge("ivf_recall")
    corpus = torch.tensor([[1.0, 0.0], [0.9, 0.1], [0.0, 1.0], [0.2, 0.8], [0.95, 0.3]])
    centroids = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    perm = np.array([0, 1, -1, 2, 3, 4])  # row 4 sits in list 1, though it is near list 0
    query = np.array([[1.0, 0.1]], np.float32)
    ids, scores = judge.probed_topk(corpus, query, centroids, perm, 3, 1, 3)
    assert ids.tolist() == [[0, 1, -1]]
    assert scores[0, :2].tolist() == pytest.approx([1.0, 0.91]) and torch.isneginf(scores[0, 2])
    ids, _ = judge.probed_topk(corpus, query, centroids, perm, 3, 2, 3)
    assert ids.tolist() == [[0, 4, 1]]


def test_kernel_7_work_by_hand():
    w = manifest.work("ivf_bf16").work(2, 3, 1000, 4, list_rows=10, pair_rows=15, lists=3, lrows=8)
    # live rows 10·4·2 + flags 3·8 + queries 2·4·2 + results 2·3·8; 2 ops a dim a scored row
    assert w == {"moved_bytes": 80 + 24 + 16 + 48, "ops": 2 * 15 * 4, "unit": "bf16"}


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

HOST_START = 1000.0
DEVICE_START_US = 5e6  # the window mark on the trace's clock


def _ns(seconds):
    return round(seconds * 1e9)


SCAN = {"queries": 1, "k": 50, "lrows": 7424, "dim": 1536, "lists": 64, "list_rows": 300000, "pair_rows": 300000,
        "masked": False}
K7 = "void (anonymous namespace)::tc_ivf_topk_kernel<pse::Bf16"


def _traced_run(k7_seconds=0.004):
    """A 2 s traced window on the host's clock [1000, 1002]; the device busy
    over 1000.101–1000.103 and 1000.5005–1000.5035 only (host clock), K7's
    kernels ``k7_seconds`` of it.  Two ``ivf.search`` spans of 5 and 7 ms
    in the window and one before it; an ``ivf.scan`` in each (the one
    before the window and a filtered one are left out of the roofline)."""
    offset_s = DEVICE_START_US * 1e-6 - HOST_START
    busy = [(1000.101, 1000.103), (1000.5005, 1000.5035)]
    edges = [HOST_START] + [t for b in busy for t in b] + [HOST_START + 2.0]
    gaps = [((edges[i] + offset_s) * 1e6, (edges[i + 1] + offset_s) * 1e6) for i in range(0, len(edges), 2)]
    device = {"start_us": DEVICE_START_US, "window_s": 2.0, "busy_s": 0.005, "kernel_s": 0.005,
              "ops": [(K7, k7_seconds), ("void at::native::sort_kernel", 0.001)], "gaps_us": gaps}
    tracing.clear()
    for lo, hi in ((1000.100, 1000.105), (1000.500, 1000.507), (999.0, 999.01)):
        tracing.record("ivf.search", _ns(lo), _ns(hi))
    tracing.record("ivf.scan", _ns(1000.1005), _ns(1000.104), **SCAN)
    tracing.record("ivf.scan", _ns(1000.5001), _ns(1000.5060), **SCAN)
    tracing.record("ivf.scan", _ns(999.001), _ns(999.009), **SCAN)
    tracing.record("ivf.scan", _ns(1000.9), _ns(1000.901), **{**SCAN, "masked": True})
    return SimpleNamespace(traced=SimpleNamespace(host_start=HOST_START, host_stop=HOST_START + 2.0, device=device),
                           cfg=CFG)


def _least_seconds():
    w = manifest.work("ivf_bf16").work(1, 50, CFG["rows"], 1536, list_rows=300000, pair_rows=300000, lists=64,
                                       lrows=7424)
    return peaks.least_seconds(**w)


@pytest.mark.parametrize("metric, value", [
    ("ivf_search_ms", 6.0),  # (5 + 7) / 2
    ("ivf_scan_event_ms", 2.5),  # (2 + 3) / 2: the first to the last busy instant inside each scan
    ("ivf_roofline", None),  # two scans' bound over 4 ms of K7
])
def test_reader_on_a_hand_built_traced_run(metric, value):
    reader = manifest.reader(metric)
    got = reader.read(_traced_run())
    want = 100.0 * 2 * _least_seconds() / 0.004 if value is None else value
    assert got == pytest.approx(want, rel=1e-6)
    if metric == "ivf_roofline":
        assert 0 < got <= 100
    assert reader.read(_no_spans()) is None
    tracing.clear()


def _no_spans():
    """A traced run of a program that records no IVF span (the flat cells,
    or a checkout whose ``IVFIndex.search`` has none)."""
    run_ = _traced_run()
    tracing.clear()
    tracing.record("embedding_store.scan", _ns(1000.1005), _ns(1000.104))
    return run_


def test_the_roofline_of_a_run_without_device_trace_is_none():
    run_ = _traced_run()
    run_.traced.device = None
    assert manifest.reader("ivf_roofline").read(run_) is None
    assert manifest.reader("ivf_scan_event_ms").read(run_) is None
    tracing.clear()

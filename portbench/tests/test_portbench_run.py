"""A run end to end on the CPU at a small size: the result line the
contract asks for, ``correct`` true for the program, false for each fault
of the timed path and for each configuration's control.  The faults are
planted at the index's routing point, where every route's answer passes,
so they reach the flat store, the int8 tier and an IVF index alike."""

import json

import numpy as np
import pytest

from portbench import control, manifest, run
from portbench.tests.helpers import IVF, TINY, add_config, assert_result_shape, checkout_copy, small_mix

BOOK = manifest.load()
SEED = 2 ** 31 + 12345  # more than 32 signed bits hold
CONFIGS = [c["name"] for c in BOOK["configs"]]


def quiet(_line):
    pass


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout copy with a small dense mix (every answer checked) on each
    configuration, and on a throwaway IVF configuration added as a file.  At
    1000 req/s requests overlap and batches form: a lone request runs alone,
    and half of a batch of one leaves nothing out."""
    mix = small_mix(rate=1000)
    root = checkout_copy(tmp_path_factory.mktemp("root"),
                         [(f"test.{name}", name, mix) for name in CONFIGS + ["throwaway-ivf"]])
    add_config(root, "throwaway-ivf", **IVF)
    return root


@pytest.mark.parametrize("cell", [w["name"] for w in BOOK["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_each_cell_runs_and_is_correct(cell, trace, capsys):
    result = run.run_cell(cell, SEED, 0.5, trace, device="cpu", overrides=TINY, log=quiet)
    assert_result_shape(result, trace)
    assert result["correct"], result["compared"]
    names = {m["name"] for m in manifest.metrics(BOOK, cell, trace)}
    device_metrics = {m["name"] for m in BOOK["per_layer"] if m["source"] == "device_trace"}
    assert set(result["metrics"]) == names - (device_metrics if trace else set())
    run.emit(result)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(result))
    assert err.strip().splitlines()[-len(result["compared"]):][0].startswith("compared ")


def altered_ids(route):
    """An answer altered where it is produced: each list's best row is swapped
    for the next row of the library."""
    def call(queries, k, mask=None):
        d, i = route(queries, k, mask)
        i = i.copy()
        i[:, 0] = (i[:, 0] + 1) % TINY["rows"]
        return d, i
    return call


def half_left_out(route):
    """Half of the batch left out: the second half's queries get the first
    half's answers."""
    def call(queries, k, mask=None):
        queries = np.atleast_2d(queries)
        half = (len(queries) + 1) // 2
        d, i = route(queries[:half], k, mask)
        pick = np.arange(len(queries)) % half
        return d[pick], i[pick]
    return call


def stale_readback(route):
    """The distances of the previous call served again (a step that returns
    its state unchanged)."""
    last = {}

    def call(queries, k, mask=None):
        d, i = route(queries, k, mask)
        prev = last.get(d.shape, d)
        last[d.shape] = d
        return prev, i
    return call


@pytest.mark.parametrize("config", CONFIGS + ["throwaway-ivf"])
@pytest.mark.parametrize("fault", [altered_ids, half_left_out, stale_readback])
def test_a_fault_of_the_timed_path_is_not_correct(root, config, fault):
    result = run.run_cell(f"test.{config}", SEED, 1.0, False, device="cpu", root=root, overrides=TINY,
                          route_fault=fault, log=quiet)
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("config", CONFIGS + ["throwaway-ivf"])
def test_the_routed_path_without_a_fault_is_correct(root, config):
    result = run.run_cell(f"test.{config}", SEED, 1.0, False, device="cpu", root=root, overrides=TINY,
                          route_fault=lambda route: route, log=quiet)
    assert result["correct"], result["compared"]


@pytest.mark.parametrize("config", CONFIGS)
def test_the_control_is_not_correct(root, config):
    lines = control.readings(f"test.{config}", [SEED, SEED + 1, SEED + 2], 0.5, device="cpu", root=root,
                             overrides=TINY, log=quiet)
    limits = manifest.config(BOOK, config)["limits"]
    for line in lines:
        assert all(line["program"][n] <= limits[n] for n in limits), line["program"]
        assert any(not line["control"][n] <= limits[n] for n in line["control"]), line["control"]
        for fault in line.get("faults", []):
            assert any(not fault["readings"][n] <= limits[n] for n in fault["readings"]), fault


def test_no_card_no_result(capsys):
    assert run.main(["--workload", BOOK["workloads"][0]["name"], "--seed", "1", "--seconds", "1"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


def test_seed_gives_the_same_library():
    import torch

    cfg = {**manifest.config(BOOK, CONFIGS[0]), **TINY}
    a = run.corpus.make_rows(cfg, SEED, torch.device("cpu"), torch.float32)
    b = run.corpus.make_rows(cfg, SEED, torch.device("cpu"), torch.float32)
    assert torch.equal(a, b) and run.corpus.checksum(a) == run.corpus.checksum(b)
    assert run.corpus.checksum(run.corpus.make_rows(cfg, SEED + 1, torch.device("cpu"), torch.float32)) != \
        run.corpus.checksum(a)


def test_every_seed_offers_the_same_load():
    mix = small_mix(rate=100)
    p, q = run.schedule(mix, SEED, 2.0, TINY["rows"]), run.schedule(mix, SEED + 1, 2.0, TINY["rows"])
    assert np.array_equal(run.schedule(mix, SEED, 2.0, TINY["rows"]).rows, p.rows)
    # the same arrival times, evenly spaced; other photos
    assert np.array_equal(p.due, q.due) and not np.array_equal(p.rows, q.rows)
    assert len(p.due) == 301 and abs(p.due[-1] - 3.0) < 0.05
    assert np.allclose(np.diff(p.due), 1 / mix["rate"])


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    result = run.run_cell(BOOK["workloads"][0]["name"], SEED, 1.0, True, overrides={"rows": 262144}, log=quiet)
    assert_result_shape(result, True)
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")

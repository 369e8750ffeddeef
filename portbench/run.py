"""One run of one benchmark cell of ``photo_search_engine_tpu_torch``.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  What a run does:

1. Set-up (``setup_s``, from the process's start to the first timed
   request): build the port's CUDA kernels (only a checkout's first run
   does; later runs find them under ``photo_search_engine_tpu_torch/
   _build/``), make the configuration's rows on the card from the seed
   (``corpus.py``), install them with the library's metadata in a
   ``VectorIndex`` built with the configuration's index options and the
   micro-batcher attached as the app builds and attaches them
   (``api/app.py initialize_services``), search once at every batch size
   the mix can form, then run the mix's workers for its ``warmup_s``.
2. The window: the mix's workers (threads of this process, as the WSGI
   handler threads are) send its requests, evenly spaced at its rate, for
   ``--seconds``; each request is the mix's request shape
   (``portbench/requests/<shape>.py``; ``image``: the two calls
   ``/search_by_image`` makes into the index,
   ``get_embedding_by_photo_path`` then ``search(embedding, k)``).  With
   ``--trace 1`` the first ``TRACE_SECONDS`` of the window are traced by
   ``torch.profiler`` and the harness's spans are kept.
3. The check: once every request of the window has answered, the device
   peak is read and the program is freed; the rows are made again from
   the seed and the plain reference (``reference.py``) judges a sample of
   the answers drawn from the seed.  Each number compared is printed beside
   its limit on the last lines of standard error, and under ``compared``
   as the last key of the result line.
4. The result: one JSON line, the last of standard output.  With
   ``--trace 0`` its metrics are the cell's end-to-end ones, with
   ``--trace 1`` its per-layer ones; each metric's reader is
   ``portbench/metrics/<name>.py``.

The run exits with 2, and prints no result, without the CUDA cards the
cell asks for, and with 3 if JAX or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from portbench import corpus, manifest, peaks, reference, trace as trace_mod  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "photo_search_engine_tpu")
CACHE_DIR = ".portbench_cache"  # the checkout's caches (CUDA's JIT cache; the kernels build in the port's _build/)
TRACE_SECONDS = 2.0  # traced part of a --trace 1 window
JOIN_GRACE_S = 60.0  # how long past the close an answer is waited for
GAP_LABELS = ("store.search", "reconstruct", "batcher.wait")


def set_cache_env(root: str) -> None:
    """Every cache in fixed directories of the checkout; no library that
    the port might import loads JAX on its own."""
    base = os.path.join(root, CACHE_DIR)
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "cuda")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return done.stdout.strip() or done.stderr.strip()


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------


def build(cfg: Dict, seed: int, device, metas: List[Dict]):
    """The vector-search service of one seed's library: ``(index, batcher,
    (rows checksum, rows dtype))``.  The rows are handed over and not
    kept.  The configuration's optional ``ivf`` block (``nlist``,
    ``nprobe``, ``target_recall``) reaches the index as ``IVF_NLIST``,
    ``IVF_NPROBE`` and ``IVF_TARGET_RECALL`` do in the app; a key it leaves
    out keeps the app's default."""
    import torch

    from photo_search_engine_tpu_torch.core.batcher import attach_microbatcher
    from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
    from photo_search_engine_tpu_torch.ops.topk import resolve_store_dtype

    dtype = getattr(torch, resolve_store_dtype(cfg["store_dtype"], device))
    rows = corpus.make_rows(cfg, seed, device, dtype)
    digest = (corpus.checksum(rows), rows.dtype)
    unused = os.path.join(tempfile.gettempdir(), "portbench-never-written")
    index = VectorIndex(
        dimension=int(cfg["dim"]),
        index_path=os.path.join(unused, "index.npy"),
        metadata_path=os.path.join(unused, "metadata.json"),
        metric=cfg["metric"],
        index_type=cfg["index_type"],
        store_dtype=cfg["store_dtype"],
        quantized=cfg["quantized"],
        device=device,
        **{f"ivf_{key}": value for key, value in cfg.get("ivf", {}).items()},
    )
    index.load_device_rows(rows, metas)
    del rows
    mb = cfg["microbatch"]
    batcher = attach_microbatcher(index, max_batch=int(mb["max_batch"]), window_s=float(mb["window_ms"]) / 1000.0,
                                  pipeline=int(mb["pipeline"]))
    # the full collection that the library's millions of new objects are due
    # runs now, in the set-up, and not at a random moment of the window
    gc.collect()
    return index, batcher, digest


def wrap_store(index, wrapper: Callable) -> None:
    """Put ``wrapper(original_search)`` in place of the live store's search."""
    store = index._store
    store.search = wrapper(store.search)


def wrap_route(index, wrapper: Callable) -> None:
    """Put ``wrapper(original)`` in place of the index's routing point,
    ``VectorIndex._route_search(queries, k, mask) -> (distances, row ids)``,
    where every route's answer passes (the flat store, the int8 tier, IVF)."""
    index._route_search = wrapper(index._route_search)


def schedule(mix: Dict, seed: int, seconds: float, rows: int) -> SimpleNamespace:
    """The mix's requests: when each is due (seconds from the start of the
    warm-up), the library row it asks about, and whether its answer is
    checked.  Arrivals are evenly spaced at the mix's ``rate`` for every
    seed; the seed picks the rows and the checks, so it changes which
    photos are asked about and never the load."""
    rate = float(mix["rate"])
    count = int(math.ceil(rate * (float(mix["warmup_s"]) + seconds))) + 1
    rng = np.random.default_rng([seed % 2 ** 63, 1])
    return SimpleNamespace(due=np.arange(count) / rate, rows=rng.integers(0, rows, count),
                           checked=rng.random(count) < float(mix["check_share"]))


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


def drive(index, batcher, cfg: Dict, mix: Dict, seed: int, seconds: float, trace: bool, paths: List[str],
          torch, root: str = manifest.ROOT) -> SimpleNamespace:
    """Warm up, then offer the mix's load for ``seconds``: request i is
    sent, when it is due, by worker i mod ``workers`` (the server's handler
    threads) as the mix's request shape (``portbench/requests/``), and its
    latency runs from when it was due, so a worker still busy with its
    previous request makes it late, not lighter.  Returns every request's
    times and outcome, the checked answers, how late each request started,
    and with ``trace`` the spans, the batcher's counters and the reduced
    profiler trace of the traced part."""
    shape = manifest.request(mix["request"], root)
    k, workers = int(mix["k"]), int(mix["workers"])
    cuda = index.device.type == "cuda"
    warm = np.random.default_rng([seed % 2 ** 63, 2]).integers(0, int(cfg["rows"]), batcher.max_batch)
    shape.warm(index, paths, warm, k, range(1, min(workers, batcher.max_batch) + 1))  # every batch the mix can form
    plan = schedule(mix, seed, seconds, int(cfg["rows"]))
    n_req = len(plan.due)
    start = np.full(n_req, np.nan)
    mid = np.full(n_req, np.nan)
    end = np.full(n_req, np.nan)
    ok = np.zeros(n_req, bool)
    checked, errors = [], []
    store_calls: List[tuple] = []
    if trace:
        def timed(search):
            def call(queries, k_, **kw):
                t = time.perf_counter()
                out = search(queries, k_, **kw)
                store_calls.append((t, time.perf_counter(), int(np.atleast_2d(queries).shape[0]), int(k_)))
                return out
            return call
        wrap_store(index, timed)
    send, clock = shape.send, time.perf_counter

    def worker(w: int) -> None:
        for i in range(w, n_req, workers):  # request i goes to worker i mod workers
            due = origin + plan.due[i]
            if due >= stop_at:
                return
            wait = due - clock()
            if wait > 0:
                time.sleep(wait)
            row = int(plan.rows[i])
            start[i] = clock()
            try:
                vector, mid[i], hits = send(index, paths[row], k, clock)
                ok[i] = True
            except Exception as exc:  # noqa: BLE001 — a failed request is counted, not fatal
                errors.append(repr(exc))
            end[i] = clock()
            if ok[i] and plan.checked[i] and due >= start_at:
                checked.append((row, vector, hits))

    gen2_before = gc.get_stats()[2]["collections"]
    prof = trace_mod.start(torch, cuda) if trace else None
    pool = [threading.Thread(target=worker, args=(w,), name=f"worker-{w}", daemon=True) for w in range(workers)]
    origin = clock() + 0.05
    start_at = origin + float(mix["warmup_s"])
    stop_at = start_at + seconds
    for t in pool:
        t.start()
    traced = None
    if trace:
        tw = min(TRACE_SECONDS, seconds)
        time.sleep(max(0.0, start_at - clock()))
        with torch.profiler.record_function(trace_mod.WINDOW_MARK):
            host_start = clock()
            counts0 = (batcher.batches_run, batcher.requests_served)
            time.sleep(max(0.0, host_start + tw - clock()))
            host_stop = clock()
            counts1 = (batcher.batches_run, batcher.requests_served)
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        traced = SimpleNamespace(host_start=host_start, host_stop=host_stop,
                                 batches=counts1[0] - counts0[0], requests=counts1[1] - counts0[1],
                                 device=trace_mod.read(prof))
    for t in pool:
        t.join(timeout=max(0.0, stop_at + JOIN_GRACE_S - clock()))
    gen2 = gc.get_stats()[2]["collections"] - gen2_before
    due = origin + plan.due
    began = ~np.isnan(start)
    return SimpleNamespace(due=due, start=start, mid=mid, end=end, ok=ok, checked=checked, errors=errors,
                           late=start[began] - due[began], start_at=start_at, stop_at=stop_at, gen2=gen2,
                           store_calls=store_calls, traced=traced)


def tally(window: SimpleNamespace, seconds: float) -> SimpleNamespace:
    """Requests of the window: those due in it (latency from when each was
    due, failures) and those answered in it (throughput).  A failed
    request, or one that never answered, has an infinite latency."""
    sent = (window.due >= window.start_at) & (window.due < window.stop_at)
    answered = window.ok & ~np.isnan(window.end)
    lat = np.where(answered, (window.end - window.due) * 1e3, math.inf)[sent]
    completed = int((answered & (window.end >= window.start_at) & (window.end <= window.stop_at)).sum())
    return SimpleNamespace(latencies_ms=lat, attempted=int(sent.sum()), failed=int((~answered[sent]).sum()),
                           completed=completed, seconds=seconds)


def samples(window: SimpleNamespace, k: int, dim: int):
    """The checked answers as arrays: the row each asked about, the vector
    read back, the rows its hits name (-1 where missing) and their
    distances."""
    n = len(window.checked)
    rows = np.zeros(n, np.int64)
    readback = np.zeros((n, dim), np.float32)
    ids = np.full((n, k), -1, np.int64)
    dists = np.full((n, k), np.nan, np.float64)
    for i, (row, vector, hits) in enumerate(window.checked):
        rows[i] = row
        readback[i] = np.asarray(vector, np.float32)
        for j, hit in enumerate(hits[:k]):
            ids[i, j] = corpus.row_of(hit.get("metadata", {}).get("photo_path"))
            dists[i, j] = float(hit.get("distance", np.nan))
    return rows, readback, ids, dists


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def _finite(value):
    return value if value is not None and math.isfinite(value) else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: Optional[str] = None,
             root: str = manifest.ROOT, overrides: Optional[Dict] = None,
             route_fault: Optional[Callable] = None, log: Callable = print) -> Dict:
    """One run of ``workload``; returns the result line's object with the
    numbers compared under ``compared``.  ``device`` ``"cpu"``,
    ``overrides`` (configuration keys, such as a smaller ``rows``) and
    ``route_fault`` (a wrapper put around the index's routing point,
    :func:`wrap_route`) exist for the CPU tests; the command line runs on
    the card as configured."""
    import torch

    from photo_search_engine_tpu_torch.device import resolve_device

    book = manifest.load(root)
    cell = manifest.cell(book, workload)
    cfg = {**manifest.config(book, cell["config"], root), **(overrides or {})}
    mix = manifest.traffic(cell["traffic"], root)
    dev = resolve_device("cpu" if device == "cpu" else "gpu")
    cuda = dev.type == "cuda"
    if cuda:
        from photo_search_engine_tpu_torch.ops import _cuda

        built = _cuda.build_info()["seconds"]
        log(f"[setup] kernels {'built in ' + format(built, '.1f') + ' s' if built else 'found built'}; "
            f"{torch.cuda.get_device_name(0)}; power: {power_limit()}")
    log(f"[setup] {workload}: {cfg['rows']} x {cfg['dim']} {cfg['index_type']} quantized={cfg['quantized']}, "
        f"{mix['request']} requests at {mix['rate']} req/s to {mix['workers']} workers, k {mix['k']}, seed {seed}, {seconds} s, trace {int(trace)}")
    k, n, dim = int(mix["k"]), int(cfg["rows"]), int(cfg["dim"])
    manifest.judge(cfg["reference"]["kind"], root)  # an unknown kind fails before the set-up, not after the window
    paths = corpus.library_paths(n)
    metas = corpus.metadata(paths)
    index, batcher, digest = build(cfg, seed, dev, metas)
    del metas
    if route_fault is not None:
        wrap_route(index, route_fault)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # the serving peak, not the install's transient copy
    window = drive(index, batcher, cfg, mix, seed, seconds, trace, paths, torch, root)
    setup_s = window.start_at - STARTED
    counts = tally(window, seconds)
    if cuda:
        torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    rows, readback, ids, dists = samples(window, k, dim)
    lat = counts.latencies_ms
    log(f"[window] {counts.attempted} requests sent, {counts.completed} answered in the window, "
        f"{counts.failed} failed or never answered, {len(rows)} checked; latency ms "
        f"p50 {np.percentile(lat, 50) if lat.size else float('nan')} p95 "
        f"{np.percentile(lat, 95) if lat.size else float('nan')} p99 "
        f"{np.percentile(lat, 99) if lat.size else float('nan')} over {lat.size} samples; "
        f"mean batch {batcher.requests_served / max(1, batcher.batches_run)} over the run; "
        f"{window.gen2} full collections in the window; requests started late by {np.mean(window.late) * 1e3} ms "
        f"on average, {np.max(window.late) * 1e3} at most; setup {setup_s} s")
    for e in sorted(set(window.errors))[:5]:
        log(f"[window] error: {e}")

    work = manifest.work(cfg["work"], root).work
    run = SimpleNamespace(
        seconds=seconds, setup_s=setup_s, counts=counts, traced=window.traced, store_calls=window.store_calls,
        spans=None, cfg=cfg, mix=mix,
        least_seconds=lambda b, kk: peaks.least_seconds(**work(b, kk, n, dim)),
    )
    if trace:
        spans: Dict[str, list] = {"reconstruct": [], "batcher.wait": [], "store.search": []}
        done = ~np.isnan(window.end) & ~np.isnan(window.mid)
        for t0, tm, t1 in zip(window.start[done], window.mid[done], window.end[done]):
            spans["reconstruct"].append((t0, tm))
            spans["batcher.wait"].append((tm, t1))
        spans["store.search"] = [(s, e) for s, e, _, _ in window.store_calls]
        run.spans = spans
    metrics = {}
    for m in manifest.metrics(book, workload, trace):
        value = manifest.reader(m["name"], root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": _finite(float(value)), "unit": m["unit"]}

    # the program goes before the reference runs
    batcher.close()
    del index, batcher
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    check = reference_numbers(cfg, seed, dev, digest, rows, readback, ids, dists, k, root)
    limits = cfg["limits"]
    if set(check) != set(limits):
        raise KeyError(f"the numbers compared {sorted(check)} and the configuration's limits {sorted(limits)} differ")
    compared = {name: {"value": _finite(value), "limit": limits[name]} for name, value in check.items()}
    passed = all(v["value"] is not None and v["value"] <= v["limit"] for v in compared.values())
    correct = bool(passed and counts.failed == 0 and len(rows) > 0)

    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": peak,
    }
    result = {"correct": correct, "attempted": counts.attempted, "failed": counts.failed,
              "metrics": metrics, "device": device_info}
    if trace and window.traced.device is not None:
        dev_trace = window.traced.device
        device_info["busy_s"] = dev_trace["busy_s"]
        device_info["window_s"] = dev_trace["window_s"]
        result["breakdown"] = {
            "device_ops": [list(op) for op in dev_trace["ops"][: trace_mod.TOP]],
            "idle_gaps": trace_mod.label_gaps(dev_trace, window.traced.host_start, run.spans, GAP_LABELS),
        }
    result["compared"] = compared
    return result


def reference_numbers(cfg, seed, dev, digest, rows, readback, ids, dists, k, root) -> Dict[str, float]:
    """The reference's judgement of the sampled answers, on the rows made
    again from the seed, by the judge kinds of the checkout at ``root``;
    ``regen_mismatch`` is 1 when those rows are not the ones the program
    served (``digest`` from :func:`build`)."""
    checksum, dtype = digest
    corpus_rows = corpus.make_rows(cfg, seed, dev, dtype)
    numbers = {"regen_mismatch": float(corpus.checksum(corpus_rows) != checksum)}
    numbers.update(reference.judge(cfg["reference"], corpus_rows, rows, readback, ids, dists, k, root))
    return numbers


def emit(result: Dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, v in result["compared"].items():
        print(f"compared {name} {v['value']} limit {v['limit']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    book = manifest.load()
    cell = manifest.cell(book, args.workload)
    set_cache_env(manifest.ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), log=lambda s: print(s, flush=True))
    loaded = forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

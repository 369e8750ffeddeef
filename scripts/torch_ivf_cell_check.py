"""An IVF cell of the benchmark at its own size, built once: a rate sweep,
then its served lists held to the index's own semantics.

    python3 scripts/torch_ivf_cell_check.py --seed <n> [--workload ivf-5m.image.r65]
        [--sweep 25,40,55,65,80,100,120] [--sweep-seconds 8] [--seconds 51] [--out <file.json>]

on a machine with a CUDA card, from the root of a checkout.  One process:

1. the cell's library and service are built as a benchmark run builds them
   (``portbench/run.py``: rows from the seed, ``VectorIndex`` with the
   configuration's IVF options, the micro-batcher), and the IVF is built by
   a first search; its build phases and the device memory are read;
2. ``--sweep``: the cell's traffic at each rate for ``--sweep-seconds``
   (latency from when each request was due), p50 and p95 a rate;
3. the cell's own traffic for ``--seconds`` with its checked answers kept,
   and the index's state (centroids, ``perm``, list capacity, nprobe)
   taken before the program is freed;
4. the rows made again from the seed and ``probed_topk``
   (``portbench/judges/ivf_recall.py``) on that state for the same
   queries: ids equal but where two scores lie within ``TIE``, served
   distances within ``DIST_TOL`` of the float64 score of their row, and
   the queries whose nprobe-th and next list scores lie within ``TIE``
   (where float32 may probe another list) counted apart.

One JSON object to ``--out`` and to standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import corpus, manifest, reference, run  # noqa: E402

TIE = 1e-5  # scores closer than this may trade places between float32 and float64
DIST_TOL = 2e-4  # the cell's dist_err limit


def p50_p95(latencies_ms):
    lat = sorted(latencies_ms.tolist())
    if not lat:
        return None, None
    return lat[max(0, math.ceil(0.5 * len(lat)) - 1)], lat[max(0, math.ceil(0.95 * len(lat)) - 1)]


def compare(corpus_rows, rows, ids, dists, state, k):
    """The served lists against ``probed_topk`` on the index's state."""
    judge = manifest.judge("ivf_recall")
    dev = corpus_rows.device
    queries = reference.normalize_queries(corpus_rows[torch.from_numpy(rows).to(dev)].float().cpu().numpy())
    p_ids, p_scores = judge.probed_topk(corpus_rows, queries, state["centroids"], state["perm"], state["capacity"],
                                        state["nprobe"], k)
    q_op = reference.operand(queries, corpus_rows)
    cents = torch.as_tensor(state["centroids"], device=dev)
    ranked = torch.sort(judge.probe_scores(q_op, cents), dim=1, descending=True).values
    boundary = (ranked[:, state["nprobe"] - 1] - ranked[:, state["nprobe"]]).abs() <= TIE
    served = torch.from_numpy(ids).to(dev)
    s_scores = reference.exact_scores(corpus_rows, q_op, served)
    dist_gap = (torch.from_numpy(dists).to(dev) - s_scores).abs()
    gap = (s_scores - p_scores).abs()
    same = served == p_ids
    off = (~same & (gap > TIE)).any(dim=1)  # ids differ where the scores are no tie
    differ = ~same.all(dim=1)
    out = {}
    for label, sel in (("clear", ~boundary), ("boundary", boundary)):
        where = sel[:, None] & ~same
        out[label] = {
            "lists": int(sel.sum()),
            "identical": int((sel & ~differ).sum()),
            "differ_at_ties_only": int((sel & differ & ~off).sum()),
            "differ_otherwise": int((sel & off).sum()),
            "widest_score_gap_where_ids_differ": float(gap[where].max()) if bool(where.any()) else 0.0,
        }
    out["dist_err"] = float(dist_gap.max()) if dist_gap.numel() else None
    out["dist_within_limit"] = bool(out["dist_err"] is not None and out["dist_err"] <= DIST_TOL)
    out["served_vs_probed_score_gap"] = float((torch.from_numpy(dists).to(dev) - p_scores).abs().max())
    _, ex_ids = reference.chunked_top(lambda a, b: q_op @ corpus_rows[a:b].double().T, corpus_rows.shape[0], k)
    out["recall_at_k_vs_exact"] = float((ex_ids[:, :, None] == served[:, None, :]).any(dim=2).double().mean())
    out["probed_recall_at_k_vs_exact"] = float((ex_ids[:, :, None] == p_ids[:, None, :]).any(dim=2).double().mean())
    return out


def check(workload, seed, rates, sweep_seconds, seconds, device, overrides=None):
    """Steps 1-4 of the module's text for one seed; returns the report."""
    cuda = device.type == "cuda"
    book = manifest.load()
    cell = manifest.cell(book, workload)
    cfg = {**manifest.config(book, cell["config"]), **(overrides or {})}
    mix = manifest.traffic(cell["traffic"])
    k, n, dim = int(mix["k"]), int(cfg["rows"]), int(cfg["dim"])
    report = {"workload": workload, "seed": seed, "card": run.power_limit() if cuda else "cpu"}
    t0 = time.perf_counter()
    paths = corpus.library_paths(n)
    metas = corpus.metadata(paths)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    index, batcher, digest = run.build(cfg, seed, device, metas)
    del metas
    report["install_s"] = time.perf_counter() - t0
    t = time.perf_counter()
    index.raw_search_batch(np.asarray(index.get_embedding_by_photo_path(paths[0]), np.float32), k)  # builds the IVF
    if cuda:
        torch.cuda.synchronize()
        report["device_peak_bytes_install_and_build"] = int(torch.cuda.max_memory_allocated())
        report["device_bytes_serving"] = int(torch.cuda.memory_allocated())
    report["first_search_s"] = time.perf_counter() - t
    ivf = index._ivf
    report["build_seconds"] = dict(ivf.build_seconds)
    report["capacity"], report["nlist"], report["nprobe"] = ivf.capacity, ivf.nlist, index.effective_nprobe
    report["host_mirror_filled"] = index._store._host_cache is not None
    report["sweep"] = []
    for rate in rates:
        window = run.drive(index, batcher, cfg, {**mix, "rate": rate, "check_share": 0.0}, seed, sweep_seconds,
                           False, paths, torch)
        counts = run.tally(window, sweep_seconds)
        p50, p95 = p50_p95(counts.latencies_ms)
        line = {"rate": rate, "p50_ms": p50, "p95_ms": p95, "attempted": counts.attempted, "failed": counts.failed,
                "completed": counts.completed, "late_ms_mean": float(np.mean(window.late) * 1e3)}
        report["sweep"].append(line)
        print(json.dumps(line), flush=True)
    window = run.drive(index, batcher, cfg, mix, seed, seconds, False, paths, torch)
    counts = run.tally(window, seconds)
    rows, _readback, ids, dists = run.samples(window, k, dim)
    report["window"] = {"attempted": counts.attempted, "failed": counts.failed, "checked": int(len(rows)),
                        "p50_ms": p50_p95(counts.latencies_ms)[0]}
    state = {"centroids": np.array(ivf.centroids), "perm": np.array(ivf.perm), "capacity": int(ivf.capacity),
             "nprobe": int(index.effective_nprobe)}
    batcher.close()
    del index, batcher, ivf
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    corpus_rows = corpus.make_rows(cfg, seed, device, digest[1])
    report["regen_mismatch"] = corpus.checksum(corpus_rows) != digest[0]
    report["compare"] = compare(corpus_rows, rows, ids, dists, state, k)
    report["host_peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    report["wall_s"] = time.perf_counter() - t0
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="ivf-5m.image.r65")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--sweep", default="", help="comma-separated rates in req/s")
    parser.add_argument("--sweep-seconds", type=float, default=8.0)
    parser.add_argument("--seconds", type=float, default=51.0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    run.set_cache_env(manifest.ROOT)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    report = check(args.workload, args.seed, [float(r) for r in args.sweep.split(",") if r], args.sweep_seconds,
                   args.seconds, torch.device("cuda", 0))
    text = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

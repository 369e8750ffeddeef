"""Readings for the limits of a cell's comparison: the program's and the
control's, on the chip, at the cell's own size and load.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 --seconds 20

For each seed, in one process: the cell's library and service are built
as a run builds them, the cell's traffic runs for ``--seconds`` and its
sampled answers are judged (the program's readings); then the control,
the plain reference put in the program's place in the next lower
precision (the configuration's ``control`` block), answers the same
sampled queries and is judged the same way (the control's readings), and
so is each of the configuration's ``faults`` (a reference-side fault of
the timed path, for a number the control leaves unread).
One JSON line a seed, then the highest program reading and the lowest
control reading of each number.  A limit lies between the two
(``PERF.md`` gives the readings and the limits).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys


from portbench import corpus, manifest, reference, run


def readings(workload: str, seeds, seconds: float, *, device=None, overrides=None, root=manifest.ROOT,
             log=print):
    """``[{"seed", "program": numbers, "control": numbers}]`` for ``seeds``."""
    import torch

    from photo_search_engine_tpu_torch.device import resolve_device

    book = manifest.load(root)
    cell = manifest.cell(book, workload)
    cfg = {**manifest.config(book, cell["config"], root), **(overrides or {})}
    mix = manifest.traffic(cell["traffic"], root)
    dev = resolve_device("cpu" if device == "cpu" else "gpu")
    k, n, dim = int(mix["k"]), int(cfg["rows"]), int(cfg["dim"])
    paths = corpus.library_paths(n)
    metas = corpus.metadata(paths)
    out = []
    for seed in seeds:
        index, batcher, digest = run.build(cfg, seed, dev, metas)
        window = run.drive(index, batcher, cfg, mix, seed, seconds, False, paths, torch, root)
        rows, readback, ids, dists = run.samples(window, k, dim)
        failed = run.tally(window, seconds).failed
        batcher.close()
        del index, batcher
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        program = run.reference_numbers(cfg, seed, dev, digest, rows, readback, ids, dists, k, root)
        corpus_rows = corpus.make_rows(cfg, seed, dev, digest[1])
        true_rows = corpus_rows[torch.from_numpy(rows).to(dev)].float().cpu().numpy()
        line = {"seed": seed, "checked": int(len(rows)), "failed": failed, "program": program,
                "control": judged(cfg, cfg["control"], corpus_rows, rows, true_rows, k, root)}
        for fault in cfg.get("faults", []):
            line.setdefault("faults", []).append(
                {"what": fault["what"], "readings": judged(cfg, fault, corpus_rows, rows, true_rows, k, root)})
        del corpus_rows
        log(json.dumps(line))
        out.append(line)
    return out


def judged(cfg, spec, corpus_rows, rows, true_rows, k, root):
    """The reference's numbers for the answers of the kind that ``spec``
    names, put in the program's place for the same sampled requests."""
    queries = reference.normalize_queries(true_rows)
    ids, dists = manifest.judge(spec["kind"], root).answer(spec, corpus_rows, queries, k)
    return reference.judge(cfg["reference"], corpus_rows, rows, true_rows, ids.cpu().numpy(), dists.cpu().numpy(), k,
                           root)


def summary(lines):
    """The highest program reading and the lowest control reading of each number."""
    names = lines[0]["control"].keys()
    return {
        name: {"program_max": max(line["program"][name] for line in lines),
               "control_min": min(line["control"][name] for line in lines)}
        for name in names
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    run.set_cache_env(manifest.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("the control readings are taken on the card", file=sys.stderr)
        return 2
    lines = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds,
                     log=lambda s: print(s, flush=True))
    print(json.dumps({"workload": args.workload, "summary": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

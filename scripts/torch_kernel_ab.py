#!/usr/bin/env python3
"""The scan kernels of one checkout of the PyTorch port, timed on one
CUDA card, for comparing two checkouts on the same card in one run.

Kernels 1, 3 (flat and grouped), 4 and 5 (bf16, block_n 1024) and
kernels 2 and 6 (int8 shadow, block_n 2048) at 1M x 1536 unit rows made on
the card from a seed, top-50, batches 1, 8, 128 and 256; the grouped
kernels over five predicates keeping 50 / 25 / 5 / 0.1 / 0 % of the rows;
kernels 1, 2 and 3 also at k = 1; kernel 4 at the checkout's default
blocks per range; phase B (``merge_partials`` of kernel 1's partials;
where the checkout has both, its sorted and packed total-order top-k at
1 to 256 rows of them).
Then kernels 1, 3, 4 and 5 on float32 rows (the same rows widened: the
checkout's f32 loop) at the same batches, and kernel 7 on a float32
layout.  Then kernel 7 (the IVF scan) at the checkout's default
geometry on a cluster-major layout of 1024 clusters x 1536 slots x 1536
(unit rows, each cluster filled to a seeded 768-1536 slots, the rest
padding) and its int8 shadow, each query probing 64 seeded clusters,
top-50 (int8: the 64 the int8 tier nominates), at the same batches;
kernel 7 followed by merge_partials and the download, host to host; and
``IVFIndex.search`` top-50 at nprobe 64, host to host, on an index made
from that layout and 1024 seeded unit centroids (STORE_QUANTIZED off: bf16
kernel 7 and the merge; on: int8 kernel 7 and the exact rescore).  Times
are CUDA events over 10 calls after one warm-up, host to host the host
clock over 10 calls.  Prints one JSON line with the card's name and power
limit and the checkout it timed.

Run from the repository root; ``--root`` names the directory that holds
the ``photo_search_engine_tpu_torch`` package to time (default: this
checkout), for example an unpacked ``git archive`` of the parent commit:

    python3 scripts/torch_kernel_ab.py --root /path/to/parent
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROWS, DIM, K, SEED = 1_000_000, 1536, 50, 20261016
NLIST, LROWS, NPROBE = 1024, 1536, 64  # kernel 7's layout: the ivf phase's IVF_NLIST, L and IVF_NPROBE
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO, help="directory holding the photo_search_engine_tpu_torch to time")
    parser.add_argument("--batches", default="1,8,128,256")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from photo_search_engine_tpu_torch.ops import grouped_mask as go
    from photo_search_engine_tpu_torch.ops import ivf_scan as io
    from photo_search_engine_tpu_torch.ops import quantized as qo
    from photo_search_engine_tpu_torch.ops import topk as to

    if not to.__file__.startswith(root):
        raise RuntimeError(f"imported {to.__file__}, not the checkout under {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def unit(n, gen):
        x = torch.randn((n, DIM), generator=gen, device="cuda")
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    corpus = torch.empty((ROWS, DIM), dtype=torch.bfloat16, device="cuda")
    for start in range(0, ROWS, 131072):
        corpus[start:start + 131072] = unit(min(131072, ROWS - start), gen).to(torch.bfloat16)
    c8, cs = qo.quantize_rows(corpus)
    table = torch.stack([torch.rand(ROWS, generator=gen, device="cuda") < f
                         for f in (0.5, 0.25, 0.05, 0.001, 0.0)]).to(torch.int8)
    times = {}
    for batch in (int(b) for b in args.batches.split(",")):
        queries = unit(batch, gen)
        q16 = queries.to(torch.bfloat16)
        q8, qs = qo.quantize_rows(queries)
        ids = (torch.arange(batch, device="cuda") % table.shape[0]).to(torch.int32)
        runs = {
            "block_topk": lambda k: to.block_topk(corpus, q16, k, count=ROWS, block_n=1024),
            "grouped_block_topk": lambda k: go.grouped_block_topk(corpus, q16, table, ids, k, count=ROWS,
                                                                  block_n=1024),
            "int8_block_topk": lambda k: qo.int8_block_topk(c8, cs, q8, qs, k, count=ROWS, block_n=2048),
            "int8_grouped_block_topk": lambda k: qo.int8_grouped_block_topk(c8, cs, q8, qs, table, ids, k,
                                                                            count=ROWS, block_n=2048),
            "fast_block_topk": lambda k: to.fast_block_topk(corpus, q16, k, count=ROWS, block_n=1024),
            "fast_grouped_block_topk": lambda k: go.fast_grouped_block_topk(corpus, q16, table, ids, k,
                                                                            count=ROWS, block_n=1024),
            "fused_topk": lambda k: to.fused_topk(corpus, q16, k, count=ROWS, block_n=1024),
        }
        for name, run in runs.items():
            times[f"{name} batch {batch}"] = ms(lambda: run(K))
            if name in ("block_topk", "int8_block_topk", "fast_block_topk"):
                times[f"{name} batch {batch} k=1"] = ms(lambda: run(1))
        partials = runs["block_topk"](K)
        times[f"merge_partials batch {batch}"] = ms(lambda: to.merge_partials(*partials, K))
    if hasattr(to, "_packed_total_order_topk"):  # phase B's two total-order top-ks, by rows of partials
        part = to.block_topk(corpus, unit(256, gen).to(torch.bfloat16), K, count=ROWS, block_n=1024)[0]
        for rows in (1, 8, 16, 32, 64, 128, 256):
            flat = part[:rows].reshape(rows, -1)
            times[f"total_order sort rows {rows}"] = ms(lambda: to._sorted_total_order_topk(flat, K))
            times[f"total_order packed rows {rows}"] = ms(lambda: to._packed_total_order_topk(flat, K))
    del c8, cs

    # float32: the same rows widened, kernels 1, 3, 4 and 5 on the checkout's f32 loop
    f32 = torch.empty((ROWS, DIM), device="cuda")
    for start in range(0, ROWS, 131072):
        f32[start:start + 131072] = corpus[start:start + 131072].float()
    del corpus
    for batch in (int(b) for b in args.batches.split(",")):
        queries = unit(batch, gen)
        ids = (torch.arange(batch, device="cuda") % table.shape[0]).to(torch.int32)
        runs = {
            "block_topk": lambda: to.block_topk(f32, queries, K, count=ROWS, block_n=1024),
            "fast_block_topk": lambda: to.fast_block_topk(f32, queries, K, count=ROWS, block_n=1024),
            "fused_topk": lambda: to.fused_topk(f32, queries, K, count=ROWS, block_n=1024),
            "grouped_block_topk": lambda: go.grouped_block_topk(f32, queries, table, ids, K, count=ROWS, block_n=1024),
        }
        for name, run in runs.items():
            times[f"{name} f32 batch {batch}"] = ms(run, reps=3 if batch >= 128 else 10)
    del f32, table

    # kernel 7 on a seeded cluster-major layout
    layout = torch.empty((NLIST * LROWS, DIM), dtype=torch.bfloat16, device="cuda")
    for start in range(0, layout.shape[0], 131072):
        layout[start:start + 131072] = unit(min(131072, layout.shape[0] - start), gen).to(torch.bfloat16)
    fill = torch.randint(LROWS // 2, LROWS + 1, (NLIST,), generator=gen, device="cuda")
    valid = (torch.arange(LROWS, device="cuda")[None, :] < fill[:, None]).to(torch.int8).reshape(-1)
    l8, ls = qo.quantize_rows(layout)

    def host_ms(fn, reps=10):
        fn()
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - start) / reps

    for batch in (int(b) for b in args.batches.split(",")):
        probes = torch.rand((batch, NLIST), generator=gen, device="cuda").argsort(dim=1)[:, :NPROBE]
        probes = torch.sort(probes, dim=1).values.to(torch.int32).contiguous()
        q16 = unit(batch, gen).to(torch.bfloat16)
        q8, qs = io.quantize_ivf_queries(q16.float())
        runs = {"bf16": (lambda: io.ivf_block_topk(layout, q16, probes, valid, K, lrows=LROWS), K),
                "int8": (lambda: io.ivf_block_topk(l8, q8, probes, valid, 64, lrows=LROWS, qscales=qs, cscales=ls), 64)}
        for tier, (run, kk) in runs.items():
            times[f"ivf_block_topk {tier} batch {batch}"] = ms(run)
            times[f"ivf_block_topk {tier} batch {batch} + merge, host to host"] = host_ms(
                lambda: to.merge_partials(*run(), kk)[1].cpu())
    del l8, ls
    f32 = torch.empty(layout.shape, device="cuda")
    for start in range(0, layout.shape[0], 131072):
        f32[start:start + 131072] = layout[start:start + 131072].float()
    for batch in (int(b) for b in args.batches.split(",")):
        probes = torch.rand((batch, NLIST), generator=gen, device="cuda").argsort(dim=1)[:, :NPROBE]
        probes = torch.sort(probes, dim=1).values.to(torch.int32).contiguous()
        queries = unit(batch, gen)
        times[f"ivf_block_topk f32 batch {batch}"] = ms(lambda: io.ivf_block_topk(f32, queries, probes, valid, K,
                                                                                 lrows=LROWS))
    del f32

    # the search a user calls, host to host, on an index over that layout
    from photo_search_engine_tpu_torch.models.ivf import IVFIndex

    slots = np.arange(NLIST * LROWS).reshape(NLIST, LROWS)
    perm = np.where(slots % LROWS < fill.cpu().numpy()[:, None], slots, -1).reshape(-1)
    centroids = unit(NLIST, gen).cpu().numpy()
    for tier, quantized in (("bf16", False), ("int8", True)):
        index = IVFIndex(centroids, layout, perm, LROWS, store_dtype="bfloat16", quantized=quantized, device="cuda")
        for batch in (int(b) for b in args.batches.split(",")):
            queries = unit(batch, gen).cpu().numpy()
            times[f"IVFIndex.search {tier} batch {batch}, host to host"] = host_ms(
                lambda: index.search(queries, K, nprobe=NPROBE))
        del index
    print(json.dumps({"card": card, "root": root, "rows": ROWS, "dim": DIM, "top_k": K,
                      "ivf": {"nlist": NLIST, "slots": LROWS, "nprobe": NPROBE},
                      "ms": {key: round(value, 4) for key, value in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

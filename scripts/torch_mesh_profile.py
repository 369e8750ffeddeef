#!/usr/bin/env python3
"""Where a mesh search's time goes: the four-shard MeshEmbeddingStore of
``chip_smoke.py`` phase ``mesh`` against the single-device EmbeddingStore
on the same rows, on one CUDA card.

1M x 1536 bf16 unit rows made on the card from a seed (metric ip: unit
rows), an int8 shadow, four shards of the card; top-50 at batches 1, 8 and
128 through ``search(impl="auto")`` (kernel 1), ``search(impl="int8")``
(kernel 2) and ``grouped_search`` over five predicates keeping 50 / 25 /
5 / 0.1 / 0 % of the rows (kernel 5).  For each: the host-to-host ms per
call (host clock over 10 calls after a warm-up, single and mesh in turns),
and one ``torch.profiler`` window of 5 calls: the device time per call
(the sum of the CUDA kernels' self time), the share of the wall time in
which no kernel ran (idle share, kernels assumed not to overlap: one
stream), the five kernels with the most device time and the six host
ops with the most self CPU time.  Prints the
card's name and power limit, one line per case, and a JSON line.

Run from the repository root:  python3 scripts/torch_mesh_profile.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROWS, DIM, K, SEED, SHARDS = 1_000_000, 1536, 50, 20261021, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host_ms(fn, reps=10):
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t) / reps


def _profile(fn, calls=5):
    """(device ms per call, idle share, top kernels, top host ops) over
    ``calls`` calls; an op's host time is its self CPU time per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    host = sorted((e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    return (device_us / 1e3 / calls, 1.0 - device_us / wall_us,
            [(e.key[:60], round(e.self_device_time_total / 1e3 / calls, 4), e.count // calls) for e in top],
            [(e.key[:40], round(e.self_cpu_time_total / 1e3 / calls, 4), e.count // calls) for e in host])


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("torch_mesh_profile: needs a CUDA card", file=sys.stderr)
        return 2
    from photo_search_engine_tpu_torch.core.embedding_store import EmbeddingStore
    from photo_search_engine_tpu_torch.core.mesh_store import MeshEmbeddingStore
    from photo_search_engine_tpu_torch.parallel.sharded import make_mesh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    corpus = torch.empty((ROWS, DIM), dtype=torch.bfloat16, device=dev)
    for start in range(0, ROWS, 131072):
        x = torch.randn((min(ROWS, start + 131072) - start, DIM), generator=gen, device=dev)
        corpus[start : start + x.shape[0]] = (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).to(torch.bfloat16)
    host = np.empty((ROWS, DIM), np.float32)
    for start in range(0, ROWS, 131072):
        host[start : start + 131072] = corpus[start : start + 131072].float().cpu().numpy()
    queries = torch.randn((128, DIM), generator=gen, device=dev)
    queries = (queries / torch.linalg.vector_norm(queries, dim=1, keepdim=True)).cpu().numpy()
    rng = np.random.default_rng(SEED)
    table = np.stack([rng.random(ROWS) < f for f in (0.5, 0.25, 0.05, 0.001, 0.0)]).astype(np.int8)
    single = EmbeddingStore(DIM, device=dev, metric="ip", store_dtype="bfloat16", quantized=True)
    single.load_device_rows(corpus)
    mesh = MeshEmbeddingStore(DIM, metric="ip", store_dtype="bfloat16", quantized=True,
                              mesh=make_mesh(devices=[dev] * SHARDS))
    mesh.append(host)
    del host
    cases = {
        "auto": lambda s, q, ids: s.search(q, K, impl="auto"),
        "int8": lambda s, q, ids: s.search(q, K, impl="int8"),
        "grouped": lambda s, q, ids: s.grouped_search(q, K, table, ids),
    }
    out = []
    for batch in (1, 8, 128):
        q = queries[:batch]
        ids = np.arange(batch, dtype=np.int32) % table.shape[0]
        for name, call in cases.items():
            row = {"batch": batch, "case": name}
            ms = {}
            for who, store in (("single", single), ("mesh", mesh), ("mesh2", mesh), ("single2", single)):
                ms[who] = _host_ms(lambda: call(store, q, ids))
            for who, store in (("single", single), ("mesh", mesh)):
                device_ms, idle, top, host_ops = _profile(lambda: call(store, q, ids))
                row[who] = {"host_ms": round((ms[who] + ms[who + "2"]) / 2, 4), "device_ms": round(device_ms, 4),
                            "idle_share": round(idle, 4), "top_kernels": top, "top_host_ops": host_ops}
            print(f"batch {batch} {name}: " + "; ".join(
                f"{who} host {row[who]['host_ms']:.3f} ms, device {row[who]['device_ms']:.3f} ms, idle "
                f"{row[who]['idle_share']:.2f}, top {row[who]['top_kernels'][:3]}, host ops "
                f"{row[who]['top_host_ops'][:4]}" for who in ("single", "mesh")),
                flush=True)
            out.append(row)
    print(json.dumps({"device": smi, "rows": ROWS, "dim": DIM, "shards": SHARDS, "k": K, "cases": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

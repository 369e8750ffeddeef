"""Headline benchmark of the PyTorch port: search throughput at the
north-star scale (1M × 1536-d unit rows, top-10, batch 256) on one CUDA
card.  The port of ``bench.py``, with its knobs and its output line.

Prints ONE JSON line last:
  {"metric": ..., "value": N, "unit": "qps", "vs_baseline": N}

``value`` is queries per second of the variant's search call.
``vs_baseline`` is ``value`` over the QPS of the nearest library
composition of the same work on the same card in the same run, printed on
an earlier ``# search`` line: a cuBLAS product and ``torch.topk``
(``torch._int_mm`` and the scales for int8; for ivf the probe, the
probed clusters gathered, a batched product and ``torch.topk``).  The
library composition is a yardstick only: the port never calls it.  (The
JAX script divides by a 10k-QPS target set for a TPU v5e-8; that target
is not the port's.)

Methodology: the corpus is made on the card from a seeded
``torch.Generator`` in chunks written into one buffer, l2-normalized in
the store dtype (``resolve_store_dtype("auto")``: bfloat16 on the card);
the queries are a seeded stack of ``BENCH_ITERS + 2`` batches.  After two
warm-up calls, one call runs under
``torch.cuda.set_sync_debug_mode("error")``: a search that synchronises
with the host is reported on a ``# host sync`` line (and timed all the
same).  Then CUDA events time ``BENCH_ITERS`` back-to-back calls, each on
its own batch of the stack.  ``PSE_PLATFORM=cpu`` runs on the host, timed
by the host clock (a ``# device: cpu`` line says so; not a device time).

Scale knobs via env: BENCH_ROWS, BENCH_DIM, BENCH_Q, BENCH_K, BENCH_ITERS.
Variant via BENCH_IMPL (or the BENCH_EXACT=1 / BENCH_FAST=1 / BENCH_INT8=1
aliases):
  exact - ``ops.topk.exact_search(impl="auto")``: kernel 1 and the merge
  fast  - ``impl="pallas_fast"``: kernel 3 and the exact rescore
  int8  - ``ops.quantized.quantize_rows`` in chunks, then ``int8_search``:
          kernel 2 and ``rescore_pool``
  ivf   - ``IVFIndex.build_on_device`` and ``device_search_fn(k, nprobe,
          Q)``: the probe and kernel 7 (batch 8 unless BENCH_Q is set,
          BENCH_IVF_NPROBE=16, BENCH_IVF_NLIST=1024, BENCH_IVF_QUANTIZED=1
          for the int8 layout)
The default follows the port's serving default: int8 when
``resolve_store_quantized("auto")`` is true, else exact.

Not carried over from ``bench.py`` (TPU-only workarounds): the
backend-acquisition watchdog, the XLA compile cache, the chained
``lax.scan`` timing (CUDA events replace it), the padding of BENCH_Q to
the Pallas query block and the BENCH_DIM % 128 rule of the Pallas grid,
and the capacity padding to the kernels' blocks.  Without a card (and
without ``PSE_PLATFORM=cpu``) it prints the JAX script's
``backend_unavailable`` line and exits 1; it never falls back to the CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = ("exact", "fast", "int8", "ivf")
_TRUE = {"1", "true", "yes"}
_CHUNK = 131072  # rows per corpus / quantization step
HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline")  # the JSON line's keys, as bench.py prints them
SYNC_ERROR = "called a synchronizing CUDA operation"  # torch's error under set_sync_debug_mode("error")


def settings(env=None) -> dict:
    """The knobs of ``env`` (default ``os.environ``), with bench.py's defaults."""
    from photo_search_engine_tpu_torch.ops.quantized import resolve_store_quantized

    env = os.environ if env is None else env
    variant = env.get("BENCH_IMPL", "").strip().lower()
    if not variant:
        if env.get("BENCH_INT8", "") in _TRUE:
            variant = "int8"
        elif env.get("BENCH_FAST", "") in _TRUE:
            variant = "fast"
        elif env.get("BENCH_EXACT", "") in _TRUE:
            variant = "exact"
        else:
            # the serving default (STORE_QUANTIZED=auto)
            variant = "int8" if resolve_store_quantized("auto") else "exact"
    if variant not in VARIANTS:
        raise ValueError(f"BENCH_IMPL must be one of {VARIANTS}, got {variant!r}")
    n_queries = int(env.get("BENCH_Q", 256))
    if variant == "ivf" and "BENCH_Q" not in env:
        n_queries = 8  # IVF is the small-batch/low-latency path
    return {
        "variant": variant,
        "rows": int(env.get("BENCH_ROWS", 1_000_000)),
        "dim": int(env.get("BENCH_DIM", 1536)),
        "n_queries": n_queries,
        "k": int(env.get("BENCH_K", 10)),
        "iters": int(env.get("BENCH_ITERS", 40)),
        "nprobe": int(env.get("BENCH_IVF_NPROBE", 16)),
        "nlist": int(env.get("BENCH_IVF_NLIST", 1024)),
        "ivf_quantized": env.get("BENCH_IVF_QUANTIZED", "") in _TRUE,
    }


def metric_name(s: dict) -> str:
    """bench.py's metric name for these settings."""
    kind = {"ivf": "ivf_int8" if s["ivf_quantized"] else "ivf", "int8": "int8_rescore", "fast": "packedkey",
            "exact": "exact"}[s["variant"]]
    return f"{kind}_search_qps_{s['rows'] // 1000}k_x_{s['dim']}d_top{s['k']}_batch{s['n_queries']}"


def unit_rows(n: int, dim: int, dtype, device, seed: int):
    """``[n, dim]`` l2-normalized rows of ``dtype`` from a seeded generator,
    made in chunks written into one buffer."""
    import torch

    from photo_search_engine_tpu_torch.ops.topk import l2_normalize

    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((n, dim), dtype=dtype, device=device)
    for start in range(0, n, _CHUNK):
        stop = min(n, start + _CHUNK)
        out[start:stop] = l2_normalize(torch.randn((stop - start, dim), generator=gen, device=device, dtype=dtype))
    return out


def quantize_chunks(corpus):
    """``quantize_rows`` of ``corpus`` chunk by chunk into one int8 buffer."""
    import torch

    from photo_search_engine_tpu_torch.ops.quantized import quantize_rows

    corpus_i8 = torch.empty(corpus.shape, dtype=torch.int8, device=corpus.device)
    scales = torch.empty(corpus.shape[0], dtype=torch.float32, device=corpus.device)
    for start in range(0, corpus.shape[0], _CHUNK):
        q, s = quantize_rows(corpus[start : start + _CHUNK])
        corpus_i8[start : start + q.shape[0]] = q
        scales[start : start + q.shape[0]] = s
    return corpus_i8, scales


def make_search(s: dict, corpus):
    """``(search, library, label)`` for the variant of ``s`` over
    ``corpus``: ``search(queries, k=s["k"]) -> (values, ids)`` is the timed
    call (another ``k`` gives the same search at that depth);
    ``library(queries)`` the library composition of the same work, named
    by ``label``.  For ivf the ids are layout slots (``IVFIndex.perm``
    maps them to rows) and ``search.index`` is the index."""
    import torch

    from photo_search_engine_tpu_torch.models.ivf import IVFIndex
    from photo_search_engine_tpu_torch.ops import ivf_scan
    from photo_search_engine_tpu_torch.ops.quantized import int8_search, quantize_rows
    from photo_search_engine_tpu_torch.ops.topk import exact_search

    k, variant = s["k"], s["variant"]
    if variant in ("exact", "fast"):
        impl = "auto" if variant == "exact" else "pallas_fast"

        def search(q, k=k):
            return exact_search(corpus, q, k, metric="ip", impl=impl)

        def library(q):
            return torch.topk(torch.matmul(q.to(corpus.dtype), corpus.T), k)

        return search, library, "cuBLAS product + torch.topk"
    if variant == "int8":
        corpus_i8, scales = quantize_chunks(corpus)

        def search(q, k=k):
            return int8_search(corpus_i8, scales, corpus, q, k, count=corpus.shape[0])

        def library(q):
            q8, qs = quantize_rows(q)
            # cuBLAS's int8 product wants more than 16 rows: pad the queries
            qpad = torch.zeros((max(32, -(-q.shape[0] // 8) * 8), q8.shape[1]), dtype=torch.int8, device=q.device)
            qpad[: q.shape[0]] = q8
            acc = torch._int_mm(qpad, corpus_i8.T)[: q.shape[0]]
            return torch.topk(acc.float() * qs[:, None] * scales[None, :], k)

        return search, library, "torch._int_mm + scales + torch.topk"
    index = IVFIndex.build_on_device(corpus, nlist=s["nlist"], quantized=s["ivf_quantized"])
    bench_fn = index.device_search_fn(k, s["nprobe"], s["n_queries"])

    def search(q, k=k):
        return (bench_fn if k == s["k"] else index.device_search_fn(k, s["nprobe"], s["n_queries"]))(q)

    search.index = index
    nprobe = max(1, min(s["nprobe"], index.nlist))
    dim = index.dim
    valid = index._row_valid.view(index.nlist, index.capacity)
    if s["ivf_quantized"]:
        layout = index._corpus_i8.view(index.nlist, index.capacity, dim)
        cscales = index._cscales.view(index.nlist, index.capacity)

        def library(q):
            probes = index._probe(q.to(index._corpus.dtype), nprobe).long()
            q8, qs = ivf_scan.quantize_ivf_queries(q.to(index._corpus.dtype).float())
            qpad = torch.zeros((32, dim), dtype=torch.int8, device=q.device)
            out = []
            for i in range(q.shape[0]):  # one query a product: its own probed clusters
                qpad[0] = q8[i]
                acc = torch._int_mm(qpad, layout[probes[i]].reshape(-1, dim).T)[0]
                scores = acc.float() * qs[i] * cscales[probes[i]].reshape(-1)
                out.append(torch.topk(torch.where(valid[probes[i]].reshape(-1) > 0, scores, float("-inf")), k))
            return out

        return search, library, "probe, gather, torch._int_mm a query, scales, torch.topk"
    layout = index._corpus.view(index.nlist, index.capacity, dim)

    def library(q):
        qd = q.to(index._corpus.dtype)
        probes = index._probe(qd, nprobe).long()
        gathered = layout[probes].reshape(q.shape[0], -1, dim)
        scores = torch.bmm(gathered, qd[:, :, None])[..., 0].float()
        return torch.topk(torch.where(valid[probes].reshape(q.shape[0], -1) > 0, scores, float("-inf")), k)

    return search, library, "probe, gather, cuBLAS batched product, torch.topk"


def host_sync(fn, queries):
    """The first line of the error that ``fn(queries)`` raises under
    ``torch.cuda.set_sync_debug_mode("error")`` when it synchronises with
    the host, else None.  Any other error propagates."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(queries)
    except RuntimeError as exc:
        if SYNC_ERROR not in str(exc):
            raise
        return str(exc).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return None


def ms_per_call(fn, qstack, iters: int) -> float:
    """Milliseconds per call of ``fn`` over ``qstack[2:2 + iters]``, back to
    back, after two warm-up calls: CUDA events on the card, the host clock
    on the host."""
    import torch

    on_card = qstack.device.type == "cuda"
    for i in range(2):
        fn(qstack[i])
    if on_card:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(qstack[2 + i])
    if not on_card:
        return 1e3 * (time.perf_counter() - t0) / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def inputs(s: dict, device):
    """``(corpus, qstack)`` of the settings ``s`` on ``device``: the unit
    rows in the store dtype and ``iters + 2`` seeded query batches."""
    import torch

    from photo_search_engine_tpu_torch.ops.topk import l2_normalize, resolve_store_dtype

    dtype = getattr(torch, resolve_store_dtype("auto", device))
    corpus = unit_rows(s["rows"], s["dim"], dtype, device, seed=0)
    q_dtype = torch.float32 if s["variant"] == "int8" else dtype
    gen = torch.Generator(device=device).manual_seed(99)
    qstack = l2_normalize(torch.randn((s["iters"] + 2, s["n_queries"], s["dim"]), generator=gen, device=device,
                                      dtype=q_dtype))
    return corpus, qstack


def measure(s: dict, search, library, label: str, qstack) -> dict:
    """Check one call of ``search`` for host syncs (on the card), time it
    and its library composition.  Returns the JSON line's fields and what
    the earlier lines print."""
    sync = host_sync(search, qstack[0]) if qstack.device.type == "cuda" else None
    ms = ms_per_call(search, qstack, s["iters"])
    lib_ms = ms_per_call(library, qstack, s["iters"])
    qps, lib_qps = s["n_queries"] / (ms / 1e3), s["n_queries"] / (lib_ms / 1e3)
    return {"metric": metric_name(s), "value": round(qps, 1), "unit": "qps", "vs_baseline": round(qps / lib_qps, 3),
            "ms": ms, "library_ms": lib_ms, "library_qps": lib_qps, "library": label, "host_sync": sync}


def run(s: dict, device) -> dict:
    """Build the corpus and the variant's search on ``device`` and measure
    them (:func:`measure`)."""
    corpus, qstack = inputs(s, device)
    search, library, label = make_search(s, corpus)
    return measure(s, search, library, label, qstack)


def report(out: dict) -> list:
    """The lines that follow the device line: a ``# host sync`` line when
    the timed call synchronised, the ``# search`` line with the library
    composition's time and QPS, and the JSON line last."""
    lines = [f"# host sync in the timed call (timed all the same): {out['host_sync']}"] if out["host_sync"] else []
    lines.append(f"# search {out['ms']:.4f} ms a batch; library ({out['library']}) {out['library_ms']:.4f} ms a "
                 f"batch, {out['library_qps']:.1f} qps")
    lines.append(json.dumps({key: out[key] for key in HEADLINE_KEYS}))
    return lines


def main() -> int:
    import torch

    from photo_search_engine_tpu_torch.device import resolve_device

    try:
        device = resolve_device()
    except RuntimeError as exc:
        print(json.dumps({"metric": "backend_unavailable", "value": 0, "unit": "qps", "vs_baseline": 0,
                          "error": str(exc)}), flush=True)
        return 1
    s = settings()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (host clock; not a device time)"
    print(f"# device: {name}; {s}", flush=True)
    for line in report(run(s, device)):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

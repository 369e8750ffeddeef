#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one CUDA card.

Phases; each prints its results on lines of its own and raises on failure:

1. device  - the card's name and power limit; build the CUDA kernels from
             photo_search_engine_tpu_torch/csrc with nvcc; the registers
             and spills of the tensor-core kernels (bf16 kernels 1, 3 and
             5, kernel 1 also for kernel 4's ranges; int8 kernels 2 and 6;
             bf16 and int8 kernel 7) and their HGMMA (bf16 wgmma),
             IGMMA (int8 wgmma) and UTMALDG (TMA) counts in the SASS, which
             must not be 0; and of the f32 ring's kernels (float32 kernels
             1, 3, 3 grouped, 5 and 7 at BQ 8 and 32): FFMA and UTMALDG
             above 0, no HGMMA.
2. kernels - kernel 1 (block_topk) and kernel 2 (int8_block_topk) against
             their plain PyTorch versions on the card: ip, l2, masked with
             a live count, float32 and bfloat16, k in {1, 10, 50, 64}, and a
             block of duplicate rows whose ties must go to the smallest row;
             then kernel 5 (grouped_block_topk) and kernel 6
             (int8_grouped_block_topk), a predicate per query, for M in
             {1, 3, 8} and Q in {1, 9, 33, 128}, with an empty predicate,
             ids outside [0, M) and duplicate rows; then the bfloat16
             kernels 1 and 5 across their query tiles (Q 1/8/9/32/33/128/
             256), D 1536 and 1000 on the tensor cores and 1001 on the FMA
             loop (each launch checked on its loop), k 1/50/64, and an
             all-masked block; then the float32 kernels 1, 3, 4 and 5 the
             same way, D 1536 and 1000 on the f32 ring and 1001 and 1002 on
             the FMA loop, k 1/10/50/64, each on the ring bit for bit the
             FMA loop's on the same inputs; then the int8 kernels 2 and 6
             the same way, identical to their plain versions: D 1536 and 1008 on the
             tensor cores and 1000 on the __dp4a loop, ip, l2 and masked, an
             all-masked block and duplicate rows; then kernel 7
             (ivf_block_topk, the IVF probed-cluster scan) on float32,
             bfloat16 and int8 layouts, ip and l2, k in {1, 10, 50, 64}
             (and 500 on the float layouts), Q in {1, 9, 33, 128}, nprobe
             in {1, 8, 64}, bf16 and int8 on the tensor cores and f32 on its
             ring at k <= 64 (each f32 result also bit for bit the FMA
             loop's at the same tile), k 500 on the FMA / __dp4a loop (each
             launch checked on its loop), with padding slots, a slot mask, a query
             whose probed clusters are all masked out, duplicate rows,
             probe ids outside the layout, and one call of each loop under
             torch.cuda.set_sync_debug_mode("error"); f32 kernel 7 launched
             200 times at each of the tiles of 367 and 1100 slots and
             groups of 8 and 32, every launch bit for bit the FMA loop's;
             then
             kernel 3 (fast_block_topk, the packed-key scan, and
             fast_grouped_block_topk, through kernel 5's body) and kernel 4
             (fused_topk, the fused running top-k): the searches through
             them against the same searches on their plain versions, with
             an empty predicate or mask, a live count below n and k = 64,
             each launch on its loop (bf16 the tensor cores, f32 its ring);
             kernel 3's bf16 and f32 partials bit for bit against the plain
             version's on exact products, flat and grouped, a last block
             shorter than k included; kernel 4's range partials and result
             bit for bit against kernel 1's partials merged by range and
             by merge_partials.
3. app     - the entry point (python -m photo_search_engine_tpu_torch.api.app,
             micro-batcher on, its default) as a subprocess on a PIL photo
             library; then the same app in this process without a keyword
             index, with STORE_QUANTIZED=0 and =1, answering a text, a
             season, a season-with-text (the grouped scan), an image and an
             upload search.
f32        - STORE_DTYPE=float32 (phase f32, run after scale): a 1M x 1536
             float32 corpus made on the card from a seed, served by the
             app's wiring with the micro-batcher on: 32 concurrent
             /search_by_image (kernel 1), 64 concurrent filtered searches
             over five predicates (kernel 5), the store's impl routes
             (kernels 3, 4 and grouped 3), every launch on the f32 ring (the
             TMA ring with fmaf consumers), results against plain searches;
             each f32 kernel's time against its plain version, bound and
             library (cuBLAS float32, TF32 off, + torch.topk) at batches 1,
             8, 128 and 256 and store.search host to host; then a float32
             IVF (nlist 1024, nprobe 64, intrinsic-32 rows): its build, and
             kernel 7 on the f32 ring against its plain version and timed.
4. scale   - a 1M x 1536 bfloat16 corpus with an int8 shadow and seeded
             season metadata, made on the card from a seed, installed in a
             VectorIndex and served by the app's own wiring
             (initialize_services, create_app) with the micro-batcher on:
             concurrent image searches (kernels 1 and 2), concurrent
             filtered searches over five predicates (kernels 5 and 6)
             checked against plain per-query searches, a season-filtered
             /search_photos, the batcher's counters (kernels 1, 2, 5 and 6
             must have run on the tensor cores only); then the store's own
             impl routes: search(impl="pallas_fast") (kernel 3) and
             search(impl="pallas_fused") (kernel 4) at batch 1 and 128,
             top-50, and grouped_search(impl="pallas_fast") (grouped kernel 3)
             at batch 128 with M = 5, on the tensor cores, kernel 4's
             results identical to kernel 1's and kernel 3's checked against
             its plain version; and every kernel's time against its plain
             version (CUDA events, after warm-up), its bound and the time of
             the nearest library composition, at batch 1, 8, 128 and 256
             (kernels 1-6), with kernels 1, 2 and 3
             at k = 1 against k = 50 (every timed launch of 1-6 on the
             tensor cores); merge_partials and rescore_pool timed apart; store.search host to host through impl auto (bf16) and
             int8 and the impl routes; the int8 tier's recall@10 and @50
             against the exact scan.
5. ivf     - VECTOR_INDEX_TYPE=ivf at 1M x 1536: bfloat16 rows of intrinsic
             dimension 32 made on the card from a seed, served by the app's
             wiring with IVF_NLIST=1024, IVF_NPROBE=64 and the micro-batcher
             on, with STORE_QUANTIZED=0 and =1: the first routed search
             builds the IVF (its seconds printed), 32 concurrent image
             searches and an unfiltered /search_photos (k up to 500) reach
             kernel 7 through the routes, a masked search_batch takes the
             ivf_masked route; each result is held against the same search
             with kernel 7's plain version under the same probes; recall@10
             against the flat exact scan (kernel 1); the routes must have run
             kernel 7 on the tensor cores; kernel 7's times against its
             plain version and the library composition (gathered probed
             clusters, cuBLAS or torch._int_mm, torch.topk; chunked above
             batch 1) at batch 1, 8, 128 and 256, top-50, with its tile and
             group size, its groups, its launches and their loop; IVFIndex.search
             host to host at batch 1 and 128.

6. online  - the online profile: a local stand-in for an OpenAI-compatible
             server on 127.0.0.1 in a thread (/v1/embeddings: a unit vector
             per input from a seeded hash of its words; /v1/rerank and
             /v1/chat/completions: rankings by a seeded rule; calls and
             inputs counted), and the app served through
             initialize_services / create_app with EMBEDDING_BASE_URL,
             TEXT_RERANK_BASE_URL and VISUAL_RERANK_* at the stand-in and
             the micro-batcher on.  The PIL photo library of phase 3 is
             indexed through the real Indexer with the stand-in's
             embeddings; a text search with the API text rerank and the
             visual rerank, one with the chat text rerank, an image and an
             upload search with the visual rerank each report the reranks
             they ran.  Then phase 4's corpus: 32 concurrent
             /search_by_image (kernel 1, then kernel 2 with the int8 tier),
             64 concurrent season-filtered searches whose query vectors come
             from the stand-in through the batched embedder (kernels 5 and
             6), each held against the plain scan of the stand-in's vector,
             and 32 concurrent /search_photos whose query embeds must reach
             the stand-in as coalesced list calls (mean batch above 1); route
             p50/p99 ms and wall seconds (the stand-in answers in
             microseconds: these time the port's host path and the card).
7. tools   - tools.migrate on a fake FAISS flat binary of 8192 x 1536 unit
             rows (bursts of 16 shots), then recall_eval.evaluate on the
             result: exact recall@10 1.0 (kernel 1), every masked check
             right, the int8 (kernel 2) and IVF (kernel 7) recall printed;
             recall_eval.evaluate_synthetic at 1M x 1536, intrinsic 32,
             nlist 1024, sweeping nprobe 16/32/64 at batch 1/8/128 through
             IVFIndex.device_search_fn (kernel 7, CUDA events); and one call
             of device_search_fn per tier (bf16, int8) under
             torch.cuda.set_sync_debug_mode("error"), equal to
             IVFIndex.search.  The tools find the card as their default
             device: PSE_PLATFORM must be unset.
8. mesh    - the mesh tier: (a) a MeshEmbeddingStore over four shards of
             the card (make_mesh(devices=[cuda:0] * 4)) at 1M x 1536 bf16
             unit rows from a seed, with the int8 shadow: search(impl=
             "auto") (kernel 1), search(impl="int8") (kernel 2) and
             grouped_search over five predicates keeping 50 / 25 / 5 /
             0.1 / 0 % (kernel 5, then kernel 6) at batches 1, 8 and 128,
             top-50, each call launching its kernel once per shard, held
             against the single-device EmbeddingStore on the same rows and
             against the same search on the kernels' plain versions, host
             to host ms beside the single store's; (b) a ShardedIVFIndex
             on the same four shards (intrinsic-32 rows, nlist 1024,
             nprobe 64): build seconds, kernel 7 once per shard per search
             against its plain version under the same probes, recall@10
             against the exact mesh scan; (c) the app with MESH_DEVICES=-1
             (one card: the degenerate mesh of 1), flat and ivf, image,
             text and season-filtered searches (the grouped scan), then a
             restart that loads the saved mesh index and its IVF sidecar;
             (d) two ranks on the card(s): the sharded search with each
             rank uploading only its rows (a numpy oracle), and two app
             instances joined through DIST_* (rank 0 over HTTP, rank 1's
             replays); gloo when the ranks share a card (NCCL refuses
             that), NCCL with a card per rank.
9. entry   - the entry points that run and measure the port, at the card's
             default (PSE_PLATFORM unset): (a) scripts/torch_bench.py's
             inputs, searches and measurement at its default 1M x 1536
             for exact (kernel 1), fast (kernel 3), int8 (kernel 2), ivf
             and ivf with BENCH_IVF_QUANTIZED=1 (kernel 7, bf16 and int8):
             one batch of each search against its kernel's plain version
             at the bench's shapes, then each JSON line beside the library
             composition's QPS, each kernel on the tensor cores, no host
             sync in the timed call; then the bench's command line once at
             its default variant; (b) scripts/torch_load_test.py at 1M x
             1536 with 16 threads, flat, --quantized and --index-type ivf,
             --requests cut to 1024 a mode: each JSON line with 0 errors,
             the flat modes' launches printed (none expected: candidate_k
             500 > 64 takes the plain scan, so no kernel is compared
             there), kernel 7 launched by the ivf mode and its first
             measured query answered the same with kernel 7 on its plain
             version; (c) graft_entry.entry() (kernel
             1 on the f32 ring, bit for bit the FMA loop's, against the plain
             scan) and graft_entry.dryrun_multichip(4), four shards on
             cuda:0 (kernels 1, 2, 5 and 7); (d) scripts/torch_check_services.py
             (backend cuda, the card's name) and scripts/torch_demo_e2e.py
             (every mode answered) as subprocesses.

Launches are the kernel wrapper calls on card tensors that the spy of
tests/torch_parity.spy_launches sees outside a CUDA graph's capture (a
call under capture only records into the graph; a replay launches its
kernels without calling a wrapper and is not counted), and the loop a
launch ran on is the loop rule's answer for its inputs
(topk.scoring_loop, quantized.int8_scoring_loop,
ivf_scan.ivf_scoring_loop), checked where a phase expects one; zeroed
before the route runs of phases 3-6 and f32 (and before the store's
impl routes in phase 4, and before the float32 IVF's first search in phase
f32), before phase 7 and before each mesh call of phase 8, before each bench
measurement (after its check against the plain version), each load test and
each graft entry call of phase 9, and read after every client thread has
joined (in phase 8, after the call: it must have launched its kernel once
per shard); a kernel that its path never launched fails the run.  Each phase prints its seconds.  The second-to-last line of output is a JSON object with each
kernel's route, launches, error, times, bound (the larger of its bytes
over 3.35 TB/s and its operations over the peak of their type: 989 TFLOP/s
bf16, 67 TFLOP/s f32, 1,979 TOP/s int8) and library time; the last is
{"ok": true, "device": {...}}.  Without a CUDA card the script exits
non-zero and prints no result.

Run:  python3 chip_smoke.py            (all phases; one card, nvcc on PATH
                                        or under $CUDA_HOME or /usr/local/cuda)
      python3 chip_smoke.py --phases device,kernels
      python3 chip_smoke.py --phases device,f32
      python3 chip_smoke.py --phases device,online,tools
      python3 chip_smoke.py --phases device,mesh
      python3 chip_smoke.py --phases device,entry
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
TOL = 1e-5  # unit vectors at 1536-d: the kernel and the plain product differ in summation order only
SEED = 20261016

_NAMES = ("block_topk", "int8_block_topk", "grouped_block_topk", "int8_grouped_block_topk", "ivf_block_topk",
          "fast_block_topk", "fast_grouped_block_topk", "fused_topk")
_FLAT = _NAMES[:4]
_IMPL_ROUTES = _NAMES[5:]  # driven through the store's impl values in phase 4
_DRIVES = {"app": _FLAT, "scale": _FLAT + _IMPL_ROUTES, "ivf": ("ivf_block_topk",), "online": _FLAT,
           "tools": ("block_topk", "int8_block_topk", "ivf_block_topk"), "mesh": _FLAT + ("ivf_block_topk",),
           "f32": ("block_topk", "grouped_block_topk", "ivf_block_topk") + _IMPL_ROUTES,
           "entry": ("block_topk", "int8_block_topk", "grouped_block_topk", "ivf_block_topk",
                     "fast_block_topk")}  # what each phase must launch
_ERRORS = {name: 0.0 for name in _NAMES}
_LAUNCHES = {name: 0 for name in _NAMES}
_TIMES = {}  # (name, batch, k): (kernel ms, plain ms, bound ms, bound by, library ms)
_IVF_RECALL = {}  # tier: phase 5's recall@10 at nprobe 64, printed beside phase 7's

_SPY = None  # the run's tests.torch_parity.Launches: every kernel wrapper's calls, set in main


def log(line: str) -> None:
    print(line, flush=True)


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------


def check_topk(name, got_v, got_i, ref_v, ref_i, *, exact=False):
    """A top-k (``[..., k]``, descending) against the plain version's
    top-(k+1), whose extra slot is the cut, by the comparison rule the
    CPU tests use (``tests/torch_parity.py``): values within ``TOL``,
    indices equal wherever the plain score of the slot differs from its
    neighbours by more than ``TOL``, empty slots equal; ``exact`` asks for
    identical values and indices.  Returns the largest value error."""
    from tests.torch_parity import assert_topk_match

    k = got_v.shape[-1]
    try:
        return assert_topk_match(got_v, got_i, ref_v[..., :k], ref_i[..., :k], tol=TOL,
                                 cut=ref_v[..., k], exact=exact)
    except AssertionError as exc:
        raise AssertionError(f"{name}: {exc}") from exc


def check_scores(name, got_v, got_i, scores, *, tol=TOL):
    """Every row id a kernel returned has the plain score it reports."""
    import torch

    live = (got_i != torch.iinfo(torch.int32).max) & (got_i >= 0)  # INT_MAX or -1: an empty slot
    q = torch.arange(got_i.shape[0], device=got_i.device).view(-1, *([1] * (got_i.ndim - 1)))
    rows = torch.where(live, got_i, 0).long()
    true = scores[q.expand_as(rows), rows]
    err = torch.where(live, (true - got_v).abs(), torch.zeros_like(got_v))
    if not float(err.max()) <= tol:
        raise AssertionError(f"{name}: a returned row's score differs by {float(err.max()):.3g}")


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def ivf_scan_work(row_valid, nlist: int, lrows: int, probes, row_bytes: int):
    """What kernel 7 must do for these probes: ``(bytes, padded bytes,
    scored rows)``.  The bytes are the live rows of each probed cluster,
    read once, and one ``row_valid`` byte for each of its slots: a slot
    whose flag is 0 (padding, or dropped by a filter) scores -inf whatever
    it holds, so its row need not be read.  The padded bytes count every
    slot's row, the figure of a scan that reads the whole cluster.  The
    scored rows are the live rows summed over the (query, probe) pairs, for
    the operations."""
    import torch

    live = (row_valid.view(nlist, lrows) > 0).sum(dim=1)
    pr = probes.long()
    pr = pr[(pr >= 0) & (pr < nlist)]
    probed = torch.unique(pr)
    flags = probed.numel() * lrows
    return (int(live[probed].sum()) * row_bytes + flags, flags * row_bytes + flags, int(live[pr].sum()))


def bound_ms(moved_bytes: float, ops: float, unit: str):
    """The least time the card could take (``portbench.peaks.least_seconds``),
    and whether the bytes or the operations set it."""
    from portbench.peaks import HBM_BYTES_PER_S, PEAK_OPS_PER_S, least_seconds

    by_bytes = moved_bytes / HBM_BYTES_PER_S >= ops / PEAK_OPS_PER_S[unit]
    return 1e3 * least_seconds(moved_bytes, ops, unit), "bytes" if by_bytes else "operations"


def time_kernel(key, kernel, plain, library, moved_bytes, ops, unit, reps=3):
    """Kernel and plain times in turns (plain, kernel, kernel, plain), the
    library composition's time (None where there is none), and the bound;
    recorded under ``key`` and returned."""
    plain_ms = cuda_ms(plain, reps=2)
    kernel_ms = cuda_ms(kernel, reps=reps)
    kernel_ms2 = cuda_ms(kernel, reps=reps)
    plain_ms2 = cuda_ms(plain, reps=2)
    lib_ms = None
    if library is not None:
        try:  # a yardstick only: one the card refuses is reported as none
            lib_ms = cuda_ms(library, reps=2)
        except RuntimeError as exc:
            log(f"[time] {key}: the library composition failed ({str(exc).splitlines()[0][:200]})")
    bound, by = bound_ms(moved_bytes, ops, unit)
    _TIMES[key] = ((kernel_ms + kernel_ms2) / 2, (plain_ms + plain_ms2) / 2, bound, by, lib_ms)
    return _TIMES[key] + ((kernel_ms, kernel_ms2, plain_ms, plain_ms2),)


def reset_launches() -> None:
    _SPY.reset()


def read_launches() -> dict:
    """Each kernel's launches since :func:`reset_launches`: the calls of its
    wrapper on card tensors outside a graph's capture (a replay calls none)."""
    return _SPY.launches()


def close_batchers(services) -> None:
    """Stop the micro-batcher and the batched embedder that
    ``initialize_services`` started (their worker threads)."""
    index = services["vector_index"]
    if hasattr(index, "_microbatcher"):
        index._microbatcher.close()
        services["searcher"].embedding_service._batcher.close()


def run_threads(target, args_list, timeout=600):
    """Run ``target`` once per argument tuple, all at once; join them all."""
    import threading

    errors = []

    def guarded(*args):
        try:
            target(*args)
        except BaseException as exc:  # noqa: BLE001 -- re-raised below, after every join
            errors.append(exc)

    threads = [threading.Thread(target=guarded, args=args) for args in args_list]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"client threads still running after {timeout} s")
    if errors:
        raise errors[0]


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------


def phase_device() -> None:
    import torch

    from photo_search_engine_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    log(smi.stdout.strip().splitlines()[0])  # the card's name and power limit, as nvidia-smi gives them
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    info = _cuda.build_info()
    log(f"[device] kernels built in {info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        if any(word in line for word in ("entry function", "registers", "spill", "error", "warning",
                                         "Performance")):
            log(f"[device] ptxas: {line.strip()}")
    # the tensor-core kernels (bf16 kernels 1, 3 and 5, whose kernel 1 also
    # scans kernel 4's ranges; int8 kernels 2 and 6): registers, spills, and
    # wgmma (HGMMA bf16, IGMMA int8) and TMA (UTMALDG) instructions in their
    # SASS
    ptxas = _ptxas_by_function(info["log"])
    sass = _cuda.sass_counts(TC_KERNEL)
    sass8 = _cuda.sass_counts(TC_INT8_KERNEL)
    sass7 = _cuda.sass_counts(TC_IVF_KERNEL)
    for name, ops in sorted({**sass, **sass8, **sass7}.items(), key=lambda item: _tc_label(item[0])):
        regs, stores, loads = ptxas.get(name, ("?", "?", "?"))
        log(f"[device] {_tc_label(name)}: {regs} registers, {stores}/{loads} bytes spill stores/loads; "
            f"SASS {ops['HGMMA']} HGMMA, {ops['IGMMA']} IGMMA, {ops['UTMALDG']} UTMALDG")
    labels = {_tc_label(name) for name in sass}
    for kernel in ("kernel 1", "kernel 3", "kernel 3 grouped", "kernel 5"):
        for bq in (8, 32):
            if not any(label.startswith(f"{kernel} bf16") and f"BQ {bq}," in label for label in labels):
                raise AssertionError(f"no tensor-core instantiation of {kernel} at BQ {bq}: {sorted(labels)}")
    if any(ops["HGMMA"] == 0 or ops["UTMALDG"] == 0 for ops in sass.values()):
        raise AssertionError(f"bf16 tensor-core kernels without HGMMA or UTMALDG in their SASS: {sass}")
    if len(sass8) < 4 or any(ops["IGMMA"] == 0 or ops["UTMALDG"] == 0 for ops in sass8.values()):
        raise AssertionError(f"int8 tensor-core kernels without IGMMA or UTMALDG in their SASS: {sass8}")
    # kernel 7: bf16 (HGMMA) and int8 (IGMMA), groups of 8 and 32
    if {_tc_label(name) for name in sass7} != {f"kernel 7 {tier} tensor cores, BQ {bq}, 4 stages, threshold selection"
                                               for tier in ("bf16", "int8") for bq in (8, 32)}:
        raise AssertionError(f"kernel 7's tensor-core instantiations: {sorted(sass7)}")
    if any(ops["IGMMA" if "int8" in _tc_label(name) else "HGMMA"] == 0 or ops["UTMALDG"] == 0
           for name, ops in sass7.items()):
        raise AssertionError(f"kernel 7 tensor-core kernels without wgmma or UTMALDG in their SASS: {sass7}")
    # the f32 ring (kernels 1, 3, 3 grouped, 5 and 7 on float32 rows): TMA
    # loads, fmaf, no wgmma; registers and spills of each instantiation
    ring = _cuda.sass_counts(F32_RING_KERNEL, ("HGMMA", "FFMA", "UTMALDG"))
    for name, ops in sorted(ring.items(), key=lambda item: _ring_label(item[0])):
        regs, stores, loads = ptxas.get(name, ("?", "?", "?"))
        log(f"[device] {_ring_label(name)}: {regs} registers, {stores}/{loads} bytes spill stores/loads; "
            f"SASS {ops['FFMA']} FFMA, {ops['UTMALDG']} UTMALDG, {ops['HGMMA']} HGMMA")
    labels = {_ring_label(name) for name in ring}
    for kernel in ("kernel 1", "kernel 3", "kernel 3 grouped", "kernel 5", "kernel 7"):
        for bq in (8, 32):
            if not any(label.startswith(f"{kernel} f32 ring") and f"BQ {bq}," in label for label in labels):
                raise AssertionError(f"no f32 ring instantiation of {kernel} at BQ {bq}: {sorted(labels)}")
    if any(ops["FFMA"] == 0 or ops["UTMALDG"] == 0 or ops["HGMMA"] != 0 for ops in ring.values()):
        raise AssertionError(f"f32 ring kernels without FFMA or UTMALDG, or with HGMMA, in their SASS: {ring}")


TC_KERNEL = "tc_block_topk_kernel"
TC_INT8_KERNEL = "tc_int8_block_topk_kernel"
TC_IVF_KERNEL = "tc_ivf_topk_kernel"
F32_RING_KERNEL = "fma_ring_"  # fma_ring_block_topk_kernel<BQ, grouped, keys>, fma_ring_ivf_topk_kernel<BQ>


def _ring_label(mangled: str) -> str:
    """``fma_ring_block_topk_kernel<BQ, grouped, keys>`` or
    ``fma_ring_ivf_topk_kernel<BQ>`` from its mangled name.  Kernel 1's
    instantiation also scans kernel 4's ranges."""
    import re

    found = re.search(r"fma_ring_block_topk_kernelILi(\d+)ELb([01])ELb([01])E", mangled)
    if found:
        bq, grouped, keys = found.groups()
        kernel = {("0", "0"): "kernel 1", ("1", "0"): "kernel 5", ("0", "1"): "kernel 3",
                  ("1", "1"): "kernel 3 grouped"}[(grouped, keys)]
        fused = " (also kernel 4's ranges)" if kernel == "kernel 1" else ""
        return f"{kernel} f32 ring, BQ {bq}, threshold selection{fused}"
    found = re.search(r"fma_ring_ivf_topk_kernelILi(\d+)E", mangled)
    if found:
        return f"kernel 7 f32 ring, BQ {found.group(1)}, threshold selection"
    return mangled


def _tc_label(mangled: str) -> str:
    """``tc_block_topk_kernel<BQ, stages, grouped, threshold, keys>``,
    ``tc_int8_block_topk_kernel<BQ, grouped>`` or ``tc_ivf_topk_kernel<Op,
    BQ>`` from its mangled name.  bf16
    kernel 4 launches kernel 1's threshold instantiation over its ranges
    (fused_topk.cu), so that one is named for both."""
    import re

    found = re.search(TC_KERNEL + r"ILi(\d+)ELi(\d+)ELb([01])ELb([01])ELb([01])E", mangled)
    if found:
        bq, stages, grouped, threshold, keys = found.groups()
        kernel = {("0", "0"): "kernel 1", ("1", "0"): "kernel 5", ("0", "1"): "kernel 3",
                  ("1", "1"): "kernel 3 grouped"}[(grouped, keys)]
        selection = "packed-key" if keys == "1" else "threshold" if threshold == "1" else "rounds"
        fused = " (also kernel 4's ranges)" if (grouped, threshold, keys, stages) == ("0", "1", "0", "4") else ""
        return f"{kernel} bf16 tensor cores, BQ {bq}, {stages} stages, {selection} selection{fused}"
    found = re.search(TC_INT8_KERNEL + r"ILi(\d+)ELb([01])E", mangled)
    if found:
        bq, grouped = found.groups()
        return f"{'kernel 6' if grouped == '1' else 'kernel 2'} int8 tensor cores, BQ {bq}, 4 stages, threshold selection"
    found = re.search(TC_IVF_KERNEL + r"IN3pse2tc\d+(Bf16|S8)ELi(\d+)E", mangled)
    if found:
        op, bq = found.groups()
        return f"kernel 7 {'bf16' if op == 'Bf16' else 'int8'} tensor cores, BQ {bq}, 4 stages, threshold selection"
    return mangled


def _ptxas_by_function(build_log: str) -> dict:
    """``{mangled name: (registers, spill store bytes, spill load bytes)}`` from ``-Xptxas=-v``."""
    import re

    out, current = {}, None
    for line in build_log.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if found:
            current = found.group(1)
            out.setdefault(current, ["?", "?", "?"])
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            out[current][1:] = [int(spill.group(1)), int(spill.group(2))]
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[current][0] = int(regs.group(1))
    return {name: tuple(values) for name, values in out.items()}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _unit_rows(n, d, gen, dtype):
    import torch

    x = torch.randn((n, d), generator=gen, device=DEVICE, dtype=torch.float32)
    return (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).to(dtype)


def _plain_scores(corpus, queries, metric, count, mask):
    """Every row's plain score, from the scoring helpers of the plain kernel 1."""
    from photo_search_engine_tpu_torch.ops import topk as to

    qf = queries.float()
    scores = to.score_chunk(corpus, qf, (qf * qf).sum(1), metric)
    return to.mask_scores(scores, 0, corpus.shape[0], count, mask)


def _chunked_ip_scores(corpus, queries):
    """Every row's plain inner product with each query, in row chunks (a
    1M-row bf16 corpus widened at once would be a 6 GB temporary)."""
    import torch

    from photo_search_engine_tpu_torch.ops import topk as to

    out = torch.empty((queries.shape[0], corpus.shape[0]), dtype=torch.float32, device=corpus.device)
    for start in range(0, corpus.shape[0], 65536):
        out[:, start:start + 65536] = to.score_chunk(corpus[start:start + 65536], queries.float(), None, "ip")
    return out


def phase_kernels() -> None:
    import torch

    from photo_search_engine_tpu_torch.ops import quantized as qo
    from photo_search_engine_tpu_torch.ops import topk as to

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    n, d = 5000, 1536  # ragged last block, main-path width
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        corpus = _unit_rows(n, d, gen, dtype)
        cnorms = to.row_sq_norms(corpus)
        for variant in ("ip", "l2", "masked"):
            metric = "l2" if variant == "l2" else "ip"
            count, mask = n, None
            if variant == "masked":
                count = n - 777
                mask = (torch.rand(n, generator=gen, device=DEVICE) < 0.3).to(torch.int8)
            for k, q in ((1, 3), (10, 40), (50, 3), (64, 40)):
                queries = _unit_rows(q, d, gen, dtype)
                kw = dict(count=count, metric=metric, mask=mask, cnorms=cnorms, block_n=1024)
                got = to.block_topk(corpus, queries, k, **kw)
                ref = to.exact_block_topk_plain(corpus, queries, k + 1, **kw)
                torch.cuda.synchronize()
                name = f"block_topk {str(dtype)[6:]} {variant} k={k} q={q}"
                err = check_topk(name, *got, *ref)
                check_scores(name, *got, _plain_scores(corpus, queries, metric, count, mask))
                _ERRORS["block_topk"] = max(_ERRORS["block_topk"], err)
                cases += 1
        # the whole exact search through kernel 1 against the plain search
        queries = _unit_rows(40, d, gen, dtype)
        for metric in ("ip", "l2"):
            got = to.exact_search(corpus, queries, 50, metric=metric)
            ref = to.exact_search_plain(corpus, queries, 51, metric=metric)
            sign = -1.0 if metric == "l2" else 1.0
            err = check_topk(f"exact_search {str(dtype)[6:]} {metric}", sign * got[0], got[1], sign * ref[0], ref[1])
            _ERRORS["block_topk"] = max(_ERRORS["block_topk"], err)
            cases += 1
    # a width that is not a multiple of the kernels' 32-element D-chunk
    for dtype in (torch.float32, torch.bfloat16):
        corpus, queries = _unit_rows(3000, 1000, gen, dtype), _unit_rows(40, 1000, gen, dtype)
        kw = dict(count=2950, metric="l2", mask=None, cnorms=to.row_sq_norms(corpus), block_n=1024)
        name = f"block_topk {str(dtype)[6:]} D=1000"
        got = to.block_topk(corpus, queries, 10, **kw)
        err = check_topk(name, *got, *to.exact_block_topk_plain(corpus, queries, 11, **kw))
        check_scores(name, *got, _plain_scores(corpus, queries, "l2", 2950, None))
        _ERRORS["block_topk"] = max(_ERRORS["block_topk"], err)
        cases += 1
    log(f"[kernels] block_topk: {cases} cases agree with the plain version "
        f"(max |err| {_ERRORS['block_topk']:.3g}, tol {TOL})")

    # duplicate rows: every tie must come out at the smallest row, exactly
    for dtype in (torch.float32, torch.bfloat16):
        corpus = _unit_rows(n, d, gen, dtype)
        dups = list(range(1000, 1062)) + [3000, 4990]  # across a block edge and in the ragged block
        corpus[dups] = corpus[7].clone()
        queries = corpus[7:8].clone()
        for k in (1, 10, 50, 64):
            _, idx = to.exact_search(corpus, queries, k, metric="ip")
            want = ([7] + dups)[:k]
            got = idx[0].tolist()
            if got != want:
                raise AssertionError(f"duplicate-row ties {str(dtype)[6:]} k={k}: {got[:8]}... != {want[:8]}...")
    log("[kernels] block_topk: duplicate-row ties come out at the smallest row (f32, bf16; k 1/10/50/64)")

    cases = 0
    for variant in ("ip", "l2", "masked"):
        metric = "l2" if variant == "l2" else "ip"
        ref_rows = _unit_rows(n, d, gen, torch.bfloat16)
        corpus_i8, scales = qo.quantize_rows(ref_rows)
        cnorms = to.row_sq_norms(ref_rows) if metric == "l2" else None
        count, mask = n, None
        if variant == "masked":
            count = n - 777
            mask = (torch.rand(n, generator=gen, device=DEVICE) < 0.3).to(torch.int8)
        for k, q in ((10, 3), (50, 40)):
            q_i8, qs = qo.quantize_rows(_unit_rows(q, d, gen, torch.float32))
            kw = dict(count=count, metric=metric, mask=mask, cnorms=cnorms, block_n=2048)
            got = qo.int8_block_topk(corpus_i8, scales, q_i8, qs, k, **kw)
            ref = qo.int8_block_topk_plain(corpus_i8, scales, q_i8, qs, k + 1, **kw)
            torch.cuda.synchronize()
            err = check_topk(f"int8_block_topk {variant} k={k} q={q}", *got, *ref, exact=True)
            _ERRORS["int8_block_topk"] = max(_ERRORS["int8_block_topk"], err)
            cases += 1
    c8, cs = qo.quantize_rows(_unit_rows(3000, 1000, gen, torch.float32))
    q8, qs = qo.quantize_rows(_unit_rows(40, 1000, gen, torch.float32))
    kw = dict(count=3000, metric="ip", block_n=2048)
    check_topk("int8_block_topk D=1000", *qo.int8_block_topk(c8, cs, q8, qs, 10, **kw),
               *qo.int8_block_topk_plain(c8, cs, q8, qs, 11, **kw), exact=True)
    cases += 1
    log(f"[kernels] int8_block_topk: {cases} cases identical to the plain version "
        f"(max |err| {_ERRORS['int8_block_topk']:.3g})")
    check_grouped_kernels(gen, n, d)
    check_tensor_core_kernels(gen)
    check_f32_ring_kernels(gen)
    check_int8_tensor_core_kernels(gen)
    check_ivf_kernel(gen, d)
    check_f32_ivf_repeats(gen, d)
    check_fast_kernels(gen, n, d)
    check_fused_kernel(gen, n, d)


def _predicates(gen, m, n, q):
    """A random [m, n] predicate table with an empty row 1 (m > 1), and ids
    that include one past the table (q > 1) and one below it (q >= 9)."""
    import torch

    table = (torch.rand((m, n), generator=gen, device=DEVICE) < 0.5).to(torch.int8)
    if m > 1:
        table[1] = 0
    ids = torch.randint(0, m, (q,), generator=gen, device=DEVICE, dtype=torch.int32)
    if q > 1:
        ids[-1] = m
    if q >= 9:
        ids[q // 2] = -1
    return table, ids


def _grouped_plain_scores(corpus, queries, count, table, ids):
    """Every row's plain score under each query's own predicate."""
    from photo_search_engine_tpu_torch.ops import grouped_mask as go
    from photo_search_engine_tpu_torch.ops import topk as to

    scores = to.score_chunk(corpus, queries.float(), None, "ip")
    return go.grouped_mask_scores(scores, 0, corpus.shape[0], count, table, ids)


def check_grouped_kernels(gen, n, d) -> None:
    """Kernels 5 and 6 against their plain versions: k in {1, 10, 50, 64},
    M in {1, 3, 8}, Q in {1, 9, 33, 128}, a live count below n; then
    duplicate rows under different predicates."""
    import torch

    from photo_search_engine_tpu_torch.ops import grouped_mask as go
    from photo_search_engine_tpu_torch.ops import quantized as qo

    count = n - 777
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        corpus = _unit_rows(n, d, gen, dtype)
        for m in (1, 3, 8):
            for q in (1, 9, 33, 128):
                queries = _unit_rows(q, d, gen, dtype)
                table, ids = _predicates(gen, m, n, q)
                scores = _grouped_plain_scores(corpus, queries, count, table, ids)
                for k in (1, 10, 50, 64):
                    kw = dict(count=count, block_n=1024)
                    got = go.grouped_block_topk(corpus, queries, table, ids, k, **kw)
                    ref = go.grouped_block_topk_plain(corpus, queries, table, ids, k + 1, **kw)
                    torch.cuda.synchronize()
                    name = f"grouped_block_topk {str(dtype)[6:]} M={m} q={q} k={k}"
                    err = check_topk(name, *got, *ref)
                    check_scores(name, *got, scores)
                    _ERRORS["grouped_block_topk"] = max(_ERRORS["grouped_block_topk"], err)
                    cases += 1
    log(f"[kernels] grouped_block_topk: {cases} cases agree with the plain version "
        f"(max |err| {_ERRORS['grouped_block_topk']:.3g}, tol {TOL})")

    cases = 0
    corpus_i8, scales = qo.quantize_rows(_unit_rows(n, d, gen, torch.bfloat16))
    for m in (1, 3, 8):
        for q in (1, 9, 33, 128):
            q_i8, qs = qo.quantize_rows(_unit_rows(q, d, gen, torch.float32))
            table, ids = _predicates(gen, m, n, q)
            for k in (1, 10, 50, 64):
                kw = dict(count=count, block_n=2048)
                got = qo.int8_grouped_block_topk(corpus_i8, scales, q_i8, qs, table, ids, k, **kw)
                ref = qo.int8_grouped_block_topk_plain(corpus_i8, scales, q_i8, qs, table, ids, k + 1, **kw)
                torch.cuda.synchronize()
                err = check_topk(f"int8_grouped_block_topk M={m} q={q} k={k}", *got, *ref, exact=True)
                _ERRORS["int8_grouped_block_topk"] = max(_ERRORS["int8_grouped_block_topk"], err)
                cases += 1
    log(f"[kernels] int8_grouped_block_topk: {cases} cases identical to the plain version "
        f"(max |err| {_ERRORS['int8_grouped_block_topk']:.3g})")

    # duplicate rows: ties at the smallest rows, each query under its own
    # predicate (all rows / none / even rows / ids outside the table)
    dups = list(range(1000, 1062)) + [3000, 4990]
    table = torch.zeros((3, n), dtype=torch.int8, device=DEVICE)
    table[0] = 1
    table[2, ::2] = 1
    ids = torch.tensor([0, 1, 2, 3, -1, 2, 0, 1, 0], dtype=torch.int32, device=DEVICE)
    every, even = [7] + dups, [r for r in [7] + dups if r % 2 == 0]
    for dtype in (torch.float32, torch.bfloat16):
        corpus = _unit_rows(n, d, gen, dtype)
        corpus[dups] = corpus[7].clone()
        queries = corpus[7:8].repeat(9, 1)
        for k in (1, 10, 50, 64):
            _, idx = go.grouped_mask_search(corpus, queries, table, ids, k)
            got = idx.tolist()
            if got[0] != every[:k] or got[2][: len(even)] != even[:k] or any(r != [-1] * k for r in (got[1], got[3], got[4])):
                raise AssertionError(f"grouped duplicate-row ties {str(dtype)[6:]} k={k}: {[r[:6] for r in got]}")
        c8, cs = qo.quantize_rows(corpus)
        q8, qs = qo.quantize_rows(queries)
        kw = dict(count=n, block_n=2048)
        check_topk("int8_grouped_block_topk duplicates", *qo.int8_grouped_block_topk(c8, cs, q8, qs, table, ids, 64, **kw),
                   *qo.int8_grouped_block_topk_plain(c8, cs, q8, qs, table, ids, 65, **kw), exact=True)
    log("[kernels] grouped: duplicate-row ties at the smallest row under each query's predicate; "
        "empty predicate and ids outside [0, M) give empty slots (f32, bf16; k 1/10/50/64)")


def check_tensor_core_kernels(gen) -> None:
    """The bf16 kernels 1 and 5 across their query tiles and widths: Q in
    {1, 8, 9, 32, 33, 128, 256}, D in {1536, 1000} (tensor cores) and 1001
    (the FMA loop, counted apart), k in {1, 50, 64}, a ragged last block, a
    live count below n; kernel 1 cycling through ip, l2 and masked, kernel
    5 with ids outside [0, M); then a block whose rows are all masked."""
    import torch

    from photo_search_engine_tpu_torch.ops import grouped_mask as go
    from photo_search_engine_tpu_torch.ops import topk as to
    from tests.torch_parity import launch_once

    n, count = 2500, 2400  # blocks of 1024, 1024 and a ragged 452
    cases = 0
    for d in (1536, 1000, 1001):
        corpus = _unit_rows(n, d, gen, torch.bfloat16)
        cnorms = to.row_sq_norms(corpus)
        loop = "tensor_core" if d % 8 == 0 else "fma"
        if to.scoring_loop(corpus) != loop or go.scoring_loop(corpus) != loop:
            raise AssertionError(f"kernels 1 and 5 D={d}: not on the {loop} loop")
        for i, q in enumerate((1, 8, 9, 32, 33, 128, 256)):
            queries = _unit_rows(q, d, gen, torch.bfloat16)
            table, ids = _predicates(gen, 3, n, q)
            for j, k in enumerate((1, 50, 64)):
                variant = ("ip", "l2", "masked")[(i + j) % 3]
                mask = (torch.rand(n, generator=gen, device=DEVICE) < 0.5).to(torch.int8) if variant == "masked" else None
                kw = dict(count=count, metric="l2" if variant == "l2" else "ip", mask=mask, cnorms=cnorms, block_n=1024)
                got = launch_once(to.block_topk, lambda: to.block_topk(corpus, queries, k, **kw))
                name = f"block_topk bf16 {variant} D={d} q={q} k={k} ({loop})"
                _ERRORS["block_topk"] = max(_ERRORS["block_topk"], check_topk(
                    name, *got, *to.exact_block_topk_plain(corpus, queries, k + 1, **kw)))
                check_scores(name, *got, _plain_scores(corpus, queries, kw["metric"], count, mask))
                got = launch_once(go.grouped_block_topk, lambda: go.grouped_block_topk(
                    corpus, queries, table, ids, k, count=count, block_n=1024))
                ref = go.grouped_block_topk_plain(corpus, queries, table, ids, k + 1, count=count, block_n=1024)
                name = f"grouped_block_topk bf16 M=3 D={d} q={q} k={k} ({loop})"
                _ERRORS["grouped_block_topk"] = max(_ERRORS["grouped_block_topk"], check_topk(name, *got, *ref))
                check_scores(name, *got, _grouped_plain_scores(corpus, queries, count, table, ids))
                cases += 2
    # a block whose rows are all masked out: its slots are empty in every query
    corpus, queries = _unit_rows(n, 1536, gen, torch.bfloat16), _unit_rows(40, 1536, gen, torch.bfloat16)
    mask = torch.ones(n, dtype=torch.int8, device=DEVICE)
    mask[1024:2048] = 0
    got_v, got_i = to.block_topk(corpus, queries, 50, count=n, mask=mask, block_n=1024)
    ref = to.exact_block_topk_plain(corpus, queries, 51, count=n, mask=mask, block_n=1024)
    check_topk("block_topk bf16 all-masked block", got_v, got_i, *ref)
    if not (torch.isneginf(got_v[:, 1]).all() and (got_i[:, 1] == torch.iinfo(torch.int32).max).all()):
        raise AssertionError("block_topk bf16: an all-masked block returned rows")
    log(f"[kernels] bf16 kernels 1 and 5: {cases} cases over Q 1/8/9/32/33/128/256, D 1536/1000 (tensor "
        f"cores) and 1001 (FMA loop), k 1/50/64 agree with the plain versions (max |err| "
        f"{max(_ERRORS['block_topk'], _ERRORS['grouped_block_topk']):.3g}, tol {TOL}); each took its loop; "
        f"an all-masked block gives empty slots")


def check_f32_ring_kernels(gen) -> None:
    """The float32 kernels 1, 3, 4 and 5 across their query tiles and
    widths: D 1536 and 1000 on the f32 ring and 1001 and 1002 on the FMA
    loop (each launch checked on its loop), Q 1/8/9/32/33/128/256, k
    1/10/50/64 cycling through ip, l2 and masked with a live count below n,
    kernel 5 with ids outside [0, M).  Each against its plain version
    (kernel 3 as the packed-key partials, bit for bit where the scores are
    the plain ones: :func:`check_fast_partials`; here against the FMA
    loop's); on the ring's widths each bit for bit against the FMA loop on
    the same inputs (kernels 1, 3 and 5's partials, kernel 4's range
    partials and result at the same blocks per range); kernel 4's range
    partials against kernel 1's merged by range; then duplicate rows and an
    all-masked block."""
    import torch

    from photo_search_engine_tpu_torch.ops import grouped_mask as go
    from photo_search_engine_tpu_torch.ops import topk as to
    from tests.torch_parity import assert_same_bits, fma_loop, launch_once

    n, count = 2500, 2400  # blocks of 1024, 1024 and a ragged 452
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = same = 0
    for d in (1536, 1000, 1001, 1002):
        corpus = _unit_rows(n, d, gen, torch.float32)
        cnorms = to.row_sq_norms(corpus)
        loop = to.scoring_loop(corpus)
        ring = loop == "fma_ring"
        if loop != ("fma_ring" if d % 4 == 0 else "fma"):
            raise AssertionError(f"f32 D={d}: scoring loop {loop}")
        for i, q in enumerate((1, 8, 9, 32, 33, 128, 256)):
            queries = _unit_rows(q, d, gen, torch.float32)
            table, ids = _predicates(gen, 3, n, q)
            for j, k in enumerate((1, 10, 50, 64)):
                variant = ("ip", "l2", "masked")[(i + j) % 3]
                mask = (torch.rand(n, generator=gen, device=DEVICE) < 0.5).to(torch.int8) if variant == "masked" else None
                kw = dict(count=count, metric="l2" if variant == "l2" else "ip", mask=mask, cnorms=cnorms, block_n=1024)
                name = f"f32 {variant} D={d} q={q} k={k} ({loop})"
                k1 = launch_once(to.block_topk, lambda: to.block_topk(corpus, queries, k, **kw))
                _ERRORS["block_topk"] = max(_ERRORS["block_topk"], check_topk(
                    f"block_topk {name}", *k1, *to.exact_block_topk_plain(corpus, queries, k + 1, **kw)))
                check_scores(f"block_topk {name}", *k1, _plain_scores(corpus, queries, kw["metric"], count, mask))
                k5 = launch_once(go.grouped_block_topk,
                                 lambda: go.grouped_block_topk(corpus, queries, table, ids, k, count=count, block_n=1024))
                ref = go.grouped_block_topk_plain(corpus, queries, table, ids, k + 1, count=count, block_n=1024)
                _ERRORS["grouped_block_topk"] = max(_ERRORS["grouped_block_topk"],
                                                    check_topk(f"grouped_block_topk M=3 {name}", *k5, *ref))
                k3 = launch_once(to.fast_block_topk, lambda: to.fast_block_topk(corpus, queries, k, **kw))
                per = to.fused_ranges(q, 3, sms, loop=loop)[1]
                k4 = launch_once(to.fused_topk,
                                 lambda: to.fused_topk(corpus, queries, k, blocks_per_range=per, **kw))
                assert_same_bits(f"fused_topk {name} ranges against kernel 1's", k4[2:], to.range_partials(*k1, per, k))
                assert_same_bits(f"fused_topk {name} against kernel 1", k4[:2], to.merge_partials(*k1, k))
                _ERRORS["fused_topk"] = max(_ERRORS["fused_topk"], check_topk(
                    f"fused_topk {name}", *k4[:2], *to.fused_topk_plain(corpus, queries, k + 1, blocks_per_range=per,
                                                                        **kw)[:2]))
                cases += 4
                if ring:  # the ring sums as the FMA loop does: the same bits
                    with fma_loop():
                        if to.scoring_loop(corpus) != "fma" or go.scoring_loop(corpus) != "fma":
                            raise AssertionError(f"f32 D={d}: fma_loop() left the ring")
                        assert_same_bits(f"block_topk {name} against the FMA loop", k1, launch_once(
                            to.block_topk, lambda: to.block_topk(corpus, queries, k, **kw)))
                        assert_same_bits(f"grouped_block_topk {name} against the FMA loop", k5, launch_once(
                            go.grouped_block_topk, lambda: go.grouped_block_topk(
                                corpus, queries, table, ids, k, count=count, block_n=1024)))
                        assert_same_bits(f"fast_block_topk {name} against the FMA loop", k3, launch_once(
                            to.fast_block_topk, lambda: to.fast_block_topk(corpus, queries, k, **kw)))
                        f4 = launch_once(to.fused_topk, lambda: to.fused_topk(
                            corpus, queries, k, blocks_per_range=per, **kw))
                    assert_same_bits(f"fused_topk {name} against the FMA loop", k4[:2], f4[:2])
                    assert_same_bits(f"fused_topk {name} ranges against the FMA loop", k4[2:], f4[2:])
                    same += 4
    # duplicate rows across a block edge and in the ragged block; a block whose rows are all masked out
    corpus = _unit_rows(n, 1536, gen, torch.float32)
    dups = list(range(1000, 1062)) + [2100, 2490]
    corpus[dups] = corpus[7].clone()
    for impl in ("pallas", "pallas_fast", "pallas_fused"):
        for k in (1, 10, 50, 64):
            _, idx = to.exact_search(corpus, corpus[7:8].clone(), k, metric="ip", impl=impl)
            if idx[0].tolist() != ([7] + dups)[:k]:
                raise AssertionError(f"f32 ring duplicate-row ties {impl} k={k}: {idx[0].tolist()[:8]}...")
    queries = _unit_rows(40, 1536, gen, torch.float32)
    mask = torch.ones(n, dtype=torch.int8, device=DEVICE)
    mask[1024:2048] = 0
    if to.scoring_loop(corpus) != "fma_ring":
        raise AssertionError("block_topk f32 all-masked block: not on the ring")
    got_v, got_i = launch_once(to.block_topk,
                               lambda: to.block_topk(corpus, queries, 50, count=n, mask=mask, block_n=1024))
    check_topk("block_topk f32 ring all-masked block", got_v, got_i,
               *to.exact_block_topk_plain(corpus, queries, 51, count=n, mask=mask, block_n=1024))
    if not (torch.isneginf(got_v[:, 1]).all() and (got_i[:, 1] == torch.iinfo(torch.int32).max).all()):
        raise AssertionError("block_topk f32 ring: an all-masked block returned rows")
    log(f"[kernels] f32 kernels 1, 3, 4 and 5: {cases} cases over Q 1/8/9/32/33/128/256, D 1536/1000 (f32 ring) "
        f"and 1001/1002 (FMA loop), k 1/10/50/64 agree with the plain versions; {same} results on the ring bit for "
        f"bit the FMA loop's on the same inputs; kernel 4 = kernel 1 merged by range, bit for bit; each took its "
        f"loop; duplicate rows tie to the smallest row (pallas, pallas_fast, pallas_fused); an all-masked block "
        f"gives empty slots")


def check_int8_tensor_core_kernels(gen) -> None:
    """The int8 kernels 2 and 6 across their query tiles and widths, each
    result identical to the plain version: Q in {1, 8, 9, 32, 33, 128, 256},
    D in {1536, 1008} (tensor cores; 1008 ends in a ragged 128-byte chunk)
    and 1000 (the __dp4a loop, counted apart), k in {1, 50, 64}, blocks of
    2048 rows and a ragged last one, a live count below n; kernel 2 cycling
    through ip, l2 and masked, kernel 6 with an empty predicate and ids
    outside [0, M); then an all-masked block, and duplicate rows across a
    block edge and in the ragged block."""
    import torch

    from photo_search_engine_tpu_torch.ops import quantized as qo
    from photo_search_engine_tpu_torch.ops import topk as to
    from tests.torch_parity import launch_once

    n, count, bn = 5000, 4900, 2048  # blocks of 2048, 2048 and a ragged 904
    cases = 0
    for d in (1536, 1008, 1000):
        ref_rows = _unit_rows(n, d, gen, torch.bfloat16)
        c8, cs = qo.quantize_rows(ref_rows)
        cnorms = to.row_sq_norms(ref_rows)
        loop = "tensor_core" if d % 16 == 0 else "dp4a"
        if qo.int8_scoring_loop(d) != loop:
            raise AssertionError(f"kernels 2 and 6 D={d}: not on the {loop} loop")
        for i, q in enumerate((1, 8, 9, 32, 33, 128, 256)):
            q8, qs = qo.quantize_rows(_unit_rows(q, d, gen, torch.float32))
            table, ids = _predicates(gen, 3, n, q)
            for j, k in enumerate((1, 50, 64)):
                variant = ("ip", "l2", "masked")[(i + j) % 3]
                mask = (torch.rand(n, generator=gen, device=DEVICE) < 0.5).to(torch.int8) if variant == "masked" else None
                kw = dict(count=count, metric="l2" if variant == "l2" else "ip", mask=mask, cnorms=cnorms, block_n=bn)
                for wrapper, call, plain in (
                        (qo.int8_block_topk, lambda kk: qo.int8_block_topk(c8, cs, q8, qs, kk, **kw),
                         lambda kk: qo.int8_block_topk_plain(c8, cs, q8, qs, kk, **kw)),
                        (qo.int8_grouped_block_topk,
                         lambda kk: qo.int8_grouped_block_topk(c8, cs, q8, qs, table, ids, kk, count=count, block_n=bn),
                         lambda kk: qo.int8_grouped_block_topk_plain(c8, cs, q8, qs, table, ids, kk, count=count,
                                                                    block_n=bn))):
                    name = wrapper.__name__
                    got = launch_once(wrapper, lambda: call(k))
                    label = f"{name} {variant if name == 'int8_block_topk' else 'M=3'} D={d} q={q} k={k} ({loop})"
                    _ERRORS[name] = max(_ERRORS[name], check_topk(label, *got, *plain(k + 1), exact=True))
                    cases += 1
    # a block whose rows are all masked out: its slots are empty in every query
    ref_rows = _unit_rows(n, 1536, gen, torch.bfloat16)
    c8, cs = qo.quantize_rows(ref_rows)
    q8, qs = qo.quantize_rows(_unit_rows(40, 1536, gen, torch.float32))
    mask = torch.ones(n, dtype=torch.int8, device=DEVICE)
    mask[bn:2 * bn] = 0
    got_v, got_i = qo.int8_block_topk(c8, cs, q8, qs, 50, count=n, mask=mask, block_n=bn)
    check_topk("int8_block_topk all-masked block", got_v, got_i,
               *qo.int8_block_topk_plain(c8, cs, q8, qs, 51, count=n, mask=mask, block_n=bn), exact=True)
    if not (torch.isneginf(got_v[:, 1]).all() and (got_i[:, 1] == torch.iinfo(torch.int32).max).all()):
        raise AssertionError("int8_block_topk: an all-masked block returned rows")
    # duplicate rows across the block edge at 2048 and in the ragged block
    # score the same bits: ties come out at the smallest rows, in both kernels
    dups = list(range(2016, 2077)) + [4100, 4990]  # with row 7, 64 rows
    ref_rows[dups] = ref_rows[7].clone()
    c8, cs = qo.quantize_rows(ref_rows)
    for q in (1, 33):
        q8, qs = qo.quantize_rows(ref_rows[7:8].float().repeat(q, 1))
        got = qo.int8_block_topk(c8, cs, q8, qs, 64, count=n, block_n=bn)
        check_topk(f"int8_block_topk duplicates q={q}", *got,
                   *qo.int8_block_topk_plain(c8, cs, q8, qs, 65, count=n, block_n=bn), exact=True)
        merged = to.merge_partials(*got, 64)[1]
        if merged[0].tolist() != ([7] + dups)[:64]:
            raise AssertionError(f"int8 duplicate-row ties q={q}: {merged[0].tolist()[:8]}...")
        table = torch.ones((1, n), dtype=torch.int8, device=DEVICE)
        ids = torch.zeros(q, dtype=torch.int32, device=DEVICE)
        got = qo.int8_grouped_block_topk(c8, cs, q8, qs, table, ids, 64, count=n, block_n=bn)
        if to.merge_partials(*got, 64)[1][0].tolist() != ([7] + dups)[:64]:
            raise AssertionError(f"int8 grouped duplicate-row ties q={q}")
    log(f"[kernels] int8 kernels 2 and 6: {cases} cases over Q 1/8/9/32/33/128/256, D 1536/1008 (tensor "
        f"cores) and 1000 (__dp4a loop), k 1/50/64 identical to the plain versions (max |err| "
        f"{max(_ERRORS['int8_block_topk'], _ERRORS['int8_grouped_block_topk']):.3g}); each took its loop; an "
        f"all-masked block gives empty slots; duplicate rows across a block edge tie to the smallest row")


def check_partials(name, got, plain, k, *, exact=False):
    """Kernel 7's ``[Q, nprobe, T, kk]`` partials against its plain
    version run at k + 1, whose extra column (when the tile has one) is the
    cut, then the merged top-k the same way (:func:`check_topk`'s rule);
    ``exact`` (int8) asks for identical values and ids."""
    from tests.torch_parity import assert_topk_match

    from photo_search_engine_tpu_torch.ops import topk as to

    ref_v, ref_i = plain(k + 1)
    kk = got[0].shape[-1]
    cut = ref_v[..., kk] if ref_v.shape[-1] > kk else None
    try:
        err = assert_topk_match(*got, ref_v[..., :kk], ref_i[..., :kk], tol=TOL, cut=cut, exact=exact)
    except AssertionError as exc:
        raise AssertionError(f"{name} (partials): {exc}") from exc
    merged = check_topk(f"{name} (merged)", *to.merge_partials(*got, k), *to.merge_partials(ref_v, ref_i, k + 1),
                        exact=exact)
    return max(err, merged)


def _ivf_layout(gen, nlist, lrows, d):
    """A cluster-major layout of unit rows whose clusters end in padding
    slots (row_valid 0), with 64 duplicates of slot 7 spread over clusters
    0, 1 and 2."""
    import torch

    corpus = _unit_rows(nlist * lrows, d, gen, torch.float32)
    row_valid = torch.ones(nlist * lrows, dtype=torch.int8, device=DEVICE)
    fill = torch.randint(lrows // 2, lrows + 1, (nlist,), generator=gen, device=DEVICE)
    row_valid.view(nlist, lrows)[torch.arange(lrows, device=DEVICE)[None, :] >= fill[:, None]] = 0
    dups = torch.tensor([lrows + 3 + 5 * i for i in range(40)] + [2 * lrows + i for i in range(24)], device=DEVICE)
    corpus[dups] = corpus[7].clone()
    row_valid[dups] = 1
    row_valid[7] = 1
    return corpus, row_valid, dups


F32_IVF_REPEATS = 200  # launches of each tile and group size in check_f32_ivf_repeats


def check_f32_ivf_repeats(gen, d) -> None:
    """Float32 kernel 7 on the ring, launched :data:`F32_IVF_REPEATS`
    times at each of the tiles of 367 and 1100 slots (passes of fewer than
    four row tiles, where a shared stage rotation once let a warp pair read
    a stale box) and groups of 8 and 32, ip and l2 in turn, every launch
    bit for bit the FMA loop's at the same tile and group: a race that
    fails a few launches in a thousand shows here, where one launch a case
    would pass it."""
    import torch

    from photo_search_engine_tpu_torch.ops import ivf_scan as io_
    from photo_search_engine_tpu_torch.ops import topk as to
    from tests.torch_parity import fma_loop, launch_once

    nlist, lrows, q, nprobe, k = 24, 1100, 33, 8, 64
    corpus, row_valid, _ = _ivf_layout(gen, nlist, lrows, d)
    cnorms = to.row_sq_norms(corpus)
    queries = _unit_rows(q, d, gen, torch.float32)
    probes = torch.stack([torch.randperm(nlist, generator=gen, device=DEVICE)[:nprobe] for _ in range(q)])
    probes = torch.sort(probes, dim=1).values.to(torch.int32).contiguous()
    if io_.ivf_scoring_loop(corpus, k) != "fma_ring":
        raise AssertionError("f32 kernel 7 repeats: not on the f32 ring")
    summary = []
    for block_n in (367, 1100):
        for bq in (8, 32):
            kws = [dict(lrows=lrows, metric=metric, cnorms=cnorms, block_n=block_n, bq=bq) for metric in ("ip", "l2")]
            with fma_loop():
                if io_.ivf_scoring_loop(corpus, k) != "fma":
                    raise AssertionError("f32 kernel 7 repeats: the reference is not on the FMA loop")
                refs = [launch_once(io_.ivf_block_topk, lambda: io_.ivf_block_topk(
                    corpus, queries, probes, row_valid, k, **kw)) for kw in kws]
            differ = torch.zeros((), dtype=torch.int64, device=DEVICE)
            before = read_launches()["ivf_block_topk"]
            for rep in range(F32_IVF_REPEATS):
                got = io_.ivf_block_topk(corpus, queries, probes, row_valid, k, **kws[rep % 2])
                ref = refs[rep % 2]
                differ += ((got[0].view(torch.int32) != ref[0].view(torch.int32)) | (got[1] != ref[1])).any().long()
            launched = read_launches()["ivf_block_topk"] - before
            bad = int(differ)  # one read-back for the whole series
            if launched != F32_IVF_REPEATS or bad:
                raise AssertionError(f"f32 kernel 7 repeats, tile {block_n}, BQ {bq}: {bad} of {launched} ring "
                                     "launches differ from the FMA loop's bits")
            summary.append(f"tile {block_n} / BQ {bq}: 0 of {launched}")
    log(f"[kernels] f32 ivf_block_topk repeats (ip and l2 in turn, k={k}, q={q}, nprobe {nprobe}, D={d}): "
        f"launches that differ from the FMA loop's bits: {'; '.join(summary)}")


def check_ivf_kernel(gen, d) -> None:
    """Kernel 7 against its plain version: float32 (the f32 ring at k <=
    64, each result also bit for bit the FMA loop's at the same tile and
    group size), bfloat16 and int8 (the tensor cores at k <= 64) layouts,
    k 500 on the FMA / __dp4a loop; ip and l2, k 1/10/50/64 (and 500 on the
    float layouts), Q 1/9/33/128, nprobe 1/8/64, with padding slots and a
    slot mask, each launch checked on its loop; then a query whose probed
    clusters are all masked out, duplicate rows, probe ids outside the
    layout, and one call of each loop under
    ``torch.cuda.set_sync_debug_mode("error")`` (the wrapper reads nothing
    back to the host)."""
    import torch

    from photo_search_engine_tpu_torch.ops import ivf_scan as io_
    from photo_search_engine_tpu_torch.ops import quantized as qo
    from photo_search_engine_tpu_torch.ops import topk as to
    from tests.torch_parity import assert_same_bits, fma_loop, launch_once

    nlist, lrows = 96, 1100  # whole-cluster tiles end in a ragged pass of 76 rows; the FMA tiles of 256 in one of 76
    base, row_valid, dups = _ivf_layout(gen, nlist, lrows, d)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = {"float32": 0, "bfloat16": 0, "int8": 0}
    loops = dict.fromkeys(to.SCORING_LOOPS, 0)
    same_bits = 0
    shapes = ((1, 1, 1), (10, 9, 8), (50, 33, 64), (64, 128, 8), (50, 128, 64), (500, 9, 8), (500, 1, 64))
    for tier in cases:
        ref_rows = base.to(torch.bfloat16 if tier != "float32" else torch.float32)
        cnorms = to.row_sq_norms(ref_rows)
        corpus, extra = ref_rows, {}
        if tier == "int8":
            corpus, cscales = qo.quantize_rows(ref_rows)
        for metric in ("ip", "l2"):
            for k, q, nprobe in shapes:
                if tier == "int8" and k > 64:
                    continue  # the int8 tier nominates at most 64 (k > 64 scans the full-precision layout)
                queries = _unit_rows(q, d, gen, torch.float32)
                queries[0] = base[7]
                probes = torch.stack([torch.randperm(nlist, generator=gen, device=DEVICE)[:nprobe] for _ in range(q)])
                probes = torch.sort(probes, dim=1).values.to(torch.int32).contiguous()
                if tier == "int8":
                    queries, qs = io_.quantize_ivf_queries(queries)
                    extra = dict(qscales=qs, cscales=cscales)
                else:
                    queries = queries.to(corpus.dtype)
                loop = io_.ivf_scoring_loop(corpus, k)
                # the geometry's tile, also for the plain version's k + 1 (whose loop may differ)
                bn = io_.ivf_geometry(q, nprobe, nlist, lrows, loop, sms)[0]
                for valid, what in ((row_valid, ""), (row_valid * (torch.rand(row_valid.shape, generator=gen, device=DEVICE) < 0.3), " masked")):
                    kw = dict(lrows=lrows, metric=metric, cnorms=cnorms, block_n=bn, **extra)
                    got = launch_once(io_.ivf_block_topk,
                                      lambda: io_.ivf_block_topk(corpus, queries, probes, valid.to(torch.int8), k, **kw))
                    name = f"ivf_block_topk {tier} {metric}{what} k={k} q={q} nprobe={nprobe} ({loop})"
                    plain = lambda kk: io_.ivf_block_topk_plain(corpus, queries, probes, valid.to(torch.int8), kk, **kw)  # noqa: E731
                    err = check_partials(name, got, plain, k, exact=tier == "int8")
                    _ERRORS["ivf_block_topk"] = max(_ERRORS["ivf_block_topk"], err)
                    if loop == "fma_ring":  # the f32 ring sums as the FMA loop does: the same bits, tile for tile
                        with fma_loop():
                            if io_.ivf_scoring_loop(corpus, k) != "fma":
                                raise AssertionError(f"{name}: fma_loop() left the ring")
                            fma = launch_once(io_.ivf_block_topk, lambda: io_.ivf_block_topk(
                                corpus, queries, probes, valid.to(torch.int8), k, **kw))
                        assert_same_bits(f"{name} against the FMA loop", got, fma)
                        same_bits += 1
                    cases[tier] += 1
                    loops[loop] += 1
    log(f"[kernels] ivf_block_topk: {cases['float32'] + cases['bfloat16']} float cases agree with the plain "
        f"version (max |err| {_ERRORS['ivf_block_topk']:.3g}, tol {TOL}), {cases['int8']} int8 cases identical; "
        f"{loops['tensor_core']} on the tensor cores, {loops['fma_ring']} on the f32 ring ({same_bits} of them "
        f"bit for bit the FMA loop's at the same tile), {loops['fma']} on the FMA / __dp4a loop")

    # a query whose probed clusters are all masked out; duplicates of slot 7
    # come out at the smallest slots, across clusters; ids outside the
    # layout match no slot
    row_valid[3 * lrows : 5 * lrows] = 0
    probes = torch.tensor([[0, 1, 2], [3, 4, -1], [nlist, 1, nlist + 7]], dtype=torch.int32, device=DEVICE)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        corpus, kw = base.to(dtype if dtype != torch.int8 else torch.float32), dict(lrows=lrows)
        queries = corpus[[7, 7, 7]].contiguous()
        if dtype == torch.int8:
            queries, qs = io_.quantize_ivf_queries(queries)
            corpus, cs = qo.quantize_rows(corpus)
            kw.update(qscales=qs, cscales=cs)
        vals, slots = to.merge_partials(*io_.ivf_block_topk(corpus, queries, probes, row_valid, 64, **kw), 64)
        want = sorted([7] + [int(r) for r in dups])[:64]
        if slots[0].tolist() != want:
            raise AssertionError(f"ivf duplicate-row ties {str(dtype)[6:]}: {slots[0].tolist()[:8]}... != {want[:8]}...")
        if not (torch.isneginf(vals[1]).all() and (slots[1] == torch.iinfo(torch.int32).max).all()):
            raise AssertionError("ivf: a query whose probed clusters are all masked out returned slots")
        if not (slots[2] // lrows == 1).all():
            raise AssertionError(f"ivf: probe ids outside the layout matched slots: {slots[2].tolist()[:8]}...")
    log("[kernels] ivf_block_topk: duplicate-row ties at the smallest slots across clusters; a query whose "
        "probed clusters are all masked out gets empty slots; probe ids past nlist and below 0 match no slot "
        "(f32, bf16, int8)")

    # one call of each loop under sync debug mode "error": a host sync raises
    corpus = base.to(torch.bfloat16)
    probes = torch.sort(torch.stack([torch.randperm(nlist, generator=gen, device=DEVICE)[:8] for _ in range(33)]),
                        dim=1).values.to(torch.int32).contiguous()
    queries = _unit_rows(33, d, gen, torch.bfloat16)
    c8, cs = qo.quantize_rows(corpus)
    q8, qs = io_.quantize_ivf_queries(queries.float())
    f32, qf = base, queries.float().contiguous()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        io_.ivf_block_topk(corpus, queries, probes, row_valid, 50, lrows=lrows)
        io_.ivf_block_topk(c8, q8, probes, row_valid, 64, lrows=lrows, qscales=qs, cscales=cs)
        io_.ivf_block_topk(f32, qf, probes, row_valid, 50, lrows=lrows)
        io_.ivf_block_topk(corpus, queries, probes, row_valid, 500, lrows=lrows)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log('[kernels] ivf_block_topk: bf16 and int8 on the tensor cores, f32 on its ring and bf16 k=500 on the FMA '
        'loop ran under torch.cuda.set_sync_debug_mode("error"): no host sync')


def check_fast(name, got_v, got_i, ref_v, ref_i, scores):
    """A search through kernel 3 (``[Q, k]``, higher is better) against the
    same search on kernel 3's plain version, by the rule of the CPU tests
    (``tests/torch_parity.py:assert_window_match``: a differing id only
    inside the 2^-12 window of the k-th score), and every returned row has
    the plain score it reports.  Returns the largest value error where the
    ids agree."""
    from tests.torch_parity import assert_window_match

    try:
        err = assert_window_match(got_v, got_i, ref_v, ref_i, tol=TOL)
    except AssertionError as exc:
        raise AssertionError(f"{name}: {exc}") from exc
    check_scores(name, got_v, got_i, scores)
    return err


def check_fast_partials(gen) -> None:
    """Kernel 3 on the tensor cores (bf16) and on the f32 ring, flat and
    grouped, on exact products (rows with one nonzero lane, queries with
    one 1.0 lane, many equal scores): quantized partials bit for bit
    against the plain version's, ip and l2, masked rows, a live count, and
    a last block of 40 rows, shorter than k = 64, whose slots past its rows
    hold its -inf lanes."""
    import torch

    from photo_search_engine_tpu_torch.ops import grouped_mask as go
    from photo_search_engine_tpu_torch.ops import topk as to
    from tests.torch_parity import assert_same_bits, launch_once

    n, k, cases = 2 * 1024 + 40, 64, 0
    base = torch.zeros((n, 64), device=DEVICE)
    base[torch.arange(n), torch.arange(n) % 64] = torch.rand(n, generator=gen, device=DEVICE)
    base[::7] = 0.0
    base = base.to(torch.bfloat16).float()  # values exact in bf16 and f32
    mask = (torch.rand(n, generator=gen, device=DEVICE) < 0.8).to(torch.int8)
    for dtype, loop in ((torch.bfloat16, "tensor_core"), (torch.float32, "fma_ring")):
        corpus = base.to(dtype)
        if to.scoring_loop(corpus) != loop or go.scoring_loop(corpus) != loop:
            raise AssertionError(f"kernel 3 {str(dtype)[6:]}: not on the {loop} loop")
        for q in (3, 40):
            queries = torch.zeros((q, 64), device=DEVICE)
            queries[torch.arange(q), torch.arange(q) % 3] = 1.0
            queries = queries.to(dtype)
            for metric in ("ip", "l2"):
                kw = dict(count=n - 10, metric=metric, mask=mask, cnorms=to.row_sq_norms(corpus), block_n=1024)
                got = launch_once(to.fast_block_topk, lambda: to.fast_block_topk(corpus, queries, k, **kw))
                assert_same_bits(f"fast_block_topk {str(dtype)[6:]} exact products {metric} q={q}", got,
                                 to.fast_block_topk_plain(corpus, queries, k, **kw))
                tail = 2048 + torch.arange(40, 64, device=DEVICE, dtype=torch.int32)
                if not ((got[1][:, 2, 40:] == tail).all() and torch.isneginf(got[0][:, 2, 40:]).all()):
                    raise AssertionError("fast_block_topk: the short last block's slots are not its -inf lanes")
                cases += 1
            table, ids = _predicates(gen, 3, n, q)
            kw = dict(count=n - 10, block_n=1024)
            got = launch_once(go.fast_grouped_block_topk,
                              lambda: go.fast_grouped_block_topk(corpus, queries, table, ids, k, **kw))
            assert_same_bits(f"fast_grouped_block_topk {str(dtype)[6:]} exact products q={q}", got,
                             go.fast_grouped_block_topk_plain(corpus, queries, table, ids, k, **kw))
            cases += 1
    log(f"[kernels] fast_block_topk / fast_grouped_block_topk (bf16 on the tensor cores, f32 on its ring): {cases} "
        f"cases of exact products bit for bit with the plain partials (ip, l2, masked, a last block shorter than k)")


def check_fast_kernels(gen, n, d) -> None:
    """Kernel 3 through exact_search(impl="pallas_fast") and grouped kernel 3
    through grouped_mask_search(impl="pallas_fast"), against the same
    searches on their plain versions (:func:`check_fast`), each launch on
    its loop (bf16 the tensor cores, f32 its ring): float32 and bfloat16;
    ip, l2 and masked with a live count below n; an empty predicate and ids
    outside [0, M); k 1/10/50/64; then duplicate rows and the bit-for-bit
    partials of :func:`check_fast_partials`."""
    import torch

    from photo_search_engine_tpu_torch.ops import grouped_mask as go
    from photo_search_engine_tpu_torch.ops import topk as to
    from tests.torch_parity import launch_once, plain_scan

    cases = {"fast_block_topk": 0, "fast_grouped_block_topk": 0}
    for dtype in (torch.float32, torch.bfloat16):
        corpus = _unit_rows(n, d, gen, dtype)
        loop = "fma_ring" if dtype == torch.float32 else "tensor_core"
        if to.scoring_loop(corpus) != loop or go.scoring_loop(corpus) != loop:
            raise AssertionError(f"kernel 3 {str(dtype)[6:]} D={d}: not on the {loop} loop")
        for variant in ("ip", "l2", "masked", "empty"):
            metric = "l2" if variant == "l2" else "ip"
            count, mask = n, None
            if variant in ("masked", "empty"):
                count = n - 777
                mask = (torch.rand(n, generator=gen, device=DEVICE) < (0.3 if variant == "masked" else 0.0)).to(torch.int8)
            sign = -1.0 if metric == "l2" else 1.0
            for k, q in ((1, 1), (10, 9), (50, 40), (64, 128)):
                queries = _unit_rows(q, d, gen, dtype)
                kw = dict(count=count, mask=mask, metric=metric, impl="pallas_fast", block_n=1024)
                got = launch_once(to.fast_block_topk, lambda: to.exact_search(corpus, queries, k, **kw))
                with plain_scan(to, "fast_block_topk"):
                    ref = to.exact_search(corpus, queries, k, **kw)
                name = f"fast_block_topk {str(dtype)[6:]} {variant} k={k} q={q}"
                scores = _plain_scores(corpus, queries, metric, count, mask)
                err = check_fast(name, sign * got[0], got[1], sign * ref[0], ref[1], scores)
                _ERRORS["fast_block_topk"] = max(_ERRORS["fast_block_topk"], err)
                cases["fast_block_topk"] += 1
        count = n - 777
        for m in (1, 3, 8):
            for q in (1, 33, 128):
                queries = _unit_rows(q, d, gen, dtype)
                table, ids = _predicates(gen, m, n, q)
                scores = _grouped_plain_scores(corpus, queries, count, table, ids)
                for k in (10, 64):
                    got = launch_once(go.fast_grouped_block_topk, lambda: go.grouped_mask_search(
                        corpus, queries, table, ids, k, count=count, impl="pallas_fast"))
                    with plain_scan(go, "fast_grouped_block_topk"):
                        ref = go.grouped_mask_search(corpus, queries, table, ids, k, count=count, impl="pallas_fast")
                    name = f"fast_grouped_block_topk {str(dtype)[6:]} M={m} q={q} k={k}"
                    err = check_fast(name, *got, *ref, scores)
                    _ERRORS["fast_grouped_block_topk"] = max(_ERRORS["fast_grouped_block_topk"], err)
                    cases["fast_grouped_block_topk"] += 1
    # duplicate rows: one packed-key window, ties to the smallest row
    dups = list(range(1000, 1062)) + [3000, 4990]
    for dtype in (torch.float32, torch.bfloat16):
        corpus = _unit_rows(n, d, gen, dtype)
        corpus[dups] = corpus[7].clone()
        for k in (1, 10, 50, 64):
            _, idx = to.exact_search(corpus, corpus[7:8].clone(), k, metric="ip", impl="pallas_fast")
            if idx[0].tolist() != ([7] + dups)[:k]:
                raise AssertionError(f"fast duplicate-row ties {str(dtype)[6:]} k={k}: {idx[0].tolist()[:8]}...")
    log(f"[kernels] fast_block_topk: {cases['fast_block_topk']} searches, fast_grouped_block_topk: "
        f"{cases['fast_grouped_block_topk']} searches agree with their plain versions (ids within the "
        f"2^-12 window of the k-th score; max |err| {_ERRORS['fast_block_topk']:.3g} / "
        f"{_ERRORS['fast_grouped_block_topk']:.3g}, tol {TOL}; bf16 on the tensor cores, f32 on its ring); "
        f"duplicate-row ties at the smallest row")
    check_fast_partials(gen)


def check_fused_kernel(gen, n, d) -> None:
    """Kernel 4 against its plain version (range partials and result, by
    :func:`check_topk`'s rule) and bit for bit against kernel 1 on the same
    batch, its partials merged by range (range_partials) and over ranges
    (merge_partials): kernel 4 scores with kernel 1's loop (bf16 the tensor
    cores, f32 its ring) and selects exactly.  float32 and bfloat16, each
    launch on its loop; ip, l2, masked with a live count below n, and an
    empty mask; k 1/10/50/64; 1, 2 and the default blocks per range; then
    duplicate rows."""
    import torch

    from photo_search_engine_tpu_torch.ops import topk as to
    from tests.torch_parity import assert_same_bits, launch_once

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nb = -(-n // 1024)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        corpus = _unit_rows(n, d, gen, dtype)
        loop = to.scoring_loop(corpus)
        cnorms = to.row_sq_norms(corpus)
        for variant in ("ip", "l2", "masked", "empty"):
            metric = "l2" if variant == "l2" else "ip"
            count, mask = n, None
            if variant in ("masked", "empty"):
                count = n - 777
                mask = (torch.rand(n, generator=gen, device=DEVICE) < (0.3 if variant == "masked" else 0.0)).to(torch.int8)
            for k, q in ((1, 1), (10, 9), (50, 40), (64, 128)):
                queries = _unit_rows(q, d, gen, dtype)
                kw = dict(count=count, metric=metric, mask=mask, cnorms=cnorms, block_n=1024)
                for per in (1, 2, to.fused_ranges(q, nb, sms, loop=loop)[1]):
                    got = launch_once(to.fused_topk,
                                      lambda: to.fused_topk(corpus, queries, k, blocks_per_range=per, **kw))
                    ref = to.fused_topk_plain(corpus, queries, k + 1, blocks_per_range=per, **kw)
                    name = f"fused_topk {str(dtype)[6:]} {variant} k={k} q={q} blocks/range={per}"
                    err = max(check_topk(f"{name} (ranges)", got[2], got[3], ref[2], ref[3]),
                              check_topk(name, got[0], got[1], ref[0], ref[1]))
                    check_scores(name, got[0], got[1], _plain_scores(corpus, queries, metric, count, mask))
                    k1 = to.block_topk(corpus, queries, k, **kw)
                    assert_same_bits(f"{name} ranges against kernel 1's", got[2:], to.range_partials(*k1, per, k))
                    assert_same_bits(f"{name} against kernel 1", got[:2], to.merge_partials(*k1, k))
                    _ERRORS["fused_topk"] = max(_ERRORS["fused_topk"], err)
                    cases += 1
    dups = list(range(1000, 1062)) + [3000, 4990]
    for dtype in (torch.float32, torch.bfloat16):
        corpus = _unit_rows(n, d, gen, dtype)
        corpus[dups] = corpus[7].clone()
        for k in (1, 10, 50, 64):
            _, idx = to.exact_search(corpus, corpus[7:8].clone(), k, metric="ip", impl="pallas_fused")
            if idx[0].tolist() != ([7] + dups)[:k]:
                raise AssertionError(f"fused duplicate-row ties {str(dtype)[6:]} k={k}: {idx[0].tolist()[:8]}...")
    log(f"[kernels] fused_topk: {cases} cases agree with the plain version, ranges and result (max |err| "
        f"{_ERRORS['fused_topk']:.3g}, tol {TOL}), and are kernel 1's partials merged, bit for bit (bf16 on "
        f"the tensor cores, f32 on its ring); duplicate-row ties at the smallest row")


# ---------------------------------------------------------------------------
# phase 3: the app on a photo library
# ---------------------------------------------------------------------------


def _scripts():
    """The port's scripts directory on ``sys.path`` (they import by module name)."""
    path = os.path.join(REPO, "scripts")
    if path not in sys.path:
        sys.path.insert(0, path)


def _demo():
    _scripts()
    import torch_demo_e2e

    return torch_demo_e2e


def _upload_jpeg() -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (320, 240), (235, 165, 85)).save(buf, format="JPEG")
    return buf.getvalue()


def _wait_ready(demo, base, what):
    for _ in range(2400):
        status = demo._get(base, "/index_status")
        if status["status"] in {"success", "ready", "failed"}:
            break
        time.sleep(0.25)
    if status["status"] not in {"success", "ready"} or not status.get("indexed_count"):
        raise AssertionError(f"{what}: index build ended as {status}")
    return status


def _results(what, payload, *, allow_empty=False):
    if payload.get("status") != "success" or not (allow_empty or payload.get("results")):
        raise AssertionError(f"{what}: empty or failed response: {str(payload)[:300]}")
    return len(payload["results"])


def _app_env(tmp: str, quantized: str, keyword_backend: str = "builtin") -> dict:
    """The app's environment; the micro-batcher stays at its default (on).
    Without a keyword index the searcher sends a filtered text query to
    ``search_masked``, which the micro-batcher runs as a grouped scan."""
    photo_dir = os.path.join(tmp, "photos")
    data_dir = os.path.join(tmp, "data")
    os.makedirs(photo_dir, exist_ok=True)
    os.makedirs(data_dir, exist_ok=True)
    _demo().make_library(photo_dir)
    return {
        "PHOTO_DIR": photo_dir, "DATA_DIR": data_dir, "RUNTIME_DATA_DIR": data_dir,
        "PSE_PLATFORM": "gpu", "STORE_QUANTIZED": quantized, "STORE_DTYPE": "auto",
        "KEYWORD_BACKEND": keyword_backend,
    }


def phase_app_subprocess() -> None:
    import socket

    demo = _demo()
    with tempfile.TemporaryDirectory(prefix="pse_smoke_") as tmp:
        env = dict(os.environ)
        env.update(_app_env(tmp, "auto"))
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
        env.update(SERVER_PORT=str(port), PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
        log_path = os.path.join(tmp, "server.log")
        with open(log_path, "w") as log_file:
            server = subprocess.Popen(
                [sys.executable, "-m", "photo_search_engine_tpu_torch.api.app"],
                env=env, cwd=REPO, stdout=log_file, stderr=subprocess.STDOUT,
            )
            try:
                base = f"http://127.0.0.1:{port}"
                started = time.perf_counter()
                for _ in range(240):
                    if server.poll() is not None:
                        break
                    try:
                        demo._get(base, "/index_status")
                        break
                    except OSError:
                        time.sleep(0.5)
                if server.poll() is not None:
                    raise AssertionError(f"server exited rc {server.returncode}:\n{open(log_path).read()[-3000:]}")
                up = time.perf_counter() - started
                demo._post(base, "/init_index", {"mode": "full"})
                status = _wait_ready(demo, base, "entry point")
                hits = _results("entry point /search_photos",
                                demo._post(base, "/search_photos", {"query": "beach sunset sea", "top_k": 3}))
                log(f"[app] entry point: up in {up:.1f} s, indexed {status['indexed_count']} photos, "
                    f"/search_photos -> {hits} results")
            finally:
                server.terminate()
                try:
                    server.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    server.kill()
                    server.wait()
        log_text = open(log_path).read() if os.path.exists(log_path) else ""
        if "[INFO] serving on" not in log_text:
            raise AssertionError(f"entry point did not serve:\n{log_text[-3000:]}")


def _serve(app):
    _scripts()
    from torch_load_test import serve

    return serve(app)


def phase_app_in_process(quantized: str) -> dict:
    from photo_search_engine_tpu_torch.api.app import create_app, initialize_services, load_config

    demo = _demo()
    with tempfile.TemporaryDirectory(prefix="pse_smoke_") as tmp:
        services = initialize_services(load_config(_app_env(tmp, quantized, keyword_backend="none")))
        server, port = _serve(create_app(services))
        try:
            base = f"http://127.0.0.1:{port}"
            demo._post(base, "/init_index", {"mode": "full"})
            _wait_ready(demo, base, f"in process, STORE_QUANTIZED={quantized}")
            photo = os.path.join(services["config"]["PHOTO_DIR"], "beach_sunset_sea.jpg")
            reset_launches()
            search = {"text": "beach sunset sea", "season": "夏天的照片", "season_text": "夏天 海边"}
            counts = {name: _results(name, demo._post(base, "/search_photos", {"query": query, "top_k": 6}))
                      for name, query in search.items()}
            # "夏天的照片" is a pure filter (no scan); "夏天 海边" is a filtered
            # vector search: the grouped scan, through the micro-batcher
            route = dict(services["vector_index"].last_route)
            counts["image"] = _results("image", demo._post(base, "/search_by_image", {"image_path": photo, "top_k": 3}))
            counts["upload"] = _results("upload", demo._post_multipart(
                base, "/search_by_uploaded_image", {"top_k": "3"}, "image", "upload.jpg", _upload_jpeg()))
            launches = read_launches()
        finally:
            server.shutdown()
            server.server_close()
            close_batchers(services)
    batcher = services["vector_index"]._microbatcher
    log(f"[app] in process, STORE_QUANTIZED={quantized}, micro-batcher on, no keyword index: "
        f"results {counts}, launches {launches}, season_text route {route['impl']}, "
        f"batches {batcher.batches_run} (grouped {batcher.grouped_batches_run}) for "
        f"{batcher.requests_served} searches")
    return launches


def phase_app() -> None:
    phase_app_subprocess()
    exact = phase_app_in_process("0")
    int8 = phase_app_in_process("1")
    for tier, launches, names in (("0", exact, ("block_topk", "grouped_block_topk")),
                                  ("1", int8, ("int8_block_topk", "int8_grouped_block_topk"))):
        for name in names:
            if launches[name] <= 0:
                raise AssertionError(f"STORE_QUANTIZED={tier}: the routes never launched {name}")
    for name in _FLAT:
        _LAUNCHES[name] += exact[name] + int8[name]


# ---------------------------------------------------------------------------
# phase 4: 1M x 1536
# ---------------------------------------------------------------------------


def _int8_search_reference(store, queries, k, *, kloc, cand, keep=None):
    """The int8 tier's search (inner product) from plain pieces: every
    row's quantized score (the int32 dot, exact in float64, scaled in
    float32 as kernels 2 and 6 scale it), ``-inf`` where ``keep`` ([Q, N]
    bool, optional) drops the row, the ``cand`` best rows of the whole
    corpus by that score, then the plain exact search over those rows.

    The port nominates per block instead (each block's top ``kloc``, then
    the top ``cand`` of those).  Both pools are the same set unless one
    block holds more than ``kloc`` of the corpus-wide pool, which is
    checked here."""
    import torch

    from photo_search_engine_tpu_torch.ops import quantized as qo
    from photo_search_engine_tpu_torch.ops import topk as to

    n = store.count
    q_i8, qs = qo.quantize_rows(queries)
    qd = q_i8.double()
    scores = torch.empty((queries.shape[0], n), dtype=torch.float32, device=queries.device)
    for start in range(0, n, 65536):
        stop = min(n, start + 65536)
        acc = (qd @ store._device_i8[start:stop].double().T).float()
        scores[:, start:stop] = acc * qs[:, None] * store._scales[None, start:stop]
    if keep is not None:
        scores = torch.where(keep, scores, float("-inf"))
    ordered, order = torch.sort(scores, dim=1, descending=True, stable=True)
    pool, live = order[:, :cand], torch.isfinite(ordered[:, :cand])
    nb = -(-n // store._i8_block)
    blocks = pool // store._i8_block + nb * torch.arange(pool.shape[0], device=pool.device)[:, None]
    if live.any() and int(torch.bincount(blocks[live]).max()) > kloc:
        raise AssertionError(f"int8 reference: one block holds more than kloc={kloc} rows of a query's pool")
    vals = torch.full((queries.shape[0], k), float("-inf"), device=queries.device)
    idx = torch.full((queries.shape[0], k), -1, dtype=torch.int32, device=queries.device)
    for qi in range(queries.shape[0]):
        rows = pool[qi][live[qi]]
        if rows.numel():
            v, pos = to.exact_search_plain(store._device[rows], queries[qi:qi + 1], k, metric="ip")
            vals[qi, : v.shape[1]] = v[0]
            idx[qi, : v.shape[1]] = rows[pos[0].long()].to(torch.int32)
    return vals, idx


_SEASONS = {12: "冬天", 1: "冬天", 2: "冬天", 3: "春天", 4: "春天", 5: "春天",
            6: "夏天", 7: "夏天", 8: "夏天", 9: "秋天", 10: "秋天", 11: "秋天"}


def _scale_metadata(rows: int):
    """Metadata as scripts/load_test.py builds it for its synthetic corpus,
    plus a seeded EXIF date and the time fields the searcher's predicates
    read (season, year, month): a season keeps about a quarter of the rows."""
    import numpy as np

    rng = np.random.default_rng(SEED + 2)
    years, months, days = (rng.integers(lo, hi, rows).tolist() for lo, hi in ((2015, 2025), (1, 13), (1, 29)))
    return [
        {"photo_path": f"/photos/{i}.jpg", "file_name": f"IMG_{i:07d}.jpg",
         "description": f"synthetic row {i}", "exif_data": {"datetime": f"{y}-{m:02d}-{d:02d}"},
         "time_info": {"season": _SEASONS[m], "year": y, "month": m}}
        for i, (y, m, d) in enumerate(zip(years, months, days))
    ]


_METADATA = {}


def _metadata(rows: int):
    """:func:`_scale_metadata`, built once per row count (phases 4 and 5)."""
    if rows not in _METADATA:
        _METADATA[rows] = _scale_metadata(rows)
    return _METADATA[rows]


def _hits_to_topk(hits, k):
    """A search's ``[{metadata, distance}]`` as padded ``(values, row ids)``."""
    import numpy as np

    vals = np.full(k, -np.inf, np.float32)
    idx = np.full(k, -1, np.int32)
    for slot, hit in enumerate(hits):
        vals[slot] = hit["distance"]
        idx[slot] = int(hit["metadata"]["photo_path"][len("/photos/"):-len(".jpg")])
    return vals, idx


def _batch_delta(batcher, before):
    now = (batcher.batches_run, batcher.grouped_batches_run, batcher.requests_served)
    return tuple(a - b for a, b in zip(now, before)), now


def _scale_index(rows: int, dim: int, tmp: str, phase: str):
    """``rows`` x ``dim`` bf16 unit rows made on the card from a seed, with
    an int8 shadow and the seeded season metadata, installed in a
    VectorIndex as a user's ingest would leave it (``load_device_rows``):
    the corpus of phases 4 and 6.  Returns the index and the generator,
    whose next draws the phase goes on with."""
    import torch

    from photo_search_engine_tpu_torch.core.vector_index import VectorIndex

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    corpus = torch.empty((rows, dim), dtype=torch.bfloat16, device=DEVICE)
    for start in range(0, rows, 131072):
        stop = min(rows, start + 131072)
        corpus[start:stop] = _unit_rows(stop - start, dim, gen, torch.bfloat16)
    index = VectorIndex(
        dimension=dim, index_path=os.path.join(tmp, "scale.index"),
        metadata_path=os.path.join(tmp, "scale-meta.json"), metric="cosine",
        store_dtype="bfloat16", quantized=True, device=torch.device(DEVICE),
    )
    index.load_device_rows(corpus, _metadata(rows))
    del corpus
    torch.cuda.synchronize()
    log(f"[{phase}] {rows} x {dim} bf16 rows + int8 shadow on the card, season metadata on the host, in "
        f"{time.perf_counter() - t0:.1f} s (capacity {index._store.capacity}, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)")
    return index, gen


def phase_scale(rows: int = 1_000_000, dim: int = 1536) -> None:
    import numpy as np
    import torch

    from photo_search_engine_tpu_torch.api.app import create_app, initialize_services, load_config
    from photo_search_engine_tpu_torch.ops import grouped_mask as go
    from photo_search_engine_tpu_torch.ops import quantized as qo
    from photo_search_engine_tpu_torch.ops import topk as to

    demo = _demo()
    device = torch.device(DEVICE)
    with tempfile.TemporaryDirectory(prefix="pse_scale_") as tmp:
        index, gen = _scale_index(rows, dim, tmp, "scale")
        store = index._store
        if to.scoring_loop(store._device) != "tensor_core" or qo.int8_scoring_loop(dim) != "tensor_core":
            raise AssertionError("scale: by the loop rules the store's rows are off the tensor cores")

        # the app's own wiring over the installed index, micro-batcher on and
        # no keyword index (filtered text queries take search_masked); query
        # expansion and the caches off, so each request runs its searches afresh
        config = load_config({
            "DATA_DIR": tmp, "RUNTIME_DATA_DIR": tmp, "PSE_PLATFORM": "gpu",
            "SEARCH_MICROBATCH_ENABLED": "1", "KEYWORD_BACKEND": "none",
            "EMBEDDING_DIMENSION": str(dim), "TOP_K": "10",
            "QUERY_EXPANSION_ENABLED": "0", "QUERY_CACHE_ENABLED": "0", "EMBEDDING_CACHE_ENABLED": "0",
        })
        services = initialize_services(config, device=device, vector_index=index)
        batcher = index._microbatcher
        server, port = _serve(create_app(services))
        base = f"http://127.0.0.1:{port}"
        rng = np.random.default_rng(SEED)
        picks = [int(x) for x in rng.integers(0, rows, size=32)]
        # five predicates keeping about 50 %, 25 %, 5 %, 0.1 % and 0 % of the rows
        masks = [rng.random(rows) < frac for frac in (0.5, 0.25, 0.05, 0.001, 0.0)]
        filtered_q = _unit_rows(64, dim, gen, torch.float32).cpu().numpy()
        filtered = {}
        counters = (0, 0, 0)
        try:
            reset_launches()
            for quantized in (True, False):
                tier = "int8" if quantized else "exact"
                index.quantized = quantized  # int8 shadow scan (kernels 2, 6) or exact scan (1, 5)
                latency = {}

                def image_search(i):
                    t = time.perf_counter()
                    hits = demo._post(base, "/search_by_image", {"image_path": f"/photos/{i}.jpg", "top_k": 10})
                    _results("scale /search_by_image", hits)
                    latency[i] = 1e3 * (time.perf_counter() - t)

                t = time.perf_counter()
                run_threads(image_search, [(i,) for i in picks])
                wall = time.perf_counter() - t
                (b, g, r), counters = _batch_delta(batcher, counters)
                ms = sorted(latency.values())
                log(f"[scale] {len(picks)} concurrent /search_by_image ({tier}, candidate_k 50): "
                    f"{wall:.2f} s wall, request ms p50 {ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}; "
                    f"{r} searches in {b} batches (mean batch {r / max(b, 1):.2f})")

                def filtered_search(i):
                    filtered[(tier, i)] = index.search_masked(filtered_q[i], 50, masks[i % len(masks)])

                t = time.perf_counter()
                run_threads(filtered_search, [(i,) for i in range(len(filtered_q))])
                wall = time.perf_counter() - t
                (b, g, r), counters = _batch_delta(batcher, counters)
                log(f"[scale] {len(filtered_q)} concurrent search_masked(k=50) over {len(masks)} predicates "
                    f"({tier}): {wall:.2f} s wall; {r} searches in {b} batches, {g} grouped "
                    f"(mean batch {r / max(b, 1):.2f})")

            for query in ("海边 日落", "夏天 海边", "夏天 海边"):
                t = time.perf_counter()
                # random rows score below the searcher's relevance floors, so
                # the fused result may rightly be empty here
                hits = _results("scale /search_photos", demo._post(
                    base, "/search_photos", {"query": query, "top_k": 10}), allow_empty=True)
                log(f"[scale] /search_photos {query!r} (candidate_k 500, plain large-k path, "
                    f"{index.last_route['impl']}): {hits} results in {1e3 * (time.perf_counter() - t):.1f} ms")
            launches = read_launches()
        finally:
            server.shutdown()
            server.server_close()
            close_batchers(services)
        log(f"[scale] route launches {launches} (rows of width 1536: kernels 1, 2, 5 and 6 on the tensor cores)")
        for name in _FLAT:
            if launches[name] <= 0:
                raise AssertionError(f"scale routes never launched {name}")
            _LAUNCHES[name] += launches[name]
        mean = batcher.requests_served / max(batcher.batches_run, 1)
        log(f"[scale] micro-batcher: batches_run {batcher.batches_run}, grouped_batches_run "
            f"{batcher.grouped_batches_run}, requests_served {batcher.requests_served} (mean batch {mean:.2f})")
        if not mean > 1:
            raise AssertionError("the micro-batcher never coalesced: mean batch size is not above 1")

        # the filtered results against plain per-query searches, each under
        # its own predicate row; the queries normalized on the host as the
        # store normalizes cosine queries (EmbeddingStore._prepare)
        keep = torch.from_numpy(np.stack([masks[i % len(masks)] for i in range(len(filtered_q))])).to(device)
        norms = np.linalg.norm(filtered_q, axis=1, keepdims=True)
        queries = torch.from_numpy(filtered_q / np.maximum(norms, 1e-30)).to(device)
        live = store._device[: store.count]
        for quantized in (True, False):
            tier = "int8" if quantized else "exact"
            got = [_hits_to_topk(filtered[(tier, i)], 50) for i in range(len(filtered_q))]
            got_v = torch.from_numpy(np.stack([g[0] for g in got])).to(device)
            got_i = torch.from_numpy(np.stack([g[1] for g in got])).to(device)
            if quantized:
                ref_v, ref_i = _int8_search_reference(store, queries, 51, kloc=50, cand=100, keep=keep)
                name = "int8_grouped_block_topk"
            else:
                ref = [to.exact_search_plain(live, queries[i:i + 1].to(torch.bfloat16), 51, metric="ip",
                                             mask=keep[i].to(torch.int8)) for i in range(len(filtered_q))]
                ref_v, ref_i = torch.cat([r[0] for r in ref]), torch.cat([r[1] for r in ref])
                name = "grouped_block_topk"
            err = check_topk(f"scale filtered search ({tier})", got_v, got_i, ref_v, ref_i)
            _ERRORS[name] = max(_ERRORS[name], err)
            if not bool((got_i[4::5] == -1).all()):
                raise AssertionError("scale filtered search: the empty predicate returned rows")
        log("[scale] filtered-search results agree with plain per-query searches under their own "
            "predicates (exact and int8; empty predicate empty)")

        # the host predicate table each grouped batch builds and uploads
        # (EmbeddingStore.grouped_search): M = 8, the batcher's cap
        stacked = np.stack([masks[i % len(masks)] for i in range(8)])
        t = time.perf_counter()
        for _ in range(5):
            host = np.zeros((8, store.capacity), np.int8)
            host[:, :rows] = stacked > 0
            torch.from_numpy(host).to(device)
            torch.cuda.synchronize()
        log(f"[scale] host predicate table [8, {store.capacity}] int8 ({host.nbytes / 1e6:.1f} MB): build and "
            f"upload {1e3 * (time.perf_counter() - t) / 5:.2f} ms per grouped batch")

        # the image searches' vector results against the plain version
        queries = torch.from_numpy(np.stack([store.reconstruct(i) for i in picks[:4]])).to(device)
        for quantized in (True, False):
            index.quantized = quantized
            dists, idx = index.raw_search_batch(queries.cpu().numpy(), 50)
            got_v = torch.from_numpy(dists).to(device)
            got_i = torch.from_numpy(idx).to(device)
            if quantized:
                ref_v, ref_i = _int8_search_reference(store, queries, 51, kloc=50, cand=100)
                err = check_topk("scale int8 image search", got_v, got_i, ref_v, ref_i)
                _ERRORS["int8_block_topk"] = max(_ERRORS["int8_block_topk"], err)
            else:
                ref_v, ref_i = to.exact_search_plain(live, queries.to(torch.bfloat16), 51, metric="ip")
                err = check_topk("scale exact image search", got_v, got_i, ref_v, ref_i)
                _ERRORS["block_topk"] = max(_ERRORS["block_topk"], err)
            if not bool((got_i[:, 0] == torch.tensor(picks[:4], device=device, dtype=got_i.dtype)).all()):
                raise AssertionError("scale image search: a query row is not its own nearest neighbour")
        log("[scale] image-search results agree with the plain version (exact and int8)")

        scale_impl_routes(store, masks, gen)
        scale_kernel_times(store, masks, gen)


def scale_impl_routes(store, masks, gen) -> None:
    """Kernels 3 and 4 through the store's impl values, as a caller asks for
    them: search(impl="pallas_fast") and search(impl="pallas_fused") at
    batch 1 and 128, top-50, and grouped_search(impl="pallas_fast") at batch
    128 over the five predicates, every launch on the tensor cores.  Kernel
    4's results must be kernel 1's (impl="pallas"), bit for bit; kernel 3's
    are held against the same searches on its plain version
    (:func:`check_fast`)."""
    import numpy as np
    import torch

    from photo_search_engine_tpu_torch.ops import grouped_mask as go
    from photo_search_engine_tpu_torch.ops import topk as to
    from tests.torch_parity import assert_same_bits, plain_scan

    dim = store.dimension
    queries = {b: _unit_rows(b, dim, gen, torch.float32).cpu().numpy() for b in (1, 128)}
    table = np.stack(masks)
    ids = (np.arange(128) % len(masks)).astype(np.int32)
    reset_launches()
    got = {(impl, b): store.search(queries[b], 50, impl=impl) for b in (1, 128) for impl in ("pallas_fast", "pallas_fused")}
    got[("grouped", 128)] = store.grouped_search(queries[128], 50, table, ids, impl="pallas_fast")
    launches = read_launches()
    log(f"[scale] store impl routes (pallas_fast, pallas_fused at batch 1 and 128; grouped pallas_fast at "
        f"batch 128, M={len(masks)}): launches {launches}")
    for name in _IMPL_ROUTES:
        if launches[name] <= 0:
            raise AssertionError(f"the store's impl routes never launched {name}")
        _LAUNCHES[name] += launches[name]

    device = store._device.device
    live = store._device[: store.count]
    for b in (1, 128):
        # kernel 4 and kernel 1 score on the same tensor-core loop: identical
        want = store.search(queries[b], 50, impl="pallas")
        assert_same_bits(f"scale fused search batch {b} against kernel 1",
                         tuple(torch.from_numpy(x) for x in got[("pallas_fused", b)]),
                         tuple(torch.from_numpy(x) for x in want))
        with plain_scan(to, "fast_block_topk"):
            ref = store.search(queries[b], 50, impl="pallas_fast")
        q16 = torch.from_numpy(queries[b] / np.linalg.norm(queries[b], axis=1, keepdims=True)).to(device).to(torch.bfloat16)
        scores = _chunked_ip_scores(live, q16)
        err = check_fast(f"scale fast search batch {b}", *(torch.from_numpy(x).to(device) for x in (*got[("pallas_fast", b)], *ref)), scores)
        _ERRORS["fast_block_topk"] = max(_ERRORS["fast_block_topk"], err)
    with plain_scan(go, "fast_grouped_block_topk"):
        ref = store.grouped_search(queries[128], 50, table, ids, impl="pallas_fast")
    q16 = torch.from_numpy(queries[128] / np.linalg.norm(queries[128], axis=1, keepdims=True)).to(device).to(torch.bfloat16)
    keep = torch.from_numpy(table[ids]).to(device)
    scores = torch.where(keep, _chunked_ip_scores(live, q16), float("-inf"))
    err = check_fast("scale grouped fast search batch 128", *(torch.from_numpy(x).to(device) for x in (*got[("grouped", 128)], *ref)), scores)
    _ERRORS["fast_grouped_block_topk"] = max(_ERRORS["fast_grouped_block_topk"], err)
    del scores, keep
    log("[scale] impl routes, on the tensor cores: pallas_fused results identical to kernel 1's; pallas_fast "
        "(flat and grouped) agree with the same searches on kernel 3's plain version")


def scale_kernel_times(store, masks, gen) -> None:
    """Every flat kernel against its plain version at the main-path shapes
    (kernel 3's partials are quantized: its searches were held against the
    plain version in scale_impl_routes; kernel 4 is also held bit for bit
    to kernel 1's partials merged), then its time (CUDA events; plain,
    kernel, kernel, plain), its bound and the time of the nearest library
    composition (cuBLAS product, then torch.topk over the [Q, N] scores)."""
    import numpy as np
    import torch

    from photo_search_engine_tpu_torch.ops import grouped_mask as go
    from photo_search_engine_tpu_torch.ops import quantized as qo
    from photo_search_engine_tpu_torch.ops import topk as to
    from tests.torch_parity import assert_same_bits

    device, (cap, dim) = store._device.device, store._device.shape
    rows = store.count
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    table = torch.zeros((len(masks), cap), dtype=torch.int8, device=device)
    table[:, :rows] = torch.from_numpy(np.stack(masks)).to(device)
    k1 = dict(count=rows, metric="ip", block_n=store.block_rows)
    k2 = dict(count=rows, metric="ip", block_n=store._i8_block)
    k5 = dict(count=rows, block_n=store.block_rows)
    k6 = dict(count=rows, block_n=store._i8_block)
    nb, nb8 = -(-cap // store.block_rows), -(-cap // store._i8_block)
    k = 50
    for batch, names in ((1, _FLAT + _IMPL_ROUTES),
                         (8, _FLAT + _IMPL_ROUTES),
                         (128, _FLAT + _IMPL_ROUTES),
                         (256, ("block_topk", "int8_block_topk", "grouped_block_topk", "int8_grouped_block_topk")
                          + _IMPL_ROUTES)):
        qb = _unit_rows(batch, dim, gen, torch.float32)
        qb16 = qb.to(torch.bfloat16)
        q_i8, qs = qo.quantize_rows(qb)
        ids = (torch.arange(batch, device=device) % len(masks)).to(torch.int32)
        per = to.fused_ranges(batch, nb, sms, block_n=store.block_rows, k=k, loop=to.scoring_loop(store._device))[1]
        ranges = -(-nb // per)
        # the int8 product through cuBLAS wants more than 16 rows
        qpad = torch.zeros((max(32, -(-batch // 8) * 8), dim), dtype=torch.int8, device=device)
        qpad[:batch] = q_i8

        def int8_scores():
            acc = torch._int_mm(qpad, store._device_i8.T)[:batch]
            return acc.float() * qs[:, None] * store._scales[None, :]

        dense = lambda: torch.matmul(qb16, store._device.T)  # noqa: E731
        keep = lambda: table[ids.long()] > 0  # noqa: E731
        bf16_in = nbytes(store._device, qb16)
        i8_in = nbytes(store._device_i8, store._scales, q_i8, qs)
        flops = 2.0 * batch * cap * dim
        runs = {  # name: (kernel, plain, library, bytes moved, operations, unit)
            "block_topk": (
                lambda kk: to.block_topk(store._device, qb16, kk, **k1),
                lambda kk: to.exact_block_topk_plain(store._device, qb16, kk, **k1),
                lambda: torch.topk(dense(), k), bf16_in + batch * nb * k * 8, flops, "bf16"),
            "fast_block_topk": (
                lambda kk: to.fast_block_topk(store._device, qb16, kk, **k1),
                lambda kk: to.fast_block_topk_plain(store._device, qb16, kk, **k1),
                lambda: torch.topk(dense(), k), bf16_in + batch * nb * k * 8, flops, "bf16"),
            "fused_topk": (
                lambda kk: to.fused_topk(store._device, qb16, kk, blocks_per_range=per, **k1)[:2],
                lambda kk: to.fused_topk_plain(store._device, qb16, kk, blocks_per_range=per, **k1)[:2],
                lambda: torch.topk(dense(), k), bf16_in + batch * (ranges + 1) * k * 8, flops, "bf16"),
            "int8_block_topk": (
                lambda kk: qo.int8_block_topk(store._device_i8, store._scales, q_i8, qs, kk, **k2),
                lambda kk: qo.int8_block_topk_plain(store._device_i8, store._scales, q_i8, qs, kk, **k2),
                lambda: torch.topk(int8_scores(), k), i8_in + batch * nb8 * k * 8, flops, "int8"),
            "grouped_block_topk": (
                lambda kk: go.grouped_block_topk(store._device, qb16, table, ids, kk, **k5),
                lambda kk: go.grouped_block_topk_plain(store._device, qb16, table, ids, kk, **k5),
                lambda: torch.topk(torch.where(keep(), dense(), float("-inf")), k),
                bf16_in + nbytes(table, ids) + batch * nb * k * 8, flops, "bf16"),
            "fast_grouped_block_topk": (
                lambda kk: go.fast_grouped_block_topk(store._device, qb16, table, ids, kk, **k5),
                lambda kk: go.fast_grouped_block_topk_plain(store._device, qb16, table, ids, kk, **k5),
                lambda: torch.topk(torch.where(keep(), dense(), float("-inf")), k),
                bf16_in + nbytes(table, ids) + batch * nb * k * 8, flops, "bf16"),
            "int8_grouped_block_topk": (
                lambda kk: qo.int8_grouped_block_topk(store._device_i8, store._scales, q_i8, qs, table, ids, kk, **k6),
                lambda kk: qo.int8_grouped_block_topk_plain(store._device_i8, store._scales, q_i8, qs, table, ids, kk, **k6),
                lambda: torch.topk(torch.where(keep(), int8_scores(), float("-inf")), k),
                i8_in + nbytes(table, ids) + batch * nb8 * k * 8, flops, "int8"),
        }
        k1_partials = runs["block_topk"][0](k)
        for name in names:
            kernel, plain, library, moved, ops, unit = runs[name]
            err = 0.0
            if not name.startswith("fast"):
                got = kernel(k)
                err = check_topk(f"scale {name} batch {batch} top-{k}", *got, *plain(k + 1),
                                 exact=name.startswith("int8"))
                _ERRORS[name] = max(_ERRORS[name], err)
                if name == "fused_topk":  # and kernel 1's partials merged, bit for bit
                    assert_same_bits(f"scale fused_topk batch {batch} top-{k} against kernel 1", got,
                                     to.merge_partials(*k1_partials, k))
            ms, pms, bound, by, lib_ms, (a, b, c, d) = time_kernel(
                (name, batch, k), lambda: kernel(k), lambda: plain(k), library, moved, ops, unit)
            extra = f", M={len(masks)}" if "grouped" in name else ""
            extra += f", {ranges} ranges of {per} blocks" if name == "fused_topk" else ""
            agree = "" if name.startswith("fast") else f"agrees with the plain version (max |err| {err:.3g}); "
            agree += "identical to kernel 1 + merge_partials; " if name == "fused_topk" else ""
            log(f"[scale] {name} batch {batch} top-{k}{extra} at {rows}x{dim}: " + agree
                + f"kernel {ms:.3f} ms, plain {pms:.3f} ms (kernel {a:.3f}/{b:.3f}, plain {c:.3f}/{d:.3f}); "
                f"bound {bound:.3f} ms by {by} ({moved / 1e9:.3f} GB, {ops / 1e12:.3f} T{unit} ops); "
                f"library {lib_ms:.3f} ms (cuBLAS product + torch.topk)")
        # kernels 1, 2 and 3 at k = 1 against k = 50: the share of their selection
        for name in ("block_topk", "int8_block_topk") + (("fast_block_topk",) if batch == 128 else ()):
            k1_ms = cuda_ms(lambda: runs[name][0](1), reps=3)
            k50_ms = _TIMES[(name, batch, k)][0]
            log(f"[scale] {name} batch {batch} at {rows}x{dim}: k=1 {k1_ms:.3f} ms, k={k} {k50_ms:.3f} ms: "
                f"selection of top-{k} adds {k50_ms - k1_ms:.3f} ms ({(k50_ms - k1_ms) / k50_ms:.0%})")
        if batch <= 128:
            # what the searches spend after the scan: phase B (kernel 1's
            # partials merged by a stable sort) and the int8 tier's merge to
            # its pool of 2k and exact rescore (rescore_pool)
            part1 = runs["block_topk"][0](k)
            part2 = runs["int8_block_topk"][0](k)
            merge_ms = cuda_ms(lambda: to.merge_partials(*part1, k), reps=3)
            pool_ms = cuda_ms(lambda: to.rescore_pool(*part2, store._device, qb, k, cand=2 * k, metric="ip"), reps=3)
            log(f"[scale] batch {batch} top-{k} after the scan: merge_partials of kernel 1's [{batch}, {nb}, {k}] "
                f"partials {merge_ms:.3f} ms; rescore_pool of kernel 2's [{batch}, {nb8}, {k}] partials (pool "
                f"{2 * k}, exact bf16 rows) {pool_ms:.3f} ms")
        # the whole search through each impl, host to host: kernel 1 + torch
        # merge (auto), the int8 tier (kernel 2 + rescore_pool), kernel 3 +
        # merge + rescore, kernel 4 with its merge on the card
        q_host = qb.cpu().numpy()
        times = {impl: cuda_ms(lambda impl=impl: store.search(q_host, k, impl=impl), reps=3)
                 for impl in ("auto", "int8", "pallas_fast", "pallas_fused")}
        log(f"[scale] store.search batch {batch} top-{k}, host to host: "
            + ", ".join(f"{impl} {ms:.3f} ms" for impl, ms in times.items())
            + f"; int8 against auto {times['int8'] / times['auto']:.3f}x")
    # the int8 tier's recall against the exact scan (kernel 1), 128 random
    # unit queries: on unit rows of no structure the neighbours' scores lie
    # close together, the hard case for a quantized nomination
    q_host = _unit_rows(128, dim, gen, torch.float32).cpu().numpy()
    recall = {}
    for kk in (10, 50):
        got = store.search(q_host, kk, impl="int8")[1]
        want = store.search(q_host, kk, impl="auto")[1]
        recall[kk] = float(np.mean([len(set(g.tolist()) & set(w.tolist())) / kk for g, w in zip(got, want)]))
    log(f"[scale] int8 tier against the exact scan, 128 random queries at {rows}x{dim}: recall@10 "
        f"{recall[10]:.4f} (k 10: kloc 10, pool 32), recall@50 {recall[50]:.4f} (k 50: kloc 50, pool 100)")


# ---------------------------------------------------------------------------
# phase 5: VECTOR_INDEX_TYPE=ivf at 1M x 1536
# ---------------------------------------------------------------------------


def _intrinsic_rows(rows, dim, gen, intrinsic=32):
    """Unit bf16 rows ``normalize(z @ B)``, ``z ~ N(0, I)`` of width
    ``intrinsic`` and ``B`` a Gaussian ``[intrinsic, dim]`` basis over
    sqrt(intrinsic), made on the card in chunks (the corpus of
    ``tools/recall_eval.py``); returns the rows and the basis."""
    import torch

    from photo_search_engine_tpu_torch.ops import topk as to

    basis = torch.randn((intrinsic, dim), generator=gen, device=DEVICE) / intrinsic ** 0.5
    corpus = torch.empty((rows, dim), dtype=torch.bfloat16, device=DEVICE)
    for start in range(0, rows, 131072):
        stop = min(rows, start + 131072)
        z = torch.randn((stop - start, intrinsic), generator=gen, device=DEVICE)
        corpus[start:stop] = to.l2_normalize(z @ basis).to(torch.bfloat16)
    return corpus, basis


def phase_ivf(rows: int = 1_000_000, dim: int = 1536) -> None:
    import numpy as np
    import torch

    from photo_search_engine_tpu_torch.ops import topk as to

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    corpus, basis = _intrinsic_rows(rows, dim, gen)
    rng = np.random.default_rng(SEED + 3)
    # held-out queries: rows perturbed inside the corpus's subspace
    picks = torch.from_numpy(rng.choice(rows, size=128, replace=False)).to(DEVICE)
    noise = torch.randn((128, basis.shape[0]), generator=gen, device=DEVICE) @ basis
    queries = to.l2_normalize(corpus[picks].float() + 0.1 * noise).cpu().numpy()
    mask = rng.random(rows) < 0.25  # a filter keeping about a quarter of the rows
    metadata = _metadata(rows)
    # 128 more held-out queries, drawn after the others, for kernel 7's batch-256 times
    picks = torch.from_numpy(rng.choice(rows, size=128, replace=False)).to(DEVICE)
    noise = torch.randn((128, basis.shape[0]), generator=gen, device=DEVICE) @ basis
    timing = np.concatenate([queries, to.l2_normalize(corpus[picks].float() + 0.1 * noise).cpu().numpy()])
    torch.cuda.synchronize()
    log(f"[ivf] {rows} x {dim} bf16 rows of intrinsic dimension 32 on the card, 128 held-out queries (and 128 "
        f"more for batch 256), in {time.perf_counter() - t0:.1f} s")
    for quantized in ("0", "1"):
        _ivf_tier(corpus, metadata, queries, mask, quantized, timing)


def _ivf_tier(corpus, metadata, queries, mask, quantized: str, timing) -> None:
    import numpy as np
    import torch

    from photo_search_engine_tpu_torch.api.app import create_app, initialize_services, load_config
    from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
    from photo_search_engine_tpu_torch.ops import ivf_scan as io_
    from photo_search_engine_tpu_torch.ops import topk as to
    from tests.torch_parity import plain_scan

    demo = _demo()
    device = torch.device(DEVICE)
    rows, dim = corpus.shape
    tier = "int8" if quantized == "1" else "exact"
    with tempfile.TemporaryDirectory(prefix="pse_ivf_") as tmp:
        config = load_config({
            "DATA_DIR": tmp, "RUNTIME_DATA_DIR": tmp, "PSE_PLATFORM": "gpu", "VECTOR_INDEX_TYPE": "ivf",
            "IVF_NLIST": "1024", "IVF_NPROBE": "64", "STORE_QUANTIZED": quantized,
            "SEARCH_MICROBATCH_ENABLED": "1", "KEYWORD_BACKEND": "none",
            "EMBEDDING_DIMENSION": str(dim), "TOP_K": "10",
            "QUERY_EXPANSION_ENABLED": "0", "QUERY_CACHE_ENABLED": "0", "EMBEDDING_CACHE_ENABLED": "0",
        })
        index = VectorIndex(
            dimension=dim, index_path=os.path.join(tmp, "ivf.index"), metadata_path=os.path.join(tmp, "ivf-meta.json"),
            metric="cosine", index_type=config["VECTOR_INDEX_TYPE"], store_dtype="bfloat16",
            ivf_nlist=config["IVF_NLIST"], ivf_nprobe=config["IVF_NPROBE"],
            ivf_target_recall=config["IVF_TARGET_RECALL"], quantized=config["STORE_QUANTIZED"], device=device,
        )
        index.load_device_rows(corpus, metadata)
        services = initialize_services(config, device=device, vector_index=index)
        batcher = index._microbatcher
        server, port = _serve(create_app(services))
        base = f"http://127.0.0.1:{port}"
        try:
            reset_launches()
            # the first routed search (through the micro-batcher) builds the IVF
            t = time.perf_counter()
            first = index.search(queries[0], 10)
            built = time.perf_counter() - t
            ivf = index._ivf
            parts = ", ".join(f"{name} {sec:.2f} s" for name, sec in ivf.build_seconds.items())
            log(f"[ivf] STORE_QUANTIZED={quantized}: the first routed search built the IVF in {built:.1f} s "
                f"(nlist {ivf.nlist}, L {ivf.capacity}, {ivf.nlist * ivf.capacity} slots; {parts}; the rest is the "
                f"host snapshot and the search) and returned {len(first)} hits; "
                f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
            latency = {}

            def image_search(i):
                t = time.perf_counter()
                _results("ivf /search_by_image", demo._post(base, "/search_by_image",
                                                            {"image_path": f"/photos/{i}.jpg", "top_k": 10}))
                latency[i] = 1e3 * (time.perf_counter() - t)

            before = (batcher.batches_run, batcher.grouped_batches_run, batcher.requests_served)
            t = time.perf_counter()
            run_threads(image_search, [(int(i),) for i in np.random.default_rng(SEED + 4).integers(0, rows, 32)])
            wall = time.perf_counter() - t
            (b, _, r), _ = _batch_delta(batcher, before)
            ms = sorted(latency.values())
            log(f"[ivf] 32 concurrent /search_by_image ({tier}, candidate_k 50, route {index.last_route}): "
                f"{wall:.2f} s wall, request ms p50 {ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}; "
                f"{r} searches in {b} batches (mean batch {r / max(b, 1):.2f})")
            t = time.perf_counter()
            hits = _results("ivf /search_photos", demo._post(base, "/search_photos", {"query": "海边 日落", "top_k": 10}),
                            allow_empty=True)
            route = dict(index.last_route)
            log(f"[ivf] /search_photos '海边 日落' (candidate_k 500, route {route}): {hits} results in "
                f"{1e3 * (time.perf_counter() - t):.1f} ms")
            index.search_batch(queries[:4], 50, mask=mask)
            masked_route = dict(index.last_route)
            launches = read_launches()
        finally:
            server.shutdown()
            server.server_close()
            close_batchers(services)
        log(f"[ivf] route launches {launches}; masked search_batch route {masked_route}; "
            f"micro-batcher: batches_run {batcher.batches_run}, grouped_batches_run {batcher.grouped_batches_run}, "
            f"requests_served {batcher.requests_served}")
        if launches["ivf_block_topk"] <= 0:
            raise AssertionError(f"STORE_QUANTIZED={quantized}: the IVF routes never launched ivf_block_topk")
        if io_.ivf_scoring_loop(*index._ivf._kernel_layout(50)) != "tensor_core":
            raise AssertionError(f"STORE_QUANTIZED={quantized}: by the loop rule kernel 7 is off the tensor cores "
                                 "at k 50")
        if route["impl"] != "ivf" or masked_route["impl"] != "ivf_masked":
            raise AssertionError(f"IVF routes: {route}, {masked_route}")
        _LAUNCHES["ivf_block_topk"] += launches["ivf_block_topk"]

        # the searches against the same searches with kernel 7's plain
        # version, under the same probes (the reference at k + 1: its last
        # column is the cut)
        for k, m, what in ((10, None, "image"), (500, None, "search_photos"), (50, mask, "masked")):
            got = index.raw_search_batch(queries[:4], k, mask=m)
            with plain_scan(io_, "ivf_block_topk"):
                ref = index.raw_search_batch(queries[:4], k + 1, mask=m)
            err = check_topk(f"ivf {tier} {what} k={k}", *got, *ref)
            _ERRORS["ivf_block_topk"] = max(_ERRORS["ivf_block_topk"], err)
        # recall@10 of the IVF route at nprobe 64 against the flat exact scan (kernel 1)
        _, got = index.raw_search_batch(queries, 10)
        q16 = torch.from_numpy(queries).to(device).to(torch.bfloat16)
        _, want = to.exact_search(index._store._device, q16, 10, count=index._store.count, metric="ip")
        want = want.cpu().numpy()
        recall = float(np.mean([len(set(g.tolist()) & set(w.tolist())) / 10 for g, w in zip(got, want)]))
        _IVF_RECALL[tier] = recall
        log(f"[ivf] {tier}: results agree with kernel 7's plain version under the same probes (k 10, 500, "
            f"masked 50; max |err| {_ERRORS['ivf_block_topk']:.3g}); recall@10 at nprobe 64 against the flat "
            f"exact scan (kernel 1), 128 held-out queries: {recall:.4f}")

        _ivf_kernel_times(ivf, timing, quantized == "1", rows)
        # the micro-batcher's closures and the index refer to each other:
        # collect the cycle, so that the next tier starts from free memory
        del index, services, ivf, batcher
        gc.collect()
        torch.cuda.empty_cache()


def _ivf_kernel_times(ivf, timing, int8: bool, rows: int) -> None:
    """Kernel 7 at the ivf phase's shapes (batches 1, 8, 128 and 256 of
    the held-out queries ``timing``, nprobe 64, top-50; the int8 tier
    nominates 64) on the layout's ring (the tensor cores for bf16 and int8,
    the f32 ring for float32), each checked against its plain version and
    timed against it, its bound and the library composition; then
    ``IVFIndex.search`` host to host at batches 1 and 128."""
    import torch

    from photo_search_engine_tpu_torch.ops import ivf_scan as io_

    device, dim = ivf._corpus.device, timing.shape[1]
    # kernel 7 against its plain version at the main-path shapes, then
    # their times (CUDA events; plain, kernel, kernel, plain).  The
    # wrapper's time includes the work list (torch.sort, the group
    # kernel) and the query gather, which the path pays on every call;
    # nothing is read back to the host.
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    f32 = ivf._corpus.dtype == torch.float32
    for batch in (1, 8, 128, 256):
        qb = torch.from_numpy(timing[:batch]).to(device).to(ivf._corpus.dtype).contiguous()
        probes = ivf._probe(qb, 64)
        if int8:
            ivf._ensure_quantized()
            q8, qs = io_.quantize_ivf_queries(qb.float())
            args = (ivf._corpus_i8, q8, probes, ivf._row_valid)
            kw = dict(lrows=ivf.capacity, metric="ip", qscales=qs, cscales=ivf._cscales)
            kk, name = 64, "ivf_block_topk int8"  # top-50 nominates min(2k, 64) = 64
        else:
            args, kw, kk = (ivf._corpus, qb, probes, ivf._row_valid), dict(lrows=ivf.capacity, metric="ip"), 50
            name = "ivf_block_topk f32" if f32 else "ivf_block_topk"
        loop = io_.ivf_scoring_loop(args[0], kk)
        bn, bq = io_.ivf_geometry(batch, 64, ivf.nlist, ivf.capacity, loop, sms)
        kw["block_n"] = bn  # the plain version takes the kernel's tile
        before = read_launches()["ivf_block_topk"]
        kernel = lambda: io_.ivf_block_topk(*args, kk, **kw)  # noqa: E731
        plain = lambda kk_=kk: io_.ivf_block_topk_plain(*args, kk_, **kw)  # noqa: E731
        err = check_partials(f"{name} batch {batch}", kernel(), plain, kk, exact=int8)
        _ERRORS["ivf_block_topk"] = max(_ERRORS["ivf_block_topk"], err)
        pairs = batch * probes.shape[1]
        probed = torch.unique(probes).numel()  # clusters read, each once
        tiles = -(-ivf.capacity // bn)
        row_bytes = dim * args[0].element_size()
        rows_moved, padded, scored = ivf_scan_work(ivf._row_valid, ivf.nlist, ivf.capacity, probes, row_bytes)
        rest = nbytes(*args[1:3]) + pairs * tiles * kk * 8  # queries, probes, partials
        moved = rows_moved + rest
        gflop = 2 * scored * dim / 1e9
        unit = "int8" if int8 else "f32" if f32 else "bf16"
        padded_bound = bound_ms(padded + rest, 2.0 * pairs * ivf.capacity * dim, unit)[0]
        library, lib_label = _ivf_library(ivf, probes, qb, int8)
        ms, pms, bound, by, lib_ms, (a, b, c, e) = time_kernel(
            (name, batch, 50), kernel, plain, library, moved, gflop * 1e9, unit, reps=5)
        launched = read_launches()["ivf_block_topk"] - before
        if launched <= 0:
            raise AssertionError(f"{name} batch {batch}: kernel 7 never launched")
        groups = io_.ivf_work_list(probes, ivf.nlist, bq)[0]  # on the card; read here for the log only
        live = int((groups[:, 2] > 0).sum())
        fill = (f"{live} groups of up to {bq} pairs (bound {groups.shape[0]}), {pairs / (live * bq):.0%} full, "
                f"{tiles} tiles of {bn} slots a cluster")
        gbytes = scored * row_bytes / 1e9  # the pairs' live rows, counted per pair
        lib = "none" if lib_ms is None else f"{lib_ms:.3f} ms ({lib_label})"
        log(f"[ivf] {name} batch {batch} top-50 (nprobe 64, {pairs} probe pairs in {fill}: {gbytes:.2f} GB of "
            f"live probed rows, {gflop:.1f} GFLOP) at {rows}x{dim}: agrees with the plain version (max |err| "
            f"{err:.3g}); kernel {ms:.3f} ms ({gbytes / ms:.1f} TB/s over the pairs' live rows, {gflop / ms:.2f} "
            f"TFLOP/s), plain {pms:.3f} ms (kernel {a:.3f}/{b:.3f}, plain {c:.3f}/{e:.3f}); bound {bound:.3f} ms "
            f"by {by} (the live rows of the {probed} clusters read, {moved / 1e9:.3f} GB; {padded_bound:.3f} ms "
            f"counting their padding slots, {(padded + rest) / 1e9:.3f} GB); library {lib}; {launched} launches on "
            f"the {loop} loop")
    # the search host to host (IVFIndex.search: probe, kernel 7, merge or rescore, download)
    times = {batch: cuda_ms(lambda b=batch: ivf.search(timing[:b], 50, nprobe=64), reps=3) for batch in (1, 128)}
    log(f"[ivf] {'int8' if int8 else 'f32' if f32 else 'exact'} IVFIndex.search top-50 nprobe 64, host to host: "
        + ", ".join(f"batch {b} {t:.3f} ms" for b, t in times.items()))


def _ivf_library(ivf, probes, qb, int8: bool, chunk: int = 8):
    """Kernel 7's nearest library composition, a yardstick timed here and
    never called by the port: each query's probed clusters gathered, a
    cuBLAS product (int8: ``torch._int_mm`` with the query padded past 16
    rows, then the query and row scales), -inf on padding slots, then
    ``torch.topk``.  The gathered rows of a whole batch would not fit at
    once, so a batch goes in chunks of ``chunk`` queries (int8: one query a
    product), whose times are summed ("chunked").  Returns the callable and
    its label."""
    import torch

    from photo_search_engine_tpu_torch.ops import ivf_scan as io_

    nq, dim = qb.shape
    pr = probes.long()
    valid = ivf._row_valid.view(ivf.nlist, ivf.capacity)
    label = ("gather, torch._int_mm, scales, torch.topk" if int8 else "gather, cuBLAS product, torch.topk") + (
        f"; chunked, {1 if int8 else chunk} queries a chunk" if nq > 1 else "")
    if int8:
        layout = ivf._corpus_i8.view(ivf.nlist, ivf.capacity, dim)
        cscales = ivf._cscales.view(ivf.nlist, ivf.capacity)
        q8, qs = io_.quantize_ivf_queries(qb.float())
        qpad = torch.zeros((nq, 32, dim), dtype=torch.int8, device=qb.device)
        qpad[:, 0] = q8

        def one(i):
            acc = torch._int_mm(qpad[i], layout[pr[i]].reshape(-1, dim).T)[0]
            scores = acc.float() * qs[i] * cscales[pr[i]].reshape(-1)
            return torch.topk(torch.where(valid[pr[i]].reshape(-1) > 0, scores, float("-inf")), 50)

        return (lambda: [one(i) for i in range(nq)]), label
    layout = ivf._corpus.view(ivf.nlist, ivf.capacity, dim)

    def chunks():
        out = []
        for s in range(0, nq, chunk):
            p = pr[s:s + chunk]
            scores = torch.bmm(layout[p].reshape(p.shape[0], -1, dim), qb[s:s + chunk, :, None])[..., 0]
            out.append(torch.topk(torch.where(valid[p].reshape(p.shape[0], -1) > 0, scores.float(),
                                              float("-inf")), 50))
        return out

    return chunks, label


# ---------------------------------------------------------------------------
# phase f32: STORE_DTYPE=float32 at 1M x 1536 (the f32 ring)
# ---------------------------------------------------------------------------

_F32_FLAT = ("block_topk", "grouped_block_topk", "fast_block_topk", "fast_grouped_block_topk", "fused_topk")
_F32_LAUNCHES = {}  # kernel: launches of the f32 phase's routes, all on the f32 ring


def phase_f32(rows: int = 1_000_000, dim: int = 1536) -> None:
    """STORE_DTYPE=float32: a ``rows`` x ``dim`` float32 store (made on the
    card from a seed) served by the app's wiring, micro-batcher on, no
    keyword index: concurrent /search_by_image (kernel 1), concurrent
    search_masked over five predicates (kernel 5), the store's impl routes
    (kernels 3, 4 and grouped 3), every launch on the f32 ring; the results
    against plain searches; each kernel's time against its plain version,
    bound and library at batches 1, 8, 128 and 256, and ``store.search`` host
    to host; then a float32 IVF (nlist 1024, nprobe 64) on rows of intrinsic
    dimension 32: built by its first routed search, kernel 7 on the f32 ring,
    timed as phase ``ivf`` times it."""
    import numpy as np
    import torch

    from photo_search_engine_tpu_torch.api.app import create_app, initialize_services, load_config
    from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
    from photo_search_engine_tpu_torch.ops import topk as to
    from tests.torch_parity import assert_same_bits, plain_scan

    torch.backends.cuda.matmul.allow_tf32 = False  # the library yardstick at full precision, as the kernels
    demo = _demo()
    device = torch.device(DEVICE)
    with tempfile.TemporaryDirectory(prefix="pse_f32_") as tmp:
        t0 = time.perf_counter()
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
        corpus = torch.empty((rows, dim), dtype=torch.float32, device=DEVICE)
        for start in range(0, rows, 131072):
            corpus[start:start + 131072] = _unit_rows(min(131072, rows - start), dim, gen, torch.float32)
        index = VectorIndex(
            dimension=dim, index_path=os.path.join(tmp, "f32.index"), metadata_path=os.path.join(tmp, "f32-meta.json"),
            metric="cosine", store_dtype="float32", quantized=False, device=device,
        )
        index.load_device_rows(corpus, _metadata(rows))
        del corpus
        store = index._store
        torch.cuda.synchronize()
        log(f"[f32] {rows} x {dim} float32 rows on the card ({store._device.dtype}, scoring loop "
            f"{to.scoring_loop(store._device)}), season metadata on the host, in {time.perf_counter() - t0:.1f} s")
        if to.scoring_loop(store._device) != "fma_ring":
            raise AssertionError("f32: by the loop rule the store's rows are off the f32 ring")
        config = load_config({
            "DATA_DIR": tmp, "RUNTIME_DATA_DIR": tmp, "PSE_PLATFORM": "gpu", "STORE_DTYPE": "float32",
            "STORE_QUANTIZED": "0", "SEARCH_MICROBATCH_ENABLED": "1", "KEYWORD_BACKEND": "none",
            "EMBEDDING_DIMENSION": str(dim), "TOP_K": "10",
            "QUERY_EXPANSION_ENABLED": "0", "QUERY_CACHE_ENABLED": "0", "EMBEDDING_CACHE_ENABLED": "0",
        })
        services = initialize_services(config, device=device, vector_index=index)
        batcher = index._microbatcher
        server, port = _serve(create_app(services))
        base = f"http://127.0.0.1:{port}"
        rng = np.random.default_rng(SEED + 5)
        picks = [int(x) for x in rng.integers(0, rows, size=32)]
        masks = [rng.random(rows) < frac for frac in (0.5, 0.25, 0.05, 0.001, 0.0)]
        filtered_q = _unit_rows(64, dim, gen, torch.float32).cpu().numpy()
        impl_q = {b: _unit_rows(b, dim, gen, torch.float32).cpu().numpy() for b in (1, 128)}
        table = np.stack(masks)
        ids = (np.arange(128) % len(masks)).astype(np.int32)
        filtered = {}
        try:
            reset_launches()
            t = time.perf_counter()
            run_threads(lambda i: _results("f32 /search_by_image", demo._post(
                base, "/search_by_image", {"image_path": f"/photos/{i}.jpg", "top_k": 10})), [(i,) for i in picks])
            image_wall = time.perf_counter() - t
            t = time.perf_counter()
            run_threads(lambda i: filtered.__setitem__(i, index.search_masked(filtered_q[i], 50, masks[i % len(masks)])),
                        [(i,) for i in range(len(filtered_q))])
            masked_wall = time.perf_counter() - t
            got = {(impl, b): store.search(impl_q[b], 50, impl=impl) for b in (1, 128)
                   for impl in ("pallas", "pallas_fast", "pallas_fused")}
            got[("grouped", 128)] = store.grouped_search(impl_q[128], 50, table, ids, impl="pallas_fast")
            launches = read_launches()
        finally:
            server.shutdown()
            server.server_close()
            close_batchers(services)
        log(f"[f32] 32 concurrent /search_by_image {image_wall:.2f} s wall; 64 concurrent search_masked(k=50) over "
            f"{len(masks)} predicates {masked_wall:.2f} s wall; micro-batcher: batches_run {batcher.batches_run}, "
            f"grouped_batches_run {batcher.grouped_batches_run}, requests_served {batcher.requests_served}; store "
            f"impl routes pallas / pallas_fast / pallas_fused at batch 1 and 128, grouped pallas_fast at 128")
        log(f"[f32] route launches {launches} (all on the f32 ring)")
        for name in _F32_FLAT:
            if launches[name] <= 0:
                raise AssertionError(f"f32 routes never launched {name}")
            _LAUNCHES[name] += launches[name]
            _F32_LAUNCHES[name] = launches[name]

        # results against plain searches: the filtered ones per query under
        # its predicate, the image searches' own rows first, kernel 4 bit for
        # bit kernel 1, kernel 3 against the same search on its plain version
        live = store._device[: store.count]
        norms = np.linalg.norm(filtered_q, axis=1, keepdims=True)
        queries = torch.from_numpy(filtered_q / np.maximum(norms, 1e-30)).to(device)
        got_f = [_hits_to_topk(filtered[i], 50) for i in range(len(filtered_q))]
        ref = [to.exact_search_plain(live, queries[i:i + 1], 51, metric="ip",
                                     mask=torch.from_numpy(masks[i % len(masks)]).to(device).to(torch.int8))
               for i in range(len(filtered_q))]
        err = check_topk("f32 filtered search", torch.from_numpy(np.stack([g[0] for g in got_f])).to(device),
                         torch.from_numpy(np.stack([g[1] for g in got_f])).to(device),
                         torch.cat([r[0] for r in ref]), torch.cat([r[1] for r in ref]))
        _ERRORS["grouped_block_topk"] = max(_ERRORS["grouped_block_topk"], err)
        rq = torch.from_numpy(np.stack([store.reconstruct(i) for i in picks[:4]])).to(device)
        dists, idx = index.raw_search_batch(rq.cpu().numpy(), 50)
        ref_v, ref_i = to.exact_search_plain(live, rq, 51, metric="ip")
        _ERRORS["block_topk"] = max(_ERRORS["block_topk"], check_topk(
            "f32 image search", torch.from_numpy(dists).to(device), torch.from_numpy(idx).to(device), ref_v, ref_i))
        if idx[:, 0].tolist() != picks[:4]:
            raise AssertionError("f32 image search: a query row is not its own nearest neighbour")
        for b in (1, 128):
            assert_same_bits(f"f32 fused search batch {b} against kernel 1",
                             tuple(torch.from_numpy(x) for x in got[("pallas_fused", b)]),
                             tuple(torch.from_numpy(x) for x in got[("pallas", b)]))
        with plain_scan(to, "fast_block_topk"):
            ref = store.search(impl_q[128], 50, impl="pallas_fast")
        qn = torch.from_numpy(impl_q[128] / np.linalg.norm(impl_q[128], axis=1, keepdims=True)).to(device)
        scores = _chunked_ip_scores(live, qn)
        _ERRORS["fast_block_topk"] = max(_ERRORS["fast_block_topk"], check_fast(
            "f32 fast search batch 128", *(torch.from_numpy(x).to(device) for x in (*got[("pallas_fast", 128)], *ref)),
            scores))
        del scores
        log("[f32] results agree with plain searches (filtered under each predicate, image searches with their own "
            "rows first); pallas_fused bit for bit kernel 1's; pallas_fast agrees with its plain version")
        f32_kernel_times(store, masks, gen)
        del index, services, batcher, store, live
        gc.collect()
        torch.cuda.empty_cache()
    f32_ivf(rows, dim)


def f32_kernel_times(store, masks, gen) -> None:
    """The f32 kernels 1, 3, 4, 5 and grouped 3 at batches 1, 8, 128 and
    256, top-50, on the store's rows: each against its plain version (the
    partials of kernels 1, 4 and 5 at k + 1, kernel 3's through the search
    above), its time (plain, kernel, kernel, plain), bound and library
    (cuBLAS float32 product, TF32 off, then torch.topk), every launch on
    the f32 ring; then ``store.search`` host to host."""
    import numpy as np
    import torch

    from photo_search_engine_tpu_torch.ops import grouped_mask as go
    from photo_search_engine_tpu_torch.ops import topk as to

    device, (cap, dim) = store._device.device, store._device.shape
    rows, corpus = store.count, store._device
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    table = torch.zeros((len(masks), cap), dtype=torch.int8, device=device)
    table[:, :rows] = torch.from_numpy(np.stack(masks)).to(device)
    kw = dict(count=rows, metric="ip", block_n=store.block_rows)
    kg = dict(count=rows, block_n=store.block_rows)
    nb = -(-cap // store.block_rows)
    k = 50
    for batch in (1, 8, 128, 256):
        qb = _unit_rows(batch, dim, gen, torch.float32)
        ids = (torch.arange(batch, device=device) % len(masks)).to(torch.int32)
        per = to.fused_ranges(batch, nb, sms, block_n=store.block_rows, k=k, loop=to.scoring_loop(corpus))[1]
        ranges = -(-nb // per)
        dense = lambda: torch.matmul(qb, corpus.T)  # noqa: E731
        keep = lambda: table[ids.long()] > 0  # noqa: E731
        moved = nbytes(corpus, qb) + batch * nb * k * 8
        flops = 2.0 * batch * cap * dim
        runs = {  # name: (kernel, plain, library, bytes moved)
            "block_topk": (lambda kk: to.block_topk(corpus, qb, kk, **kw),
                           lambda kk: to.exact_block_topk_plain(corpus, qb, kk, **kw),
                           lambda: torch.topk(dense(), k), moved),
            "fast_block_topk": (lambda kk: to.fast_block_topk(corpus, qb, kk, **kw),
                                lambda kk: to.fast_block_topk_plain(corpus, qb, kk, **kw),
                                lambda: torch.topk(dense(), k), moved),
            "fused_topk": (lambda kk: to.fused_topk(corpus, qb, kk, blocks_per_range=per, **kw)[:2],
                           lambda kk: to.fused_topk_plain(corpus, qb, kk, blocks_per_range=per, **kw)[:2],
                           lambda: torch.topk(dense(), k), nbytes(corpus, qb) + batch * (ranges + 1) * k * 8),
            "grouped_block_topk": (lambda kk: go.grouped_block_topk(corpus, qb, table, ids, kk, **kg),
                                   lambda kk: go.grouped_block_topk_plain(corpus, qb, table, ids, kk, **kg),
                                   lambda: torch.topk(torch.where(keep(), dense(), float("-inf")), k),
                                   moved + nbytes(table, ids)),
            "fast_grouped_block_topk": (lambda kk: go.fast_grouped_block_topk(corpus, qb, table, ids, kk, **kg),
                                        lambda kk: go.fast_grouped_block_topk_plain(corpus, qb, table, ids, kk, **kg),
                                        lambda: torch.topk(torch.where(keep(), dense(), float("-inf")), k),
                                        moved + nbytes(table, ids)),
        }
        for name, (kernel, plain, library, moved_bytes) in runs.items():
            err = 0.0
            if not name.startswith("fast"):
                err = check_topk(f"f32 {name} batch {batch} top-{k}", *kernel(k), *plain(k + 1))
                _ERRORS[name] = max(_ERRORS[name], err)
            ms, pms, bound, by, lib_ms, (a, b, c, d) = time_kernel(
                (name + " f32", batch, k), lambda: kernel(k), lambda: plain(k), library, moved_bytes, flops, "f32")
            agree = "" if name.startswith("fast") else f"agrees with the plain version (max |err| {err:.3g}); "
            log(f"[f32] {name} f32 batch {batch} top-{k} at {rows}x{dim}: " + agree
                + f"kernel {ms:.3f} ms, plain {pms:.3f} ms (kernel {a:.3f}/{b:.3f}, plain {c:.3f}/{d:.3f}); bound "
                f"{bound:.3f} ms by {by} ({moved_bytes / 1e9:.3f} GB, {flops / 1e12:.3f} T f32 ops); library "
                f"{lib_ms:.3f} ms (cuBLAS f32, TF32 off, + torch.topk)"
                + (f"; {ranges} ranges of {per} blocks" if name == "fused_topk" else ""))
        k1_ms = cuda_ms(lambda: runs["block_topk"][0](1), reps=3)  # the selection's share
        k50_ms = _TIMES[("block_topk f32", batch, k)][0]
        log(f"[f32] block_topk f32 batch {batch} at {rows}x{dim}: k=1 {k1_ms:.3f} ms, k={k} {k50_ms:.3f} ms: "
            f"selection of top-{k} adds {k50_ms - k1_ms:.3f} ms ({(k50_ms - k1_ms) / k50_ms:.0%})")
        q_host = qb.cpu().numpy()
        times = {impl: cuda_ms(lambda impl=impl: store.search(q_host, k, impl=impl), reps=3)
                 for impl in ("auto", "pallas_fast", "pallas_fused")}
        log(f"[f32] store.search batch {batch} top-{k}, host to host: "
            + ", ".join(f"{impl} {ms:.3f} ms" for impl, ms in times.items()))


def f32_ivf(rows: int, dim: int) -> None:
    """A float32 IVF (nlist 1024, nprobe 64) over ``rows`` unit rows of
    intrinsic dimension 32: the first routed search builds it; kernel 7 on
    the f32 ring against its plain version and timed (``_ivf_kernel_times``)."""
    import numpy as np
    import torch

    from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
    from photo_search_engine_tpu_torch.ops import ivf_scan as io_
    from photo_search_engine_tpu_torch.ops import topk as to

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    corpus, basis = _intrinsic_rows(rows, dim, gen)
    corpus = corpus.float()
    rng = np.random.default_rng(SEED + 6)
    picks = torch.from_numpy(rng.choice(rows, size=256, replace=False)).to(DEVICE)
    noise = torch.randn((256, basis.shape[0]), generator=gen, device=DEVICE) @ basis
    timing = to.l2_normalize(corpus[picks] + 0.1 * noise).cpu().numpy()
    with tempfile.TemporaryDirectory(prefix="pse_f32_ivf_") as tmp:
        index = VectorIndex(
            dimension=dim, index_path=os.path.join(tmp, "ivf.index"), metadata_path=os.path.join(tmp, "ivf-meta.json"),
            metric="cosine", index_type="ivf", store_dtype="float32", ivf_nlist=1024, ivf_nprobe=64, quantized=False,
            device=torch.device(DEVICE),
        )
        index.load_device_rows(corpus, _metadata(rows))
        del corpus
        reset_launches()
        t = time.perf_counter()
        hits = index.search(timing[0], 10)
        built = time.perf_counter() - t
        launches = read_launches()["ivf_block_topk"]
        ivf = index._ivf
        loop = io_.ivf_scoring_loop(*ivf._kernel_layout(10))
        log(f"[f32] float32 IVF: the first routed search built it in {built:.1f} s (nlist {ivf.nlist}, L "
            f"{ivf.capacity}, {ivf._corpus.dtype}) and returned {len(hits)} hits; kernel 7 launches {launches} on "
            f"the {loop} loop; {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        if launches <= 0 or loop != "fma_ring":
            raise AssertionError(f"f32 IVF search: kernel 7 must run on the f32 ring: {launches} on {loop}")
        _LAUNCHES["ivf_block_topk"] += launches
        _F32_LAUNCHES["ivf_block_topk"] = launches
        _ivf_kernel_times(ivf, timing, False, rows)
        del index, ivf
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: the online profile against a local stand-in server
# ---------------------------------------------------------------------------

_STANDIN_NOTE = ("the stand-in answers in microseconds: these times are the port's host path and the card, "
                 "not a real model's latency")


def _online_env(base_url: str) -> dict:
    """The online profile's keys, every backend at the stand-in."""
    return {
        "EMBEDDING_BASE_URL": base_url, "EMBEDDING_API_KEY": "standin", "EMBEDDING_BACKEND": "openai",
        "TEXT_RERANK_BASE_URL": base_url, "TEXT_RERANK_API_KEY": "standin", "TEXT_RERANK_BACKEND": "api",
        "VISUAL_RERANK_BASE_URL": base_url, "VISUAL_RERANK_API_KEY": "standin",
        "SEARCH_MICROBATCH_ENABLED": "1",
    }


def _post_route(base):
    """``post(path, body, files=None)`` over HTTP, for ``run_online_flow``."""
    demo = _demo()

    def post(path, body, files=None):
        if files:
            (field, (name, content)), = files.items()
            return demo._post_multipart(base, path, body, field, name, content)
        return demo._post(base, path, body)

    return post


def _percentiles(ms):
    ms = sorted(ms)
    return ms[len(ms) // 2], ms[min(len(ms) - 1, int(0.99 * len(ms)))]


def phase_online(rows: int = 1_000_000, dim: int = 1536) -> None:
    from tests.torch_parity import StandInServer

    with StandInServer(dim=dim) as standin:
        log(f"[online] stand-in OpenAI-compatible server at {standin.base_url} (/v1/embeddings, /v1/rerank, "
            f"/v1/chat/completions)")
        online_library(standin)
        online_scale(standin, rows, dim)
        log(f"[online] stand-in calls {standin.calls}")


def online_library(standin) -> None:
    """The PIL photo library of phase 3 indexed through the real Indexer
    with the stand-in's embeddings, then a text search with the API text
    rerank and the visual rerank, the same with the chat text rerank, an
    image search and an upload search with the visual rerank: each
    response must report the reranks it ran."""
    from photo_search_engine_tpu_torch.api.app import (
        _build_text_rerank_service,
        create_app,
        initialize_services,
        load_config,
    )
    from tests.torch_parity import run_online_flow

    demo = _demo()
    with tempfile.TemporaryDirectory(prefix="pse_online_") as tmp:
        env = dict(_app_env(tmp, "0"), **_online_env(standin.base_url))
        services = initialize_services(load_config(env))
        kinds = {key: type(services[key]).__name__
                 for key in ("embedding_service", "text_rerank_service", "visual_rerank_service")}
        if kinds != {"embedding_service": "OpenAICompatibleEmbeddingService",
                     "text_rerank_service": "TextRerankService", "visual_rerank_service": "VisualRerankService"}:
            raise AssertionError(f"online profile: services built {kinds}")
        if services["device"].type != "cuda":
            raise AssertionError(f"online profile served on {services['device']}")
        config = services["config"]
        # the same app with TEXT_RERANK_BACKEND=chat, its rerank made as initialize_services makes it
        chat = dict(services, text_rerank_service=_build_text_rerank_service(
            dict(config, TEXT_RERANK_BACKEND="chat"), services["device"]))
        server, port = _serve(create_app(services))
        chat_server, chat_port = _serve(create_app(chat))
        try:
            base = f"http://127.0.0.1:{port}"
            t = time.perf_counter()
            demo._post(base, "/init_index", {"mode": "full"})
            status = _wait_ready(demo, base, "online profile")
            embeds = dict(standin.calls)
            log(f"[online] library: indexed {status['indexed_count']} photos in {time.perf_counter() - t:.1f} s "
                f"with {embeds['/v1/embeddings']} /v1/embeddings calls")
            reset_launches()
            before = dict(standin.calls)
            out = run_online_flow(_post_route(base), config["PHOTO_DIR"])
            text = demo._post(f"http://127.0.0.1:{chat_port}", "/search_photos",
                              {"query": "beach sunset sea", "top_k": 4, "enable_text_rerank": True})
            launches = read_launches()
        finally:
            for srv in (server, chat_server):
                srv.shutdown()
                srv.server_close()
            close_batchers(services)
        if not (text["status"] == "success" and text["results"] and text["text_reranked"]
                and all("text_rerank_score" in hit for hit in text["results"])):
            raise AssertionError(f"online chat text rerank did not run: {str(text)[:300]}")
        calls = {path: standin.calls[path] - before[path] for path in before}
        if calls["/v1/rerank"] < 1 or calls["/v1/chat/completions"] < 4:
            raise AssertionError(f"online library: the reranks did not reach the stand-in: {calls}")
        log(f"[online] library: text (api text rerank + visual rerank) {len(out['text']['results'])} results, "
            f"chat text rerank {len(text['results'])}, image {len(out['image']['results'])}, upload "
            f"{len(out['upload']['results'])}, each reporting its reranks; stand-in calls {calls}; launches "
            f"{launches}")
        if launches["block_topk"] <= 0:
            raise AssertionError("online library: the image searches never launched block_topk")
        for name in _FLAT:
            _LAUNCHES[name] += launches[name]


def online_scale(standin, rows: int = 1_000_000, dim: int = 1536) -> None:
    """Phase 4's corpus served by the online profile, micro-batcher on, no
    keyword index: 32 concurrent /search_by_image (kernel 1, then kernel 2
    with the int8 tier), 64 concurrent season-filtered searches whose query
    vectors come from the stand-in through the batched embedder (kernels 5
    and 6), each held against the plain scan of the stand-in's vector, and
    32 concurrent /search_photos whose query embeds must reach the stand-in
    as coalesced list calls."""
    import numpy as np
    import torch

    from photo_search_engine_tpu_torch.api.app import create_app, initialize_services, load_config
    from photo_search_engine_tpu_torch.ops import quantized as qo
    from photo_search_engine_tpu_torch.ops import topk as to
    from tests.torch_parity import standin_vector

    demo = _demo()
    device = torch.device(DEVICE)
    with tempfile.TemporaryDirectory(prefix="pse_online_scale_") as tmp:
        index, _ = _scale_index(rows, dim, tmp, "online")
        store = index._store
        if to.scoring_loop(store._device) != "tensor_core" or qo.int8_scoring_loop(dim) != "tensor_core":
            raise AssertionError("online: by the loop rules the store's rows are off the tensor cores")
        config = load_config(dict(_online_env(standin.base_url), **{
            "DATA_DIR": tmp, "RUNTIME_DATA_DIR": tmp, "PSE_PLATFORM": "gpu", "KEYWORD_BACKEND": "none",
            "EMBEDDING_DIMENSION": str(dim), "TOP_K": "10", "QUERY_EXPANSION_ENABLED": "0",
            "QUERY_CACHE_ENABLED": "0", "EMBEDDING_CACHE_ENABLED": "0",
        }))
        services = initialize_services(config, device=device, vector_index=index)
        embedder = services["searcher"].embedding_service
        server, port = _serve(create_app(services))
        base = f"http://127.0.0.1:{port}"
        seasons = np.array([("春天", "夏天", "秋天", "冬天").index(m["time_info"]["season"]) for m in _metadata(rows)])
        masks = [seasons == s for s in range(4)]
        picks = [int(x) for x in np.random.default_rng(SEED + 5).integers(0, rows, size=32)]
        texts = [f"{('春天', '夏天', '秋天', '冬天')[i % 4]} 海边 日落 {i}" for i in range(64)]
        filtered = {}
        try:
            reset_launches()
            for quantized in (False, True):
                tier = "int8" if quantized else "exact"
                index.quantized = quantized
                latency = {}

                def image_search(i):
                    t = time.perf_counter()
                    _results("online /search_by_image", demo._post(
                        base, "/search_by_image", {"image_path": f"/photos/{i}.jpg", "top_k": 10}))
                    latency[i] = 1e3 * (time.perf_counter() - t)

                t = time.perf_counter()
                run_threads(image_search, [(i,) for i in picks])
                wall = time.perf_counter() - t
                p50, p99 = _percentiles(latency.values())
                log(f"[online] 32 concurrent /search_by_image ({tier}): route ms p50 {p50:.1f} p99 {p99:.1f}, "
                    f"wall {wall:.2f} s")

                def filtered_search(i):
                    vec = embedder.generate_embedding(texts[i])
                    filtered[(tier, i)] = index.search_masked(vec, 50, masks[i % 4])

                calls = len(standin.embed_inputs)
                t = time.perf_counter()
                run_threads(filtered_search, [(i,) for i in range(64)])
                wall = time.perf_counter() - t
                sizes = standin.embed_inputs[calls:]
                log(f"[online] 64 concurrent season-filtered searches ({tier}, k 50, query vectors from the "
                    f"stand-in through the batched embedder): wall {wall:.2f} s, {len(sizes)} /v1/embeddings "
                    f"calls (mean batch {sum(sizes) / max(len(sizes), 1):.2f})")

            latency = {}

            def text_search(i):
                t = time.perf_counter()
                _results("online /search_photos", demo._post(
                    base, "/search_photos", {"query": f"海边 日落 照片 {i}", "top_k": 10}), allow_empty=True)
                latency[i] = 1e3 * (time.perf_counter() - t)

            calls = len(standin.embed_inputs)
            t = time.perf_counter()
            run_threads(text_search, [(i,) for i in range(32)])
            wall = time.perf_counter() - t
            sizes = standin.embed_inputs[calls:]
            p50, p99 = _percentiles(latency.values())
            mean = sum(sizes) / max(len(sizes), 1)
            log(f"[online] 32 concurrent /search_photos: 32 requests, {len(sizes)} /v1/embeddings calls (mean "
                f"embed batch {mean:.2f}); route ms p50 {p50:.1f} p99 {p99:.1f}, wall {wall:.2f} s "
                f"({_STANDIN_NOTE})")
            if sum(sizes) < 32 or not mean > 1:
                raise AssertionError(f"online /search_photos: query embeds did not coalesce: {sizes}")
            launches = read_launches()
        finally:
            server.shutdown()
            server.server_close()
            close_batchers(services)
        log(f"[online] route launches {launches} (all on the tensor cores)")
        for name in _FLAT:
            if launches[name] <= 0:
                raise AssertionError(f"online routes never launched {name}")
            _LAUNCHES[name] += launches[name]

        # every filtered result against the plain scan of the stand-in's
        # vector for its text, under its own season; the vectors normalized
        # on the host as the store normalizes cosine queries
        vectors = np.stack([standin_vector(t, dim) for t in texts])
        vectors /= np.maximum(np.linalg.norm(vectors, axis=1, keepdims=True), 1e-30)
        queries = torch.from_numpy(vectors).to(device)
        keep = torch.from_numpy(np.stack([masks[i % 4] for i in range(64)])).to(device)
        live = store._device[: store.count]
        for tier in ("exact", "int8"):
            got = [_hits_to_topk(filtered[(tier, i)], 50) for i in range(64)]
            got_v = torch.from_numpy(np.stack([g[0] for g in got])).to(device)
            got_i = torch.from_numpy(np.stack([g[1] for g in got])).to(device)
            if tier == "int8":
                ref_v, ref_i = _int8_search_reference(store, queries, 51, kloc=50, cand=100, keep=keep)
                name = "int8_grouped_block_topk"
            else:
                ref = [to.exact_search_plain(live, queries[i:i + 1].to(torch.bfloat16), 51, metric="ip",
                                             mask=keep[i].to(torch.int8)) for i in range(64)]
                ref_v, ref_i = torch.cat([r[0] for r in ref]), torch.cat([r[1] for r in ref])
                name = "grouped_block_topk"
            _ERRORS[name] = max(_ERRORS[name], check_topk(f"online filtered search ({tier})", got_v, got_i,
                                                          ref_v, ref_i))
        # the image searches' vector results (exact and int8) against the plain versions
        queries = torch.from_numpy(np.stack([store.reconstruct(i) for i in picks[:4]])).to(device)
        for quantized in (False, True):
            index.quantized = quantized
            dists, idx = index.raw_search_batch(queries.cpu().numpy(), 50)
            got_v, got_i = torch.from_numpy(dists).to(device), torch.from_numpy(idx).to(device)
            if quantized:
                ref_v, ref_i = _int8_search_reference(store, queries, 51, kloc=50, cand=100)
                name = "int8_block_topk"
            else:
                ref_v, ref_i = to.exact_search_plain(live, queries.to(torch.bfloat16), 51, metric="ip")
                name = "block_topk"
            _ERRORS[name] = max(_ERRORS[name], check_topk(f"online image search ({name})", got_v, got_i,
                                                          ref_v, ref_i))
        log("[online] filtered and image searches agree with the plain scans of the stand-in's vectors "
            "(exact and int8)")
        del index, store, live, services
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: the tools (migrate, recall_eval) on the card
# ---------------------------------------------------------------------------


def _fake_faiss_dir(path: str, rows: int, dim: int) -> None:
    """A reference-format corpus: a FAISS flat binary as
    ``tests/test_migrate.py`` fakes one (a junk header, the int64 element
    count, the float32 rows, a junk tail), its sidecar, and a metadata.json
    whose time_info is stringified as the reference stores it.  The rows
    come in bursts of 16 shots of one scene (a photo library's bursts and
    near-duplicates), so that a row's 10th and 11th neighbours are not
    within float32 rounding of each other and exact recall is 1.0 in any
    summation order."""
    import struct

    import numpy as np

    rng = np.random.default_rng(SEED + 7)
    scenes = rng.normal(size=(rows // 16, dim)).astype(np.float32)
    spread = rng.uniform(0.2, 1.0, size=(rows, 1)).astype(np.float32)
    vectors = np.repeat(scenes, 16, axis=0) + spread * rng.normal(size=(rows, dim)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "photo_search.index"), "wb") as f:
        f.write(b"IHNf" + rng.bytes(64))
        f.write(struct.pack("<q", rows * dim))
        f.write(vectors.astype(np.float32).tobytes())
        f.write(rng.bytes(32))
    with open(os.path.join(path, "photo_search.index.meta.json"), "w", encoding="utf-8") as f:
        json.dump({"metric": "cosine", "dimension": dim}, f)
    metadata = [{"photo_path": f"/photos/{i}.jpg", "description": f"burst {i // 16} shot {i % 16}",
                 "time_info": str({"season": _SEASONS[1 + (i * 7) % 12], "year": 2020 + i % 5})}
                for i in range(rows)]
    with open(os.path.join(path, "metadata.json"), "w", encoding="utf-8") as f:
        json.dump(metadata, f, ensure_ascii=False)


def phase_tools(rows: int = 1_000_000, dim: int = 1536, faiss_rows: int = 8192, nlist: int = 1024,
                small_rows: int = 262_144) -> None:
    import numpy as np
    import torch

    from photo_search_engine_tpu_torch.models.ivf import IVFIndex
    from photo_search_engine_tpu_torch.tools import migrate, recall_eval

    if os.environ.get("PSE_PLATFORM", "").strip().lower() not in ("", "gpu", "cuda"):
        raise AssertionError("phase tools runs the tools on their default device: unset PSE_PLATFORM")
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="pse_tools_") as tmp:
        _fake_faiss_dir(os.path.join(tmp, "faiss"), faiss_rows, dim)
        t = time.perf_counter()
        report = migrate.migrate(os.path.join(tmp, "faiss", "photo_search.index"),
                                 os.path.join(tmp, "faiss", "metadata.json"), os.path.join(tmp, "migrated"))
        log(f"[tools] migrate: {report['count']} x {report['dimension']} ({report['metric']}) in "
            f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        got = recall_eval.evaluate(os.path.join(tmp, "migrated"), k=10, nprobe=8)
        log(f"[tools] evaluate in {time.perf_counter() - t:.1f} s: {json.dumps(got)}")
    if got["exact_recall_at_k"] != 1.0:
        raise AssertionError(f"recall_eval.evaluate: exact recall {got['exact_recall_at_k']} is not 1.0")
    if not got["masked_search_checks"] or got["masked_search_correct"] != got["masked_search_checks"]:
        raise AssertionError(f"recall_eval.evaluate: masked checks {got['masked_search_correct']} of "
                             f"{got['masked_search_checks']}")
    evaluated = read_launches()
    for name in ("block_topk", "int8_block_topk", "ivf_block_topk"):
        if evaluated[name] <= 0:
            raise AssertionError(f"recall_eval.evaluate never launched {name}: it did not run on the card")

    t = time.perf_counter()
    synthetic = recall_eval.evaluate_synthetic(rows, dim=dim, intrinsic=32, nlist=nlist,
                                               sweep=[16, 32, 64], sweep_batches=[1, 8, 128])
    seconds = time.perf_counter() - t
    log(f"[tools] evaluate_synthetic {rows} x {dim}, intrinsic 32, nlist {nlist} in {seconds:.1f} s: tuned nprobe "
        f"{synthetic['tuned_nprobe']}, recall@10 against the exact scan (kernel 1) "
        f"{synthetic['recall_at_k_vs_exact']} (phase ivf's at nprobe 64, 128 other held-out queries: "
        f"{_IVF_RECALL or 'not run'}), build {synthetic['ivf_build_seconds']} s, tune {synthetic['tune_seconds']} s, "
        f"batch 8 at the tuned nprobe {synthetic['latency_ms_per_batch']} ms ({synthetic['qps']} QPS)")
    for row in synthetic["sweep"]:
        log(f"[tools]   nprobe {row['nprobe']:3d} batch {row['batch']:3d}: recall@10 {row['recall_at_k']}, "
            f"{row['latency_ms_per_batch']} ms per batch ({row['qps']} QPS; CUDA events, 32 launches of "
            f"device_search_fn)")
    if not synthetic["recall_at_k_vs_exact"] >= 0.5:
        raise AssertionError(f"evaluate_synthetic: recall@10 {synthetic['recall_at_k_vs_exact']}")

    # device_search_fn reads nothing back: one call of each tier under
    # sync debug mode "error", held against IVFIndex.search
    from photo_search_engine_tpu_torch.ops.topk import l2_normalize

    corpus, _ = recall_eval.synthetic_corpus(small_rows, dim, 32, np.random.default_rng(SEED + 8), 0,
                                             torch.device(DEVICE), torch.bfloat16)
    index = IVFIndex.build_on_device(corpus, 256, seed=0)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    picks = torch.randint(0, corpus.shape[0], (64,), generator=gen, device=DEVICE)
    queries = l2_normalize(corpus[picks].float() + 0.05 * torch.randn((64, dim), generator=gen, device=DEVICE))
    del corpus
    for quantized in (False, True):
        index.quantized = quantized
        fn = index.device_search_fn(10, 32, 64)
        before = read_launches()["ivf_block_topk"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            vals, slots = fn(queries)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if read_launches()["ivf_block_topk"] != before + 1:
            raise AssertionError("device_search_fn did not launch kernel 7 once")
        got_d, got_i = index._to_rows(vals.cpu().numpy(), slots.cpu().numpy())
        want_d, want_i = index.search(queries.cpu().numpy(), 10, nprobe=32)
        if not (np.array_equal(got_i, want_i) and np.allclose(got_d, want_d, rtol=0, atol=1e-5)):
            raise AssertionError(f"device_search_fn ({'int8' if quantized else 'bf16'}) differs from IVFIndex.search")
    log(f"[tools] device_search_fn under torch.cuda.set_sync_debug_mode('error'), bf16 and int8 tiers, 64 "
        f"queries at nprobe 32 over {small_rows} x {dim}, nlist 256: no host sync, ids equal to "
        f"IVFIndex.search, values within 1e-5")
    del index
    launches = read_launches()
    log(f"[tools] launches {launches}")
    for name in ("block_topk", "int8_block_topk", "ivf_block_topk"):
        _LAUNCHES[name] += launches[name]
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: the mesh tier
# ---------------------------------------------------------------------------

_MESH_SHARDS = 4
_MESH_KERNELS = ("block_topk", "int8_block_topk", "grouped_block_topk", "int8_grouped_block_topk")


def _counted(name, shards, call):
    """``call()`` with the launch counters set to 0 just before; it must
    have launched kernel ``name`` once per shard and nothing else of the
    mesh's kernels.  The launches go into the JSON line's counts."""
    import torch

    reset_launches()
    out = call()
    torch.cuda.synchronize()
    launches = read_launches()
    want = {n: (shards if n == name else 0) for n in _MESH_KERNELS + ("ivf_block_topk",)}
    got = {n: launches[n] for n in want}
    if got != want:
        raise AssertionError(f"mesh: expected {name} once per shard ({shards}), launches {got}")
    _LAUNCHES[name] += shards
    return out


def _host_ms(fn, reps: int = 3) -> float:
    """Mean host-to-host milliseconds of ``fn`` (results on the host), after a warm-up."""
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t) / reps


def _host_rows(corpus):
    """A device corpus as float32 host rows, in chunks."""
    import numpy as np

    out = np.empty(tuple(corpus.shape), np.float32)
    for start in range(0, corpus.shape[0], 131072):
        out[start : start + 131072] = corpus[start : start + 131072].float().cpu().numpy()
    return out


def phase_mesh(rows: int = 1_000_000, dim: int = 1536) -> None:
    mesh_flat(rows, dim)
    mesh_ivf(rows, dim)
    mesh_app()
    mesh_ranks()


def mesh_flat(rows: int, dim: int) -> None:
    """(a) MeshEmbeddingStore over four shards of the card against the
    single-device EmbeddingStore on the same rows, and against the plain
    per-shard scans."""
    import numpy as np
    import torch

    from photo_search_engine_tpu_torch.core.embedding_store import EmbeddingStore
    from photo_search_engine_tpu_torch.core.mesh_store import MeshEmbeddingStore
    from photo_search_engine_tpu_torch.ops import grouped_mask as go
    from photo_search_engine_tpu_torch.ops import quantized as qo
    from photo_search_engine_tpu_torch.ops import topk as to
    from photo_search_engine_tpu_torch.parallel.sharded import make_mesh
    from tests.torch_parity import plain_scan

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    corpus = torch.empty((rows, dim), dtype=torch.bfloat16, device=DEVICE)
    for start in range(0, rows, 131072):
        stop = min(rows, start + 131072)
        corpus[start:stop] = _unit_rows(stop - start, dim, gen, torch.bfloat16)
    host = _host_rows(corpus)
    queries = _unit_rows(128, dim, gen, torch.float32).cpu().numpy()
    rng = np.random.default_rng(SEED + 5)
    keeps = (0.5, 0.25, 0.05, 0.001, 0.0)
    table = np.stack([rng.random(rows) < frac for frac in keeps]).astype(np.int8)
    log(f"[mesh] {rows} x {dim} bf16 unit rows (metric ip: unit rows, so cosine) from a seed on the card, "
        f"{len(keeps)} predicates keeping {keeps} of them, in {time.perf_counter() - t0:.1f} s")

    t = time.perf_counter()
    mesh = make_mesh(devices=[torch.device(DEVICE, 0)] * _MESH_SHARDS)
    store = MeshEmbeddingStore(dim, metric="ip", store_dtype="bfloat16", quantized=True, mesh=mesh)
    store.append(host)
    store._sharded._sync()
    torch.cuda.synchronize()
    appended = time.perf_counter() - t
    single = EmbeddingStore(dim, device=torch.device(DEVICE), metric="ip", store_dtype="bfloat16", quantized=True)
    single.load_device_rows(corpus)  # the same bf16 rows; its int8 shadow from quantize_rows
    del host
    sharded = store._sharded
    log(f"[mesh] MeshEmbeddingStore on {mesh}: append + first sync {appended:.1f} s (shard capacity "
        f"{sharded._capacity}, counts {sharded.counts.tolist()}, int8 block {_int8_block(sharded)}); "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated with the single-device store")

    calls = (  # kernel, what, the call, (module, the kernel's plain version)
        ("block_topk", "auto", lambda s, q, ids, k: s.search(q, k, impl="auto"), (to, to.exact_block_topk_plain)),
        ("int8_block_topk", "int8", lambda s, q, ids, k: s.search(q, k, impl="int8"),
         (qo, qo.int8_block_topk_plain)),
        ("grouped_block_topk", "grouped", lambda s, q, ids, k: s.grouped_search(q, k, table, ids),
         (go, go.grouped_block_topk_plain)),
        ("int8_grouped_block_topk", "grouped int8",
         lambda s, q, ids, k: s.grouped_search(q, k, table, ids, impl="int8"), (qo, qo.int8_grouped_block_topk_plain)),
    )
    for batch in (1, 8, 128):
        q = queries[:batch]
        ids = np.arange(batch, dtype=np.int32) % len(keeps)
        for name, what, call, (module, plain) in calls:
            got_v, got_i = _counted(name, _MESH_SHARDS, lambda: call(store, q, ids, 50))
            # the references at k + 1: their last column is the cut (check_topk)
            ref_v, ref_i = call(single, q, ids, 51)
            err = check_topk(f"mesh {what} against the single-device store", got_v, got_i, ref_v, ref_i)
            with plain_scan(module, name, plain):
                plain_v, plain_i = call(store, q, ids, 51)
            err = max(err, check_topk(f"mesh {what} against the plain per-shard scans", got_v, got_i,
                                      plain_v, plain_i))
            _ERRORS[name] = max(_ERRORS[name], err)
            if "grouped" in what and not (got_i[4::5] == -1).all():
                raise AssertionError(f"mesh {what}: the empty predicate returned rows")
            single_ms, mesh_ms = (_host_ms(lambda: call(single, q, ids, 50)),
                                  _host_ms(lambda: call(store, q, ids, 50)))
            mesh_ms2, single_ms2 = (_host_ms(lambda: call(store, q, ids, 50)),
                                    _host_ms(lambda: call(single, q, ids, 50)))
            log(f"[mesh] batch {batch} {what} top-50: {name} x{_MESH_SHARDS}; ids equal to the single-device "
                f"store's and to the plain per-shard scans (max |err| {err:.3g}); host to host ms mesh "
                f"{(mesh_ms + mesh_ms2) / 2:.3f} ({mesh_ms:.3f}, {mesh_ms2:.3f}) against single "
                f"{(single_ms + single_ms2) / 2:.3f} ({single_ms:.3f}, {single_ms2:.3f})")
    del store, single, sharded, corpus
    gc.collect()
    torch.cuda.empty_cache()


def _int8_block(sharded) -> int:
    from photo_search_engine_tpu_torch.parallel.sharded import _shard_block_n

    return _shard_block_n(sharded._capacity, sharded.dimension)


def mesh_ivf(rows: int, dim: int) -> None:
    """(b) ShardedIVFIndex over the same four shards: intrinsic-32 rows,
    global nlist 1024, nprobe 64; kernel 7 once per shard per search,
    against its plain version under the same probes; recall@10 against the
    exact mesh scan."""
    import numpy as np
    import torch

    from photo_search_engine_tpu_torch.ops import ivf_scan as io_
    from photo_search_engine_tpu_torch.ops import topk as to
    from photo_search_engine_tpu_torch.parallel.sharded import ShardedEmbeddingStore, make_mesh
    from photo_search_engine_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex
    from tests.torch_parity import plain_scan

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    corpus, basis = _intrinsic_rows(rows, dim, gen)
    rng = np.random.default_rng(SEED + 6)
    picks = torch.from_numpy(rng.choice(rows, size=128, replace=False)).to(DEVICE)
    noise = torch.randn((128, basis.shape[0]), generator=gen, device=DEVICE) @ basis
    queries = to.l2_normalize(corpus[picks].float() + 0.1 * noise).cpu().numpy()
    mesh = make_mesh(devices=[torch.device(DEVICE, 0)] * _MESH_SHARDS)
    store = ShardedEmbeddingStore(dim, mesh, metric="ip", store_dtype="bfloat16")
    store.append(_host_rows(corpus))
    store._sync()
    del corpus
    torch.cuda.synchronize()
    log(f"[mesh] {rows} x {dim} bf16 rows of intrinsic dimension 32 in a four-shard ShardedEmbeddingStore in "
        f"{time.perf_counter() - t0:.1f} s")
    t = time.perf_counter()
    ivf = ShardedIVFIndex.build(store, 1024)
    torch.cuda.synchronize()
    build = time.perf_counter() - t
    log(f"[mesh] ShardedIVFIndex.build: nlist {ivf.nlist}, L {ivf.lrows} slots a cluster per shard, "
        f"{ivf.n_shards} shards, in {build:.1f} s (data-parallel k-means, 8 steps over every row; placement; "
        f"layout gathers); {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    for batch in (1, 128):
        q = queries[:batch]
        got_v, got_i = _counted("ivf_block_topk", _MESH_SHARDS, lambda: ivf.search(q, 50, 64))
        with plain_scan(io_, "ivf_block_topk"):
            ref_v, ref_i = ivf.search(q, 51, 64)
        err = check_topk(f"mesh ivf batch {batch}", got_v, got_i, ref_v, ref_i)
        _ERRORS["ivf_block_topk"] = max(_ERRORS["ivf_block_topk"], err)
        ms = _host_ms(lambda: ivf.search(q, 50, 64))
        log(f"[mesh] ShardedIVFIndex.search batch {batch}, top-50, nprobe 64: ivf_block_topk x{_MESH_SHARDS}, ids "
            f"equal to kernel 7's plain version under the same probes (max |err| {err:.3g}); {ms:.3f} ms host to host")
    _, got = ivf.search(queries, 10, 64)
    _, want = _counted("block_topk", _MESH_SHARDS, lambda: store.search(queries, 10))
    recall = float(np.mean([len(set(g.tolist()) & set(w.tolist())) / 10 for g, w in zip(got, want)]))
    log(f"[mesh] sharded IVF recall@10 at nprobe 64 against the exact mesh scan (kernel 1 x{_MESH_SHARDS}), 128 "
        f"held-out queries: {recall:.4f}")
    if not recall > 0.5:
        raise AssertionError(f"mesh ivf: recall@10 {recall:.4f}")
    del ivf, store
    gc.collect()
    torch.cuda.empty_cache()


def mesh_app() -> None:
    """(c) The app with MESH_DEVICES=-1: one card resolves to a mesh of 1
    (the degenerate mesh, the same code path), flat and IVF, and a restart
    that loads the saved mesh index and its IVF sidecar."""
    import numpy as np

    from photo_search_engine_tpu_torch.api.app import create_app, initialize_services, load_config

    demo = _demo()
    with tempfile.TemporaryDirectory(prefix="pse_mesh_") as tmp:
        for index_type in ("flat", "ivf"):
            env = _app_env(os.path.join(tmp, index_type), "0", keyword_backend="none")
            env.update(MESH_DEVICES="-1", VECTOR_INDEX_TYPE=index_type, IVF_NPROBE="4")
            services = initialize_services(load_config(env))
            index = services["vector_index"]
            if index.mesh_devices != 1 or index._store.n_shards != 1:
                raise AssertionError(f"MESH_DEVICES=-1 on one card: mesh_devices {index.mesh_devices}")
            server, port = _serve(create_app(services))
            base = f"http://127.0.0.1:{port}"
            try:
                demo._post(base, "/init_index", {"mode": "full"})
                _wait_ready(demo, base, f"mesh app ({index_type})")
                photo = os.path.join(services["config"]["PHOTO_DIR"], "beach_sunset_sea.jpg")
                reset_launches()
                counts = {"image": _results("mesh image", demo._post(base, "/search_by_image",
                                                                      {"image_path": photo, "top_k": 3}))}
                image_route = dict(index.last_route)
                counts["text"] = _results("mesh text", demo._post(base, "/search_photos",
                                                                   {"query": "beach sunset sea", "top_k": 6}))
                counts["season_text"] = _results("mesh season", demo._post(
                    base, "/search_photos", {"query": "夏天 海边", "top_k": 6}), allow_empty=True)
                launches = read_launches()
            finally:
                server.shutdown()
                server.server_close()
                close_batchers(services)
            want = "ivf_block_topk" if index_type == "ivf" else "block_topk"
            log(f"[mesh] app MESH_DEVICES=-1 ({index_type}): results {counts}, image route {image_route}, "
                f"launches {launches}")
            if image_route.get("mesh_devices") != 1 or launches[want] <= 0 or launches["grouped_block_topk"] <= 0:
                raise AssertionError(f"mesh app ({index_type}): route {image_route}, launches {launches}")
            for name in (want, "grouped_block_topk"):
                _LAUNCHES[name] += launches[name]
        # a restart: the saved mesh index and its IVF sidecar load without retraining
        restarted = initialize_services(load_config(env))
        index = restarted["vector_index"]
        try:
            if not restarted["searcher"].load_index() or index._ivf is None:
                raise AssertionError("mesh app restart: the index or its IVF sidecar did not load")
            with np.load(index.ivf_sidecar_path) as payload:
                kind = json.loads(str(payload["__meta__"]))["kind"]
            hits = index.search(index.get_embedding_by_photo_path(photo), 3)
        finally:
            close_batchers(restarted)
        if kind != "mesh" or not hits or index.last_route.get("mesh_devices") != 1:
            raise AssertionError(f"mesh app restart: sidecar kind {kind}, route {index.last_route}")
        log(f"[mesh] app restart: the saved mesh index ({index.get_total_items()} rows) and its IVF sidecar "
            f"(kind {kind!r}) loaded without retraining; route {index.last_route}")


def mesh_ranks() -> None:
    """(d) Two ranks on the card(s): the bare sharded search (each rank
    uploads only its rows; a numpy oracle) and the app deployment through
    DIST_*.  With one card both ranks share it and the collectives run on
    gloo; with two or more each rank takes its own card and NCCL."""
    import torch

    from photo_search_engine_tpu_torch.parallel.multihost import launch_app_dryrun, launch_dryrun

    cards = torch.cuda.device_count()
    log(f"[mesh] two ranks on {cards} card(s): device collectives on "
        f"{'nccl (a card per rank)' if cards >= 2 else 'gloo (the ranks share cuda:0; NCCL refuses that, so the NCCL path is not run on one card)'}")
    for what, run in (("sharded search, 2 x 2 shards", lambda: launch_dryrun(2, 2, timeout=180.0, device=DEVICE)),
                      ("app deployment via DIST_*", lambda: launch_app_dryrun(2, 1, timeout=240.0, device=DEVICE))):
        t = time.perf_counter()
        if not run():
            raise AssertionError(f"mesh: two ranks, {what}, failed")
        log(f"[mesh] two ranks, {what}: passed in {time.perf_counter() - t:.1f} s")


# ---------------------------------------------------------------------------
# phase entry: the entry points that run and measure the port
# ---------------------------------------------------------------------------

_BENCH_RUNS = (  # what, env of scripts/torch_bench.py, the kernel it must launch on the tensor cores
    ("exact", {"BENCH_IMPL": "exact"}, "block_topk"),
    ("fast", {"BENCH_IMPL": "fast"}, "fast_block_topk"),
    ("int8", {"BENCH_IMPL": "int8"}, "int8_block_topk"),
    ("ivf", {"BENCH_IMPL": "ivf"}, "ivf_block_topk"),
    ("ivf int8", {"BENCH_IMPL": "ivf", "BENCH_IVF_QUANTIZED": "1"}, "ivf_block_topk"),
)
_LOAD_MODES = (("flat", []), ("flat int8", ["--quantized"]), ("ivf", ["--index-type", "ivf"]))
_LOAD_REQUESTS = 1024  # of the load test's default 2000 a mode: phase entry's share of the run's time limit


def _free_card() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_entry(rows: int = 1_000_000, dim: int = 1536) -> None:
    import torch

    if os.environ.get("PSE_PLATFORM", "").strip().lower() not in ("", "gpu", "cuda"):
        raise AssertionError("phase entry runs the entry points on their default device: unset PSE_PLATFORM")
    _free_card()
    log(f"[entry] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before the entry points")
    summary = {"bench": entry_bench(rows, dim), "load": entry_load(rows, dim)}
    entry_graft()
    entry_scripts()
    log(f"[entry] summary {json.dumps(summary)}")


def _bench_check(what: str, s: dict, search, corpus, queries) -> float:
    """One batch of the bench's ``search`` against the same search with its
    kernel on the plain version, on the bench's own corpus and queries
    (kernel 7 under the same probes, slots mapped to rows through
    ``IVFIndex.perm``).  Kernel 1 and bf16 kernel 7 against the plain
    top-(k+1) (:func:`check_topk`); kernel 2 and int8 kernel 7 at the same
    k, because their rescored pool follows k, by the same rule with the
    last slot isolated from below; kernel 3 by :func:`check_fast` against
    the plain scores.  Returns the largest value error."""
    from photo_search_engine_tpu_torch.ops import ivf_scan as io_
    from photo_search_engine_tpu_torch.ops import quantized as qo
    from photo_search_engine_tpu_torch.ops import topk as to
    from tests.torch_parity import assert_topk_match, plain_scan

    name = f"bench {what} ({s['n_queries']} queries, top-{s['k']})"
    got = search(queries)
    if s["variant"] == "fast":
        with plain_scan(to, "fast_block_topk"):
            ref = search(queries)
        return check_fast(name, *got, *ref, _chunked_ip_scores(corpus, queries))
    module, kernel, plain = {"exact": (to, "block_topk", to.exact_block_topk_plain), "int8": (qo, "int8_block_topk", None),
                             "ivf": (io_, "ivf_block_topk", None)}[s["variant"]]
    pooled = s["variant"] == "int8" or s["ivf_quantized"]
    with plain_scan(module, kernel, plain):
        ref = search(queries, s["k"] if pooled else s["k"] + 1)
    if s["variant"] == "ivf":
        got, ref = (search.index._to_rows(*(x.cpu().numpy() for x in pair)) for pair in (got, ref))
    if not pooled:
        return check_topk(name, *got, *ref)
    try:
        return assert_topk_match(*got, *ref, tol=TOL)
    except AssertionError as exc:
        raise AssertionError(f"{name}: {exc}") from exc


def _bench_loop(s, search, corpus) -> str:
    """The scoring loop of the bench variant's kernel, by the loop rules."""
    from photo_search_engine_tpu_torch.ops import ivf_scan as io_
    from photo_search_engine_tpu_torch.ops import quantized as qo
    from photo_search_engine_tpu_torch.ops import topk as to

    if s["variant"] == "ivf":
        return io_.ivf_scoring_loop(*search.index._kernel_layout(s["k"]))
    if s["variant"] == "int8":
        return qo.int8_scoring_loop(corpus.shape[1])
    return to.scoring_loop(corpus)


def entry_bench(rows: int, dim: int) -> dict:
    """(a) scripts/torch_bench.py for each variant at ``rows`` x ``dim``
    (its default 1M x 1536) on the card, through its own functions: the
    search of each variant is first held against its plain version on one
    batch of the bench's queries (:func:`_bench_check`), then measured
    with the launch counts zeroed: its JSON line, the library
    composition's QPS beside it, the variant's kernel launched on the
    tensor cores, no host sync in the timed call.  Then the bench's
    command line once as a user runs it (its default variant).  Returns
    each variant's JSON line with its timing line and launches."""
    import torch

    _scripts()
    import torch_bench

    device = torch.device(DEVICE)
    results = {}
    for what, env, kernel in _BENCH_RUNS:
        t = time.perf_counter()
        s = torch_bench.settings({"BENCH_ROWS": str(rows), "BENCH_DIM": str(dim), **env})
        corpus, qstack = torch_bench.inputs(s, device)
        search, library, label = torch_bench.make_search(s, corpus)
        err = _bench_check(what, s, search, corpus, qstack[0])
        _ERRORS[kernel] = max(_ERRORS[kernel], err)
        reset_launches()
        out = torch_bench.measure(s, search, library, label, qstack)
        launched, loop = read_launches()[kernel], _bench_loop(s, search, corpus)
        lines = torch_bench.report(out)
        for line in lines:
            log(f"[entry] bench {what}: {line}")
        if out["host_sync"]:
            raise AssertionError(f"bench {what}: the timed call synchronises with the host: {out['host_sync']}")
        if launched <= 0 or loop != "tensor_core":
            raise AssertionError(f"bench {what}: {kernel} launched {launched} times on the {loop} loop")
        _LAUNCHES[kernel] += launched
        results[what] = {**json.loads(lines[-1]), "detail": lines[-2], "launches": launched}
        log(f"[entry] bench {what}: one batch against the plain version, max |err| {err:.3g}; {kernel} "
            f"x{launched} on the tensor cores; no host sync; {time.perf_counter() - t:.1f} s")
        del corpus, qstack, search, library
        _free_card()
    t = time.perf_counter()
    env = {key: value for key, value in os.environ.items() if not key.startswith("BENCH_") and key != "PSE_PLATFORM"}
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "torch_bench.py")], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    for line in proc.stdout.splitlines():
        log(f"[entry] bench command line: {line}")
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if proc.returncode == 0 and lines and lines[-1].startswith("{") else {}
    want = torch_bench.metric_name(torch_bench.settings({}))
    if set(line) != set(torch_bench.HEADLINE_KEYS) or line["metric"] != want or not line["value"] > 0:
        raise AssertionError(f"python3 scripts/torch_bench.py: rc {proc.returncode}, want {want}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    log(f"[entry] bench command line: rc 0, {want}; {time.perf_counter() - t:.1f} s")
    return results


def _results_by_rank(payload):
    """``(scores, row ids)`` of a /search_photos response, in rank order."""
    import numpy as np

    results = payload["results"]
    return (np.array([r["score"] for r in results], np.float64),
            np.array([int(r["photo_path"].rsplit("/", 1)[1].split(".")[0]) for r in results], np.int64))


def entry_load(rows: int, dim: int) -> dict:
    """(b) scripts/torch_load_test.py at ``rows`` x ``dim`` (1M x 1536), 16 threads: flat,
    --quantized, --index-type ivf.  Each mode's JSON line with 0 errors,
    and its launches over the whole run (the warm-up included).  The ivf
    mode must launch kernel 7: its first measured request's query is sent
    again, then once more with kernel 7 on its plain version (the same
    probes): the same photos in the same order, scores within TOL.  The
    flat modes' candidate_k 500 > 64 is served by the plain exact scan, so
    no kernel of theirs is compared; their launches are printed.  Returns
    each mode's JSON line."""
    from photo_search_engine_tpu_torch.ops import ivf_scan as io_
    from tests.torch_parity import assert_topk_match, plain_scan

    _scripts()
    import torch_load_test as lt

    log(f"[entry] load test: --requests cut from 2000 to {_LOAD_REQUESTS} per mode (phase entry's share of the "
        f"run's time limit); rows and dim not cut")
    results = {}
    for mode, extra in _LOAD_MODES:
        t = time.perf_counter()
        args = lt.parse_args(["--rows", str(rows), "--dim", str(dim), "--threads", "16",
                              "--requests", str(_LOAD_REQUESTS)] + extra)
        reset_launches()
        stats, err_sample, server, port, index = lt.measure(args)
        launched = {name: n for name, n in read_launches().items() if n}
        try:
            query = lt.query_pool()[lt.warmup_requests(args.threads, args.requests) % 512]
            got = lt.post_search(port, query)
            if mode == "ivf":
                with plain_scan(io_, "ivf_block_topk"):
                    want = lt.post_search(port, query)
        finally:
            server.shutdown()
            server.server_close()
            index._microbatcher.close()
        log(f"[entry] load {mode}: {json.dumps(stats)}")
        if err_sample:
            log(f"[entry] load {mode}: sample errors {err_sample}")
        if stats["errors"] or stats["requests_ok"] != args.requests:
            raise AssertionError(f"load {mode}: {stats['errors']} errors of {args.requests}")
        if not got.get("results") or got.get("status") != "success":
            raise AssertionError(f"load {mode}: empty or failed response {str(got)[:300]}")
        if mode == "ivf":
            if launched.get("ivf_block_topk", 0) <= 0:
                raise AssertionError(f"load ivf: kernel 7 never launched ({launched})")
            _LAUNCHES["ivf_block_topk"] += launched["ivf_block_topk"]
            err = assert_topk_match(*_results_by_rank(got), *_results_by_rank(want), tol=TOL)
            checked = (f"the first measured query {query!r} answered the same with kernel 7 on its plain version "
                       f"({len(got['results'])} photos, max |score err| {err:.3g}); expected kernel 7 on its FMA "
                       f"loop (k 500 > 64)")
        else:
            checked = ("candidate_k 500 > 64 is served by exact_search_plain, so no kernel was compared; "
                       "expected launches: none")
        log(f"[entry] load {mode}: {checked}; kernels launched in the run {launched or 'none'}; "
            f"{time.perf_counter() - t:.1f} s")
        results[mode] = stats
        del server, index
        _free_card()
    return results


def entry_graft() -> None:
    """(c) graft_entry.entry() on the card (kernel 1 on the f32 ring, bit
    for bit the FMA loop's; against the plain scan), then
    dryrun_multichip(4): four shards on cuda:0, kernels 1, 2, 5 and 7."""
    import torch

    from photo_search_engine_tpu_torch import graft_entry
    from photo_search_engine_tpu_torch.ops import topk as to
    from tests.torch_parity import assert_same_bits, fma_loop

    t = time.perf_counter()
    forward, (corpus, queries) = graft_entry.entry()
    if corpus.device.type != torch.device(DEVICE).type:
        raise AssertionError(f"entry(): corpus on {corpus.device}")
    reset_launches()
    got = forward(corpus, queries)
    torch.cuda.synchronize()
    launched, loop = read_launches()["block_topk"], to.scoring_loop(corpus)
    if launched != 1 or loop != "fma_ring":
        raise AssertionError(f"entry(): block_topk launched {launched} times on the {loop} loop")
    _LAUNCHES["block_topk"] += 1
    with fma_loop():
        assert_same_bits("entry() against the FMA loop", got, forward(corpus, queries))
    err = check_topk("entry() against the plain scan", *got, *to.exact_search_plain(corpus, queries, 11, metric="ip"))
    _ERRORS["block_topk"] = max(_ERRORS["block_topk"], err)
    log(f"[entry] graft entry(): exact_search over {tuple(corpus.shape)} f32 rows, {queries.shape[0]} queries, "
        f"top-10 on {corpus.device}: block_topk on the f32 ring, bit for bit the FMA loop's, against the plain "
        f"scan max |err| {err:.3g}")
    reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        graft_entry.dryrun_multichip(_MESH_SHARDS)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[entry] graft {out.getvalue().strip()}; launches {launches}")
    for name in ("block_topk", "int8_block_topk", "grouped_block_topk", "ivf_block_topk"):
        if launches[name] <= 0:
            raise AssertionError(f"dryrun_multichip({_MESH_SHARDS}): {name} never launched")
        _LAUNCHES[name] += launches[name]
    log(f"[entry] graft entry: {time.perf_counter() - t:.1f} s")


def entry_scripts() -> None:
    """(d) scripts/torch_check_services.py and scripts/torch_demo_e2e.py as
    subprocesses on the card (PSE_PLATFORM unset)."""
    import torch

    env = {key: value for key, value in os.environ.items() if key != "PSE_PLATFORM"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "torch_check_services.py")], env=env,
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    report = json.loads(out.stdout) if out.returncode == 0 else {}
    name = torch.cuda.get_device_name(0)
    if out.returncode != 0 or report.get("backend") != "cuda" or report.get("devices", [None])[0] != name:
        raise AssertionError(f"check_services: rc {out.returncode}: {out.stdout[-2000:]} {out.stderr[-2000:]}")
    log(f"[entry] check_services: ok, backend {report['backend']}, devices {report['devices']}, native library "
        f"{report['native_library']}, server {report['server']} ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "torch_demo_e2e.py")], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    for line in out.stdout.splitlines():
        log(f"[entry] demo | {line}")
    labels = ("== text: beach sunset ==", "== season filter", "== season+period", "== autumn date range",
              "== image-to-image", "== upload-to-search", "all demo flows completed")
    missing = [label for label in labels if label not in out.stdout]
    if out.returncode != 0 or missing or "ERROR" in out.stdout:
        raise AssertionError(f"demo: rc {out.returncode}, missing {missing}: {out.stderr[-2000:]}")
    log(f"[entry] demo: every mode answered on the card ({time.perf_counter() - t:.1f} s)")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="device,kernels,app,scale,f32,ivf,online,tools,mesh,entry",
                        help="comma-separated subset of device,kernels,app,scale,f32,ivf,online,tools,mesh,entry")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a CUDA card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "photo_search_engine_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    global _SPY
    from tests.torch_parity import spy_launches

    phases = [p.strip() for p in args.phases.split(",") if p.strip()]
    started = time.perf_counter()
    phase_device()
    runners = {"kernels": phase_kernels, "app": phase_app, "scale": phase_scale, "f32": phase_f32, "ivf": phase_ivf,
               "online": phase_online, "tools": phase_tools, "mesh": phase_mesh, "entry": phase_entry}
    with spy_launches() as _SPY:
        for name in phases:
            if name in runners:
                t = time.perf_counter()
                runners[name]()
                log(f"[{name}] phase passed in {time.perf_counter() - t:.1f} s")
    for name in {n for phase in phases for n in _DRIVES.get(phase, ())}:
        if _LAUNCHES[name] <= 0:
            raise AssertionError(f"the main path never launched {name}")
    sources = {  # name: (source, TPU kernel it replaces, batch of the reported time)
        "block_topk": ("photo_search_engine_tpu_torch/csrc/block_topk.cu",
                       "photo_search_engine_tpu/ops/topk.py:345", 1),
        "int8_block_topk": ("photo_search_engine_tpu_torch/csrc/int8_block_topk.cu",
                            "photo_search_engine_tpu/ops/quantized.py:192", 1),
        "grouped_block_topk": ("photo_search_engine_tpu_torch/csrc/block_topk.cu",
                               "photo_search_engine_tpu/ops/grouped_mask.py:167", 128),
        "int8_grouped_block_topk": ("photo_search_engine_tpu_torch/csrc/int8_block_topk.cu",
                                    "photo_search_engine_tpu/ops/quantized.py:339", 128),
        "ivf_block_topk": ("photo_search_engine_tpu_torch/csrc/ivf_topk.cu",
                           "photo_search_engine_tpu/models/ivf.py:247", 1),
        "fast_block_topk": ("photo_search_engine_tpu_torch/csrc/block_topk.cu",
                            "photo_search_engine_tpu/ops/topk.py:301", 1),
        "fast_grouped_block_topk": ("photo_search_engine_tpu_torch/csrc/block_topk.cu",
                                    "photo_search_engine_tpu/ops/grouped_mask.py:167", 128),
        "fused_topk": ("photo_search_engine_tpu_torch/csrc/fused_topk.cu",
                       "photo_search_engine_tpu/ops/topk.py:483", 1),
    }
    kernels = []
    for name, (source, replaces, batch) in sources.items():
        ms, plain_ms, bound, by, lib_ms = _TIMES.get((name, batch, 50), (None,) * 5)
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": _LAUNCHES[name], "max_abs_err": _ERRORS[name],
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                 "library_ms": lib_ms, "batch": batch, "top_k": 50}
        f32 = {b: _TIMES[(name + " f32", b, 50)] for b in (1, 8, 128, 256) if (name + " f32", b, 50) in _TIMES}
        if f32:  # the same kernel on float32 rows (the f32 ring), by batch
            entry["f32"] = {"launches": _F32_LAUNCHES.get(name, 0), "by_batch": {
                str(b): {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3], "library_ms": t[4]}
                for b, t in f32.items()}}
        kernels.append(entry)
    log(f"[done] phases {phases} passed in {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

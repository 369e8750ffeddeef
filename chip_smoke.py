#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one CUDA card.

Phases; each prints its results on lines of its own and raises on failure:

1. device  - the card's name and power limit; build the CUDA kernels from
             photo_search_engine_tpu_torch/csrc with nvcc.
2. kernels - kernel 1 (block_topk) and kernel 2 (int8_block_topk) against
             their plain PyTorch versions on the card: ip, l2, masked with
             a live count, float32 and bfloat16, k in {1, 10, 50, 64}, and a
             block of duplicate rows whose ties must go to the smallest row;
             then kernel 5 (grouped_block_topk) and kernel 6
             (int8_grouped_block_topk), a predicate per query, for M in
             {1, 3, 8} and Q in {1, 9, 33, 128}, with an empty predicate,
             ids outside [0, M) and duplicate rows; then kernel 7
             (ivf_block_topk, the IVF probed-cluster scan) on float32,
             bfloat16 and int8 layouts, ip and l2, k in {1, 10, 50, 64}
             (and 500 on the float layouts), Q in {1, 9, 33, 128}, nprobe
             in {1, 8, 64}, with padding slots, a slot mask, a query whose
             probed clusters are all masked out and duplicate rows.
3. app     - the entry point (python -m photo_search_engine_tpu_torch.api.app,
             micro-batcher on, its default) as a subprocess on a PIL photo
             library; then the same app in this process without a keyword
             index, with STORE_QUANTIZED=0 and =1, answering a text, a
             season, a season-with-text (the grouped scan), an image and an
             upload search.
4. scale   - a 1M x 1536 bfloat16 corpus with an int8 shadow and seeded
             season metadata, made on the card from a seed, installed in a
             VectorIndex and served by the app's own wiring
             (initialize_services, create_app) with the micro-batcher on:
             concurrent image searches (kernels 1 and 2), concurrent
             filtered searches over five predicates (kernels 5 and 6)
             checked against plain per-query searches, a season-filtered
             /search_photos, the batcher's counters, and the kernels'
             times against the plain versions (CUDA events, after warm-up).
5. ivf     - VECTOR_INDEX_TYPE=ivf at 1M x 1536: bfloat16 rows of intrinsic
             dimension 32 made on the card from a seed, served by the app's
             wiring with IVF_NLIST=1024, IVF_NPROBE=64 and the micro-batcher
             on, with STORE_QUANTIZED=0 and =1: the first routed search
             builds the IVF (its seconds printed), 32 concurrent image
             searches and an unfiltered /search_photos (k up to 500) reach
             kernel 7 through the routes, a masked search_batch takes the
             ivf_masked route; each result is held against the same search
             with kernel 7's plain version under the same probes; recall@10
             against the flat exact scan (kernel 1); kernel 7's times against
             its plain version at batch 1 and 128, top-50.

The launch counters are set to 0 before the route runs of phases 3, 4 and
5 and read after every client thread has joined; a kernel that the routes
never launched fails the run.  The second-to-last line of output is a JSON
object with each kernel's route, launches, error and times; the last is
{"ok": true, "device": {...}}.  Without a CUDA card the script exits
non-zero and prints no result.

Run:  python3 chip_smoke.py            (all phases; one card, nvcc on PATH
                                        or under $CUDA_HOME or /usr/local/cuda)
      python3 chip_smoke.py --phases device,kernels
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

_NAMES = ("block_topk", "int8_block_topk", "grouped_block_topk", "int8_grouped_block_topk", "ivf_block_topk")
_FLAT = _NAMES[:4]
_DRIVES = {"app": _FLAT, "scale": _FLAT, "ivf": ("ivf_block_topk",)}  # the kernels each route phase must launch
_ERRORS = {name: 0.0 for name in _NAMES}
_LAUNCHES = {name: 0 for name in _NAMES}
_TIMES = {}


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

    live = got_i != torch.iinfo(torch.int32).max
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


def _wrappers() -> dict:
    from photo_search_engine_tpu_torch.ops import grouped_mask as go
    from photo_search_engine_tpu_torch.ops import ivf_scan as io_
    from photo_search_engine_tpu_torch.ops import quantized as qo
    from photo_search_engine_tpu_torch.ops import topk as to

    return {"block_topk": to.block_topk, "int8_block_topk": qo.int8_block_topk,
            "grouped_block_topk": go.grouped_block_topk, "int8_grouped_block_topk": qo.int8_grouped_block_topk,
            "ivf_block_topk": io_.ivf_block_topk}


def reset_launches() -> None:
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: wrapper.launches for name, wrapper in _wrappers().items()}


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
        if any(word in line for word in ("entry function", "registers", "spill", "error")):
            log(f"[device] ptxas: {line.strip()}")


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
    check_ivf_kernel(gen, d)


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


def check_partials(name, got, plain, k):
    """Kernel 7's ``[Q, nprobe, T, kk]`` partials against its plain
    version run at k + 1, whose extra column (when the tile has one) is the
    cut, then the merged top-k the same way (:func:`check_topk`'s rule)."""
    from tests.torch_parity import assert_topk_match

    from photo_search_engine_tpu_torch.ops import topk as to

    ref_v, ref_i = plain(k + 1)
    kk = got[0].shape[-1]
    cut = ref_v[..., kk] if ref_v.shape[-1] > kk else None
    try:
        err = assert_topk_match(*got, ref_v[..., :kk], ref_i[..., :kk], tol=TOL, cut=cut)
    except AssertionError as exc:
        raise AssertionError(f"{name} (partials): {exc}") from exc
    return max(err, check_topk(f"{name} (merged)", *to.merge_partials(*got, k), *to.merge_partials(ref_v, ref_i, k + 1)))


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


def check_ivf_kernel(gen, d) -> None:
    """Kernel 7 against its plain version: float32, bfloat16 and int8
    layouts, ip and l2, k 1/10/50/64 (and 500 on the float layouts), Q
    1/9/33/128, nprobe 1/8/64, with padding slots; then a slot mask, a query
    whose probed clusters are all masked out, and duplicate rows."""
    import torch

    from photo_search_engine_tpu_torch.ops import ivf_scan as io_
    from photo_search_engine_tpu_torch.ops import quantized as qo
    from photo_search_engine_tpu_torch.ops import topk as to

    nlist, lrows = 96, 384  # 384 slots: a ragged last tile of 128
    base, row_valid, dups = _ivf_layout(gen, nlist, lrows, d)
    cases = {"float32": 0, "bfloat16": 0, "int8": 0}
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
                for valid, what in ((row_valid, ""), (row_valid * (torch.rand(row_valid.shape, generator=gen, device=DEVICE) < 0.3), " masked")):
                    kw = dict(lrows=lrows, metric=metric, cnorms=cnorms, **extra)
                    got = io_.ivf_block_topk(corpus, queries, probes, valid.to(torch.int8), k, **kw)
                    torch.cuda.synchronize()
                    name = f"ivf_block_topk {tier} {metric}{what} k={k} q={q} nprobe={nprobe}"
                    plain = lambda kk: io_.ivf_block_topk_plain(corpus, queries, probes, valid.to(torch.int8), kk, **kw)  # noqa: E731
                    if tier == "int8":
                        err = check_topk(name, *got, *plain(k + 1), exact=True)
                    else:
                        err = check_partials(name, got, plain, k)
                    _ERRORS["ivf_block_topk"] = max(_ERRORS["ivf_block_topk"], err)
                    cases[tier] += 1
    log(f"[kernels] ivf_block_topk: {cases['float32'] + cases['bfloat16']} float cases agree with the plain "
        f"version (max |err| {_ERRORS['ivf_block_topk']:.3g}, tol {TOL}), {cases['int8']} int8 cases identical")

    # a query whose probed clusters are all masked out; duplicates of slot 7
    # come out at the smallest slots, across clusters
    row_valid[3 * lrows : 5 * lrows] = 0
    probes = torch.tensor([[0, 1], [3, 4]], dtype=torch.int32, device=DEVICE)
    for dtype in (torch.float32, torch.bfloat16):
        corpus = base.to(dtype)
        queries = corpus[[7, 7]].contiguous()
        vals, slots = to.merge_partials(*io_.ivf_block_topk(corpus, queries, probes, row_valid, 64, lrows=lrows), 64)
        want = sorted([7] + [int(r) for r in dups[:40]])
        if slots[0].tolist()[: len(want)] != want:
            raise AssertionError(f"ivf duplicate-row ties {str(dtype)[6:]}: {slots[0].tolist()[:8]}... != {want[:8]}...")
        if not (torch.isneginf(vals[1]).all() and (slots[1] == torch.iinfo(torch.int32).max).all()):
            raise AssertionError("ivf: a query whose probed clusters are all masked out returned slots")
    log("[kernels] ivf_block_topk: duplicate-row ties at the smallest slots across clusters; a query whose "
        "probed clusters are all masked out gets empty slots (f32, bf16)")


# ---------------------------------------------------------------------------
# phase 3: the app on a photo library
# ---------------------------------------------------------------------------


def _demo():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import demo_e2e

    return demo_e2e


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
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from load_test import serve

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


def phase_scale(rows: int = 1_000_000, dim: int = 1536) -> None:
    import numpy as np
    import torch

    from photo_search_engine_tpu_torch.api.app import create_app, initialize_services, load_config
    from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
    from photo_search_engine_tpu_torch.ops import grouped_mask as go
    from photo_search_engine_tpu_torch.ops import quantized as qo
    from photo_search_engine_tpu_torch.ops import topk as to

    demo = _demo()
    device = torch.device(DEVICE)
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    corpus = torch.empty((rows, dim), dtype=torch.bfloat16, device=device)
    for start in range(0, rows, 131072):
        stop = min(rows, start + 131072)
        corpus[start:stop] = _unit_rows(stop - start, dim, gen, torch.bfloat16)
    with tempfile.TemporaryDirectory(prefix="pse_scale_") as tmp:
        index = VectorIndex(
            dimension=dim, index_path=os.path.join(tmp, "scale.index"),
            metadata_path=os.path.join(tmp, "scale-meta.json"), metric="cosine",
            store_dtype="bfloat16", quantized=True, device=device,
        )
        index.load_device_rows(corpus, _metadata(rows))
        del corpus
        store = index._store
        torch.cuda.synchronize()
        log(f"[scale] {rows} x {dim} bf16 rows + int8 shadow on the card, season metadata on the host, in "
            f"{time.perf_counter() - t0:.1f} s (capacity {store.capacity}, "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)")

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
        log(f"[scale] route launches {launches}")
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

        # the kernels against their plain versions at the main-path shapes,
        # then their times (CUDA events; plain, kernel, kernel, plain)
        table = torch.zeros((len(masks), store.capacity), dtype=torch.int8, device=device)
        table[:, :rows] = torch.from_numpy(np.stack(masks)).to(device)
        k1 = dict(count=store.count, metric="ip", block_n=store.block_rows)
        k2 = dict(count=store.count, metric="ip", block_n=store._i8_block)
        k5 = dict(count=store.count, block_n=store.block_rows)
        k6 = dict(count=store.count, block_n=store._i8_block)
        for batch, tops, names in ((1, (10, 50), ("block_topk", "int8_block_topk")),
                                   (256, (10, 50), ("block_topk", "int8_block_topk")),
                                   (128, (50,), _FLAT)):  # the grouped kernels beside 1 and 2
            qb = _unit_rows(batch, dim, gen, torch.float32)
            qb16 = qb.to(torch.bfloat16)
            q_i8, qs = qo.quantize_rows(qb)
            ids = (torch.arange(batch, device=device) % len(masks)).to(torch.int32)
            runs = {
                "block_topk": (
                    lambda kk: to.block_topk(store._device, qb16, kk, **k1),
                    lambda kk: to.exact_block_topk_plain(store._device, qb16, kk, **k1),
                ),
                "int8_block_topk": (
                    lambda kk: qo.int8_block_topk(store._device_i8, store._scales, q_i8, qs, kk, **k2),
                    lambda kk: qo.int8_block_topk_plain(store._device_i8, store._scales, q_i8, qs, kk, **k2),
                ),
                "grouped_block_topk": (
                    lambda kk: go.grouped_block_topk(store._device, qb16, table, ids, kk, **k5),
                    lambda kk: go.grouped_block_topk_plain(store._device, qb16, table, ids, kk, **k5),
                ),
                "int8_grouped_block_topk": (
                    lambda kk: qo.int8_grouped_block_topk(store._device_i8, store._scales, q_i8, qs, table, ids, kk, **k6),
                    lambda kk: qo.int8_grouped_block_topk_plain(store._device_i8, store._scales, q_i8, qs, table, ids, kk, **k6),
                ),
            }
            for k in tops:
                for name in names:
                    kernel, plain = runs[name]
                    err = check_topk(f"scale {name} batch {batch} top-{k}", *kernel(k), *plain(k + 1),
                                     exact=name.startswith("int8"))
                    _ERRORS[name] = max(_ERRORS[name], err)
                    plain_ms = cuda_ms(lambda: plain(k), reps=2)
                    kernel_ms = cuda_ms(lambda: kernel(k), reps=3)
                    kernel_ms2 = cuda_ms(lambda: kernel(k), reps=3)
                    plain_ms2 = cuda_ms(lambda: plain(k), reps=2)
                    ms, pms = (kernel_ms + kernel_ms2) / 2, (plain_ms + plain_ms2) / 2
                    _TIMES[(name, batch, k)] = (ms, pms)
                    extra = f", M={len(masks)}" if name.startswith(("grouped", "int8_grouped")) else ""
                    log(f"[scale] {name} batch {batch} top-{k}{extra} at {rows}x{dim}: agrees with the plain "
                        f"version (max |err| {err:.3g}); kernel {ms:.3f} ms, plain {pms:.3f} ms "
                        f"(kernel {kernel_ms:.3f}/{kernel_ms2:.3f}, plain {plain_ms:.3f}/{plain_ms2:.3f})")


# ---------------------------------------------------------------------------
# phase 5: VECTOR_INDEX_TYPE=ivf at 1M x 1536
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_ivf_scan():
    """Inside, every IVF search runs kernel 7's plain version in place of
    the kernel; the pipeline around it (probes, merge, rescore) is the same."""
    from photo_search_engine_tpu_torch.ops import ivf_scan

    kernel = ivf_scan.ivf_block_topk
    ivf_scan.ivf_block_topk = ivf_scan.ivf_block_topk_plain
    try:
        yield
    finally:
        ivf_scan.ivf_block_topk = kernel


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
    torch.cuda.synchronize()
    log(f"[ivf] {rows} x {dim} bf16 rows of intrinsic dimension 32 on the card, 128 held-out queries, "
        f"in {time.perf_counter() - t0:.1f} s")
    for quantized in ("0", "1"):
        _ivf_tier(corpus, metadata, queries, mask, quantized)


def _ivf_tier(corpus, metadata, queries, mask, quantized: str) -> None:
    import numpy as np
    import torch

    from photo_search_engine_tpu_torch.api.app import create_app, initialize_services, load_config
    from photo_search_engine_tpu_torch.core.vector_index import VectorIndex
    from photo_search_engine_tpu_torch.ops import ivf_scan as io_
    from photo_search_engine_tpu_torch.ops import topk as to

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
        log(f"[ivf] route launches {launches}; masked search_batch route {masked_route}; micro-batcher: "
            f"batches_run {batcher.batches_run}, grouped_batches_run {batcher.grouped_batches_run}, "
            f"requests_served {batcher.requests_served}")
        if launches["ivf_block_topk"] <= 0:
            raise AssertionError(f"STORE_QUANTIZED={quantized}: the IVF routes never launched ivf_block_topk")
        if route["impl"] != "ivf" or masked_route["impl"] != "ivf_masked":
            raise AssertionError(f"IVF routes: {route}, {masked_route}")
        _LAUNCHES["ivf_block_topk"] += launches["ivf_block_topk"]

        # the searches against the same searches with kernel 7's plain
        # version, under the same probes (the reference at k + 1: its last
        # column is the cut)
        for k, m, what in ((10, None, "image"), (500, None, "search_photos"), (50, mask, "masked")):
            got = index.raw_search_batch(queries[:4], k, mask=m)
            with plain_ivf_scan():
                ref = index.raw_search_batch(queries[:4], k + 1, mask=m)
            err = check_topk(f"ivf {tier} {what} k={k}", *got, *ref)
            _ERRORS["ivf_block_topk"] = max(_ERRORS["ivf_block_topk"], err)
        # recall@10 of the IVF route at nprobe 64 against the flat exact scan (kernel 1)
        _, got = index.raw_search_batch(queries, 10)
        q16 = torch.from_numpy(queries).to(device).to(torch.bfloat16)
        _, want = to.exact_search(index._store._device, q16, 10, count=index._store.count, metric="ip")
        want = want.cpu().numpy()
        recall = float(np.mean([len(set(g.tolist()) & set(w.tolist())) / 10 for g, w in zip(got, want)]))
        log(f"[ivf] {tier}: results agree with kernel 7's plain version under the same probes (k 10, 500, "
            f"masked 50; max |err| {_ERRORS['ivf_block_topk']:.3g}); recall@10 at nprobe 64 against the flat "
            f"exact scan (kernel 1), 128 held-out queries: {recall:.4f}")

        # kernel 7 against its plain version at the main-path shapes, then
        # their times (CUDA events; plain, kernel, kernel, plain).  The
        # wrapper's time includes its probe-group table (one probe-id read
        # back, one table upload), which the path pays on every call.
        for batch in (1, 128):
            qb = torch.from_numpy(queries[:batch]).to(device).to(torch.bfloat16).contiguous()
            probes = ivf._probe(qb, 64)
            if quantized == "1":
                ivf._ensure_quantized()
                q8, qs = io_.quantize_ivf_queries(qb.float())
                args = (ivf._corpus_i8, q8, probes, ivf._row_valid)
                kw = dict(lrows=ivf.capacity, metric="ip", qscales=qs, cscales=ivf._cscales)
                kk, name = 64, "ivf_block_topk int8"  # top-50 nominates min(2k, 64) = 64
            else:
                args, kw, kk, name = (ivf._corpus, qb, probes, ivf._row_valid), dict(lrows=ivf.capacity, metric="ip"), 50, "ivf_block_topk"
            kernel = lambda: io_.ivf_block_topk(*args, kk, **kw)  # noqa: E731
            plain = lambda kk_=kk: io_.ivf_block_topk_plain(*args, kk_, **kw)  # noqa: E731
            if quantized == "1":
                err = check_topk(f"{name} batch {batch}", *kernel(), *plain(kk + 1), exact=True)
            else:
                err = check_partials(f"{name} batch {batch}", kernel(), plain, kk)
            _ERRORS["ivf_block_topk"] = max(_ERRORS["ivf_block_topk"], err)
            plain_ms = cuda_ms(plain, reps=2)
            kernel_ms = cuda_ms(kernel, reps=5)
            kernel_ms2 = cuda_ms(kernel, reps=5)
            plain_ms2 = cuda_ms(plain, reps=2)
            ms, pms = (kernel_ms + kernel_ms2) / 2, (plain_ms + plain_ms2) / 2
            _TIMES[(name, batch, 50)] = (ms, pms)
            pairs = batch * probes.shape[1]
            groups, _, _, bq = io_.probe_groups(probes.cpu().numpy(), ivf.nlist)
            fill = f"{groups.shape[0]} groups of up to {bq} queries, {pairs / (groups.shape[0] * bq):.0%} full"
            gbytes = pairs * ivf.capacity * dim * args[0].element_size() / 1e9  # probed rows, counted per pair
            gflop = 2 * pairs * ivf.capacity * dim / 1e9
            log(f"[ivf] {name} batch {batch} top-50 (nprobe 64, {pairs} probe pairs in {fill}: {gbytes:.2f} GB of probed "
                f"rows, {gflop:.1f} GFLOP) at {rows}x{dim}: agrees with the plain version (max |err| {err:.3g}); "
                f"kernel {ms:.3f} ms ({gbytes / ms:.1f} TB/s over the pairs' rows, {gflop / ms:.2f} TFLOP/s), "
                f"plain {pms:.3f} ms (kernel {kernel_ms:.3f}/{kernel_ms2:.3f}, plain {plain_ms:.3f}/{plain_ms2:.3f})")
        # the micro-batcher's closures and the index refer to each other:
        # collect the cycle, so that the next tier starts from free memory
        del index, services, ivf, batcher
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="device,kernels,app,scale,ivf",
                        help="comma-separated subset of device,kernels,app,scale,ivf")
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
    phases = [p.strip() for p in args.phases.split(",") if p.strip()]
    started = time.perf_counter()
    phase_device()
    runners = {"kernels": phase_kernels, "app": phase_app, "scale": phase_scale, "ivf": phase_ivf}
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
    }
    kernels = []
    for name, (source, replaces, batch) in sources.items():
        ms, plain_ms = _TIMES.get((name, batch, 50), (None, None))
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": _LAUNCHES[name], "max_abs_err": _ERRORS[name],
                        "ms": ms, "plain_ms": plain_ms})
    log(f"[done] phases {phases} passed in {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

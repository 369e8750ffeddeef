#!/usr/bin/env python3
"""Kernels 1, 3 and 4 of the PyTorch port side by side on one CUDA card:
1M x 1536 bfloat16 unit rows made on the card from a seed, top-50, batches
1, 8, 32, 128 and 256.  Kernel 1, kernel 3 (packed-key selection) and
kernel 4 (a running top-k over ranges of blocks), all three on the tensor
cores (wgmma fed by a TMA ring, ``csrc/block_score_tc.cuh``), against the
library composition (cuBLAS product, then ``torch.topk``); kernels 1 and 3
at k = 1; then kernel 1's geometries through
``pse_block_topk_bf16_geometry``: block_n in {512, 1024, 2048} with a ring
of 2, 4 or 6 corpus stages, and the k-round selection at 1024 / 4; each
one's merged top-k is checked identical to kernel 1's (the same sums in the
same order).  ``--fused-only`` times kernel 4 instead, at 1, 2, 3, 4, 5,
8, 15 and 30 blocks per range and at ``topk.fused_ranges``' default (each
timed twice, in two passes of opposite order), each result checked
identical to kernel 1 followed by ``merge_partials``.  ``--ivf-only``
times kernel 7 (the IVF scan, tensor cores) instead, on a cluster-major
layout of 1024 clusters x 1536 slots x 1536 (each cluster filled to a
seeded 768-1536 slots) with 64 seeded probes a query, bf16 top-50 and int8
top-64, at every tile of 512, 768 and 1536 slots and group size of 8 and
32 (two passes of opposite order), each merged result checked against the
one at ``ivf_scan.ivf_geometry``'s choice, which the line names.
``--f32-only`` times the float32 kernels at batches 1, 8, 128 and 256:
kernel 1 at 1M x 1536 and kernel 7 on that layout in float32, on the TMA
ring with fmaf consumers and on the FMA loop side by side (kernel 1's
partials checked bit for bit between the two), each against its plain
version, its bound and the library composition (a cuBLAS float32 product
with TF32 off, then ``torch.topk``; kernel 7's gathers each query's probed
clusters first, in chunks of 8 queries).  Times are CUDA events over 5 calls after one warm-up
(``chip_smoke.cuda_ms``); each line names the card and its power limit.

Run from the repository root:
    python3 scripts/torch_kernel_sweep.py [--fused-only | --ivf-only | --f32-only]
"""

import argparse
import os
import subprocess
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from photo_search_engine_tpu_torch.ops import _cuda  # noqa: E402
from photo_search_engine_tpu_torch.ops import ivf_scan as io  # noqa: E402
from photo_search_engine_tpu_torch.ops import quantized as qo  # noqa: E402
from photo_search_engine_tpu_torch.ops import topk as to  # noqa: E402
from tests.torch_parity import assert_topk_match, fma_loop  # noqa: E402

ROWS, DIM, K, BLOCK_N = 1_000_000, 1536, 50, 1024
NLIST, LROWS, NPROBE = 1024, 1536, 64  # kernel 7's layout: the ivf phase's IVF_NLIST, L and IVF_NPROBE
SM_SHARED_LIMIT = 232448  # bytes one CTA may use on the H100
_SM_SHARED = 233472  # an SM's shared memory; each resident CTA also reserves 1 KB


def ivf_layout(gen, dtype=torch.bfloat16):
    """Kernel 7's seeded layout: ``(rows [NLIST * LROWS, DIM], row_valid)``."""
    layout = torch.empty((NLIST * LROWS, DIM), dtype=dtype, device="cuda")
    for start in range(0, layout.shape[0], 131072):
        layout[start:start + 131072] = cs._unit_rows(min(131072, layout.shape[0] - start), DIM, gen, dtype)
    fill = torch.randint(LROWS // 2, LROWS + 1, (NLIST,), generator=gen, device="cuda")
    valid = (torch.arange(LROWS, device="cuda")[None, :] < fill[:, None]).to(torch.int8).reshape(-1)
    return layout, valid


def ivf_probes(gen, batch):
    probes = torch.rand((batch, NLIST), generator=gen, device="cuda").argsort(dim=1)[:, :NPROBE]
    return torch.sort(probes, dim=1).values.to(torch.int32).contiguous()


def ivf_sweep(card) -> int:
    """Kernel 7's tile and group size on the tensor cores, by batch."""
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    layout, valid = ivf_layout(gen)
    l8, ls = qo.quantize_rows(layout)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    settings = [(bn, bq) for bn in (512, 768, 1536) for bq in io.IVF_BQ]
    for batch in (1, 8, 32, 128, 256):
        probes = ivf_probes(gen, batch)
        q16 = cs._unit_rows(batch, DIM, gen, torch.bfloat16)
        q8, qs = io.quantize_ivf_queries(q16.float())
        rule = io.ivf_geometry(batch, NPROBE, NLIST, LROWS, "tensor_core", sms)
        probed = int(torch.unique(probes).numel())
        groups = {bq: int((io.ivf_work_list(probes, NLIST, bq)[0][:, 2] > 0).sum()) for bq in io.IVF_BQ}
        for tier, args, kk, extra in (("bf16", (layout, q16), K, {}),
                                      ("int8", (l8, q8), 64, dict(qscales=qs, cscales=ls))):
            def run(bn, bq):
                return io.ivf_block_topk(*args, probes, valid, kk, lrows=LROWS, block_n=bn, bq=bq, **extra)

            want = to.merge_partials(*run(*rule), kk)
            times = {s: [] for s in settings}
            for s in settings + settings[::-1]:  # two passes in opposite orders: clocks settle meanwhile
                assert_topk_match(*to.merge_partials(*run(*s), kk), *want, tol=1e-5, exact=tier == "int8")
                times[s].append(cs.cuda_ms(lambda: run(*s), reps=5))
            best = min(times, key=lambda s: sum(times[s]))
            cells = ", ".join(f"bn {bn} / BQ {bq}: {a:.3f}/{b:.3f}" for (bn, bq), (a, b) in times.items())
            print(f"{card}: kernel 7 {tier} batch {batch} top-{kk} (nprobe {NPROBE}, {probed} clusters probed, "
                  f"{batch * NPROBE / probed:.2f} pairs a cluster; groups: {groups[8]} of 8, {groups[32]} of 32; "
                  f"merged results agree with the rule's) ms, forward / backward pass: {cells}; "
                  f"rule bn {rule[0]} / BQ {rule[1]}, fastest bn {best[0]} / BQ {best[1]}", flush=True)
    return 0


def f32_times(card) -> int:
    """float32 kernels 1 and 7 on the ring (fmaf consumers) and on the FMA
    loop, side by side, against their plain versions, bounds and library
    compositions, at batches 1, 8, 128 and 256."""
    torch.backends.cuda.matmul.allow_tf32 = False  # a full-precision library product, as the kernels
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    corpus = torch.empty((ROWS, DIM), dtype=torch.float32, device="cuda")
    for start in range(0, ROWS, 131072):
        corpus[start:start + 131072] = cs._unit_rows(min(131072, ROWS - start), DIM, gen, torch.float32)
    kw = dict(count=ROWS, block_n=BLOCK_N)
    nb = -(-ROWS // BLOCK_N)
    for batch in (1, 8, 128, 256):
        queries = cs._unit_rows(batch, DIM, gen, torch.float32)
        ring = to.block_topk(corpus, queries, K, **kw)
        with fma_loop():
            fma = to.block_topk(corpus, queries, K, **kw)
            fma_ms = cs.cuda_ms(lambda: to.block_topk(corpus, queries, K, **kw), reps=2)
        same = torch.equal(ring[0].view(torch.int32), fma[0].view(torch.int32)) and torch.equal(ring[1], fma[1])
        ms, pms, bound, by, lib, (a, b, _, _) = cs.time_kernel(
            ("block_topk f32", batch, K), lambda: to.block_topk(corpus, queries, K, **kw),
            lambda: to.exact_block_topk_plain(corpus, queries, K, **kw),
            lambda: torch.topk(torch.matmul(queries, corpus.T), K),
            cs.nbytes(corpus, queries) + batch * nb * K * 8, 2.0 * batch * ROWS * DIM, "f32", reps=5)
        print(f"{card}: kernel 1 f32 batch {batch} top-{K} at {ROWS}x{DIM}: ring {ms:.3f} ms ({a:.3f}/{b:.3f}), "
              f"FMA loop {fma_ms:.3f} ms (partials bit for bit the ring's: {same}), plain {pms:.3f} ms, bound "
              f"{bound:.3f} ms by {by}, library {lib:.3f} ms (cuBLAS f32, TF32 off, + torch.topk)", flush=True)
    del corpus, ring, fma
    layout, valid = ivf_layout(gen, torch.float32)
    ivf = types.SimpleNamespace(_row_valid=valid, nlist=NLIST, capacity=LROWS, _corpus=layout)
    for batch in (1, 8, 128, 256):
        probes = ivf_probes(gen, batch)
        queries = cs._unit_rows(batch, DIM, gen, torch.float32)
        pairs, probed = batch * NPROBE, int(torch.unique(probes).numel())
        library, label = cs._ivf_library(ivf, probes, queries, False)
        rows_moved, padded, scored = cs.ivf_scan_work(valid, NLIST, LROWS, probes, DIM * 4)
        _, tile, bq = io.ivf_launch(layout, probes, LROWS, K)
        rest = cs.nbytes(queries, probes) + pairs * -(-LROWS // tile) * K * 8
        padded_bound = cs.bound_ms(padded + rest, 2.0 * pairs * LROWS * DIM, "f32")[0]
        with fma_loop():
            fma_ms = cs.cuda_ms(lambda: io.ivf_block_topk(layout, queries, probes, valid, K, lrows=LROWS), reps=3)
        ms, pms, bound, by, lib, _ = cs.time_kernel(
            ("ivf_block_topk f32", batch, K), lambda: io.ivf_block_topk(layout, queries, probes, valid, K, lrows=LROWS),
            lambda: io.ivf_block_topk_plain(layout, queries, probes, valid, K, lrows=LROWS, block_n=tile), library,
            rows_moved + rest, 2.0 * scored * DIM, "f32", reps=5)
        print(f"{card}: kernel 7 f32 batch {batch} top-{K} (nprobe {NPROBE} of {NLIST}, L {LROWS}, {probed} "
              f"clusters probed): ring {ms:.3f} ms (bn {tile}, BQ {bq}), FMA loop {fma_ms:.3f} ms, plain {pms:.3f} "
              f"ms, bound {bound:.3f} ms by {by} (live rows; {padded_bound:.3f} ms counting the padding slots), "
              f"library {lib:.3f} ms ({label}; TF32 off)", flush=True)
    return 0


def geometry_scan(corpus, queries, k, block_n, stages, threshold):
    """Kernel 1 (bf16, tensor cores) at ``block_n``, a ring of ``stages``
    and the threshold (True) or k-round selection: ``[Q, NB, k]`` partials."""
    (n, d), q = corpus.shape, queries.shape[0]
    nb = -(-n // block_n)
    out_v = torch.empty((q, nb, k), dtype=torch.float32, device=corpus.device)
    out_i = torch.empty((q, nb, k), dtype=torch.int32, device=corpus.device)
    err = _cuda.library().pse_block_topk_bf16_geometry(
        _cuda.ptr(corpus), _cuda.ptr(queries), None, None, None, _cuda.ptr(out_v), _cuda.ptr(out_i),
        n, d, q, n, k, block_n, 0, stages, int(threshold), _cuda.stream(corpus.device))
    _cuda.check(err, "pse_block_topk_bf16_geometry")
    return out_v, out_i


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fused-only", action="store_true", help="sweep kernel 4's blocks per range only")
    parser.add_argument("--ivf-only", action="store_true", help="sweep kernel 7's tile and group size only")
    parser.add_argument("--f32-only", action="store_true", help="time the float32 kernels 1 and 7 only, ring and "
                        "FMA loop")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.ivf_only:
        return ivf_sweep(card)
    if args.f32_only:
        return f32_times(card)
    consts = _cuda.header_constants("block_score_tc.cuh")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    corpus = torch.empty((ROWS, DIM), dtype=torch.bfloat16, device="cuda")
    for start in range(0, ROWS, 131072):
        corpus[start:start + 131072] = cs._unit_rows(min(131072, ROWS - start), DIM, gen, torch.bfloat16)
    nb = -(-ROWS // BLOCK_N)
    kw = dict(count=ROWS, block_n=BLOCK_N)
    for batch in (1, 8, 32, 128, 256):
        queries = cs._unit_rows(batch, DIM, gen, torch.bfloat16)
        want = to.merge_partials(*to.block_topk(corpus, queries, K, **kw), K)
        if args.fused_only:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            ranges, per = to.fused_ranges(batch, nb, sms, block_n=BLOCK_N, k=K, loop="tensor_core")
            settings = (None, 1, 2, 3, 4, 5, 8, 15, 30)
            times = {blocks: [] for blocks in settings}
            for blocks in settings + settings[::-1]:  # two passes in opposite orders: clocks settle meanwhile
                run = lambda: to.fused_topk(corpus, queries, K, blocks_per_range=blocks, **kw)  # noqa: E731
                got = run()[:2]
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"kernel 4 at {blocks} blocks per range differs from kernel 1's top-{K}")
                times[blocks].append(cs.cuda_ms(run, reps=5))
            fused = [f"{blocks or f'default {per}'}: {a:.3f}/{b:.3f}" for blocks, (a, b) in times.items()]
            print(f"{card}: batch {batch} kernel 4 (tensor cores) by blocks per range (default {per}, {ranges} "
                  f"ranges; top-{K} identical to kernel 1's; ms, forward / backward pass) {', '.join(fused)}",
                  flush=True)
            continue
        k1 = cs.cuda_ms(lambda: to.block_topk(corpus, queries, K, **kw), reps=5)
        k1_1 = cs.cuda_ms(lambda: to.block_topk(corpus, queries, 1, **kw), reps=5)
        k3 = cs.cuda_ms(lambda: to.fast_block_topk(corpus, queries, K, **kw), reps=5)
        k3_1 = cs.cuda_ms(lambda: to.fast_block_topk(corpus, queries, 1, **kw), reps=5)
        k4 = cs.cuda_ms(lambda: to.fused_topk(corpus, queries, K, **kw), reps=5)
        lib = cs.cuda_ms(lambda: torch.topk(torch.matmul(queries, corpus.T), K), reps=5)
        print(f"{card}: batch {batch} top-{K} at {ROWS}x{DIM} bf16, tensor cores: kernel 1 {k1:.3f} ms "
              f"(k=1 {k1_1:.3f}), kernel 3 {k3:.3f} ms (k=1 {k3_1:.3f}), kernel 4 {k4:.3f} ms, "
              f"cuBLAS + torch.topk {lib:.3f} ms", flush=True)
        bq = consts["kSmallBQ"] if batch <= consts["kSmallBQ"] else consts["kLargeBQ"]
        timed = []
        s4, s6 = consts["kStages"], consts["kSweepStages"]
        geometries = [(bn, st, True) for bn in (512, 1024, 2048) for st in (2, s4, s6)]
        geometries += [(BLOCK_N, s4, False)]  # the k rounds: the selection's share
        for block_n, stages, threshold in geometries:
            smem = to.tc_shared_bytes(bq, stages)
            if smem > SM_SHARED_LIMIT:
                continue
            scan = lambda kk: geometry_scan(corpus, queries, kk, block_n, stages, threshold)  # noqa: E731
            got = to.merge_partials(*scan(K), K)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"geometry bn {block_n}, {stages} stages, threshold {threshold}: "
                                     f"its top-{K} differs from kernel 1's")
            ms, ms1 = cs.cuda_ms(lambda: scan(K), reps=5), cs.cuda_ms(lambda: scan(1), reps=5)
            per_sm = _SM_SHARED // (smem + 1024)
            timed.append(f"bn {block_n} / {stages} stages / {'threshold' if threshold else 'rounds'} "
                         f"({smem} B, {per_sm} CTAs an SM): {ms:.3f} (k=1 {ms1:.3f})")
        print(f"{card}: batch {batch} kernel 1 geometries (BQ {bq}; ms, merged top-{K} identical to kernel 1's): "
              + "; ".join(timed), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

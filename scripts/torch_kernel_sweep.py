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
identical to kernel 1 followed by ``merge_partials``.  Times are CUDA
events over 5 calls after one warm-up (``chip_smoke.cuda_ms``); each line
names the card and its power limit.

Run from the repository root:  python3 scripts/torch_kernel_sweep.py [--fused-only]
"""

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from photo_search_engine_tpu_torch.ops import _cuda  # noqa: E402
from photo_search_engine_tpu_torch.ops import topk as to  # noqa: E402

ROWS, DIM, K, BLOCK_N = 1_000_000, 1536, 50, 1024
SM_SHARED_LIMIT = 232448  # bytes one CTA may use on the H100
_SM_SHARED = 233472  # an SM's shared memory; each resident CTA also reserves 1 KB


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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
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

#!/usr/bin/env python3
"""Kernel 1, kernel 3 and kernel 4 of the PyTorch port side by side on one
CUDA card: 1M x 1536 bfloat16 unit rows made on the card from a seed,
top-50, batches 1, 8, 32 and 128; kernel 4 at its default blocks per range
(``ops/topk.fused_ranges``) and at 1, 2, 4, 8, 15 and 30.  Times are CUDA
events over 5 calls after one warm-up (``chip_smoke.cuda_ms``); each line
names the card.

Run from the repository root:  python3 scripts/torch_kernel_sweep.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from photo_search_engine_tpu_torch.ops import topk as to  # noqa: E402

ROWS, DIM, K, BLOCK_N = 1_000_000, 1536, 50, 1024


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    card = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    corpus = torch.empty((ROWS, DIM), dtype=torch.bfloat16, device="cuda")
    for start in range(0, ROWS, 131072):
        corpus[start:start + 131072] = cs._unit_rows(min(131072, ROWS - start), DIM, gen, torch.bfloat16)
    nb = -(-ROWS // BLOCK_N)
    for batch in (1, 8, 32, 128):
        queries = cs._unit_rows(batch, DIM, gen, torch.bfloat16)
        kw = dict(count=ROWS, block_n=BLOCK_N)
        k1 = cs.cuda_ms(lambda: to.block_topk(corpus, queries, K, **kw), reps=5)
        k3 = cs.cuda_ms(lambda: to.fast_block_topk(corpus, queries, K, **kw), reps=5)
        fused = []
        for per in (None, 1, 2, 4, 8, 15, 30):
            ms = cs.cuda_ms(lambda: to.fused_topk(corpus, queries, K, blocks_per_range=per, **kw), reps=5)
            fused.append(f"{per or 'default'}: {ms:.3f}")
        ranges, per = to.fused_ranges(batch, nb, block_n=BLOCK_N, k=K)
        print(f"{card}: batch {batch} top-{K} at {ROWS}x{DIM} bf16: kernel 1 {k1:.3f} ms, kernel 3 {k3:.3f} ms, "
              f"kernel 4 by blocks per range (default {per}, {ranges} ranges) {', '.join(fused)} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Judge kind ``int8_tier``: the int8 tier with exact rescore (Qdrant's
scalar quantization with rescoring; the port's ``STORE_QUANTIZED=1``).
Rows and the query quantized per row to ``levels`` (``reference.quantize``:
absmax·(1/levels), rounded half to even, clipped), quantized scores
float32(int dot)·q_scale·row_scale, each block of ``block_rows`` rows keeps
its ``kloc`` best, the ``pool`` best of those are rescored exactly and the k
best of the pool returned, ties to the smallest row, reported with their
exact scores."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import reference


def int8_tier(corpus: torch.Tensor, queries: np.ndarray, k: int, *, levels: int, block_rows: int,
              kloc: int, pool: int) -> torch.Tensor:
    """Row ids ``[S, k]`` of the int8 tier with exact rescore, in its order."""
    if reference.CHUNK_ROWS % block_rows:
        raise ValueError(f"block_rows {block_rows} must divide {reference.CHUNK_ROWS}")
    dev, n = corpus.device, corpus.shape[0]
    qq, qs = reference.quantize(torch.from_numpy(queries).to(dev), levels)
    part_v, part_i = [], []
    for start in range(0, n, reference.CHUNK_ROWS):
        stop = min(n, start + reference.CHUNK_ROWS)
        blocks = -(-(stop - start) // block_rows)
        scores = torch.nn.functional.pad(
            reference.quantized_scores(qq, qs, corpus, start, stop, levels),
            (0, blocks * block_rows - (stop - start)), value=float("-inf"),
        ).view(qq.shape[0], blocks, block_rows)
        vals, pos = reference.stable_top(scores, min(kloc, block_rows))
        first = start + block_rows * torch.arange(blocks, device=dev)[None, :, None]
        part_v.append(vals.flatten(1))
        part_i.append((pos + first).flatten(1))
    cand_v, pos = reference.stable_top(torch.cat(part_v, dim=1), pool)
    cand_i = torch.gather(torch.cat(part_i, dim=1), 1, pos)
    exact = reference.exact_scores(corpus, reference.operand(queries, corpus), cand_i)
    exact = torch.where(torch.isneginf(cand_v) | (cand_i >= n), float("-inf"), exact)
    _, order = reference.stable_top(exact, k)
    return torch.gather(cand_i, 1, order)


def answer(spec: Dict, corpus: torch.Tensor, queries: np.ndarray, k: int):
    ids = int8_tier(corpus, queries, k, levels=int(spec["levels"]), block_rows=int(spec["block_rows"]),
                    kloc=int(spec["kloc"]), pool=int(spec["pool"]))
    return ids, reference.exact_scores(corpus, reference.operand(queries, corpus), ids)

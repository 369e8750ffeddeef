"""Judge kind ``exact_thinned`` (a fault: rows left out of the index): the
exact top-k over the library with a share ``spec["share"]`` of its rows
withheld, drawn by ``spec["seed"]``, reported with the exact scores.  An
index that loses that many rows misses about that share of the exact
top-k."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import reference


def answer(spec: Dict, corpus: torch.Tensor, queries: np.ndarray, k: int):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(spec["seed"]))
    out = (torch.rand(corpus.shape[0], generator=gen) < float(spec["share"])).to(corpus.device)  # each row withheld
    q_op = reference.operand(queries, corpus)

    def scores(a: int, b: int) -> torch.Tensor:
        return torch.where(out[a:b], float("-inf"), q_op @ corpus[a:b].double().T)

    vals, ids = reference.chunked_top(scores, corpus.shape[0], k)
    return ids, vals

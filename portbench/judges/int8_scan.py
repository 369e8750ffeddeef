"""Judge kind ``int8_scan`` (a control, or the fault "rescore left out"):
the k rows of the highest quantized score at ``spec["levels"]``, reported
with their quantized scores, no rescore."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import reference


def int8_scan(corpus: torch.Tensor, queries: np.ndarray, k: int, levels: int):
    """The k rows of the highest quantized score and those scores."""
    qq, qs = reference.quantize(torch.from_numpy(queries).to(corpus.device), levels)
    vals, ids = reference.chunked_top(lambda a, b: reference.quantized_scores(qq, qs, corpus, a, b, levels),
                                      corpus.shape[0], k)
    return ids, vals.double()


def answer(spec: Dict, corpus: torch.Tensor, queries: np.ndarray, k: int):
    return int8_scan(corpus, queries, k, int(spec["levels"]))

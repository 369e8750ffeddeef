"""Judge kind ``exact``: the k rows of the highest score
(``reference.exact_scores``), ties to the smallest row, reported with those
scores."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench import reference


def exact_topk(corpus: torch.Tensor, q_op: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best rows by float64 score: ``(scores, ids)``."""
    return reference.chunked_top(lambda a, b: q_op @ corpus[a:b].double().T, corpus.shape[0], k)


def answer(spec: Dict, corpus: torch.Tensor, queries: np.ndarray, k: int):
    scores, ids = exact_topk(corpus, reference.operand(queries, corpus), k)
    return ids, scores

"""Judge kind ``ivf_recall``: an IVF_FLAT index (FAISS's ``IndexIVFFlat``,
Milvus's IVF_FLAT) judged against the exact answer.

``answer`` is the exact top-k (the k rows of the highest float64 score,
ties to the smallest row), so ``rank_gap`` reads how far below the exact
j-th score the j-th served row lies: the recall lost to the lists left
unprobed.  ``numbers`` adds ``recall_miss``, the share of the exact top-k
that the served lists miss, over every sampled request.

:func:`probed_topk` is the index's semantics, for a check against the
index's own state (centroids, ``perm``, list capacity): each query's
``nprobe`` nearest lists by ``2·q·c − ‖c‖²``, ties to the smallest list,
then the exact top-k over the live rows of those lists.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench import reference


def _exact(corpus: torch.Tensor, queries: np.ndarray, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    q_op = reference.operand(queries, corpus)
    return reference.chunked_top(lambda a, b: q_op @ corpus[a:b].double().T, corpus.shape[0], k)


def answer(spec: Dict, corpus: torch.Tensor, queries: np.ndarray, k: int):
    scores, ids = _exact(corpus, queries, k)
    return ids, scores


def numbers(spec: Dict, corpus: torch.Tensor, queries: np.ndarray, served_ids: torch.Tensor,
            served_dists: torch.Tensor, k: int) -> Dict[str, float]:
    _, ids = _exact(corpus, queries, k)
    found = (ids[:, :, None] == served_ids[:, None, :]).any(dim=2)
    return {"recall_miss": float(1.0 - found.double().mean()) if found.numel() else float("nan")}


def probe_scores(q_op: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """float64 ``2·q·c − ‖c‖²`` of each query (``reference.operand``) against
    each centroid (float32 values)."""
    c = centroids.double()
    return 2.0 * (q_op @ c.T) - (c * c).sum(dim=1)[None, :]


def probed_topk(corpus: torch.Tensor, queries: np.ndarray, centroids, perm, capacity: int, nprobe: int,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids [S, k], float64 scores [S, k])``: the exact top-k over the live
    rows of each query's ``nprobe`` nearest lists, ties to the smallest row;
    -1 and -inf where the probed lists hold fewer than k rows.  ``perm``
    ``[nlist·capacity]`` names the row of each slot (-1 empty), list-major."""
    dev, n = corpus.device, corpus.shape[0]
    cents = torch.as_tensor(np.asarray(centroids, np.float32), device=dev)
    perm = torch.as_tensor(np.asarray(perm, np.int64), device=dev)
    nlist = cents.shape[0]
    list_of_row = torch.full((n,), nlist, dtype=torch.int64, device=dev)  # nlist: in no list
    live = perm >= 0
    list_of_row[perm[live]] = torch.div(torch.arange(perm.shape[0], device=dev), capacity,
                                        rounding_mode="floor")[live]
    q_op = reference.operand(queries, corpus)
    probed = torch.zeros((q_op.shape[0], nlist + 1), dtype=torch.bool, device=dev)
    probed.scatter_(1, reference.stable_top(probe_scores(q_op, cents), nprobe)[1], True)  # ties to the smallest list

    def scores(a: int, b: int) -> torch.Tensor:
        s = q_op @ corpus[a:b].double().T
        return torch.where(probed[:, list_of_row[a:b]], s, float("-inf"))

    vals, ids = reference.chunked_top(scores, n, k)
    return torch.where(torch.isneginf(vals), -1, ids), vals

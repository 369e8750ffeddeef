"""The plain reference that decides ``correct``, in plain PyTorch and NumPy.

It imports nothing of the program (``photo_search_engine_tpu_torch``),
nothing of JAX and nothing of the JAX package, and takes nothing the
program made: it gets the benchmark's own rows (made again from the seed
once the program is gone), the row each sampled request asked about, and
the program's answers, which it only judges.

The semantics every kind shares:

* ``cosine`` over rows normalized at ingest: a query is its library row,
  normalized in float32 (``normalize_queries``); its score against a row
  is the inner product of the query cast to the rows' dtype with the
  stored row, worked out here in float64 (``exact_scores``).
* per-row absmax quantization to ``±levels`` (``quantize``) and the
  quantized score float32(int dot)·q_scale·row_scale
  (``quantized_scores``), for the int8 kinds.

Each kind of answer (a configuration's ``reference``, ``control`` and
``faults`` blocks name one under ``kind``) is a file of its own,
``portbench/judges/<kind>.py``, found by its name (``manifest.judge``).
It gives ``answer(spec, corpus, queries, k) -> (ids [S, k], reported
distances [S, k] float64)`` for normalized float32 ``queries``, and may
give ``numbers(spec, corpus, queries, served_ids, served_dists, k) ->
{name: float}`` (the served answers as tensors on the corpus's device,
int64 ids with -1 where a hit is missing, float64 distances): numbers of
its own beside the common four, each held by a limit of the
configuration like them.  A kind file imports nothing of
the program and nothing of JAX; it may import this module.

``judge`` turns the program's answers into the numbers ``correct`` is
decided on.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench import manifest

CHUNK_ROWS = 65536  # rows scored at once (a multiple of every block size used)
QUERY_CHUNK = 128  # queries whose gathered rows are widened at once


def normalize_queries(rows_f32: np.ndarray) -> np.ndarray:
    """Cosine queries: each row over its float32 norm (zero rows kept)."""
    norms = np.linalg.norm(rows_f32, axis=1, keepdims=True)
    return np.where(norms > 0, rows_f32 / np.maximum(norms, 1e-30), rows_f32).astype(np.float32)


def operand(queries: np.ndarray, corpus: torch.Tensor) -> torch.Tensor:
    """The queries as the scan multiplies them: cast to the rows' dtype,
    held in float64."""
    return torch.from_numpy(queries).to(corpus.device).to(corpus.dtype).double()


def exact_scores(corpus: torch.Tensor, q_op: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """float64 score of each query against each of its rows ``ids`` ``[S, k]``
    (ids outside the corpus read row 0; the caller masks them)."""
    n = corpus.shape[0]
    out = torch.empty(ids.shape, dtype=torch.float64, device=corpus.device)
    safe = ids.clamp(0, n - 1)
    for s in range(0, ids.shape[0], QUERY_CHUNK):
        rows = corpus[safe[s : s + QUERY_CHUNK]].double()
        out[s : s + QUERY_CHUNK] = torch.einsum("sd,skd->sk", q_op[s : s + QUERY_CHUNK], rows)
    return out


def stable_top(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the smallest position."""
    vals, pos = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def chunked_top(score_rows, n: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over rows ``[0, n)`` of ``score_rows(start, stop)``, ties to the
    smallest row: each chunk's top-k, merged with the earlier rows first."""
    best_v = best_i = None
    for start in range(0, n, CHUNK_ROWS):
        stop = min(n, start + CHUNK_ROWS)
        vals, pos = stable_top(score_rows(start, stop), min(k, stop - start))
        ids = pos + start
        if best_v is not None:
            vals, pos = stable_top(torch.cat([best_v, vals], dim=1), k)
            ids = torch.gather(torch.cat([best_i, ids], dim=1), 1, pos)
        best_v, best_i = vals, ids
    return best_v, best_i


def quantize(x: torch.Tensor, levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax quantization of float32 ``x`` to ``±levels``:
    ``(integer values as float32, scales float32)``; zero rows get scale 0."""
    x = x.float()
    scale = x.abs().amax(dim=1, keepdim=True) * (1.0 / levels)
    q = torch.clamp(torch.round(x / torch.clamp(scale, min=1e-30)), -levels, levels)
    return q, scale[:, 0]


def quantized_scores(qq: torch.Tensor, qs: torch.Tensor, corpus: torch.Tensor, start: int, stop: int,
                     levels: int) -> torch.Tensor:
    """float32(exact integer dot) · query scale · row scale for rows ``[start, stop)``."""
    rq, rs = quantize(corpus[start:stop], levels)
    acc = (qq.double() @ rq.double().T).float()
    return acc * qs[:, None] * rs[None, :]


def judge(spec: Dict, corpus: torch.Tensor, query_rows: np.ndarray, readback: np.ndarray,
          served_ids: np.ndarray, served_dists: np.ndarray, k: int, root: str) -> Dict[str, float]:
    """The numbers ``correct`` is decided on, for the sampled requests:

    * ``readback_err``: the widest gap between the query row the program
      read back and the benchmark's row (exact: 0);
    * ``bad_hits``: hits that name no row of the library, repeat a row, or
      are missing from a list shorter than k (exact: 0);
    * ``dist_err``: the widest gap between a served distance and the
      reference score of the row it names;
    * ``rank_gap``: the widest amount by which the reference score of the
      j-th served row lies below the j-th of the answer of the kind that
      ``spec`` names, over the lists with no bad hit;
    * and the kind's own ``numbers``, where it gives any.
    The kind is ``portbench/judges/<kind>.py`` of the checkout at ``root``.
    ``served_ids`` ``[S, k]`` holds -1 where a hit is missing."""
    kind = manifest.judge(spec["kind"], root)
    n, dev = corpus.shape[0], corpus.device
    rows_f32 = corpus[torch.from_numpy(query_rows).to(dev)].float().cpu().numpy()
    readback_err = float(np.max(np.abs(readback - rows_f32))) if len(query_rows) else float("nan")
    queries = normalize_queries(rows_f32)
    ids = torch.from_numpy(served_ids).to(dev)
    invalid = (ids < 0) | (ids >= n)
    ranked = torch.sort(torch.where(invalid, -1 - torch.arange(k, device=dev), ids), dim=1).values
    repeated = torch.zeros_like(invalid)
    repeated[:, 1:] = ranked[:, 1:] == ranked[:, :-1]
    scores = exact_scores(corpus, operand(queries, corpus), ids)
    dists = torch.from_numpy(served_dists).to(dev)
    dist_err = torch.where(invalid, 0.0, (dists - scores).abs())
    _, ref_scores = kind.answer(spec, corpus, queries, k)
    clean = ~(invalid.any(dim=1) | repeated.any(dim=1))
    gaps = (ref_scores - scores)[clean]
    numbers = {
        "readback_err": readback_err,
        "bad_hits": int(invalid.sum() + repeated.sum()),
        "dist_err": float(dist_err.max()) if dist_err.numel() else float("nan"),
        "rank_gap": float(gaps.max()) if gaps.numel() else float("nan"),
    }
    if hasattr(kind, "numbers"):
        extra = kind.numbers(spec, corpus, queries, ids, dists, k)
        if set(extra) & set(numbers):  # a kind adds numbers; it never replaces a common one
            raise ValueError(f"judge kind {spec['kind']!r} returns {sorted(set(extra) & set(numbers))}")
        numbers.update(extra)
    return numbers

"""The library the benchmark serves, made from ``--seed``: its embedding
rows on the device and one metadata dict a row.

Rows are unit vectors of low intrinsic dimension that come in bursts of
near-duplicate shots (a photo library's bursts), the structure of the
repo's recall tools (``tools/recall_eval.py synthetic_corpus``) with a
burst term added.  With ``c`` the configuration's ``corpus`` block:

    u     = normalize(z @ B)                       z ~ N(0, I_r), B ~ N(0, 1/r), r = c["intrinsic"]
    scene = normalize(u + c["scene_noise"] · g / sqrt(D))     one per burst of c["burst"] rows
    row   = normalize(scene + c["shot_noise"] · h / sqrt(D))  in the served dtype

made on the device by one ``torch.Generator`` seeded with the seed, in
chunks of whole bursts.  The same seed on the same device gives the same
bits: the reference makes the rows again once the program is gone and
checks them against :func:`checksum`.
"""

from __future__ import annotations

import gc
import math
from typing import Dict, List

import torch

CHUNK_ROWS = 262144  # rows per generation step (a multiple of every burst size used)
SEED_MODULUS = 2 ** 63


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-30)


def make_rows(cfg: Dict, seed: int, device, dtype) -> torch.Tensor:
    """``[cfg["rows"], cfg["dim"]]`` unit rows in ``dtype`` on ``device``."""
    n, d, c = int(cfg["rows"]), int(cfg["dim"]), cfg["corpus"]
    r, burst = int(c["intrinsic"]), int(c["burst"])
    if CHUNK_ROWS % burst:
        raise ValueError(f"burst {burst} must divide {CHUNK_ROWS}")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_MODULUS)
    basis = torch.randn((r, d), generator=gen, device=device) / math.sqrt(r)
    out = torch.empty((n, d), dtype=dtype, device=device)
    for start in range(0, n, CHUNK_ROWS):
        m = min(CHUNK_ROWS, n - start)
        scenes = -(-m // burst)
        u = _normalize(torch.randn((scenes, r), generator=gen, device=device) @ basis)
        u += torch.randn((scenes, d), generator=gen, device=device) * (float(c["scene_noise"]) / math.sqrt(d))
        shots = _normalize(u).repeat_interleave(burst, dim=0)[:m]
        shots += torch.randn((m, d), generator=gen, device=device) * (float(c["shot_noise"]) / math.sqrt(d))
        out[start : start + m] = _normalize(shots).to(dtype)
        del u, shots
    return out


def checksum(rows: torch.Tensor) -> int:
    """An exact integer digest of the rows' bits that changes when a row
    changes or two rows trade places."""
    total = 0
    width = rows.element_size()
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32}[width]
    for start in range(0, rows.shape[0], CHUNK_ROWS):
        chunk = rows[start : start + CHUNK_ROWS].contiguous().view(bits)
        per_row = chunk.sum(dim=1, dtype=torch.int64)
        weight = torch.arange(start, start + chunk.shape[0], device=rows.device, dtype=torch.int64) % 65521 + 1
        total += int((per_row * weight).sum())
    return total


PATH_PREFIX = "/library/"
PATH_SUFFIX = ".jpg"


def library_paths(n: int) -> List[str]:
    """The ``photo_path`` of every row, in row order."""
    return list(map((PATH_PREFIX + "{:07d}" + PATH_SUFFIX).format, range(n)))


def metadata(paths: List[str]) -> List[Dict[str, str]]:
    """One dict a row, as the indexer stores it (``photo_path``, ``file_name``)."""
    skip = len(PATH_PREFIX)
    gc.disable()  # millions of new dicts: no collection while they are made
    try:
        return [{"photo_path": p, "file_name": p[skip:]} for p in paths]
    finally:
        gc.enable()


def row_of(path) -> int:
    """The row a served ``photo_path`` names, or -1 for one this library
    does not hold."""
    if not isinstance(path, str) or not path.startswith(PATH_PREFIX) or not path.endswith(PATH_SUFFIX):
        return -1
    digits = path[len(PATH_PREFIX) : -len(PATH_SUFFIX)]
    return int(digits) if digits.isdigit() else -1

"""Map ``PSE_PLATFORM`` to a ``torch.device``.

Counterpart of ``photo_search_engine_tpu/api/app.py``
``_apply_platform_override``: unset, ``gpu`` or ``cuda`` select the CUDA
card; ``cpu`` selects the host.  A request for CUDA on a machine without
it raises — the port never falls back to the CPU silently, because a
CPU run of a GPU deployment measures nothing its users pay for.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

_CUDA_NAMES = {"", "gpu", "cuda"}


def resolve_device(platform: Optional[str] = None) -> torch.device:
    """The device ``platform`` (default: ``$PSE_PLATFORM``) names."""
    wanted = (
        os.environ.get("PSE_PLATFORM", "") if platform is None else platform
    ).strip().lower()
    if wanted == "cpu":
        return torch.device("cpu")
    if wanted not in _CUDA_NAMES:
        raise ValueError(f"PSE_PLATFORM must be cpu, gpu or cuda, got {wanted!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"PSE_PLATFORM={wanted or '(unset)'} asks for a CUDA device but "
            "torch.cuda.is_available() is False; set PSE_PLATFORM=cpu to run "
            "on the host"
        )
    # The JAX package scores float32 corpora at Precision.HIGHEST
    # (ops/topk.py _dot_precision); TF32 keeps ~3 decimal digits and would
    # reorder near-tied neighbours, so every float32 product here is IEEE.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")

"""Device-memory capacity model for the device-resident store.

Counterpart of ``photo_search_engine_tpu/core/capacity.py`` with the same
arithmetic and the same :class:`DeviceCapacityError`: an append or
install past the card's memory raises, with the capacity math in the
message, BEFORE allocating, instead of dying in a CUDA out-of-memory
error halfway through a grow-copy.

Per device: the primary corpus is ``capacity × dim × itemsize`` bytes;
the int8 shadow adds ``capacity × (dim + 4)``; a grow-copy holds the old
and the new buffer at once; everything else rides in the safety margin
``PSE_HBM_SAFETY`` (default 0.90).  The budget is ``PSE_HBM_BYTES`` when
set (0 disables the check), else the card's total memory from
``torch.cuda.mem_get_info``; on the CPU the check is off.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

_DEFAULT_SAFETY = 0.90


class DeviceCapacityError(RuntimeError):
    """A store operation would exceed the device memory budget."""


def device_hbm_budget(device=None) -> Optional[int]:
    """Usable device-memory budget in bytes, or ``None`` when the check is
    off (a CPU device with no explicit budget, or ``PSE_HBM_BYTES=0``)."""
    env = os.environ.get("PSE_HBM_BYTES", "").strip()
    if env:
        value = int(env)
        return value if value > 0 else None
    if device is None or torch.device(device).type != "cuda":
        return None
    _free, total = torch.cuda.mem_get_info(torch.device(device))
    return int(total)


def safety_factor() -> float:
    return float(os.environ.get("PSE_HBM_SAFETY", _DEFAULT_SAFETY))


def store_bytes(capacity: int, dim: int, itemsize: int, quantized: bool) -> int:
    """Resident bytes of one store at ``capacity`` padded rows."""
    primary = capacity * dim * itemsize
    shadow = capacity * (dim + 4) if quantized else 0
    return primary + shadow


def max_rows_for_budget(
    dim: int, itemsize: int, quantized: bool, budget: Optional[int]
) -> Optional[int]:
    """Largest steady-state row count the budget holds."""
    if budget is None:
        return None
    per_row = dim * itemsize + ((dim + 4) if quantized else 0)
    return int(budget * safety_factor()) // per_row


def check_store_allocation(
    new_capacity: int,
    old_capacity: int,
    dim: int,
    itemsize: int,
    quantized: bool,
    *,
    device=None,
    extra_bytes: int = 0,
    what: str = "embedding store growth",
) -> None:
    """Raise :class:`DeviceCapacityError` if allocating ``new_capacity``
    rows while ``old_capacity`` rows (and ``extra_bytes`` of other input)
    are still resident would exceed the budget of ``device``."""
    budget = device_hbm_budget(device)
    if budget is None:
        return
    usable = int(budget * safety_factor())
    needed = (
        store_bytes(new_capacity, dim, itemsize, quantized)
        + store_bytes(old_capacity, dim, itemsize, quantized)
        + extra_bytes
    )
    if needed <= usable:
        return
    ceiling = max_rows_for_budget(dim, itemsize, quantized, budget)
    resident_clause = (
        f" and {extra_bytes / 1e9:.2f} GB of resident input" if extra_bytes else ""
    )
    raise DeviceCapacityError(
        f"{what} to {new_capacity} x {dim} rows needs ~{needed / 1e9:.2f} GB "
        f"device memory (incl. the old-buffer copy transient of "
        f"{old_capacity} rows{resident_clause}) but only ~{usable / 1e9:.2f} GB of the "
        f"{budget / 1e9:.2f} GB budget is usable "
        f"(PSE_HBM_SAFETY={safety_factor():.2f}). Single-device ceiling at "
        f"this config is ~{ceiling} rows. Options: drop the int8 shadow "
        f"(STORE_QUANTIZED=0), use bfloat16 storage (STORE_DTYPE=auto), or "
        f"raise PSE_HBM_BYTES if the device has more memory."
    )

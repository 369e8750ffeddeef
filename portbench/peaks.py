"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the least time a piece of work
can take on it.  Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``,
``PEAK_OPS_PER_S``, ``bound_ms``)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}  # f32: outside the tensor cores


def least_seconds(moved_bytes: float, ops: float, unit: str) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the peak rate of their type."""
    return max(moved_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[unit])

"""State carried across from the JAX package to the port.

:func:`store_state_from_jax` reads a ``photo_search_engine_tpu``
``EmbeddingStore`` into a plain dict of numpy arrays;
``EmbeddingStore.from_state`` builds the port's store from it.  Tests and
``chip_smoke.py`` feed both packages the same rows this way.  The dict is
all the store holds: the float32 rows, the live count, the capacity, the
int8 shadow and its scales when the store is quantized, the metric and
the dtype.  (The hashing embedder has no weights: its seed is its state.)

Nothing here imports jax: the JAX store's device arrays are read through
``numpy.asarray``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def store_state_from_jax(store) -> Dict[str, object]:
    """Plain-numpy state of a JAX-package ``EmbeddingStore``."""
    count = int(store.count)
    state: Dict[str, object] = {
        "rows": np.asarray(store.snapshot(), np.float32),
        "count": count,
        "capacity": int(store.capacity),
        "metric": str(store.metric),
        "dtype": str(np.dtype(store.store_dtype).name),
        "rows_i8": None,
        "scales": None,
    }
    if getattr(store, "quantized", False) and count:
        state["rows_i8"] = np.asarray(store._device_i8)[:count].astype(np.int8)
        state["scales"] = np.asarray(store._scales).reshape(-1)[:count].astype(np.float32)
    return state

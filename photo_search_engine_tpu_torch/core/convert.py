"""State carried across from the JAX package to the port.

:func:`store_state_from_jax` reads a ``photo_search_engine_tpu``
``EmbeddingStore`` into a plain dict of numpy arrays;
``EmbeddingStore.from_state`` builds the port's store from it.  The dict
is all the store holds: the float32 rows, the live count, the capacity,
the int8 shadow and its scales when the store is quantized, the metric and
the dtype.  :func:`ivf_state_from_jax` does the same for a trained
``IVFIndex``, for ``models/ivf.IVFIndex.from_state``.  Tests feed both
packages the same rows and the same trained index this way.  (The hashing
embedder has no weights: its seed is its state.)

Nothing here imports jax: the JAX arrays are read through
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


def ivf_state_from_jax(index) -> Dict[str, object]:
    """Plain-numpy state of a JAX-package ``IVFIndex``: its ``state()``
    (centroids, perm, capacity, metric), its store dtype and int8 flag, and
    ``rows``, the corpus rows in their original order as the layout holds
    them (store-dtype values, the lane padding of D dropped).  The port's
    ``IVFIndex.from_state(state["rows"], state, store_dtype=state["dtype"],
    quantized=state["quantized"])`` then holds the same layout."""
    state = dict(index.state())
    perm = np.asarray(state["perm"], np.int64)
    live = perm >= 0
    layout = np.asarray(index._corpus).astype(np.float32)[:, : index.dim]
    rows = np.zeros((int(perm[live].max()) + 1 if live.any() else 0, index.dim), np.float32)
    rows[perm[live]] = layout[live]
    state.update(
        rows=rows,
        dtype=str(np.dtype(index._corpus.dtype).name),
        quantized=bool(index.quantized),
    )
    return state

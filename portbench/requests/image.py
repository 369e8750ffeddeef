"""Request shape ``image``: "find similar" on a photo of the library, the
two calls ``/search_by_image`` makes into the vector-search service.

A request shape is a file ``portbench/requests/<shape>.py`` that a
traffic mix names under ``request``; it gives ``warm`` and ``send``.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np


def warm(index, paths: List[str], rows: Sequence[int], k: int, sizes: Sequence[int]) -> None:
    """Search once at every batch size in ``sizes`` with the embeddings of
    ``rows``, so that no shape of the window is new."""
    emb = np.stack([np.asarray(index.get_embedding_by_photo_path(paths[r]), np.float32) for r in rows])
    for b in sizes:
        index.raw_search_batch(emb[:b], k)


def send(index, path: str, k: int, clock: Callable[[], float]):
    """One request about the photo at ``path``: ``(embedding read back,
    time between the two calls, hits)``."""
    vector = index.get_embedding_by_photo_path(path)
    mid = clock()
    return vector, mid, index.search(vector, k)

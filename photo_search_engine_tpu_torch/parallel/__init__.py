"""Multi-device execution: a row-sharded corpus over a mesh of devices,
per-shard partial top-k, a gathered merge.

Counterpart of ``photo_search_engine_tpu/parallel/``: ``sharded.py`` (the
mesh, the sharded searches and store), ``sharded_ivf.py`` (the IVF over
the mesh), ``spmd_serving.py`` (the rank-0 fan-in of multi-process
serving) and ``multihost.py`` (the two-process dry-runs), on
``torch.distributed`` where JAX runs ``jax.distributed``.
"""

from photo_search_engine_tpu_torch.parallel.sharded import (
    ShardedEmbeddingStore,
    make_mesh,
    sharded_exact_search,
    sharded_grouped_search,
    sharded_int8_search,
    sharded_kmeans_step,
)

__all__ = [
    "ShardedEmbeddingStore",
    "make_mesh",
    "sharded_exact_search",
    "sharded_grouped_search",
    "sharded_int8_search",
    "sharded_kmeans_step",
]

"""photo_search_engine_tpu_torch — the PyTorch/CUDA port of photo_search_engine_tpu.

The JAX package's default serving configuration, rebuilt on PyTorch for
one NVIDIA H100: the device embedding store, the flat and IVF vector
indexes, the micro-batcher with its per-query filtered (grouped) scans,
the hashing embedder, the local rerank services and the composition root.
The scan kernels (``csrc/block_topk.cu``: exact and grouped exact;
``csrc/int8_block_topk.cu``: int8 and grouped int8; ``csrc/ivf_topk.cu``:
the IVF probed-cluster scan) are CUDA C++ written for ``sm_90a``, built
with ``nvcc`` at first use and bound with ``ctypes`` (``ops/_cuda.py``).

Host modules of the JAX package that do not depend on JAX (config,
routes, wsgi, searcher, indexer, keyword index, the LLM-backed services)
are reused by import; this package itself never loads JAX.

Layer map:
  device            — PSE_PLATFORM → torch.device
  ops/              — kernel wrappers + their plain PyTorch versions
  csrc/             — the CUDA kernels
  core/             — capacity model, embedding store, vector index,
                      micro-batcher, JAX-store state conversion
  models/           — hashing text embedder, IVF index (k-means, layout)
  services/         — local text / visual rerank
  api/              — composition root + server entry point
"""

__version__ = "0.1.0"

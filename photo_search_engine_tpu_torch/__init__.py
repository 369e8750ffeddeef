"""photo_search_engine_tpu_torch — the PyTorch/CUDA port of photo_search_engine_tpu.

The flat-search serving slice of the JAX package, rebuilt on PyTorch for
one NVIDIA H100: the device embedding store, the flat vector index, the
hashing embedder, the local rerank services and the composition root.
The two scan kernels (``csrc/block_topk.cu``, ``csrc/int8_block_topk.cu``)
are CUDA C++ written for ``sm_90a``, built with ``nvcc`` at first use and
bound with ``ctypes`` (``ops/_cuda.py``).

Host modules of the JAX package that do not depend on JAX (config,
routes, wsgi, searcher, indexer, keyword index, the LLM-backed services)
are reused by import; this package itself never loads JAX.

Layer map:
  device            — PSE_PLATFORM → torch.device
  ops/              — kernel wrappers + their plain PyTorch versions
  csrc/             — the CUDA kernels
  core/             — capacity model, embedding store, vector index,
                      JAX-store state conversion
  models/           — hashing text embedder
  services/         — local text / visual rerank
  api/              — composition root + server entry point
"""

__version__ = "0.1.0"

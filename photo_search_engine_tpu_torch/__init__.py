"""photo_search_engine_tpu_torch — the PyTorch/CUDA port of photo_search_engine_tpu.

The JAX package's serving configurations, rebuilt on PyTorch for one
NVIDIA H100: the device embedding store, the flat and IVF vector indexes,
the micro-batcher with its per-query filtered (grouped) scans, the
offline profile (the hashing embedder, the local rerank services) and the
online profile (an OpenAI-compatible embedding backend, the API text
rerank and the LLM visual rerank), the composition root, and the tools
(``tools/migrate.py`` from a reference FAISS index, ``tools/recall_eval.py``
for recall and latency on the card).  Every public constructor runs on
the device ``PSE_PLATFORM`` names, the card when it is unset, unless the
caller passes another.
The scan kernels (``csrc/block_topk.cu``: exact, packed-key and their
grouped variants; ``csrc/int8_block_topk.cu``: int8 and grouped int8;
``csrc/ivf_topk.cu``: the IVF probed-cluster scan;
``csrc/fused_topk.cu``: the fused running top-k) are CUDA C++ written for
``sm_90a``, built with ``nvcc`` at first use and bound with ``ctypes``
(``ops/_cuda.py``).

The host modules (config, routes, wsgi, searcher, indexer, keyword
index, the LLM-backed services, the native host library) are copies of
the JAX package's that differ only in their import lines: this package
imports nothing of the JAX package and never loads JAX.

Layer map:
  device            — PSE_PLATFORM → torch.device
  ops/              — kernel wrappers + their plain PyTorch versions
  csrc/             — the CUDA kernels
  core/             — capacity model, embedding store, vector index,
                      micro-batcher, JAX-store state conversion
  models/           — hashing text embedder, IVF index (k-means, layout)
  services/         — embedding and text rerank (OpenAI-compatible API,
                      chat model, local), visual rerank (LLM, local)
  api/              — composition root + server entry point, SPA contract
  tools/            — migrate, recall_eval
"""

__version__ = "0.1.0"

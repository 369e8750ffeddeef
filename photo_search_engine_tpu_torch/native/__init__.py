"""Native (C++) host-runtime components.

The TPU compute path is Pallas/XLA (ops/, models/); this package holds the
native host-side runtime pieces — the analogue of the reference's C++ tier
(FAISS internals, SURVEY.md §2 native obligations):

* ``ivf_layout`` — balanced cluster placement for the IVF build (a
  million-iteration placement loop; ~100× over the Python fallback).
* ``bm25`` — packed-postings BM25 scoring core for the keyword index
  (the ES-server replacement's hot path at large corpus sizes).

The shared library is compiled on demand with g++ (no pybind11 — plain C
ABI via ctypes) and every entry point has a pure-Python fallback, so the
framework works even without a toolchain.
"""

from photo_search_engine_tpu_torch.native.loader import get_library, native_available

__all__ = ["get_library", "native_available"]

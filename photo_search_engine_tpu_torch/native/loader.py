"""Compile-on-demand loader for the native library (ctypes, C ABI)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_SOURCES = ("ivf_layout.cc", "bm25.cc")
_LIB_NAME = "libpse_native.so"


def _compile() -> Optional[str]:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out_path = os.path.join(_BUILD_DIR, _LIB_NAME)
    sources = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    newest_src = max(os.path.getmtime(s) for s in sources)
    if os.path.exists(out_path) and os.path.getmtime(out_path) >= newest_src:
        return out_path
    command = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        *sources, "-o", out_path,
    ]
    try:
        subprocess.run(
            command, check=True, capture_output=True, timeout=120
        )
        return out_path
    except Exception as exc:  # toolchain missing or compile error
        print(f"[WARN] native library build failed ({exc}); using Python fallbacks")
        return None


def get_library() -> Optional[ctypes.CDLL]:
    """The compiled library, or None when unavailable (callers must have a
    Python fallback)."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _compile()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            print(f"[WARN] native library load failed: {exc}")
            return None
        _configure(lib)
        _LIB = lib
        return _LIB


def _configure(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)

    lib.pse_balanced_layout.argtypes = [
        i32p,              # ranked [n * 3]
        ctypes.c_int64,    # n
        ctypes.c_int64,    # nlist
        ctypes.c_int64,    # capacity
        i64p,              # out cluster_of_row [n]
        i64p,              # out perm [nlist * capacity]
    ]
    lib.pse_balanced_layout.restype = ctypes.c_int64

    lib.pse_bm25_new.argtypes = [ctypes.c_int32]
    lib.pse_bm25_new.restype = ctypes.c_void_p
    lib.pse_bm25_free.argtypes = [ctypes.c_void_p]
    lib.pse_bm25_free.restype = None
    lib.pse_bm25_add_doc.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, i64p, ctypes.c_int64
    ]
    lib.pse_bm25_add_doc.restype = None
    lib.pse_bm25_remove_doc.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.pse_bm25_remove_doc.restype = None
    lib.pse_bm25_doc_count.argtypes = [ctypes.c_void_p]
    lib.pse_bm25_doc_count.restype = ctypes.c_int64
    lib.pse_bm25_field_nnz.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.pse_bm25_field_nnz.restype = ctypes.c_int64
    lib.pse_bm25_field_doc_count.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.pse_bm25_field_doc_count.restype = ctypes.c_int64
    lib.pse_bm25_export_field.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i64p, i64p, i32p, ctypes.c_int64
    ]
    lib.pse_bm25_export_field.restype = ctypes.c_int64
    lib.pse_bm25_export_doc_lens.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i64p, i64p, ctypes.c_int64
    ]
    lib.pse_bm25_export_doc_lens.restype = ctypes.c_int64
    lib.pse_bm25_load_field.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        i64p, i64p, i32p, ctypes.c_int64,   # COO postings
        i64p, i64p, ctypes.c_int64,         # per-doc lengths
    ]
    lib.pse_bm25_load_field.restype = None
    lib.pse_bm25_score_field.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,    # field
        i64p,              # query token ids (unique)
        ctypes.c_int64,    # n query tokens
        ctypes.c_int64,    # min matched terms required
        i64p,              # out doc ids buffer
        f64p,              # out scores buffer
        i64p,              # out matched-term counts buffer
        ctypes.c_int64,    # buffer capacity
    ]
    lib.pse_bm25_score_field.restype = ctypes.c_int64
    lib.pse_bm25_score_field_masked.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,    # field
        i64p,              # query token ids (unique)
        ctypes.c_int64,    # n query tokens
        ctypes.c_int64,    # min matched terms required
        ctypes.POINTER(ctypes.c_uint8),  # allowed-row mask (nullable)
        ctypes.c_int64,    # allowed mask length (rows beyond it: filtered)
        i64p,              # out doc ids buffer
        f64p,              # out scores buffer
        i64p,              # out matched-term counts buffer
        ctypes.c_int64,    # buffer capacity
    ]
    lib.pse_bm25_score_field_masked.restype = ctypes.c_int64
    lib.pse_bm25_score_query.argtypes = [
        ctypes.c_void_p,
        i64p,              # query token ids (unique, known)
        ctypes.c_int64,    # n query tokens
        ctypes.c_int64,    # min matched terms required (per field)
        f64p,              # per-field boosts [n_fields]
        ctypes.c_int32,    # phrase-candidate field id (-1 disables)
        ctypes.c_int64,    # full-match threshold for phrase candidates
        ctypes.POINTER(ctypes.c_uint8),  # allowed-row mask (nullable)
        ctypes.c_int64,    # allowed mask length (rows beyond it: filtered)
        i64p,              # out fused row ids
        f64p,              # out fused scores
        ctypes.c_int64,    # fused capacity
        i64p,              # out candidate positions (into fused rows)
        f64p,              # out candidate raw retrieval_text scores
        ctypes.c_int64,    # candidate capacity
        i64p,              # out candidate count (by ref)
    ]
    lib.pse_bm25_score_query.restype = ctypes.c_int64
    lib.pse_phrase_hits.argtypes = [
        i32p,              # flat packed token streams (-1 separated)
        ctypes.c_int64,    # flat length
        i64p,              # per-row stream start offsets (-1 = no stream)
        i64p,              # per-row stream lengths (incl. separator)
        ctypes.c_int64,    # n rows
        i64p,              # candidate rows
        ctypes.c_int64,    # n candidates
        i32p,              # pattern token ids
        ctypes.c_int64,    # pattern length
        i64p,              # out matching rows (capacity n candidates)
    ]
    lib.pse_phrase_hits.restype = ctypes.c_int64
    lib.pse_phrase_hits_mask.argtypes = [
        i32p,              # flat packed token streams (-1 separated)
        ctypes.c_int64,    # flat length
        i64p,              # per-row stream start offsets (-1 = no stream)
        i64p,              # per-row stream lengths (incl. separator)
        ctypes.c_int64,    # n rows
        i64p,              # candidate rows
        ctypes.c_int64,    # n candidates
        i32p,              # pattern token ids
        ctypes.c_int64,    # pattern length
        ctypes.POINTER(ctypes.c_uint8),  # out per-candidate hit mask
    ]
    lib.pse_phrase_hits_mask.restype = ctypes.c_int64


def native_available() -> bool:
    return get_library() is not None

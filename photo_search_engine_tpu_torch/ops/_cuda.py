"""Build-on-first-use loader for the CUDA kernels (``csrc/*.cu``).

The same compile-on-demand idea as ``photo_search_engine_tpu/native/
loader.py``: ``nvcc`` compiles every source under ``csrc/`` (one process
per source, all started together), then links the objects into one
shared library with a plain C interface, which ``ctypes`` loads.  No
PyTorch headers are included, so a build takes seconds, not minutes.

The library lands in ``photo_search_engine_tpu_torch/_build/`` under a
name keyed by a hash of the sources, so an edited kernel is rebuilt and
a stale library is never loaded.  Each C entry point returns
``cudaGetLastError()`` after its launch; :func:`check` raises on
anything but 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# (pointer arguments, int arguments) of each entry point; the stream is last
_SIGNATURES = {
    "pse_block_topk_f32": (7, 7),
    "pse_block_topk_bf16": (7, 7),
    "pse_int8_block_topk": (8, 7),
    "pse_grouped_block_topk_f32": (6, 7),
    "pse_grouped_block_topk_bf16": (6, 7),
    "pse_int8_grouped_block_topk": (8, 7),
    "pse_ivf_topk_f32": (11, 9),
    "pse_ivf_topk_bf16": (11, 9),
    "pse_ivf_topk_int8": (11, 9),
}

_lock = threading.Lock()
_state: Dict[str, object] = {}


def _sources():
    return sorted(
        glob.glob(os.path.join(SRC_DIR, "*.cu"))
        + glob.glob(os.path.join(SRC_DIR, "*.cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _build() -> str:
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:16]
    out_path = os.path.join(BUILD_DIR, f"libpse_cuda_{tag}.so")
    log_path = out_path + ".log"
    if os.path.exists(out_path):
        _state["build_seconds"] = 0.0
        if os.path.exists(log_path):
            with open(log_path) as f:
                _state["build_log"] = f.read()
        return out_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp_path = f"{out_path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    started = time.perf_counter()
    compiles = []
    for source in (s for s in sources if s.endswith(".cu")):
        obj = f"{tmp_path}.{os.path.basename(source)}.o"
        command = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, source]
        compiles.append((obj, subprocess.Popen(command, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], False
    for obj, proc in compiles:  # every process is waited for, failed or not
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        logs.append(out)
        failed = failed or proc.returncode != 0
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", tmp_path, *(obj for obj, _ in compiles)],
                              capture_output=True, text=True, timeout=600)
        logs.append(link.stdout + link.stderr)
        failed = link.returncode != 0
    for obj, _ in compiles:
        if os.path.exists(obj):
            os.remove(obj)
    _state["build_seconds"] = time.perf_counter() - started
    _state["build_log"] = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{_state['build_log']}")
    with open(log_path, "w") as f:
        f.write(str(_state["build_log"]))
    os.replace(tmp_path, out_path)  # atomic: two processes building at once never tear it
    return out_path


def library() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on first use."""
    with _lock:
        lib = _state.get("lib")
        if lib is None:
            lib = ctypes.CDLL(_build())
            for name, (n_ptr, n_int) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_P]
                fn.restype = _I
            _state["lib"] = lib
        return lib


def build_info() -> Dict[str, object]:
    """Seconds the build took in this process (0 when it was already on
    disk) and the compiler's output (``-Xptxas=-v``: registers, shared
    memory and spills of each kernel)."""
    library()
    return {
        "seconds": float(_state.get("build_seconds", 0.0)),
        "log": str(_state.get("build_log", "")),
    }


def ptr(tensor) -> Optional[int]:
    """Device address of a tensor for a ``c_void_p`` argument (None → NULL)."""
    return None if tensor is None else tensor.data_ptr()


def stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(what: str, tensor, device, dtype, shape) -> None:
    """Raise unless ``tensor`` is a contiguous ``dtype`` tensor of
    ``shape`` on ``device`` (what a kernel may be given a pointer to)."""
    if tensor is None:
        raise ValueError(f"{what}: required here")
    if (
        tensor.device != device
        or tensor.dtype != dtype
        or tuple(tensor.shape) != tuple(shape)
        or not tensor.is_contiguous()
    ):
        raise ValueError(
            f"{what}: expected a contiguous {dtype} tensor of shape {tuple(shape)} "
            f"on {device}, got {tensor.dtype} {tuple(tensor.shape)} on {tensor.device}"
        )


def check(error: int, what: str) -> None:
    if error != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {error}")

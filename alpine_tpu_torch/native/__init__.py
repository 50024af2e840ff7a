"""Native (C++) components of the port, loaded via ctypes.

Currently: Leiden community detection (``leiden.cpp``, the port's copy of
``alpine_tpu/native/leiden.cpp``), which the ComponentOptimizer's CV
scoring runs on the host.  The shared library is compiled with g++ at
first use, with the JAX package's flags, into ``native/build/`` beside the
source (not tracked by git); its file name carries a hash of the source,
the flags and the host's name, so an edited source builds anew and a tree
copied to another machine never loads a library built for another CPU
(``-march=native``).  Where no C++ toolchain
exists, scoring falls back to a pure-Python Louvain
(``alpine_tpu_torch/optimize/scoring.py:_python_louvain``), as the JAX
package does; ``leiden_backend()`` says which of the two runs and
``build_error()`` why the build failed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import warnings
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "leiden.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        key = f.read() + " ".join(_FLAGS + [platform.node()]).encode()
    digest = hashlib.sha256(key).hexdigest()
    return os.path.join(_BUILD_DIR, f"_leiden-{digest[:16]}.so")


def _build(lib: str) -> Optional[str]:
    """Compile the library to ``lib``; returns None or the failure."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # a per-process temp name, promoted atomically: concurrent processes
    # never load each other's half-written output
    tmp = f"{lib}.tmp.{os.getpid()}"
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, lib)
        return None
    except subprocess.CalledProcessError as e:
        return f"g++ failed: {e.stderr.strip()[-2000:]}"
    except Exception as e:  # no g++, a timeout
        return f"{type(e).__name__}: {e}"
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def load_leiden() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the Leiden shared library, or None (the
    reason is in ``build_error()``, and a warning says it once)."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        lib_path = _lib_path()
        if not os.path.exists(lib_path):
            _error = _build(lib_path)
        if _error is None:
            try:
                lib = ctypes.CDLL(lib_path)
            except OSError as e:
                _error = f"loading {os.path.basename(lib_path)} failed: {e}"
        if _error is not None:
            warnings.warn(f"native Leiden unavailable ({_error}); clustering "
                          "falls back to the pure-Python Louvain")
            return None
        lib.alpine_leiden.restype = ctypes.c_int64
        lib.alpine_leiden.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_double, ctypes.c_int64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


def leiden_backend() -> str:
    """"native" when the C++ library builds and loads, else "python" (the
    Louvain fallback)."""
    return "native" if load_leiden() is not None else "python"


def build_error() -> Optional[str]:
    """Why the native library is unavailable, or None."""
    load_leiden()
    return _error


def leiden_native(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    weight: Optional[np.ndarray],
    resolution: float = 1.0,
    max_levels: int = 10,
    seed: int = 0,
) -> Optional[np.ndarray]:
    """Run native Leiden; returns labels (n_nodes,) or None if unavailable."""
    lib = load_leiden()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    w_ptr = None
    if weight is not None:
        weight = np.ascontiguousarray(weight, dtype=np.float64)
        w_ptr = weight.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    out = np.empty(n_nodes, dtype=np.int64)
    rc = lib.alpine_leiden(
        n_nodes, len(src),
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        w_ptr, float(resolution), int(max_levels), int(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc < 0:
        return None
    return out

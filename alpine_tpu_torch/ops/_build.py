"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) at first use into
``csrc/build/`` (listed in .gitignore).  The library file name carries a
hash of the sources and flags, so an edited kernel is rebuilt and a stale
one is never loaded.  ``build_all`` starts one ``nvcc`` per source, all at
once.  Nothing here runs at import time: the CPU tests import every module
of the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("fused_iteration", "fused_transform", "x_passes", "stream_probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# every C entry point: its source, its symbol and its argtypes (pointers
# and the stream are c_void_p, sizes c_int, eps c_float: ctypes would
# otherwise cut 64-bit pointers)
SIGNATURES = {
    "fused_iteration": ("fused_iteration", "alpine_fused_iteration",
                        [_P, _I] + [_P] * 7
                        + [_I] * 6 + [_F] + [_I] * 12 + [_P] * 8),
    "fused_transform": ("fused_transform", "alpine_fused_transform",
                        [_P, _P, _P] + [_I] * 8 + [_F, _P, _P, _P, _P]),
    # the large-K chain of K1/K2/K4 (K > 512): X's products are P1's and
    # P2's kernels, so it lives beside them
    "fused_iteration_wide": ("x_passes", "alpine_fused_iteration_wide",
                             [_P, _I] + [_P] * 7 + [_I] * 7 + [_F] + [_I] * 16
                             + [_P] * 15),
    # its statistics against Hn alone (csrc/gram_wide.cuh, included there)
    "gram_wide": ("x_passes", "alpine_gram_wide", [_P] * 3 + [_I] * 5 + [_P] * 6),
    # its D = WᵀW H alone (csrc/wtw_gemm.cuh's store, included there)
    "wtw_gemm": ("x_passes", "alpine_wtw_gemm", [_P, _P, _I, _I, _P, _P, _P]),
    "hxt": ("x_passes", "alpine_hxt", [_P, _I, _P] + [_I] * 8 + [_P] * 4),
    "wtx": ("x_passes", "alpine_wtx", [_P, _I, _P] + [_I] * 9 + [_P] * 5),
    # P1/P2 above K = 512 on int8/bf16 X (csrc/x_passes_wide.cuh, which
    # x_passes.cu includes)
    "hxt_wide": ("x_passes", "alpine_hxt_wide", [_P, _I, _P] + [_I] * 7 + [_P] * 4),
    "wtx_wide": ("x_passes", "alpine_wtx_wide", [_P, _I, _P] + [_I] * 7 + [_P] * 4),
    # and on float32/int16 X (csrc/fma_wide.cuh, which x_passes.cu includes)
    "hxt_fma_wide": ("x_passes", "alpine_hxt_fma_wide", [_P, _I, _P] + [_I] * 5 + [_P] * 3),
    "wtx_fma_wide": ("x_passes", "alpine_wtx_fma_wide", [_P, _I, _P] + [_I] * 3 + [_P] * 2),
    "stream_probe": ("stream_probe", "alpine_stream_probe",
                     [_P, _I] + [_I] * 5 + [_P] * 4),
}

_lock = threading.Lock()
# entry name -> (its library, its C function); the library is kept referenced
_entries: Dict[str, Tuple[ctypes.CDLL, Callable[..., int]]] = {}
# ptxas register / shared-memory report of the last build of each source
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            path = Path(cand) / "bin" / "nvcc"
            if path.exists():
                return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of alpine_tpu_torch cannot be built")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, nvcc: str):
    """Start nvcc for one source into a temporary file; returns
    (target, tmp, process) or None when the library is already built."""
    target = _lib_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return target, tmp, proc


def _finish(name: str, started) -> None:
    target, tmp, proc = started
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    Path(f"{target}.log").write_text(out)
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file


def build_log(name: str) -> str:
    """nvcc's output (ptxas register, shared-memory and spill report) of the
    build of ``csrc/<name>.cu``, kept beside the library."""
    if name in build_logs:
        return build_logs[name]
    log = Path(f"{_lib_path(name)}.log")
    return log.read_text() if log.exists() else ""


def build_all() -> Dict[str, float]:
    """Compile every source that is not built yet, one nvcc per source, all
    started together.  Returns the seconds each build took (0.0 when the
    library was already there).  Every nvcc is waited for before a failure
    is raised."""
    nvcc = find_nvcc()
    with _lock:
        t0 = time.perf_counter()
        started = {name: _start(name, nvcc) for name in SOURCES}
        seconds, errors = {}, []
        for name, s in started.items():
            if s is not None:
                try:
                    _finish(name, s)
                except RuntimeError as e:
                    errors.append(str(e))
            seconds[name] = (time.perf_counter() - t0) if s is not None else 0.0
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def entry(name: str) -> Callable[..., int]:
    """The C entry point ``name`` of ``SIGNATURES``, its source built and
    loaded first if needed."""
    loaded = _entries.get(name)
    if loaded is None:
        with _lock:
            if name not in _entries:
                source, fn_name, argtypes = SIGNATURES[name]
                s = _start(source, find_nvcc())
                if s is not None:
                    _finish(source, s)
                lib = ctypes.CDLL(str(_lib_path(source)))
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _entries[name] = (lib, fn)
            loaded = _entries[name]
    return loaded[1]

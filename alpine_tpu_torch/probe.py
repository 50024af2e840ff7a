"""The port's streaming read-rate probe: how fast the card reads X from
device memory and widens it to float32, with no matrix product.

Counterpart of the ``streaming_GBps`` part of
``benchmarks/envelope_probe.py`` (``probe_streaming``): the same bench
shape (2,000 genes x 100,000 cells), the same data (integers 0..99 in the
storage dtype, drawn from a seed) and the same kernel's work, through
``kernels.stream_probe``.  The rate is the bytes of X over the mean time of
``reps`` launches timed with CUDA events.  It needs an NVIDIA GPU.
``scripts/torch_envelope_probe.py`` prints it as one JSON line.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from alpine_tpu_torch.ops import kernels
from alpine_tpu_torch.ops.mu import x_storage_dtype

GENES, CELLS = 2000, 100_000
REPS = 32


def stream_input(x_dtype: str, genes: int = GENES, cells: int = CELLS,
                 seed: int = 0, device="cuda") -> torch.Tensor:
    """X (genes, cells): integers 0..99 in the storage dtype ``x_dtype``,
    drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.empty((genes, cells), dtype=x_storage_dtype(x_dtype), device=device)
    return X.random_(0, 100, generator=gen)


def stream_rate(X: torch.Tensor, reps: int = REPS) -> Dict[str, float]:
    """Mean ms of ``reps`` launches of ``kernels.stream_probe`` on the card
    (after one warm launch) and the read rate in GB/s of X's bytes."""
    if X.device.type != "cuda":
        raise RuntimeError("the streaming probe measures a GPU: X must be on "
                           "a CUDA device")
    kernels.stream_probe(X)
    torch.cuda.synchronize(X.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        kernels.stream_probe(X)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    nbytes = X.numel() * X.element_size()
    return {"ms": ms, "bytes_read": nbytes, "GBps": nbytes / ms / 1e6,
            "tile": kernels.stream_tile(X.shape[0], X.element_size()),
            "reps": reps}


def streaming_GBps(x_dtypes: Sequence[str] = ("int8", "float32"),
                   genes: int = GENES, cells: int = CELLS, reps: int = REPS,
                   seed: int = 0) -> Dict[str, Dict[str, float]]:
    """The probe at each storage dtype: {x_dtype: stream_rate(...)}."""
    if not torch.cuda.is_available():
        raise RuntimeError("the streaming probe needs an NVIDIA GPU")
    out = {}
    for name in x_dtypes:
        X = stream_input(name, genes, cells, seed)
        out[name] = stream_rate(X, reps)
        del X
    return out

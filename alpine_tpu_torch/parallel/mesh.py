"""Device resolution for the port (single device; cell-axis sharding over
several GPUs is a later slice).

Counterpart of ``alpine_tpu/parallel/mesh.py:resolve_device``, with one
deliberate difference: there is no silent CPU fallback.  The estimator runs
on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Map the user-facing ``device`` argument to a ``torch.device``.

    ``"cuda"`` (the default) and ``"auto"`` mean the current CUDA device;
    ``"cpu"`` is accepted (the tests use it).  Asking for the card where
    there is none raises instead of falling back to the CPU."""
    if device is None or (isinstance(device, str) and device == "auto"):
        device = "cuda"
    if isinstance(device, str):
        try:
            dev = torch.device(device)
        except RuntimeError as e:
            raise ValueError(f"Unknown device {device!r}: {e}") from e
    elif isinstance(device, torch.device):
        dev = device
    else:
        raise TypeError(
            f"device must be a string or torch.device, got {type(device)}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ALPINE(device='cuda') needs an NVIDIA GPU, but "
                "torch.cuda.is_available() is False. Pass device='cpu' to "
                "run the plain PyTorch path on the CPU.")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(
        f"device must be 'cuda', 'auto' or 'cpu', got {device!r}")

"""alpine_tpu_torch — the PyTorch/CUDA port of alpine_tpu for NVIDIA Hopper.

The JAX package ``alpine_tpu`` is the reference this package is held
against; this package imports nothing of it and nothing of JAX.  Plain
tensor code is PyTorch, and each Pallas kernel of the JAX package's main
path is a CUDA kernel written for ``sm_90a`` (``alpine_tpu_torch/csrc``),
built with ``nvcc`` at first use and bound with ``ctypes``.

    from alpine_tpu_torch import ALPINE, AnnData

The estimator runs on the card by default (``device="cuda"``);
``device="cpu"`` runs the same fit loop with each kernel's plain PyTorch
version, which is what the tests use.
"""

from typing import TYPE_CHECKING

__all__ = ["ALPINE", "AlpineMatrices", "AnnData", "suggest_data_dtype"]
__version__ = "0.1.0"

if TYPE_CHECKING:  # pragma: no cover
    from alpine_tpu_torch.models.alpine import ALPINE
    from alpine_tpu_torch.models.state import AlpineMatrices
    from alpine_tpu_torch.utils.adata import AnnData

_LAZY = {
    "ALPINE": ("alpine_tpu_torch.models.alpine", "ALPINE"),
    "AlpineMatrices": ("alpine_tpu_torch.models.state", "AlpineMatrices"),
    "AnnData": ("alpine_tpu_torch.utils.adata", "AnnData"),
    "suggest_data_dtype": ("alpine_tpu_torch.utils.adata", "suggest_data_dtype"),
}


def __getattr__(name: str):
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module 'alpine_tpu_torch' has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module_name), attr)
    globals()[name] = value
    return value

"""Carry weights and fitted state from the JAX package into the port.

Both packages exchange plain numpy arrays, so nothing here imports JAX:
the caller fetches the JAX arrays with ``np.asarray``.  ``state_from_numpy``
turns an initial or fitted (W, H, Bs) into the port's tensors — e.g. the
draw of ``alpine_tpu.ops.mu.init_matrices``, so that a port fit starts where
a JAX fit starts — and ``fitted_from_numpy`` installs a JAX model's
``get_decomposed_matrices()`` and encoder labels into a port ``ALPINE`` so
that ``transform`` starts from the same W.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from alpine_tpu_torch.utils.encoder import FeatureEncoders


def state_from_numpy(W, H, Bs: Sequence, device):
    """(W, H, Bs) as contiguous float32 tensors on ``device``."""
    # np.array copies: arrays fetched from JAX are read-only
    to = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    return to(W), to(H), tuple(to(b) for b in Bs)


def fitted_from_numpy(model, matrices: Dict, encoded_labels: Dict[str, List[str]],
                      *, covariate_keys: List[str], feature_names: List[str],
                      max_iter: int, data_dtype: str):
    """Install a fitted state into a port ``ALPINE`` (constructed with the
    same block sizes): ``matrices`` is the ``get_decomposed_matrices()``
    dict, ``encoded_labels`` the encoder's ``{key: ["key_value", ...]}``."""
    fe = FeatureEncoders(covariate_keys)
    for key in covariate_keys:
        labels = list(encoded_labels[key])
        fe.encoded_labels[key] = labels
        fe.categories[key] = np.asarray(
            [lab[len(key) + 1:] for lab in labels], dtype=object)
    model.fe = fe
    model.matrices = {
        "X": np.asarray(matrices["X"], dtype=np.float32),
        **{name: [np.asarray(a, dtype=np.float32) for a in matrices[name]]
           for name in ("Ys", "Ws", "Hs", "Bs")},
    }
    model.covariate_keys = list(covariate_keys)
    model.feature_names = list(feature_names)
    model.n_features = len(feature_names)
    model.max_iter = max_iter
    model.data_dtype_ = data_dtype
    return model

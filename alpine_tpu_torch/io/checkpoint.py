"""Fitted-model persistence of the port, in the JAX package's format.

The port's own copy of ``save_model``, ``load_model``, ``_restore_model``
and ``_encoder_path`` of ``alpine_tpu/io/checkpoint.py``: one compressed
``.npz`` (the matrices, ``_meta`` JSON with ``format_version`` 1,
``_loss_history`` and ``_loss_columns``) and a pickled encoder beside it
(``<path>.encoders.pkl``).  Each package reads the other's files:

- a sidecar the JAX package wrote pickles
  ``alpine_tpu.utils.encoder.FeatureEncoders`` holding scikit-learn
  ``OneHotEncoder``s.  It is read by an unpickler that maps those two
  classes onto stand-ins, allows the numpy globals their state needs and
  refuses every other global, so neither scikit-learn nor ``alpine_tpu`` is
  imported; the stand-ins become the port's encoder (each key's
  ``categories_[0]`` and its encoded labels);
- a sidecar the port writes pickles the port's ``FeatureEncoders``, which
  the JAX package's ``load_model`` reads wherever both packages are
  installed.
"""

from __future__ import annotations

import json
import pickle
from typing import Dict

import numpy as np

from alpine_tpu_torch.utils.encoder import FeatureEncoders

FORMAT_VERSION = 1


def save_model(model, path: str) -> None:
    """Write a fitted port ``ALPINE`` to ``<path>.npz`` (compressed) and
    ``<path>.encoders.pkl``."""
    if not hasattr(model, "matrices"):
        raise RuntimeError("Model is not trained yet. Please fit the model first.")

    arrays: Dict[str, np.ndarray] = {}
    m = model.matrices
    arrays["X"] = m["X"]
    for name in ("Ys", "Ws", "Hs", "Bs"):
        for i, a in enumerate(m[name]):
            arrays[f"{name}_{i}"] = a
    meta = {
        "format_version": FORMAT_VERSION,
        "n_components": model.n_components,
        "n_covariate_components": model.n_covariate_components,
        "lam": model.lam,
        "orth_W": model.orth_W,
        "alpha_W": model.alpha_W,
        "l1_ratio_W": model.l1_ratio_W,
        "use_als": model.use_als,
        "scale_needed": model.scale_needed,
        "loss_type": model.loss_type,
        "eps": model.eps,
        "random_state": model.random_state,
        "matmul_precision": model.matmul_precision,
        "data_dtype": model.data_dtype,
        # the resolved storage dtype: a loaded model casts query data as the
        # fit did
        "data_dtype_": getattr(model, "data_dtype_", None),
        "max_iter": model.max_iter,
        "covariate_keys": model.covariate_keys,
        "feature_names": model.feature_names,
        "n_features": model.n_features,
        "counts": {name: len(m[name]) for name in ("Ys", "Ws", "Hs", "Bs")},
    }
    arrays["_meta"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    ).copy()
    arrays["_loss_history"] = np.asarray(model.loss_history_)
    arrays["_loss_columns"] = np.array(
        [c.encode("utf-8") for c in model.loss_columns()]
    )
    np.savez_compressed(_npz_path(path), **arrays)

    with open(_encoder_path(path), "wb") as f:
        pickle.dump(model.fe, f)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _encoder_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".encoders.pkl"


def load_model(path: str, device="auto"):
    """A fitted port ``ALPINE`` from files written by ``save_model`` or by
    the JAX package's ``alpine_tpu.io.checkpoint.save_model``."""
    from alpine_tpu_torch.models.alpine import ALPINE

    with np.load(_npz_path(path), allow_pickle=False) as data:
        return _restore_model(ALPINE, data, path, device)


def _restore_model(ALPINE, data, path, device):
    meta = json.loads(bytes(data["_meta"]).decode("utf-8"))
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version: {meta.get('format_version')}")

    model = ALPINE(
        n_components=meta["n_components"],
        n_covariate_components=meta["n_covariate_components"],
        lam=meta["lam"],
        orth_W=meta["orth_W"],
        alpha_W=meta["alpha_W"],
        l1_ratio_W=meta["l1_ratio_W"],
        use_als=meta["use_als"],
        scale_needed=meta["scale_needed"],
        loss_type=meta["loss_type"],
        eps=meta["eps"],
        random_state=meta["random_state"],
        device=device,
        matmul_precision=meta.get("matmul_precision", "highest"),
        data_dtype=meta.get("data_dtype", "float32"),
    )
    model.max_iter = meta["max_iter"]
    resolved = meta.get("data_dtype_")
    if resolved is None:
        # files from before data_dtype="auto" carried a concrete data_dtype
        resolved = meta.get("data_dtype", "float32")
        resolved = "float32" if resolved == "auto" else resolved
    model.data_dtype_ = resolved
    model.covariate_keys = meta["covariate_keys"]
    model.feature_names = meta["feature_names"]
    model.n_features = meta["n_features"]
    model.matrices = {
        "X": data["X"],
        **{
            name: [data[f"{name}_{i}"] for i in range(meta["counts"][name])]
            for name in ("Ys", "Ws", "Hs", "Bs")
        },
    }
    model.loss_history_ = data["_loss_history"]
    with open(_encoder_path(path), "rb") as f:
        model.fe = _port_encoders(_EncoderUnpickler(f).load())
    return model


# --------------------------------------------------------- encoder sidecars


class _JaxFeatureEncoders:
    """Stand-in for ``alpine_tpu.utils.encoder.FeatureEncoders`` while its
    pickle is read: holds ``covariate_keys``, ``encoders`` and
    ``encoded_labels`` as plain attributes."""


class _OneHotEncoderState:
    """Stand-in for scikit-learn's ``OneHotEncoder`` while a JAX sidecar is
    read: holds the fitted state (``categories_`` among it)."""


_RECONSTRUCT = np.ndarray((0,)).__reduce__()[0]  # numpy's own _reconstruct
_ALLOWED_GLOBALS = {
    ("alpine_tpu_torch.utils.encoder", "FeatureEncoders"): FeatureEncoders,
    ("alpine_tpu.utils.encoder", "FeatureEncoders"): _JaxFeatureEncoders,
    ("sklearn.preprocessing._encoders", "OneHotEncoder"): _OneHotEncoderState,
    ("numpy._core.multiarray", "_reconstruct"): _RECONSTRUCT,
    ("numpy.core.multiarray", "_reconstruct"): _RECONSTRUCT,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("numpy", "float64"): np.float64,
}


class _EncoderUnpickler(pickle.Unpickler):
    """Reads an encoder sidecar, resolving only ``_ALLOWED_GLOBALS``."""

    def find_class(self, module, name):
        try:
            return _ALLOWED_GLOBALS[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"an encoder sidecar may not reference {module}.{name}"
            ) from None


def _port_encoders(obj) -> FeatureEncoders:
    """The port's encoder from an unpickled sidecar: as it is when the port
    wrote it; from each key's fitted categories and labels when the JAX
    package did."""
    if isinstance(obj, FeatureEncoders):
        return obj
    if not isinstance(obj, _JaxFeatureEncoders):
        raise TypeError(f"an encoder sidecar holds {type(obj).__name__}, "
                        "not FeatureEncoders")
    fe = FeatureEncoders(list(obj.covariate_keys))
    for key, enc in obj.encoders.items():
        fe.categories[key] = np.asarray(enc.categories_[0], dtype=object)
        fe.encoded_labels[key] = list(obj.encoded_labels[key])
    return fe

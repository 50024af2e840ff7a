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

``FitCheckpointer`` is the port's copy of the JAX package's mid-fit
snapshots with its npz backend: the same file name (a hash of the fit's
configuration), the same arrays and the same atomic replace, so a snapshot
either package wrote resumes in the other.  The orbax backend imports JAX
and is not ported.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import warnings
import zipfile
from typing import Any, Dict, Optional, Tuple

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


# --------------------------------------------------------- mid-fit snapshots


def check_backend(backend: str) -> None:
    """The checkpoint backends the port has: npz only."""
    if backend == "orbax":
        raise ValueError(
            "checkpoint_backend='orbax' is not available in alpine_tpu_torch "
            "(orbax imports JAX); use checkpoint_backend='npz'.")
    if backend != "npz":
        raise ValueError("checkpoint backend must be 'npz' or 'orbax'")


class FitCheckpointer:
    """Snapshots of a fit's state (iteration, W, H, Bs, loss history) in
    ``<directory>/fit_snapshot_<tag>.npz``, where the tag hashes
    ``config_key``: a snapshot of another configuration is never resumed.
    The counterpart of ``alpine_tpu.io.checkpoint.FitCheckpointer`` with
    ``backend="npz"``."""

    def __init__(self, directory: str, config_key: Dict[str, Any],
                 backend: str = "npz"):
        check_backend(backend)
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        blob = json.dumps(config_key, sort_keys=True, default=str).encode("utf-8")
        self.tag = hashlib.sha256(blob).hexdigest()[:16]

    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"fit_snapshot_{self.tag}.npz")

    def save(self, iteration: int, W, H, Bs, losses: np.ndarray) -> None:
        """Write the snapshot to a temporary file, then replace the old one
        atomically: a preemption mid-write leaves the previous snapshot."""
        arrays = {"iteration": np.asarray(iteration), "W": np.asarray(W),
                  "H": np.asarray(H), "losses": np.asarray(losses)}
        for i, b in enumerate(Bs):
            arrays[f"B_{i}"] = np.asarray(b)
        arrays["n_bs"] = np.asarray(len(Bs))
        tmp = self.path + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, self.path)

    def load(self) -> Optional[Tuple[int, np.ndarray, np.ndarray, tuple,
                                     np.ndarray]]:
        """(iteration, W, H, Bs, losses), or None where there is no
        snapshot or it is unreadable (with a warning naming the file)."""
        if not os.path.exists(self.path):
            return None
        try:
            with np.load(self.path, allow_pickle=False) as data:
                n_bs = int(data["n_bs"])
                return (int(data["iteration"]), data["W"], data["H"],
                        tuple(data[f"B_{i}"] for i in range(n_bs)),
                        data["losses"])
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            warnings.warn(
                f"Fit checkpoint at {self.path!r} is unreadable "
                f"({type(e).__name__}: {e}); restarting the fit from scratch.")
            return None

    def clear(self) -> None:
        """Remove the snapshot and a temporary file a preempted save left."""
        for leftover in (self.path, self.path + ".tmp.npz"):
            if os.path.exists(leftover):
                os.remove(leftover)

"""Minimal AnnData-compatible container and the X helpers of the fit path.

The port's own copy of ``alpine_tpu/utils/adata.py`` (the subset the
estimator's fit/transform path needs), written so that this path imports
neither pandas nor anndata: ``obs`` may be a pandas DataFrame or a plain
dict of equal-length 1-D arrays.  ``is_anndata`` is duck-typed, so the JAX
package's ``AnnData`` and a real ``anndata.AnnData`` are accepted too.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def is_sparse_x(X: Any) -> bool:
    """Duck-typed scipy sparse check (matrix or sparse-array API)."""
    return hasattr(X, "toarray") and hasattr(X, "nnz") and hasattr(X, "shape")


def as_compressed(X: Any):
    """Canonical compressed sparse form with summed duplicates, on a copy
    when the caller's matrix would otherwise be mutated."""
    if not is_sparse_x(X):
        return X
    if not hasattr(X, "indptr"):
        return X.tocsr()
    if not getattr(X, "has_canonical_format", True):
        X = X.copy()
        X.sum_duplicates()
    return X


def dense_x(X: Any) -> np.ndarray:
    """Dense float32 COPY of an ``adata.X`` (ndarray or scipy sparse)."""
    if is_sparse_x(X):
        return np.asarray(X.toarray(), dtype=np.float32)
    return np.asarray(X).astype(np.float32)


def suggest_data_dtype(X: Any) -> str:
    """The narrowest EXACT ``ALPINE(data_dtype=...)`` for a dataset:
    "int8" for non-negative integers ≤ 127, "int16" for ≤ 32767, else
    "float32".  Accepts a dense array, a scipy sparse matrix, or an
    AnnData-like object."""
    if hasattr(X, "X") and hasattr(X, "obs"):  # AnnData-like
        X = X.X
    if is_sparse_x(X):
        data = np.asarray(as_compressed(X).data)
    else:
        data = np.asarray(X)
    if data.size == 0:
        return "float32"
    if np.mod(data, 1.0).any() or not (float(data.min(initial=0.0)) >= 0):
        return "float32"
    top = float(data.max(initial=0.0))
    if top <= np.iinfo(np.int8).max:
        return "int8"
    if top <= np.iinfo(np.int16).max:
        return "int16"
    return "float32"


def x_min(X: Any) -> float:
    """Minimum of an adata.X without densifying (sparse implicit zeros count
    as 0).  NaN propagates: validate with ``not (x_min(X) >= 0)``."""
    if is_sparse_x(X):
        Xc = as_compressed(X)
        data = np.asarray(Xc.data)
        explicit_min = float(data.min()) if data.size else 0.0
        has_implicit_zero = Xc.nnz < Xc.shape[0] * Xc.shape[1]
        return min(explicit_min, 0.0) if has_implicit_zero else explicit_min
    arr = np.asarray(X)
    return float(arr.min()) if arr.size else 0.0


def obs_keys(obs: Any) -> list:
    """Column names of an ``obs`` table (DataFrame or dict)."""
    return list(obs.columns) if hasattr(obs, "columns") else list(obs.keys())


def obs_column(obs: Any, key: str) -> np.ndarray:
    """One ``obs`` column as a 1-D object array (missing values stay as
    None / NaN / pandas.NA for the encoder to detect)."""
    return np.asarray(obs[key], dtype=object).reshape(-1)


def obs_is_categorical(obs: Any, key: str) -> bool:
    """Whether an ``obs`` column holds labels: object/categorical dtype in a
    DataFrame (the JAX package's rule), object or string arrays in a dict."""
    col = obs[key]
    kind = getattr(getattr(col, "dtype", None), "kind", None)
    if hasattr(obs, "columns"):
        return kind == "O"
    if kind is None:
        kind = np.asarray(col).dtype.kind
    return kind in ("O", "U")


def obs_length(obs: Any) -> int:
    if hasattr(obs, "columns"):
        return len(obs)
    lengths = {len(np.asarray(v).reshape(-1)) for v in obs.values()}
    if len(lengths) > 1:
        raise ValueError("obs columns must all have the same length")
    return lengths.pop() if lengths else 0


class _AxisMapping(dict):
    """dict that validates the leading-axis length of inserted arrays."""

    def __init__(self, length: int, axis_name: str):
        super().__init__()
        self._length = length
        self._axis_name = axis_name

    def __setitem__(self, key: str, value: Any) -> None:
        length = self.__dict__.get("_length")
        if (length is not None and hasattr(value, "shape")
                and len(value.shape) >= 1 and value.shape[0] != length):
            raise ValueError(
                f"value for {self._axis_name}[{key!r}] has leading dimension "
                f"{value.shape[0]}, expected {length}"
            )
        super().__setitem__(key, value)


class AnnData:
    """A lightweight stand-in for ``anndata.AnnData`` (rows = cells/obs,
    columns = genes/vars) with the subset of the API that ALPINE touches.
    ``obs`` is a pandas DataFrame or a dict of equal-length 1-D arrays;
    ``var_names`` defaults to "0".."n_vars-1"."""

    def __init__(
        self,
        X: np.ndarray,
        obs: Optional[Any] = None,
        var_names: Optional[Any] = None,
        obsm: Optional[Dict[str, Any]] = None,
        varm: Optional[Dict[str, Any]] = None,
    ):
        X = as_compressed(X) if is_sparse_x(X) else np.asarray(X)
        if len(X.shape) != 2:
            raise ValueError("X must be a 2-D array (obs x var).")
        self.X = X
        n_obs, n_vars = X.shape
        if obs is None:
            obs = {}
        elif not hasattr(obs, "columns"):
            obs = {k: np.asarray(v).reshape(-1) for k, v in obs.items()}
        if obs_keys(obs) and obs_length(obs) != n_obs:
            raise ValueError("obs length does not match X rows")
        self.obs = obs
        names = (np.arange(n_vars).astype(str) if var_names is None
                 else np.asarray(var_names).reshape(-1))
        if len(names) != n_vars:
            raise ValueError("var_names length does not match X columns")
        self.var_names = names
        self.obsm = _AxisMapping(n_obs, "obsm")
        self.varm = _AxisMapping(n_vars, "varm")
        for mapping, items in ((self.obsm, obsm), (self.varm, varm)):
            for k, v in (items or {}).items():
                mapping[k] = v

    @property
    def shape(self):
        return self.X.shape

    @property
    def n_obs(self) -> int:
        return self.X.shape[0]

    @property
    def n_vars(self) -> int:
        return self.X.shape[1]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"AnnData(n_obs={self.n_obs}, n_vars={self.n_vars}, "
                f"obs={obs_keys(self.obs)}, obsm={list(self.obsm)}, "
                f"varm={list(self.varm)})")


def is_anndata(obj: Any) -> bool:
    """Duck-typed AnnData check: this module's stand-in, the JAX package's,
    or a real ``anndata.AnnData``."""
    return all(hasattr(obj, a) for a in ("X", "obs", "obsm", "varm", "shape"))

"""Minimal AnnData-compatible container and the X helpers of the fit path.

The port's own copy of ``alpine_tpu/utils/adata.py`` (the subset the
estimator's fit, transform, export and h5ad paths need), written so that
these paths import neither pandas nor anndata: ``obs`` and ``var`` may be
pandas DataFrames or plain dicts of equal-length 1-D arrays.  ``is_anndata``
is duck-typed, so the JAX package's ``AnnData`` and a real
``anndata.AnnData`` are accepted too.
"""

from __future__ import annotations

from copy import deepcopy
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
    if _has_fraction(data) or not (float(data.min(initial=0.0)) >= 0):
        return "float32"
    top = float(data.max(initial=0.0))
    if top <= np.iinfo(np.int8).max:
        return "int8"
    if top <= np.iinfo(np.int16).max:
        return "int16"
    return "float32"


def _has_fraction(data: np.ndarray, step: int = 1 << 22) -> bool:
    """Whether some value of ``data`` is not a whole number (NaN counts as
    one).  Floating data is compared with its floor in slabs of ``step``
    values: about ten times faster than ``np.mod(data, 1.0)``, with one
    slab of temporaries.  ±inf equals its floor here where ``np.mod``
    gives NaN; ``suggest_data_dtype`` still answers "float32" for it from
    the range checks."""
    if data.dtype.kind != "f":
        return bool(np.mod(data, 1.0).any())
    flat = data.reshape(-1)
    return any(bool(np.any(c != np.floor(c)))
               for c in (flat[i:i + step] for i in range(0, flat.size, step)))


def dtype_can_store(data_dtype: str, X: Any) -> bool:
    """Whether X is exactly representable under a storage dtype name: float
    dtypes always store (bfloat16 rounds by design); int8/int16 need
    non-negative integers within range (``suggest_data_dtype``'s rule)."""
    if data_dtype not in ("int8", "int16"):
        return True
    suggested = suggest_data_dtype(X)
    if suggested == "float32":  # fractional, negative, or NaN somewhere
        return False
    return np.iinfo(suggested).max <= np.iinfo(data_dtype).max


def is_na(v: Any) -> bool:
    """A missing label: None, a float NaN, or pandas' NA objects (pd.NA,
    NaT), found without importing pandas."""
    if v is None:
        return True
    try:
        return bool(v != v)  # NaN, NaT
    except TypeError:  # pandas.NA: its truth value is ambiguous
        return True


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
    The positional order is the JAX package's: ``(X, obs, var, obsm, varm,
    layers, uns)``.  ``obs`` / ``var`` are pandas DataFrames or dicts of
    equal-length 1-D arrays; ``obs_names`` / ``var_names`` are a
    DataFrame's index, else "0".."n-1" (``var_names``, keyword only, may
    be given with a dict ``var``).  ``obsm`` and ``layers`` check their
    values' leading axis against the cells, ``varm`` against the genes, as
    the JAX package's class does; ``uns`` is kept as a dict."""

    def __init__(
        self,
        X: np.ndarray,
        obs: Optional[Any] = None,
        var: Optional[Any] = None,
        obsm: Optional[Dict[str, Any]] = None,
        varm: Optional[Dict[str, Any]] = None,
        layers: Optional[Dict[str, Any]] = None,
        uns: Optional[Dict[str, Any]] = None,
        *,
        var_names: Optional[Any] = None,
    ):
        X = as_compressed(X) if is_sparse_x(X) else np.asarray(X)
        if len(X.shape) != 2:
            raise ValueError("X must be a 2-D array (obs x var).")
        self.X = X
        n_obs, n_vars = X.shape
        self.obs, self._obs_names = _frame(obs, None, n_obs, "obs", "X rows")
        self.var, self._var_names = _frame(var, var_names, n_vars, "var",
                                           "X columns")
        self.obsm = _AxisMapping(n_obs, "obsm")
        self.varm = _AxisMapping(n_vars, "varm")
        self.layers = _AxisMapping(n_obs, "layers")
        for mapping, items in ((self.obsm, obsm), (self.varm, varm),
                               (self.layers, layers)):
            for k, v in (items or {}).items():
                mapping[k] = v
        self.uns: Dict[str, Any] = dict(uns) if uns else {}

    @property
    def shape(self):
        return self.X.shape

    @property
    def n_obs(self) -> int:
        return self.X.shape[0]

    @property
    def n_vars(self) -> int:
        return self.X.shape[1]

    @property
    def obs_names(self):
        return self.obs.index if hasattr(self.obs, "columns") else self._obs_names

    @property
    def var_names(self):
        return self.var.index if hasattr(self.var, "columns") else self._var_names

    def __getitem__(self, idx) -> "AnnData":
        """Row (obs) subset, as the optimizer's CV folds take it: a new
        object holding copies of the selected rows of X, obs, obsm and
        layers, with their obs names, and a deep copy of uns; var and varm
        are shared."""
        if isinstance(idx, tuple):
            raise NotImplementedError("only obs-axis subsetting is supported")
        if np.isscalar(idx) and not isinstance(idx, (slice, bool)):
            idx = np.asarray([idx])  # a 1-obs object, not a 1-D X
        Xs = self.X[idx] if is_sparse_x(self.X) else np.asarray(self.X[idx])
        if hasattr(self.obs, "columns"):
            obs = self.obs[idx] if isinstance(idx, slice) else self.obs.iloc[idx]
            names = None
        else:
            obs = {k: np.asarray(v)[idx] for k, v in self.obs.items()}
            names = np.asarray(self._obs_names)[idx]
        out = AnnData(Xs, obs=obs, var=self.var,
                      var_names=None if hasattr(self.var, "columns")
                      else self._var_names)
        if names is not None:
            out._obs_names = names
        for k, v in self.obsm.items():
            out.obsm[k] = np.asarray(v)[idx]
        for k, v in self.layers.items():
            out.layers[k] = np.asarray(v)[idx]
        for k, v in self.varm.items():
            out.varm[k] = v
        out.uns = deepcopy(self.uns)
        return out

    def copy(self) -> "AnnData":
        """A deep copy: X, obs, var, uns and every obsm/varm/layers value."""
        copy_table = lambda t: (t.copy() if hasattr(t, "columns")
                                else {k: np.array(v) for k, v in t.items()})
        out = AnnData(self.X.copy(), obs=copy_table(self.obs),
                      var=copy_table(self.var),
                      var_names=None if hasattr(self.var, "columns")
                      else self._var_names.copy())
        if not hasattr(self.obs, "columns"):
            out._obs_names = self._obs_names.copy()
        for name in ("obsm", "varm", "layers"):
            src, dst = getattr(self, name), getattr(out, name)
            for k, v in src.items():
                dst[k] = v.copy() if hasattr(v, "copy") else deepcopy(v)
        out.uns = deepcopy(self.uns)
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return (f"AnnData(n_obs={self.n_obs}, n_vars={self.n_vars}, "
                f"obs={obs_keys(self.obs)}, obsm={list(self.obsm)}, "
                f"varm={list(self.varm)}, layers={list(self.layers)})")


def _frame(table: Optional[Any], names: Optional[Any], n: int, what: str,
           axis: str):
    """(table, names) of one axis: a DataFrame keeps its own index (``names``
    must then be None); a dict's columns become 1-D arrays, with ``names``
    or "0".."n-1" as the axis names."""
    if table is None:
        table = {}
    elif hasattr(table, "columns"):
        if names is not None:
            raise ValueError(f"{what} is a DataFrame: its index names the "
                             f"{what} axis, so {what}_names must be None")
        if len(table) != n:
            raise ValueError(f"{what} length does not match {axis}")
        return table, None
    else:
        table = {k: np.asarray(v).reshape(-1) for k, v in table.items()}
    if obs_keys(table) and obs_length(table) != n:
        raise ValueError(f"{what} length does not match {axis}")
    names = (np.arange(n).astype(str) if names is None
             else np.asarray(names).reshape(-1))
    if len(names) != n:
        raise ValueError(f"{what}_names length does not match {axis}")
    return table, names


def is_anndata(obj: Any) -> bool:
    """Duck-typed AnnData check: this module's stand-in, the JAX package's,
    or a real ``anndata.AnnData``."""
    return all(hasattr(obj, a) for a in ("X", "obs", "obsm", "varm", "shape"))

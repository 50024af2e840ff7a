"""Minimal .h5ad (AnnData HDF5) reader/writer of the port.

The port's own copy of ``alpine_tpu/io/h5ad.py``, reading into and writing
from the port's ``AnnData`` (``alpine_tpu_torch/utils/adata.py``).  It reads
the standard h5ad layout directly with h5py:

- ``/X``: dense dataset, or a group encoding a csr/csc sparse matrix
  (``data``/``indices``/``indptr`` + ``shape`` attr) — densified on read
- ``/obs``, ``/var``: dataframe groups (``_index`` attr, per-column
  datasets, categorical groups with ``categories``/``codes``, nullable
  ``values``/``mask`` groups), read into pandas DataFrames
- ``/obsm``, ``/varm``, ``/layers``: groups of arrays

``write_h5ad`` emits the same layout (sparse X stays CSR/CSC on disk,
dense X stays dense; plain/categorical/nullable columns), so files
round-trip with the JAX package and with scanpy.  h5py, scipy and
pandas are imported inside the functions that use them; an ``obs`` or
``var`` held as a dict of arrays is written as a DataFrame indexed by
``obs_names`` / ``var_names``.
"""

from __future__ import annotations

import numpy as np

from alpine_tpu_torch.utils.adata import AnnData, as_compressed, is_sparse_x


def _node_shape(node) -> tuple:
    """Shape of an h5ad array node WITHOUT reading its contents (dense
    dataset -> .shape; sparse group -> its ``shape`` attribute)."""
    import h5py

    if isinstance(node, h5py.Dataset):
        return tuple(node.shape)
    # "shape" is the anndata encoding; h5sparse-era files (the legacy
    # format _sparse_rows' h5sparse_format fallback exists for) store it
    # as "h5sparse_shape" instead
    for key in ("shape", "h5sparse_shape"):
        if key in node.attrs:
            return tuple(int(v) for v in node.attrs[key])
    raise ValueError("h5ad node has no shape metadata")


def h5ad_dims(path: str) -> tuple:
    """(n_obs, n_vars) of an .h5ad file without reading X.

    The cheap first step of out-of-core ingestion: each process of a
    multi-host fit asks for the global cell count, computes its own row
    range (``distributed.process_cell_range``) and then reads only that
    range with ``read_h5ad(path, obs_range=...)``."""
    import h5py

    with h5py.File(path, "r") as f:
        return _node_shape(f["X"])


def _decode(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.kind in ("S", "O"):
        return np.asarray([
            v.decode("utf-8") if isinstance(v, bytes) else v for v in arr
        ], dtype=object)
    return arr


def _attr_str(node, name, default=""):
    """String attribute, decoding bytes (older h5py / non-Python writers
    store fixed-length attrs that read back as bytes)."""
    v = node.attrs.get(name, default)
    return v.decode("utf-8") if isinstance(v, bytes) else v


def _sparse_rows(node, enc: str, lo: int, hi: int, dtype=None) -> np.ndarray:
    """Densified rows [lo, hi) of an on-disk CSR/CSC group, reading only
    what the range needs: CSR reads the rows' own data/index slice (one
    indptr-bounded hyperslab); CSC streams column blocks and keeps the
    in-range rows, so host memory stays O(block nnz + output) instead of
    O(file nnz).  Duplicate entries (hand-built non-canonical files) SUM,
    matching scipy's todense.  ``dtype`` sets the output dtype up front —
    read_h5ad passes float32 for X so the dense shard is only ever
    materialized once at 4 bytes/element (an int64/float64 atlas would
    otherwise briefly hold a double-width copy)."""
    shape = _node_shape(node)
    n_rows, n_cols = int(shape[0]), int(shape[1])
    indptr_ds = node["indptr"]
    out_dtype = node["data"].dtype if dtype is None else np.dtype(dtype)
    fmt = enc.replace("_matrix", "") or _attr_str(node, "h5sparse_format")
    if fmt not in ("csr", "csc"):
        # legacy file with no format metadata: the indptr length
        # identifies the compressed axis (rows+1 for CSR, cols+1 CSC)
        fmt = "csr" if indptr_ds.shape[0] == n_rows + 1 else "csc"
    if fmt == "csr":
        from scipy import sparse

        indptr = indptr_ds[lo:hi + 1]
        start, stop = int(indptr[0]), int(indptr[-1])
        # cast the nnz data (cheap) so todense materializes the rows at
        # the final width directly
        mat = sparse.csr_matrix(
            (node["data"][start:stop].astype(out_dtype, copy=False),
             node["indices"][start:stop], indptr - start),
            shape=(hi - lo, n_cols),
        )
        return np.asarray(mat.todense())
    # CSC: rows are the uncompressed axis — every column can hold rows in
    # [lo, hi), so stream the columns in blocks and filter
    out = np.zeros((hi - lo, n_cols), dtype=out_dtype)
    indptr = indptr_ds[()]
    block = 2048
    for c0 in range(0, n_cols, block):
        c1 = min(c0 + block, n_cols)
        start, stop = int(indptr[c0]), int(indptr[c1])
        if start == stop:
            continue
        rows = node["indices"][start:stop]
        data = node["data"][start:stop]
        cols = np.repeat(
            np.arange(c0, c1), np.diff(indptr[c0:c1 + 1]).astype(np.int64)
        )
        keep = (rows >= lo) & (rows < hi)
        r = (rows[keep] - lo).astype(np.int64)
        c = cols[keep]
        d = data[keep].astype(out_dtype, copy=False)
        if r.size == 0:
            continue
        # duplicates must SUM like scipy todense, but np.add.at is an
        # unbuffered ufunc (~8 M nnz/s) — detect the canonical no-duplicate
        # case (a C-speed sort) and use plain fancy assignment there
        lin = r * n_cols + c
        lin.sort()
        if (np.diff(lin) == 0).any():
            np.add.at(out, (r, c), d)
        else:
            out[r, c] = d
    return out


def _read_array(node, rows=None, sparse_dtype=None) -> np.ndarray:
    """Read an h5ad array node; ``rows=(lo, hi)`` reads only that slice of
    the leading (obs) axis — dense datasets via an HDF5 hyperslab, sparse
    groups via `_sparse_rows`, categorical/nullable groups by slicing their
    codes/values.  ``sparse_dtype`` pre-casts a sparse node's densification
    (X reads pass float32 — single-materialization memory path)."""
    import h5py

    if isinstance(node, h5py.Dataset):
        return _decode(node[()] if rows is None else node[rows[0]:rows[1]])
    enc = _attr_str(node, "encoding-type")
    if enc in ("csr_matrix", "csc_matrix") or (
        "data" in node and "indices" in node and "indptr" in node
    ):
        lo, hi = rows if rows is not None else (0, _node_shape(node)[0])
        return _sparse_rows(node, enc, lo, hi, dtype=sparse_dtype)
    if enc == "categorical" or ("categories" in node and "codes" in node):
        cats = _decode(node["categories"][()])
        codes = (node["codes"][()] if rows is None
                 else node["codes"][rows[0]:rows[1]])
        out = np.empty(len(codes), dtype=object)
        mask = codes >= 0
        out[mask] = cats[codes[mask]]
        out[~mask] = None  # NaN category (semi-supervised entry point)
        return out
    if enc.startswith("nullable-") or ("values" in node and "mask" in node):
        # anndata >= 0.8 nullable-integer / nullable-boolean columns
        # (pandas Int64/boolean dtypes): masked entries become None — the
        # same NA convention the categorical branch and encoder use
        sl = slice(None) if rows is None else slice(rows[0], rows[1])
        values = node["values"][sl]
        mask = node["mask"][sl].astype(bool)
        out = np.empty(len(values), dtype=object)
        out[~mask] = values[~mask].tolist()
        out[mask] = None
        return out
    raise ValueError(f"unsupported h5ad node encoding: {enc!r}")


def _read_dataframe(group, rows=None):
    import pandas as pd

    index_name = group.attrs.get("_index", "_index")
    if isinstance(index_name, bytes):
        index_name = index_name.decode("utf-8")
    index = (_decode(_read_array(group[index_name], rows=rows))
             if index_name in group else None)
    order = group.attrs.get("column-order", None)
    if order is not None:
        cols = [c.decode("utf-8") if isinstance(c, bytes) else c for c in order]
    else:
        cols = [k for k in group.keys() if k != index_name]
    df = pd.DataFrame(index=index)
    for c in cols:
        if c in group:
            df[c] = _read_array(group[c], rows=rows)
    return df


def read_h5ad(path: str, obs_range=None) -> AnnData:
    """Load an .h5ad file into the port's AnnData (X densified; obs and var
    as pandas DataFrames).

    ``obs_range=(lo, hi)`` reads only cells (obs rows) [lo, hi) — X, obs,
    obsm and layers are range-read from disk (dense hyperslabs / CSR indptr
    slices / streamed CSC column blocks), var and varm in full.  This is
    the out-of-core ingestion path: a reader of a large atlas loads its
    own row range, so no process materializes the full matrix."""
    import h5py
    import pandas as pd

    with h5py.File(path, "r") as f:
        rows = None
        if obs_range is not None:
            lo, hi = (int(obs_range[0]), int(obs_range[1]))
            n_obs = _node_shape(f["X"])[0]
            if not (0 <= lo <= hi <= n_obs):
                raise ValueError(
                    f"obs_range {obs_range!r} out of bounds for an .h5ad "
                    f"file with {n_obs} obs rows (need 0 <= lo <= hi <= "
                    f"{n_obs})."
                )
            rows = (lo, hi)
        X = np.asarray(
            _read_array(f["X"], rows=rows, sparse_dtype=np.float32),
            dtype=np.float32,
        )
        default = lambda n: pd.DataFrame(index=pd.RangeIndex(n).astype(str))
        obs = (_read_dataframe(f["obs"], rows=rows) if "obs" in f
               else default(X.shape[0]))
        var = _read_dataframe(f["var"]) if "var" in f else default(X.shape[1])
        adata = AnnData(X, obs=obs, var=var)
        for name in ("obsm", "varm", "layers"):
            if name in f:
                target = getattr(adata, name)
                obs_aligned = name in ("obsm", "layers")
                for k in f[name]:
                    target[k] = _read_array(
                        f[name][k], rows=rows if obs_aligned else None
                    )
    return adata


def write_h5ad(adata, path: str) -> None:
    """Write an AnnData-compatible object to .h5ad.  Sparse X/layers/obsm
    values are written as CSR/CSC groups WITHOUT densifying (an atlas-scale
    count matrix stays a count matrix on disk, and the round trip through
    ``read_h5ad``'s out-of-core ``obs_range`` path keeps working); dense
    arrays are written as plain datasets.  Strings are stored as UTF-8
    variable-length (matching anndata; plain "S" dtype would crash on
    non-ASCII labels/barcodes).

    Every node carries the ``encoding-type``/``encoding-version`` attribute
    pair of the anndata ≥0.8 on-disk spec — anndata's IO registry dispatches
    readers on that pair, so files without it fail (or legacy-misparse) in
    scanpy, defeating this module's purpose."""
    import h5py
    import pandas as pd

    str_dt = h5py.string_dtype(encoding="utf-8")

    def enc(node, etype, eversion):
        node.attrs["encoding-type"] = etype
        node.attrs["encoding-version"] = eversion
        return node

    def utf8(values):
        return np.asarray([str(v) for v in values], dtype=object)

    def write_sparse(g, name, mat):
        # canonicalize (sums hand-built duplicates on a copy; COO/DIA → CSR)
        # so data/indices/indptr represent the dense values exactly
        mat = as_compressed(mat)
        fmt = getattr(mat, "format", "csr")
        if fmt not in ("csr", "csc"):  # pragma: no cover - as_compressed
            mat, fmt = mat.tocsr(), "csr"
        sg = enc(g.create_group(name), f"{fmt}_matrix", "0.1.0")
        sg.attrs["shape"] = np.asarray(mat.shape, dtype=np.int64)
        sg.create_dataset("data", data=mat.data)
        sg.create_dataset("indices", data=mat.indices)
        sg.create_dataset("indptr", data=mat.indptr)
        return sg

    def write_array(g, name, arr):
        if is_sparse_x(arr):
            return write_sparse(g, name, arr)
        arr = np.asarray(arr)
        if arr.dtype.kind in ("O", "U", "S"):
            ds = g.create_dataset(name, data=utf8(arr), dtype=str_dt)
            return enc(ds, "string-array", "0.2.0")
        return enc(g.create_dataset(name, data=arr), "array", "0.2.0")

    def write_nullable(g, name, col, bool_like):
        """pandas Int*/boolean extension columns and object columns of
        ints/bools with Nones write as anndata's nullable values+mask
        groups — stringifying them through the categorical branch would
        corrupt numeric obs metadata (1 -> "1") on the round trip."""
        mask = col.isna().to_numpy().astype(np.bool_)
        filler = False if bool_like else 0
        values = col.fillna(filler).to_numpy(
            dtype=np.bool_ if bool_like else np.int64
        )
        etype = "nullable-boolean" if bool_like else "nullable-integer"
        ng = enc(g.create_group(name), etype, "0.1.0")
        enc(ng.create_dataset("values", data=values), "array", "0.2.0")
        enc(ng.create_dataset("mask", data=mask), "array", "0.2.0")

    def _object_kind(col):
        """'bool'/'int' when every non-null element of an object column is
        a bool/integer (the reader's nullable output), else None."""
        # pandas-native NA detection: None, float nan AND pd.NA (e.g. an
        # Int64 column passed through .astype(object)) — a hand-rolled
        # None/nan test misses pd.NA and the column would stringify
        # through the categorical branch
        nonnull = [v for v, na in zip(col, col.isna()) if not na]
        if not nonnull:
            return None
        if all(isinstance(v, (bool, np.bool_)) for v in nonnull):
            return "bool"
        if all(isinstance(v, (int, np.integer))
               and not isinstance(v, (bool, np.bool_)) for v in nonnull):
            return "int"
        return None

    def write_df(f, name, df):
        g = enc(f.create_group(name), "dataframe", "0.2.0")
        g.attrs["_index"] = "_index"
        g.attrs.create("column-order", utf8(df.columns), dtype=str_dt)
        ds = g.create_dataset("_index", data=utf8(df.index), dtype=str_dt)
        enc(ds, "string-array", "0.2.0")
        for c in df.columns:
            col = df[c]
            if (pd.api.types.is_extension_array_dtype(col.dtype)
                and not isinstance(col.dtype, pd.CategoricalDtype)
                and (pd.api.types.is_integer_dtype(col.dtype)
                     or pd.api.types.is_bool_dtype(col.dtype))
            ):  # pandas Int8..Int64 / boolean nullable dtypes
                write_nullable(g, c, col,
                               pd.api.types.is_bool_dtype(col.dtype))
            elif col.dtype == object and _object_kind(col) is not None:
                write_nullable(g, c, col, _object_kind(col) == "bool")
            elif (col.dtype == object or str(col.dtype) == "category"
                  or isinstance(col.dtype, pd.StringDtype)):
                # StringDtype included: modern pandas infers it for string
                # columns, and the plain string-array fallback would
                # stringify missing values to a literal "nan"
                s = (col if str(col.dtype) == "category"
                     else col.astype("category"))
                cg = enc(g.create_group(c), "categorical", "0.2.0")
                cg.attrs["ordered"] = False
                enc(cg.create_dataset("categories",
                                      data=utf8(s.cat.categories),
                                      dtype=str_dt), "string-array", "0.2.0")
                enc(cg.create_dataset("codes",
                                      data=s.cat.codes.to_numpy()),
                    "array", "0.2.0")
            else:
                write_array(g, c, col.to_numpy())

    with h5py.File(path, "w") as f:
        enc(f, "anndata", "0.1.0")
        if is_sparse_x(adata.X):
            write_sparse(f, "X", adata.X)
        else:
            write_array(f, "X", np.asarray(adata.X))
        write_df(f, "obs", _frame(pd, adata.obs, adata.obs_names))
        write_df(f, "var", _frame(pd, getattr(adata, "var", None),
                                  adata.var_names))
        for name in ("obsm", "varm", "layers"):
            src = getattr(adata, name, None)
            if src:
                g = enc(f.create_group(name), "dict", "0.1.0")
                for k, v in src.items():
                    write_array(g, k, v)


def _frame(pd, table, names):
    """An obs/var table as a DataFrame: as it is, or a dict of columns
    indexed by the axis names."""
    if hasattr(table, "columns"):
        return table
    return pd.DataFrame(dict(table or {}), index=pd.Index(np.asarray(names)))

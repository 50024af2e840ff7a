"""Export, persistence and h5ad I/O of the port against the JAX package, on
the CPU at small shapes.

- ``ALPINE.save``/``ALPINE.load`` (alpine_tpu_torch/io/checkpoint.py) in
  every direction: port → port (matrices bit-equal, transforms equal),
  JAX save → port load in a subprocess where ``jax``, ``alpine_tpu``,
  ``sklearn`` and ``pandas`` cannot be imported, and port save → JAX load
  (matrices, covariate gene scores and ``transform``);
- ``get_normalized_expression`` against ``alpine_tpu.ALPINE``'s on the
  same matrices and embedding (rtol 1e-5, atol 1e-6), blockwise against
  one slab, ``on_device`` against the host, and the errors of an untrained
  model or bad arguments (same type and message);
- ``read_h5ad``/``write_h5ad``/``h5ad_dims`` (alpine_tpu_torch/io/h5ad.py):
  the cases of tests/test_h5ad.py that need no multi-process helpers, each
  run port → port, JAX write → port read and port write → JAX read.

Transforms of the two packages are compared from the JAX package's H0
(the ``jax_draws`` fixture) at K3's plain tolerance against JAX (rtol 2e-4,
atol 1e-6, as tests/test_torch_model.py holds them).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

h5py = pytest.importorskip("h5py")
from scipy import sparse  # noqa: E402

import alpine_tpu_torch.models.alpine as talpine  # noqa: E402
from alpine_tpu import ALPINE as JaxALPINE  # noqa: E402
from alpine_tpu.io import h5ad as jh5ad  # noqa: E402
from alpine_tpu.ops import mu as jmu  # noqa: E402
from alpine_tpu.utils.adata import AnnData as JaxAnnData  # noqa: E402
from alpine_tpu_torch import ALPINE, AnnData  # noqa: E402
from alpine_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from alpine_tpu_torch.io import h5ad as th5ad  # noqa: E402
from alpine_tpu_torch.ops import kernels  # noqa: E402
from alpine_tpu_torch.utils.single_cell import normalize_total  # noqa: E402

from .conftest import make_synthetic_adata  # noqa: E402
from .test_torch_cuda import MatmulDevices  # noqa: E402
from .test_torch_model import KEYS, KW, _adata, jax_draws  # noqa: E402,F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _fitted_port(**kw):
    m = ALPINE(device="cpu", **{**KW, **kw})
    m.fit(_adata(integer=True), KEYS, max_iter=6)
    return m


def _jax_h0(n_components, n_cells, random_state, eps):
    key = jmu.transform_key(jax.random.PRNGKey(random_state))
    return np.array(jnp.maximum(jax.random.uniform(
        key, (n_components, n_cells), dtype=jnp.float32), eps))


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------


def test_save_load_roundtrip(tmp_path):
    model = _fitted_port()
    path = str(tmp_path / "model")
    model.save(path)
    assert (tmp_path / "model.npz").exists()
    assert (tmp_path / "model.encoders.pkl").exists()
    loaded = ALPINE.load(path, device="cpu")
    assert loaded.device == torch.device("cpu")
    for name in ("Ws", "Hs", "Bs", "Ys"):
        for a, b in zip(model.matrices[name], loaded.matrices[name]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(model.matrices["X"], loaded.matrices["X"])
    pd.testing.assert_frame_equal(model.loss_history, loaded.loss_history)
    assert loaded.max_iter == model.max_iter
    assert loaded.covariate_keys == KEYS
    assert loaded.data_dtype_ == model.data_dtype_ == "int8"
    assert loaded.fe.encoded_labels == model.fe.encoded_labels
    assert getattr(loaded, "_x_cache", None) is None

    # a loaded model transforms new data as the model it was saved from
    fresh_a, fresh_b = _adata(integer=True, seed=9), _adata(integer=True, seed=9)
    model.transform(fresh_a, n_iter=5)
    kernels.reset_launches()
    loaded.transform(fresh_b, n_iter=5)
    for k in ["ALPINE_embedding"] + KEYS:
        np.testing.assert_array_equal(fresh_a.obsm[k], fresh_b.obsm[k])
    sa, sb = model.get_covariate_gene_scores(), loaded.get_covariate_gene_scores()
    for key in KEYS:
        pd.testing.assert_frame_equal(sa[key], sb[key])
    # a path ending in .npz names the same files
    model.save(str(tmp_path / "other.npz"))
    assert (tmp_path / "other.encoders.pkl").exists()
    again = ALPINE.load(str(tmp_path / "other.npz"), device="cpu")
    np.testing.assert_array_equal(again.matrices["Ws"][0], model.matrices["Ws"][0])


def test_save_unfitted_raises(tmp_path):
    for cls in (JaxALPINE, ALPINE):
        with pytest.raises(RuntimeError, match="not trained"):
            cls(device="cpu", **KW).save(str(tmp_path / "x"))


def test_save_load_preserves_precision_settings(tmp_path):
    m = _fitted_port(matmul_precision="default", data_dtype="bfloat16")
    p = str(tmp_path / "m")
    m.save(p)
    loaded = ALPINE.load(p, device="cpu")
    assert loaded.matmul_precision == "default"
    assert loaded.data_dtype == loaded.data_dtype_ == "bfloat16"
    with np.load(p + ".npz") as data:
        meta = json.loads(bytes(data["_meta"]).decode("utf-8"))
    assert meta["format_version"] == tckpt.FORMAT_VERSION == 1


def test_load_refuses_other_versions_and_globals(tmp_path):
    m = _fitted_port()
    p = str(tmp_path / "m")
    m.save(p)
    with np.load(p + ".npz") as data:
        arrays = dict(data)
    meta = json.loads(bytes(arrays["_meta"]).decode("utf-8"))
    meta["format_version"] = 2
    arrays["_meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
    np.savez_compressed(str(tmp_path / "v2.npz"), **arrays)
    (tmp_path / "v2.encoders.pkl").write_bytes((tmp_path / "m.encoders.pkl").read_bytes())
    with pytest.raises(ValueError, match="unsupported checkpoint version: 2"):
        ALPINE.load(str(tmp_path / "v2"), device="cpu")
    # a sidecar naming any other global is refused before it runs
    import pickle

    (tmp_path / "m.encoders.pkl").write_bytes(pickle.dumps(print))
    with pytest.raises(pickle.UnpicklingError, match="builtins.print"):
        ALPINE.load(p, device="cpu")


_BLOCKED_LOAD = r"""
import sys
for m in ("jax", "jaxlib", "alpine_tpu", "pandas", "sklearn"):
    sys.modules[m] = None  # any import of these now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
import alpine_tpu_torch.models.alpine as talpine
from alpine_tpu_torch import ALPINE, AnnData

d = sys.argv[1]
h0 = np.load(d + "/h0.npy")
talpine.draw_transform_h0 = (
    lambda n_components, n_cells, random_state, eps, device:
    torch.from_numpy(h0).to(device))
m = ALPINE.load(d + "/jax_model", device="cpu")
inp = np.load(d + "/input.npz", allow_pickle=True)
ad = AnnData(inp["X"], obs={k: inp[k] for k in ("batch", "condition")})
m.transform(ad, n_iter=int(inp["n_iter"]))
m.store_embeddings(ad)
emb = dict(ad.obsm)
m.get_normalized_expression(ad, library_size=100.0, cell_block_size=7)
out = {"norm": ad.layers["normalized_expression"], "data_dtype_": m.data_dtype_,
       "max_iter": m.max_iter, "loss": m.loss_history_}
out.update({"obsm_" + k: v for k, v in emb.items()})
for i, w in enumerate(m.matrices["Ws"]):
    out[f"Ws_{i}"] = w
for key in m.covariate_keys:
    out["labels_" + key] = np.asarray(m.fe.encoded_labels[key])
    out["cats_" + key] = np.asarray(m.fe.categories[key]).astype(str)
np.savez(d + "/port_out.npz", **out)
assert all(mod is None for mod in (sys.modules["jax"], sys.modules["pandas"],
                                   sys.modules["sklearn"], sys.modules["alpine_tpu"]))
print("ok")
"""


def test_jax_saved_model_loads_without_jax_pandas_sklearn(tmp_path):
    """A model the JAX package saved (sklearn encoders in its sidecar) loads
    into the port in a process that cannot import jax, alpine_tpu, sklearn
    or pandas, and transforms and exports as the JAX model does."""
    jm = JaxALPINE(device="cpu", **KW)
    jm.fit(_adata(integer=True), KEYS, max_iter=6)
    jm.save(str(tmp_path / "jax_model"))
    new = _adata(integer=True, seed=4)
    new.obs.loc[new.obs.index[:5], "batch"] = None  # NA rows encode to zeros
    n_iter = 7
    np.save(tmp_path / "h0.npy", _jax_h0(jm.total_components, new.n_obs,
                                         jm.random_state, jm.eps))
    np.savez(tmp_path / "input.npz", X=new.X, n_iter=n_iter,
             **{k: np.asarray(new.obs[k], dtype=object) for k in KEYS})
    out = subprocess.run([sys.executable, "-c", _BLOCKED_LOAD, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    got = np.load(tmp_path / "port_out.npz")
    assert str(got["data_dtype_"]) == jm.data_dtype_ and int(got["max_iter"]) == jm.max_iter
    np.testing.assert_array_equal(got["loss"], jm.loss_history.to_numpy())
    for i, w in enumerate(jm.matrices["Ws"]):
        np.testing.assert_array_equal(got[f"Ws_{i}"], w)
    for key in KEYS:
        assert got["labels_" + key].tolist() == jm.fe.encoded_labels[key]
        assert got["cats_" + key].tolist() == [
            str(c) for c in jm.fe.encoders[key].categories_[0]]
    ad_j = new.copy()
    jm.transform(ad_j, n_iter=n_iter)
    jm.store_embeddings(ad_j)
    for k in ["ALPINE_embedding"] + KEYS:
        np.testing.assert_allclose(got["obsm_" + k], ad_j.obsm[k], rtol=2e-4,
                                   atol=1e-6)
    for k in KEYS:
        np.testing.assert_array_equal(got[f"obsm_{k}_dummy_matrix"],
                                      ad_j.obsm[f"{k}_dummy_matrix"])
    # the export from the port's own embedding against the JAX export of it
    ad_j.obsm["ALPINE_embedding"] = got["obsm_ALPINE_embedding"]
    jm.get_normalized_expression(ad_j, library_size=100.0)
    np.testing.assert_allclose(got["norm"], ad_j.layers["normalized_expression"],
                               rtol=1e-5, atol=1e-6)


def test_port_saved_model_loads_into_jax(tmp_path, jax_draws):
    """The JAX package's ALPINE.load reads a port file: the same matrices
    and covariate gene scores, and its transform (which runs the port's
    encoder on a DataFrame obs) projects as the port does."""
    tm = _fitted_port()
    tm.save(str(tmp_path / "port_model"))
    jm = JaxALPINE.load(str(tmp_path / "port_model"), device="cpu")
    for name in ("Ws", "Hs", "Bs", "Ys"):
        for a, b in zip(tm.matrices[name], jm.matrices[name]):
            np.testing.assert_array_equal(a, b)
    assert (jm.max_iter, jm.data_dtype_, jm.covariate_keys) == (
        tm.max_iter, tm.data_dtype_, tm.covariate_keys)
    pd.testing.assert_frame_equal(jm.loss_history, tm.loss_history)
    st, sj = tm.get_covariate_gene_scores(), jm.get_covariate_gene_scores()
    for key in KEYS:
        pd.testing.assert_frame_equal(st[key], sj[key])
    new = _adata(integer=True, seed=6)
    ad_t, ad_j = new.copy(), new.copy()
    tm.transform(ad_t, n_iter=8)
    jm.transform(ad_j, n_iter=8)
    for k in ["ALPINE_embedding"] + KEYS:
        np.testing.assert_allclose(ad_t.obsm[k], ad_j.obsm[k], rtol=2e-4, atol=1e-6)
    tm.store_embeddings(ad_t)
    jm.store_embeddings(ad_j)
    for k in KEYS:
        np.testing.assert_array_equal(ad_t.obsm[f"{k}_dummy_matrix"],
                                      ad_j.obsm[f"{k}_dummy_matrix"])


# ---------------------------------------------------------------------------
# get_normalized_expression
# ---------------------------------------------------------------------------


@pytest.fixture
def exported_pair(tmp_path):
    """A JAX fit, the port model loaded from its file, and an adata whose
    embedding both export from."""
    ad = make_synthetic_adata(n_cells=90, n_genes=30, seed=2)
    jm = JaxALPINE(device="cpu", **KW)
    jm.fit(ad, KEYS, max_iter=10)
    jm.save(str(tmp_path / "m"))
    tm = ALPINE.load(str(tmp_path / "m"), device="cpu")
    return jm, tm, ad


@pytest.mark.parametrize("library_size", [None, 1e4, 100.0])
def test_normalized_expression_matches_jax(exported_pair, library_size):
    jm, tm, ad = exported_pair
    ad_t, ad_j = ad.copy(), ad.copy()
    ad_t.obsm["ALPINE_embedding"] = ad.obsm["ALPINE_embedding"]
    tm.get_normalized_expression(ad_t, library_size=library_size)
    jm.get_normalized_expression(ad_j, library_size=library_size)
    got, want = (ad_t.layers["normalized_expression"],
                 ad_j.layers["normalized_expression"])
    assert got.dtype == np.float32 and got.shape == ad.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    sums = got.sum(axis=1)
    target = np.median(sums) if library_size is None else library_size
    np.testing.assert_allclose(sums, target, rtol=1e-3)
    # the scanpy rule on the plain product, as the reference applies it
    W, H = tm.matrices["Ws"][-1], np.asarray(ad.obsm["ALPINE_embedding"]).T
    np.testing.assert_allclose(got, normalize_total((W @ H).T, library_size),
                               rtol=1e-5, atol=1e-6)


def test_normalized_expression_blockwise(exported_pair, tmp_path):
    """Block sizes change no value beyond BLAS's choice of kernel by slab
    width; covering blocks are one slab and give the same bits; ``out`` may
    be a memmap, and becomes the layer."""
    _, tm, ad = exported_pair
    n, g = ad.shape
    outs = {}
    for bs in (None, 7, n, 10 * n):
        a = ad.copy()
        a.obsm["ALPINE_embedding"] = ad.obsm["ALPINE_embedding"]
        tm.get_normalized_expression(a, cell_block_size=bs)
        outs[bs] = a.layers["normalized_expression"]
    np.testing.assert_array_equal(outs[n], outs[10 * n])
    for bs in (7, n, 10 * n):
        np.testing.assert_allclose(outs[None], outs[bs], rtol=1e-6, atol=2e-6)
    mm = np.memmap(tmp_path / "expr.f32", dtype=np.float32, mode="w+", shape=(n, g))
    tm.get_normalized_expression(ad, cell_block_size=9, out=mm)
    np.testing.assert_allclose(np.asarray(mm), outs[None], rtol=1e-6, atol=2e-6)
    assert ad.layers["normalized_expression"] is mm


@pytest.mark.parametrize("block", [None, 11])
def test_normalized_expression_on_device_matches_host(exported_pair, block):
    _, tm, ad = exported_pair
    tm.get_normalized_expression(ad, library_size=100.0, on_device=False,
                                 cell_block_size=block)
    host = np.asarray(ad.layers["normalized_expression"]).copy()
    tm.get_normalized_expression(ad, library_size=100.0, on_device=True,
                                 cell_block_size=block)
    dev = np.asarray(ad.layers["normalized_expression"])
    np.testing.assert_allclose(dev, host, rtol=1e-5, atol=1e-6)


def test_normalized_expression_runs_on_the_model_device(exported_pair):
    """By default each slab's product is a ``torch.matmul`` on the model's
    device (here the CPU), the same bits as ``on_device=True``;
    ``on_device=False`` makes no torch product (numpy on the host)."""
    _, tm, ad = exported_pair
    with MatmulDevices() as rec:
        tm.get_normalized_expression(ad, library_size=100.0, cell_block_size=11)
    assert rec.devices == ["cpu"] * 9  # 90 cells in slabs of 11
    default = np.asarray(ad.layers["normalized_expression"]).copy()
    tm.get_normalized_expression(ad, library_size=100.0, on_device=True,
                                 cell_block_size=11)
    np.testing.assert_array_equal(ad.layers["normalized_expression"], default)
    with MatmulDevices() as rec:
        tm.get_normalized_expression(ad, library_size=100.0, on_device=False,
                                     cell_block_size=11)
    assert rec.devices == []


_EXPORT_ERRORS = {
    "untrained": (False, lambda ad: (ad,), {}),
    "not-anndata": (True, lambda ad: (np.ones((3, 3)),), {}),
    "no-embedding": (True, lambda ad: (make_synthetic_adata(n_cells=90, n_genes=30),), {}),
    "library-size": (True, lambda ad: (ad,), dict(library_size=0.0)),
    "block-zero": (True, lambda ad: (ad,), dict(cell_block_size=0)),
    "block-float": (True, lambda ad: (ad,), dict(cell_block_size=2.5)),
    "out-shape": (True, lambda ad: (ad,), dict(out=np.empty((3, 3), np.float32))),
    "out-dtype": (True, lambda ad: (ad,), dict(out=np.empty((90, 30), np.float64))),
}


@pytest.mark.parametrize("case", sorted(_EXPORT_ERRORS))
def test_export_errors_match_jax(exported_pair, case):
    jm, tm, ad = exported_pair
    trained, args, kw = _EXPORT_ERRORS[case]
    models = ((jm, tm) if trained
              else (JaxALPINE(device="cpu", **KW), ALPINE(device="cpu", **KW)))
    with pytest.raises((ValueError, TypeError, RuntimeError)) as ej:
        models[0].get_normalized_expression(*args(ad), **kw)
    with pytest.raises(type(ej.value)) as et:
        models[1].get_normalized_expression(*args(ad), **kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("method", ["transform", "compute_loss",
                                    "get_decomposed_matrices",
                                    "get_covariate_gene_scores",
                                    "store_embeddings"])
def test_untrained_errors_match_jax(method):
    ad = _adata(integer=True)
    args = () if method in ("get_decomposed_matrices",
                            "get_covariate_gene_scores") else (ad,)
    with pytest.raises(RuntimeError) as ej:
        getattr(JaxALPINE(device="cpu", **KW), method)(*args)
    with pytest.raises(RuntimeError) as et:
        getattr(ALPINE(device="cpu", **KW), method)(*args)
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# h5ad: the cases of tests/test_h5ad.py, in three directions
# ---------------------------------------------------------------------------

# (AnnData class the writer gets, writer, reader)
DIRECTIONS = {
    "port": (AnnData, th5ad.write_h5ad, th5ad.read_h5ad),
    "jax-write-port-read": (JaxAnnData, jh5ad.write_h5ad, th5ad.read_h5ad),
    "port-write-jax-read": (AnnData, th5ad.write_h5ad, jh5ad.read_h5ad),
}


@pytest.fixture(params=sorted(DIRECTIONS))
def io(request):
    return DIRECTIONS[request.param]


def _sample_adata(cls):
    r = np.random.default_rng(0)
    X = r.random((12, 5)).astype(np.float32)
    obs = pd.DataFrame(
        {"batch": pd.Categorical(["a", "b"] * 6),
         "score": np.arange(12, dtype=np.float64)},
        index=[f"cell{i}" for i in range(12)],
    )
    var = pd.DataFrame(index=[f"g{i}" for i in range(5)])
    ad = cls(X, obs=obs, var=var)
    ad.obsm["emb"] = r.random((12, 3))
    ad.varm["w"] = r.random((5, 3))
    ad.layers["norm"] = X * 2
    return ad


def test_round_trip(tmp_path, io):
    cls, write, read = io
    ad = _sample_adata(cls)
    p = str(tmp_path / "t.h5ad")
    write(ad, p)
    back = read(p)
    np.testing.assert_array_equal(back.X, ad.X)
    assert list(back.obs.index) == list(ad.obs.index)
    assert list(back.var.index) == list(ad.var.index) == list(back.var_names)
    assert list(back.obs["batch"]) == list(ad.obs["batch"])
    np.testing.assert_array_equal(back.obs["score"], ad.obs["score"])
    for name, k in (("obsm", "emb"), ("varm", "w"), ("layers", "norm")):
        np.testing.assert_array_equal(getattr(back, name)[k], getattr(ad, name)[k])


def test_dict_obs_writes_as_a_frame(tmp_path):
    """The port's AnnData with a dict obs and var names of its own writes
    the DataFrame layout the JAX reader reads back."""
    X = np.arange(12, dtype=np.float32).reshape(4, 3)
    ad = AnnData(X, obs={"batch": np.array(["a", None, "b", "a"], dtype=object),
                         "n": np.array([1, 2, None, 4], dtype=object)},
                 var_names=["g0", "g1", "g2"])
    ad.layers["twice"] = 2 * X
    assert list(ad.obs_names) == ["0", "1", "2", "3"]
    p = str(tmp_path / "dict.h5ad")
    th5ad.write_h5ad(ad, p)
    for read in (th5ad.read_h5ad, jh5ad.read_h5ad):
        back = read(p)
        assert list(back.obs_names) == ["0", "1", "2", "3"]
        assert list(back.var_names) == ["g0", "g1", "g2"]
        assert list(back.obs["n"]) == [1, 2, None, 4]
        s = back.obs["batch"]
        assert list(s[~s.isna()]) == ["a", "b", "a"] and bool(s.isna().iloc[1])
        np.testing.assert_array_equal(back.layers["twice"], 2 * X)


def test_port_anndata_axis_checks():
    """layers and obsm are checked against the cells, varm against the
    genes; a DataFrame obs or var names its axis with its index."""
    X = np.ones((4, 3), np.float32)
    ad = AnnData(X, var=pd.DataFrame(index=["a", "b", "c"]))
    assert list(ad.var_names) == ["a", "b", "c"] and list(ad.obs_names) == list("0123")
    for name, bad in (("layers", np.ones((3, 3))), ("obsm", np.ones((3, 2))),
                      ("varm", np.ones((4, 2)))):
        with pytest.raises(ValueError, match="leading dimension"):
            getattr(ad, name)["k"] = bad
    with pytest.raises(ValueError, match="var length does not match X columns"):
        AnnData(X, var=pd.DataFrame(index=["a"]))
    with pytest.raises(ValueError, match="obs length does not match X rows"):
        AnnData(X, obs=pd.DataFrame(index=["a"]))
    with pytest.raises(ValueError, match="var_names length does not match X columns"):
        AnnData(X, var_names=["a"])
    with pytest.raises(ValueError, match="var_names must be None"):
        AnnData(X, var=pd.DataFrame(index=["a", "b", "c"]), var_names=["x", "y", "z"])


def _write_csr_x(f, mat, *, fmt="csr", enc=True, shape_attr="shape"):
    g = f.create_group("X")
    if enc:
        g.attrs["encoding-type"] = enc if isinstance(enc, (str, bytes, np.bytes_)) \
            else f"{fmt}_matrix"
    g.attrs[shape_attr] = np.asarray(mat.shape, np.int64)
    g.create_dataset("data", data=mat.data)
    g.create_dataset("indices", data=mat.indices)
    g.create_dataset("indptr", data=mat.indptr)
    return g


def _names_group(f, name, names):
    g = f.create_group(name)
    g.attrs["_index"] = "_index"
    g.create_dataset("_index", data=np.asarray(names, dtype="S"))
    return g


def _read_both(p, **kw):
    """The port's read and the JAX package's of one file; X and the frames
    must agree."""
    got, want = th5ad.read_h5ad(p, **kw), jh5ad.read_h5ad(p, **kw)
    np.testing.assert_array_equal(got.X, want.X)
    pd.testing.assert_frame_equal(got.obs, want.obs)
    pd.testing.assert_frame_equal(got.var, want.var)
    return got


def test_read_sparse_csr_x(tmp_path):
    r = np.random.default_rng(1)
    dense = (r.random((8, 6)) * (r.random((8, 6)) > 0.5)).astype(np.float32)
    p = str(tmp_path / "sparse.h5ad")
    with h5py.File(p, "w") as f:
        _write_csr_x(f, sparse.csr_matrix(dense))
        _names_group(f, "obs", [f"c{i}" for i in range(8)])
        _names_group(f, "var", [f"g{i}" for i in range(6)])
    back = _read_both(p)
    np.testing.assert_allclose(back.X, dense)


def test_nan_categorical_codes(tmp_path):
    p = str(tmp_path / "nan.h5ad")
    with h5py.File(p, "w") as f:
        f.create_dataset("X", data=np.ones((4, 2), np.float32))
        obs = _names_group(f, "obs", list("abcd"))
        obs.attrs["column-order"] = np.asarray(["lab"], dtype="S")
        cg = obs.create_group("lab")
        cg.attrs["encoding-type"] = "categorical"
        cg.create_dataset("categories", data=np.asarray(["x", "y"], dtype="S"))
        cg.create_dataset("codes", data=np.asarray([0, -1, 1, 0], dtype=np.int8))
        _names_group(f, "var", ["g0", "g1"])
    vals = _read_both(p).obs["lab"]
    assert list(vals[~vals.isna()]) == ["x", "y", "x"]
    assert vals.isna().sum() == 1 and bool(vals.isna().iloc[1])


def test_fit_from_h5ad(tmp_path, io):
    """Write, read, fit with the port."""
    cls, write, read = io
    p = str(tmp_path / "fit.h5ad")
    write(_sample_adata(cls), p)
    loaded = read(p)
    loaded.obs["batch"] = loaded.obs["batch"].astype(object)
    m = ALPINE(n_components=3, n_covariate_components=[2], lam=[1.0],
               device="cpu", random_state=0)
    m.fit(loaded, ["batch"], max_iter=4)
    assert loaded.obsm["ALPINE_embedding"].shape == (12, 3)
    assert m.feature_names == [f"g{i}" for i in range(5)]


def test_non_ascii_strings_round_trip(tmp_path, io):
    cls, write, read = io
    obs = pd.DataFrame({"célл": pd.Categorical(["naïve", "naïve", "Tγδ"])},
                       index=["バー1", "バー2", "バー3"])
    p = str(tmp_path / "utf8.h5ad")
    write(cls(np.ones((3, 2), np.float32), obs=obs), p)
    back = read(p)
    assert list(back.obs.index) == ["バー1", "バー2", "バー3"]
    assert list(back.obs["célл"]) == ["naïve", "naïve", "Tγδ"]


def test_written_files_carry_anndata_encoding_metadata(tmp_path):
    p = str(tmp_path / "enc.h5ad")
    th5ad.write_h5ad(_sample_adata(AnnData), p)
    with h5py.File(p, "r") as f:
        assert f.attrs["encoding-type"] == "anndata"
        assert f["X"].attrs["encoding-type"] == "array"
        assert f["X"].attrs["encoding-version"] == "0.2.0"
        for name in ("obs", "var"):
            g = f[name]
            assert g.attrs["encoding-type"] == "dataframe"
            assert g.attrs["encoding-version"] == "0.2.0"
            assert g["_index"].attrs["encoding-type"] == "string-array"
        cat = f["obs"]["batch"]
        assert cat.attrs["encoding-type"] == "categorical"
        assert cat.attrs["encoding-version"] == "0.2.0"
        assert cat.attrs["ordered"] == False  # noqa: E712
        assert cat["categories"].attrs["encoding-type"] == "string-array"
        assert cat["codes"].attrs["encoding-type"] == "array"
        assert f["obsm"].attrs["encoding-type"] == "dict"
        assert f["obsm"]["emb"].attrs["encoding-type"] == "array"
        assert f["layers"]["norm"].attrs["encoding-type"] == "array"


def test_read_csc_with_bytes_encoding_attr(tmp_path):
    r = np.random.default_rng(0)
    X = ((r.random((6, 4)) < 0.5) * r.random((6, 4))).astype(np.float32)
    p = str(tmp_path / "csc_bytes.h5ad")
    with h5py.File(p, "w") as f:
        _write_csr_x(f, sparse.csc_matrix(X), enc=np.bytes_("csc_matrix"))
    np.testing.assert_allclose(np.asarray(_read_both(p).X), X, rtol=1e-6)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_read_legacy_sparse_without_encoding(tmp_path, fmt):
    r = np.random.default_rng(1)
    X = ((r.random((3, 7)) < 0.5) * r.random((3, 7))).astype(np.float32)
    mat = sparse.csr_matrix(X) if fmt == "csr" else sparse.csc_matrix(X)
    p = str(tmp_path / f"legacy_{fmt}.h5ad")
    with h5py.File(p, "w") as f:
        _write_csr_x(f, mat, enc=False)
    np.testing.assert_allclose(np.asarray(_read_both(p).X), X, rtol=1e-6)


def test_read_nullable_integer_column(tmp_path):
    p = str(tmp_path / "nullable.h5ad")
    with h5py.File(p, "w") as f:
        f.create_dataset("X", data=np.ones((3, 2), np.float32))
        obs = f.create_group("obs")
        obs.attrs["_index"] = "_index"
        obs.attrs["column-order"] = np.array(["count"], dtype=object)
        obs.create_dataset("_index", data=np.array(["a", "b", "c"], dtype=object))
        col = obs.create_group("count")
        col.attrs["encoding-type"] = "nullable-integer"
        col.create_dataset("values", data=np.array([1, 2, 3]))
        col.create_dataset("mask", data=np.array([False, True, False]))
    assert list(_read_both(p).obs["count"]) == [1, None, 3]


def _write_rich(tmp_path, x_writer):
    """File with every obs-aligned node kind: X (via x_writer), plain +
    categorical (with NaN) + nullable obs columns, obsm, varm, layers."""
    r = np.random.default_rng(7)
    dense = ((r.random((11, 6)) > 0.4) * r.random((11, 6))).astype(np.float32)
    p = str(tmp_path / "rich.h5ad")
    with h5py.File(p, "w") as f:
        x_writer(f, dense)
        obs = _names_group(f, "obs", [f"c{i}" for i in range(11)])
        obs.attrs["column-order"] = np.asarray(["lab", "score", "nn"], dtype="S")
        cg = obs.create_group("lab")
        cg.attrs["encoding-type"] = "categorical"
        cg.create_dataset("categories", data=np.asarray(["x", "y"], dtype="S"))
        cg.create_dataset("codes", data=np.asarray(
            [0, 1, -1, 0, 1, 0, -1, 1, 0, 1, 0], dtype=np.int8))
        obs.create_dataset("score", data=np.arange(11, dtype=np.float64))
        ng = obs.create_group("nn")
        ng.attrs["encoding-type"] = "nullable-integer"
        ng.create_dataset("values", data=np.arange(11, dtype=np.int64))
        ng.create_dataset("mask", data=(np.arange(11) % 4 == 1).astype(np.bool_))
        _names_group(f, "var", [f"g{i}" for i in range(6)])
        f.create_group("obsm").create_dataset("emb", data=r.random((11, 3)))
        f.create_group("varm").create_dataset("w", data=r.random((6, 2)))
        f.create_group("layers").create_dataset("norm", data=dense * 2)
    return p, dense


_X_WRITERS = {
    "dense": lambda f, d: f.create_dataset("X", data=d),
    "csr": lambda f, d: _write_csr_x(f, sparse.csr_matrix(d)),
    "csc": lambda f, d: _write_csr_x(f, sparse.csc_matrix(d), fmt="csc"),
}


@pytest.mark.parametrize("writer", sorted(_X_WRITERS))
def test_obs_range_read_matches_full_slice(tmp_path, writer):
    p, dense = _write_rich(tmp_path, _X_WRITERS[writer])
    assert th5ad.h5ad_dims(p) == jh5ad.h5ad_dims(p) == (11, 6)
    full = _read_both(p)
    np.testing.assert_allclose(full.X, dense, rtol=1e-6)
    for lo, hi in [(0, 11), (0, 5), (4, 9), (10, 11), (3, 3)]:
        part = _read_both(p, obs_range=(lo, hi))
        np.testing.assert_array_equal(part.X, full.X[lo:hi])
        assert list(part.obs.index) == list(full.obs.index[lo:hi])
        assert list(part.obs["lab"].fillna("NA")) == list(
            full.obs["lab"].fillna("NA")[lo:hi])
        np.testing.assert_array_equal(part.obs["score"], full.obs["score"][lo:hi])
        assert list(part.obs["nn"].isna()) == list(full.obs["nn"].isna()[lo:hi])
        np.testing.assert_array_equal(part.obsm["emb"], full.obsm["emb"][lo:hi])
        np.testing.assert_array_equal(part.layers["norm"], full.layers["norm"][lo:hi])
        assert list(part.var.index) == list(full.var.index)
        np.testing.assert_array_equal(part.varm["w"], full.varm["w"])


def test_obs_range_validation(tmp_path):
    p, _ = _write_rich(tmp_path, _X_WRITERS["dense"])
    for bad in [(-1, 4), (3, 2), (0, 12), (12, 12)]:
        with pytest.raises(ValueError) as ej:
            jh5ad.read_h5ad(p, obs_range=bad)
        with pytest.raises(ValueError, match="obs_range") as et:
            th5ad.read_h5ad(p, obs_range=bad)
        assert str(et.value) == str(ej.value)


def test_h5ad_dims_does_not_read_x(tmp_path):
    p, dense = _write_rich(tmp_path, _X_WRITERS["csr"])
    assert th5ad.h5ad_dims(p) == dense.shape


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_write_sparse_x_stays_sparse(tmp_path, fmt, io):
    cls, write, read = io
    r = np.random.default_rng(3)
    dense = ((r.random((10, 7)) > 0.6) * r.random((10, 7))).astype(np.float32)
    mat = sparse.csr_matrix(dense) if fmt == "csr" else sparse.csc_matrix(dense)
    ad = cls(mat, obs=pd.DataFrame(index=[f"c{i}" for i in range(10)]),
             var=pd.DataFrame(index=[f"g{i}" for i in range(7)]))
    ad.layers["counts"] = mat.copy()
    p = str(tmp_path / f"sp_{fmt}.h5ad")
    write(ad, p)
    with h5py.File(p, "r") as f:
        assert f["X"].attrs["encoding-type"] == f"{fmt}_matrix"
        assert f["X"].attrs["encoding-version"] == "0.1.0"
        assert tuple(f["X"].attrs["shape"]) == (10, 7)
        assert f["X"]["data"].shape[0] == mat.nnz  # not densified
        assert f["layers"]["counts"].attrs["encoding-type"] == f"{fmt}_matrix"
    back = read(p)
    np.testing.assert_allclose(back.X, dense, rtol=1e-6)
    np.testing.assert_allclose(back.layers["counts"], dense, rtol=1e-6)
    part = read(p, obs_range=(3, 8))
    np.testing.assert_allclose(part.X, dense[3:8], rtol=1e-6)
    np.testing.assert_allclose(part.layers["counts"], dense[3:8], rtol=1e-6)


def test_write_sparse_x_sums_duplicates_without_mutating(tmp_path, io):
    cls, write, read = io
    coo = sparse.coo_matrix(
        (np.asarray([5.0, -3.0, 1.0]), ([0, 0, 1], [1, 1, 0])), shape=(2, 3))
    nnz_before = coo.nnz
    ad = cls(coo, obs=pd.DataFrame(index=["a", "b"]),
             var=pd.DataFrame(index=["g0", "g1", "g2"]))
    p = str(tmp_path / "dup.h5ad")
    write(ad, p)
    assert coo.nnz == nnz_before
    np.testing.assert_allclose(read(p).X, np.asarray([[0, 2, 0], [1, 0, 0]], np.float32))


def test_nullable_numeric_obs_columns_round_trip(tmp_path, io):
    cls, write, read = io
    obs = pd.DataFrame(
        {"n_counts": pd.array([5, None, 7], dtype="Int64"),
         "flag": pd.array([True, None, False], dtype="boolean"),
         "obj_int": np.array([1, None, 3], dtype=object),
         "obj_bool": np.array([True, None, False], dtype=object),
         "strings": np.array(["a", None, "b"], dtype=object)},
        index=["c0", "c1", "c2"])
    p = str(tmp_path / "nullable_rt.h5ad")
    write(cls(np.ones((3, 2), np.float32), obs=obs), p)
    with h5py.File(p, "r") as f:
        for col, etype in (("n_counts", "nullable-integer"), ("flag", "nullable-boolean"),
                           ("obj_int", "nullable-integer"),
                           ("obj_bool", "nullable-boolean"), ("strings", "categorical")):
            assert f["obs"][col].attrs["encoding-type"] == etype
    back = read(p)
    assert list(back.obs["n_counts"]) == [5, None, 7]
    assert list(back.obs["flag"]) == [True, None, False]
    assert list(back.obs["obj_int"]) == [1, None, 3]
    assert list(back.obs["obj_bool"]) == [True, None, False]
    s = back.obs["strings"]
    assert list(s[~s.isna()]) == ["a", "b"] and bool(s.isna().iloc[1])
    p2 = str(tmp_path / "nullable_rt2.h5ad")
    th5ad.write_h5ad(back, p2)
    again = th5ad.read_h5ad(p2)
    assert list(again.obs["n_counts"]) == [5, None, 7]
    assert list(again.obs["obj_int"]) == [1, None, 3]


def test_object_column_with_pd_na_writes_nullable(tmp_path, io):
    cls, write, read = io
    obs = pd.DataFrame(
        {"na_int": pd.array([1, None, 3], dtype="Int64").astype(object),
         "na_bool": pd.array([True, None, False], dtype="boolean").astype(object)},
        index=["c0", "c1", "c2"])
    assert obs["na_int"].iloc[1] is pd.NA
    p = str(tmp_path / "pd_na.h5ad")
    write(cls(np.ones((3, 2), np.float32), obs=obs), p)
    with h5py.File(p, "r") as f:
        assert f["obs"]["na_int"].attrs["encoding-type"] == "nullable-integer"
        assert f["obs"]["na_bool"].attrs["encoding-type"] == "nullable-boolean"
    back = read(p)
    assert list(back.obs["na_int"]) == [1, None, 3]
    assert list(back.obs["na_bool"]) == [True, None, False]


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_read_h5sparse_legacy_attrs(tmp_path, fmt):
    r = np.random.default_rng(3)
    X = ((r.random((6, 6)) < 0.5) * r.random((6, 6))).astype(np.float32)
    mat = sparse.csr_matrix(X) if fmt == "csr" else sparse.csc_matrix(X)
    p = str(tmp_path / f"h5sparse_{fmt}.h5ad")
    with h5py.File(p, "w") as f:
        g = _write_csr_x(f, mat, enc=False, shape_attr="h5sparse_shape")
        g.attrs["h5sparse_format"] = fmt
    assert th5ad.h5ad_dims(p) == (6, 6)
    np.testing.assert_allclose(np.asarray(_read_both(p).X), X, rtol=1e-6)
    part = _read_both(p, obs_range=(2, 5))
    np.testing.assert_allclose(np.asarray(part.X), X[2:5], rtol=1e-6)


def test_csc_range_read_sums_duplicates_and_respects_dtype(tmp_path):
    p = str(tmp_path / "dupcsc.h5ad")
    with h5py.File(p, "w") as f:
        g = f.create_group("X")
        g.attrs["encoding-type"] = "csc_matrix"
        g.attrs["shape"] = (2, 3)
        g.create_dataset("data", data=np.asarray([5.0, -3.0, 4.0], np.float64))
        g.create_dataset("indices", data=np.asarray([0, 0, 1]))
        g.create_dataset("indptr", data=np.asarray([0, 2, 3, 3]))
    expected = np.asarray([[2.0, 0.0, 0.0], [0.0, 4.0, 0.0]], np.float32)
    full = _read_both(p)
    assert full.X.dtype == np.float32
    np.testing.assert_allclose(full.X, expected)
    np.testing.assert_allclose(_read_both(p, obs_range=(0, 1)).X, expected[:1])


def test_exported_layer_round_trips(tmp_path, exported_pair):
    """An export written with write_h5ad reads back bit for bit, in full and
    by obs_range, as X, obsm, varm and the layer."""
    _, tm, ad = exported_pair
    tm.get_normalized_expression(ad)
    p = str(tmp_path / "export.h5ad")
    th5ad.write_h5ad(ad, p)
    back = th5ad.read_h5ad(p)
    np.testing.assert_array_equal(back.X, ad.X)
    np.testing.assert_array_equal(back.layers["normalized_expression"],
                                  ad.layers["normalized_expression"])
    for name in ("obsm", "varm"):
        for k, v in getattr(ad, name).items():
            np.testing.assert_array_equal(getattr(back, name)[k], np.asarray(v))
    part = th5ad.read_h5ad(p, obs_range=(20, 47))
    np.testing.assert_array_equal(part.layers["normalized_expression"],
                                  back.layers["normalized_expression"][20:47])

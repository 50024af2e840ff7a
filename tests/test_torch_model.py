"""The port's estimator (alpine_tpu_torch.ALPINE on the CPU: the fused
fit loop with each kernel's plain version) against alpine_tpu.ALPINE (its
XLA path on the CPU), both started from the JAX package's init draws.

Trajectory tolerances are those of tests/test_pallas.py:135-137 — loss
rtol 5e-4, factors rtol 5e-3 atol 1e-5 — loose because the fused fit loop
and XLA sum in different orders (statistics carried across iterations,
whole-array vs per-tile reductions) and the differences grow along the
trajectory.  int8 data computes in bf16, where a last-bit difference can
flip a bf16 rounding of W or H; the JAX package's own two backends then
drift apart by ~3e-3 over 30 iterations (tests/test_torch_mu.py), so the
int8 case is held over 5 iterations and the longer fits use float data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import alpine_tpu_torch.models.alpine as talpine
from alpine_tpu import ALPINE as JaxALPINE
from alpine_tpu.ops import mu as jmu
from alpine_tpu.ops.elbow import find_elbow as jax_find_elbow
from alpine_tpu.utils.encoder import FeatureEncoders as JaxEncoders
from alpine_tpu_torch import ALPINE, AnnData
from alpine_tpu_torch.convert import fitted_from_numpy, state_from_numpy
from alpine_tpu_torch.ops.elbow import find_elbow
from alpine_tpu_torch.utils.encoder import FeatureEncoders

from .conftest import make_synthetic_adata

torch.set_num_threads(1)

KW = dict(n_components=6, n_covariate_components=[2, 3], lam=[5.0, 2.0],
          random_state=3)
KEYS = ["batch", "condition"]


def jax_fit_key(random_state, restart=0, chunk=None):
    """The key of the JAX estimator's sampled streams: split(PRNGKey(seed))[1]
    for a fit, its restart r > 0 starting from fold_in(PRNGKey(seed), r)
    (alpine_tpu/models/alpine.py:952-996), and checkpoint chunk c's
    fold_in(fit key, c) (:779)."""
    base = jax.random.PRNGKey(random_state)
    if restart:
        base = jax.random.fold_in(base, restart)
    _, key = jax.random.split(base)
    return key if chunk is None else jax.random.fold_in(key, chunk)


@pytest.fixture
def jax_draws(monkeypatch):
    """Make the port draw its fit init and transform H0 exactly as the JAX
    estimator does (jax.random streams, converted to tensors)."""
    def draw_init(cfg, n_genes, random_state, eps, device):
        init_key, _ = jax.random.split(jax.random.PRNGKey(random_state))
        jcfg = jmu.MUConfig(blocks=cfg.blocks, n_labels=cfg.n_labels,
                            n_cells=cfg.n_cells)
        W0, H0, Bs0 = jmu.init_matrices(jcfg, n_genes, init_key, eps)
        return state_from_numpy(W0, H0, Bs0, device)

    def draw_transform_h0(n_components, n_cells, random_state, eps, device):
        key = jmu.transform_key(jax.random.PRNGKey(random_state))
        H0 = jnp.maximum(jax.random.uniform(key, (n_components, n_cells),
                                            dtype=jnp.float32), eps)
        return torch.from_numpy(np.array(H0)).to(device)

    monkeypatch.setattr(talpine, "draw_init", draw_init)
    monkeypatch.setattr(talpine, "draw_transform_h0", draw_transform_h0)


def _adata(integer: bool, seed=0):
    ad = make_synthetic_adata(n_cells=150, n_genes=40, seed=seed)
    if integer:
        ad.X = np.round(ad.X)
    return ad


def _close(a, b, rtol=5e-3, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _compare_embeddings(ad_t, ad_j):
    assert set(ad_t.obsm) == set(ad_j.obsm)
    assert set(ad_t.varm) == set(ad_j.varm)
    for k in ad_j.obsm:
        _close(ad_t.obsm[k], ad_j.obsm[k])
    for k in ad_j.varm:
        _close(ad_t.varm[k], ad_j.varm[k])


def _fit_both(ad, max_iter, **kw):
    jm = JaxALPINE(device="cpu", **KW, **kw)
    tm = ALPINE(device="cpu", **KW, **kw)
    ad_j, ad_t = ad.copy(), ad.copy()
    jm.fit(ad_j, KEYS, max_iter=max_iter)
    tm.fit(ad_t, KEYS, max_iter=max_iter)
    return jm, tm, ad_j, ad_t


def _check_fit_and_transform(jm, tm, ad_j, ad_t):
    assert tm.data_dtype_ == jm.data_dtype_
    assert tm.max_iter == jm.max_iter
    assert list(tm.loss_history.columns) == list(jm.loss_history.columns)
    # the reconstruction loss is ‖X‖² − 2Σ(WᵀX)∘H + Σ(WᵀW)∘(HHᵀ), a
    # difference of f32 sums of size ‖X‖²: its rounding floor is absolute
    # (two f32 sums in different orders differ by ~1e-6·‖X‖²), which
    # dominates once a long fit drives the loss down to a few % of ‖X‖²
    L_t, L_j = tm.loss_history_, jm.loss_history.values
    floor = 2e-6 * float(np.sum(np.square(np.asarray(ad_t.X, np.float64))))
    _close(L_t[:, :2], L_j[:, :2], rtol=5e-4, atol=floor)
    _close(L_t[:, 2:], L_j[:, 2:], rtol=5e-4, atol=0)
    _compare_embeddings(ad_t, ad_j)
    scores_t = tm.get_covariate_gene_scores()
    for key, df in jm.get_covariate_gene_scores().items():
        assert list(scores_t[key].columns) == list(df.columns)
        assert list(scores_t[key].index) == list(df.index)
        _close(scores_t[key].values, df.values)
    jm.transform(ad_j)
    tm.transform(ad_t)
    _compare_embeddings(ad_t, ad_j)
    _close(tm.compute_loss(ad_t), jm.compute_loss(ad_j), rtol=5e-4, atol=0)


def test_int8_auto_fit_transform_matches_jax(jax_draws):
    jm, tm, ad_j, ad_t = _fit_both(_adata(integer=True), max_iter=5)
    assert tm.data_dtype_ == "int8"
    _check_fit_and_transform(jm, tm, ad_j, ad_t)


@pytest.mark.parametrize("loss_type", ["kl-divergence", "frobenius"])
def test_fit_transform_matches_jax(jax_draws, loss_type):
    jm, tm, ad_j, ad_t = _fit_both(_adata(integer=False), max_iter=30,
                                   loss_type=loss_type, orth_W=0.1)
    assert tm.data_dtype_ == "float32"
    _check_fit_and_transform(jm, tm, ad_j, ad_t)


def test_elbow_fit_matches_jax(jax_draws):
    """max_iter=None: a 200-iteration warm-up, the elbow of its log10
    reconstruction loss, then the fit at that length."""
    jm, tm, ad_j, ad_t = _fit_both(_adata(integer=False, seed=1), max_iter=None)
    assert 0 < tm.max_iter < 200
    _check_fit_and_transform(jm, tm, ad_j, ad_t)


def test_transform_of_a_jax_fitted_model(jax_draws):
    """convert.fitted_from_numpy: a port model holding a JAX fit projects
    new data as the JAX model does."""
    ad = _adata(integer=True)
    jm = JaxALPINE(device="cpu", **KW)
    jm.fit(ad.copy(), KEYS, max_iter=10)
    tm = fitted_from_numpy(
        ALPINE(device="cpu", **KW), jm.get_decomposed_matrices(),
        jm.fe.encoded_labels, covariate_keys=KEYS,
        feature_names=jm.feature_names, max_iter=jm.max_iter,
        data_dtype=jm.data_dtype_)
    new = _adata(integer=True, seed=5)
    ad_j, ad_t = new.copy(), new.copy()
    jm.transform(ad_j)
    tm.transform(ad_t)
    for k in ["ALPINE_embedding"] + KEYS:
        _close(ad_t.obsm[k], ad_j.obsm[k], rtol=2e-4, atol=1e-6)
    tm.store_embeddings(ad_t)
    jm.store_embeddings(ad_j)
    for k in KEYS:
        np.testing.assert_array_equal(ad_t.obsm[f"{k}_dummy_matrix"],
                                      ad_j.obsm[f"{k}_dummy_matrix"])


@pytest.mark.parametrize("kwargs", [
    dict(n_components=0),
    dict(lam=[1, 2]),
    dict(n_covariate_components=(2, 3)),
    dict(loss_type="poisson"),
    dict(eps=-1.0),
    dict(matmul_precision="tf32"),
    dict(data_dtype="fp8"),
], ids=["n_components", "lam-int", "ncc-tuple", "loss", "eps", "precision",
        "dtype"])
def test_constructor_errors_match_jax(kwargs):
    args = {**KW, **kwargs}
    with pytest.raises((ValueError, TypeError)) as ej:
        JaxALPINE(device="cpu", **args)
    with pytest.raises(type(ej.value), match=None) as et:
        ALPINE(device="cpu", **args)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("case", ["negative", "missing-key", "numeric-key",
                                  "keys-length", "max_iter", "sampling"])
def test_fit_errors_match_jax(case):
    ad = _adata(integer=True)
    keys, kw = KEYS, {}
    if case == "negative":
        ad.X = ad.X.copy()
        ad.X[0, 0] = -1.0
    elif case == "missing-key":
        keys = ["batch", "nope"]
    elif case == "numeric-key":
        ad.obs["condition"] = np.arange(ad.n_obs, dtype=np.float64)
    elif case == "keys-length":
        keys = ["batch"]
    elif case == "max_iter":
        kw = dict(max_iter=0)
    else:
        kw = dict(sampling_method="bogus")
    with pytest.raises((ValueError, TypeError)) as ej:
        JaxALPINE(device="cpu", **KW).fit(ad.copy(), keys, **kw)
    with pytest.raises(type(ej.value)) as et:
        ALPINE(device="cpu", **KW).fit(ad.copy(), keys, **kw)
    assert str(et.value) == str(ej.value)


def test_unported_options_raise(tmp_path):
    """Nothing of the single-device estimator is left out any more: tiled
    sampling, restarts, checkpoints, bucketing, minibatch and gathered
    weighted fits all run and raise no NotImplementedError."""
    ad = _adata(integer=True)
    m = ALPINE(device="cpu", **KW)
    for kw in (dict(sampling_method="tiled", batch_size=100),
               dict(n_restarts=2), dict(checkpoint_dir=str(tmp_path)),
               dict(batch_size=10), dict(sampling_method="weighted")):
        m.fit(ad, KEYS, max_iter=2, **kw)
        assert np.isfinite(m.loss_history_).all() and m.loss_history_.shape == (2, 4)
    b = ALPINE(device="cpu", component_bucket=8, **KW)
    b.fit(ad, KEYS, max_iter=2)
    assert [w.shape[1] for w in b.matrices["Ws"]] == [2, 3, 6]


def test_encoder_matches_sklearn_encoder():
    obs = pd.DataFrame({
        "a": pd.Series(["x", None, "y", "x", np.nan, "z"], dtype=object),
        "b": pd.Categorical(["p", "q", None, "q", "p", "p"]),
        "c": pd.array(["u", pd.NA, "v", "u", "v", pd.NA], dtype="string"),
    })
    keys = ["a", "b", "c"]
    want, got = JaxEncoders(keys), FeatureEncoders(keys)
    for w, g in zip(want.fit_transform(obs), got.fit_transform(obs)):
        np.testing.assert_array_equal(g, w)
    assert got.encoded_labels == want.encoded_labels
    new = pd.DataFrame({"a": ["y", "unseen", None], "b": ["q", "p", "r"],
                        "c": ["v", "w", "u"]}, dtype=object)
    for w, g in zip(want.transform(new), got.transform(new)):
        np.testing.assert_array_equal(g, w)
    # a plain dict of arrays encodes as the DataFrame does
    as_dict = {k: np.asarray(obs[k], dtype=object) for k in keys}
    for w, g in zip(want.transform(obs), got.transform(as_dict)):
        np.testing.assert_array_equal(g, w)


def test_find_elbow_matches_jax():
    r = np.random.default_rng(0)
    x = np.arange(200, dtype=np.float64)
    curves = [np.exp(-x / 20) + 1e-3 * r.random(200),
              1.0 / (1.0 + x) + 0.01,
              np.log10(5e4 * np.exp(-x / 35) + 1e4),
              np.linspace(1.0, 0.0, 50),
              np.array([3.0, 2.0])]
    for y in curves:
        assert find_elbow(y) == jax_find_elbow(y)


def test_port_anndata_with_dict_obs():
    r = np.random.default_rng(1)
    X = r.poisson(2.0, (80, 12)).astype(np.float32)
    obs = {"batch": np.array(["b0", "b1"] * 40, dtype=object)}
    ad = AnnData(X, obs=obs)
    m = ALPINE(n_components=3, n_covariate_components=[2], lam=[1.0],
               device="cpu")
    m.fit(ad, ["batch"], max_iter=5)
    m.transform(ad)
    assert m.data_dtype_ == "int8"
    assert ad.obsm["ALPINE_embedding"].shape == (80, 3)
    assert ad.obsm["batch_dummy_matrix"].shape == (80, 2)
    assert m.loss_history_.shape == (5, 3)

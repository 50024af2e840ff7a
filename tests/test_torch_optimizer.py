"""The port's ComponentOptimizer (alpine_tpu_torch/optimize/optimizer.py)
against the JAX package's on the CPU.

- Every validation error and message of tests/test_optimizer.py's
  validation cases, and the constructor's sampling/dtype checks.
- ``allocate_components`` on a grid of totals, ratios and floors.
- The sequential route (``fold_batching=False``): with the JAX package's
  init and transform draws patched in, on the float32 data with a planted
  batch effect of tests/test_search_quality.py, ``calc_score`` equals the
  JAX package's within 1e-6 (same folds, the same neighbours and the same
  Leiden partition); a 3-trial search picks the same best point, and
  ``get_train_history`` is the JAX package's frame.
- Searches with dict and pandas ``obs`` holding missing covariates, the
  batched route, persistence of trials and of the optimizer, and
  ``AnnData.__getitem__`` / ``copy``.
"""

import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from alpine_tpu import ComponentOptimizer as JaxCO
from alpine_tpu.optimize.optimizer import allocate_components as jax_allocate
from alpine_tpu_torch import AnnData, ComponentOptimizer
from alpine_tpu_torch.optimize.optimizer import allocate_components

from .conftest import make_synthetic_adata
from .test_search_quality import _batch_effect_adata
from .test_torch_model import jax_draws  # noqa: F401  (fixture)

torch.set_num_threads(1)

BASE = {"n_components": 8, "n_covariate_components": [2], "orth_W": 0.0,
        "alpha_W": 0.0, "l1_ratio_W": 0.0}


def _port(ad, dict_obs=False):
    """The port's AnnData over the same X and obs (a pandas frame, or a
    dict of object arrays with the frame's index as obs names)."""
    if not dict_obs:
        return AnnData(ad.X, obs=ad.obs, var=ad.var)
    out = AnnData(ad.X, obs={k: ad.obs[k].to_numpy(dtype=object) for k in ad.obs},
                  var_names=list(ad.var.index))
    out._obs_names = np.asarray(ad.obs.index)
    return out


@pytest.fixture(scope="module")
def small():
    return make_synthetic_adata(n_cells=90, n_genes=25, covariates=(("batch", 2),), seed=11)


def _both_raise(exc, fn_jax, fn_port):
    """Both raise the same exception type with the same message (``exc``
    None: whatever the JAX package raises)."""
    with pytest.raises(exc or Exception) as ej:
        fn_jax()
    with pytest.raises(type(ej.value)) as et:
        fn_port()
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("case", [
    dict(adata="x"), dict(keys=["nope"]), dict(keys="batch"), dict(keys=[3]),
    dict(loss_type="huber"), dict(max_iter=-1), dict(batch_size=2.5),
    dict(random_state="0"), dict(fold_batching=1), dict(shape_bucket=0),
    dict(sampling_method="bogus"), dict(sampling_method="weighted_fast", batch_size=10),
    dict(sampling_method="weighted_fast", use_als=True), dict(sampling_method="tiled"),
    dict(sampling_method="tiled", batch_size=10, use_als=True),
    dict(data_dtype="int4"), dict(data_dtype="int8"),
])
def test_constructor_errors_match_jax(small, case):
    case = dict(case)
    ad_j = case.pop("adata", small)
    ad_t = ad_j if isinstance(ad_j, str) else _port(small)
    keys = case.pop("keys", ["batch"])
    _both_raise(None, lambda: JaxCO(ad_j, keys, device="cpu", **case),
                lambda: ComponentOptimizer(ad_t, keys, device="cpu", **case))


@pytest.mark.parametrize("kw,exc", [
    (dict(n_total_components_range=(20, 10)), ValueError),
    (dict(n_total_components_range=(1, 10)), ValueError),
    (dict(n_total_components_range=[5, 10]), TypeError),
    (dict(lam_range=(1, 10)), TypeError),
    (dict(lam_range=(10.0, 1.0)), ValueError),
    (dict(orth_W_range=(0.0,)), TypeError),
    (dict(l1_ratio_W_range=(0.0, 2.0)), ValueError),
    (dict(n_splits=1), ValueError), (dict(n_splits=2.0), TypeError),
    (dict(max_evals=0), ValueError),
    (dict(min_covariate_components=[1]), ValueError),
    (dict(min_covariate_components=[2, 3]), ValueError),
])
def test_search_errors_match_jax(small, kw, exc):
    cj = JaxCO(small, ["batch"], max_iter=5, device="cpu")
    ct = ComponentOptimizer(_port(small), ["batch"], max_iter=5, device="cpu")
    _both_raise(exc, lambda: cj.search_hyperparams(**kw),
                lambda: ct.search_hyperparams(**kw))


def test_errors_before_a_search_match_jax(small):
    cj = JaxCO(small, ["batch"], max_iter=5, device="cpu")
    ct = ComponentOptimizer(_port(small), ["batch"], max_iter=5, device="cpu")
    _both_raise(RuntimeError, cj.fit_the_best_param, ct.fit_the_best_param)
    _both_raise(RuntimeError, cj.extend_training, ct.extend_training)
    from alpine_tpu.optimize.tpe import Trials as JaxTrials
    from alpine_tpu_torch.optimize.tpe import Trials
    cj.trials, ct.trials = JaxTrials(), Trials()
    _both_raise(RuntimeError, cj.get_train_history, ct.get_train_history)


def test_allocate_components_matches_jax():
    r = np.random.default_rng(0)
    for total in (4, 7, 10, 33, 64, 100, 257):
        for n_cov in (1, 2, 3):
            for _ in range(8):
                ratios = list(r.uniform(0.0, 1.0, n_cov + 1) + 1e-3)
                floors = list(r.integers(2, 6, n_cov))
                assert allocate_components(total, ratios, floors) == \
                    jax_allocate(total, ratios, floors)


@pytest.fixture(scope="module")
def planted():
    return _batch_effect_adata()


def test_sequential_calc_score_matches_jax(planted, jax_draws):
    cj = JaxCO(planted, ["batch"], max_iter=40, device="cpu", random_state=0,
               fold_batching=False)
    ct = ComponentOptimizer(_port(planted), ["batch"], max_iter=40, device="cpu",
                            random_state=0, fold_batching=False)
    for co in (cj, ct):
        co.n_splits, co.iter_records = 3, []
    folds_t, folds_j = ct._stratified_folds(), cj._stratified_folds()
    for (a, b), (c, d) in zip(folds_t, folds_j):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    for lam in (1e4, 1e-3):
        st = ct.calc_score({**BASE, "lam": [lam]})
        sj = cj.calc_score({**BASE, "lam": [lam]})
        assert abs(st - sj) < 1e-6, (lam, st, sj)


def test_sequential_search_matches_jax(planted, jax_draws):
    kw = dict(n_total_components_range=(6, 14), lam_range=(1.0, 1e4), n_splits=2,
              max_evals=3)
    cj = JaxCO(planted, ["batch"], max_iter=30, device="cpu", random_state=0,
               fold_batching=False)
    ct = ComponentOptimizer(_port(planted), ["batch"], max_iter=30, device="cpu",
                            random_state=0, fold_batching=False)
    best_j = cj.search_hyperparams(**kw)
    best_t = ct.search_hyperparams(**kw)
    assert best_t == best_j
    np.testing.assert_allclose([t["result"]["loss"] for t in ct.trials.trials],
                               [t["result"]["loss"] for t in cj.trials.trials],
                               rtol=0, atol=1e-6)
    hj, ht = cj.get_train_history(), ct.get_train_history()
    assert list(ht.columns) == list(hj.columns)
    assert list(ht["tid"]) == list(hj["tid"])
    pd.testing.assert_frame_equal(ht.drop(columns="score"), hj.drop(columns="score"))
    np.testing.assert_allclose(ht["score"], hj["score"], atol=1e-6)
    assert ct.get_hyperparameter(0)["n_components"] == cj.get_hyperparameter(0)["n_components"]


@pytest.mark.parametrize("dict_obs", [False, True], ids=["pandas_obs", "dict_obs"])
@pytest.mark.parametrize("fold_batching", [False, True], ids=["sequential", "batched"])
def test_search_with_nan_covariates(dict_obs, fold_batching):
    """A missing covariate reads "nan" in the folds (one stratification
    class) and is masked in the score, with a pandas or a dict obs."""
    ad = make_synthetic_adata(n_cells=90, n_genes=20, covariates=(("batch", 2),),
                              na_frac=0.3, seed=7)
    co = ComponentOptimizer(_port(ad, dict_obs), ["batch"], max_iter=5, device="cpu",
                            random_state=0, fold_batching=fold_batching)
    co.search_hyperparams(n_total_components_range=(8, 14), lam_range=(1.0, 50.0),
                          n_splits=2, max_evals=2)
    ok = [t["result"]["loss"] for t in co.trials.trials if t["result"]["status"] == "ok"]
    assert ok and np.isfinite(ok).all()
    assert co.min_covariate_components == [2]  # the NA label is not a level
    cj = JaxCO(ad, ["batch"], max_iter=5, device="cpu", random_state=0)
    cj.n_splits = co.n_splits
    for (a, b), (c, d) in zip(co._stratified_folds(), cj._stratified_folds()):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_batched_search_persistence_and_refit(small, tmp_path):
    co = ComponentOptimizer(_port(small), ["batch"], max_iter=8, device="cpu",
                            random_state=0)
    best = co.search_hyperparams(n_total_components_range=(8, 16),
                                 lam_range=(1.0, 100.0), n_splits=2, max_evals=4)
    assert set(best) == {"n_components", "n_covariate_components", "lam", "alpha_W",
                         "orth_W", "l1_ratio_W", "random_state"}
    assert co._fold_cache is not None and co._fold_cache[1].Xtr.shape[0] == 2
    hist = co.get_train_history()
    assert (hist["score"].values[:-1] >= hist["score"].values[1:] - 1e-12).all()
    fn = str(tmp_path / "t.pkl")
    co.save_trials(fn)
    co2 = ComponentOptimizer(_port(small), ["batch"], max_iter=8, device="cpu",
                             random_state=0)
    co2.search_hyperparams(n_total_components_range=(8, 16), lam_range=(1.0, 100.0),
                           n_splits=2, max_evals=2, trials_filename=fn)
    assert len(co2.trials.trials) == len(co.trials.trials) + 2
    # the JAX package reads the port's trials file
    cj = JaxCO(small, ["batch"], max_iter=8, device="cpu")
    cj.load_trials(fn)
    assert len(cj.get_train_history()) == len(hist)
    n_before = len(co.trials.trials)
    co.extend_training(extra_evals=2)
    assert len(co.trials.trials) == n_before + 2
    # a pickle carries no device tensors and resumes its search
    blob = pickle.dumps(co)
    back = pickle.loads(blob)
    assert not hasattr(back, "_fold_cache") and back._exec_device == torch.device("cpu")
    model = co.fit_the_best_param()
    assert co._fold_cache is None and hasattr(model, "matrices")
    assert model.n_components == co.best_param["n_components"]
    assert np.isfinite(model.loss_history_).all()


def test_fold_batching_runs_sequential_until_max_iter_is_frozen(small, monkeypatch):
    co = ComponentOptimizer(_port(small), ["batch"], max_iter=None, device="cpu",
                            random_state=0)
    co.n_splits, co.iter_records = 2, []
    routes = []
    seq, bat = co._fit_one_fold, co._batched_fold_embeddings
    monkeypatch.setattr(co, "_fit_one_fold", lambda *a: routes.append("seq") or seq(*a))
    monkeypatch.setattr(co, "_batched_fold_embeddings",
                        lambda *a: routes.append("batched") or bat(*a))
    co.max_iter = 6
    co.calc_score({**BASE, "n_components": 5, "lam": [5.0]})
    assert routes == ["batched"]


def test_anndata_getitem_and_copy():
    ad = make_synthetic_adata(n_cells=12, n_genes=5, seed=2)
    for port in (_port(ad), _port(ad, dict_obs=True)):
        port.obsm["emb"] = np.arange(24.0).reshape(12, 2)
        port.layers["raw"] = np.asarray(port.X) * 2
        port.varm["w"] = np.ones((5, 3))
        idx = np.array([5, 0, 7])
        sub = port[idx]
        np.testing.assert_array_equal(sub.X, np.asarray(port.X)[idx])
        assert list(sub.obs_names) == [f"cell{i}" for i in idx]
        np.testing.assert_array_equal(np.asarray(sub.obs["batch"], dtype=object),
                                      np.asarray(port.obs["batch"], dtype=object)[idx])
        np.testing.assert_array_equal(sub.obsm["emb"], port.obsm["emb"][idx])
        np.testing.assert_array_equal(sub.layers["raw"], port.layers["raw"][idx])
        assert sub.varm["w"].shape == (5, 3) and list(sub.var_names) == list(port.var_names)
        assert port[3].shape == (1, 5) and port[2:6].shape == (4, 5)
        dup = port.copy()
        dup.X[0, 0] = -1.0
        dup.obsm["emb"][0, 0] = -1.0
        assert port.X[0, 0] != -1.0 and port.obsm["emb"][0, 0] == 0.0
        assert list(dup.obs_names) == list(port.obs_names)


def test_scoring_device_and_defaults(small, monkeypatch):
    """CPU fits keep the float64 host kNN (as the JAX package keeps its
    sklearn search); the defaults are the JAX package's; without a card
    the default device raises instead of running on the CPU."""
    co = ComponentOptimizer(_port(small), ["batch"], device="cpu")
    assert co._scoring_device() is None
    assert (co.fold_batching, co.shape_bucket, co.random_state) == (True, "auto", 42)
    assert co.data_dtype_ == JaxCO(small, ["batch"], device="cpu").data_dtype_
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ComponentOptimizer(_port(small), ["batch"])

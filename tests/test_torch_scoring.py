"""The port's CV scoring pieces against scikit-learn and the JAX package:

- ``metrics.stratified_kfold`` gives ``StratifiedKFold``'s (train, test)
  index pairs exactly, with its warning and errors, on joint "_" labels,
  classes smaller than n_splits, labels reading "nan", and several seeds;
- ``adjusted_rand_score`` and ``homogeneity_score`` equal scikit-learn's
  to 1e-12, special cases included;
- ``scoring.knn_graph`` (edges and UMAP weights) equals the JAX package's
  to 1e-12 on the host search (embeddings of at most 15 dimensions, where
  scikit-learn's search is float64-exact) and to 1e-5 on the torch search
  run on CPU tensors against JAX's device search on the CPU;
- ``scoring.leiden`` returns the JAX package's labels for seeds 0-2, with
  the native library and with the Python Louvain fallback;
- ``embedding_score`` equals the JAX package's, NaN covariates included.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from sklearn.metrics.cluster import adjusted_rand_score as sk_ari
from sklearn.metrics.cluster import homogeneity_score as sk_hom
from sklearn.model_selection import StratifiedKFold

from alpine_tpu.optimize import scoring as jscoring
from alpine_tpu_torch.native import leiden_backend
from alpine_tpu_torch.optimize import metrics, scoring

torch.set_num_threads(1)


def _labels(name, rng):
    if name == "joint":
        a = rng.choice(["b0", "b1"], 120)
        c = rng.choice(["c0", "c1", "c2"], 120)
        return np.array([f"{x}_{y}" for x, y in zip(a, c)], dtype=object)
    if name == "small_class":  # one class below n_splits
        lab = rng.choice(["x", "y", "z"], 60).astype(object)
        lab[[3, 17]] = "rare"
        return lab
    if name == "nan":  # a missing value stringified
        lab = rng.choice(["a", "b", "nan"], 50, p=[0.5, 0.3, 0.2]).astype(object)
        return np.array([f"{v}_{w}" for v, w in zip(lab, rng.choice(["u", "nan"], 50))],
                        dtype=object)
    return rng.integers(0, 4, 97)  # integer classes, in no sorted order


@pytest.mark.parametrize("name", ["joint", "small_class", "nan", "ints"])
@pytest.mark.parametrize("n_splits", [2, 3, 5])
@pytest.mark.parametrize("seed", [0, 1, 42])
def test_stratified_kfold_matches_sklearn(name, n_splits, seed):
    y = _labels(name, np.random.default_rng(seed + 7))
    with warnings.catch_warnings(record=True) as w_sk:
        warnings.simplefilter("always")
        want = list(StratifiedKFold(n_splits, shuffle=True, random_state=seed)
                    .split(np.zeros((len(y), 1)), y))
    with warnings.catch_warnings(record=True) as w_port:
        warnings.simplefilter("always")
        got = metrics.stratified_kfold(y, n_splits, shuffle=True, random_state=seed)
    assert len(got) == len(want) == n_splits
    for (tr, te), (str_, ste) in zip(got, want):
        np.testing.assert_array_equal(tr, str_)
        np.testing.assert_array_equal(te, ste)
    assert [str(x.message) for x in w_port] == [str(x.message) for x in w_sk]


def test_stratified_kfold_errors_match_sklearn():
    y = np.array(["a", "a", "b", "b", "c"], dtype=object)  # every class < 3
    for kw in (dict(n_splits=3, shuffle=True, random_state=0),
               dict(n_splits=6, shuffle=True, random_state=0),
               dict(n_splits=1, shuffle=True, random_state=0),
               dict(n_splits=2, shuffle=False, random_state=0)):
        with pytest.raises(ValueError) as e_sk:
            list(StratifiedKFold(**kw).split(np.zeros((5, 1)), y))
        with pytest.raises(ValueError) as e_port:
            metrics.stratified_kfold(y, **kw)
        assert " ".join(str(e_port.value).split()) == " ".join(str(e_sk.value).split())
    unshuffled = metrics.stratified_kfold(np.array([0, 1] * 6), 3)
    want = list(StratifiedKFold(3).split(np.zeros((12, 1)), np.array([0, 1] * 6)))
    for (tr, te), (a, b) in zip(unshuffled, want):
        np.testing.assert_array_equal(tr, a)
        np.testing.assert_array_equal(te, b)


@pytest.mark.parametrize("seed", range(6))
def test_ari_and_homogeneity_match_sklearn(seed):
    r = np.random.default_rng(seed)
    n = int(r.integers(2, 300))
    truth = r.choice(["a", "b", "c", "d"][: int(r.integers(1, 5))], n)
    clusters = r.integers(0, int(r.integers(1, 9)), n).astype(str)
    if seed == 5:
        clusters = truth.copy()  # full agreement
    assert abs(metrics.adjusted_rand_score(truth, clusters) - sk_ari(truth, clusters)) < 1e-12
    assert abs(metrics.homogeneity_score(truth, clusters) - sk_hom(truth, clusters)) < 1e-12


@pytest.mark.parametrize("truth,pred", [
    ([], []), (["a"], ["0"]), (["a"] * 5, ["0", "1", "0", "2", "1"]),
    (["a", "b", "a", "b"], ["0"] * 4), (["a", "b"], ["1", "0"])])
def test_ari_and_homogeneity_special_cases(truth, pred):
    truth, pred = np.array(truth, dtype=object), np.array(pred, dtype=object)
    assert metrics.adjusted_rand_score(truth, pred) == sk_ari(truth.astype(str), pred.astype(str))
    assert metrics.homogeneity_score(truth, pred) == sk_hom(truth.astype(str), pred.astype(str))


def _blobs(seed, n_per=60, d=6, dup=0):
    r = np.random.default_rng(seed)
    emb = np.vstack([r.normal(c, 0.6, (n_per, d)) for c in (0.0, 3.0, 6.0)])
    emb = np.abs(emb).astype(np.float32)
    if dup:
        emb = np.concatenate([emb, emb[:dup]])
    return emb


def _graph_dense(n, src, dst, w):
    A = np.zeros((n, n))
    A[src, dst] = w
    return A


@pytest.mark.parametrize("dup", [0, 9])
def test_knn_graph_matches_jax(dup):
    """With duplicate rows the searches order exactly tied twins
    differently (scikit-learn arbitrarily, the port by index), so the
    edges not touching a duplicated point are held tightly and the total
    edge mass within 2 %, as tests/test_knn.py does."""
    emb = _blobs(1, dup=dup)
    n = len(emb)
    clean = np.ones(n, bool)
    clean[:dup] = clean[n - dup:] = False
    clean = clean[:, None] & clean[None, :]
    graphs = [
        (scoring.knn_graph(emb, n_neighbors=15), jscoring.knn_graph(emb, n_neighbors=15),
         1e-12),
        (scoring.knn_graph(emb, n_neighbors=15, device=torch.device("cpu")),
         jscoring.knn_graph(emb, n_neighbors=15, device=jax.devices("cpu")[0]), 1e-5),
    ]
    for (ps, pd_, pw), (js, jd, jw), tol in graphs:
        A, B = _graph_dense(n, ps, pd_, pw), _graph_dense(n, js, jd, jw)
        if not dup:
            np.testing.assert_array_equal(ps, js)
            np.testing.assert_array_equal(pd_, jd)
        np.testing.assert_allclose(A[clean], B[clean], rtol=tol, atol=tol)
        assert abs(A.sum() - B.sum()) / B.sum() < (0.02 if dup else tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backend", ["native", "python"])
def test_leiden_matches_jax(seed, backend, monkeypatch):
    emb = _blobs(seed + 3, n_per=50)
    if backend == "python":
        monkeypatch.setattr(scoring, "leiden_native", lambda *a, **k: None)
        monkeypatch.setattr(jscoring, "leiden_native", lambda *a, **k: None)
    else:
        assert leiden_backend() == "native"
    got = scoring.leiden(emb, n_neighbors=15, resolution=1.0, seed=seed)
    want = jscoring.leiden(emb, n_neighbors=15, resolution=1.0, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) >= 3


def test_embedding_score_matches_jax_with_nan():
    r = np.random.default_rng(4)
    clusters = r.integers(0, 5, 80)
    vals = r.choice(["a", "b", "c"], 80).astype(object)
    vals[r.random(80) < 0.2] = None
    vals[[1, 2]] = np.nan
    assert scoring.embedding_score(clusters, vals) == jscoring.embedding_score(clusters, vals)
    assert np.isfinite(scoring.embedding_score(clusters, vals))
    both_nan = np.array([None, np.nan, "a", "a"], dtype=object)
    assert (scoring.embedding_score(np.array([0, 0, 1, 1]), both_nan)
            == jscoring.embedding_score(np.array([0, 0, 1, 1]), both_nan))


def test_python_louvain_separates_blobs():
    emb = _blobs(5)
    src, dst, w = scoring.knn_graph(emb)
    lab = scoring._python_louvain(len(emb), src, dst, w, seed=0)
    truth = np.repeat(["a", "b", "c"], 60)
    assert metrics.homogeneity_score(truth, lab.astype(str)) > 0.95


def test_leiden_build_failure_is_reported(monkeypatch, tmp_path):
    """A failed g++ build surfaces: leiden_backend() reads "python",
    build_error() says why, a warning is raised once, and scoring falls
    back to the Louvain of the JAX package's fallback."""
    import alpine_tpu_torch.native as native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_build", lambda lib: "g++ failed: no compiler")
    with pytest.warns(UserWarning, match="no compiler"):
        assert native.leiden_backend() == "python"
    assert native.build_error() == "g++ failed: no compiler"
    assert native.leiden_native(3, np.array([0]), np.array([1]), None) is None
    emb = _blobs(2, n_per=30)
    np.testing.assert_array_equal(
        scoring.leiden(emb, seed=0),
        scoring._python_louvain(len(emb), *scoring.knn_graph(emb), seed=0))

"""weighted_fast in the port (balanced sampling as per-cell draw counts)
against the JAX package on the CPU, from the same numpy inputs.

- the plain counts mode of ``kernels.fused_iteration`` (K4) against
  ``pallas_kernels.fused_iteration(counts=...)`` in interpret mode;
- the plain counts step against ``mu.joint_weighted_counts_update``;
- both port fit loops against ``mu.fit_scan`` (XLA and interpret-mode
  Pallas counts paths), fed the JAX package's own count stream;
- the estimator against ``alpine_tpu.ALPINE(...).fit(...,
  sampling_method="weighted_fast")``, its group sort, its device-X cache
  and its validation messages;
- the port's sampler and group tables.

Tolerances are those of tests/test_torch_kernels.py (one kernel call) and
tests/test_torch_mu.py (trajectories: loss rtol 5e-4, factors rtol 5e-3
atol 1e-5; int8 data, which computes in bf16, over 5 iterations).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alpine_tpu_torch.models.alpine as talpine
from alpine_tpu import ALPINE as JaxALPINE
from alpine_tpu.ops import mu as jmu
from alpine_tpu.ops import pallas_kernels as pk
from alpine_tpu.utils import sampling as jsmp
from alpine_tpu_torch import ALPINE
from alpine_tpu_torch.convert import state_from_numpy
from alpine_tpu_torch.ops import kernels
from alpine_tpu_torch.ops import mu as tmu
from alpine_tpu_torch.utils import sampling as tsmp

from .conftest import make_synthetic_adata
from .test_torch_kernels import _both, _close, _problem, _t
from .test_torch_model import KEYS, KW, _adata, _check_fit_and_transform
from .test_torch_model import jax_draws  # noqa: F401  (fixture)
from .test_torch_model import jax_fit_key
from .test_torch_mu import G, N, _assert_trajectory, _data, _hypers

torch.set_num_threads(1)

EPS = 1e-6


def _jax_tables(ids):
    order, start, sizes = jsmp.balanced_group_tables(ids)
    return order, (jnp.asarray(start), jnp.asarray(sizes))


_MAX_DRAWS = 256  # one split shape: one compile for every draw


def _jax_counts(key, t, n, tables):
    """Draw t of the JAX package's weighted_fast stream over ``key``:
    jax.random.split(key, T)[t] does not depend on T (the installed JAX
    splits partitionably), so the XLA path's T draws and the Pallas path's
    T + 1 are one stream."""
    assert t < _MAX_DRAWS
    it_key = jax.random.split(key, _MAX_DRAWS)[t]
    return np.array(jmu.grouped_balanced_counts(it_key, n, tables, n))


@pytest.fixture
def jax_counts(monkeypatch):
    """The estimator's count stream replaced by the JAX estimator's (its
    fit key is split(PRNGKey(random_state))[1])."""
    def stream(tables, n_cells, random_state, device, restart=0, chunk=None):
        fit_key = jax_fit_key(random_state, restart, chunk)
        jt = tuple(jnp.asarray(t.cpu().numpy()) for t in tables)
        return lambda t: torch.from_numpy(
            _jax_counts(fit_key, t, n_cells, jt)).to(device)

    monkeypatch.setattr(talpine, "draw_counts_stream", stream)


# ---------------------------------------------------------------------------
# K4: the counts mode of fused_iteration
# ---------------------------------------------------------------------------

K4_CASES = [("float32", (3, 4, 6), (2, 3), True),
            ("float32", (3, 9), (2,), False),
            ("int8", (3, 4, 6), (2, 3), True),
            ("int8", (2, 3, 4, 5), (2, 5, 3), False)]


def _k4_problem(dtype, blocks, n_labels, n_real=200):
    """A K4 problem on a cell axis padded to the Pallas tile (its wrapper's
    contract): pad columns are zero and drawn 0 times.  Counts hold zeros,
    ones and counts above 1."""
    K = sum(blocks)
    n = n_real + pk.pad_target(G, n_real, 1, 1 if dtype == "int8" else 4, K,
                               n_labels, cast_itemsize=2 if dtype == "int8"
                               else None, counts_mode=True)
    X, W, H, WtW, Ys, Bs, lam = _problem(11, n, blocks, n_labels, dtype)
    X[:, n_real:] = 0.0
    H[:, n_real:] = 0.0
    for y in Ys:
        y[:, n_real:] = 0.0
    r = np.random.default_rng(12)
    C = r.integers(0, 4, (2, n)).astype(np.float32)
    C[:, n_real:] = 0.0
    assert {0.0, 1.0, 2.0, 3.0} <= set(np.unique(C[:, :n_real]))
    return X, W, H, WtW, Ys, Bs, lam, C


def _run_k4(dtype, blocks, loss_kl, X, W, H, WtW, Ys, Bs, lam, C):
    Xj, Xt = _both(X, dtype)
    want = pk.fused_iteration(
        Xj, jnp.asarray(W), jnp.asarray(H), jnp.asarray(WtW),
        tuple(_both(y, dtype)[0] for y in Ys),
        tuple(jnp.asarray(b) for b in Bs), jnp.asarray(lam), jnp.float32(EPS),
        jnp.asarray(C), blocks=blocks, loss_kl=loss_kl, interpret=True)
    got = kernels.fused_iteration(
        Xt, _t(W), _t(H), _t(WtW), [_both(y, dtype)[1] for y in Ys],
        [_t(b) for b in Bs], _t(lam), EPS, _t(C), blocks=blocks,
        loss_kl=loss_kl)
    return got, want


@pytest.mark.parametrize("dtype,blocks,n_labels,loss_kl", K4_CASES)
def test_fused_iteration_counts_plain_matches_pallas(dtype, blocks, n_labels,
                                                     loss_kl):
    X, W, H, WtW, Ys, Bs, lam, C = _k4_problem(dtype, blocks, n_labels)
    before = dict(kernels.launches)
    got, want = _run_k4(dtype, blocks, loss_kl, X, W, H, WtW, Ys, Bs, lam, C)
    assert len(got) == len(want) == 8
    Hn, XHt, HHt, HHtU, ld, preds, bnums, bdens = got
    _close(Hn, want[0], 1e-5, 1e-6)
    _close(XHt, want[1], 1e-4, 1e-4)
    _close(HHt, want[2], 1e-4, 1e-4)
    _close(HHtU, want[3], 1e-4, 1e-4)
    _close(ld, want[4], 1e-4)
    for c in range(len(n_labels)):
        _close(preds[c], want[5][c], 1e-4)
        _close(bnums[c], want[6][c], 1e-4, 1e-5)
        _close(bdens[c], want[7][c], 1e-4)
    undrawn = C[0] == 0
    np.testing.assert_array_equal(Hn.numpy()[:, undrawn], H[:, undrawn])
    np.testing.assert_array_equal(np.asarray(want[0])[:, undrawn], H[:, undrawn])
    assert kernels.launches == before  # plain runs never count


def test_fused_iteration_counts_rounds_the_scaled_product():
    """int8 X computes in bf16: X (c ⊙ Hn)ᵀ rounds the PRODUCT c·hn to bf16,
    as the Pallas kernel rounds Hs.  One cell, undrawn now (its Hn is its H,
    exactly) and drawn 3 times next, makes XHt a single exact product on
    both sides, so they agree bit for bit — and differ from c·round(hn)."""
    blocks, n_labels = (3, 4, 6), (2, 3)
    X, W, H, WtW, Ys, Bs, lam, C = _k4_problem("int8", blocks, n_labels)
    C[:] = 0.0
    j = 7
    C[1, j] = 3.0
    got, want = _run_k4("int8", blocks, True, X, W, H, WtW, Ys, Bs, lam, C)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    bf16 = lambda v: torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.outer(X[:, j], bf16(3.0 * H[:, j])))
    assert not np.array_equal(got[1].numpy(),
                              np.outer(X[:, j], 3.0 * bf16(H[:, j])))


def test_fused_iteration_counts_refusals_match_pallas():
    X, W, H, WtW, Ys, Bs, lam, C = _k4_problem("float32", (3, 4, 6), (2, 3))
    with pytest.raises(ValueError) as ej:
        pk.fused_iteration(jnp.asarray(X), jnp.asarray(W), jnp.asarray(H),
                           jnp.asarray(WtW), (), (), jnp.asarray(lam),
                           jnp.float32(EPS), jnp.asarray(C), blocks=(13,),
                           loss_kl=True, interpret=True)
    with pytest.raises(ValueError) as et:
        kernels.fused_iteration(_t(X), _t(W), _t(H), _t(WtW), (), (), _t(lam),
                                EPS, _t(C), blocks=(13,), loss_kl=True)
    assert str(et.value) == str(ej.value)
    args = (_t(X), _t(W), _t(H), _t(WtW), [_t(y) for y in Ys],
            [_t(b) for b in Bs], _t(lam), EPS)
    for bad in (_t(C[:1]), _t(C).double(), _t(C.T.copy()).T):
        with pytest.raises(ValueError, match="counts"):
            kernels.fused_iteration(*args, bad, blocks=(3, 4, 6), loss_kl=True)


# ---------------------------------------------------------------------------
# The counts step and the fit loops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loss_kl", [True, False])
def test_counts_step_matches_jax(loss_kl):
    blocks, n_labels = (3, 4, 6), (2, 3)
    X, Ys = _data(3, n_labels, "float32")
    r = np.random.default_rng(4)
    W = r.random((G, 13), dtype=np.float32) + 0.1
    H = r.random((13, N), dtype=np.float32) + 0.1
    Bs = [r.random((nl, k), dtype=np.float32) + 0.1
          for nl, k in zip(n_labels, blocks)]
    c = r.integers(0, 3, N).astype(np.float32)
    jh, th = _hypers([3.0, 1.5], 0.2, 0.4, 0.3, EPS)
    jcfg = jmu.MUConfig(blocks=blocks, n_labels=n_labels, n_cells=N,
                        loss_kl=loss_kl, weighted=True, weighted_counts=True)
    want = jmu.joint_weighted_counts_update(
        jcfg, jh, jnp.asarray(W), tuple(jnp.asarray(b) for b in Bs),
        jnp.asarray(H), jnp.asarray(X), tuple(jnp.asarray(y) for y in Ys),
        jnp.asarray(c))
    tcfg = tmu.MUConfig(blocks=blocks, n_labels=n_labels, n_cells=N,
                        loss_kl=loss_kl, weighted_counts=True)
    Xt = _t(X)
    got = tmu.joint_weighted_counts_update(
        tcfg, th, _t(W), [_t(b) for b in Bs], _t(H), Xt, Xt,
        [_t(y) for y in Ys], _t(c))
    for a, b in ((got[0], want[0]), (got[2], want[2]), (got[3][0], want[3][0]),
                 (got[3][1], want[3][1])):
        _close(a, b, 1e-5, 1e-7)
    for a, b in zip(got[1], want[1]):
        _close(a, b, 1e-5, 1e-7)
    undrawn = c == 0
    np.testing.assert_array_equal(got[2].numpy()[:, undrawn], H[:, undrawn])


@pytest.mark.parametrize("dtype,loss_kl,iters", [
    ("float32", True, 20), ("float32", False, 20), ("int8", True, 5)])
def test_weighted_fit_scan_matches_jax(dtype, loss_kl, iters):
    """Both port loops against both JAX counts paths from one init and one
    count stream, on a group-sorted cell axis."""
    blocks, n_labels, lam = (3, 4, 6), (2, 3), [3.0, 1.5]
    X, Ys = _data(5, n_labels, dtype)
    order, tables = _jax_tables(jsmp.joint_label_ids(Ys))
    X, Ys = X[:, order], [y[:, order] for y in Ys]
    jh, th = _hypers(lam, 0.2, 0.4, 0.3, EPS)
    key = jax.random.PRNGKey(8)
    init = jmu.init_matrices(jmu.MUConfig(blocks=blocks, n_labels=n_labels,
                                          n_cells=N), G, key, EPS)
    refs = {}
    for backend in ("xla", "pallas_interpret"):
        cfg = jmu.MUConfig(blocks=blocks, n_labels=n_labels, n_cells=N,
                           loss_kl=loss_kl, max_iter=iters, x_dtype=dtype,
                           backend=backend, weighted=True,
                           weighted_counts=True)
        out = jmu.fit_scan(cfg, *init, jnp.asarray(X).astype(cfg.xdt),
                           tuple(jnp.asarray(y) for y in Ys), jh, key, tables)
        refs[backend] = (np.asarray(out[0]), np.asarray(out[1]),
                         [np.asarray(b) for b in out[2]], np.asarray(out[3]))
    draws = []

    def draw_counts(t):
        draws.append(t)
        return torch.from_numpy(_jax_counts(key, t, N, tables))

    Xt = torch.from_numpy(X).to(torch.int8 if dtype == "int8" else torch.float32)
    for backend in ("fused", "plain"):
        cfg = tmu.MUConfig(blocks=blocks, n_labels=n_labels, n_cells=N,
                           loss_kl=loss_kl, max_iter=iters, x_dtype=dtype,
                           backend=backend, weighted_counts=True)
        W0, H0, Bs0 = state_from_numpy(*[np.asarray(a) if not isinstance(a, tuple)
                                         else [np.asarray(b) for b in a]
                                         for a in init], device="cpu")
        draws.clear()
        W, H, Bs, L = tmu.fit_scan(cfg, W0, H0, Bs0, Xt,
                                   [torch.from_numpy(y) for y in Ys], th,
                                   draw_counts=draw_counts)
        # the fused loop also draws the statistics of the step after the last
        assert draws == list(range(iters + (backend == "fused")))
        port = (W.numpy(), H.numpy(), [b.numpy() for b in Bs], L.numpy())
        for ref in refs.values():
            _assert_trajectory(port, ref)


def test_weighted_counts_needs_covariates_and_draws():
    cfg = tmu.MUConfig(blocks=(3,), n_labels=(), n_cells=N,
                       weighted_counts=True)
    X, _ = _data(0, (), "float32")
    W0, H0 = torch.rand(G, 3), torch.rand(3, N)
    with pytest.raises(ValueError, match="covariates"):
        tmu.fit_scan(cfg, W0, H0, (), _t(X), [], _hypers([], 0, 0, 0, EPS)[1],
                     draw_counts=lambda t: torch.ones(N))


# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------


def _fit_both(ad, max_iter, **kw):
    jm = JaxALPINE(device="cpu", **KW, **kw)
    tm = ALPINE(device="cpu", **KW, **kw)
    ad_j, ad_t = ad.copy(), ad.copy()
    jm.fit(ad_j, KEYS, max_iter=max_iter, sampling_method="weighted_fast")
    tm.fit(ad_t, KEYS, max_iter=max_iter, sampling_method="weighted_fast")
    return jm, tm, ad_j, ad_t


def test_weighted_fast_int8_matches_jax(jax_draws, jax_counts):
    jm, tm, ad_j, ad_t = _fit_both(_adata(integer=True), max_iter=5)
    assert tm.data_dtype_ == "int8"
    _check_fit_and_transform(jm, tm, ad_j, ad_t)


@pytest.mark.parametrize("loss_type", ["kl-divergence", "frobenius"])
def test_weighted_fast_matches_jax(jax_draws, jax_counts, loss_type):
    """Float data over 30 iterations; the transform of the same data runs
    through both estimators' device-X caches (group-sorted X)."""
    jm, tm, ad_j, ad_t = _fit_both(_adata(integer=False), max_iter=30,
                                   loss_type=loss_type, orth_W=0.1)
    assert tm._x_cache is not None and tm._x_cache[3] is not None
    np.testing.assert_array_equal(tm._x_cache[3], jm._x_cache[4])
    _check_fit_and_transform(jm, tm, ad_j, ad_t)


def test_weighted_fast_elbow_matches_jax(jax_draws, jax_counts):
    """max_iter=None: the 200-iteration warm-up and the fit at the elbow
    both start the count stream from draw 0, as the JAX estimator's reuse
    of its fit key does."""
    jm, tm, ad_j, ad_t = _fit_both(_adata(integer=False, seed=1), max_iter=None)
    assert 0 < tm.max_iter < 200
    _check_fit_and_transform(jm, tm, ad_j, ad_t)


def _wf_model(**kw):
    return ALPINE(n_components=6, n_covariate_components=[2, 3],
                  lam=[1.0, 1.0], device="cpu", random_state=0, **kw)


def test_weighted_fast_is_seed_deterministic_and_undoes_the_sort():
    """Two fits from one seed give the same bits; another seed another
    trajectory; and a cell with an extreme profile keeps the largest H
    column in caller order (the group sort is undone on extraction, as
    tests/test_weighted_counts.py checks for the JAX package)."""
    adata = make_synthetic_adata(n_cells=120, n_genes=20, seed=6)
    fits = []
    for seed in (0, 0, 1):
        m = ALPINE(n_components=6, n_covariate_components=[2, 3],
                   lam=[1.0, 1.0], device="cpu", random_state=seed)
        m.fit(adata.copy(), KEYS, max_iter=25, sampling_method="weighted_fast")
        fits.append(m)
    np.testing.assert_array_equal(fits[0].matrices["Hs"][-1],
                                  fits[1].matrices["Hs"][-1])
    np.testing.assert_array_equal(fits[0].loss_history_, fits[1].loss_history_)
    assert not np.array_equal(fits[0].loss_history_, fits[2].loss_history_)
    L = fits[0].loss_history_[:, 0]
    assert np.isfinite(L).all() and L[-1] < L[0]

    marked = 17
    X = np.asarray(adata.X).copy()
    X[marked] += 40.0
    adata.X = X
    mm = _wf_model()
    mm.fit(adata, KEYS, max_iter=25, sampling_method="weighted_fast")
    norms = np.linalg.norm(np.concatenate(mm.matrices["Hs"], axis=0), axis=0)
    assert norms.argmax() == marked


def test_weighted_fast_transform_cache_matches_uncached(monkeypatch):
    """A same-data transform reuses the group-sorted device X, re-pairs H0
    with it and un-sorts the result: the same embedding as the uncached
    transform.  A wrong un-sort would misassign whole cells."""
    adata = make_synthetic_adata(n_cells=200, n_genes=24, seed=3)
    m = _wf_model()
    m.fit(adata, KEYS, max_iter=10, sampling_method="weighted_fast")
    assert m._x_cache is not None and m._x_cache[3] is not None
    assert m._x_cache[0].dtype == torch.float32  # fractional data
    assert pickle.loads(pickle.dumps(m))._x_cache is None
    assert m._x_cache is not None  # pickling leaves the model's cache

    ad_hit = adata.copy()
    m.transform(ad_hit)
    m.free_device_cache()
    assert m._x_cache is None
    ad_miss = adata.copy()
    m.transform(ad_miss)
    for key in ["ALPINE_embedding"] + KEYS:
        np.testing.assert_allclose(ad_hit.obsm[key], ad_miss.obsm[key],
                                   rtol=1e-5, atol=1e-7)
    hit, miss = ad_hit.obsm["ALPINE_embedding"], ad_miss.obsm["ALPINE_embedding"]
    perm = np.random.default_rng(1).permutation(hit.shape[0])
    assert not np.allclose(hit, miss[perm], rtol=1e-2)

    # the JAX package's switch turns the cache off
    monkeypatch.setenv("ALPINE_TPU_NO_X_CACHE", "1")
    m.fit(adata, KEYS, max_iter=3, sampling_method="weighted_fast")
    assert m._x_cache is None
    monkeypatch.setenv("ALPINE_TPU_NO_X_CACHE", "0")
    m.fit(adata, KEYS, max_iter=3)
    assert m._x_cache is not None and m._x_cache[3] is None


def test_x_fingerprint_matches_jax():
    import scipy.sparse as sp

    r = np.random.default_rng(2)
    dense = r.poisson(1.0, (50, 30)).astype(np.float32)
    for X in (dense, sp.csr_matrix(dense), sp.csc_matrix(dense)):
        assert ALPINE._x_fingerprint(X) == JaxALPINE._x_fingerprint(X)
    swapped = dense[[1, 0] + list(range(2, 50))]
    assert ALPINE._x_fingerprint(swapped) != ALPINE._x_fingerprint(dense)


@pytest.mark.parametrize("case", ["no-covariates", "als", "sub-covering"])
def test_weighted_fast_errors_match_jax(case):
    ad = _adata(integer=True)
    ctor, keys, fit_kw = dict(KW), KEYS, {}
    if case == "no-covariates":
        ctor.update(n_covariate_components=[], lam=[])
        keys = []
    elif case == "als":
        ctor["use_als"] = True
    else:
        fit_kw = dict(batch_size=ad.n_obs - 1)
    with pytest.raises(ValueError) as ej:
        JaxALPINE(device="cpu", **ctor).fit(
            ad.copy(), keys, max_iter=2, sampling_method="weighted_fast",
            **fit_kw)
    with pytest.raises(ValueError) as et:
        ALPINE(device="cpu", **ctor).fit(
            ad.copy(), keys, max_iter=2, sampling_method="weighted_fast",
            **fit_kw)
    assert str(et.value) == str(ej.value)


def test_weighted_fast_covering_batch_size_is_full_epoch():
    ad = _adata(integer=True)
    runs = []
    for bs in (None, ad.n_obs, ad.n_obs + 7):
        m = ALPINE(device="cpu", **KW)
        m.fit(ad.copy(), KEYS, max_iter=3, batch_size=bs,
              sampling_method="weighted_fast")
        runs.append(m.loss_history_)
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[0], runs[2])


# ---------------------------------------------------------------------------
# The sampler and its tables
# ---------------------------------------------------------------------------


def _rare_group_ids(n=300, seed=0):
    r = np.random.default_rng(seed)
    ids = r.integers(0, 4, n)
    ids[:5] = 4  # one rare group: 5 cells in 300
    return ids


def test_group_tables_match_jax():
    r = np.random.default_rng(3)
    Ys = []
    for nl in (2, 3, 4):
        y = np.zeros((nl, 200), np.float32)
        y[r.integers(0, nl, 200), np.arange(200)] = 1.0
        Ys.append(y)
    Ys[0][:, :3] = 0.0  # cells with a missing label take argmax 0
    ids = tsmp.joint_label_ids(Ys)
    np.testing.assert_array_equal(ids, jsmp.joint_label_ids(Ys))
    for cand in (ids, _rare_group_ids()):
        for a, b in zip(tsmp.balanced_group_tables(cand),
                        jsmp.balanced_group_tables(cand)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        np.testing.assert_array_equal(tsmp.balanced_sample_probabilities(cand),
                                      jsmp.balanced_sample_probabilities(cand))
    big = np.asarray([3, 2 ** 24])
    with pytest.raises(ValueError) as ej:
        jsmp.check_group_sizes(big)
    with pytest.raises(ValueError) as et:
        tsmp.check_group_sizes(big)
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="at least one"):
        tsmp.joint_label_ids([])


def _port_tables(ids):
    order, start, sizes = tsmp.balanced_group_tables(ids)
    return order, (torch.from_numpy(start), torch.from_numpy(sizes))


def test_grouped_balanced_counts_draw():
    ids = _rare_group_ids()
    n = len(ids)
    order, tables = _port_tables(ids)
    gen = torch.Generator().manual_seed(5)
    c = tmu.grouped_balanced_counts(gen, n, tables)
    assert c.dtype == torch.float32 and c.shape == (n,)  # no draw past n
    assert float(c.sum()) == n
    assert {0.0, 1.0} <= set(c.unique().tolist()) and float(c.max()) > 1
    again = tmu.grouped_balanced_counts(torch.Generator().manual_seed(5), n,
                                        tables)
    assert torch.equal(c, again)
    other = tmu.grouped_balanced_counts(torch.Generator().manual_seed(6), n,
                                        tables)
    assert not torch.equal(c, other)


def test_grouped_balanced_counts_distribution():
    """The draw is the balanced distribution: over 200 epochs each cell's
    mean count lies within 5 standard errors of n·w_i, w the balanced
    probabilities (a shorter form of the JAX package's test)."""
    ids = _rare_group_ids()
    n = len(ids)
    order, tables = _port_tables(ids)
    gen = torch.Generator().manual_seed(0)
    reps = 200
    total = torch.zeros(n, dtype=torch.float64)
    for _ in range(reps):
        total += tmu.grouped_balanced_counts(gen, n, tables)
    mean = total.numpy() / reps
    w = tsmp.balanced_sample_probabilities(ids)[order].astype(np.float64)
    se = np.sqrt(n * w / reps)
    assert (np.abs(mean - n * w) < 5 * se + 0.2).all()
    # the five rare cells carry a whole group's mass between them
    rare = np.isin(order, np.flatnonzero(ids == 4))
    assert abs(mean[rare].sum() - n / 5) < 5 * np.sqrt(n / 5 / reps) + 1


def test_draw_counts_stream_depends_on_t_alone():
    ids = _rare_group_ids()
    _, tables = _port_tables(ids)
    draw = talpine.draw_counts_stream(tables, len(ids), 42, torch.device("cpu"))
    late = [draw(3), draw(1)]
    fresh = talpine.draw_counts_stream(tables, len(ids), 42, torch.device("cpu"))
    assert torch.equal(fresh(1), late[1]) and torch.equal(fresh(3), late[0])
    assert not torch.equal(late[0], late[1])
    other = talpine.draw_counts_stream(tables, len(ids), 43, torch.device("cpu"))
    assert not torch.equal(other(1), late[1])

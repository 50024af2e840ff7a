"""Random-minibatch and gathered weighted fits of the port against the JAX
package, on the CPU at small shapes.

- ``mu.fit_scan`` with ``batch_size`` < n_cells or ``weighted=True``, both
  backends (the fused one runs the kernels' plain versions here), against
  JAX ``mu.fit_scan`` (xla) from the same ``init_matrices`` draw and JAX's
  own epoch streams (``jax.random.permutation`` / ``jax.random.choice``
  over ``jax.random.split(key, max_iter)``): joint and ALS, KL and
  Frobenius, float32 and int8 X, a short last batch, weighted draws.
  Tolerances as tests/test_torch_mu.py's: loss rtol 5e-4, factors rtol
  5e-3 atol 1e-5; int8 (bf16 compute, chaotic at the last bit) over 5
  epochs.  The port cuts a short last batch where the JAX package
  zero-fills it to the batch size: the fill adds nothing to any sum, so
  the two agree up to summation order.
- The minibatch loop in float64 against tests/oracle.py's steps on the
  same gathered batches (rtol 1e-11), duplicates in a batch included.
- The fused backend against the plain one.
- The estimator against ``alpine_tpu.ALPINE`` fed the JAX streams, and
  tests/test_model_api.py::test_minibatch_and_weighted_fit.  Its int8 case
  runs 3 epochs of 4 batches: int8 ALS minibatch trajectories grow a
  last-bit difference fast.  On the CPU (batch 40, 150 cells) one ulp added
  to one element of W0 moves the JAX package's own recon loss by 1.8e-5
  after 5 epochs and 1.0e-2 after 8, and the port and JAX differ by 1.8e-5
  after 3 epochs, 8.4e-4 after 5 (over the 5e-4 tolerance) and 1.8e-2
  after 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alpine_tpu_torch.models.alpine as talpine
from alpine_tpu import ALPINE as JaxALPINE
from alpine_tpu.ops import mu as jmu
from alpine_tpu.utils import sampling as jsmp
from alpine_tpu_torch import ALPINE
from alpine_tpu_torch.convert import state_from_numpy
from alpine_tpu_torch.ops import kernels
from alpine_tpu_torch.ops import mu as tmu
from alpine_tpu_torch.utils import sampling as tsmp

from .conftest import make_synthetic_adata
from .oracle import (_cat_h, _cat_w, _split_h, _split_w, oracle_als_step,
                     oracle_joint_step)
from .test_torch_model import KEYS, KW, _adata, _check_fit_and_transform
from .test_torch_model import jax_draws  # noqa: F401  (fixture)
from .test_torch_model import jax_fit_key
from .test_torch_mu import G, N, _TORCH, _data, _hypers

torch.set_num_threads(1)

EPS = 1e-6
_MAX_EPOCHS = 256  # one split shape: split(key, T)[t] does not depend on T


def _jax_cells(key, t, n, probs=None):
    """Epoch t's cell indices as the JAX package's minibatch branch draws
    them (alpine_tpu/ops/mu.py:900-905)."""
    assert t < _MAX_EPOCHS
    it_key = jax.random.split(key, _MAX_EPOCHS)[t]
    if probs is None:
        idx = jax.random.permutation(it_key, n)
    else:
        idx = jax.random.choice(it_key, n, shape=(n,), replace=True,
                                p=jnp.asarray(probs))
    return np.array(idx, dtype=np.int64)


# (use_als, n_cov, loss_kl, dtype, batch_size, weighted)
CASES = [
    (False, 2, True, "float32", 64, False),   # 4 batches of 64 + one of 44
    (False, 2, False, "float32", 100, False),
    (False, 0, True, "float32", 64, False),
    (True, 2, True, "float32", 64, False),
    (True, 2, False, "float32", 100, False),
    (False, 2, True, "int8", 64, False),
    (True, 2, True, "int8", 128, False),
    (False, 2, True, "float32", 64, True),
    (False, 2, False, "int8", 128, True),
    (True, 2, True, "float32", None, True),   # one batch of N draws
]


def _case_id(c):
    als, n_cov, kl, dt, bs, w = c
    return (f"{'als' if als else 'joint'}-cov{n_cov}-{'kl' if kl else 'fro'}-"
            f"{dt}-bs{bs}{'-weighted' if w else ''}")


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_minibatch_fit_scan_matches_jax(case):
    use_als, n_cov, loss_kl, dtype, bs, weighted = case
    if n_cov:
        blocks, n_labels, lam = (3, 4, 6), (2, 3), [3.0, 1.5]
    else:
        blocks, n_labels, lam = (6,), (), []
    iters = 12 if dtype == "float32" else 5
    X, Ys = _data(4, n_labels, dtype)
    jh, th = _hypers(lam, 0.2, 0.4, 0.3, EPS)
    key = jax.random.PRNGKey(5)
    probs = (jsmp.balanced_sample_probabilities(jsmp.joint_label_ids(Ys))
             if weighted else None)
    jcfg = jmu.MUConfig(blocks=blocks, n_labels=n_labels, n_cells=N,
                        loss_kl=loss_kl, use_als=use_als, batch_size=bs,
                        weighted=weighted, max_iter=iters, x_dtype=dtype,
                        backend="xla")
    assert not jcfg.full_batch
    W0, H0, Bs0 = jmu.init_matrices(jcfg, G, key, EPS)
    ref = jmu.fit_scan(jcfg, W0, H0, Bs0, jnp.asarray(X).astype(jcfg.xdt),
                       tuple(jnp.asarray(y) for y in Ys), jh, key,
                       None if probs is None else jnp.asarray(probs))
    Wr, Hr, Bsr, Lr = (np.asarray(ref[0]), np.asarray(ref[1]),
                       [np.asarray(b) for b in ref[2]], np.asarray(ref[3]))
    # the streams JAX's scan used: split(key, iters)[t]
    assert np.array_equal(_jax_cells(key, 1, N, probs), np.asarray(
        jax.random.permutation(jax.random.split(key, iters)[1], N)) if probs is None
        else _jax_cells(key, 1, N, probs))
    out = {}
    for backend in ("fused", "plain"):
        cfg = tmu.MUConfig(blocks=blocks, n_labels=n_labels, n_cells=N,
                           loss_kl=loss_kl, max_iter=iters, x_dtype=dtype,
                           backend=backend, use_als=use_als, batch_size=bs,
                           weighted=weighted)
        assert cfg.minibatch and cfg.eff_batch_size == (bs or N)
        W0t, H0t, Bs0t = state_from_numpy(np.asarray(W0), np.asarray(H0),
                                          [np.asarray(b) for b in Bs0], "cpu")
        H0_before = H0t.clone()
        kernels.reset_launches()
        W, H, Bs, L = tmu.fit_scan(
            cfg, W0t, H0t, Bs0t, torch.from_numpy(X).to(_TORCH[dtype]),
            [torch.from_numpy(y) for y in Ys], th,
            draw_cells=lambda t: torch.from_numpy(_jax_cells(key, t, N, probs)))
        assert torch.equal(H0t, H0_before)  # the caller's H0 is not written
        assert sum(kernels.launches.values()) == 0  # plain versions on the CPU
        L = L.numpy()
        assert np.isfinite(L).all() and L.shape == (iters, 2 + n_cov)
        np.testing.assert_allclose(L, Lr, rtol=5e-4)
        np.testing.assert_allclose(W.numpy(), Wr, rtol=5e-3, atol=1e-5)
        np.testing.assert_allclose(H.numpy(), Hr, rtol=5e-3, atol=1e-5)
        for b, br in zip(Bs, Bsr):
            np.testing.assert_allclose(b.numpy(), br, rtol=5e-3, atol=1e-5)
        out[backend] = (W, H, L)
    # the fused backend (the kernels' plain versions) against the plain one
    for a, b in zip(out["fused"], out["plain"]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("use_als", [False, True], ids=["joint", "als"])
@pytest.mark.parametrize("loss_kl", [True, False], ids=["kl", "fro"])
def test_minibatch_loop_f64_matches_oracle(use_als, loss_kl):
    """The minibatch loop in float64 (plain backend) against the oracle's
    steps on the same gathered batches: 7 batches of 6 cells and a short
    one of 3, over epochs of with-replacement draws (duplicates in a
    batch) and a permutation."""
    blocks, n_labels, g, n, bs = (3, 4, 6), (2, 3), 20, 45, 6
    r = np.random.default_rng(0)
    X = r.random((g, n)) * 2
    Ys = []
    for nl in n_labels:
        y = np.zeros((nl, n))
        y[r.integers(0, nl, n), np.arange(n)] = 1.0
        Ys.append(y)
    Ws = [r.random((g, k)) + 0.1 for k in blocks]
    Hs = [r.random((k, n)) + 0.1 for k in blocks]
    Bs = [r.random((nl, k)) + 0.1 for nl, k in zip(n_labels, blocks)]
    lam, orth, alpha, l1 = [2.0, 0.5], 0.3, 0.7, 0.4
    draws = [r.integers(0, n, n), r.permutation(n), r.integers(0, n, n)]
    assert any(len(set(d[lo:lo + bs])) < len(d[lo:lo + bs])
               for d in draws[::2] for lo in range(0, n, bs))
    cfg = tmu.MUConfig(blocks=blocks, n_labels=n_labels, n_cells=n,
                       loss_kl=loss_kl, use_als=use_als, backend="plain",
                       batch_size=bs, max_iter=len(draws))
    hyper = (torch.tensor(lam, dtype=torch.float64), orth, alpha, l1, EPS)
    t = torch.from_numpy
    W, H, Bs_t, L = tmu._fit_scan_steps(
        cfg, t(_cat_w(Ws)), t(_cat_h(Hs)), tuple(t(b) for b in Bs), t(X),
        [t(y) for y in Ys], hyper, None, lambda e: t(draws[e]), None)
    step = oracle_als_step if use_als else oracle_joint_step
    oW, oH = _cat_w(Ws), _cat_h(Hs)
    oBs = Bs
    for d in draws:
        for lo in range(0, n, bs):
            b = d[lo:lo + bs]
            oWs, oHs_b, oBs = step(_split_w(oW, blocks), _split_h(oH[:, b], blocks),
                                   oBs, X[:, b], [y[:, b] for y in Ys], lam, orth,
                                   alpha, l1, EPS, loss_kl)
            oW = _cat_w(oWs)
            oH[:, b] = _cat_h(oHs_b)
    assert W.dtype == torch.float64
    np.testing.assert_allclose(W.numpy(), oW, rtol=1e-11)
    np.testing.assert_allclose(H.numpy(), oH, rtol=1e-11)
    for b, ob in zip(Bs_t, oBs):
        np.testing.assert_allclose(b.numpy(), ob, rtol=1e-11)
    assert np.isfinite(L.numpy()).all()


def test_minibatch_config_and_refusals():
    cfg = tmu.MUConfig(blocks=(2, 3), n_labels=(2,), n_cells=N, batch_size=64)
    assert cfg.minibatch and cfg.eff_batch_size == 64
    covering = tmu.MUConfig(blocks=(2, 3), n_labels=(2,), n_cells=N,
                            batch_size=N)
    assert not covering.minibatch
    one = tmu.MUConfig(blocks=(2, 3), n_labels=(2,), n_cells=N, weighted=True)
    assert one.minibatch and one.eff_batch_size == N
    with pytest.raises(ValueError, match="batch_size"):
        tmu.MUConfig(blocks=(2, 3), n_labels=(2,), n_cells=N, batch_size=0)
    X, Ys = _data(0, (2,), "float32")
    W0, H0, Bs0 = state_from_numpy(np.ones((G, 5), np.float32),
                                   np.ones((5, N), np.float32),
                                   [np.ones((2, 2), np.float32)], "cpu")
    hyper = (torch.ones(1), 0.0, 0.0, 0.0, EPS)
    args = (W0, H0, Bs0, torch.from_numpy(X), [torch.from_numpy(Ys[0])], hyper)
    with pytest.raises(ValueError, match="draw_cells"):
        tmu.fit_scan(cfg, *args)
    both = tmu.MUConfig(blocks=(2, 3), n_labels=(2,), n_cells=N, batch_size=64,
                        weighted_counts=True)
    with pytest.raises(ValueError, match="full-epoch"):
        tmu.fit_scan(both, *args, draw_counts=lambda t: torch.ones(N),
                     draw_cells=lambda t: torch.arange(N))


@pytest.mark.parametrize("use_als", [False, True], ids=["joint", "als"])
@pytest.mark.parametrize("bs", [64, N, None], ids=["short-last", "one", "full"])
def test_epoch_is_cut_into_batches(monkeypatch, use_als, bs):
    """An epoch runs ceil(n / bs) steps on batches of bs cells with a short
    last one, in the order of the epoch's draw; a full-batch fit runs one
    step an iteration on all of X."""
    name = "als_batch_update" if use_als else "joint_batch_update"
    real, widths = getattr(tmu, name), []

    def spy(cfg, hyper, W, Bs, H, X, *rest):
        widths.append(X.shape[1])
        return real(cfg, hyper, W, Bs, H, X, *rest)

    monkeypatch.setattr(tmu, name, spy)
    X, Ys = _data(0, (2,), "float32")
    cfg = tmu.MUConfig(blocks=(2, 3), n_labels=(2,), n_cells=N, max_iter=2,
                       use_als=use_als, batch_size=bs, weighted=bs == N,
                       backend="plain")
    r = np.random.default_rng(1)
    W0, H0, Bs0 = state_from_numpy(r.random((G, 5), np.float32) + 0.1,
                                   r.random((5, N), np.float32) + 0.1,
                                   [r.random((2, 2), np.float32) + 0.1], "cpu")
    hyper = (torch.ones(1), 0.0, 0.0, 0.0, EPS)
    tmu.fit_scan(cfg, W0, H0, Bs0, torch.from_numpy(X),
                 [torch.from_numpy(Ys[0])], hyper,
                 draw_cells=lambda t: torch.randperm(N))
    size = bs or N
    epoch = [size] * (N // size) + ([N % size] if N % size else [])
    assert widths == 2 * epoch


def test_cell_stream():
    """The estimator's cell draws: a permutation an epoch, or n draws with
    replacement that follow the balanced probabilities; each epoch's draw
    depends on (random_state, epoch) alone."""
    n = 500
    perm = talpine.draw_cells_stream(n, 3, torch.device("cpu"))
    p0 = perm(0)
    assert p0.dtype == torch.int64
    assert torch.equal(torch.sort(p0).values, torch.arange(n))
    assert torch.equal(perm(0), p0) and not torch.equal(perm(1), p0)
    assert torch.equal(talpine.draw_cells_stream(n, 3, torch.device("cpu"))(1), perm(1))
    assert not torch.equal(talpine.draw_cells_stream(n, 4, torch.device("cpu"))(0), p0)
    ids = np.repeat([0, 1, 2], [400, 80, 20])
    probs = tsmp.balanced_sample_probabilities(ids)
    draw = talpine.draw_cells_stream(n, 3, torch.device("cpu"), probs)
    idx = torch.cat([draw(t) for t in range(40)]).numpy()
    assert idx.min() >= 0 and idx.max() < n
    share = np.bincount(ids[idx], minlength=3) / len(idx)
    np.testing.assert_allclose(share, 1 / 3, atol=0.02)  # balanced groups


# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_cells(monkeypatch):
    """The estimator's cell stream replaced by the JAX estimator's (its fit
    key is split(PRNGKey(random_state))[1]; ``jax_fit_key`` for a restart or
    a checkpoint chunk)."""
    def stream(n_cells, random_state, device, probs=None, restart=0, chunk=None):
        fit_key = jax_fit_key(random_state, restart, chunk)
        return lambda t: torch.from_numpy(
            _jax_cells(fit_key, t, n_cells, probs)).to(device)

    monkeypatch.setattr(talpine, "draw_cells_stream", stream)


@pytest.mark.parametrize("kw,integer,max_iter", [
    (dict(batch_size=40), False, 15),
    (dict(batch_size=64, sampling_method="weighted"), False, 15),
    (dict(sampling_method="weighted"), False, 10),
    (dict(batch_size=40), True, 3),
], ids=["random", "weighted", "weighted-one-batch", "random-int8"])
@pytest.mark.parametrize("use_als", [False, True], ids=["joint", "als"])
def test_minibatch_estimator_matches_jax(jax_draws, jax_cells, kw, integer,
                                         max_iter, use_als):
    ad = _adata(integer=integer)
    jm = JaxALPINE(device="cpu", use_als=use_als, **KW)
    tm = ALPINE(device="cpu", use_als=use_als, **KW)
    ad_j, ad_t = ad.copy(), ad.copy()
    jm.fit(ad_j, KEYS, max_iter=max_iter, **kw)
    tm.fit(ad_t, KEYS, max_iter=max_iter, **kw)
    assert tm.batch_size == jm.batch_size
    assert tm.sampling_method == jm.sampling_method
    _check_fit_and_transform(jm, tm, ad_j, ad_t)


def test_minibatch_and_weighted_fit():
    """tests/test_model_api.py::test_minibatch_and_weighted_fit on the
    port, with the port's own streams."""
    ad = make_synthetic_adata()
    model = ALPINE(n_components=6, n_covariate_components=[2, 3],
                   lam=[5.0, 2.0], device="cpu", random_state=0)
    model.fit(ad, ["batch", "condition"], max_iter=8, batch_size=32)
    assert len(model.loss_history) == 8
    model2 = ALPINE(n_components=6, n_covariate_components=[2, 3],
                    lam=[5.0, 2.0], device="cpu", random_state=0)
    model2.fit(ad, ["batch", "condition"], max_iter=8, batch_size=32,
               sampling_method="weighted")
    assert np.isfinite(model2.loss_history.values).all()
    assert ad.obsm["ALPINE_embedding"].shape == (ad.n_obs, 6)
    # the device X is kept for a same-data transform
    assert model2._x_cache is not None and model2._x_cache[3] is None
    model2.transform(ad)
    assert np.isfinite(ad.obsm["ALPINE_embedding"]).all()

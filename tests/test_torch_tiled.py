"""Tiled sampling in the port (``sampling_method="tiled"``, ``MUConfig.tile``)
against the JAX package on the CPU, from the same numpy inputs
(tests/test_tiled.py's anchors on the port's step loop):

- ``mu.fit_scan`` with ``tile`` against JAX ``mu.fit_scan`` (xla) from the
  same init and JAX's own tile permutations, both port backends (the fused
  one runs the kernels' plain versions here), float32 and int8 X, KL and
  Frobenius, a cell axis padded to a tile multiple; a short last batch
  (JAX zero-fills it, the port cuts it short);
- tile = 1 on an unpadded cell axis is the per-cell minibatch path, bit
  for bit;
- a single batch covering every tile is the full-batch step on a column
  permutation of X;
- the float64 loop against tests/oracle.py's steps on the same tiles
  (rtol 1e-11); the pad's columns of H stay exactly zero and the pad's KL
  constant never reaches the loss;
- the estimator against ``alpine_tpu.ALPINE`` fed the JAX streams (its
  seeded numpy pre-shuffle is drawn identically), H back in the caller's
  cell order, the cached transform against the uncached one, and the
  reference's refusals.

Tolerances as tests/test_torch_mu.py's: loss rtol 5e-4, factors rtol 5e-3
atol 1e-5; int8 (bf16 compute, chaotic at the last bit) over 4 epochs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alpine_tpu_torch.models.alpine as talpine
from alpine_tpu import ALPINE as JaxALPINE
from alpine_tpu.ops import mu as jmu
from alpine_tpu_torch import ALPINE
from alpine_tpu_torch.convert import state_from_numpy
from alpine_tpu_torch.ops import mu as tmu

from .conftest import make_synthetic_adata
from .oracle import _cat_h, _cat_w, _split_h, _split_w, oracle_joint_step
from .test_torch_model import KEYS, KW, _check_fit_and_transform
from .test_torch_model import jax_draws  # noqa: F401  (fixture)
from .test_torch_model import jax_fit_key
from .test_torch_mu import _hypers

torch.set_num_threads(1)

BLOCKS, N_LABELS, G = (3, 4, 6), (2, 3), 25
EPS = 1e-6
_MAX_EPOCHS = 256  # one split shape: split(key, T)[t] does not depend on T


def _jax_tiles(key, t, n_tiles):
    """Epoch t's tile permutation as the JAX package's ``_tiled_epoch``
    draws it (alpine_tpu/ops/mu.py:770-802)."""
    assert t < _MAX_EPOCHS
    it_key = jax.random.split(key, _MAX_EPOCHS)[t]
    return np.array(jax.random.permutation(it_key, n_tiles), dtype=np.int64)


@pytest.fixture
def jax_tiles(monkeypatch):
    """The estimator's tile stream replaced by the JAX estimator's."""
    def stream(n_tiles, random_state, device, restart=0, chunk=None):
        key = jax_fit_key(random_state, restart, chunk)
        return lambda t: torch.from_numpy(_jax_tiles(key, t, n_tiles)).to(device)

    monkeypatch.setattr(talpine, "draw_tiles_stream", stream)


def _problem(seed, n, dtype="float32", t=8):
    """X (genes × n) padded with zero columns to a multiple of t, Ys
    likewise, and an init of n cells."""
    r = np.random.default_rng(seed)
    if dtype == "int8":
        X = r.poisson(3.0, (G, n)).clip(0, 127).astype(np.float32)
    else:
        X = (r.random((G, n)).astype(np.float32) * 3).round(3)
    Ys = []
    for nl in N_LABELS:
        y = np.zeros((nl, n), np.float32)
        y[r.integers(0, nl, n), np.arange(n)] = 1.0
        Ys.append(y)
    W = r.random((G, sum(BLOCKS))).astype(np.float32) + 0.1
    H = r.random((sum(BLOCKS), n)).astype(np.float32) + 0.1
    Bs = [r.random((nl, k)).astype(np.float32) + 0.1
          for nl, k in zip(N_LABELS, BLOCKS)]
    pad = (-n) % t
    Xp = np.pad(X, ((0, 0), (0, pad)))
    Ysp = [np.pad(y, ((0, 0), (0, pad))) for y in Ys]
    return Xp, Ysp, (W, H, Bs)


# (n, batch_size, tile, loss_kl, dtype, epochs)
CASES = [
    (37, 16, 8, True, "float32", 10),   # 3 pad columns; batches 2, 2, 1 tiles
    (40, 16, 8, False, "float32", 10),
    (37, 16, 8, True, "int8", 4),
    (48, 47, 8, True, "float32", 6),    # one batch covers every tile
]


@pytest.mark.parametrize("backend", ["fused", "plain"])
@pytest.mark.parametrize("case", CASES, ids=[
    f"n{c[0]}-bs{c[1]}-{'kl' if c[3] else 'fro'}-{c[4]}" for c in CASES])
def test_tiled_fit_scan_matches_jax(case, backend):
    n, bs, t, loss_kl, dtype, epochs = case
    Xp, Ysp, (W0, H0, Bs0) = _problem(2, n, dtype, t)
    jh, th = _hypers([1.0, 2.0], 0.2, 0.1, 0.5, EPS)
    key = jax.random.PRNGKey(11)
    jcfg = jmu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n,
                        loss_kl=loss_kl, batch_size=bs, tile=t,
                        max_iter=epochs, x_dtype=dtype, backend="xla")
    ref = jmu.fit_scan(jcfg, jnp.asarray(W0), jnp.asarray(H0),
                       tuple(jnp.asarray(b) for b in Bs0),
                       jnp.asarray(Xp).astype(jcfg.xdt),
                       tuple(jnp.asarray(y) for y in Ysp), jh, key, None)
    cfg = tmu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n,
                       loss_kl=loss_kl, batch_size=bs, tile=t,
                       max_iter=epochs, x_dtype=dtype, backend=backend)
    assert cfg.tiled
    n_tiles = Xp.shape[1] // t
    W, H, Bs, L = tmu.fit_scan(
        cfg, *state_from_numpy(W0, H0, Bs0, "cpu"),
        torch.from_numpy(Xp), [torch.from_numpy(y) for y in Ysp], th,
        draw_cells=lambda e: torch.from_numpy(_jax_tiles(key, e, n_tiles)))
    assert H.shape == (sum(BLOCKS), n)
    np.testing.assert_allclose(L.numpy(), np.asarray(ref[3]), rtol=5e-4)
    np.testing.assert_allclose(W.numpy(), np.asarray(ref[0]), rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(H.numpy(), np.asarray(ref[1]), rtol=5e-3, atol=1e-5)
    for b, rb in zip(Bs, ref[2]):
        np.testing.assert_allclose(b.numpy(), np.asarray(rb), rtol=5e-3, atol=1e-5)


@pytest.mark.parametrize("backend", ["fused", "plain"])
def test_tile1_is_the_per_cell_path(backend):
    """tile = 1 on an unpadded cell axis draws, batches and updates as the
    per-cell minibatch path: the same bits."""
    n, bs = 37, 10
    Xp, Ysp, init = _problem(7, n, t=1)
    _, th = _hypers([1.0, 2.0], 0.2, 0.1, 0.5, EPS)
    draws = [torch.from_numpy(np.random.default_rng(e).permutation(n))
             for e in range(3)]
    out = []
    for tile in (0, 1):
        cfg = tmu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n,
                           batch_size=bs, tile=tile, max_iter=3, backend=backend)
        out.append(tmu.fit_scan(cfg, *state_from_numpy(*init, "cpu"),
                                torch.from_numpy(Xp),
                                [torch.from_numpy(y) for y in Ysp], th,
                                draw_cells=lambda e: draws[e]))
    for a, b in zip(out[0], out[1]):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


def test_single_batch_epoch_is_a_column_permutation_of_full_batch():
    """One batch covering every tile: the full-batch step on a column
    permutation of X, with H scattered back to its columns."""
    n, t = 48, 8
    Xp, Ysp, init = _problem(3, n, t=t)
    _, th = _hypers([1.0, 2.0], 0.2, 0.1, 0.5, EPS)
    tiled = tmu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n,
                         batch_size=n - 1, tile=t, max_iter=4, backend="plain")
    full = tmu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n,
                        max_iter=4, backend="plain")
    perm = [torch.from_numpy(np.random.default_rng(e).permutation(n // t))
            for e in range(4)]
    X, Ys = torch.from_numpy(Xp), [torch.from_numpy(y) for y in Ysp]
    a = tmu.fit_scan(tiled, *state_from_numpy(*init, "cpu"), X, Ys, th,
                     draw_cells=lambda e: perm[e])
    b = tmu.fit_scan(full, *state_from_numpy(*init, "cpu"), X, Ys, th)
    for x, y in zip((a[0], a[1], *a[2], a[3]), (b[0], b[1], *b[2], b[3])):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n", [40, 37])  # 37: 3 zero pad columns
def test_tiled_loop_f64_matches_oracle(n):
    """The tiled loop in float64 (plain backend) against the oracle's steps
    on the same tiles: batches of 2 tiles of 8 cells, the last one short."""
    t, bs, epochs = 8, 16, 3
    Xp, Ysp, (W0, H0, Bs0) = _problem(9, n, t=t)
    X, Ys = Xp.astype(np.float64), [y.astype(np.float64) for y in Ysp]
    pad = X.shape[1] - n
    H0p = np.pad(H0.astype(np.float64), ((0, 0), (0, pad)))
    n_tiles = X.shape[1] // t
    perms = [np.random.default_rng(e).permutation(n_tiles) for e in range(epochs)]
    lam, orth, alpha, l1 = [1.0, 2.0], 0.2, 0.1, 0.5
    cfg = tmu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n,
                       batch_size=bs, tile=t, max_iter=epochs, backend="plain")
    hyper = (torch.tensor(lam, dtype=torch.float64), orth, alpha, l1, EPS)
    f64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))
    W, H, Bs, L = tmu._fit_scan_steps(
        cfg, f64(W0), f64(H0p), tuple(f64(b) for b in Bs0), f64(X),
        [f64(y) for y in Ys], hyper, None, lambda e: torch.from_numpy(perms[e]),
        None)
    oW, oH, oBs = W0.astype(np.float64), H0p.copy(), list(Bs0)
    for perm in perms:
        for lo in range(0, n_tiles, bs // t):
            idx = (perm[lo:lo + bs // t, None] * t + np.arange(t)).ravel()
            oWs, oHs_b, oBs = oracle_joint_step(
                _split_w(oW, BLOCKS), _split_h(oH[:, idx], BLOCKS), oBs,
                X[:, idx], [y[:, idx] for y in Ys], lam, orth, alpha, l1, EPS,
                True)
            oW = _cat_w(oWs)
            oH[:, idx] = _cat_h(oHs_b)
    assert W.dtype == torch.float64
    np.testing.assert_allclose(W.numpy(), oW, rtol=1e-11)
    np.testing.assert_allclose(H.numpy(), oH, rtol=1e-11)
    for b, ob in zip(Bs, oBs):
        np.testing.assert_allclose(b.numpy(), ob, rtol=1e-11)
    assert np.isfinite(L.numpy()).all()


@pytest.mark.parametrize("backend", ["fused", "plain"])
@pytest.mark.parametrize("loss_kl", [True, False], ids=["kl", "fro"])
def test_tiled_pad_columns_stay_exactly_zero(backend, loss_kl):
    """The pad's columns of H stay exactly zero, and the loss of the padded
    fit is the loss over its n cells (the KL pad constant is stripped)."""
    n, t = 37, 8
    Xp, Ysp, (W0, H0, Bs0) = _problem(5, n, t=t)
    _, th = _hypers([1.0, 2.0], 0.2, 0.1, 0.5, EPS)
    cfg = tmu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n,
                       loss_kl=loss_kl, batch_size=16, tile=t, max_iter=4,
                       backend=backend)
    H0p = np.pad(H0, ((0, 0), (0, Xp.shape[1] - n)))
    W, H, Bs, L = tmu._fit_scan_steps(
        cfg, *state_from_numpy(W0, H0p, Bs0, "cpu"), torch.from_numpy(Xp),
        [torch.from_numpy(y) for y in Ysp], th, None,
        lambda e: torch.from_numpy(np.random.default_rng(e).permutation(5)), None)
    assert H.shape[1] == n + 3
    assert not H[:, n:].any()
    unpadded = tmu.compute_loss_parts(
        cfg, th, W, H[:, :n], Bs, torch.from_numpy(Xp[:, :n]),
        torch.from_numpy(Xp[:, :n]), [torch.from_numpy(y[:, :n]) for y in Ysp],
        tmu._norm_x2(torch.from_numpy(Xp)))
    np.testing.assert_allclose(L[-1].numpy(), unpadded.numpy(), rtol=1e-5)


def test_kl_pad_loss_matches_jax():
    """compute_loss_parts with kl_pad against the JAX package's."""
    n, pad = 37, 3
    Xp, Ysp, (W0, H0, Bs0) = _problem(4, n, t=40)
    H0p = np.pad(H0, ((0, 0), (0, pad)))
    jh, th = _hypers([1.0, 2.0], 0.0, 0.0, 0.0, EPS)
    jcfg = jmu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n)
    cfg = tmu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n)
    ref = jmu.compute_loss_parts(jcfg, jh, jnp.asarray(W0), jnp.asarray(H0p),
                                 tuple(jnp.asarray(b) for b in Bs0),
                                 jnp.asarray(Xp), tuple(jnp.asarray(y) for y in Ysp),
                                 jnp.sum(jnp.asarray(Xp) ** 2), kl_pad=pad)
    X = torch.from_numpy(Xp)
    W, H, Bs = state_from_numpy(W0, H0p, Bs0, "cpu")
    got = tmu.compute_loss_parts(cfg, th, W, H, Bs, X, X,
                                 [torch.from_numpy(y) for y in Ysp],
                                 tmu._norm_x2(X), kl_pad=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("kw,n_cols,match", [
    (dict(), 37, "multiple"),
    (dict(use_als=True), 40, "joint mode"),
    (dict(weighted=True), 40, "exclusive"),
    (dict(), 48, "X must be"),   # a pad wider than a tile
])
def test_tiled_fit_scan_refusals(kw, n_cols, match):
    """The reference's refusals (alpine_tpu/ops/mu.py:746-767), and an X
    wider than n_cells plus a tile."""
    Xp, Ysp, init = _problem(5, 37, t=1)
    X = np.pad(Xp, ((0, 0), (0, n_cols - 37)))
    Ys = [np.pad(y, ((0, 0), (0, n_cols - 37))) for y in Ysp]
    cfg = tmu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=37,
                       batch_size=16, tile=8, max_iter=2, **kw)
    with pytest.raises(ValueError, match=match):
        tmu.fit_scan(cfg, *state_from_numpy(*init, "cpu"), torch.from_numpy(X),
                     [torch.from_numpy(y) for y in Ys], _hypers([1.0, 2.0], 0, 0, 0, EPS)[1],
                     draw_cells=lambda e: torch.arange(n_cols // 8))


def test_tile_stream():
    """A permutation of the tiles an epoch; draw t depends on (random_state,
    restart, chunk, t) alone, and restart 0 of an unchunked fit is the
    plain stream."""
    cpu = torch.device("cpu")
    draw = talpine.draw_tiles_stream(50, 3, cpu)
    p0 = draw(0)
    assert p0.dtype == torch.int64 and torch.equal(torch.sort(p0).values, torch.arange(50))
    assert torch.equal(talpine.draw_tiles_stream(50, 3, cpu)(0), p0)
    assert not torch.equal(draw(1), p0)
    others = [talpine.draw_tiles_stream(50, 3, cpu, restart=1)(0),
              talpine.draw_tiles_stream(50, 3, cpu, chunk=0)(0),
              talpine.draw_tiles_stream(50, 4, cpu)(0),
              talpine.draw_cells_stream(50, 3, cpu)(0)]
    assert all(not torch.equal(o, p0) for o in others)


# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("integer,loss_type,max_iter", [
    (False, "kl-divergence", 12),
    (False, "frobenius", 12),
    (True, "kl-divergence", 4),
], ids=["float32-kl", "float32-fro", "int8-kl"])
def test_tiled_estimator_matches_jax(jax_draws, jax_tiles, integer, loss_type,
                                     max_iter):
    """300 cells (3 tiles of 128, 84 pad columns), batch 130 (2 tiles, then
    1): the loss history, the factors and the cached transform against the
    JAX estimator's fit and its uncached transform (the JAX package's
    cached one draws H0 at the padded width)."""
    ad = make_synthetic_adata(n_cells=300, n_genes=30, seed=2)
    if integer:
        ad.X = np.round(ad.X)
    jm = JaxALPINE(device="cpu", loss_type=loss_type, **KW)
    tm = ALPINE(device="cpu", loss_type=loss_type, **KW)
    ad_j, ad_t = ad.copy(), ad.copy()
    kw = dict(max_iter=max_iter, batch_size=130, sampling_method="tiled")
    jm.fit(ad_j, KEYS, **kw)
    tm.fit(ad_t, KEYS, **kw)
    assert tm._x_cache[4] == jm._x_cache[3] == 84
    np.testing.assert_array_equal(tm._x_cache[3], jm._x_cache[4])
    assert tuple(tm._x_cache[0].shape) == (30, 384)
    jm.free_device_cache()
    _check_fit_and_transform(jm, tm, ad_j, ad_t)


def test_model_tiled_unshuffles_h_to_caller_cell_order():
    """Each cell's returned H column explains its own expression row
    (tests/test_tiled.py:198-226 on the port)."""
    adata = make_synthetic_adata(n_cells=300, n_genes=30)
    m = ALPINE(n_components=8, n_covariate_components=[2, 3],
               lam=[1.0, 2.0], device="cpu", random_state=0)
    m.fit(adata, ["batch", "condition"], batch_size=130,
          sampling_method="tiled", max_iter=80)
    L = m.loss_history_[:, 0]
    assert np.isfinite(L).all() and L[-1] < L[0]
    R = np.hstack(m.matrices["Ws"]) @ np.vstack(m.matrices["Hs"])
    X = np.asarray(adata.X, np.float32).T

    def mean_cell_corr(a, b):
        a, b = a - a.mean(0), b - b.mean(0)
        denom = np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0) + 1e-12
        return float(((a * b).sum(0) / denom).mean())

    aligned = mean_cell_corr(X, R)
    misaligned = mean_cell_corr(X, R[:, np.random.default_rng(1).permutation(300)])
    assert aligned > 0.9 and aligned > misaligned + 0.2, (aligned, misaligned)


def test_tiled_cached_transform_equals_uncached():
    """The transform through the tiled fit's permuted, padded device X gives
    each cell the projection an upload of the data gives it: H0 re-paired
    and padded with zero columns, the result stripped and un-permuted."""
    adata = make_synthetic_adata(n_cells=300, n_genes=30)
    m = ALPINE(n_components=8, n_covariate_components=[2, 3],
               lam=[1.0, 2.0], device="cpu", random_state=0)
    m.fit(adata, ["batch", "condition"], batch_size=130,
          sampling_method="tiled", max_iter=5)
    assert m._x_cache[3] is not None and m._x_cache[4] == 84
    ad_hit, ad_miss = adata.copy(), adata.copy()
    m.transform(ad_hit, n_iter=30)
    m.free_device_cache()
    m.transform(ad_miss, n_iter=30)
    for k in ("ALPINE_embedding", "batch", "condition"):
        np.testing.assert_allclose(ad_hit.obsm[k], ad_miss.obsm[k], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mkw,fkw", [
    (dict(use_als=True), dict(batch_size=16)),
    (dict(), dict()),
    (dict(), dict(batch_size=64)),
    (dict(), dict(batch_size=1000)),
], ids=["als", "no-batch", "covering", "over-covering"])
def test_tiled_refusals_match_jax(mkw, fkw):
    ad = make_synthetic_adata(n_cells=64, n_genes=20)
    kw = dict(n_components=6, n_covariate_components=[2, 2], lam=[1.0, 1.0],
              random_state=0, **mkw)
    args = (["batch", "condition"],)
    fkw = dict(sampling_method="tiled", max_iter=3, **fkw)
    with pytest.raises(ValueError) as ej:
        JaxALPINE(device="cpu", **kw).fit(ad.copy(), *args, **fkw)
    with pytest.raises(ValueError) as et:
        ALPINE(device="cpu", **kw).fit(ad.copy(), *args, **fkw)
    assert str(et.value) == str(ej.value) and "tiled" in str(et.value)

"""ALS mode in the port, and the kernels of its X passes and of the
streaming probe, against the JAX package on the CPU.

- ``kernels.hxt_plain`` / ``wtx_plain`` against copies of the Pallas
  kernels of ``benchmarks/als_probe.py:_pallas_dots`` run with
  ``interpret=True`` (that module reads ``sys.argv`` when imported, so its
  two kernel bodies are copied here, lines 154-170), and against
  ``alpine_tpu.ops.mu._x_ht`` / ``_dot_x``: rtol 1e-5, sums in another
  order; bf16 products are exact.
- ``kernels.stream_probe_plain`` against a copy of
  ``benchmarks/envelope_probe.py``'s streaming kernel (lines 118-127):
  exact, since sums of small integers are exact in f32.
- ``mu.als_batch_update`` in float64 against ``tests/oracle.py`` at rtol
  1e-11 (loss 1e-9), as tests/test_exact_parity.py holds the JAX step.
- ``mu.fit_scan(use_als=True)`` on both backends against JAX's, from one
  init: loss rtol 5e-4, factors rtol 5e-3 (20 iterations on float32 data,
  5 on int8, whose bf16 roundings make trajectories chaotic at the last
  bit: tests/test_torch_mu.py).
- ``ALPINE(use_als=True)`` against the JAX estimator, as
  tests/test_torch_model.py holds the joint fit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from alpine_tpu import ALPINE as JaxALPINE
from alpine_tpu.ops import mu as jmu
from alpine_tpu.ops import pallas_kernels as pk
from alpine_tpu_torch import ALPINE
from alpine_tpu_torch.convert import state_from_numpy
from alpine_tpu_torch.ops import kernels
from alpine_tpu_torch.ops import mu as tmu

from .oracle import _cat_h, _cat_w, oracle_als_step, oracle_loss
from .test_torch_model import (  # noqa: F401  (jax_draws is a fixture)
    KEYS, KW, _adata, _check_fit_and_transform, jax_draws)
from .torch_k_samples import COVER_KS

torch.set_num_threads(1)

EPS = 1e-6
DTYPES = ("float32", "bfloat16", "int8", "int16")
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8, "int16": torch.int16}


def _x_values(r, dtype, shape):
    """float32 values that the storage dtype holds exactly."""
    if dtype in ("int8", "int16"):
        return r.poisson(3.0, shape).clip(0, 127).astype(np.float32)
    if dtype == "bfloat16":
        return np.array(jnp.asarray(r.random(shape, dtype=np.float32))
                        .astype(jnp.bfloat16).astype(jnp.float32))
    return r.random(shape, dtype=np.float32)


def _both(a, dtype):
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(np.ascontiguousarray(a)).to(_TORCH[dtype]))


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# P1, P2: the ALS probe's kernels
# ---------------------------------------------------------------------------


def _probe_dots(g, K, tile_n, n):
    """benchmarks/als_probe.py:_pallas_dots (lines 138-188) at (g, K),
    run with interpret=True."""
    import jax.experimental.pallas as pl

    grid = (n // tile_n,)
    full = lambda i: (0, 0)
    by_cells = lambda i: (0, i)

    def hxt_kernel(X_ref, H_ref, out_ref):
        xt, xdt = pk._load_x(X_ref)
        i = pl.program_id(0)

        @pl.when(i == 0)
        def _():
            out_ref[:] = jnp.zeros_like(out_ref)

        out_ref[:] += lax.dot_general(
            H_ref[:].astype(xdt), xt, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)

    def wtx_kernel(X_ref, W_ref, out_ref):
        xt, xdt = pk._load_x(X_ref)
        out_ref[:] = lax.dot_general(
            W_ref[:].astype(xdt), xt, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)

    hxt = pl.pallas_call(
        hxt_kernel, grid=grid,
        in_specs=[pl.BlockSpec((g, tile_n), by_cells),
                  pl.BlockSpec((K, tile_n), by_cells)],
        out_specs=pl.BlockSpec((K, g), full),
        out_shape=jax.ShapeDtypeStruct((K, g), jnp.float32), interpret=True)
    wtx = pl.pallas_call(
        wtx_kernel, grid=grid,
        in_specs=[pl.BlockSpec((g, tile_n), by_cells),
                  pl.BlockSpec((g, K), full)],
        out_specs=pl.BlockSpec((K, tile_n), by_cells),
        out_shape=jax.ShapeDtypeStruct((K, n), jnp.float32), interpret=True)
    return hxt, wtx


@pytest.mark.parametrize("n", [384, 1001, 8195])
@pytest.mark.parametrize("K", [7, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_x_pass_plain_versions_match_pallas_probe(dtype, K, n):
    """384 cells fill the probe's 128-cell tiles; 1,001 and 8,195 (rows off
    16-byte alignment on the card) do not, and the probe, whose grid takes
    whole tiles, runs on X and H padded with zero cells (which add nothing
    to H Xᵀ; WᵀX's padded columns are dropped)."""
    g, tile = 48, 128
    r = np.random.default_rng(K)
    X = _x_values(r, dtype, (g, n))
    H = r.random((K, n), dtype=np.float32) + 0.1
    W = r.random((g, K), dtype=np.float32)
    Xj, Xt = _both(X, dtype)
    n_pad = -(-n // tile) * tile
    Xp = jnp.pad(Xj, ((0, 0), (0, n_pad - n)))
    Hp = jnp.pad(jnp.asarray(H), ((0, 0), (0, n_pad - n)))
    hxt, wtx = _probe_dots(g, K, tile, n_pad)
    got_h = kernels.hxt(Xt, torch.from_numpy(H))
    got_w = kernels.wtx(Xt, torch.from_numpy(W))
    assert got_h.shape == (K, g) and got_w.shape == (K, n)
    _close(got_h, hxt(Xp, Hp), 1e-5, 1e-6)
    _close(got_w, np.asarray(wtx(Xp, jnp.asarray(W)))[:, :n], 1e-5, 1e-6)
    # and the JAX fit path's own X products, with MUConfig of each dtype
    cfg = jmu.MUConfig(blocks=(K,), n_labels=(), n_cells=n, x_dtype=dtype)
    _close(got_h.T, jmu._x_ht(cfg, Xj, jnp.asarray(H)), 1e-5, 1e-6)
    _close(got_w, jmu._dot_x(cfg, jnp.asarray(W).T, Xj), 1e-5, 1e-6)
    assert kernels.launches["hxt"] == kernels.launches["wtx"] == 0


def test_x_pass_wrappers_check_inputs():
    X = torch.zeros((6, 10), dtype=torch.int8)
    with pytest.raises(ValueError, match="H has shape"):
        kernels.hxt(X, torch.zeros((3, 9)))
    with pytest.raises(ValueError, match="W has dtype"):
        kernels.wtx(X, torch.zeros((6, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="X must be 2-D"):
        kernels.hxt(X.double(), torch.zeros((3, 10)))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.wtx(X, torch.zeros((3, 6)).T)
    meta = torch.zeros((6, 10), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.hxt(meta, torch.zeros((3, 10), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.stream_probe(meta)


def test_wtx_tile_rule():
    """wtx's fp32 path takes wtx_fma_grid's tile (12 cells a thread, 32 / LK
    threads along the cells; above 512 wtx_fma_wide_grid's 128-cell tiles),
    its bf16 path wtx_grid's: all of K in one
    pass (at most 6 fragment rows a warp, 48 accumulators a thread) for
    every K up to 512, T a multiple of 16; above 512, wtx_wide_grid's
    128-cell tiles of 256 rows of K (a warpgroup's 64 cells x 256 rows: 128
    accumulators a thread), all genes in one pass at the bench shape
    (tests/torch_k_samples.py)."""
    for K in COVER_KS:
        for xdt in (torch.float32, torch.int16):
            if K > 512:  # wtx_fma_wide's 128-cell tiles of 128 rows of K
                T, _, _, blocks = kernels.wtx_fma_wide_grid(2000, 100_000, K, xdt)
                assert T == 128 and blocks == -(-K // 128) * -(-100_000 // T)
                continue
            T, LK, _, _, blocks = kernels.wtx_fma_grid(2000, 100_000, K, xdt)
            assert T == 12 * 32 // LK and blocks == -(-100_000 // T)
        if K > 512:
            CL, ranges, _, _ = kernels.wtx_wide_grid(2000, 100_000, K, torch.int8)
            assert kernels._WIDE_BM % 16 == 0 and 64 * kernels._WIDE_BN // 128 == 128
            assert kernels._wide_tiles("wtx", 100_000, K) == (
                -(-(-(-100_000 // kernels._WIDE_BM)) // CL) * CL * -(-K // kernels._WIDE_BN))
            assert ranges == 1
            continue
        T, WR, GC, S, blocks = kernels.wtx_grid(2000, 100_000, K, torch.int8)
        frags = -(-(kernels._pad16(K) // 16) // WR)  # fragment rows a warp
        cells = T // (8 // WR)  # cells a warp
        assert T % 16 == 0 and cells % 16 == 0 and frags <= 6
        assert frags * cells // 2 <= 48  # 8 accumulators a 16 x 16 fragment
        assert blocks == -(-100_000 // T)
    with pytest.raises(ValueError, match="float32 and int16"):
        kernels.wtx_fma_grid(2000, 100_000, 30, torch.int8)
    assert kernels.wtx_grid(2000, 100_000, 5, torch.int8)[0] == 384
    assert kernels.wtx_grid(2000, 100_000, 30, torch.int8)[0] == 384
    assert kernels.wtx_grid(2000, 100_000, 40, torch.int8)[0] == 192


# ---------------------------------------------------------------------------
# P3: the streaming probe
# ---------------------------------------------------------------------------


def _pallas_stream(X, tile):
    """benchmarks/envelope_probe.py:probe_streaming's kernel (lines
    118-135) over X zero-padded to whole tiles, run with interpret=True."""
    from jax.experimental import pallas as pl

    g, n = X.shape
    n_pad = -(-n // tile) * tile
    Xp = jnp.pad(X, ((0, 0), (0, n_pad - n)))

    def kernel(x_ref, o_ref):
        @pl.when(pl.program_id(0) == 0)
        def _init():
            o_ref[...] = jnp.zeros_like(o_ref)

        s = jnp.sum(x_ref[...].astype(jnp.float32), axis=0, keepdims=True)
        o_ref[...] += jnp.broadcast_to(s[:, :128], (8, 128))

    stream = pl.pallas_call(
        kernel, grid=(n_pad // tile,),
        in_specs=[pl.BlockSpec((g, tile), lambda i: (0, i))],
        out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32), interpret=True)
    return np.asarray(stream(Xp))


@pytest.mark.parametrize("dtype,n,tile", [
    ("int8", 300, 128), ("float32", 1000, 256), ("bfloat16", 384, 128),
    ("int16", 100, 128), ("int8", 1000, None)])
def test_stream_probe_plain_matches_pallas_probe(dtype, n, tile):
    """Ragged last tiles (300, 1000 and 100 cells) count as zero columns;
    tile=None takes the probe's own rule."""
    g = 24
    X = np.random.default_rng(n).integers(0, 100, (g, n)).astype(np.float32)
    Xj, Xt = _both(X, dtype)
    use = tile or kernels.stream_tile(g, Xt.element_size())
    if tile is None:
        assert use == max(128, (6 * 1024 * 1024 // (g * Xt.element_size()))
                          // 128 * 128)
    fold, colsum = kernels.stream_probe(Xt, tile)
    np.testing.assert_array_equal(fold.numpy(), _pallas_stream(Xj, use))
    np.testing.assert_array_equal(colsum.numpy(), X.sum(axis=0))
    with pytest.raises(ValueError, match="multiple of 128"):
        kernels.stream_probe(Xt, 200)
    assert kernels.launches["stream_probe"] == 0


# ---------------------------------------------------------------------------
# The ALS step in float64 against the numpy oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loss_kl", [True, False])
def test_als_step_f64_matches_oracle(loss_kl):
    blocks, n_labels, G, N = (3, 4, 6), (2, 3), 20, 35
    r = np.random.default_rng(0)
    X = r.random((G, N)) * 2
    Ys = []
    for nl in n_labels:
        y = np.zeros((nl, N))
        y[r.integers(0, nl, N), np.arange(N)] = 1.0
        Ys.append(y)
    Ws = [r.random((G, k)) + 0.1 for k in blocks]
    Hs = [r.random((k, N)) + 0.1 for k in blocks]
    Bs = [r.random((nl, k)) + 0.1 for nl, k in zip(n_labels, blocks)]
    lam = [2.0, 0.5]
    cfg = tmu.MUConfig(blocks=blocks, n_labels=n_labels, n_cells=N,
                       loss_kl=loss_kl, use_als=True, backend="plain")
    hyper = (torch.tensor(lam, dtype=torch.float64), 0.3, 0.7, 0.4, EPS)
    t = torch.from_numpy
    W, H = t(_cat_w(Ws)), t(_cat_h(Hs))
    Bs_t = tuple(t(b) for b in Bs)
    Xt, Ys_t = t(X), [t(y) for y in Ys]
    W_in, H_in = W.clone(), H.clone()
    oWs, oHs, oBs = Ws, Hs, Bs
    for _ in range(10):
        W, Bs_t, H, (WtX, WtW) = tmu.als_batch_update(cfg, hyper, W, Bs_t, H,
                                                      Xt, Xt, Ys_t)
        oWs, oHs, oBs = oracle_als_step(oWs, oHs, oBs, X, Ys, lam, 0.3, 0.7,
                                        0.4, EPS, loss_kl)
    assert WtW is None and W.dtype == torch.float64
    np.testing.assert_allclose(W.numpy(), _cat_w(oWs), rtol=1e-11)
    np.testing.assert_allclose(H.numpy(), _cat_h(oHs), rtol=1e-11)
    for b, ob in zip(Bs_t, oBs):
        np.testing.assert_allclose(b.numpy(), ob, rtol=1e-11)
    # the returned WᵀX is that of the final W
    np.testing.assert_allclose(WtX.numpy(), W.numpy().T @ X, rtol=1e-12)
    got = tmu.compute_loss_parts(cfg, hyper, W, H, Bs_t, Xt, Xt, Ys_t,
                                 torch.sum(Xt * Xt), WtX=WtX)
    want = oracle_loss(oWs, oHs, oBs, X, Ys, lam, EPS, loss_kl)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)
    # the step leaves its inputs as they were
    assert torch.equal(W_in, t(_cat_w(Ws))) and torch.equal(H_in, t(_cat_h(Hs)))


# ---------------------------------------------------------------------------
# fit_scan(use_als=True) against JAX's
# ---------------------------------------------------------------------------


G, N = 30, 300


def _fit_problem(seed, n_labels, dtype):
    r = np.random.default_rng(seed)
    if dtype == "int8":
        X = r.poisson(3.0, (G, N)).clip(0, 127).astype(np.float32)
    else:
        X = r.random((G, N), dtype=np.float32)
    Ys = []
    for nl in n_labels:
        y = np.zeros((nl, N), np.float32)
        y[r.integers(0, nl, N), np.arange(N)] = 1.0
        Ys.append(y)
    return X, Ys


@pytest.mark.parametrize("n_cov,loss_kl,dtype", [
    (2, True, "float32"), (2, False, "float32"), (0, True, "float32"),
    (2, True, "int8"), (2, False, "int8"),
])
def test_als_fit_scan_matches_jax(n_cov, loss_kl, dtype):
    if n_cov:
        blocks, n_labels, lam = (3, 4, 6), (2, 3), [3.0, 1.5]
    else:
        blocks, n_labels, lam = (6,), (), []
    iters = 20 if dtype == "float32" else 5
    X, Ys = _fit_problem(1, n_labels, dtype)
    lam_np = np.asarray(lam, np.float32)
    f = lambda v: float(np.float32(v))
    jh = (jnp.asarray(lam_np), jnp.float32(0.2), jnp.float32(0.4),
          jnp.float32(0.3), jnp.float32(EPS))
    th = (torch.from_numpy(lam_np), f(0.2), f(0.4), f(0.3), f(EPS))
    key = jax.random.PRNGKey(2)
    jcfg = jmu.MUConfig(blocks=blocks, n_labels=n_labels, n_cells=N,
                        loss_kl=loss_kl, use_als=True, max_iter=iters,
                        x_dtype=dtype, backend="xla")
    W0, H0, Bs0 = jmu.init_matrices(jcfg, G, key, EPS)
    ref = jmu.fit_scan(jcfg, W0, H0, Bs0, jnp.asarray(X).astype(jcfg.xdt),
                       tuple(jnp.asarray(y) for y in Ys), jh, key, None)
    Wr, Hr, Bsr, Lr = (np.asarray(ref[0]), np.asarray(ref[1]),
                       [np.asarray(b) for b in ref[2]], np.asarray(ref[3]))
    for backend in ("fused", "plain"):
        cfg = tmu.MUConfig(blocks=blocks, n_labels=n_labels, n_cells=N,
                           loss_kl=loss_kl, max_iter=iters, x_dtype=dtype,
                           backend=backend, use_als=True)
        W0t, H0t, Bs0t = state_from_numpy(np.asarray(W0), np.asarray(H0),
                                          [np.asarray(b) for b in Bs0], "cpu")
        W, H, Bs, L = tmu.fit_scan(cfg, W0t, H0t, Bs0t,
                                   torch.from_numpy(X).to(_TORCH[dtype]),
                                   [torch.from_numpy(y) for y in Ys], th)
        L = L.numpy()
        assert np.isfinite(L).all() and L.shape == (iters, 2 + n_cov)
        np.testing.assert_allclose(L, Lr, rtol=5e-4)
        np.testing.assert_allclose(W.numpy(), Wr, rtol=5e-3, atol=1e-5)
        np.testing.assert_allclose(H.numpy(), Hr, rtol=5e-3, atol=1e-5)
        for b, br in zip(Bs, Bsr):
            np.testing.assert_allclose(b.numpy(), br, rtol=5e-3, atol=1e-5)
    assert kernels.launches["hxt"] == kernels.launches["wtx"] == 0


def test_als_rejects_weighted_counts():
    cfg = tmu.MUConfig(blocks=(2, 3), n_labels=(2,), n_cells=N, use_als=True,
                       weighted_counts=True)
    X, Ys = _fit_problem(0, (2,), "float32")
    W0, H0, Bs0 = state_from_numpy(np.ones((G, 5), np.float32),
                                   np.ones((5, N), np.float32),
                                   [np.ones((2, 2), np.float32)], "cpu")
    hyper = (torch.ones(1), 0.0, 0.0, 0.0, EPS)
    with pytest.raises(ValueError, match="use_als=False"):
        tmu.fit_scan(cfg, W0, H0, Bs0, torch.from_numpy(X),
                     [torch.from_numpy(Ys[0])], hyper,
                     draw_counts=lambda t: torch.ones(N))


# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------


def _fit_both_als(ad, max_iter, **kw):
    jm = JaxALPINE(device="cpu", use_als=True, **KW, **kw)
    tm = ALPINE(device="cpu", use_als=True, **KW, **kw)
    ad_j, ad_t = ad.copy(), ad.copy()
    jm.fit(ad_j, KEYS, max_iter=max_iter)
    tm.fit(ad_t, KEYS, max_iter=max_iter)
    return jm, tm, ad_j, ad_t


@pytest.mark.parametrize("integer,max_iter,loss_type", [
    (False, 30, "kl-divergence"), (False, 30, "frobenius"),
    (True, 5, "kl-divergence")])
def test_als_estimator_matches_jax(jax_draws, integer, max_iter, loss_type):
    jm, tm, ad_j, ad_t = _fit_both_als(_adata(integer=integer), max_iter,
                                       loss_type=loss_type, orth_W=0.1)
    assert tm.data_dtype_ == ("int8" if integer else "float32")
    assert set(tm.timings_) == {"fit"}
    _check_fit_and_transform(jm, tm, ad_j, ad_t)


def test_als_elbow_fit_matches_jax(jax_draws):
    jm, tm, ad_j, ad_t = _fit_both_als(_adata(integer=False, seed=1), None)
    assert 0 < tm.max_iter < 200
    assert set(tm.timings_) == {"warmup", "fit"}
    _check_fit_and_transform(jm, tm, ad_j, ad_t)


def test_als_options_left_out_raise():
    """Minibatch and gathered weighted ALS fits run; weighted_fast and tiled
    ALS fits raise the reference's ValueError with its message."""
    ad = _adata(integer=True)
    m = ALPINE(device="cpu", use_als=True, **KW)
    for kw in (dict(batch_size=10), dict(sampling_method="weighted")):
        m.fit(ad, KEYS, max_iter=2, **kw)
        assert np.isfinite(m.loss_history_).all() and m.loss_history_.shape == (2, 4)
    for kw in (dict(sampling_method="weighted_fast"),
               dict(sampling_method="tiled", batch_size=10)):
        with pytest.raises(ValueError) as ej:
            JaxALPINE(device="cpu", use_als=True, **KW).fit(ad.copy(), KEYS,
                                                            max_iter=2, **kw)
        with pytest.raises(ValueError) as et:
            m.fit(ad, KEYS, max_iter=2, **kw)
        assert str(et.value) == str(ej.value)

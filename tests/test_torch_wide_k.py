"""K > 512 on the CPU: the large-K routes of the port's kernels.

On the card every kernel of the fit and transform path takes any K by a
rule by K (``kernels.route``): P1/P2 as the wgmma kernels hxt_wide and
wtx_wide on int8/bf16 X (csrc/x_passes_wide.cuh) and as hxt_fma_wide
and wtx_fma_wide on float32/int16 X (csrc/fma_wide.cuh), K1/K2/K4 as the
chain of
``kernels.wide_iteration_grid`` (WᵀX by P2's large-K kernel, D = WᵀW H by
csrc/wtw_gemm.cuh, iter_wide's H update, Q and loss rows over 128-cell
tiles, X Hsᵀ by P1's large-K kernel, H Hᵀ, HHtU, rowsum and Bnum by
gram_wide from one read of Hn: tests/test_torch_gram_wide.py), K3
as one launch a step (csrc/wtw_gemm.cuh's update).  The
CUDA kernels run only on the card (tests/test_torch_cuda.py); here, on
numpy-seeded inputs:

- the plain versions against the JAX package's Pallas kernels in interpret
  mode at K = 520 and 768 (K1 with and without counts at rtol 1e-4 on the
  statistics, K2, and K3 at rtol 2e-4 / atol 1e-6);
- a PyTorch emulation of the large-K chain's summation order against the
  plain version (rtol 1e-5), and of K3's per-step path's buffers;
- the estimator against the JAX estimator at K = 600 (blocks (400, 100,
  100)): joint, ALS and weighted_fast fits of 5 iterations, loss rtol
  5e-4, factors 5e-3; and a JAX-fitted K = 600 model carried across by
  ``convert.fitted_from_numpy``, whose transform matches the JAX one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpine_tpu import ALPINE as JaxALPINE
from alpine_tpu.ops import pallas_kernels as pk
from alpine_tpu_torch import ALPINE
from alpine_tpu_torch.convert import fitted_from_numpy
from alpine_tpu_torch.ops import kernels
from alpine_tpu_torch.ops.mu import guided_width

from .test_torch_fma_wide import emulate_hxt_fma_wide as _emulate_hxt_fp32
from .test_torch_fma_wide import emulate_wtx_fma_wide as _emulate_wtx_fp32
from .test_torch_gram_wide import emulate_gram
from .test_torch_hxt import _emulate_hxt as _emulate_hxt_bf16
from .test_torch_kernels import _both, _close, _problem, _t
from .test_torch_model import (  # noqa: F401  (jax_draws is a fixture)
    KEYS, _adata, _check_fit_and_transform, jax_draws)
from .test_torch_weighted import _k4_problem, _run_k4, jax_counts  # noqa: F401
from .test_torch_wtx import _emulate_wtx as _emulate_wtx_bf16

torch.set_num_threads(1)

EPS = 1e-6
WIDE_BLOCKS = {520: (130, 65, 325), 768: (192, 192, 384)}
KW600 = dict(n_components=400, n_covariate_components=[100, 100], lam=[5.0, 2.0],
             random_state=3)


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,dtype,loss_kl", [(520, "float32", True), (520, "int8", False),
                                             (768, "bfloat16", True), (768, "int8", True),
                                             (768, "int16", False)])
def test_fused_iteration_plain_matches_pallas_at_wide_k(K, dtype, loss_kl):
    blocks, n_labels, n = WIDE_BLOCKS[K], (2, 3), 256
    X, W, H, WtW, Ys, Bs, lam = _problem(K, n, blocks, n_labels, dtype)
    Xj, Xt = _both(X, dtype)
    want = pk.fused_iteration(
        Xj, jnp.asarray(W), jnp.asarray(H), jnp.asarray(WtW),
        tuple(_both(y, dtype)[0] for y in Ys), tuple(jnp.asarray(b) for b in Bs),
        jnp.asarray(lam), jnp.float32(EPS), blocks=blocks, loss_kl=loss_kl, interpret=True)
    assert kernels.route(K) == "wide"
    Hn, XHt, HHt, ld, preds, bnums, bdens = kernels.fused_iteration(
        Xt, _t(W), _t(H), _t(WtW), [_both(y, dtype)[1] for y in Ys], [_t(b) for b in Bs],
        _t(lam), EPS, blocks=blocks, loss_kl=loss_kl)
    _close(Hn, want[0], 1e-5, 1e-6)
    if dtype in ("int8", "bfloat16"):
        # X Hnᵀ over this Hn, as the Pallas kernel forms it (bf16 operands,
        # fp32 sums): an Hn within rtol 1e-5 of the kernel's can round to
        # the next bf16 value, which moves one of 256 terms by 2^-8
        want_xht = jnp.dot(Xj.astype(jnp.bfloat16), jnp.asarray(Hn.numpy()).T.astype(
            jnp.bfloat16), preferred_element_type=jnp.float32)
        _close(XHt, want_xht, 1e-4, 1e-4)
    else:
        _close(XHt, want[1], 1e-4, 1e-4)
    _close(HHt, want[2], 1e-4, 1e-4)
    _close(ld, want[3], 1e-4)
    for c in range(len(n_labels)):
        _close(preds[c], want[4][c], 1e-4)
        _close(bnums[c], want[5][c], 1e-4, 1e-5)
        _close(bdens[c], want[6][c], 1e-4)


@pytest.mark.parametrize("K,dtype,loss_kl", [(520, "float32", True), (768, "int8", True),
                                             (768, "float32", False)])
def test_fused_iteration_counts_plain_matches_pallas_at_wide_k(K, dtype, loss_kl):
    X, W, H, WtW, Ys, Bs, lam, C = _k4_problem(dtype, WIDE_BLOCKS[K], (2, 3))
    got, want = _run_k4(dtype, WIDE_BLOCKS[K], loss_kl, X, W, H, WtW, Ys, Bs, lam, C)
    Hn, XHt, HHt, HHtU, ld, preds, bnums, bdens = got
    _close(Hn, want[0], 1e-5, 1e-6)
    _close(XHt, want[1], 1e-4, 1e-4)
    _close(HHt, want[2], 1e-4, 1e-4)
    _close(HHtU, want[3], 1e-4, 1e-4)
    _close(ld, want[4], 1e-4)
    for c in range(2):
        _close(preds[c], want[5][c], 1e-4)
        _close(bnums[c], want[6][c], 1e-4, 1e-5)
        _close(bdens[c], want[7][c], 1e-4)
    undrawn = C[0] == 0
    assert undrawn.any()
    np.testing.assert_array_equal(Hn.numpy()[:, undrawn], H[:, undrawn])


@pytest.mark.parametrize("K,dtype", [(520, "int8"), (768, "float32")])
def test_fused_h_update_plain_matches_pallas_at_wide_k(K, dtype):
    X, W, H, WtW, _, _, _ = _problem(K + 1, 300, (K,), (), dtype)
    Xj, Xt = _both(X, dtype)
    want = pk.fused_h_update(Xj, jnp.asarray(W), jnp.asarray(H), jnp.asarray(WtW),
                             jnp.float32(EPS), interpret=True)
    Hn, XHt, HHt, ld = kernels.fused_h_update(Xt, _t(W), _t(H), _t(WtW), EPS)
    _close(Hn, want[0], 1e-5, 1e-6)
    _close(XHt, want[1], 1e-4, 1e-4)
    _close(HHt, want[2], 1e-4, 1e-4)
    _close(ld, want[3], 1e-4)


@pytest.mark.parametrize("K", [520, 768])
def test_fused_transform_plain_matches_pallas_at_wide_k(K):
    r = np.random.default_rng(K)
    W = r.random((30, K), dtype=np.float32)
    X = r.random((30, 300), dtype=np.float32)
    H0 = r.random((K, 300), dtype=np.float32) + 0.1
    num2 = (2.0 * (W.T @ X)).astype(np.float32)
    WtW2 = (2.0 * (W.T @ W)).astype(np.float32)
    want = pk.fused_transform(jnp.asarray(num2), jnp.asarray(H0), jnp.asarray(WtW2),
                              jnp.float32(EPS), n_iter=12, interpret=True)
    assert kernels.transform_path(K) == "steps"
    got = kernels.fused_transform(_t(num2), _t(H0), _t(WtW2), EPS, n_iter=12)
    _close(got, want, 2e-4, 1e-6)


# ---------------------------------------------------------------------------
# the large-K chain's summation order
# ---------------------------------------------------------------------------


def _emulate_wide(X, W, H, WtW, Ys, Bs, lam, C, blocks, loss_kl):
    """fused_iteration's large-K chain in PyTorch: WᵀX in P2's large-K order
    (wtx_wide's on int8/bf16 X, wtx_fma_wide's on float32/int16:
    tests/test_torch_wide_passes.py, test_torch_fma_wide.py),
    D = WᵀW H, the H update and
    guided terms elementwise as iter_wide forms them, iter_wide's per-block
    partials (each block's 128-cell tiles in order: the prediction-loss rows
    and the loss dot), added in block order; X Hsᵀ in P1's large-K order
    (hxt_wide's splits, or hxt_fma_wide's); H Hᵀ = Hs Hnᵀ, HHtU, rowsum and
    Bnum = Q Hsᵀ in gram_wide's (its splits' upper-triangle tiles and extra
    columns, mirrored: ``emulate_gram``).  Returns the outputs of
    ``fused_iteration`` (``fused_h_update`` without covariates)."""
    g, n = X.shape
    K = H.shape[0]
    mma = X.dtype in kernels._MMA_XTYPES
    grid = kernels.wide_iteration_grid(g, n, K, X.dtype)
    WtX = _emulate_wtx_bf16(X, W, K) if mma else _emulate_wtx_fp32(X, W)
    num, den = 2.0 * WtX, 2.0 * (WtW @ H)
    Kg = guided_width(blocks) if Ys else 0
    if Ys:
        Yf = torch.cat([y.float() for y in Ys])
        Bg = kernels._embed_b(Bs, blocks)
        lam_rows = kernels._lam_rows(lam, blocks)[:, None]
        BH = Bg @ H[:Kg]
        if loss_kl:
            num[:Kg] += lam_rows * (Bg.T @ (Yf / torch.clamp(BH, min=EPS)))
            den[:Kg] += lam_rows * torch.sum(Bg, dim=0)[:, None]
        else:
            num[:Kg] += 2.0 * lam_rows * (Bg.T @ Yf)
            den[:Kg] += 2.0 * lam_rows * (Bg.T @ BH)
    Hn = H * (num / torch.clamp(den, min=EPS))
    Hs = Hn
    if C is not None:
        Hn = torch.where(C[0] > 0, Hn, H)
        Hs = Hn * C[1]
    L = sum(y.shape[0] for y in Ys)
    Q = E = torch.zeros((0, n))
    if Ys:
        yhat = Bg @ Hn[:Kg]
        if loss_kl:
            yh = torch.clamp(yhat, min=EPS)
            Q = Yf / yh
            E = Yf * torch.log(torch.clamp(Q, min=EPS)) - Yf + yh
        else:
            Q, E = Yf, (Yf - yhat) ** 2
    small = torch.zeros(L + 1)  # the prediction-loss rows, the loss dot
    run = grid.T * grid.tiles_per_block
    for b in range(grid.n_part):
        part = torch.zeros_like(small)
        for c0 in range(b * run, min(n, (b + 1) * run), grid.T):
            cells = slice(c0, min(n, c0 + grid.T))
            part[:L] += torch.sum(E[:, cells], dim=1)
            part[-1] += torch.sum(WtX[:, cells] * Hn[:, cells])
        small += part
    XHt = (_emulate_hxt_bf16(X, Hs, K) if mma else _emulate_hxt_fp32(X, Hs)).T
    HHt, HHtU, rowsum, bnum = emulate_gram(Hn, None if C is None else C[1], Q if Ys else None)
    if not Ys:
        return Hn, XHt, HHt, small[-1]
    preds, bnums, bdens = kernels._split_stats(
        blocks, [y.shape[0] for y in Ys], bnum, rowsum, small[:L])
    extra = [HHtU] if C is not None else []
    return (Hn, XHt, HHt, *extra, small[-1], preds, bnums, bdens)


def _flat(out):
    return [np.asarray(t, dtype=np.float64) for o in out
            for t in (o if isinstance(o, tuple) else (o,))]


def _wide_problem(seed, n, K, dtype, counts):
    r = np.random.default_rng(seed)
    g = 40
    blocks = (K // 4, K // 8, K - K // 4 - K // 8)
    xdt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
           "int16": torch.int16}[dtype]
    if dtype == "int16":
        X = (r.poisson(3.0, (g, n)) * 300).astype(np.float32)
    elif dtype == "int8":
        X = r.poisson(3.0, (g, n)).astype(np.float32)
    else:
        X = r.random((g, n), dtype=np.float32)
    W = r.random((g, K), dtype=np.float32)
    H = r.random((K, n), dtype=np.float32) + 0.1
    Ys, Bs = [], []
    for c, nl in enumerate((2, 3)):
        y = np.zeros((nl, n), np.float32)
        y[r.integers(0, nl, n), np.arange(n)] = 1.0
        Ys.append(torch.from_numpy(y).to(xdt))
        Bs.append(torch.from_numpy(r.random((nl, blocks[c])).astype(np.float32) + 0.1))
    lam = torch.from_numpy((r.random(2) * 5 + 0.5).astype(np.float32))
    C = torch.from_numpy(r.integers(0, 4, (2, n)).astype(np.float32)) if counts else None
    Wt = torch.from_numpy(W)
    return (torch.from_numpy(X).to(xdt), Wt, torch.from_numpy(H), Wt.T @ Wt, Ys, Bs, lam,
            C, blocks)


@pytest.mark.parametrize("dtype", ["float32", "int16", "int8", "bfloat16"])
@pytest.mark.parametrize("K,n,counts,loss_kl", [(520, 17, False, True), (520, 1001, True, True),
                                                (1030, 1001, False, False),
                                                (1030, 300, True, True), (513, 17, True, True),
                                                (1030, 17, True, False)])
def test_wide_chain_emulation_matches_plain(dtype, K, n, counts, loss_kl):
    """The large-K chain's summation order against the plain version at
    rtol 1e-5, undrawn columns of H bit for bit; XHt against the plain
    product over the emulation's own Hs (an Hn one ulp off can round Hs to
    another bf16 value on int8/bf16 X).  K = 1030 takes, on float32/int16
    X, nine 128-row tiles of K, the last of 6 rows, and on int8/bf16 X
    five 256-row tiles of K, the last of 6 rows; gram_wide's last row tile
    has 6 rows there and 1 at K = 513.  HHt (and HHtU) come
    out exactly symmetric."""
    X, W, H, WtW, Ys, Bs, lam, C, blocks = _wide_problem(K + n, n, K, dtype, counts)
    want = list(kernels.fused_iteration_plain(X, W, H, WtW, Ys, Bs, lam, EPS, C,
                                              blocks=blocks, loss_kl=loss_kl))
    got = _emulate_wide(X, W, H, WtW, Ys, Bs, lam, C, blocks, loss_kl)
    Hs = got[0] if C is None else got[0] * C[1]
    want[1] = kernels.hxt_plain(X, Hs).T
    for a, b in zip(_flat(got), _flat(want), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
    assert torch.equal(got[2], got[2].T) and (not counts or torch.equal(got[3], got[3].T))
    if counts:
        undrawn = (C[0] == 0).numpy()
        assert undrawn.any()
        np.testing.assert_array_equal(got[0].numpy()[:, undrawn], H.numpy()[:, undrawn])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_wide_chain_emulation_matches_plain_without_covariates(dtype):
    """K2's large-K chain (no covariates, no iter_wide label rows)."""
    X, W, H, WtW, _, _, _, _, _ = _wide_problem(7, 1001, 600, dtype, False)
    want = list(kernels.fused_h_update_plain(X, W, H, WtW, EPS))
    got = _emulate_wide(X, W, H, WtW, [], [], None, None, (600,), True)
    want[1] = kernels.hxt_plain(X, got[0]).T
    for a, b in zip(_flat(got), _flat(want), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)


def test_iter_wide_stages_bg_where_it_fits():
    """iter_wide stages Bg (labels x guided components) in shared memory
    where it fits beside its label rows, and reads it through the cache
    where it does not; either way its shared memory fits a Hopper block up
    to about 190 labels, whatever K."""
    assert kernels.wide_stages_bg(5, 384, True) and kernels.wide_stages_bg(5, 1536, True)
    assert not kernels.wide_stages_bg(0, 384, False)
    assert not kernels.wide_stages_bg(60, 768, False)
    for L in (1, 5, 60, 190):
        for counts in (False, True):
            staged = kernels.wide_stages_bg(L, 768, counts)
            assert kernels.wide_smem_bytes(L, 768, counts, staged) <= kernels._MAX_SMEM
    assert kernels.wide_smem_bytes(200, 768, True, False) > kernels._MAX_SMEM


@pytest.mark.parametrize("n_iter", [0, 1, 2, 5])
def test_transform_steps_land_in_the_output(n_iter):
    """fused_transform's per-step path (K > 512): step i reads the last
    step's buffer (H0 first) and writes out when n_iter - 1 - i is even,
    else the scratch (csrc/fused_transform.cu: launch_steps), so the last
    step writes out; float64, so the loop is the plain version's."""
    r = np.random.default_rng(n_iter)
    K, n = 12, 9
    num2 = torch.from_numpy(r.random((K, n)))
    H0 = torch.from_numpy(r.random((K, n)) + 0.1)
    A = torch.from_numpy(r.random((K, K)))
    WtW2 = A @ A.T
    bufs = {"out": torch.full((K, n), np.nan, dtype=torch.float64),
            "scratch": torch.full((K, n), np.nan, dtype=torch.float64)}
    src = H0
    for it in range(n_iter):
        dst = bufs["out" if (n_iter - 1 - it) % 2 == 0 else "scratch"]
        dst.copy_(src * (num2 / torch.clamp(WtW2 @ src, min=EPS)))
        src = dst
    if n_iter == 0:
        bufs["out"].copy_(H0)
    want = kernels.fused_transform_plain(num2, H0, WtW2, EPS, n_iter=n_iter)
    assert torch.equal(bufs["out"], want)
    assert kernels.transform_path(513) == "steps"


@pytest.mark.parametrize("K", [513, 600, 1024, 1500, 2048])
def test_transform_takes_the_per_step_path_above_512(K):
    """Every K > 512 takes the per-step path (no tiled grid), and its steps
    over float64 at that K, ping-ponged between the two buffers with each
    sum over j formed in order from 0 (csrc/wtw_gemm.cuh), hold the plain
    loop at rtol 1e-12 over 3 steps."""
    assert kernels.transform_bucket(K) == 0 and kernels.transform_path(K) == "steps"
    with pytest.raises(ValueError, match="per-step"):
        kernels.transform_tiles_grid(K)
    r = np.random.default_rng(K)
    n = 5
    num2 = torch.from_numpy(r.random((K, n)))
    H0 = torch.from_numpy(r.random((K, n)) + 0.1)
    A = torch.from_numpy(r.random((K, K)))
    WtW2 = A @ A.T / K
    bufs = [torch.empty((K, n), dtype=torch.float64) for _ in range(2)]
    src = H0
    for it in range(3):
        d = torch.zeros((K, n), dtype=torch.float64)
        for j in range(K):
            d += WtW2[:, j:j + 1] * src[j:j + 1]
        dst = bufs[(3 - 1 - it) % 2]
        dst.copy_(src * (num2 / torch.clamp(d, min=EPS)))
        src = dst
    want = kernels.fused_transform_plain(num2, H0, WtW2, EPS, n_iter=3)
    np.testing.assert_allclose(bufs[0].numpy(), want.numpy(), rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# the estimator at K = 600
# ---------------------------------------------------------------------------


def _fit_both_600(ad, max_iter, fit_kw=None, **kw):
    jm = JaxALPINE(device="cpu", **KW600, **kw)
    tm = ALPINE(device="cpu", **KW600, **kw)
    ad_j, ad_t = ad.copy(), ad.copy()
    jm.fit(ad_j, KEYS, max_iter=max_iter, **(fit_kw or {}))
    tm.fit(ad_t, KEYS, max_iter=max_iter, **(fit_kw or {}))
    return jm, tm, ad_j, ad_t


@pytest.mark.parametrize("mode", ["joint", "als"])
def test_estimator_at_k600_matches_jax(jax_draws, mode):
    """K = 600 (blocks (400, 100, 100)), int8 counts, 5 iterations: the
    port's fit and transform against the JAX estimator's, loss rtol 5e-4,
    factors rtol 5e-3 (tests/test_torch_model.py:_check_fit_and_transform)."""
    jm, tm, ad_j, ad_t = _fit_both_600(_adata(integer=True), 5, use_als=mode == "als")
    assert tm.data_dtype_ == "int8"
    _check_fit_and_transform(jm, tm, ad_j, ad_t)


def test_weighted_fast_at_k600_matches_jax(jax_draws, jax_counts):
    jm, tm, ad_j, ad_t = _fit_both_600(_adata(integer=True), 5,
                                       fit_kw=dict(sampling_method="weighted_fast"))
    _check_fit_and_transform(jm, tm, ad_j, ad_t)


def test_transform_of_a_jax_fitted_k600_model(jax_draws):
    """A JAX fit at K = 600 carried into the port (convert.fitted_from_numpy)
    projects new data as the JAX model does."""
    jm = JaxALPINE(device="cpu", **KW600)
    jm.fit(_adata(integer=True).copy(), KEYS, max_iter=5)
    tm = fitted_from_numpy(
        ALPINE(device="cpu", **KW600), jm.get_decomposed_matrices(),
        jm.fe.encoded_labels, covariate_keys=KEYS, feature_names=jm.feature_names,
        max_iter=jm.max_iter, data_dtype=jm.data_dtype_)
    new = _adata(integer=True, seed=5)
    ad_j, ad_t = new.copy(), new.copy()
    jm.transform(ad_j)
    tm.transform(ad_t)
    for k in ["ALPINE_embedding"] + KEYS:
        _close(ad_t.obsm[k], ad_j.obsm[k], rtol=2e-4, atol=1e-6)

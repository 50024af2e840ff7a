"""The port's kernels (alpine_tpu_torch/ops/kernels.py) against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs.
The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py.

Tolerances follow tests/test_pallas.py: Hn rtol 1e-5 / atol 1e-6 (one
multiplicative step, sums in another order), the accumulated statistics
(XHt, HHt, Bnum, preds, lossdot) rtol 1e-4, the transform loop rtol 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpine_tpu.ops import pallas_kernels as pk
from alpine_tpu_torch.ops import kernels
from tests.torch_k_samples import COVER_KS

torch.set_num_threads(1)

G = 30
EPS = 1e-6
DTYPES = ("float32", "bfloat16", "int8", "int16")
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8, "int16": torch.int16}


def _x_values(r, dtype, shape):
    """float32 values that the storage dtype holds exactly (bf16 rounding
    is applied identically on both sides)."""
    if dtype in ("int8", "int16"):
        return r.poisson(3.0, shape).clip(0, 127).astype(np.float32)
    return r.random(shape, dtype=np.float32)


def _both(a, dtype):
    """The same values as a JAX array and a torch CPU tensor of `dtype`."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(np.ascontiguousarray(a)).to(_TORCH[dtype]))


def _problem(seed, n, blocks, n_labels, dtype):
    r = np.random.default_rng(seed)
    K = sum(blocks)
    X = _x_values(r, dtype, (G, n))
    W = r.random((G, K), dtype=np.float32)
    H = r.random((K, n), dtype=np.float32) + 0.1
    WtW = (W.T @ W).astype(np.float32)
    Ys, Bs = [], []
    for c, nl in enumerate(n_labels):
        y = np.zeros((nl, n), np.float32)
        y[r.integers(0, nl, n), np.arange(n)] = 1.0
        Ys.append(y)
        Bs.append(r.random((nl, blocks[c])).astype(np.float32) + 0.1)
    lam = (r.random(len(n_labels)) * 5 + 0.5).astype(np.float32)
    return X, W, H, WtW, Ys, Bs, lam


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=atol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


ITER_CASES = (
    [(d, (3, 4, 6), (2, 3), True) for d in DTYPES]
    + [(d, (3, 9), (2,), False) for d in DTYPES]
    + [("float32", (1, 1), (1,), True),
       ("float32", (2, 3, 4, 5), (2, 5, 3), False),
       ("float32", (2, 1), (17,), True)]
)


@pytest.mark.parametrize("dtype,blocks,n_labels,loss_kl", ITER_CASES)
def test_fused_iteration_plain_matches_pallas(dtype, blocks, n_labels, loss_kl):
    n = 256  # a multiple of the Pallas tile at this width (its contract)
    X, W, H, WtW, Ys, Bs, lam = _problem(4, n, blocks, n_labels, dtype)
    Xj, Xt = _both(X, dtype)
    Ysj = tuple(_both(y, dtype)[0] for y in Ys)
    Yst = [_both(y, dtype)[1] for y in Ys]
    want = pk.fused_iteration(
        Xj, jnp.asarray(W), jnp.asarray(H), jnp.asarray(WtW), Ysj,
        tuple(jnp.asarray(b) for b in Bs), jnp.asarray(lam), jnp.float32(EPS),
        blocks=blocks, loss_kl=loss_kl, interpret=True)
    got = kernels.fused_iteration(
        Xt, _t(W), _t(H), _t(WtW), Yst, [_t(b) for b in Bs], _t(lam), EPS,
        blocks=blocks, loss_kl=loss_kl)
    Hn, XHt, HHt, ld, preds, bnums, bdens = got
    _close(Hn, want[0], 1e-5, 1e-6)
    _close(XHt, want[1], 1e-4, 1e-4)
    _close(HHt, want[2], 1e-4, 1e-4)
    _close(ld, want[3], 1e-4)
    for c in range(len(n_labels)):
        _close(preds[c], want[4][c], 1e-4)
        _close(bnums[c], want[5][c], 1e-4, 1e-5)
        _close(bdens[c], want[6][c], 1e-4)
    assert kernels.launches["fused_iteration"] == 0  # plain runs never count


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_h_update_plain_matches_pallas(dtype):
    n = 300  # ragged: the Pallas kernel masks its last tile
    X, W, H, WtW, _, _, _ = _problem(1, n, (13,), (), dtype)
    Xj, Xt = _both(X, dtype)
    want = pk.fused_h_update(Xj, jnp.asarray(W), jnp.asarray(H),
                             jnp.asarray(WtW), jnp.float32(EPS), interpret=True)
    Hn, XHt, HHt, ld = kernels.fused_h_update(Xt, _t(W), _t(H), _t(WtW), EPS)
    _close(Hn, want[0], 1e-5, 1e-6)
    _close(XHt, want[1], 1e-4, 1e-4)
    _close(HHt, want[2], 1e-4, 1e-4)
    _close(ld, want[3], 1e-4)


@pytest.mark.parametrize("K", [11, 65, 100])  # the register path, and the tiled path's KP 128
def test_fused_transform_plain_matches_pallas(K):
    r = np.random.default_rng(2)
    W = r.random((G, K), dtype=np.float32)
    X = r.random((G, 300), dtype=np.float32)
    H0 = r.random((K, 300), dtype=np.float32) + 0.1
    num2 = (2.0 * (W.T @ X)).astype(np.float32)
    WtW2 = (2.0 * (W.T @ W)).astype(np.float32)
    want = pk.fused_transform(jnp.asarray(num2), jnp.asarray(H0),
                              jnp.asarray(WtW2), jnp.float32(EPS), n_iter=12,
                              interpret=True)
    got = kernels.fused_transform(_t(num2), _t(H0), _t(WtW2), EPS, n_iter=12)
    _close(got, want, 2e-4, 1e-6)


def test_transform_path_rule():
    """fused_transform's rule by K: the smallest bucket that holds K (the
    register path), the tiled path above the largest bucket up to K = 512,
    the per-step path above; every K >= 1 has one and K = 0 raises."""
    buckets = kernels._TRANSFORM_BUCKETS
    assert list(buckets) == sorted(set(buckets))
    # two lanes split a bucket's rows, each half read in 16-byte loads
    assert all(b % 8 == 0 for b in buckets)
    for K in COVER_KS + (2049, 2600, 5000):
        b = kernels.transform_bucket(K)
        path = kernels.transform_path(K)
        if K <= buckets[-1]:
            assert b == min(x for x in buckets if x >= K) and path == "registers", K
        elif K <= 512:  # the tiled path: a grid for every K above the largest bucket
            assert b == 0 and path == "tiles", K
            grid = kernels.transform_tiles_grid(K)
            assert (grid.T, grid.KP) in kernels._TRANSFORM_TILES, K
        else:  # one launch a step, for any K
            assert b == 0 and path == "steps", K
            with pytest.raises(ValueError, match="per-step"):
                kernels.transform_tiles_grid(K)
    assert kernels.transform_bucket(40) == 40  # the bench shape needs no padding
    for rule in (kernels.transform_bucket, kernels.transform_path):
        with pytest.raises(ValueError, match="K=0"):
            rule(0)


def test_transform_tiles_grid_fits_a_hopper_block():
    """transform_tiles' rule for every K: (T, KP) is an instantiation, the
    first that holds K; KP holds K in whole micro-tiles (TR threads × 2 rows
    a pair) and T whole 8-cell thread tiles; the chunk (a multiple of the
    kernel's 8 unrolled rows) divides KP; the block's shared memory with
    its two ring stages fits a Hopper block (and half an SM where two
    blocks share one); the register estimate stays under the hardware's 255
    (128 for two blocks an SM).  K = 300 takes 80 accumulators a thread.
    K > 512 takes the per-step path and has no tiled grid."""
    for K in range(1, 513):
        T, KP, J, S, smem = kernels.transform_tiles_grid(K)
        TR = kernels._THREADS // (T // 8)
        assert (T, KP) == next(t for t in kernels._TRANSFORM_TILES if t[1] >= K), K
        assert KP >= K and KP % (2 * TR) == 0 and KP - K < 2 * TR, K
        assert T % 8 == 0 and (T // 8) * TR == kernels._THREADS, K
        assert KP * T % (8 * kernels._THREADS) == 0, K  # eight loads of H a thread
        assert J == kernels._TRANSFORM_J and J % 8 == 0 and KP % J == 0, K
        assert S == kernels._TRANSFORM_STAGES == 2, K
        assert smem == kernels.transform_tiles_smem_bytes(KP, T, J, S)
        per_sm = kernels.transform_blocks_per_sm(T, KP)
        assert smem <= min(kernels._MAX_SMEM, kernels._SM_SMEM // per_sm
                           - kernels._BLOCK_SMEM_RESERVED), K
        assert kernels.transform_tiles_registers(T, KP) <= (255 if per_sm == 1 else 128), K
    assert kernels.transform_tiles_grid(300)[:3] == (64, 320, 32)
    assert 16 * kernels.transform_row_pairs(64, 320) == 80
    assert kernels.transform_tiles_grid(100)[:2] == (64, 128)
    assert kernels.transform_blocks_per_sm(64, 128) == 2
    assert kernels.transform_tiles_grid(512)[:2] == (32, 512)
    # the instantiations: one more pair of rows at T = 64 would not fit
    assert [kp for t, kp in kernels._TRANSFORM_TILES if t == 64] == [64 * g for g in range(1, 7)]
    assert kernels.transform_tiles_registers(64, 448) > 255
    with pytest.raises(ValueError, match="K=513 takes the per-step path"):
        kernels.transform_tiles_grid(513)
    with pytest.raises(ValueError, match="K=0"):
        kernels.transform_tiles_grid(0)


@pytest.mark.parametrize("K", [65, 100, 300, 512])
def test_transform_tiles_padding_is_exact(K):
    """transform_tiles pads WtW2ᵀ to KP × KP and H's rows to KP with zeros
    and never updates a padded row (forms no ratio there): the padded rows
    stay exactly 0 and the real rows keep the unpadded result (float64, so
    only the summation's zeros differ)."""
    KP = kernels.transform_tiles_grid(K).KP
    r = np.random.default_rng(K)
    n = 19
    num2 = torch.from_numpy(r.random((K, n)))
    H0 = torch.from_numpy(r.random((K, n)) + 0.1)
    A = torch.from_numpy(r.random((K, K)))
    WtW2 = A @ A.T
    Wt = torch.zeros((KP, KP), dtype=torch.float64)
    Wt[:K, :K] = WtW2.T
    H = torch.zeros((KP, n), dtype=torch.float64)
    H[:K] = H0
    for _ in range(20):
        d = Wt.T @ H
        H[:K] = H[:K] * (num2 / torch.clamp(d[:K], min=EPS))
    want = kernels.fused_transform_plain(num2, H0, WtW2, EPS, n_iter=20)
    assert torch.equal(H[K:], torch.zeros((KP - K, n), dtype=torch.float64))
    _close(H[:K], want, 1e-12)


@pytest.mark.parametrize("num_pad", [0.0, 1.0])
@pytest.mark.parametrize("K", [1, 9, 33, 61])
def test_transform_zero_padding_is_exact(K, num_pad):
    """The register path pads H0 and WtW2 with zeros up to K's bucket (and
    num2 with ones, which keeps its padded rows off the division's slow
    path): the padded rows stay exactly 0 and the real rows keep the
    unpadded result (float64, so only the summation's zeros differ)."""
    KB = kernels.transform_bucket(K)
    assert KB >= K
    r = np.random.default_rng(K)
    n = 37
    num2 = torch.from_numpy(r.random((K, n)))
    H0 = torch.from_numpy(r.random((K, n)) + 0.1)
    A = torch.from_numpy(r.random((K, K)))
    WtW2 = A @ A.T
    pad = lambda t, rows, cols, value=0.0: torch.nn.functional.pad(
        t, (0, cols - t.shape[1], 0, rows - t.shape[0]), value=value)
    want = kernels.fused_transform_plain(num2, H0, WtW2, EPS, n_iter=20)
    got = kernels.fused_transform_plain(pad(num2, KB, n, num_pad),
                                        pad(H0, KB, n), pad(WtW2, KB, KB), EPS,
                                        n_iter=20)
    assert torch.equal(got[K:], torch.zeros((KB - K, n), dtype=torch.float64))
    _close(got[:K], want, 1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
def test_iteration_tile_rule_fits_its_path(dtype):
    """For every K, fused_iteration's H update (iter_wide) takes 128-cell
    tiles on every X dtype, its shared memory independent of K and within a
    Hopper block's up to 8 labels over K - 1 guided components with counts;
    at K <= 512 the X passes' rings fit too (wtx_mma / hxt_mma on int8/bf16
    X, wtx_fma / hxt_fma on float32/int16); above, the large-K passes'
    (tests/test_torch_k1_fp32.py).  K = 0 raises."""
    xdt = _TORCH[dtype]
    mma = dtype in ("int8", "bfloat16")
    assert (xdt in kernels._MMA_XTYPES) == mma
    for K in COVER_KS:
        grid = kernels.iteration_grid(2000, 100_000, K, xdt)
        assert grid.T == kernels._WIDE_T == 128
        assert kernels.route(K) == ("tile" if K <= 512 else "wide")
        for L, counts in ((0, False), (8, False), (8, True)):
            assert kernels.wide_stages_bg(L, K - 1, counts) == (L > 0)
            assert kernels.wide_smem_bytes(L, K - 1, counts) <= kernels._MAX_SMEM
        if K > 512:
            continue
        if mma:
            assert kernels.hxt_smem_bytes(K, grid.GB, grid.S, xdt,
                                          grid.chunk) <= kernels._MAX_SMEM
            assert kernels.wtx_smem_bytes(K, grid.wtx_T, grid.wtx_S, xdt,
                                          grid.wtx_GC) <= kernels._MAX_SMEM
        else:
            assert kernels.hxt_fma_smem_bytes(K, grid.GB, grid.S, xdt,
                                              grid.chunk) <= kernels._MAX_SMEM
            assert kernels.wtx_fma_smem_bytes(K, grid.wtx_WR, grid.wtx_S,
                                              xdt) <= kernels._MAX_SMEM
    with pytest.raises(ValueError, match="K=0"):
        kernels.iteration_grid(2000, 100_000, 0, xdt)


def test_wrappers_reject_other_devices_and_bad_input():
    X = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.fused_h_update(X, X, X, X, EPS)
    with pytest.raises(ValueError, match="covariates"):
        kernels.fused_iteration(torch.zeros(4, 8), None, None, None, (), (),
                                None, EPS, blocks=(2,), loss_kl=True)

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


def test_fused_transform_plain_matches_pallas():
    r = np.random.default_rng(2)
    W = r.random((G, 11), dtype=np.float32)
    X = r.random((G, 300), dtype=np.float32)
    H0 = r.random((11, 300), dtype=np.float32) + 0.1
    num2 = (2.0 * (W.T @ X)).astype(np.float32)
    WtW2 = (2.0 * (W.T @ W)).astype(np.float32)
    want = pk.fused_transform(jnp.asarray(num2), jnp.asarray(H0),
                              jnp.asarray(WtW2), jnp.float32(EPS), n_iter=12,
                              interpret=True)
    got = kernels.fused_transform(_t(num2), _t(H0), _t(WtW2), EPS, n_iter=12)
    _close(got, want, 2e-4, 1e-6)


def test_tile_rule():
    assert kernels.tile_width(40) == 64
    assert kernels.tile_width(100) == 32
    assert kernels.tile_width(512) == 8
    for K in (1, 7, 64, 65, 129, 300, 512):
        assert K * kernels.tile_width(K) <= 4096
    with pytest.raises(ValueError, match="K=513"):
        kernels.tile_width(513)


def test_wrappers_reject_other_devices_and_bad_input():
    X = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.fused_h_update(X, X, X, X, EPS)
    with pytest.raises(ValueError, match="covariates"):
        kernels.fused_iteration(torch.zeros(4, 8), None, None, None, (), (),
                                None, EPS, blocks=(2,), loss_kl=True)

"""On an NVIDIA GPU: each CUDA kernel of alpine_tpu_torch against its plain
PyTorch version on the same tensors.  Skipped where there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: rtol 1e-4 / atol 1e-5 for one fused iteration (fp32 sums in
another order than cuBLAS), rtol 2e-4 for the 20-step transform loop.
"""

import numpy as np
import pytest
import torch

from alpine_tpu_torch.ops import kernels

EPS = 1e-6
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8, "int16": torch.int16}
ITER_CASES = (
    [(d, (3, 4, 6), (2, 3), True) for d in DTYPES]
    + [(d, (3, 9), (2,), False) for d in DTYPES]
    + [("float32", (1, 1), (1,), True),
       ("float32", (2, 3, 4, 5), (2, 5, 3), False),
       ("float32", (2, 1), (17,), True),
       ("int8", (5, 5, 30), (2, 3), True),
       ("int8", (40, 60, 100), (4, 7), True)]
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _problem(seed, g, n, blocks, n_labels, dtype, dev):
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    K = sum(blocks)
    if dtype in ("int8", "int16"):
        X = r.poisson(3.0, (g, n)).clip(0, 127).astype(np.float32)
    else:
        X = r.random((g, n), dtype=np.float32)
    W = r.random((g, K), dtype=np.float32)
    H = r.random((K, n), dtype=np.float32) + 0.1
    Ys, Bs = [], []
    for c, nl in enumerate(n_labels):
        y = np.zeros((nl, n), np.float32)
        y[r.integers(0, nl, n), np.arange(n)] = 1.0
        Ys.append(t(y).to(DTYPES[dtype]))
        Bs.append(t(r.random((nl, blocks[c])).astype(np.float32) + 0.1))
    lam = t((r.random(len(n_labels)) * 5 + 0.5).astype(np.float32))
    Wt = t(W)
    return t(X).to(DTYPES[dtype]), Wt, t(H), Wt.T @ Wt, Ys, Bs, lam


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want.double().cpu().numpy(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,blocks,n_labels,loss_kl", ITER_CASES)
def test_fused_iteration_cuda_matches_plain(cuda, dtype, blocks, n_labels,
                                            loss_kl):
    X, W, H, WtW, Ys, Bs, lam = _problem(6, 70, 1000, blocks, n_labels, dtype,
                                         cuda)
    before = kernels.launches["fused_iteration"]
    got = kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS,
                                  blocks=blocks, loss_kl=loss_kl)
    torch.cuda.synchronize()
    assert kernels.launches["fused_iteration"] == before + 1
    want = kernels.fused_iteration_plain(X, W, H, WtW, Ys, Bs, lam, EPS,
                                         blocks=blocks, loss_kl=loss_kl)
    assert kernels.launches["fused_iteration"] == before + 1
    for a, b in zip(got[:4], want[:4]):
        _close(a, b, 1e-4, 1e-5)
    for ga, wa in zip(got[4:], want[4:]):
        for a, b in zip(ga, wa):
            _close(a, b, 1e-4, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_h_update_cuda_matches_plain(cuda, dtype):
    X, W, H, WtW, _, _, _ = _problem(7, 50, 777, (13,), (), dtype, cuda)
    got = kernels.fused_h_update(X, W, H, WtW, EPS)
    want = kernels.fused_h_update_plain(X, W, H, WtW, EPS)
    for a, b in zip(got, want):
        _close(a, b, 1e-4, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("K,n", [(40, 1000), (7, 333), (300, 500)])
def test_fused_transform_cuda_matches_plain(cuda, K, n):
    r = np.random.default_rng(8)
    t = lambda a: torch.from_numpy(a).to(cuda)
    num2 = t(r.random((K, n), dtype=np.float32))
    H0 = t(r.random((K, n), dtype=np.float32) + 0.1)
    A = r.random((K, K), dtype=np.float32)
    WtW2 = t((A @ A.T).astype(np.float32))
    got = kernels.fused_transform(num2, H0, WtW2, EPS, n_iter=20)
    want = kernels.fused_transform_plain(num2, H0, WtW2, EPS, n_iter=20)
    _close(got, want, 2e-4, 1e-6)


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_path(cuda, monkeypatch):
    """A CUDA tensor launches the kernel or raises: a failed build is an
    error, not a silent fallback."""
    from alpine_tpu_torch.ops import _build

    def broken(name):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "entry", broken)
    X, W, H, WtW, _, _, _ = _problem(1, 20, 64, (4,), (), "float32", cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.fused_h_update(X, W, H, WtW, EPS)

"""The large-K fp32 product A B (csrc/wtw_gemm.cuh: wtw_gemm) on the CPU.

On the card it is the K1/K2/K4 chain's D = WᵀW H (its store epilogue) and
K3's per-step path above K = 512 (its update epilogue): A is transposed
once a call into a K x K scratch, both operands come through a cp.async
ring of stages of a chunk of j, and the K / 128 row tiles of one 128-cell
tile run back to back; the launch alone decides its grid, chunk and
stages.  The CUDA kernel runs only on the card (tests/test_torch_cuda.py
holds it bit for bit against the design before it,
scripts/wtw_gemm_variants.cu); here:

- the plain version against the JAX package's product (the Pallas
  kernels' ``jnp.dot(WtW, H)`` at HIGHEST precision), rtol 1e-5;
- the ring the header declares (``kernels.wtw_design``) fits two blocks
  an SM with no term in K; a block an output tile;
- the transposed scratch is K x K for every K in 513 .. 4096;
- both callers (the chain, through K2, and K3's per-step path) and the
  wrapper allocate that K x K scratch and pass it to their C entry (the
  entry replaced by a recorder), the wrapper counts its launch and raises
  on a launch error, a wrong shape, dtype, device or layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from alpine_tpu_torch.ops import kernels

from .test_torch_kernels import _close, _t

torch.set_num_threads(1)

EPS = 1e-6
HOPPER_BLOCK_SMEM = 232448  # bytes a Hopper block may ask for (227 KB)
ALL_WIDE_K = range(513, 4097)


@pytest.mark.parametrize("K,n", [(513, 17), (768, 1001), (1030, 300)])
def test_plain_matches_the_jax_product(K, n):
    r = np.random.default_rng(K + n)
    A = r.random((K, K), dtype=np.float32)
    B = r.random((K, n), dtype=np.float32) + 0.05
    want = jnp.dot(jnp.asarray(A), jnp.asarray(B), precision=lax.Precision.HIGHEST)
    got = kernels.wtw_gemm(_t(A), _t(B))
    assert got.shape == (K, n) and got.dtype == torch.float32
    _close(got, np.asarray(want), 1e-5)
    assert torch.equal(got, kernels.wtw_gemm_plain(_t(A), _t(B)))


def test_ring_fits_two_blocks_an_sm():
    """The kernel's ring, as csrc/wtw_gemm.cuh declares it: stages of a
    chunk of j of Aᵀ's and of B's tiles, fp32, with no term in K or n,
    under a Hopper block's 227 KB, and two blocks (its launch bounds) in an
    SM's 228 KB with 1 KB reserved each."""
    d = kernels.wtw_design()
    assert d["tile"] == [128, 128] and d["chunk"] % 8 == 0 and 2 <= d["stages"] <= 8
    smem = 4 * d["stages"] * d["chunk"] * sum(d["tile"])
    assert smem <= HOPPER_BLOCK_SMEM and 2 * (smem + 1024) <= 233472


@pytest.mark.parametrize("K,n,blocks", [(513, 17, 5), (768, 100_000, 6 * 782),
                                        (2048, 1001, 16 * 8)])
def test_design_counts_a_block_an_output_tile(K, n, blocks):
    assert kernels.wtw_design(K, n)["blocks"] == blocks


def test_transposed_scratch_is_k_by_k_at_every_k():
    for K in ALL_WIDE_K:
        assert kernels.wtw_scratch_shape(K) == (K, K)
        assert kernels.transform_path(K) == "steps"
        assert kernels.transform_scratch_shapes(K, 1001) == ((K, 1001), (K, K))


def _recorder(monkeypatch, rc=0):
    """Route the wrappers' CUDA branch onto CPU tensors: each C entry is
    replaced by a recorder of its arguments, and every tensor torch.empty
    makes is kept by its address."""
    calls, made = [], {}
    real_empty = torch.empty

    def empty(*args, **kw):
        t = real_empty(*args, **kw)
        made[t.data_ptr()] = t
        return t

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(kernels, "_cuda_or_cpu", lambda t: True)
    monkeypatch.setattr(kernels, "_on_device", lambda dev, fn, *a: fn(*a))
    monkeypatch.setattr(kernels, "_stream", lambda dev: 0)
    monkeypatch.setattr(kernels._build, "entry",
                        lambda name: lambda *a: calls.append((name, a)) or rc)
    return calls, made


@pytest.mark.parametrize("K", [513, 768, 2048, 4096])
def test_callers_pass_a_k_by_k_transposed_scratch(monkeypatch, K):
    calls, made = _recorder(monkeypatch)
    r = np.random.default_rng(K)
    g, n = 6, 17
    X = _t(r.integers(0, 5, (g, n), dtype=np.int8))
    W = _t(r.random((g, K), dtype=np.float32))
    H = _t(r.random((K, n), dtype=np.float32))
    WtW = _t(r.random((K, K), dtype=np.float32))
    kernels.reset_launches()
    kernels.fused_h_update(X, W, H, WtW, EPS)  # K2: the large-K chain
    kernels.fused_transform(H, H, WtW, EPS, n_iter=3)  # K3's per-step path
    kernels.wtw_gemm(WtW, H)
    (chain, a_chain), (steps, a_steps), (alone, a_alone) = calls
    assert (chain, steps, alone) == ("fused_iteration", "fused_transform", "wtw_gemm")
    # the chain: ..., wpart, arrivals, WᵀW transposed, stream
    assert tuple(made[a_chain[-2]].shape) == (K, K)
    # K3: ..., eps, H's second buffer, WtW2 transposed, out, stream
    assert tuple(made[a_steps[12]].shape) == (K, n)
    assert tuple(made[a_steps[13]].shape) == (K, K)
    # alone: A, B, K, n, Aᵀ, out, stream
    assert a_alone[2:4] == (K, n) and tuple(made[a_alone[4]].shape) == (K, K)
    assert tuple(made[a_alone[5]].shape) == (K, n)
    assert kernels.launches["wtw_gemm"] == 2  # the chain's store and its own
    assert kernels.launches["fused_transform"] == 1


def test_wrapper_raises_on_a_launch_error(monkeypatch):
    _recorder(monkeypatch, rc=1)
    kernels.reset_launches()
    A, B = torch.ones((520, 520)), torch.ones((520, 9))
    with pytest.raises(RuntimeError, match="wtw_gemm kernel failed to launch: CUDA error 1"):
        kernels.wtw_gemm(A, B)
    assert kernels.launches["wtw_gemm"] == 0


@pytest.mark.parametrize("case", ["A shape", "B shape", "A dtype", "B dtype", "A device",
                                  "B layout"])
def test_wrapper_checks_its_operands(monkeypatch, case):
    calls, _ = _recorder(monkeypatch)
    K, n = 520, 9
    A, B = torch.ones((K, K)), torch.ones((K, n))
    if case == "A shape":
        A = torch.ones((K, K + 1))
    elif case == "B shape":
        B = torch.ones((K + 1, n))
    elif case == "A dtype":
        A = A.double()
    elif case == "B dtype":
        B = B.half()
    elif case == "A device":
        A = torch.ones((K, K), device="meta")
    else:
        B = torch.ones((n, K)).T
    with pytest.raises(ValueError):
        kernels.wtw_gemm(A, B)
    assert not calls

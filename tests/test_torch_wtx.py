"""The grid rule of P2 ``wtx``'s bf16 path (``kernels.wtx_grid``) on the CPU.

The CUDA kernel (csrc/x_passes.cu: round_w, then wtx_mma) runs only on the
card; these tests hold what it is given: every cell covered once by tiles
that are multiples of 16, all of K in one pass within 48 accumulators a
thread, shared memory within a Hopper block's limit with two blocks an SM
for every K, the bench shape's grid pinned, and an emulation of the
kernel's arithmetic over that grid (W rounded to bf16, exact products, fp32
sums chunk by chunk over the genes) equal to ``wtx_plain`` at rtol 1e-5
(fp32 sums of positive terms in another order).  The float32/int16 path
takes ``wtx_fma_grid`` (tests/test_torch_fp32_passes.py).
"""

import numpy as np
import pytest
import torch

from alpine_tpu_torch.ops import kernels
from alpine_tpu_torch.ops.mu import round_partner

MMA = {"int8": torch.int8, "bfloat16": torch.bfloat16}
KS = (1, 5, 13, 30, 64, 65, 300, 512)
SLOTS = 2 * kernels._SMS  # two blocks an SM


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("g,n", [(2000, 100_000), (70, 17), (300, 50_001),
                                 (300, 50_016), (20_000, 1001), (1, 64)])
@pytest.mark.parametrize("K", KS)
def test_wtx_grid_covers_each_cell_once(dtype, g, n, K):
    T, WR, GC, S, blocks = kernels.wtx_grid(g, n, K, MMA[dtype])
    assert T % 16 == 0 and T // (8 // WR) % 16 == 0 and GC in (32, 64)
    assert WR in (1, 2, 4, 8) and 2 <= S <= 8
    seen = np.zeros(n, np.int64)
    for b in range(blocks):
        assert b * T < n  # no empty tile
        seen[b * T:(b + 1) * T] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype", list(MMA))
def test_wtx_grid_fits_shared_memory_and_accumulators(dtype):
    """For every K the kernel takes: one pass over X (every fragment row of
    Kp held by some warp row, at most 6 a warp), at most 48 accumulators a
    thread, no idle warp row, and the ring within half an SM's shared
    memory (two blocks an SM): 64 genes a stage where two such stages fit,
    else 32, with the most stages that fit."""
    xdt = MMA[dtype]
    budget = min(kernels._MAX_SMEM, kernels._SM_SMEM // 2 - 1024)
    for n in (100_000, 5040):
        for K in range(1, 513):
            T, WR, GC, S, blocks = kernels.wtx_grid(2000, n, K, xdt)
            rows = kernels._pad16(K) // 16
            frags = -(-rows // WR)
            assert frags <= 6 and WR <= rows
            assert frags * (T // (8 // WR) // 16) * 8 <= 48
            smem = kernels.wtx_smem_bytes(K, T, S, xdt, GC)
            assert smem <= budget <= kernels._MAX_SMEM
            assert S == 8 or kernels.wtx_smem_bytes(K, T, S + 1, xdt, GC) > budget
            assert GC == 64 or kernels.wtx_smem_bytes(K, T, 2, xdt, 64) > budget


def test_wtx_grid_at_the_bench_shape():
    """100k cells x 2,000 genes: at k = 5 and 30 (ALS's blocks) tiles of
    384 cells, 261 blocks for 264 slots (one wave), all 8 warps side by
    side (each 48 cells), 64 genes a ring stage; int8 X fits 4 / 3 stages,
    bf16 X 2.  At K = 40 tiles of 192 cells in 2 rows of warps: 521
    blocks, two waves.  At K = 512 a stage of 64 genes no longer fits twice
    in half an SM: 32 genes a stage."""
    assert kernels.wtx_grid(2000, 100_000, 5, torch.int8) == (384, 1, 64, 4, 261)
    assert kernels.wtx_grid(2000, 100_000, 30, torch.int8) == (384, 1, 64, 3, 261)
    assert kernels.wtx_grid(2000, 100_000, 5, torch.bfloat16) == (384, 1, 64, 2, 261)
    assert kernels.wtx_grid(2000, 100_000, 30, torch.bfloat16) == (384, 1, 64, 2, 261)
    assert kernels.wtx_grid(2000, 100_000, 40, torch.int8) == (192, 2, 64, 5, 521)
    assert kernels.wtx_grid(2000, 100_000, 512, torch.int8) == (16, 8, 32, 2, 6250)
    waves = lambda K: -(-kernels.wtx_grid(2000, 100_000, K, torch.int8)[4] // SLOTS)
    assert (waves(5), waves(30), waves(40)) == (1, 1, 2)


def test_wtx_grid_rejects_what_the_kernel_does_not_take():
    for xdt in (torch.float32, torch.int16):
        with pytest.raises(ValueError, match="int8 and bf16"):
            kernels.wtx_grid(100, 100, 8, xdt)
    for K in (0, 513):
        with pytest.raises(ValueError):
            kernels.wtx_grid(100, 100, K, torch.int8)


def _emulate_wtx(X, W, K):
    """wtx_mma's arithmetic in PyTorch over wtx_grid's tiles: W rounded to
    bf16 (round_w), and each tile's K x T outputs summed over the genes in
    chunks of GC, 16 genes a product, in gene order."""
    g, n = X.shape
    T, _, GC, _, blocks = kernels.wtx_grid(g, n, K, X.dtype)
    Wb, Xf = round_partner(W, X.dtype).T, X.float()
    out = torch.zeros((K, n), dtype=torch.float32)
    for b in range(blocks):
        c0, c1 = b * T, min(n, (b + 1) * T)
        for g0 in range(0, g, GC):
            for k0 in range(g0, min(g, g0 + GC), 16):
                k1 = min(g, k0 + 16)
                out[:, c0:c1] += Wb[:, k0:k1] @ Xf[k0:k1, c0:c1]
    return out


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("n", [17, 1001, 5040])
@pytest.mark.parametrize("K", KS)
def test_wtx_grid_emulation_matches_plain(dtype, n, K):
    r = np.random.default_rng(K * 11 + n)
    g = 150  # not a multiple of the 32-gene chunk
    if dtype == "int8":
        X = torch.from_numpy(r.poisson(3.0, (g, n)).clip(0, 127).astype(np.int8))
    else:
        X = torch.from_numpy(r.random((g, n), dtype=np.float32)).to(torch.bfloat16)
    W = torch.from_numpy(r.random((g, K), dtype=np.float32))
    want = kernels.wtx_plain(X, W)
    got = _emulate_wtx(X, W, K)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=0)
    # the CPU wrapper is the plain version
    assert torch.equal(kernels.wtx(X, W), want)

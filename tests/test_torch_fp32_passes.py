"""The grid rules of ALS's X passes on float32 and int16 X
(``kernels.hxt_fma_grid`` for P1 ``hxt``, ``kernels.wtx_fma_grid`` for P2
``wtx``) on the CPU.

The CUDA kernels (csrc/x_passes.cu: hxt_fma, wtx_fma) run only on the card;
these tests hold what they are given: every gene and cell covered once,
shared memory within a Hopper block's limit and accumulators within the
register budget for every K in 1..512 (above, tests/test_torch_fma_wide.py
holds the large-K kernels), the bench shape's grids pinned, and a
PyTorch emulation of each kernel's summation order (micro-tiles, the warps'
split of each chunk's cells or genes added in warp order, partials in split
order) equal to ``hxt_plain`` / ``wtx_plain`` at rtol 1e-5 (fp32 sums of
positive terms in another order); on the CPU the wrappers return the plain
version bit for bit.
"""

import numpy as np
import pytest
import torch

from alpine_tpu_torch.ops import kernels
from tests.torch_k_samples import COVER_KS

FP32 = {"float32": torch.float32, "int16": torch.int16}
KS = (1, 5, 13, 30, 40, 64, 65, 300, 512)
TILE_KS = [K for K in COVER_KS if K <= 512]
SHAPES = [(2000, 100_000), (70, 17), (300, 50_001), (300, 50_016), (20_000, 1001),
          (1, 64)]
HALF_SM = min(kernels._MAX_SMEM, kernels._SM_SMEM // 2 - 1024)


def _x(r, g, n, dtype):
    """Counts above 127 for int16 (int16 is chosen for them), fractions for
    float32."""
    if dtype == "int16":
        return torch.from_numpy((r.poisson(3.0, (g, n)) * 300).astype(np.int16))
    return torch.from_numpy(r.random((g, n), dtype=np.float32))


# ---------------------------------------------------------------------------
# P1 hxt
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(FP32))
@pytest.mark.parametrize("g,n", SHAPES)
@pytest.mark.parametrize("K", KS)
def test_hxt_fma_grid_covers_each_gene_and_cell_once(dtype, g, n, K):
    GB, n_split, cps, S, chunk = kernels.hxt_fma_grid(g, n, K, FP32[dtype])
    assert chunk in (64, 32) and cps % chunk == 0 and GB in (32, 64, 128)
    assert 2 <= S <= 8
    seen_g = np.zeros(g, np.int64)
    for g0 in range(0, g, GB):
        seen_g[g0:g0 + GB] += 1
    seen_c = np.zeros(n, np.int64)
    for s in range(n_split):
        assert s * cps < n  # no empty split
        seen_c[s * cps:(s + 1) * cps] += 1
    assert (seen_g == 1).all() and (seen_c == 1).all()


@pytest.mark.parametrize("dtype", list(FP32))
def test_hxt_fma_grid_fits_shared_memory_and_registers(dtype):
    """For every K the kernel takes: all of K in one pass (8 warp-row lanes
    x MK rows x WK warp rows reach K, MK <= 7, 8 only at 8 warp rows), at
    most 8 x 8 accumulators a thread, 8 warps = Q x WK x WG, shared memory
    within a Hopper block's limit with 64-cell chunks where two stages fit
    half an SM and the most stages that fit, two blocks an SM up to some K
    and one above it, and a wide grid within one wave on 132 SMs."""
    xdt = FP32[dtype]
    two_per_sm = []
    for K in TILE_KS:
        GB, n_split, cps, S, chunk = kernels.hxt_fma_grid(2000, 100_000, K, xdt)
        WK, MK = kernels.hxt_fma_rows(K)
        WG = GB // 32
        assert 8 * WK * MK >= K and 8 * MK <= 64 and (MK <= 7 or WK == 8)
        assert WK == 1 or -(-K // (4 * WK)) > 7  # the fewest warp rows
        assert 8 % (WK * WG) == 0 and WG == min(4, 8 // WK)
        smem = kernels.hxt_fma_smem_bytes(K, GB, S, xdt, chunk)
        assert smem <= kernels._MAX_SMEM
        per_sm = 2 if smem <= HALF_SM and MK <= 7 else 1
        two_per_sm.append(per_sm == 2)
        budget = min(kernels._MAX_SMEM, kernels._SM_SMEM // per_sm - 1024)
        if per_sm == 2:  # the wider chunk where two of its stages fit
            assert chunk == 64 or kernels.hxt_fma_smem_bytes(K, GB, 2, xdt, 64) > HALF_SM
            assert S == 8 or kernels.hxt_fma_smem_bytes(K, GB, S + 1, xdt, chunk) > budget
        # one wave
        assert -(-2000 // GB) * n_split <= max(-(-2000 // GB), 132 * per_sm)
    first_one = two_per_sm.index(False)
    assert first_one > 128 and not any(two_per_sm[first_one:])


def test_hxt_fma_grid_at_the_bench_shape():
    """100k cells x 2,000 genes, K = 40: one warp row of 5 rows a thread,
    128 genes a block (16 gene blocks) and two cell groups of warps, 16
    splits of 98 chunks of 64 cells, one wave of 256 blocks at two an SM,
    two ring stages for float32 and int16 X.  GB narrows as K needs more
    warp rows."""
    assert kernels.hxt_fma_grid(2000, 100_000, 40, torch.float32) == (128, 16, 6272, 2, 64)
    assert kernels.hxt_fma_grid(2000, 100_000, 40, torch.int16) == (128, 16, 6272, 2, 64)
    assert kernels.hxt_fma_rows(40) == (1, 5)
    assert [kernels.hxt_fma_grid(2000, 100_000, K, torch.float32)[0]
            for K in (64, 65, 112, 113, 224, 225, 512)] == [128, 128, 128, 64, 64, 32, 32]


def test_hxt_fma_grid_rejects_what_the_kernel_does_not_take():
    """int8/bf16 X and K = 0 raise; K = 513 .. 2048 raise, naming the
    large-K kernel's rule (``hxt_fma_wide_grid``)."""
    for xdt in (torch.int8, torch.bfloat16):
        with pytest.raises(ValueError, match="float32 and int16"):
            kernels.hxt_fma_grid(100, 100, 8, xdt)
    with pytest.raises(ValueError, match="K=0"):
        kernels.hxt_fma_grid(100, 100, 0, torch.float32)
    for K in (513, 600, 768, 1024, 1025, 2048):
        with pytest.raises(ValueError, match="hxt_fma_wide_grid"):
            kernels.hxt_fma_grid(100, 100, K, torch.float32)


def _emulate_hxt(X, H, K):
    """hxt_fma's summation order in PyTorch over hxt_fma_grid's grid: warp
    group q of a block sums cells q CW / Q .. (q + 1) CW / Q - 1 of every
    chunk of its split; the Q tiles are added in q order into the split's
    partial, and the partials in split order."""
    g, n = X.shape
    GB, n_split, cps, _, CW = kernels.hxt_fma_grid(g, n, K, X.dtype)
    WK, _ = kernels.hxt_fma_rows(K)
    Q = 8 // (WK * (GB // 32))
    Xf = X.float()
    out = torch.zeros((K, g), dtype=torch.float32)
    for s in range(n_split):
        cells = torch.arange(s * cps, min(n, (s + 1) * cps))
        part = torch.zeros((K, g), dtype=torch.float32)
        for q in range(Q):
            mine = cells[(cells % CW) // (CW // Q) == q]
            for g0 in range(0, g, GB):
                part[:, g0:g0 + GB] += H[:, mine] @ Xf[g0:g0 + GB, mine].T
        out += part
    return out


@pytest.mark.parametrize("dtype", list(FP32))
@pytest.mark.parametrize("n", [17, 1001, 5040])
@pytest.mark.parametrize("K", KS)
def test_hxt_fma_emulation_matches_plain(dtype, n, K):
    r = np.random.default_rng(K * 7 + n)
    g = 150  # two gene blocks at GB = 128, ragged
    X = _x(r, g, n, dtype)
    H = torch.from_numpy(r.random((K, n), dtype=np.float32) + 0.1)
    want = kernels.hxt_plain(X, H)
    np.testing.assert_allclose(_emulate_hxt(X, H, K).numpy(), want.numpy(),
                               rtol=1e-5, atol=0)
    # the CPU wrapper is the plain version
    assert torch.equal(kernels.hxt(X, H), want)


# ---------------------------------------------------------------------------
# P2 wtx
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(FP32))
@pytest.mark.parametrize("g,n", SHAPES)
@pytest.mark.parametrize("K", KS)
def test_wtx_fma_grid_covers_each_cell_once(dtype, g, n, K):
    T, LK, GC, S, blocks = kernels.wtx_fma_grid(g, n, K, FP32[dtype])
    assert GC == 32 and LK in (1, 2, 4, 8, 16) and T == 12 * 32 // LK
    assert 2 <= S <= 8
    seen = np.zeros(n, np.int64)
    for b in range(blocks):
        assert b * T < n  # no empty tile
        seen[b * T:(b + 1) * T] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype", list(FP32))
def test_wtx_fma_grid_fits_shared_memory_and_registers(dtype):
    """For every K the kernel takes: all of K in one pass (LK lanes x MK
    rows x WK warp rows reach K, MK <= 6), 12 x MK <= 72 accumulators a
    thread, the fewest lanes along K, two blocks an SM where two stages fit
    half an SM (else one), with the most stages that fit."""
    xdt = FP32[dtype]
    for K in TILE_KS:
        T, LK, GC, S, blocks = kernels.wtx_fma_grid(2000, 100_000, K, xdt)
        WK, MK = kernels.wtx_fma_rows(K, LK)
        assert WK * LK * MK >= K and MK <= 6 and 12 * MK <= 72
        assert LK == 1 or K > 8 * (LK // 2) * 6  # the fewest lanes along K
        assert 8 % WK == 0 and blocks == -(-100_000 // T)
        smem = kernels.wtx_fma_smem_bytes(K, LK, S, xdt)
        assert smem <= kernels._MAX_SMEM
        if smem > HALF_SM:  # one block an SM only where two stages pass half an SM
            assert kernels.wtx_fma_smem_bytes(K, LK, 2, xdt) > HALF_SM
        budget = HALF_SM if smem <= HALF_SM else kernels._MAX_SMEM
        assert S == 8 or kernels.wtx_fma_smem_bytes(K, LK, S + 1, xdt) > budget


def test_wtx_fma_grid_at_the_bench_shape():
    """100k cells x 2,000 genes: for K <= 48 (ALS's blocks k = 5 and 30)
    tiles of 384 cells, 261 blocks for 264 slots (one wave at two an SM);
    k = 5 is one warp row whose 8 warps split each chunk's 32 genes, k = 30
    eight warp rows of 4 rows a thread (32 computed); two ring stages of 32
    genes.  K = 512: 16 lanes along K, tiles of 24 cells."""
    for xdt in (torch.float32, torch.int16):
        for k in (5, 30):
            assert kernels.wtx_fma_grid(2000, 100_000, k, xdt) == (384, 1, 32, 2, 261)
    assert kernels.wtx_fma_rows(5, 1) == (1, 5) and kernels.wtx_fma_rows(30, 1) == (8, 4)
    assert kernels.wtx_fma_grid(2000, 100_000, 512, torch.float32) == (24, 16, 32, 3, 4167)


def test_wtx_fma_grid_rejects_what_the_kernel_does_not_take():
    """int8/bf16 X and K = 0 raise; K = 513 .. 2048 raise, naming the
    large-K kernel's rule (``wtx_fma_wide_grid``)."""
    for xdt in (torch.int8, torch.bfloat16):
        with pytest.raises(ValueError, match="float32 and int16"):
            kernels.wtx_fma_grid(100, 100, 8, xdt)
    with pytest.raises(ValueError, match="K=0"):
        kernels.wtx_fma_grid(100, 100, 0, torch.float32)
    for K in (513, 600, 768, 1024, 1025, 2048):
        with pytest.raises(ValueError, match="wtx_fma_wide_grid"):
            kernels.wtx_fma_grid(100, 100, K, torch.float32)


def _emulate_wtx(X, W, K):
    """wtx_fma's summation order in PyTorch over wtx_fma_grid's tiles: warp
    group q sums genes q GC / Q .. (q + 1) GC / Q - 1 of every chunk of 32
    genes, and the Q tiles are added in q order."""
    g, n = X.shape
    T, LK, GC, _, blocks = kernels.wtx_fma_grid(g, n, K, X.dtype)
    WK, _ = kernels.wtx_fma_rows(K, LK)
    Q = 8 // WK
    genes = torch.arange(g)
    Xf = X.float()
    out = torch.zeros((K, n), dtype=torch.float32)
    for b in range(blocks):
        c0, c1 = b * T, min(n, (b + 1) * T)
        for q in range(Q):
            mine = genes[(genes % GC) // (GC // Q) == q]
            out[:, c0:c1] += W[mine].T @ Xf[mine, c0:c1]
    return out


@pytest.mark.parametrize("dtype", list(FP32))
@pytest.mark.parametrize("n", [17, 1001, 5040])
@pytest.mark.parametrize("K", KS)
def test_wtx_fma_emulation_matches_plain(dtype, n, K):
    r = np.random.default_rng(K * 11 + n)
    g = 150  # not a multiple of the 16-gene chunk
    X = _x(r, g, n, dtype)
    W = torch.from_numpy(r.random((g, K), dtype=np.float32))
    want = kernels.wtx_plain(X, W)
    np.testing.assert_allclose(_emulate_wtx(X, W, K).numpy(), want.numpy(),
                               rtol=1e-5, atol=0)
    # the CPU wrapper is the plain version
    assert torch.equal(kernels.wtx(X, W), want)

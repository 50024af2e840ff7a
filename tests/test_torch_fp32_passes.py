"""The grid rules of ALS's X passes on float32 and int16 X
(``kernels.hxt_fma_grid`` for P1 ``hxt``, ``kernels.wtx_fma_grid`` for P2
``wtx``) on the CPU.

The CUDA kernels (csrc/x_passes.cu: hxt_fma, wtx_fma) run only on the card;
these tests hold what they are given: every gene and cell covered once,
shared memory within a Hopper block's limit and accumulators within the
register budget for every K in 1..512 (and a sample of the large-K route's
ranges of K up to 2048), the bench shape's grids pinned, and a
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
KS = (1, 5, 13, 30, 40, 64, 65, 300, 512, 600, 768, 2048)
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
    and one above it, and a wide grid within one wave on 132 SMs.  Above
    K = 512 the same for each range of KR <= 512 rows (a grid layer)."""
    xdt = FP32[dtype]
    two_per_sm = []
    for K in COVER_KS:
        GB, n_split, cps, S, chunk = kernels.hxt_fma_grid(2000, 100_000, K, xdt)
        R, KR = kernels.k_ranges(K)
        WK, MK = kernels.hxt_fma_rows(KR)
        WG = GB // 32
        assert 8 * WK * MK >= KR and 8 * MK <= 64 and (MK <= 7 or WK == 8)
        assert WK == 1 or -(-KR // (4 * WK)) > 7  # the fewest warp rows
        assert 8 % (WK * WG) == 0 and WG == min(4, 8 // WK)
        smem = kernels.hxt_fma_smem_bytes(KR, GB, S, xdt, chunk)
        assert smem <= kernels._MAX_SMEM
        if K % KR:  # the last range's launch, on its own layout
            WKl, _ = kernels.hxt_fma_rows(K % KR)
            assert 8 % (WKl * WG) == 0
            assert kernels.hxt_fma_smem_bytes(K % KR, GB, S, xdt, chunk) <= kernels._MAX_SMEM
        per_sm = 2 if smem <= HALF_SM and MK <= 7 else 1
        if K <= 512:
            two_per_sm.append(per_sm == 2)
        budget = min(kernels._MAX_SMEM, kernels._SM_SMEM // per_sm - 1024)
        if per_sm == 2:  # the wider chunk where two of its stages fit
            assert chunk == 64 or kernels.hxt_fma_smem_bytes(KR, GB, 2, xdt, 64) > HALF_SM
            assert S == 8 or kernels.hxt_fma_smem_bytes(KR, GB, S + 1, xdt, chunk) > budget
        # one wave, or (above 512) the splits of at most 16,384 cells
        assert (-(-2000 // GB) * n_split * R <= max(-(-2000 // GB) * R, 132 * per_sm)
                or (R > 1 and n_split <= -(-100_000 // kernels._WIDE_SPLIT_CELLS)))
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
    """int8/bf16 X and K = 0 raise; K = 513 .. 2048 take the large-K route's
    grid, the K <= 512 rule's at each range's KR."""
    for xdt in (torch.int8, torch.bfloat16):
        with pytest.raises(ValueError, match="float32 and int16"):
            kernels.hxt_fma_grid(100, 100, 8, xdt)
    with pytest.raises(ValueError, match="K=0"):
        kernels.hxt_fma_grid(100, 100, 0, torch.float32)
    for K in (513, 600, 768, 1024, 1025, 2048):
        R, KR = kernels.k_ranges(K)
        GB, n_split, cps, S, chunk = kernels.hxt_fma_grid(100, 100, K, torch.float32)
        assert R >= 2 and GB == 32 * min(4, 8 // kernels.hxt_fma_rows(KR)[0])
        assert kernels.hxt_fma_smem_bytes(KR, GB, S, torch.float32, chunk) <= kernels._MAX_SMEM


def _emulate_hxt(X, H, K):
    """hxt_fma's summation order in PyTorch over hxt_fma_grid's grid: warp
    group q of a block sums cells q CW / Q .. (q + 1) CW / Q - 1 of every
    chunk of its split; the Q tiles are added in q order into the split's
    partial, and the partials in split order."""
    g, n = X.shape
    GB, n_split, cps, _, CW = kernels.hxt_fma_grid(g, n, K, X.dtype)
    KR = kernels.k_ranges(K)[1]
    Xf = X.float()
    out = torch.zeros((K, g), dtype=torch.float32)
    for s in range(n_split):
        cells = torch.arange(s * cps, min(n, (s + 1) * cps))
        part = torch.zeros((K, g), dtype=torch.float32)
        for k0 in range(0, K, KR):  # a launch a range of K, each on its own layout
            rows = slice(k0, min(K, k0 + KR))
            WK, _ = kernels.hxt_fma_rows(rows.stop - k0)
            Q = 8 // (WK * (GB // 32))
            for q in range(Q):
                mine = cells[(cells % CW) // (CW // Q) == q]
                for g0 in range(0, g, GB):
                    part[rows, g0:g0 + GB] += H[rows][:, mine] @ Xf[g0:g0 + GB, mine].T
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
    half an SM (else one), with the most stages that fit.  Above K = 512 the
    same for each range of KR <= 512 columns of W (a grid layer)."""
    xdt = FP32[dtype]
    for K in COVER_KS:
        T, LK, GC, S, blocks = kernels.wtx_fma_grid(2000, 100_000, K, xdt)
        KR = kernels.k_ranges(K)[1]
        WK, MK = kernels.wtx_fma_rows(KR, LK)
        assert WK * LK * MK >= KR and MK <= 6 and 12 * MK <= 72
        assert LK == 1 or KR > 8 * (LK // 2) * 6  # the fewest lanes along K
        assert 8 % WK == 0 and blocks == -(-100_000 // T)
        smem = kernels.wtx_fma_smem_bytes(KR, LK, S, xdt)
        assert smem <= kernels._MAX_SMEM
        if smem > HALF_SM:  # one block an SM only where two stages pass half an SM
            assert kernels.wtx_fma_smem_bytes(KR, LK, 2, xdt) > HALF_SM
        budget = HALF_SM if smem <= HALF_SM else kernels._MAX_SMEM
        assert S == 8 or kernels.wtx_fma_smem_bytes(KR, LK, S + 1, xdt) > budget


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
    """int8/bf16 X and K = 0 raise; K = 513 .. 2048 take the large-K route's
    grid, the K <= 512 rule's at each range's KR."""
    for xdt in (torch.int8, torch.bfloat16):
        with pytest.raises(ValueError, match="float32 and int16"):
            kernels.wtx_fma_grid(100, 100, 8, xdt)
    with pytest.raises(ValueError, match="K=0"):
        kernels.wtx_fma_grid(100, 100, 0, torch.float32)
    for K in (513, 600, 768, 1024, 1025, 2048):
        R, KR = kernels.k_ranges(K)
        T, LK, GC, S, blocks = kernels.wtx_fma_grid(100, 100, K, torch.float32)
        assert R >= 2 and (T, LK, GC, S, blocks) == kernels.wtx_fma_grid(100, 100, KR,
                                                                          torch.float32)
        assert kernels.wtx_fma_smem_bytes(KR, LK, S, torch.float32) <= kernels._MAX_SMEM


def _emulate_wtx(X, W, K):
    """wtx_fma's summation order in PyTorch over wtx_fma_grid's tiles: warp
    group q sums genes q GC / Q .. (q + 1) GC / Q - 1 of every chunk of 32
    genes, and the Q tiles are added in q order."""
    g, n = X.shape
    T, LK, GC, _, blocks = kernels.wtx_fma_grid(g, n, K, X.dtype)
    WK, _ = kernels.wtx_fma_rows(kernels.k_ranges(K)[1], LK)  # every range's layout
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

"""The grid rules of P1 ``hxt``'s bf16 path on the CPU: ``kernels.hxt_grid``
for K <= 512 and ``kernels.hxt_wide_grid`` above.

The CUDA kernels (csrc/x_passes.cu: hxt_mma; csrc/x_passes_wide.cuh:
hxt_wide) run only on the card; these tests hold what they are given: every
gene and cell covered once, splits that are multiples of the ring's chunk
(the wide kernel's 64-cell stage), shared memory within a Hopper block's
limit for every K (1..512 and a sample of the large-K route up to 2048),
and the sum of per-split partials in split order over that grid equal to
``hxt_plain`` (rtol 1e-5: fp32 sums of positive terms in another order).
The float32/int16 path takes ``hxt_fma_grid``
(tests/test_torch_fp32_passes.py); K1's bf16 path keeps ``_cell_splits``;
the wide kernel's slot order and staging: tests/test_torch_wide_passes.py.
"""

import numpy as np
import pytest
import torch

from alpine_tpu_torch.ops import kernels
from alpine_tpu_torch.ops.mu import round_partner
from tests.test_torch_wtx import as_values, device_bytes, keep_bytes, stage_windows, words_at
from tests.torch_k_samples import COVER_KS

MMA = {"int8": torch.int8, "bfloat16": torch.bfloat16}
KS = (1, 13, 40, 64, 65, 300, 512, 600, 768, 2048)


def hxt_launch_grid(g, n, K, dtype):
    """(GB, n_split, cells_per_split, S, chunk) of the bf16 path's kernel at
    K: hxt_grid's, or above 512 hxt_wide's (128-gene tiles, 64-cell
    stages)."""
    if kernels.route(K) == "wide":
        _, n_split, cps, S = kernels.hxt_wide_grid(g, n, K, dtype)
        return kernels._WIDE_BM, n_split, cps, S, kernels._WIDE_BK
    return kernels.hxt_grid(g, n, K, dtype)


def _grid_ranges(g, n, K, dtype):
    GB, n_split, cps, S, chunk = hxt_launch_grid(g, n, K, dtype)
    genes = [(g0, min(g, g0 + GB)) for g0 in range(0, g, GB)]
    cells = [(s * cps, min(n, (s + 1) * cps)) for s in range(n_split)]
    return GB, n_split, cps, S, chunk, genes, cells


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("g,n", [(2000, 100_000), (70, 17), (300, 50_001),
                                 (300, 50_016), (20_000, 1001), (1, 64)])
@pytest.mark.parametrize("K", KS)
def test_hxt_grid_covers_each_gene_and_cell_once(dtype, g, n, K):
    GB, n_split, cps, S, chunk, genes, cells = _grid_ranges(g, n, K, MMA[dtype])
    assert chunk in (kernels._HXT_CHUNKS if K <= 512 else (kernels._WIDE_BK,))
    assert cps % chunk == 0 and GB % 16 == 0
    assert 2 <= S <= 8
    seen_g = np.zeros(g, np.int64)
    for a, b in genes:
        seen_g[a:b] += 1
    seen_c = np.zeros(n, np.int64)
    for a, b in cells:
        assert a < b  # no empty split
        seen_c[a:b] += 1
    assert (seen_g == 1).all() and (seen_c == 1).all()


@pytest.mark.parametrize("dtype", list(MMA))
def test_hxt_grid_fits_shared_memory_and_fragments(dtype):
    """For every K the kernels take: one pass of at most 4 fragments a warp
    (X read once), shared memory within a Hopper block's limit, two blocks
    an SM up to the K where three stages no longer fit half an SM, and the
    blocks of a grid (gene blocks x splits) within one wave on 132 SMs.
    Above K = 512 the wide kernel: wgmma tiles of legal widths (64 rows a
    warpgroup, N = 256 a multiple of 8 up to 256) that cover K, whole
    clusters of gene tiles, the most ring stages within a block, and
    splits of at most 16,384 cells."""
    xdt = MMA[dtype]
    two_per_sm = []
    for K in COVER_KS:
        if K > 512:
            CL, n_split, cps, S = kernels.hxt_wide_grid(2000, 100_000, K, xdt)
            assert kernels._WIDE_BM == 2 * 64 and kernels._WIDE_BN % 8 == 0
            assert kernels._WIDE_BN <= 256 and kernels._WIDE_BK % 16 == 0
            assert -(-K // kernels._WIDE_BN) * kernels._WIDE_BN >= K and CL in (1, 2)
            tiles = kernels._wide_tiles("hxt", 2000, K)
            assert tiles % (CL * -(-K // kernels._WIDE_BN)) == 0
            for aligned in (False, True):
                assert kernels.x_wide_smem_bytes("hxt", S, xdt, aligned) <= kernels._MAX_SMEM
            assert S == 8 or kernels.x_wide_smem_bytes("hxt", S + 1, xdt) > kernels._MAX_SMEM
            assert cps % 64 == 0 and cps <= kernels._WIDE_SPLIT_CELLS
            assert (n_split - 1) * cps < 100_000 <= n_split * cps
            continue
        GB, n_split, cps, S, chunk = kernels.hxt_grid(2000, 100_000, K, xdt)
        frags = (kernels._pad16(K) // 16) * (GB // 16)
        assert frags <= 32 and 8 % (GB // 16) == 0
        smem = kernels.hxt_smem_bytes(K, GB, S, xdt, chunk)
        assert smem <= kernels._MAX_SMEM
        per_sm = 2 if smem <= kernels._SM_SMEM // 2 - 1024 else 1
        two_per_sm.append(per_sm == 2)
        # the most stages that fit: one more would pass the budget or 8
        budget = min(kernels._MAX_SMEM, kernels._SM_SMEM // per_sm - 1024)
        assert S == 8 or kernels.hxt_smem_bytes(K, GB, S + 1, xdt, chunk) > budget
        if chunk != 128:  # the wider chunk does not fit the same budget
            assert kernels.hxt_smem_bytes(K, GB, 2, xdt, 128) > budget
        # one wave
        assert -(-2000 // GB) * n_split <= max(-(-2000 // GB), 132 * per_sm)
    # two blocks an SM from K = 1 up to some K, one above it
    first_one = two_per_sm.index(False)
    assert first_one > 64 and not any(two_per_sm[first_one:])


def test_hxt_grid_at_the_bench_shape():
    """100k cells x 2,000 genes, K = 40: 128 genes a block (16 gene blocks),
    16 splits of 49 chunks of 128 cells, one wave of 256 blocks at two an
    SM; int8 X fits three ring stages, bf16 X two."""
    assert kernels.hxt_grid(2000, 100_000, 40, torch.int8) == (128, 16, 6272, 3, 128)
    assert kernels.hxt_grid(2000, 100_000, 40, torch.bfloat16) == (128, 16, 6272, 2, 128)
    # the widest block whose Kp x GB outputs fit 32 fragments
    assert [kernels.hxt_grid(2000, 100_000, K, torch.int8)[0]
            for K in (64, 65, 128, 129, 256, 257, 512)] == [128, 64, 64, 32, 32, 16, 16]


def test_cell_splits_keep_the_fp32_and_k1_grid():
    """_cell_splits, which K1's bf16 path (fused_iteration's X Hnᵀ pass on
    int8/bf16 X) uses, keeps its grid at the bench shape; the float32/int16
    paths of hxt and of K1 take hxt_fma_grid instead."""
    for xdt in (torch.int8, torch.float32):
        assert kernels.iteration_tile_width(40, xdt) == 64
    assert kernels._cell_splits(2000, 100_000, 64) == (131, 768)
    assert kernels._cell_splits(300, 50_000, 64) == (782, 64)


def test_hxt_grid_rejects_what_the_kernel_does_not_take():
    """float32/int16 X and K = 0 raise; K = 513 .. 2048 take the large-K
    route: hxt_grid refuses them and hxt_wide_grid takes them (and refuses
    K <= 512 and float32/int16 X), within a Hopper block; the fp32 path
    keeps its ranges of at most 512 rows of H."""
    for xdt in (torch.float32, torch.int16):
        with pytest.raises(ValueError, match="int8 and bf16"):
            kernels.hxt_grid(100, 100, 8, xdt)
        with pytest.raises(ValueError, match="int8 and bf16"):
            kernels.hxt_wide_grid(100, 100, 768, xdt)
    with pytest.raises(ValueError, match="K=0"):
        kernels.hxt_grid(100, 100, 0, torch.int8)
    with pytest.raises(ValueError, match="K > 512"):
        kernels.hxt_wide_grid(100, 100, 512, torch.int8)
    for K in (513, 600, 768, 1024, 1025, 2048):
        assert kernels.route(K) == "wide"
        with pytest.raises(ValueError, match="hxt_wide_grid"):
            kernels.hxt_grid(100, 100, K, torch.int8)
        CL, n_split, cps, S = kernels.hxt_wide_grid(100, 100, K, torch.int8)
        assert (CL, n_split, cps) == (2, 2, 64)  # two 64-cell splits fill more of a wave
        assert kernels.x_wide_smem_bytes("hxt", S, torch.int8) <= kernels._MAX_SMEM


def _emulate_hxt(X, H, K, base=None):
    """hxt_mma's arithmetic in PyTorch over hxt_grid's grid: each (gene
    block, split) sums H rounded to bf16 times X over its cells, chunk by
    chunk, into its partial; the partials are added in split order from
    zero.  ``base`` None takes X's values as they are (the aligned path);
    an address stages each chunk through the aligned windows of X laid out
    there and reads a lane's 8 cells at each row's offset, masked past n
    (lds8_at / lds16_at, keep_bytes).  Above K = 512 hxt_wide's
    (tests/test_torch_wide_passes.py)."""
    if kernels.route(K) == "wide":
        from tests.test_torch_wide_passes import emulate_hxt_wide
        return emulate_hxt_wide(X, H, base)
    g, n = X.shape
    GB, n_split, cps, _, chunk = kernels.hxt_grid(g, n, K, X.dtype)
    Hb, Xf = round_partner(H, X.dtype), X.float()
    sz = X.element_size()
    mem = None if base is None else device_bytes(X, base)
    part = torch.zeros((n_split, K, g), dtype=torch.float32)
    for s in range(n_split):
        for c0 in range(s * cps, min(n, (s + 1) * cps), chunk):
            c1 = min(n, c0 + chunk)
            if mem is None:
                Xc = Xf[:, c0:c1]
            else:
                stage, off = stage_windows(mem, base, np.arange(g), n, sz, c0, chunk)
                keep = (n - c0 - np.arange(0, chunk, 8)[:, None]) * sz - 4 * np.arange(2 * sz)
                raw = np.concatenate([keep_bytes(words_at(stage, off + e * sz, 2 * sz),
                                                 keep[e // 8][None, :])
                                      for e in range(0, chunk, 8)], 1)
                Xc = as_values(raw.view(np.uint8), X.dtype)
                assert not Xc[:, c1 - c0:].any()  # cells past n read as zeros
                Xc = Xc[:, :c1 - c0]
            for g0 in range(0, g, GB):
                g1 = min(g, g0 + GB)
                part[s, :, g0:g1] += Hb[:, c0:c1] @ Xc[g0:g1].T
    out = torch.zeros((K, g), dtype=torch.float32)
    for s in range(n_split):
        out += part[s]
    return out


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("n", [17, 1001, 5040])
@pytest.mark.parametrize("K", KS)
def test_hxt_grid_emulation_matches_plain(dtype, n, K):
    r = np.random.default_rng(K * 7 + n)
    g = 150  # two gene blocks at GB = 128, ragged
    if dtype == "int8":
        X = torch.from_numpy(r.poisson(3.0, (g, n)).clip(0, 127).astype(np.int8))
    else:
        X = torch.from_numpy(r.random((g, n), dtype=np.float32)).to(torch.bfloat16)
    H = torch.from_numpy(r.random((K, n), dtype=np.float32) + 0.1)
    want = kernels.hxt_plain(X, H)
    got = _emulate_hxt(X, H, K)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=0)
    # the CPU wrapper is the plain version
    assert torch.equal(kernels.hxt(X, H), want)


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("n", [1009, 1014, 1019, 1024])
@pytest.mark.parametrize("base", [0, 1, 6, 15])
def test_hxt_window_staging_gives_the_aligned_bits(dtype, n, base):
    """X at a base address off 16-byte alignment (bf16: the even address
    below) and rows of n mod 16 = 1, 6, 11 (every row offset 0-15 occurs)
    or 0, several splits: the chunks staged through the aligned windows
    and read at each row's offset give the aligned path's values, so its
    bits, and the plain version's sums at rtol 1e-5, atol 1e-5 max|plain|
    (X holds negative values, whose bytes have the top bit set: sums near
    zero cancel)."""
    K = 13
    r = np.random.default_rng(n + base)
    if dtype == "int8":
        X = torch.from_numpy((r.poisson(3.0, (150, n)) - r.integers(0, 2, (150, n)) * 5
                              ).astype(np.int8))
    else:
        X = torch.from_numpy(r.random((150, n), dtype=np.float32) - 0.25).to(torch.bfloat16)
    H = torch.from_numpy(r.random((K, n), dtype=np.float32) + 0.1)
    base -= base % X.element_size()
    assert kernels.hxt_grid(150, n, K, X.dtype)[1] > 1
    got, want = _emulate_hxt(X, H, K, base=base), kernels.hxt_plain(X, H)
    assert torch.equal(got, _emulate_hxt(X, H, K))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", list(MMA))
def test_hxt_partials_stay_a_small_share_of_x(dtype):
    """The splits' fp32 partials (splits × K × g, read back by the second
    pass) stay within an eighth of X's bytes from 33k cells up for every
    K, and within 3 % at the bench shape; at the minibatch shape (2,000 ×
    8,192, K = 40) the grid keeps filling the wave (16 splits of 4 chunks,
    the parent's grid: fewer splits took more time on the card), its
    partials a third of X's int8 bytes."""
    xdt = MMA[dtype]
    sz = 1 if dtype == "int8" else 2
    share = lambda n, K: 4 * hxt_launch_grid(2000, n, K, xdt)[1] * K * 2000 / (2000 * n * sz)
    for n in (33_334, 66_667, 100_000):
        for K in COVER_KS:
            # above 512 the splits are at least the fewest of at most 16,384
            # cells (the fp32 sums' length) and at most twice as many
            _, n_split, cps, _, chunk = hxt_launch_grid(2000, n, K, xdt)
            least = -(-n // kernels._WIDE_SPLIT_CELLS)
            assert share(n, K) <= 1 / 8 or (
                K > 512 and n_split == -(-n // cps) and cps <= kernels._WIDE_SPLIT_CELLS
                and least <= n_split <= 2 * least)
    assert share(100_000, 40) <= 0.03
    assert kernels.hxt_grid(2000, 8192, 40, torch.int8) == (128, 16, 512, 3, 128)
    assert 0.3 < share(8192, 40) * sz < 0.32

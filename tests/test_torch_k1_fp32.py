"""K1's float32/int16 path (``kernels.fused_iteration`` and its counts mode
K4 on float32 and int16 X) on the CPU.

On the card that path runs the chain of ``kernels.iteration_grid``: at
K <= 512 the kernels of ALS's fp32 X passes, wtx_fma (WᵀX) and hxt_fma
(X Hnᵀ, X Hsᵀ in counts mode, one partial a cell split), around the
chain's own D = WᵀW H (wtw_gemm), H update (iter_wide) and statistics
against Hn (gram_wide), then reduce_partials; above, the same chain with
the fp32 X passes of fma_wide.cuh.  The CUDA kernels run only on the card;
these tests hold what they are given:

- ``kernels.iteration_grid``'s launch parameters for every K in 1..512:
  every cell and gene covered once by each launch, shared memory within a
  Hopper block's limit, the bench shape's grid pinned (the int8/bf16
  chain's: tests/test_torch_k1_chain.py); and for a sample of K up to 2048
  the large-K grid (``wide_iteration_grid``), on every X dtype;
- a PyTorch emulation of the chain's summation order
  (tests/test_torch_wide_k.py:emulate_chain: WᵀX in wtx_fma's order,
  tests/test_torch_fp32_passes.py:_emulate_wtx; the H update and iter_wide's
  partials; X Hnᵀ in hxt_fma's order, _emulate_hxt; gram_wide's tiles)
  against ``kernels.fused_iteration_plain`` at rtol 1e-5 (fp32 sums of
  positive terms in another order) and against the Pallas kernel in
  interpret mode at the tolerances of tests/test_torch_kernels.py, with
  and without counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpine_tpu.ops import pallas_kernels as pk
from alpine_tpu_torch.ops import kernels
from alpine_tpu_torch.ops.mu import guided_width

from .test_torch_fp32_passes import FP32, SHAPES
from .test_torch_wide_k import emulate_chain
from .torch_k_samples import WIDE_SAMPLE

torch.set_num_threads(1)

EPS = 1e-6
G = 150  # two gene blocks of hxt_fma at K <= 112 (the second ragged), a ragged gene chunk
KS = (1, 13, 40, 65, 300, 512)
NS = (17, 1001, 5040)


# ---------------------------------------------------------------------------
# launch parameters
# ---------------------------------------------------------------------------


def _covered_once(n, starts, width):
    seen = np.zeros(n, np.int64)
    for s in starts:
        assert s < n  # nothing empty
        seen[s:s + width] += 1
    return (seen == 1).all()


@pytest.mark.parametrize("dtype", list(FP32))
@pytest.mark.parametrize("g,n", SHAPES)
def test_iteration_grid_covers_each_cell_and_gene_once(dtype, g, n):
    """Every launch of the fp32 path covers its axis once for every K:
    iter_wide's blocks walk their runs of 128-cell tiles, wtx_fma's tiles
    the cells, hxt_fma's gene blocks the genes and its splits the cells,
    gram_wide's splits the cells."""
    xdt = FP32[dtype]
    for K in range(1, 513):
        grid = kernels.iteration_grid(g, n, K, xdt)
        T, n_part, tpb = grid.T, grid.n_part, grid.tiles_per_block
        assert T == kernels._WIDE_T and n_part <= kernels._WIDE_PART_BLOCKS
        run = T * tpb
        assert _covered_once(n, range(0, n_part * run, run), run)
        assert grid.wtx_T * -(-n // grid.wtx_T) >= n
        assert _covered_once(n, range(0, n, grid.wtx_T), grid.wtx_T)
        assert _covered_once(g, range(0, g, grid.GB), grid.GB)
        cps = grid.cells_per_split
        assert cps % grid.chunk == 0
        assert _covered_once(n, range(0, grid.n_split * cps, cps), cps)
        hh = grid.gram_cells_per_split
        assert _covered_once(n, range(0, grid.gram_split * hh, hh), hh)
        # the X passes' own grids, as ALS runs them (all genes one range),
        # and gram_wide's
        assert grid[3:9] == kernels.wtx_fma_grid(g, n, K, xdt)[:4] + (1, g)
        assert grid[9:14] == kernels.hxt_fma_grid(g, n, K, xdt)
        assert grid[14:] == kernels.gram_wide_grid(n, K)


@pytest.mark.parametrize("dtype", ["float32", "int16", "int8", "bfloat16"])
@pytest.mark.parametrize("g,n", SHAPES)
def test_wide_iteration_grid_covers_each_cell_and_gene_once(dtype, g, n):
    """The large-K chain (K > 512) on every X dtype: iter_wide's blocks walk
    runs of 128-cell tiles, P2's tiles and P1's gene blocks and splits cover
    their axes once, X's passes take P1/P2's own large-K grids at the same
    K (X's dtype picks the wgmma kernels hxt_wide / wtx_wide or the fp32
    kernels hxt_fma_wide / wtx_fma_wide), H Hᵀ takes gram_wide's splits
    (``gram_wide_grid``), and every launch fits a Hopper block."""
    xdt = {"float32": torch.float32, "int16": torch.int16, "int8": torch.int8,
           "bfloat16": torch.bfloat16}[dtype]
    mma = xdt in kernels._MMA_XTYPES
    for K in WIDE_SAMPLE:
        grid = kernels.iteration_grid(g, n, K, xdt)
        assert isinstance(grid, kernels.IterationGrid)
        assert grid.T == kernels._WIDE_T == 128
        assert grid.n_part <= kernels._WIDE_PART_BLOCKS
        run = grid.T * grid.tiles_per_block
        assert _covered_once(n, range(0, grid.n_part * run, run), run)
        assert _covered_once(n, range(0, n, grid.wtx_T), grid.wtx_T)
        # P1's gene block: hxt_wide's 128-gene tile (GB carries its cluster
        # size on that path), hxt_fma's GB genes
        gene_block = kernels._WIDE_BM if mma else grid.GB
        assert _covered_once(g, range(0, g, gene_block), gene_block)
        cps = grid.cells_per_split
        assert cps % grid.chunk == 0
        assert _covered_once(n, range(0, grid.n_split * cps, cps), cps)
        hh = grid.gram_cells_per_split
        assert hh <= kernels._WIDE_SPLIT_CELLS and hh % kernels._GRAM_BK == 0
        assert _covered_once(n, range(0, grid.gram_split * hh, hh), hh)
        if mma:  # (tile, cluster, stage, stages, ranges, genes a range) and
            # (cluster, splits, cells a split, stages, stage) of the wgmma kernels
            CL, ranges, range_genes, S = kernels.wtx_wide_grid(g, n, K, xdt)
            assert grid[3:9] == (kernels._WIDE_BM, CL, kernels._WIDE_BK, S, ranges,
                                 range_genes)
            CL, n_split, cps, S = kernels.hxt_wide_grid(g, n, K, xdt)
            assert grid[9:14] == (CL, n_split, cps, S, kernels._WIDE_BK)
        else:  # (tile, no cluster, chunk, stages, one range, all genes) and
            # (gene tile, splits, cells a split, stages, chunk) of the fp32 kernels
            T, chunk, S, _ = kernels.wtx_fma_wide_grid(g, n, K, xdt)
            assert grid[3:9] == (T, 1, chunk, S, 1, g)
            assert grid[9:14] == (kernels.wtw_design()["tile"][1],
                                  *kernels.hxt_fma_wide_grid(g, n, K, xdt), S, chunk)
        assert grid[14:] == kernels.gram_wide_grid(n, K)
        if mma:
            assert kernels.x_wide_smem_bytes("wtx", grid.wtx_S, xdt) <= kernels._MAX_SMEM
            assert kernels.x_wide_smem_bytes("hxt", grid.S, xdt) <= kernels._MAX_SMEM
        else:
            assert kernels.fma_wide_smem_bytes("wtx", xdt) <= kernels._MAX_SMEM
            assert kernels.fma_wide_smem_bytes("hxt", xdt) <= kernels._MAX_SMEM
    with pytest.raises(ValueError, match="K > 512"):
        kernels.wide_iteration_grid(g, n, 512, xdt)


@pytest.mark.parametrize("dtype", list(FP32))
def test_iteration_grid_fits_shared_memory(dtype):
    """Shared memory of each of the fp32 path's kernels within a Hopper
    block's limit for every K, iter_wide at 8 labels over K - 1 guided
    components, with and without counts (independent of K)."""
    xdt = FP32[dtype]
    for K in range(1, 513):
        grid = kernels.iteration_grid(2000, 100_000, K, xdt)
        for L, Kg, counts in ((0, 0, False), (8, K - 1, False), (8, K - 1, True)):
            assert kernels.wide_smem_bytes(L, Kg, counts) <= kernels._MAX_SMEM
        assert kernels.hxt_fma_smem_bytes(K, grid.GB, grid.S, xdt,
                                          grid.chunk) <= kernels._MAX_SMEM
        assert kernels.wtx_fma_smem_bytes(K, grid.wtx_WR, grid.wtx_S,
                                          xdt) <= kernels._MAX_SMEM


def test_iteration_grid_at_the_bench_shape():
    """100k cells x 2,000 genes, K = 40: iter_wide 391 blocks of two
    128-cell tiles; wtx_fma 261 tiles of 384 cells, one lane along K, two
    stages of 32 genes, all genes one range; hxt_fma 16 gene blocks of 128
    x 16 splits of 6,272 cells (5.1 MB of partials), two stages of 64
    cells; gram_wide 261 splits of 384 cells (one tile pair)."""
    for xdt in (torch.float32, torch.int16):
        assert kernels.iteration_grid(2000, 100_000, 40, xdt) == (
            128, 391, 2, 384, 1, 32, 2, 1, 2000, 128, 16, 6272, 2, 64, 261, 384)
    g = kernels.iteration_grid(2000, 100_000, 40, torch.float32)
    assert g.n_split * 40 * 2000 * 4 == 5_120_000


# ---------------------------------------------------------------------------
# the summation order
# ---------------------------------------------------------------------------


def _problem(seed, n, blocks, n_labels, dtype, counts):
    r = np.random.default_rng(seed)
    K = sum(blocks)
    if dtype == "int16":  # counts above int8's range
        X = (r.poisson(3.0, (G, n)) * 300).astype(np.float32)
    else:
        X = r.random((G, n), dtype=np.float32)
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
    C = r.integers(0, 4, (2, n)).astype(np.float32) if counts else None
    return X, W, H, WtW, Ys, Bs, lam, C


def _blocks(K):
    """Two covariates where K allows; at K = 1 one covariate and no
    unguided component."""
    if K == 1:
        return (1, 0), (2,)
    a = max(1, K // 5)
    b = max(1, K // 7) if K > 2 else 0
    return ((a, b, K - a - b), (2, 3)) if b else ((a, K - a), (2,))


def _emulate(X, W, H, WtW, Ys, Bs, lam, C, blocks, loss_kl):
    """K1's fp32 path in PyTorch (tests/test_torch_wide_k.py:emulate_chain).
    With no covariates (K2): (Hn, XHt, HHt, lossdot)."""
    return emulate_chain(X, W, H, WtW, Ys, Bs, lam, C, blocks, loss_kl)


def _flat(out):
    """The outputs as a flat list of float64 arrays."""
    flat = []
    for o in out:
        for t in (o if isinstance(o, tuple) else (o,)):
            flat.append(np.asarray(t, dtype=np.float64))
    return flat


CASES = [(K, n, counts, loss_kl) for K in KS for n in NS for counts in (False, True)
         for loss_kl in ((True,) if counts else (n % 2 == 1,))]


@pytest.mark.parametrize("dtype", list(FP32))
@pytest.mark.parametrize("K,n,counts,loss_kl", CASES)
def test_k1_emulation_matches_plain(dtype, K, n, counts, loss_kl):
    """The new summation order against the plain version (rtol 1e-5): every
    output, undrawn columns of H bit for bit; on the CPU the wrapper is the
    plain version."""
    blocks, n_labels = _blocks(K)
    X, W, H, WtW, Ys, Bs, lam, C = _problem(K * 3 + n, n, blocks, n_labels, dtype, counts)
    xdt = FP32[dtype]
    args = (torch.from_numpy(X).to(xdt), torch.from_numpy(W), torch.from_numpy(H),
            torch.from_numpy(WtW), [torch.from_numpy(y).to(xdt) for y in Ys],
            [torch.from_numpy(b) for b in Bs], torch.from_numpy(lam), EPS,
            None if C is None else torch.from_numpy(C))
    want = kernels.fused_iteration_plain(*args, blocks=blocks, loss_kl=loss_kl)
    got = _emulate(*args[:7], args[8], blocks, loss_kl)
    for a, b in zip(_flat(got), _flat(want), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
    if counts:
        undrawn = C[0] == 0
        assert undrawn.any()
        np.testing.assert_array_equal(got[0].numpy()[:, undrawn], H[:, undrawn])
    before = dict(kernels.launches)
    same = kernels.fused_iteration(*args, blocks=blocks, loss_kl=loss_kl)
    for a, b in zip(_flat(same), _flat(want), strict=True):
        np.testing.assert_array_equal(a, b)
    assert kernels.launches == before  # plain runs never count


@pytest.mark.parametrize("dtype", list(FP32))
@pytest.mark.parametrize("K,n,counts", [(K, n, c) for K in KS for n in NS
                                        for c in (False, True)])
def test_k1_emulation_matches_pallas(dtype, K, n, counts):
    """The new summation order against the Pallas kernel in interpret mode,
    at tests/test_torch_kernels.py's tolerances (Hn rtol 1e-5 / atol 1e-6,
    statistics rtol 1e-4).  The Pallas kernel wants the cell axis padded to
    its tile: the pad columns are zero, drawn 0 times, and left out of the
    comparison; they add eps per label row to the KL prediction loss, which
    the comparison takes off."""
    blocks, n_labels = _blocks(K)
    jdt = jnp.float32 if dtype == "float32" else jnp.int16
    pad = pk.pad_target(G, n, 1, jnp.dtype(jdt).itemsize, K, n_labels,
                        cast_itemsize=pk._cast_itemsize_for_dtype(jdt), counts_mode=counts)
    X, W, H, WtW, Ys, Bs, lam, C = _problem(K * 5 + n, n + pad, blocks, n_labels,
                                            dtype, counts)
    X[:, n:] = 0.0
    H[:, n:] = 0.0
    for y in Ys:
        y[:, n:] = 0.0
    if counts:
        C[:, n:] = 0.0
    xdt = FP32[dtype]
    want = pk.fused_iteration(
        jnp.asarray(X).astype(jdt), jnp.asarray(W), jnp.asarray(H), jnp.asarray(WtW),
        tuple(jnp.asarray(y).astype(jdt) for y in Ys), tuple(jnp.asarray(b) for b in Bs),
        jnp.asarray(lam), jnp.float32(EPS), None if C is None else jnp.asarray(C),
        blocks=blocks, loss_kl=True, interpret=True)
    cut = lambda a: torch.from_numpy(np.ascontiguousarray(a[..., :n]))
    got = _emulate(cut(X).to(xdt), torch.from_numpy(W), cut(H), torch.from_numpy(WtW),
                   [cut(y).to(xdt) for y in Ys], [torch.from_numpy(b) for b in Bs],
                   torch.from_numpy(lam), None if C is None else cut(C), blocks, True)
    close = lambda a, b, rtol, atol=0.0: np.testing.assert_allclose(
        np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=atol)
    close(got[0], np.asarray(want[0])[:, :n], 1e-5, 1e-6)
    for i in range(1, 4 if counts else 3):  # XHt, HHt (and HHtU)
        close(got[i], want[i], 1e-4, 1e-4)
    o = 4 if counts else 3
    close(got[o], want[o], 1e-4)
    for c, nl in enumerate(n_labels):
        close(got[o + 1][c], float(want[o + 1][c]) - EPS * nl * pad, 1e-4)
        close(got[o + 2][c], want[o + 2][c], 1e-4, 1e-5)
        close(got[o + 3][c], want[o + 3][c], 1e-4)


@pytest.mark.parametrize("dtype", list(FP32))
@pytest.mark.parametrize("K,n", [(K, n) for K in KS for n in NS])
def test_k2_emulation_matches_plain_and_pallas(dtype, K, n):
    """K2 (no covariates) runs the same fp32 path: the emulation against
    ``fused_h_update_plain`` (rtol 1e-5) and the Pallas kernel in interpret
    mode (its ragged last tile is masked: no padding)."""
    X, W, H, WtW, _, _, _, _ = _problem(K * 7 + n, n, (K,), (), dtype, False)
    xdt = FP32[dtype]
    Xt = torch.from_numpy(X).to(xdt)
    Wt, Ht, WtWt = torch.from_numpy(W), torch.from_numpy(H), torch.from_numpy(WtW)
    got = _emulate(Xt, Wt, Ht, WtWt, (), (), None, None, (K,), True)
    want = kernels.fused_h_update_plain(Xt, Wt, Ht, WtWt, EPS)
    for a, b in zip(_flat(got), _flat(want), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
    jdt = jnp.float32 if dtype == "float32" else jnp.int16
    pal = pk.fused_h_update(jnp.asarray(X).astype(jdt), jnp.asarray(W), jnp.asarray(H),
                            jnp.asarray(WtW), jnp.float32(EPS), interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(pal[0]), rtol=1e-5, atol=1e-6)
    for a, b in zip(got[1:], pal[1:]):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=1e-4, atol=1e-4)

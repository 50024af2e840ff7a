"""K1's int8/bf16 chain (``kernels.fused_iteration``, its counts mode K4 and
K2 on int8 and bf16 X at K <= 512) on the CPU.

On the card one C call launches the chain of ``kernels.iteration_grid``:
wtx_mma (WᵀX over P2's grid, ``wtx_grid`` and ``wtx_gene_split``; W rounded
and transposed to bf16 by round_w) → wtw_gemm (D = WᵀW H) → iter_wide (the
H update over 128-cell tiles; Hs = c_next ⊙ Hn in counts mode, Q, the
prediction-loss rows and the loss dot) → hxt_mma (X Hnᵀ, or X Hsᵀ, over
``k1_hxt_grid``; Hn or Hs rounded to bf16 by round_h) → gram_wide (H Hᵀ,
HHtU, rowsum and Bnum from one read of Hn) → reduce_partials (the splits in
order).  The CUDA kernels run only on the card; these tests hold what they
are given:

- ``kernels.iteration_grid`` on int8/bf16 X for every K in 1..512: every
  cell and gene covered once by each launch, the X passes on P2's grid and
  K1's X Hnᵀ grid, gram_wide's splits, shared memory within a Hopper
  block's limit, the bench shape's and the optimizer fold's grids pinned;
- the wrapper's one C call (through a recorder): the grid's 16 ints, the
  scratch buffers' shapes, and the launches it counts;
- a PyTorch emulation of the chain's summation order
  (tests/test_torch_wide_k.py:emulate_chain: WᵀX as
  tests/test_torch_wtx.py:_emulate_wtx sums it, iter_wide's update and
  partials, X Hsᵀ as tests/test_torch_hxt.py:_emulate_hxt sums it over
  ``k1_hxt_grid``, gram_wide's tiles) against
  ``kernels.fused_iteration_plain`` at rtol 1e-5 (fp32 sums of positive
  terms in another order; XHt against the plain product over the
  emulation's own Hs, whose bf16 rounding may differ from the plain
  version's by one step where Hn differs by one ulp, and at rtol 1e-4
  against the plain XHt) and against the Pallas kernel in interpret mode at
  the tolerances of tests/test_torch_kernels.py, at K = 40, 144, 224 and
  512, with and without counts, KL and Frobenius, and K2, on 1,001 cells
  (int8 rows 9 bytes off 16-byte alignment) and 5,040;
- X laid out at an address off 16-byte alignment (the aligned windows the
  X passes stage) gives the emulation's aligned bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpine_tpu.ops import pallas_kernels as pk
from alpine_tpu_torch.ops import kernels

from .test_torch_fp32_passes import SHAPES
from .test_torch_k1_fp32 import _blocks, _covered_once, _flat
from .test_torch_wide_k import emulate_chain
from .test_torch_wtw_gemm import _recorder

torch.set_num_threads(1)

EPS = 1e-6
G = 150  # two gene blocks of hxt_mma at K <= 64 (the second ragged), ragged gene chunks
MMA = {"int8": torch.int8, "bfloat16": torch.bfloat16}
JAX = {"int8": jnp.int8, "bfloat16": jnp.bfloat16}
KS = (40, 144, 224, 512)
NS = (1001, 5040)


# ---------------------------------------------------------------------------
# launch parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("g,n", SHAPES)
def test_chain_grid_covers_each_cell_and_gene_once(dtype, g, n):
    """Every launch of the int8/bf16 chain covers its axis once for every K:
    iter_wide's blocks walk runs of 128-cell tiles, wtx_mma's tiles the
    cells and its gene ranges the genes, hxt_mma's gene blocks the genes
    and its splits the cells (at most 16,384 a split), gram_wide's splits
    the cells; the X passes take P2's own grid and K1's X Hnᵀ grid."""
    xdt = MMA[dtype]
    for K in range(1, 513):
        grid = kernels.iteration_grid(g, n, K, xdt)
        T, n_part, tpb = grid.T, grid.n_part, grid.tiles_per_block
        assert T == kernels._WIDE_T and n_part <= kernels._WIDE_PART_BLOCKS
        run = T * tpb
        assert _covered_once(n, range(0, n_part * run, run), run)
        assert _covered_once(n, range(0, n, grid.wtx_T), grid.wtx_T)
        rg = grid.wtx_range_genes
        assert rg % grid.wtx_GC == 0
        assert _covered_once(g, range(0, grid.wtx_ranges * rg, rg), rg)
        assert _covered_once(g, range(0, g, grid.GB), grid.GB)
        cps = grid.cells_per_split
        assert cps % grid.chunk == 0 and cps <= kernels._WIDE_SPLIT_CELLS
        assert _covered_once(n, range(0, grid.n_split * cps, cps), cps)
        hh = grid.gram_cells_per_split
        assert _covered_once(n, range(0, grid.gram_split * hh, hh), hh)
        assert grid[3:9] == (kernels.wtx_grid(g, n, K, xdt)[:4]
                             + kernels.wtx_gene_split(g, n, K, xdt))
        assert grid[9:14] == kernels.k1_hxt_grid(g, n, K, xdt)
        assert grid[14:] == kernels.gram_wide_grid(n, K)


@pytest.mark.parametrize("dtype", list(MMA))
def test_chain_grid_fits_shared_memory(dtype):
    """Shared memory of each kernel of the chain within a Hopper block's
    limit for every K: the X passes' rings, and iter_wide at 8 labels over
    K - 1 guided components, with and without counts (independent of K)."""
    xdt = MMA[dtype]
    for K in range(1, 513):
        grid = kernels.iteration_grid(2000, 100_000, K, xdt)
        for L, Kg, counts in ((0, 0, False), (8, K - 1, False), (8, K - 1, True)):
            assert kernels.wide_smem_bytes(L, Kg, counts) <= kernels._MAX_SMEM
        assert kernels.hxt_smem_bytes(K, grid.GB, grid.S, xdt, grid.chunk) <= kernels._MAX_SMEM
        assert kernels.wtx_smem_bytes(K, grid.wtx_T, grid.wtx_S, xdt,
                                      grid.wtx_GC) <= kernels._MAX_SMEM


def test_chain_grid_at_the_bench_shape_and_the_optimizer_fold():
    """100k cells x 2,000 genes, K = 40: iter_wide 391 blocks of two
    128-cell tiles; wtx_mma tiles of 192 cells, 2 warp rows, 64-gene chunks
    (5 stages int8, 3 bf16), all genes one range; hxt_mma 16 gene blocks of
    128 x 16 splits of 6,272 cells (3 ring stages of 128 cells on int8 X, 2
    on bf16), P1's grid; gram_wide 261 splits of 384 cells.  The
    optimizer's fold, 66,667 cells at K = 144: iter_wide 521 blocks of one
    tile; wtx_mma 64-cell tiles; hxt_mma 32-gene blocks x 5 splits of
    13,440 cells (P1's grid: 4 of 16,768); gram_wide 261 splits of 256
    cells (three tile pairs)."""
    assert kernels.iteration_grid(2000, 100_000, 40, torch.int8) == (
        128, 391, 2, 192, 2, 64, 5, 1, 2048, 128, 16, 6272, 3, 128, 261, 384)
    assert kernels.iteration_grid(2000, 100_000, 40, torch.bfloat16) == (
        128, 391, 2, 192, 2, 64, 3, 1, 2048, 128, 16, 6272, 2, 128, 261, 384)
    assert kernels.iteration_grid(2000, 66_667, 144, torch.int8) == (
        128, 521, 1, 64, 2, 64, 4, 1, 2048, 32, 5, 13440, 2, 128, 261, 256)
    assert kernels.hxt_grid(2000, 66_667, 144, torch.int8)[1:3] == (4, 16768)


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("K,n,counts", [(40, 1001, False), (144, 5040, True),
                                        (512, 17, True), (13, 8192, False)])
def test_chain_call_passes_its_grid_and_scratch(monkeypatch, dtype, K, n, counts):
    """The wrapper's one C call (recorded on the CPU): the 16 ints of
    ``iteration_grid``; Hb and Wb padded to P1's and P2's chunks, P2's gene
    ranges' partials and zeroed counters only where it splits the genes,
    Hs only in counts mode, P1's split partials; one launch each of
    wtx_mma, hxt_mma, wtw_gemm and gram_wide counted beside K1's (K4's)."""
    calls, made = _recorder(monkeypatch)
    g = 300
    blocks = (K // 4, K // 4, K - 2 * (K // 4)) if K >= 4 else (1, 1, K - 2)
    xdt = MMA[dtype]
    X = torch.ones((g, n), dtype=xdt)
    Ys = [torch.ones((2, n), dtype=xdt), torch.ones((3, n), dtype=xdt)]
    Bs = [torch.ones((2, blocks[0])), torch.ones((3, blocks[1]))]
    C = torch.ones((2, n)) if counts else None
    kernels.reset_launches()
    kernels.fused_iteration(X, torch.ones((g, K)), torch.ones((K, n)), torch.ones((K, K)), Ys,
                            Bs, torch.ones(2), 1e-6, C, blocks=blocks, loss_kl=True)
    ((name, args),) = calls
    grid = kernels.iteration_grid(g, n, K, xdt)
    assert name == "fused_iteration" and args[17:33] == tuple(grid)
    hs, hb, wb, wpart, arrivals = args[38], args[43], args[44], args[45], args[46]
    assert (hs is not None) == counts
    assert made[hb].numel() == 2 * K * -(-n // grid.chunk) * grid.chunk
    assert made[wb].numel() == 2 * kernels._pad16(K) * -(-g // grid.wtx_GC) * grid.wtx_GC
    assert (wpart is None) == (arrivals is None) == (grid.wtx_ranges == 1)
    if wpart is not None:
        assert tuple(made[wpart].shape) == (grid.wtx_ranges, K, n)
    assert tuple(made[args[41]].shape) == (grid.n_split, K, g)  # part_x
    k1 = "fused_iteration_counts" if counts else "fused_iteration"
    assert {k: v for k, v in kernels.launches.items() if v} == {
        k1: 1, "wtx_mma": 1, "hxt_mma": 1, "wtw_gemm": 1, "gram_wide": 1}


# ---------------------------------------------------------------------------
# the summation order
# ---------------------------------------------------------------------------


def _problem(seed, n, blocks, n_labels, dtype, counts):
    r = np.random.default_rng(seed)
    K = sum(blocks)
    if dtype == "int8":
        X = r.poisson(3.0, (G, n)).clip(0, 127).astype(np.float32)
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


def _emulate_chain(*args, base=None):
    return emulate_chain(*args, base=base)


def _torch_args(X, W, H, WtW, Ys, Bs, lam, C, dtype):
    xdt = MMA[dtype]
    return (torch.from_numpy(X).to(xdt), torch.from_numpy(W), torch.from_numpy(H),
            torch.from_numpy(WtW), [torch.from_numpy(y).to(xdt) for y in Ys],
            [torch.from_numpy(b) for b in Bs], torch.from_numpy(lam), EPS,
            None if C is None else torch.from_numpy(C))


CASES = [(K, n, counts, loss_kl) for K in KS for n in NS for counts in (False, True)
         for loss_kl in ((True,) if counts else (n % 2 == 1,))]


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("K,n,counts,loss_kl", CASES)
def test_chain_emulation_matches_plain(dtype, K, n, counts, loss_kl):
    """The chain's summation order against the plain version (rtol 1e-5):
    every output (XHt against the plain product over the emulation's own
    Hs, and at rtol 1e-4 against the plain XHt), undrawn columns of H bit
    for bit; on the CPU the wrapper is the plain version and counts no
    launch."""
    blocks, n_labels = _blocks(K)
    X, W, H, WtW, Ys, Bs, lam, C = _problem(K * 3 + n, n, blocks, n_labels, dtype, counts)
    args = _torch_args(X, W, H, WtW, Ys, Bs, lam, C, dtype)
    want = kernels.fused_iteration_plain(*args, blocks=blocks, loss_kl=loss_kl)
    got = _emulate_chain(*args[:7], args[8], blocks, loss_kl)
    Hs = got[0] if C is None else got[0] * torch.from_numpy(C[1])
    own = kernels.hxt_plain(args[0], Hs).T
    for i, (a, b) in enumerate(zip(_flat(got), _flat(want), strict=True)):
        np.testing.assert_allclose(a, b, rtol=1e-4 if i == 1 else 1e-5, atol=0)
    np.testing.assert_allclose(got[1].numpy(), own.numpy(), rtol=1e-5, atol=0)
    if counts:
        undrawn = C[0] == 0
        assert undrawn.any()
        np.testing.assert_array_equal(got[0].numpy()[:, undrawn], H[:, undrawn])
    before = dict(kernels.launches)
    same = kernels.fused_iteration(*args, blocks=blocks, loss_kl=loss_kl)
    for a, b in zip(_flat(same), _flat(want), strict=True):
        np.testing.assert_array_equal(a, b)
    assert kernels.launches == before  # plain runs never count


def _pallas(dtype, K, n, blocks, n_labels, counts, seed):
    """The Pallas kernel in interpret mode on the problem padded to its
    tile (pad columns zero and drawn 0 times), and the emulation on the
    first n cells."""
    pad = pk.pad_target(G, n, 1, jnp.dtype(JAX[dtype]).itemsize, K, n_labels,
                        cast_itemsize=pk._cast_itemsize_for_dtype(JAX[dtype]),
                        counts_mode=counts)
    X, W, H, WtW, Ys, Bs, lam, C = _problem(seed, n + pad, blocks, n_labels, dtype, counts)
    X[:, n:] = 0.0
    H[:, n:] = 0.0
    for y in Ys:
        y[:, n:] = 0.0
    if counts:
        C[:, n:] = 0.0
    jdt = JAX[dtype]
    want = pk.fused_iteration(
        jnp.asarray(X).astype(jdt), jnp.asarray(W), jnp.asarray(H), jnp.asarray(WtW),
        tuple(jnp.asarray(y).astype(jdt) for y in Ys), tuple(jnp.asarray(b) for b in Bs),
        jnp.asarray(lam), jnp.float32(EPS), None if C is None else jnp.asarray(C),
        blocks=blocks, loss_kl=True, interpret=True)
    cut = lambda a: np.ascontiguousarray(a[..., :n])
    args = _torch_args(cut(X), W, cut(H), WtW, [cut(y) for y in Ys], Bs, lam,
                       None if C is None else cut(C), dtype)
    return want, _emulate_chain(*args[:7], args[8], blocks, True), pad


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("K,counts", [(K, c) for K in KS for c in (False, True)])
def test_chain_emulation_matches_pallas(dtype, K, counts):
    """The chain's summation order against the Pallas kernel in interpret
    mode at 1,001 cells, at tests/test_torch_kernels.py's tolerances (Hn
    rtol 1e-5 / atol 1e-6, statistics rtol 1e-4).  The pad columns add eps
    per label row to the KL prediction loss, which the comparison takes
    off."""
    n = 1001
    blocks, n_labels = _blocks(K)
    want, got, pad = _pallas(dtype, K, n, blocks, n_labels, counts, K * 5 + n)
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


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("K", KS)
def test_k2_chain_emulation_matches_plain_and_pallas(dtype, K):
    """K2 (no covariates) runs the same chain: the emulation against
    ``fused_h_update_plain`` (rtol 1e-5; XHt 1e-4) and the Pallas kernel in
    interpret mode (its ragged last tile is masked: no padding)."""
    n = 1001
    X, W, H, WtW, _, _, _, _ = _problem(K * 7 + n, n, (K,), (), dtype, False)
    Xt, Wt, Ht, WtWt = _torch_args(X, W, H, WtW, [], [], np.zeros(0, np.float32), None,
                                   dtype)[:4]
    got = _emulate_chain(Xt, Wt, Ht, WtWt, (), (), None, None, (K,), True)
    want = kernels.fused_h_update_plain(Xt, Wt, Ht, WtWt, EPS)
    for i, (a, b) in enumerate(zip(_flat(got), _flat(want), strict=True)):
        np.testing.assert_allclose(a, b, rtol=1e-4 if i == 1 else 1e-5, atol=0)
    pal = pk.fused_h_update(jnp.asarray(X).astype(JAX[dtype]), jnp.asarray(W), jnp.asarray(H),
                            jnp.asarray(WtW), jnp.float32(EPS), interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(pal[0]), rtol=1e-5, atol=1e-6)
    for a, b in zip(got[1:], pal[1:]):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("n,base", [(1001, 1), (1001, 6), (1014, 15), (5040, 1)])
@pytest.mark.parametrize("counts", [False, True])
def test_chain_misaligned_x_gives_the_aligned_bits(dtype, n, base, counts):
    """X at an address off 16-byte alignment (bf16: the even address below)
    and rows off it too (1,001 and 1,014 cells): both X passes staged
    through the aligned windows that cover the rows give the aligned
    chain's bits, every output."""
    K = 40
    blocks, n_labels = _blocks(K)
    X, W, H, WtW, Ys, Bs, lam, C = _problem(n + base, n, blocks, n_labels, dtype, counts)
    args = _torch_args(X, W, H, WtW, Ys, Bs, lam, C, dtype)
    base -= base % args[0].element_size()
    aligned = _emulate_chain(*args[:7], args[8], blocks, True)
    moved = _emulate_chain(*args[:7], args[8], blocks, True, base=base)
    for a, b in zip(_flat(moved), _flat(aligned), strict=True):
        np.testing.assert_array_equal(a, b)

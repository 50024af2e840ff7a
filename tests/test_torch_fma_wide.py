"""P1 ``hxt`` and P2 ``wtx`` above K = 512 on float32/int16 X on the CPU:
the FP32 kernels of csrc/fma_wide.cuh (hxt_fma_wide, wtx_fma_wide), which
run only on the card (tests/test_torch_cuda.py ``-k fma_wide``).  Here:

- their summation order in PyTorch (``emulate_hxt_fma_wide``,
  ``emulate_wtx_fma_wide``: every output one fmaf chain over its terms in
  order, P1's over the cells of each split of ``hxt_fma_wide_grid`` with
  the splits added in order, P2's over all genes; products exact in
  float64, each step rounded to fp32) against ``hxt_plain`` / ``wtx_plain``
  (rtol 1e-5) and against the Pallas kernels of
  ``benchmarks/als_probe.py:_pallas_dots`` run with ``interpret=True``
  (rtol 1e-4, atol 1e-6), at K = 513, 520 and 768 and n = 17, 1,001 and
  5,040 (17 and 1,001: rows off 16-byte alignment);
- the staging of int16 rows off 16-byte alignment: the 4-byte words that
  cover a thread's 8 (P2) or 4 (P1) cells at any 2-byte offset
  (copy_int16_words), read at that offset (widen_int16), give the aligned
  copy's values, zero past n;
- the grid rules (``hxt_fma_wide_grid``, ``wtx_fma_wide_grid``): every
  output and cell covered once, splits of at most 16,384 cells in whole
  chunks, at least two waves of two blocks an SM where the cells allow,
  the bench shape's grids pinned; shared memory that does not grow with K
  (every K to 2,048) and lets two blocks share an SM, the header's sizes
  the same as ``fma_wide_smem_bytes``'s;
- the wrappers and the large-K chain calling the new C entries with the
  grid's arguments (the entries replaced by a recorder), counting their
  launches, and raising on a launch error.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpine_tpu_torch.ops import _build, kernels
from tests.test_torch_als import _close, _probe_dots
from tests.test_torch_wtw_gemm import _recorder
from tests.torch_k_samples import WIDE_SAMPLE

torch.set_num_threads(1)

FP32 = {"float32": torch.float32, "int16": torch.int16}
SHAPES = [(2000, 100_000), (70, 17), (300, 50_001), (300, 66_667), (20_000, 1001), (1, 64)]
GRID_KS = (513, 768, 1030, 2048)
TWO_BLOCKS = min(kernels._MAX_SMEM, kernels._SM_SMEM // 2 - kernels._BLOCK_SMEM_RESERVED)


def _x(r, dtype, shape):
    """int16: counts above 127 and a few negative values; float32:
    fractions."""
    if dtype == "int16":
        return (r.poisson(3.0, shape) * 300 - r.integers(0, 2, shape) * 7).astype(np.float32)
    return r.random(shape, dtype=np.float32)


def _fma_steps(acc, a, b):
    """acc + a b as fmaf forms it: the product exact in float64, the sum
    rounded once to fp32."""
    return (acc.double() + a.double() * b.double()).float()


def emulate_wtx_fma_wide(X, W):
    """wtx_fma_wide's order: out[k][c] one fmaf chain over the genes in
    order from 0.f (zero past g, n and K add nothing)."""
    g, n = X.shape
    Xf = X.float()
    out = torch.zeros((W.shape[1], n), dtype=torch.float32)
    for j in range(g):
        out = _fma_steps(out, W[j][:, None], Xf[j][None, :])
    return out


def emulate_hxt_fma_wide(X, H):
    """hxt_fma_wide's order over ``hxt_fma_wide_grid``: each split's partial
    one fmaf chain over its cells in order, the partials added in split
    order (reduce_splits; one split is the partial itself)."""
    g, n = X.shape
    K = H.shape[0]
    n_split, cps = kernels.hxt_fma_wide_grid(g, n, K, X.dtype)
    Xf = X.float()
    out = None
    for s in range(n_split):
        part = torch.zeros((K, g), dtype=torch.float32)
        for c in range(s * cps, min(n, (s + 1) * cps)):
            part = _fma_steps(part, H[:, c][:, None], Xf[:, c][None, :])
        out = part if out is None else out + part
    return out


# ---------------------------------------------------------------------------
# the orders against the plain versions and the Pallas probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(FP32))
@pytest.mark.parametrize("n", [17, 1001, 5040])
@pytest.mark.parametrize("K", [513, 520, 768])
def test_fma_wide_passes_match_plain_and_pallas_probe(dtype, K, n):
    """Both emulations against the plain versions (rtol 1e-5: fp32 sums in
    another order) and against benchmarks/als_probe.py's Pallas kernels in
    interpret mode on X and H padded to whole 128-cell tiles (rtol 1e-4,
    atol 1e-6, as tests/test_torch_als.py holds them); the CPU wrappers are
    the plain versions."""
    g, tile = 40, 128
    r = np.random.default_rng(K + n)
    X = _x(r, dtype, (g, n))
    H = r.random((K, n), dtype=np.float32) + 0.1
    W = r.random((g, K), dtype=np.float32)
    Xt = torch.from_numpy(X).to(FP32[dtype])
    Ht, Wt = torch.from_numpy(H), torch.from_numpy(W)
    got_h, got_w = emulate_hxt_fma_wide(Xt, Ht), emulate_wtx_fma_wide(Xt, Wt)
    want_h, want_w = kernels.hxt_plain(Xt, Ht), kernels.wtx_plain(Xt, Wt)
    np.testing.assert_allclose(got_h.numpy(), want_h.numpy(), rtol=1e-5, atol=0)
    np.testing.assert_allclose(got_w.numpy(), want_w.numpy(), rtol=1e-5, atol=0)
    assert torch.equal(kernels.hxt(Xt, Ht), want_h) and torch.equal(kernels.wtx(Xt, Wt), want_w)
    n_pad = -(-n // tile) * tile
    Xj = jnp.asarray(X).astype(jnp.int16 if dtype == "int16" else jnp.float32)
    Xp = jnp.pad(Xj, ((0, 0), (0, n_pad - n)))
    Hp = jnp.pad(jnp.asarray(H), ((0, 0), (0, n_pad - n)))
    hxt, wtx = _probe_dots(g, K, tile, n_pad)
    _close(got_h, hxt(Xp, Hp), 1e-4, 1e-6 * float(np.abs(want_h.numpy()).max()))
    _close(got_w, np.asarray(wtx(Xp, jnp.asarray(W)))[:, :n], 1e-4,
           1e-6 * float(np.abs(want_w.numpy()).max()))


# ---------------------------------------------------------------------------
# int16 rows off 16-byte alignment: the words that cover them
# ---------------------------------------------------------------------------


def stage_int16_cells(mem, x_at, e, first, valid, cells, row_ok=True):
    """copy_int16_words then widen_int16, on a byte image ``mem`` of device
    memory in which X starts at byte ``x_at`` (even): a thread's cells / 2
    + 1 words from the word holding element e (its first cell, cell
    ``first`` of its row), those whose lower cell (first - shift + 2 w)
    lies below ``valid`` copied, the others zero; then its ``cells`` values
    from element shift, zero from cell ``valid`` on."""
    shift = (x_at // 2 + e) & 1
    base = (x_at + 2 * e) & ~3
    words = np.zeros(cells + 2, np.int16)
    for w in range(cells // 2 + 1):
        if row_ok and first - shift + 2 * w < valid:
            words[2 * w:2 * w + 2] = mem[base + 4 * w:base + 4 * w + 4].view(np.int16)
    return np.array([words[shift + t] if row_ok and first + t < valid else 0
                     for t in range(cells)], np.int16)


@pytest.mark.parametrize("cells", [8, 4])
@pytest.mark.parametrize("n", [17, 1001, 5003, 5040])
@pytest.mark.parametrize("x_at", [0, 2, 6])
def test_int16_words_give_the_aligned_values(cells, n, x_at):
    """Every thread's cells of every stage (P2: 8 cells, 16 threads over 128
    cells of a gene row; P1: 4 cells, each of the two lanes of a row taking
    2 groups of 16) read through its words give the row's values, zero past
    n, and zero for a row past g: X at a 2-byte offset from a 4-byte
    boundary, and odd n (every other row shifted)."""
    r = np.random.default_rng(n + x_at)
    g = 5
    X = (r.poisson(3.0, (g, n)) * 300 - r.integers(0, 2, (g, n)) * 7).astype(np.int16)
    mem = np.zeros(x_at + 2 * g * n + 16, np.uint8)
    mem[x_at:x_at + 2 * g * n] = X.view(np.uint8).reshape(-1)
    for row in range(g):
        for first in range(0, n, cells):
            got = stage_int16_cells(mem, x_at, row * n + first, first, n, cells)
            want = np.zeros(cells, np.int16)
            want[:min(cells, n - first)] = X[row, first:first + cells]
            np.testing.assert_array_equal(got, want)
    assert not stage_int16_cells(mem, x_at, 0, 0, n, cells, row_ok=False).any()


@pytest.mark.parametrize("n,x_at", [(17, 0), (17, 2), (1001, 2), (5040, 2)])
def test_int16_words_stay_inside_the_rows_bytes(n, x_at):
    """Every word a thread copies (8 or 4 cells) starts at most one element
    before its row and before the row's end: it holds a cell of the row (or
    the element just before the row's first, which shares its word), so no
    copy reads a word of which X's buffer holds no byte."""
    for cells in (8, 4):
        for row in range(3):
            for first in range(0, n, cells):
                e = row * n + first
                shift = (x_at // 2 + e) & 1
                base = (x_at + 2 * e) & ~3
                for w in range(cells // 2 + 1):
                    if first - shift + 2 * w < n:  # copied
                        lo = base + 4 * w
                        assert x_at + 2 * row * n - 2 <= lo < x_at + 2 * (row + 1) * n


# ---------------------------------------------------------------------------
# the grid rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(FP32))
@pytest.mark.parametrize("g,n", SHAPES)
@pytest.mark.parametrize("K", GRID_KS)
def test_hxt_fma_wide_grid_covers_each_cell_once(dtype, g, n, K):
    """Whole 16-cell chunks, at most 16,384 cells a split, no empty split,
    every cell in one split; at least two waves of two blocks an SM on 132
    SMs, or splits no longer than the fewest chunks that would give them;
    at most twice as many splits as the 16,384-cell cap or the two waves
    ask for."""
    n_split, cps = kernels.hxt_fma_wide_grid(g, n, K, FP32[dtype])
    d = kernels.wtw_design()
    bk = d["chunk"]
    assert cps % bk == 0 and cps <= kernels._WIDE_SPLIT_CELLS
    seen = np.zeros(n, np.int64)
    for s in range(n_split):
        assert s * cps < n  # no empty split
        seen[s * cps:(s + 1) * cps] += 1
    assert (seen == 1).all()
    tiles = -(-K // d["tile"][0]) * -(-g // d["tile"][1])
    chunks, waves = -(-n // bk), -(-2 * 2 * kernels._SMS // tiles)
    assert tiles * n_split >= 2 * 2 * kernels._SMS or cps <= -(-chunks // min(chunks, waves)) * bk
    assert n_split <= 2 * max(-(-n // kernels._WIDE_SPLIT_CELLS), waves)


@pytest.mark.parametrize("dtype", list(FP32))
@pytest.mark.parametrize("g,n", SHAPES)
@pytest.mark.parametrize("K", GRID_KS)
def test_wtx_fma_wide_grid_covers_each_output_once(dtype, g, n, K):
    """A block a 128 x 128 output tile, the row tiles of a cell tile back to
    back: every (row of K, cell) in one block."""
    T, chunk, S, blocks = kernels.wtx_fma_wide_grid(g, n, K, FP32[dtype])
    d = kernels.wtw_design()
    assert (T, chunk, S) == (d["tile"][1], d["chunk"], kernels._FW_STAGES)
    KT = -(-K // d["tile"][0])
    assert blocks == KT * -(-n // T)
    seen = np.zeros((KT * d["tile"][0], blocks // KT * T), np.int64)
    for b in range(blocks):
        k0, c0 = b % KT * d["tile"][0], b // KT * T
        seen[k0:k0 + d["tile"][0], c0:c0 + T] += 1
    assert (seen[:K, :n] == 1).all()


def test_fma_wide_grids_at_the_bench_shape():
    """2,000 genes x 100k cells: P1 at K = 768 96 tiles x 11 splits of 9,104
    cells (1,056 blocks: four whole waves of 264), at 1,024 and 2,048 8 and
    7 splits; P2 at K = 768 6 x 782 tiles; both the same on float32 and
    int16 X, and the 66,667-cell fold the grid of its 66,672-cell twin."""
    for xdt in FP32.values():
        assert kernels.hxt_fma_wide_grid(2000, 100_000, 768, xdt) == (11, 9104)
        assert kernels.hxt_fma_wide_grid(2000, 100_000, 1024, xdt) == (8, 12512)
        assert kernels.hxt_fma_wide_grid(2000, 100_000, 2048, xdt) == (7, 14288)
        assert kernels.wtx_fma_wide_grid(2000, 100_000, 768, xdt) == (128, 16, 2, 4692)
        assert (kernels.hxt_fma_wide_grid(2000, 66_667, 768, xdt)
                == kernels.hxt_fma_wide_grid(2000, 66_672, 768, xdt))
    assert kernels._wave_share(96 * 11, 2) == 1.0


@pytest.mark.parametrize("dtype", list(FP32))
def test_fma_wide_shared_memory_does_not_grow_with_k(dtype):
    """Every K from 513 to 2,048: one size a kernel, within what two blocks
    an SM may take; the header's sizes are the Python formula's."""
    xdt = FP32[dtype]
    for kind in ("hxt", "wtx"):
        sizes = {kernels.fma_wide_smem_bytes(kind, xdt) for K in range(513, 2049)
                 if kernels.route(K) == "wide"}
        assert len(sizes) == 1 and sizes.pop() <= TWO_BLOCKS
    text = (_build.CSRC / "fma_wide.cuh").read_text()
    assert re.search(r"constexpr int kFwStages = (\d+);", text).group(1) == str(
        kernels._FW_STAGES)
    d = kernels.wtw_design()
    row = re.search(r"constexpr int kFwRow = kGemmBK \+ (\d+), kFwTurn = kGemmBM \+ (\d+);",
                    text)
    words = re.search(r"constexpr int kFwWtxWords = (\d+), kFwHxtWords = (\d+);", text)
    assert row and (d["chunk"] + int(row.group(1)), d["tile"][0] + int(row.group(2))) == (
        kernels._FW_ROW, kernels._FW_TURN)
    assert words and (int(words.group(1)), int(words.group(2))) == (
        kernels._FW_WORDS["wtx"], kernels._FW_WORDS["hxt"])
    # P1's staged rows: a turn's 16-byte reads by a quarter-warp (4 rows x
    # the 2 lanes of a row, 4 cells apart) touch 8 different bank groups;
    # its stores into the turned tiles (16 rows x 2 lanes, cells 4 apart)
    # touch 32 different banks
    assert len({(4 * kernels._FW_ROW * r + 16 * p) % 128 for r in range(4) for p in range(2)}) == 8
    for c in range(4):
        assert len({(c + 4 * p) * kernels._FW_TURN % 32 + r for r in range(16)
                    for p in range(2)}) == 32
    assert kernels._FW_TURN % 4 == 0 and kernels._FW_ROW % 4 == 0
    # an int16 row holds its threads' slots of words (P2: 16 threads of 8
    # cells, 5 words each; P1: 2 threads of 2 x 4 cells, 3 words each)
    assert kernels._FW_WORDS["wtx"] >= 16 * 5 and kernels._FW_WORDS["hxt"] >= 2 * 2 * 3
    assert all(4 * kernels._FW_WORDS[k] % 16 == 0 for k in ("wtx", "hxt"))


@pytest.mark.parametrize("K", [1, 40, 512])
def test_fma_wide_grids_reject_what_the_kernels_do_not_take(K):
    """K <= 512 and int8/bf16 X raise; the K <= 512 rules raise above 512,
    naming the large-K rule."""
    for rule in (kernels.hxt_fma_wide_grid, kernels.wtx_fma_wide_grid):
        with pytest.raises(ValueError, match="K > 512"):
            rule(100, 100, K, torch.float32)
        for xdt in (torch.int8, torch.bfloat16):
            with pytest.raises(ValueError, match="float32 and int16"):
                rule(100, 100, K + 600, xdt)
    for rule, wide in ((kernels.hxt_fma_grid, "hxt_fma_wide_grid"),
                       (kernels.wtx_fma_grid, "wtx_fma_wide_grid")):
        with pytest.raises(ValueError, match=wide):
            rule(100, 100, K + 600, torch.int16)


# ---------------------------------------------------------------------------
# the wrappers and the chain call the new entries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(FP32))
@pytest.mark.parametrize("K,n", [(513, 17), (768, 1001), (2048, 300)])
def test_wrappers_take_the_fma_wide_entries(monkeypatch, dtype, K, n):
    """hxt and wtx at K > 512 on float32/int16 X call alpine_hxt_fma_wide
    (the grid's splits, a partial buffer only with more than one split)
    and alpine_wtx_fma_wide, each counted as its pass and as its kernel."""
    calls, made = _recorder(monkeypatch)
    g = 40
    X = torch.ones((g, n), dtype=FP32[dtype])
    kernels.reset_launches()
    kernels.hxt(X, torch.ones((K, n)))
    kernels.wtx(X, torch.ones((g, K)))
    (h, ah), (w, aw) = calls
    n_split, cps = kernels.hxt_fma_wide_grid(g, n, K, X.dtype)
    assert h == "hxt_fma_wide" and ah[1] == kernels._XTYPE[X.dtype]
    assert ah[3:8] == (g, n, K, n_split, cps)
    assert (ah[8] is None) == (n_split == 1)
    if ah[8] is not None:
        assert tuple(made[ah[8]].shape) == (n_split, K, g)
    assert tuple(made[ah[9]].shape) == (K, g)
    assert w == "wtx_fma_wide" and aw[3:6] == (g, n, K) and tuple(made[aw[6]].shape) == (K, n)
    assert {k: kernels.launches[k] for k in ("hxt", "wtx", "hxt_fma_wide", "wtx_fma_wide",
                                             "hxt_wide", "wtx_wide")} == {
        "hxt": 1, "wtx": 1, "hxt_fma_wide": 1, "wtx_fma_wide": 1, "hxt_wide": 0, "wtx_wide": 0}


@pytest.mark.parametrize("dtype", list(FP32))
def test_chain_passes_the_fma_wide_grid(monkeypatch, dtype):
    """K1's large-K chain on float32/int16 X: the 16 ints of
    ``wide_iteration_grid`` (P2: 128-cell tiles, no cluster, 16-gene chunks,
    the ring's 2 stages, one range; P1: 128-gene tiles and the splits of
    ``hxt_fma_wide_grid``) and one launch of each fp32 kernel counted."""
    calls, made = _recorder(monkeypatch)
    K, n, g = 768, 1001, 40
    blocks = (192, 192, 384)
    X = torch.ones((g, n), dtype=FP32[dtype])
    Ys = [torch.ones((2, n), dtype=X.dtype), torch.ones((3, n), dtype=X.dtype)]
    Bs = [torch.ones((2, 192)), torch.ones((3, 192))]
    kernels.reset_launches()
    kernels.fused_iteration(X, torch.ones((g, K)), torch.ones((K, n)), torch.ones((K, K)), Ys,
                            Bs, torch.ones(2), 1e-6, blocks=blocks, loss_kl=True)
    ((name, args),) = calls
    assert name == "fused_iteration"
    grid = kernels.wide_iteration_grid(g, n, K, X.dtype)
    assert args[17:33] == tuple(grid) and len(grid) == 16
    d, S = kernels.wtw_design(), kernels._FW_STAGES
    assert grid[3:9] == (d["tile"][1], 1, d["chunk"], S, 1, g)
    assert grid[9:14] == (d["tile"][1], *kernels.hxt_fma_wide_grid(g, n, K, X.dtype), S,
                          d["chunk"])
    assert tuple(made[args[41]].shape) == (grid.n_split, K, g)  # part_x
    assert {k: kernels.launches[k] for k in ("fused_iteration", "hxt_fma_wide", "wtx_fma_wide",
                                             "hxt_wide", "wtx_wide", "gram_wide",
                                             "wtw_gemm")} == {
        "fused_iteration": 1, "hxt_fma_wide": 1, "wtx_fma_wide": 1, "hxt_wide": 0,
        "wtx_wide": 0, "gram_wide": 1, "wtw_gemm": 1}


@pytest.mark.parametrize("dtype", list(FP32))
def test_k512_passes_keep_their_entries(monkeypatch, dtype):
    """At K <= 512 hxt and wtx on float32/int16 X still call alpine_hxt and
    alpine_wtx with hxt_fma_grid's and wtx_fma_grid's arguments (no range
    of K among them)."""
    calls, _ = _recorder(monkeypatch)
    g, n, K = 40, 1001, 512
    X = torch.ones((g, n), dtype=FP32[dtype])
    kernels.reset_launches()
    kernels.hxt(X, torch.ones((K, n)))
    kernels.wtx(X, torch.ones((g, K)))
    (h, ah), (w, aw) = calls
    GB, n_split, cps, S, chunk = kernels.hxt_fma_grid(g, n, K, X.dtype)
    assert h == "hxt" and ah[3:11] == (g, n, K, GB, n_split, cps, S, chunk)
    T, LK, GC, S, _ = kernels.wtx_fma_grid(g, n, K, X.dtype)
    assert w == "wtx" and aw[3:12] == (g, n, K, T, LK, GC, S, 1, g)
    assert kernels.launches["hxt_fma_wide"] == kernels.launches["wtx_fma_wide"] == 0


@pytest.mark.parametrize("kind", ["hxt", "wtx"])
def test_fma_wide_wrappers_raise_on_a_launch_error(monkeypatch, kind):
    """A failed launch raises and counts nothing (no plain fallback)."""
    calls, _ = _recorder(monkeypatch, rc=1)
    X = torch.ones((40, 17))
    P = torch.ones((600, 17)) if kind == "hxt" else torch.ones((40, 600))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match=f"{kind} kernel failed to launch: CUDA error 1"):
        getattr(kernels, kind)(X, P)
    assert calls[0][0] == f"{kind}_fma_wide"
    assert kernels.launches[kind] == kernels.launches[f"{kind}_fma_wide"] == 0


def test_wide_sample_takes_the_fma_wide_grids():
    """Every K of the large-K sample gets both grids on both storage types."""
    for K in WIDE_SAMPLE:
        for xdt in FP32.values():
            assert kernels.hxt_fma_wide_grid(2000, 100_000, K, xdt)[0] >= 7
            assert kernels.wtx_fma_wide_grid(2000, 100_000, K, xdt)[3] == (
                -(-K // 128) * -(-100_000 // 128))

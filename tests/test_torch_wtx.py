"""The grid rules of P2 ``wtx``'s bf16 path on the CPU: ``kernels.wtx_grid``
for K <= 512 and ``kernels.wtx_wide_grid`` above.

The CUDA kernels (csrc/x_passes.cu: round_w, then wtx_mma; above K = 512
csrc/x_passes_wide.cuh: wtx_wide) run only on the card; these tests hold
what they are given: every cell covered once by tiles that are multiples
of 16, all of K in one pass within 48 accumulators a thread (K <= 512),
shared memory within a Hopper block's limit (two blocks an SM for K <=
512), the bench shape's grid pinned, and an emulation of the kernel's
arithmetic over that grid (W rounded to bf16, exact products, fp32 sums
chunk by chunk over the genes) equal to ``wtx_plain`` at rtol 1e-5 (fp32
sums of positive terms in another order).  The float32/int16 path takes
``wtx_fma_grid`` (tests/test_torch_fp32_passes.py); the wide kernel's
operands: tests/test_torch_wide_passes.py.
"""

import numpy as np
import pytest
import torch

from alpine_tpu_torch.ops import kernels
from alpine_tpu_torch.ops.mu import round_partner
from tests.torch_k_samples import COVER_KS

MMA = {"int8": torch.int8, "bfloat16": torch.bfloat16}
KS = (1, 5, 13, 30, 64, 65, 300, 512, 600, 768, 2048)
SLOTS = 2 * kernels._SMS  # two blocks an SM


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("g,n", [(2000, 100_000), (70, 17), (300, 50_001),
                                 (300, 50_016), (20_000, 1001), (1, 64)])
@pytest.mark.parametrize("K", KS)
def test_wtx_grid_covers_each_cell_once(dtype, g, n, K):
    if K > 512:  # 128-cell tiles in whole clusters, 64-gene stages
        CL, _, _, S = kernels.wtx_wide_grid(g, n, K, MMA[dtype])
        T, WR, GC = kernels._WIDE_BM, 8, kernels._WIDE_BK
        blocks = -(-n // T)
        assert kernels._wide_tiles("wtx", n, K) == -(-blocks // CL) * CL * -(-K // kernels._WIDE_BN)
    else:
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
    """For every K the kernel takes: one pass over X a range of K (every
    fragment row of Kp held by some warp row, at most 6 a warp), at most 48
    accumulators a thread, no idle warp row, and the ring within half an
    SM's shared memory (two blocks an SM): 64 genes a stage where two such
    stages fit, else 32, with the most stages that fit (each X row with
    room for the aligned window of a row off 16-byte alignment).  Above
    K = 512 the wide kernel: one block an SM, the most stages that fit."""
    xdt = MMA[dtype]
    budget = min(kernels._MAX_SMEM, kernels._SM_SMEM // 2 - 1024)
    for n in (100_000, 5040):
        for K in COVER_KS:
            if K > 512:  # the wide kernel: one block an SM, the most stages
                S = kernels.wtx_wide_grid(2000, n, K, xdt)[3]
                for aligned in (False, True):
                    smem = kernels.x_wide_smem_bytes("wtx", S, xdt, aligned)
                    assert smem <= kernels._MAX_SMEM
                    # the ring holds the epilogue's 256 x 132 fp32 outputs
                    assert smem - 1024 - 16 * S >= 256 * 132 * 4
                assert S == 8 or kernels.x_wide_smem_bytes("wtx", S + 1, xdt) > kernels._MAX_SMEM
                continue
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
    """float32/int16 X and K = 0 raise; K = 513 .. 2048 take the large-K
    route: wtx_grid and wtx_gene_split refuse them, wtx_wide_grid takes
    them (one 128-cell tile, a block alone, all 100 genes in one
    range) within a Hopper block and refuses K <= 512."""
    for xdt in (torch.float32, torch.int16):
        with pytest.raises(ValueError, match="int8 and bf16"):
            kernels.wtx_grid(100, 100, 8, xdt)
        with pytest.raises(ValueError, match="int8 and bf16"):
            kernels.wtx_wide_grid(100, 100, 768, xdt)
    with pytest.raises(ValueError, match="K=0"):
        kernels.wtx_grid(100, 100, 0, torch.int8)
    with pytest.raises(ValueError, match="K > 512"):
        kernels.wtx_wide_grid(100, 100, 512, torch.int8)
    for K in (513, 600, 768, 1024, 1025, 2048):
        for rule in (kernels.wtx_grid, kernels.wtx_gene_split):
            with pytest.raises(ValueError, match="wtx_wide_grid"):
                rule(100, 100, K, torch.int8)
        CL, ranges, genes, S = kernels.wtx_wide_grid(100, 100, K, torch.int8)
        assert (CL, ranges, genes) == (1, 1, 128)
        assert kernels.x_wide_smem_bytes("wtx", S, torch.int8) <= kernels._MAX_SMEM


# ---- X rows at any byte alignment: the aligned-window staging -----------
#
# The bf16 X passes copy each X row's slice of a chunk as the 16-byte-aligned
# window that covers it (csrc/x_passes.cu: window_src); wtx then shifts each
# B registers from byte loads at each row's offset, hxt reads a lane's 8
# cells at the row's offset (lds8_at / lds16_at, keep_bytes).  These helpers do
# the same word by word on X's bytes laid out at a chosen address, so the
# tests hold the kernels' index arithmetic: every value lands where the
# aligned path puts it; hxt reads cells past n as zero.


def device_bytes(X, base):
    """X's bytes as on the card at byte address ``base`` of a buffer (the
    address of byte i is its index), with room past the end for a window's
    last 16-byte read."""
    raw = X.contiguous().view(torch.uint8).numpy().reshape(-1)
    mem = np.zeros(base + raw.size + 32, np.uint8)
    mem[base:base + raw.size] = raw
    return mem


def stage_windows(mem, base, rows, n, sz, c0, width):
    """The bytes a ring stage holds for X's rows ``rows`` (an array) from
    cell c0: 16-byte copies of each row's aligned window, width * sz / 16
    + 1 of them, zero once a copy starts past the row; and each row's
    byte offset from a 16-byte boundary."""
    row = base + rows.astype(np.int64) * n * sz
    start = (row + c0 * sz) & ~15
    copies = width * sz // 16 + 1
    src = start[:, None] + 16 * np.arange(copies)[None, :]
    ok = (src < (row + n * sz)[:, None])[..., None]
    idx = np.where(ok, src[..., None] + np.arange(16), 0)
    stage = np.where(ok, mem[idx], 0).astype(np.uint8).reshape(len(rows), copies * 16)
    # the staged rows are padded in shared memory: room for a read past
    return np.concatenate([stage, np.zeros((len(rows), 16), np.uint8)], 1), row & 15


def funnel(lo, hi, sh):
    """__funnelshift_r(lo, hi, sh): the 64 bits hi:lo shifted right by sh."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v >> np.asarray(sh, np.uint64)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def keep_bytes(w, keep):
    """keep_bytes: the word with only its first ``keep`` bytes (clipped 0..4)."""
    keep = np.clip(keep, 0, 4).astype(np.uint64)
    return (w.astype(np.uint64) & ((np.uint64(1) << (8 * keep)) - np.uint64(1))).astype(np.uint32)


def words_at(stage, o, count):
    """``count`` words from byte o (per row, any offset) of staged rows: the
    aligned words that cover them, funnel-shifted (lds8_at, lds16_at)."""
    words = stage.view("<u4")
    q, sh = o[:, None] >> 2, (o[:, None] & 3) * 8
    out = [funnel(np.take_along_axis(words, q + j, 1), np.take_along_axis(words, q + j + 1, 1),
                  sh) for j in range(count)]
    return np.concatenate(out, 1)


def at_offsets(stage, off, B):
    """The B bytes of each staged row from its offset on: what wtx's lanes
    read where X's rows are off 16-byte alignment."""
    return np.stack([row[o:o + B] for row, o in zip(stage, off)])


def ldsm_x4_trans(rows):
    """ldmatrix.sync.aligned.m8n8.x4.trans.b16 as PTX defines it: ``rows``
    (32, 16) bytes, lane i's address giving row i % 8 of matrix i // 8 (8
    b16 elements); with .trans lane t gets from matrix m the elements of
    rows 2 (t % 4) and 2 (t % 4) + 1 in column t // 4, the first in the low
    half.  Returns (32, 4) uint32."""
    e = rows.view("<u2").astype(np.uint32)  # (32, 8) b16 elements
    t = np.arange(32)
    out = np.empty((32, 4), np.uint32)
    for m in range(4):
        out[:, m] = e[8 * m + 2 * (t % 4), t // 4] | e[8 * m + 2 * (t % 4) + 1, t // 4] << 16
    return out


def fragments_at_offsets(stage, off, g32, cw, nt, ks, int8):
    """The B registers wtx_mma's misaligned instantiation builds from byte
    (int8) or 2-byte (bf16) loads of the staged windows at each row's
    offset (csrc/x_passes.cu), for every lane: (32, 4) uint32."""
    out = np.empty((32, 4), np.uint32)
    for lane in range(32):
        for m in range(4):
            if int8:
                ga = g32 + 8 * m + 2 * (lane & 3)
                c = cw + nt * 16 + 2 * (lane >> 2)
                pa, pb = stage[ga, off[ga] + c:], stage[ga + 1, off[ga + 1] + c:]
                out[lane, m] = (int(pa[0]) | int(pa[1]) << 8 | int(pb[0]) << 16
                                | int(pb[1]) << 24)
            else:
                ga = g32 + ks * 16 + 8 * (m & 1) + 2 * (lane & 3)
                c = cw + nt * 16 + 8 * (m >> 1) + (lane >> 2)
                lo = stage[ga, off[ga] + 2 * c:].view("<u2")[0]
                hi = stage[ga + 1, off[ga + 1] + 2 * c:].view("<u2")[0]
                out[lane, m] = int(lo) | int(hi) << 16
    return out


def as_values(raw, dtype):
    """Staged bytes (rows, bytes) read as X's values, in float32."""
    if dtype == torch.int8:
        return torch.from_numpy(raw.view(np.int8).astype(np.float32))
    bits = raw.view("<u2").astype(np.uint32) << 16
    return torch.from_numpy(bits.view(np.float32))


def _emulate_wtx(X, W, K, base=None):
    """wtx_mma's arithmetic in PyTorch over wtx_grid's tiles and
    wtx_gene_split's ranges: W rounded to bf16 (round_w), and each tile's
    K x T outputs summed over its range's genes in chunks of GC, 16 genes a
    product, in gene order; with several ranges their partials added in
    range order from zero.  ``base`` None takes X's values as they are (the
    aligned path); an address stages each tile through the aligned windows
    of X laid out there and reads each row from its offset.  Above K = 512
    wtx_wide's (tests/test_torch_wide_passes.py)."""
    if kernels.route(K) == "wide":
        from tests.test_torch_wide_passes import emulate_wtx_wide
        return emulate_wtx_wide(X, W, base)
    g, n = X.shape
    T, _, GC, _, blocks = kernels.wtx_grid(g, n, K, X.dtype)
    ranges, range_genes = kernels.wtx_gene_split(g, n, K, X.dtype)
    Wb, Xf = round_partner(W, X.dtype).T, X.float()
    sz = X.element_size()
    mem = None if base is None else device_bytes(X, base)
    out = torch.zeros((K, n), dtype=torch.float32)
    for b in range(blocks):
        c0, c1 = b * T, min(n, (b + 1) * T)
        if mem is None:
            Xt = Xf[:, c0:c1]
        else:
            stage, off = stage_windows(mem, base, np.arange(g), n, sz, c0, T)
            # the places of cells past n may hold bytes from past the row:
            # their outputs are never stored
            Xt = as_values(at_offsets(stage, off, T * sz), X.dtype)[:, :c1 - c0]
        total = torch.zeros((K, c1 - c0), dtype=torch.float32)
        for r in range(ranges):
            acc = torch.zeros((K, c1 - c0), dtype=torch.float32)
            for g0 in range(r * range_genes, min(g, (r + 1) * range_genes), GC):
                for k0 in range(g0, min(g, g0 + GC), 16):
                    k1 = min(g, k0 + 16)
                    acc += Wb[:, k0:k1] @ Xt[k0:k1]
            total = acc if ranges == 1 else total + acc
        out[:, c0:c1] = total
    return out


def _x_and_w(dtype, g, n, K, seed, signed=False):
    """Counts (int8) or uniform values (bf16) and W; ``signed`` shifts X
    so that some values are negative (their bytes have the top bit set)."""
    r = np.random.default_rng(seed)
    if dtype == "int8":
        X = r.poisson(3.0, (g, n)) - (r.integers(0, 2, (g, n)) * 5 if signed else 0)
        X = torch.from_numpy(X.clip(-128, 127).astype(np.int8))
    else:
        X = torch.from_numpy(r.random((g, n), dtype=np.float32) - (0.25 if signed else 0.0)
                             ).to(torch.bfloat16)
    return X, torch.from_numpy(r.random((g, K), dtype=np.float32))


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("g,n", [(150, 17), (150, 1001), (150, 5040), (600, 1001)])
@pytest.mark.parametrize("K", KS)
def test_wtx_grid_emulation_matches_plain(dtype, g, n, K):
    """150 genes are not a multiple of the 32-gene chunk; 600 genes at 1001
    cells split into gene ranges."""
    X, W = _x_and_w(dtype, g, n, K, K * 11 + n + g)
    want = kernels.wtx_plain(X, W)
    got = _emulate_wtx(X, W, K)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=0)
    # the CPU wrapper is the plain version
    assert torch.equal(kernels.wtx(X, W), want)


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("n", [1009, 1014, 1019, 1024])
@pytest.mark.parametrize("base", [0, 1, 6, 15])
def test_wtx_window_staging_gives_the_aligned_bits(dtype, n, base):
    """X at a base address off 16-byte alignment (bf16: the even address
    below) and rows of n mod 16 = 1, 6, 11 (every row offset 0-15 occurs)
    or 0: the tiles staged through the aligned windows and read at each
    row's offset give the aligned path's values, so its bits, and the
    plain version's sums
    at rtol 1e-5, atol 1e-5 max|plain| (X holds negative values, whose
    bytes have the top bit set: sums near zero cancel); 600 genes split
    into two gene ranges."""
    K = 40
    X, W = _x_and_w(dtype, 600, n, K, n + base, signed=True)
    base -= base % X.element_size()
    assert kernels.wtx_gene_split(600, n, K, X.dtype)[0] > 1
    got, want = _emulate_wtx(X, W, K, base=base), kernels.wtx_plain(X, W)
    assert torch.equal(got, _emulate_wtx(X, W, K))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("K", KS)
def test_wtx_gene_split_covers_each_gene_once(dtype, K):
    """Gene ranges are whole ring chunks, at least 4 a range, each gene in
    one range; tiles × ranges stay within one wave (two blocks an SM), and
    a grid of a wave or more keeps one range.  Above K = 512 (wtx_wide's
    ranges of 64-gene stages): 1..4 ranges, only where the tiles fill less
    than four waves of one block an SM."""
    for g, n in ((2000, 8192), (2000, 100_000), (2000, 66_667), (600, 1001),
                 (20_000, 1001), (70, 17), (1, 64)):
        if K > 512:
            _, ranges, per, _ = kernels.wtx_wide_grid(g, n, K, MMA[dtype])
            tiles = kernels._wide_tiles("wtx", n, K)
            assert per % kernels._WIDE_BK == 0 and 1 <= ranges <= 4
            assert ranges == 1 or (tiles < 4 * kernels._SMS and per // kernels._WIDE_BK >= 4)
            seen = np.zeros(g, np.int64)
            for r in range(ranges):
                assert r * per < g  # no empty range
                seen[r * per:(r + 1) * per] += 1
            assert (seen == 1).all()
            continue
        T, _, GC, _, blocks = kernels.wtx_grid(g, n, K, MMA[dtype])
        ranges, per = kernels.wtx_gene_split(g, n, K, MMA[dtype])
        assert per % GC == 0
        seen = np.zeros(g, np.int64)
        for r in range(ranges):
            assert r * per < g  # no empty range
            seen[r * per:(r + 1) * per] += 1
        assert (seen == 1).all()
        if ranges > 1:
            assert per // GC >= 4 and blocks * ranges <= SLOTS
        if blocks >= SLOTS:
            assert ranges == 1


def test_wtx_gene_split_fills_a_wave_at_8192_cells():
    """The minibatch steps' shape (2,000 × 8,192, K = 40): 128 tiles of 64
    cells fill half a wave; two gene ranges of 16 chunks of 64 genes fill
    256 of the 264 slots.  At 100k cells the grid keeps one range."""
    for xdt in MMA.values():
        T, _, GC, _, blocks = kernels.wtx_grid(2000, 8192, 40, xdt)
        assert (T, GC, blocks) == (64, 64, 128)
        assert kernels.wtx_gene_split(2000, 8192, 40, xdt) == (2, 1024)
        for K in (5, 30, 40, 512):
            assert kernels.wtx_gene_split(2000, 100_000, K, xdt)[0] == 1


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("n", [1009, 1014, 1019])
@pytest.mark.parametrize("base", [0, 1, 6, 15])
def test_wtx_byte_load_fragments_are_what_ldmatrix_gives(dtype, n, base):
    """For X rows off 16-byte alignment wtx_mma builds each lane's B
    registers from loads at each row's offset in the staged windows; they
    equal what ldmatrix.trans (as PTX defines it) gives on the same cells
    staged aligned, for every lane, 16-cell group, k16 step and 32-gene
    slice of a 64-gene chunk and 64-cell tile."""
    X, _ = _x_and_w(dtype, 64, n, 1, n + base, signed=True)
    sz = X.element_size()
    base -= base % sz
    T, c0 = 64, 128  # a tile of 64 cells from cell 128
    stage, off = stage_windows(device_bytes(X, base), base, np.arange(64), n, sz, c0, T)
    tile = X[:, c0:c0 + T].contiguous().view(torch.uint8).numpy()  # the aligned staging
    for g32 in (0, 32):
        for cw in (0, 32):
            for nt in (0, 1):
                for ks in ((0,) if sz == 1 else (0, 1)):
                    if sz == 1:  # lane i: gene g32 + i, 16 bytes of cells
                        rows = tile[g32 + np.arange(32), cw + nt * 16:cw + nt * 16 + 16]
                    else:  # lane i: gene g32 + 16 ks + i % 16, cells (i // 16) 8 on
                        lanes = np.arange(32)
                        first = (cw + nt * 16 + (lanes >> 4) * 8) * 2
                        rows = np.stack([tile[g32 + ks * 16 + (i & 15), f:f + 16]
                                         for i, f in zip(lanes, first)])
                    want = ldsm_x4_trans(np.ascontiguousarray(rows))
                    got = fragments_at_offsets(stage, off, g32, cw, nt, ks, sz == 1)
                    np.testing.assert_array_equal(got, want)

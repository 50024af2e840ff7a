"""P1 ``hxt`` and P2 ``wtx`` above K = 512 on int8/bf16 X on the CPU: the
wgmma kernels of csrc/x_passes_wide.cuh (hxt_wide, wtx_wide), which run
only on the card (tests/test_torch_cuda.py ``-k wide``).  Here:

- their summation order in PyTorch (``emulate_hxt_wide``,
  ``emulate_wtx_wide``: H or W rounded to bf16, X widened exactly, fp32
  sums split by split (hxt) or range by range (wtx) in order, 16 values a
  product) against ``hxt_plain`` / ``wtx_plain`` (rtol 1e-5) and against
  the Pallas kernels of ``benchmarks/als_probe.py:_pallas_dots`` run with
  ``interpret=True`` (rtol 1e-4), at K = 513, 520, 768, 1024 and n = 17,
  1,001, 5,003 (rows off 16-byte alignment) and 8,192;
- the index arithmetic of the kernels' operands: hxt_wide's slot order
  (round_h_wide's Hb' against the cells its lanes put in the A fragments),
  its lanes' reads of the TMA tile (plain int8 rows, bf16 rows in the
  128-byte swizzle) and of the aligned windows of rows off alignment
  (lds16_at at each row's offset, masked past n); wtx_wide's ldmatrix.trans
  addresses in the swizzled tile and the byte loads of the windows, both
  against the A fragments wgmma takes (rows of cells, the int8 path's even
  and odd cells); every misaligned X giving its aligned copy's values, so
  its bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpine_tpu_torch.ops import kernels
from alpine_tpu_torch.ops.mu import round_partner
from tests.test_torch_als import _both, _close, _probe_dots, _x_values
from tests.test_torch_wtx import (as_values, at_offsets, device_bytes, fragments_at_offsets,
                                  keep_bytes, ldsm_x4_trans, stage_windows, words_at)

torch.set_num_threads(1)

MMA = {"int8": torch.int8, "bfloat16": torch.bfloat16}
WIDE_KS = (513, 520, 768, 1024)
WIDE_NS = (17, 1001, 5003, 8192)
BK = kernels._WIDE_BK


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# hxt_wide's slot order
# ---------------------------------------------------------------------------


def round_h_slots():
    """The cell of each of a 64-cell stage's slots 16 j + s in Hb', as
    round_h_wide writes it: one thread a k16 step j, slot s from lane t =
    (s % 8) / 2's run of 4 cells 16t + 4j .., element 2 (s / 8) + s % 2."""
    return np.array([16 * ((s % 16 % 8) // 2) + 4 * (s // 16) + 2 * (s % 16 // 8) + s % 2
                     for s in range(BK)])


def lane_slots():
    """The cell hxt_wide's lanes put in each slot 16 j + s of a k16 step's
    A fragments: lane t of a quad reads cells 16t .. 16t + 15 of a row and
    gives step j cells 16t + 4j, + 1 (register h: slots 2t, 2t + 1) and
    16t + 4j + 2, + 3 (register 2 + h: slots 2t + 8, 2t + 9)."""
    cells = np.empty(BK, np.int64)
    for t in range(4):
        for j in range(4):
            for e in range(2):
                cells[16 * j + 2 * t + e] = 16 * t + 4 * j + e
                cells[16 * j + 8 + 2 * t + e] = 16 * t + 4 * j + 2 + e
    return cells


def test_hxt_wide_slot_order_is_one_bijection_on_both_sides():
    """round_h_wide's Hb' and the lanes' A fragments put the same cell in
    every slot, and every cell of a stage in one slot."""
    assert np.array_equal(round_h_slots(), lane_slots())
    assert sorted(lane_slots()) == list(range(BK))


def hxt_wide_stage_values(X, c0, mem=None, base=0):
    """The values of X's 64-cell stage from cell c0 (g x 64 float32) as
    hxt_wide's lanes read them: from the TMA tile, zero past n; or, with
    ``mem`` (X's bytes at address ``base``, rows off alignment), from the
    aligned windows by lds16_at at 16 t sz bytes past each row's offset,
    masked past n (keep_bytes)."""
    g, n = X.shape
    if mem is None:
        out = torch.zeros((g, BK), dtype=torch.float32)
        out[:, :min(BK, n - c0)] = X[:, c0:c0 + BK].float()
        return out
    sz = X.element_size()
    stage, off = stage_windows(mem, base, np.arange(g), n, sz, c0, BK)
    runs = []
    for t in range(4):
        keep = (n - c0 - 16 * t) * sz - 4 * np.arange(4 * sz)
        runs.append(keep_bytes(words_at(stage, off + 16 * t * sz, 4 * sz), keep[None, :]))
    return as_values(np.concatenate(runs, 1).view(np.uint8), X.dtype)


def emulate_hxt_wide(X, H, base=None):
    """hxt_wide's arithmetic over ``hxt_wide_grid``: H rounded to bf16 in
    round_h_wide's slot order, each split's 64-cell stages in order, a k16
    step (16 slots) a product into the split's fp32 partial, the partials
    added in split order from zero.  ``base`` stages X through the aligned
    windows of its bytes laid out at that address."""
    g, n = X.shape
    K = H.shape[0]
    _, n_split, cps, _ = kernels.hxt_wide_grid(g, n, K, X.dtype)
    n_pad = _cdiv(n, BK) * BK
    Hp = torch.zeros((K, n_pad), dtype=torch.float32)
    Hp[:, :n] = round_partner(H, X.dtype)
    Hb = Hp.view(K, n_pad // BK, BK)[:, :, round_h_slots()].reshape(K, n_pad)
    mem = None if base is None else device_bytes(X, base)
    slots = lane_slots()
    part = torch.zeros((n_split, K, g), dtype=torch.float32)
    for s in range(n_split):
        for c0 in range(s * cps, min(n, (s + 1) * cps), BK):
            Xa = hxt_wide_stage_values(X, c0, mem, base)
            if mem is not None:
                assert not Xa[:, n - c0:].any()  # cells past n read as zeros
            Xa = Xa[:, slots]
            for j in range(4):
                part[s] += Hb[:, c0 + 16 * j:c0 + 16 * j + 16] @ Xa[:, 16 * j:16 * j + 16].T
    out = torch.zeros((K, g), dtype=torch.float32)
    for s in range(n_split):
        out += part[s]
    return out


# ---------------------------------------------------------------------------
# wtx_wide's order
# ---------------------------------------------------------------------------


def emulate_wtx_wide(X, W, base=None):
    """wtx_wide's arithmetic over ``wtx_wide_grid``: W rounded to bf16
    (round_w), each 128-cell tile's outputs summed over its range's genes
    in 64-gene stages, 16 genes a product; with several ranges their
    partials added in range order from zero.  ``base`` stages X through
    the aligned windows of its bytes laid out at that address."""
    g, n = X.shape
    K = W.shape[1]
    _, ranges, range_genes, _ = kernels.wtx_wide_grid(g, n, K, X.dtype)
    Wb, Xf = round_partner(W, X.dtype).T, X.float()
    sz = X.element_size()
    mem = None if base is None else device_bytes(X, base)
    out = torch.zeros((K, n), dtype=torch.float32)
    for c0 in range(0, n, kernels._WIDE_BM):
        c1 = min(n, c0 + kernels._WIDE_BM)
        if mem is None:
            Xt = Xf[:, c0:c1]
        else:
            stage, off = stage_windows(mem, base, np.arange(g), n, sz, c0, kernels._WIDE_BM)
            Xt = as_values(at_offsets(stage, off, kernels._WIDE_BM * sz), X.dtype)[:, :c1 - c0]
        total = torch.zeros((K, c1 - c0), dtype=torch.float32)
        for r in range(ranges):
            acc = torch.zeros((K, c1 - c0), dtype=torch.float32)
            for g0 in range(r * range_genes, min(g, (r + 1) * range_genes), BK):
                for k0 in range(g0, min(g, g0 + BK), 16):
                    acc += Wb[:, k0:k0 + 16] @ Xt[k0:k0 + 16]
            total = acc if ranges == 1 else total + acc
        out[:, c0:c1] = total
    return out


# ---------------------------------------------------------------------------
# the orders against the plain versions and the Pallas probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("n", WIDE_NS)
@pytest.mark.parametrize("K", WIDE_KS)
def test_wide_passes_match_plain_and_pallas_probe(dtype, K, n):
    """Both emulations against the plain versions (rtol 1e-5: fp32 sums in
    another order; bf16 products are exact) and against
    benchmarks/als_probe.py's Pallas kernels in interpret mode on X and H
    padded to whole 128-cell tiles (rtol 1e-4, atol 1e-6, as
    tests/test_torch_als.py holds them); the CPU wrappers are the plain
    versions."""
    g, tile = 40, 128
    r = np.random.default_rng(K + n)
    X = _x_values(r, dtype, (g, n))
    H = r.random((K, n), dtype=np.float32) + 0.1
    W = r.random((g, K), dtype=np.float32)
    Xj, Xt = _both(X, dtype)
    Ht, Wt = torch.from_numpy(H), torch.from_numpy(W)
    got_h, got_w = emulate_hxt_wide(Xt, Ht), emulate_wtx_wide(Xt, Wt)
    want_h, want_w = kernels.hxt_plain(Xt, Ht), kernels.wtx_plain(Xt, Wt)
    np.testing.assert_allclose(got_h.numpy(), want_h.numpy(), rtol=1e-5, atol=0)
    np.testing.assert_allclose(got_w.numpy(), want_w.numpy(), rtol=1e-5, atol=0)
    assert torch.equal(kernels.hxt(Xt, Ht), want_h) and torch.equal(kernels.wtx(Xt, Wt), want_w)
    n_pad = _cdiv(n, tile) * tile
    Xp = jnp.pad(Xj, ((0, 0), (0, n_pad - n)))
    Hp = jnp.pad(jnp.asarray(H), ((0, 0), (0, n_pad - n)))
    hxt, wtx = _probe_dots(g, K, tile, n_pad)
    _close(got_h, hxt(Xp, Hp), 1e-4, 1e-6)
    _close(got_w, np.asarray(wtx(Xp, jnp.asarray(W)))[:, :n], 1e-4, 1e-6)


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("n,base", [(5003, 0), (5003, 7), (1001, 2), (8192, 1), (8192, 9)])
def test_wide_window_staging_gives_the_aligned_bits(dtype, n, base):
    """X off 16-byte alignment (n mod 16 = 11 or 9, or X at an odd address;
    bf16 at the even address below): every stage read through the aligned
    windows gives the aligned copy's values, so both emulations give its
    bits; X holds negative values (bytes with the top bit set)."""
    K = 520
    r = np.random.default_rng(n + base)
    if dtype == "int8":
        X = torch.from_numpy((r.poisson(3.0, (70, n)) - r.integers(0, 2, (70, n)) * 5
                              ).astype(np.int8))
    else:
        X = torch.from_numpy(r.random((70, n), dtype=np.float32) - 0.25).to(torch.bfloat16)
    H = torch.from_numpy(r.random((K, n), dtype=np.float32) + 0.1)
    W = torch.from_numpy(r.random((70, K), dtype=np.float32))
    base -= base % X.element_size()
    assert torch.equal(emulate_hxt_wide(X, H, base=base), emulate_hxt_wide(X, H))
    assert torch.equal(emulate_wtx_wide(X, W, base=base), emulate_wtx_wide(X, W))


# ---------------------------------------------------------------------------
# the operands' index arithmetic
# ---------------------------------------------------------------------------


def bf16_bits(v):
    """bf16 bits of float32 values that bf16 holds exactly."""
    return (np.asarray(v, np.float32).view(np.uint32) >> 16).astype(np.uint32)


def swizzle_128(tile):
    """A tile of 128-byte rows as TMA writes it in the 128-byte swizzle from
    a 1,024-byte-aligned address: 16-byte chunk q of row r at chunk
    q ^ (r % 8) of the row."""
    rows = tile.reshape(tile.shape[0], 8, 16)
    out = np.empty_like(rows)
    for r in range(tile.shape[0]):
        for q in range(8):
            out[r, q ^ (r % 8)] = rows[r, q]
    return out.reshape(tile.shape)


def widen_i8(b):
    """widen_i8x8 / widen_cell_pairs: int8 bytes as bf16 bits of their values."""
    return bf16_bits(np.asarray(b, np.uint8).view(np.int8).astype(np.float32))


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("n,base", [(4096, 0), (1001, 0), (1001, 3), (4096, 1)])
def test_hxt_wide_a_fragments(dtype, n, base):
    """Each lane's A registers of every k16 step, built as hxt_wide builds
    them from the stage (the TMA tile where X's rows are aligned: int8 rows
    of 64 bytes, bf16 rows of 128 in the swizzle; else the windows read at
    each row's offset), hold the bf16 bits of X at the rows and slots
    wgmma's A layout gives them: register h = rows gq + 8h, slots 2t, 2t +
    1; register 2 + h the slots 2t + 8, 2t + 9."""
    r = np.random.default_rng(n + base)
    X = torch.from_numpy(_x_values(r, dtype, (128, n))).to(MMA[dtype])
    sz = X.element_size()
    base -= base % sz
    aligned = base == 0 and n * sz % 16 == 0
    c0 = 128
    vals = X[:, c0:c0 + BK].float().numpy()
    slots = lane_slots()
    if aligned:
        raw = X[:, c0:c0 + BK].contiguous().view(torch.uint8).numpy()
        tile = raw if sz == 1 else swizzle_128(raw)
    else:
        stage, off = stage_windows(device_bytes(X, base), base, np.arange(128), n, sz, c0, BK)
    # the lanes' rows: 16 w + gq (register h = 0) and 16 w + gq + 8 (h = 1)
    for r0 in [16 * w + gq for w in range(8) for gq in range(8)]:
        for t in range(4):
            words = []
            for h in range(2):
                rr = r0 + 8 * h
                if aligned:
                    if sz == 1:
                        b = tile[rr, 16 * t:16 * t + 16]
                    else:
                        b = np.concatenate([tile[rr, 16 * ((2 * t + u) ^ (rr % 8)):][:16]
                                            for u in range(2)])
                    w = b.view("<u4")
                else:
                    keep = (n - c0 - 16 * t) * sz - 4 * np.arange(4 * sz)
                    w = keep_bytes(words_at(stage[rr:rr + 1], off[rr:rr + 1] + 16 * t * sz,
                                            4 * sz), keep[None, :])[0]
                words.append(w)
            for j in range(4):
                for h in range(2):
                    w = words[h]
                    if sz == 1:
                        by = w.view(np.uint8)[4 * j:4 * j + 4]
                        regs = (widen_i8(by[0]) | widen_i8(by[1]) << 16,
                                widen_i8(by[2]) | widen_i8(by[3]) << 16)
                    else:
                        regs = (int(w[2 * j]), int(w[2 * j + 1]))
                    for q, reg in enumerate(regs):  # register h, then 2 + h
                        s0 = 16 * j + 8 * q + 2 * t
                        want = bf16_bits(vals[r0 + 8 * h, slots[s0]]) | bf16_bits(
                            vals[r0 + 8 * h, slots[s0 + 1]]) << 16
                        assert int(reg) == int(want)


def wtx_wide_row_cell(cw, row, int8):
    """The cell of A row ``row`` (0..15) of the warp whose tile cells start
    at cw: int8 pairs cells (rows 0-7 the even cells, 8-15 the odd), bf16
    keeps their order; the epilogue stores row by this."""
    if int8:
        return cw + 2 * (row % 8) + row // 8
    return cw + row


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("n,base", [(4096, 0), (5003, 0), (5003, 5), (4096, 2)])
def test_wtx_wide_a_fragments(dtype, n, base):
    """wtx_wide's A registers for every warp's 16 cells, 32-gene half of a
    stage and k16 step: ldmatrix.trans at the kernel's addresses in the
    TMA tile (128-byte swizzle: int8 one tile of 64 genes x 128 cells,
    bf16 two of 64 cells) where X's rows are aligned, else the byte loads
    of the windows at each row's offset; both are what ldmatrix.trans
    gives on the tile as stored, and widened and ordered as the kernel
    does they hold X's bf16 bits at wgmma's A layout: row gq (+ 8) the
    cell ``wtx_wide_row_cell``, register h the genes 2t, 2t + 1 of the
    step, 2 + h the genes 2t + 8, 2t + 9."""
    r = np.random.default_rng(n + base)
    X = torch.from_numpy(_x_values(r, dtype, (64, n))).to(MMA[dtype])
    sz = X.element_size()
    int8 = sz == 1
    base -= base % sz
    aligned = base == 0 and n * sz % 16 == 0
    c0 = 256
    raw = X[:, c0:c0 + 128].contiguous().view(torch.uint8).numpy()  # 64 genes x 128 cells
    vals = X[:, c0:c0 + 128].float().numpy()
    if aligned:
        subs = [swizzle_128(np.ascontiguousarray(raw[:, 128 * b:128 * b + 128]))
                for b in range(sz)]
    else:
        stage, off = stage_windows(device_bytes(X, base), base, np.arange(64), n, sz, c0, 128)
    lanes = np.arange(32)
    for cw in range(0, 128, 16):
        for g32 in (0, 32):
            regs = {}  # k16 step -> (32, 4) registers
            for ks in ((0,) if int8 else (0, 1)):
                if int8:
                    gr = g32 + lanes
                    plain = raw[gr, cw:cw + 16]
                else:
                    gr = g32 + 16 * ks + (lanes & 15)
                    first = (cw + 8 * (lanes >> 4)) * 2
                    plain = np.stack([raw[q, f:f + 16] for q, f in zip(gr, first)])
                want_r = ldsm_x4_trans(np.ascontiguousarray(plain))
                if aligned:
                    if int8:
                        rows = np.stack([subs[0][q, 16 * ((cw >> 4) ^ (q % 8)):][:16]
                                         for q in gr])
                    else:
                        q0 = ((cw & 63) >> 3) + (lanes >> 4)
                        rows = np.stack([subs[cw >> 6][q, 16 * (c ^ (q % 8)):][:16]
                                         for q, c in zip(gr, q0)])
                    got_r = ldsm_x4_trans(np.ascontiguousarray(rows))
                else:
                    got_r = fragments_at_offsets(stage, off, g32, cw, 0, ks, int8)
                np.testing.assert_array_equal(got_r, want_r)
                if int8:  # widen_cell_pairs: even cells, then odd
                    b = got_r.view(np.uint8).reshape(32, 4, 4)
                    for half in range(2):
                        even = widen_i8(b[:, 2 * half:2 * half + 2, 0]) | widen_i8(
                            b[:, 2 * half:2 * half + 2, 2]) << 16
                        odd = widen_i8(b[:, 2 * half:2 * half + 2, 1]) | widen_i8(
                            b[:, 2 * half:2 * half + 2, 3]) << 16
                        regs[g32 // 16 + half] = np.stack(
                            [even[:, 0], odd[:, 0], even[:, 1], odd[:, 1]], 1)
                else:
                    regs[g32 // 16 + ks] = got_r[:, [0, 2, 1, 3]]
            for j, a in regs.items():
                for lane in range(32):
                    gq, t = lane // 4, lane % 4
                    for reg in range(4):
                        rowa = gq + 8 * (reg % 2)
                        gene = 16 * j + 2 * t + 8 * (reg // 2)
                        cell = wtx_wide_row_cell(cw, rowa, int8)
                        want = bf16_bits(vals[gene, cell]) | bf16_bits(vals[gene + 1, cell]) << 16
                        assert int(a[lane, reg]) == int(want), (cw, g32, j, lane, reg)


# ---------------------------------------------------------------------------
# the grids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(MMA))
@pytest.mark.parametrize("g,n", [(2000, 100_000), (2000, 8192), (70, 17), (2000, 66_667),
                                 (20_000, 1001), (1, 64)])
def test_wide_grids_cover_and_fill_waves(dtype, g, n):
    """For K = 513, 520, 768, 1024, 2048: every gene, cell and row of K in
    one tile, split or range; the last wave's share of 132 blocks no
    smaller than with the fewest splits (hxt) or one range (wtx); the grids
    at the bench shape pinned."""
    xdt = MMA[dtype]
    for K in WIDE_KS + (2048,):
        CL, n_split, cps, S = kernels.hxt_wide_grid(g, n, K, xdt)
        assert cps % BK == 0 and (n_split - 1) * cps < n <= n_split * cps
        tiles = kernels._wide_tiles("hxt", g, K)
        assert tiles // CL * CL == tiles and tiles * kernels._WIDE_BM * kernels._WIDE_BN >= g * K
        least = _cdiv(n, kernels._WIDE_SPLIT_CELLS)
        assert kernels._wave_share(tiles * n_split) >= kernels._wave_share(tiles * least)
        CL, ranges, rg, S = kernels.wtx_wide_grid(g, n, K, xdt)
        assert rg % BK == 0 and (ranges - 1) * rg < g <= ranges * rg
        tiles = kernels._wide_tiles("wtx", n, K)
        assert kernels._wave_share(tiles * ranges) >= kernels._wave_share(tiles)
        assert ranges == 1 or (tiles < 4 * kernels._SMS and rg // BK >= 4)
    if (g, n) == (2000, 100_000):
        S = 5 if dtype == "int8" else 4
        assert kernels.hxt_wide_grid(g, n, 768, xdt) == (2, 11, 9152, S)
        assert kernels.wtx_wide_grid(g, n, 768, xdt) == (1, 1, 2048, S)
    if (g, n) == (2000, 8192):
        assert kernels.wtx_wide_grid(g, n, 768, xdt)[1:3] == (2, 1024)

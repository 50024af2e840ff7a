"""gram_wide on the CPU: the large-K chain's statistics against Hn
(csrc/gram_wide.cuh): H Hᵀ = Hn diag(c) Hnᵀ over the upper triangle of
128 x 128 tiles of K x K, HHtU = Hn Hnᵀ in counts mode, and rowsum = Hn c
and Bnum = Q diag(c) Hnᵀ as extra columns of the diagonal blocks.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py's kernel_wide); here, on numpy-seeded inputs:

- ``gram_wide_grid`` and ``gram_wide_pairs`` cover the upper triangle of
  K x K once at K = 513, 640, 768, 1030 and 2048 (ragged last tiles
  included), and the cells once in splits of at most 16,384 cells;
- a PyTorch emulation of the kernel (each split's partials in the
  kernel's thread layout, summed in split order and mirrored as
  gram_reduce mirrors them) against the float64 products at rtol 1e-5,
  HHt and HHtU exactly symmetric;
- the emulation over the Hn of the JAX package's ``fused_iteration`` in
  interpret mode at K = 520 against its HHt, HHtU and bnums, at the
  tolerances of test_torch_wide_k.py's plain-vs-Pallas test;
- the CPU wrapper returns the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpine_tpu.ops import pallas_kernels as pk
from alpine_tpu_torch.ops import kernels
from alpine_tpu_torch.ops.mu import guided_width

from .test_torch_kernels import _both, _close, _problem, _t
from .test_torch_weighted import _k4_problem

torch.set_num_threads(1)

EPS = 1e-6
BM = kernels._GRAM_BM
GRID_KS = (1, 40, 128, 144, 512, 513, 640, 768, 1030, 2048)  # K <= 512: K1's chain too
GRID_NS = (17, 1001, 5040, 16_384, 16_385, 66_667, 100_000, 250_000)


def _slot(r, c):
    """The offset of entry (r, c) of a 128 x 128 tile in a pair's partial
    (csrc/gram_wide.cuh, the partials of a split): thread (ty, tx) = ((r % 64) // 4,
    (c % 64) // 4) holds rows 4 ty + i, 64 + 4 ty + i and columns 4 tx + u,
    64 + 4 tx + u as acc[i][u] (i, u < 8) at (i * 8 + u) * 256 + 16 ty + tx."""
    i, u = 4 * (r // 64) + r % 4, 4 * (c // 64) + c % 4
    return (i * 8 + u) * 256 + ((r % 64) // 4) * 16 + (c % 64) // 4


def emulate_gram(Hn, c=None, Q=None):
    """gram_wide in PyTorch (float32): for each split of ``gram_wide_grid``
    every tile pair's product over the split's cells (A rows scaled by c as
    iter_wide scales Hs, B rows unscaled) laid out in the kernel's thread
    layout, and the extra columns (Q rows, the ones row) of each row tile;
    the partials added in split order; HHt (and HHtU) read at (min, max)
    for both (r, s) and (s, r).  Returns what ``gram_wide`` returns."""
    K, n = Hn.shape
    L = 0 if Q is None else Q.shape[0]
    Hs = Hn if c is None else Hn * c
    X = torch.cat([Q if Q is not None else Hn.new_zeros((0, n)), torch.ones((1, n))])
    n_split, cps = kernels.gram_wide_grid(n, K)
    T = -(-K // BM)
    pairs = kernels.gram_wide_pairs(K)
    nmat = 1 if c is None else 2
    tiles = torch.zeros((len(pairs), nmat, BM * BM))
    extra = torch.zeros((T, L + 1, BM))
    pad = lambda A: torch.cat([A, A.new_zeros((T * BM - K, A.shape[1]))])
    for s in range(n_split):
        cells = slice(s * cps, min(n, (s + 1) * cps))
        A, B, U = pad(Hs[:, cells]), pad(Hn[:, cells]), pad(Hn[:, cells])
        rows = torch.arange(BM)
        slots = _slot(rows[:, None], rows[None, :]).reshape(-1)
        for p, (ti, tj) in enumerate(pairs):
            a, b = slice(ti * BM, (ti + 1) * BM), slice(tj * BM, (tj + 1) * BM)
            part = torch.zeros((nmat, BM * BM))
            part[0, slots] = (A[a] @ B[b].T).reshape(-1)
            if nmat == 2:
                part[1, slots] = (U[a] @ B[b].T).reshape(-1)
            tiles[p] += part
        for ti in range(T):
            extra[ti] += X[:, cells] @ A[ti * BM:(ti + 1) * BM].T
    index = torch.full((T, T), -1, dtype=torch.long)
    for p, (ti, tj) in enumerate(pairs):
        index[ti, tj] = p
    r = torch.arange(K)
    lo, hi = torch.minimum(r[:, None], r[None, :]), torch.maximum(r[:, None], r[None, :])
    pidx = index[lo // BM, hi // BM]
    flat = _slot(lo % BM, hi % BM)
    mats = [tiles[pidx, m, flat] for m in range(nmat)]
    ex = extra.permute(1, 0, 2).reshape(L + 1, T * BM)[:, :K]
    return mats[0], (mats[1] if nmat == 2 else None), ex[L], ex[:L]


@pytest.mark.parametrize("K", GRID_KS)
def test_gram_wide_pairs_cover_the_upper_triangle_once(K):
    """Each entry (r, s), r <= s, of K x K is the entry of exactly one tile
    pair read at (min, max); no pair lies below the diagonal; every slot of
    the thread layout is one entry of a tile."""
    pairs = kernels.gram_wide_pairs(K)
    T = -(-K // BM)
    assert len(pairs) == T * (T + 1) // 2 == len(set(pairs))
    assert all(ti <= tj < T for ti, tj in pairs)
    seen = np.zeros((K, K), np.int64)
    for ti, tj in pairs:
        a, b = slice(ti * BM, min(K, (ti + 1) * BM)), slice(tj * BM, min(K, (tj + 1) * BM))
        block = np.ones((a.stop - a.start, b.stop - b.start), np.int64)
        seen[a, b] += np.triu(block) if ti == tj else block
    assert (np.triu(seen) == np.triu(np.ones_like(seen))).all()
    assert (np.tril(seen, -1) == 0).all()
    rows = np.arange(BM)
    assert sorted(_slot(rows[:, None], rows[None, :]).reshape(-1)) == list(range(BM * BM))


@pytest.mark.parametrize("K", GRID_KS)
@pytest.mark.parametrize("n", GRID_NS)
def test_gram_wide_grid_covers_each_cell_once(K, n):
    """Splits of at most 16,384 cells, each a multiple of a chunk (8
    cells), none empty, covering every cell once."""
    n_split, cps = kernels.gram_wide_grid(n, K)
    assert cps <= kernels._WIDE_SPLIT_CELLS and cps % kernels._GRAM_BK == 0
    seen = np.zeros(n, np.int64)
    for s in range(n_split):
        assert s * cps < n
        seen[s * cps:(s + 1) * cps] += 1
    assert (seen == 1).all()
    assert n_split >= -(-n // kernels._WIDE_SPLIT_CELLS)


def test_gram_wide_grid_at_the_bench_shape():
    """At K = 768 and 100k cells: 21 tile pairs x 50 splits of 2,000
    cells, 1,050 tile-pair blocks (about eight an SM of 132), and a block
    of extra columns a row tile and chunk of 8.  At K <= 512 (K1's chain
    below the large-K route) about 264 splits whatever the pairs: 261 of
    384 cells at 100k cells, K = 40 (one pair) or 512 (ten), 261 of 256 at
    the optimizer's fold (66,667 cells, K = 144)."""
    assert kernels.gram_wide_grid(100_000, 768) == (50, 2000)
    for K in (40, 512):
        assert kernels.gram_wide_grid(100_000, K) == (261, 384)
    assert kernels.gram_wide_grid(66_667, 144) == (261, 256)
    assert len(kernels.gram_wide_pairs(768)) == 21
    assert kernels.gram_items(768, 5) == 21 + 6  # 6 extra columns: one chunk a row tile
    assert kernels.gram_items(768, 8) == 21 + 12  # 9: two chunks a row tile


def _gram_problem(seed, K, n, L, counts):
    r = np.random.default_rng(seed)
    Hn = torch.from_numpy(r.random((K, n), dtype=np.float32) + 0.05)
    c = torch.from_numpy(r.integers(0, 4, n).astype(np.float32)) if counts else None
    Q = torch.from_numpy(r.random((L, n), dtype=np.float32)) if L else None
    return Hn, c, Q


@pytest.mark.parametrize("K,n,L,counts", [(513, 17, 5, True), (600, 1001, 0, False),
                                          (768, 300, 5, True), (1030, 17, 9, False),
                                          (1030, 257, 17, True)])
def test_gram_wide_emulation_matches_float64(K, n, L, counts):
    """The emulated partials, summed in split order and mirrored, against
    the float64 products at rtol 1e-5 (fp32 sums of positive terms); HHt
    and HHtU exactly symmetric; the CPU wrapper is the plain version."""
    Hn, c, Q = _gram_problem(K + n + L, K, n, L, counts)
    hht, hhtu, rowsum, bnum = emulate_gram(Hn, c, Q)
    H64 = Hn.double()
    Hs64 = H64 if c is None else H64 * c.double()
    Q64 = Hn.new_zeros((0, n)).double() if Q is None else Q.double()
    np.testing.assert_allclose(hht.numpy(), (Hs64 @ H64.T).numpy(), rtol=1e-5, atol=0)
    np.testing.assert_allclose(rowsum.numpy(), Hs64.sum(1).numpy(), rtol=1e-5, atol=0)
    np.testing.assert_allclose(bnum.numpy(), (Q64 @ Hs64.T).numpy(), rtol=1e-5, atol=0)
    assert bnum.shape == (L, K)
    assert torch.equal(hht, hht.T)
    if counts:
        np.testing.assert_allclose(hhtu.numpy(), (H64 @ H64.T).numpy(), rtol=1e-5, atol=0)
        assert torch.equal(hhtu, hhtu.T)
    else:
        assert hhtu is None
    want = kernels.gram_wide_plain(Hn, c, Q)
    got = kernels.gram_wide(Hn, c, Q)
    for a, b in zip(got, want, strict=True):
        assert (a is None and b is None) or torch.equal(a, b)


def _q_of(Hn, Ys, Bs, blocks, loss_kl):
    """Q = Y / max(Bg Hn, eps) (KL) or Y, as iter_wide writes it."""
    Yf = torch.cat([y.float() for y in Ys])
    if not loss_kl:
        return Yf
    Bg = kernels._embed_b(Bs, blocks)
    return Yf / torch.clamp(Bg @ Hn[:guided_width(blocks)], min=EPS)


@pytest.mark.parametrize("counts", [False, True])
def test_gram_wide_emulation_matches_pallas_at_k520(counts):
    """Over the Hn of the JAX package's fused_iteration (interpret mode) at
    K = 520, the emulated HHt, HHtU, Bnum and rowsum against the Pallas
    kernel's HHt, HHtU, bnums and bdens at rtol 1e-4 (the tolerances of
    test_fused_iteration_plain_matches_pallas_at_wide_k)."""
    blocks, n_labels = (130, 65, 325), (2, 3)
    if counts:
        X, W, H, WtW, Ys, Bs, lam, C = _k4_problem("float32", blocks, n_labels)
        Cn = np.asarray(C)
        want = pk.fused_iteration(
            jnp.asarray(X), jnp.asarray(W), jnp.asarray(H), jnp.asarray(WtW),
            tuple(jnp.asarray(y) for y in Ys), tuple(jnp.asarray(b) for b in Bs),
            jnp.asarray(lam), jnp.float32(EPS), jnp.asarray(Cn), blocks=blocks,
            loss_kl=True, interpret=True)
        HHt_w, HHtU_w, bnums_w, bdens_w = want[2], want[3], want[6], want[7]
        c = torch.from_numpy(np.ascontiguousarray(Cn[1]))
    else:
        X, W, H, WtW, Ys, Bs, lam = _problem(520, 256, blocks, n_labels, "float32")
        Xj, _ = _both(X, "float32")
        want = pk.fused_iteration(
            Xj, jnp.asarray(W), jnp.asarray(H), jnp.asarray(WtW),
            tuple(jnp.asarray(y) for y in Ys), tuple(jnp.asarray(b) for b in Bs),
            jnp.asarray(lam), jnp.float32(EPS), blocks=blocks, loss_kl=True, interpret=True)
        HHt_w, HHtU_w, bnums_w, bdens_w = want[2], None, want[5], want[6]
        c = None
    Hn = _t(np.asarray(want[0]))
    Ys_t = [_t(np.asarray(y)) for y in Ys]
    Bs_t = [_t(np.asarray(b)) for b in Bs]
    Q = _q_of(Hn, Ys_t, Bs_t, blocks, True)
    hht, hhtu, rowsum, bnum = emulate_gram(Hn, c, Q)
    _close(hht, HHt_w, 1e-4, 1e-4)
    if counts:
        _close(hhtu, HHtU_w, 1e-4, 1e-4)
    _, bnums, bdens = kernels._split_stats(blocks, list(n_labels), bnum, rowsum,
                                           torch.zeros(sum(n_labels)))
    for k in range(len(n_labels)):
        _close(bnums[k], bnums_w[k], 1e-4, 1e-5)
        _close(bdens[k], bdens_w[k], 1e-4)

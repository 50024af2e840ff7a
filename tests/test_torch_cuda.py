"""On an NVIDIA GPU: each CUDA kernel of alpine_tpu_torch against its plain
PyTorch version on the same tensors.  Skipped where there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: rtol 1e-4 / atol 1e-5 for one fused iteration and for the ALS
X passes hxt and wtx (fp32 sums in another order than cuBLAS), rtol 2e-4
for the 20-step transform loop; the streaming probe exactly (sums of small
integers); a fit on the card against the same fit on the CPU as
chip_smoke.py holds it (loss rtol 5e-4 plus 2e-6·‖X‖², embeddings rtol 5e-3
/ atol 1e-5), and an ALS fit through the kernels against the same fit
through plain products at loss rtol 5e-4, factors rtol 5e-3.
"""

import numpy as np
import pytest
import torch

from alpine_tpu_torch.ops import kernels

EPS = 1e-6
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8, "int16": torch.int16}
ITER_CASES = (
    [(d, (3, 4, 6), (2, 3), True) for d in DTYPES]
    + [(d, (3, 9), (2,), False) for d in DTYPES]
    + [("float32", (1, 1), (1,), True),
       ("float32", (2, 3, 4, 5), (2, 5, 3), False),
       ("float32", (2, 1), (17,), True),
       ("int8", (5, 5, 30), (2, 3), True),
       ("int8", (40, 60, 100), (4, 7), True)]
    # the tensor-core path (int8, bf16) at K not a multiple of 16, and at
    # K = 300 and 512, where it takes 16-cell tiles (float32: 8); 70 genes
    # and 1000 cells are not multiples of any gene chunk, tile or cell chunk
    + [("int8", (7, 14), (3,), True),
       ("bfloat16", (5, 5, 30), (2, 3), False),
       ("bfloat16", (150, 150), (3,), False),
       ("int8", (200, 312), (4,), True),
       ("float32", (200, 312), (4,), True)]
)


class MatmulDevices(torch.overrides.TorchFunctionMode):
    """Records the device type of every ``torch.matmul`` (or ``@``) made
    while it is entered."""

    def __init__(self):
        super().__init__()
        self.devices = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("matmul", "__matmul__"):
            self.devices.append(args[0].device.type)
        return func(*args, **(kwargs or {}))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _problem(seed, g, n, blocks, n_labels, dtype, dev):
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    K = sum(blocks)
    if dtype in ("int8", "int16"):
        X = r.poisson(3.0, (g, n)).clip(0, 127).astype(np.float32)
    else:
        X = r.random((g, n), dtype=np.float32)
    W = r.random((g, K), dtype=np.float32)
    H = r.random((K, n), dtype=np.float32) + 0.1
    Ys, Bs = [], []
    for c, nl in enumerate(n_labels):
        y = np.zeros((nl, n), np.float32)
        y[r.integers(0, nl, n), np.arange(n)] = 1.0
        Ys.append(t(y).to(DTYPES[dtype]))
        Bs.append(t(r.random((nl, blocks[c])).astype(np.float32) + 0.1))
    lam = t((r.random(len(n_labels)) * 5 + 0.5).astype(np.float32))
    Wt = t(W)
    return t(X).to(DTYPES[dtype]), Wt, t(H), Wt.T @ Wt, Ys, Bs, lam


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want.double().cpu().numpy(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,blocks,n_labels,loss_kl", ITER_CASES)
def test_fused_iteration_cuda_matches_plain(cuda, dtype, blocks, n_labels,
                                            loss_kl):
    X, W, H, WtW, Ys, Bs, lam = _problem(6, 70, 1000, blocks, n_labels, dtype,
                                         cuda)
    before = kernels.launches["fused_iteration"]
    got = kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS,
                                  blocks=blocks, loss_kl=loss_kl)
    torch.cuda.synchronize()
    assert kernels.launches["fused_iteration"] == before + 1
    want = kernels.fused_iteration_plain(X, W, H, WtW, Ys, Bs, lam, EPS,
                                         blocks=blocks, loss_kl=loss_kl)
    assert kernels.launches["fused_iteration"] == before + 1
    for a, b in zip(got[:4], want[:4]):
        _close(a, b, 1e-4, 1e-5)
    for ga, wa in zip(got[4:], want[4:]):
        for a, b in zip(ga, wa):
            _close(a, b, 1e-4, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,blocks,n_labels,loss_kl", ITER_CASES)
def test_fused_iteration_counts_cuda_matches_plain(cuda, dtype, blocks,
                                                   n_labels, loss_kl):
    """K4: the counts mode against its plain version.  Undrawn columns keep
    H bit for bit, and two launches give the same bits (fixed-order sums)."""
    X, W, H, WtW, Ys, Bs, lam = _problem(9, 70, 1000, blocks, n_labels, dtype,
                                         cuda)
    r = np.random.default_rng(10)
    counts = torch.from_numpy(r.integers(0, 4, (2, 1000)).astype(np.float32))
    counts = counts.to(cuda)
    before = dict(kernels.launches)
    run = lambda: kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS,
                                          counts, blocks=blocks,
                                          loss_kl=loss_kl)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert kernels.launches["fused_iteration_counts"] == (
        before["fused_iteration_counts"] + 2)
    assert kernels.launches["fused_iteration"] == before["fused_iteration"]
    want = kernels.fused_iteration_plain(X, W, H, WtW, Ys, Bs, lam, EPS,
                                         counts, blocks=blocks,
                                         loss_kl=loss_kl)
    assert len(got) == len(want) == 8
    for a, b in zip(got[:5], want[:5]):
        _close(a, b, 1e-4, 1e-5)
    for ga, wa in zip(got[5:], want[5:]):
        for a, b in zip(ga, wa):
            _close(a, b, 1e-4, 1e-5)
    undrawn = counts[0] == 0
    assert bool(undrawn.any())
    assert torch.equal(got[0][:, undrawn], H[:, undrawn])
    flat = lambda o: [t for v in o for t in (v if isinstance(v, tuple) else (v,))]
    for a, b in zip(flat(got), flat(again)):
        assert torch.equal(a, b)


def _unaligned(t):
    """The same values in a contiguous tensor whose address is off 16-byte
    alignment (one element into its buffer)."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    u = buf[1:1 + t.numel()].view(t.shape)
    u.copy_(t)
    return u


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,blocks,n_labels,loss_kl", [
    ("int8", (7, 14), (3,), True),
    ("bfloat16", (5, 5, 30), (2, 3), False),
    ("int8", (200, 312), (4,), True)])
def test_fused_iteration_cuda_staging_paths_agree(cuda, dtype, blocks, n_labels,
                                                  loss_kl):
    """At 1040 cells (a multiple of 16, not of the 64-cell tile or chunk) the
    tensor-core path stages X, W and Hn in 16-byte loads; the same X and W
    at addresses off 16-byte alignment take its element-by-element staging.
    Both match the plain version and give the same bits, with and without
    counts."""
    X, W, H, WtW, Ys, Bs, lam = _problem(11, 70, 1040, blocks, n_labels, dtype,
                                         cuda)
    r = np.random.default_rng(12)
    counts = torch.from_numpy(r.integers(0, 4, (2, 1040)).astype(np.float32))
    flat = lambda o: [t for v in o for t in (v if isinstance(v, tuple) else (v,))]
    for C in (None, counts.to(cuda)):
        run = lambda X, W: kernels.fused_iteration(
            X, W, H, WtW, Ys, Bs, lam, EPS, C, blocks=blocks, loss_kl=loss_kl)
        got, moved = run(X, W), run(_unaligned(X), _unaligned(W))
        want = kernels.fused_iteration_plain(X, W, H, WtW, Ys, Bs, lam, EPS, C,
                                             blocks=blocks, loss_kl=loss_kl)
        torch.cuda.synchronize()
        for a, b, c in zip(flat(got), flat(moved), flat(want)):
            assert torch.equal(a, b)
            _close(a, c, 1e-4, 1e-5)


@pytest.mark.cuda
def test_weighted_fast_fit_on_card_matches_cpu(cuda, monkeypatch):
    """sampling_method="weighted_fast" on the card against the same fit on
    the CPU, both fed one count stream made with numpy (the card's and the
    CPU's generators give different numbers from one seed)."""
    import alpine_tpu_torch.models.alpine as talpine
    from alpine_tpu_torch import ALPINE, AnnData

    def stream(tables, n_cells, random_state, device, restart=0, chunk=None):
        start, sizes = (t.cpu().numpy() for t in tables)

        def draw(t):
            r = np.random.default_rng([random_state, t])
            gid = r.integers(0, len(sizes), n_cells)
            pos = np.floor(r.random(n_cells) * sizes[gid]).astype(np.int64)
            c = np.bincount(start[gid] + pos, minlength=n_cells)
            return torch.from_numpy(c.astype(np.float32)).to(device)

        return draw

    monkeypatch.setattr(talpine, "draw_counts_stream", stream)
    r = np.random.default_rng(1)
    X = np.minimum(r.poisson(r.gamma(2.0, 1.0, (500, 6)) @ r.gamma(2.0, 0.3, (6, 80))),
                   127).astype(np.float32)
    obs = {"batch": np.array(["b0", "b1"], dtype=object)[r.integers(0, 2, 500)],
           "cond": np.array(["c0", "c1", "c2"], dtype=object)[r.integers(0, 3, 500)]}
    fits = {}
    for where in ("cuda", "cpu"):
        ad = AnnData(X, obs=obs)
        m = ALPINE(n_components=6, n_covariate_components=[2, 2],
                   lam=[10.0, 10.0], device=where, random_state=7)
        kernels.reset_launches()
        m.fit(ad, ["batch", "cond"], max_iter=5, sampling_method="weighted_fast")
        m.transform(ad)
        if where == "cuda":
            assert kernels.launches["fused_iteration_counts"] == 5
            assert kernels.launches["fused_iteration"] == 0
        fits[where] = (m.loss_history_, ad.obsm["ALPINE_embedding"])
    floor = 2e-6 * float(np.sum(np.square(X.astype(np.float64))))
    np.testing.assert_allclose(fits["cuda"][0], fits["cpu"][0], rtol=5e-4,
                               atol=floor)
    np.testing.assert_allclose(fits["cuda"][1], fits["cpu"][1], rtol=5e-3,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K", [13, 40])
def test_fused_h_update_cuda_matches_plain(cuda, dtype, K):
    X, W, H, WtW, _, _, _ = _problem(7, 50, 777, (K,), (), dtype, cuda)
    got = kernels.fused_h_update(X, W, H, WtW, EPS)
    want = kernels.fused_h_update_plain(X, W, H, WtW, EPS)
    for a, b in zip(got, want):
        _close(a, b, 1e-4, 1e-5)


def _transform_problem(seed, K, n, dev):
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)
    num2 = t(r.random((K, n), dtype=np.float32))
    H0 = t(r.random((K, n), dtype=np.float32) + 0.1)
    A = r.random((K, K), dtype=np.float32)
    return num2, H0, t((A @ A.T).astype(np.float32))


_LARGEST_BUCKET = kernels._TRANSFORM_BUCKETS[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("K,n", [
    (K, 1001) for K in (1, 8, 9, 40, _LARGEST_BUCKET, _LARGEST_BUCKET + 1,
                        100, 129, 257, 300, 512)] + [(40, 1000), (7, 333), (300, 500)])
def test_fused_transform_cuda_matches_plain(cuda, K, n):
    """Both paths (the register path up to the largest bucket, K = 1 and
    K one past a bucket included; the tiled path above it, at K one past
    a multiple of its 64-row micro-tile (65, 129, 257), 100, 300 and, on
    32-cell tiles, 512) against the plain version; 1001 cells fill no
    block or tile."""
    num2, H0, WtW2 = _transform_problem(8, K, n, cuda)
    before = kernels.launches["fused_transform"]
    got = kernels.fused_transform(num2, H0, WtW2, EPS, n_iter=20)
    torch.cuda.synchronize()
    assert kernels.launches["fused_transform"] == before + 1
    want = kernels.fused_transform_plain(num2, H0, WtW2, EPS, n_iter=20)
    _close(got, want, 2e-4, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("K,eps", [(9, EPS), (40, EPS), (_LARGEST_BUCKET + 1, EPS),
                                   (300, EPS), (9, 0.0), (_LARGEST_BUCKET + 1, 0.0)])
def test_fused_transform_cuda_same_bits(cuda, K, eps):
    """Two launches give the same bits; the tiled path, called through the C
    entry with ``transform_tiles_grid(K)``'s parameters for any K, gives the
    bits of the wrapper's path (for K with a bucket, the register path's:
    the same sums in the same order).  At eps = 0 the padded rows (of K =
    9's bucket, of K = 65's 128-row tile) must stay 0 (a 0 / 0 there would
    spread NaN): the result is finite and, at K = 65, its real rows hold
    the plain version's at rtol 2e-4."""
    from alpine_tpu_torch.ops import _build

    n = 1001
    num2, H0, WtW2 = _transform_problem(13, K, n, cuda)
    run = lambda: kernels.fused_transform(num2, H0, WtW2, eps, n_iter=20)
    got, again = run(), run()
    tiled = torch.empty_like(got)
    T, KP, J, S, _ = kernels.transform_tiles_grid(K)
    Wt = torch.empty((KP, KP), dtype=torch.float32, device=cuda)
    fn = _build.entry("fused_transform")
    rc = fn(num2.data_ptr(), H0.data_ptr(), WtW2.data_ptr(), K, 0, n, T, KP, J, S,
            20, eps, Wt.data_ptr(), None, tiled.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    assert torch.equal(got, tiled)
    if K > _LARGEST_BUCKET and eps == 0.0:
        _close(got, kernels.fused_transform_plain(num2, H0, WtW2, eps, n_iter=20),
               2e-4, 1e-6)


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_path(cuda, monkeypatch):
    """A CUDA tensor launches the kernel or raises: a failed build is an
    error, not a silent fallback."""
    from alpine_tpu_torch.ops import _build

    def broken(name):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "entry", broken)
    X, W, H, WtW, _, _, _ = _problem(1, 20, 64, (4,), (), "float32", cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.fused_h_update(X, W, H, WtW, EPS)
    counts = torch.ones((2, 64), device=cuda)
    for dtype in ("float32", "int16", "int8"):  # K1 and K4, fp32 and bf16 paths
        Xc, Wc, Hc, WtWc, Ys, Bs, lam = _problem(2, 20, 64, (2, 2), (2,), dtype, cuda)
        for C in (None, counts):
            with pytest.raises(RuntimeError, match="nvcc failed"):
                kernels.fused_iteration(Xc, Wc, Hc, WtWc, Ys, Bs, lam, EPS, C,
                                        blocks=(2, 2), loss_kl=True)
    for K in (40, 300):  # either path of fused_transform
        num2, H0, WtW2 = _transform_problem(3, K, 64, cuda)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            kernels.fused_transform(num2, H0, WtW2, EPS, n_iter=2)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.hxt(X, H)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.wtx(X, W)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.stream_probe(X)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("n", [50_000, 50_001, 50_016])
@pytest.mark.parametrize("mode", ["K1", "K2", "K4"])
def test_fused_iteration_fp32_path_same_bits(cuda, dtype, n, mode):
    """K1, K2 and K4 on float32 and int16 X (wtx_fma, the per-tile pass,
    hxt_fma, the partials' sum): two launches give the same bits at a width
    of many tiles and splits, the last of each ragged; 50,001 cells take the
    X passes' element-by-element staging, 50,000 and 50,016 their cp.async
    rings, and the same X and W off 16-byte alignment give the same bits
    too.  int16 X holds counts above 127.  The result matches the plain
    version; in K4 undrawn columns keep H bit for bit."""
    blocks, n_labels = ((5, 5, 30), (2, 3)) if mode != "K2" else ((40,), ())
    X, W, H, WtW, Ys, Bs, lam = _problem(13, 300, n, blocks, n_labels, dtype, cuda)
    if dtype == "int16":
        X, _, _ = _x_pass_problem(14, 300, n, 1, dtype, cuda)
    grid = kernels.iteration_grid(300, n, 40, X.dtype)
    assert grid.n_split > 1 and n % grid.cells_per_split != 0
    assert n % grid.wtx_T != 0 and n % grid.T != 0
    C = None
    if mode == "K4":
        r = np.random.default_rng(15)
        C = torch.from_numpy(r.integers(0, 4, (2, n)).astype(np.float32)).to(cuda)
    flat = lambda o: [t for v in o for t in (v if isinstance(v, tuple) else (v,))]

    def run(X, W):
        if mode == "K2":
            return kernels.fused_h_update(X, W, H, WtW, EPS)
        return kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS, C,
                                       blocks=blocks, loss_kl=True)

    before = dict(kernels.launches)
    got, again, moved = run(X, W), run(X, W), run(_unaligned(X), _unaligned(W))
    torch.cuda.synchronize()
    name = {"K1": "fused_iteration", "K2": "fused_h_update",
            "K4": "fused_iteration_counts"}[mode]
    assert kernels.launches[name] == before[name] + 3
    for a, b, c in zip(flat(got), flat(again), flat(moved), strict=True):
        assert torch.equal(a, b) and torch.equal(a, c)
    if mode == "K2":
        want = kernels.fused_h_update_plain(X, W, H, WtW, EPS)
    else:
        want = kernels.fused_iteration_plain(X, W, H, WtW, Ys, Bs, lam, EPS, C,
                                             blocks=blocks, loss_kl=True)
    for a, b in zip(flat(got), flat(want), strict=True):
        _close(a, b, 1e-4, 1e-5)
    if mode == "K4":
        undrawn = C[0] == 0
        assert bool(undrawn.any())
        assert torch.equal(got[0][:, undrawn], H[:, undrawn])


def _x_pass_problem(seed, g, n, K, dtype, dev):
    r = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if dtype == "int8":
        X = r.poisson(3.0, (g, n)).clip(0, 127).astype(np.float32)
    elif dtype == "int16":  # counts above 127, and a few negative values
        X = (r.poisson(3.0, (g, n)) * 300 - r.integers(0, 2, (g, n)) * 7).astype(np.float32)
    else:
        X = r.random((g, n), dtype=np.float32)
    H = r.random((K, n), dtype=np.float32) + 0.1
    W = r.random((g, K), dtype=np.float32)
    return t(X).to(DTYPES[dtype]), t(W), t(H)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K,n", [(1, 1001), (13, 1024), (40, 1000), (40, 1024),
                                 (300, 777), (300, 1040), (64, 1024), (65, 1040),
                                 (512, 1024), (40, 17), (512, 17)])
def test_x_passes_cuda_match_plain(cuda, dtype, K, n):
    """P1 (hxt) and P2 (wtx) against their plain versions: K = 1, K not a
    multiple of 16, K = 64 and 65 (hxt's widest gene block and the next),
    K = 300 and 512 (one pass over X on wtx's tensor-core path, its warps
    in 4 and 8 rows; hxt's narrowest gene block); 70 genes and 1000, 1001,
    777 or 17 cells fill no block, chunk or tile, 1024 and 1040 cells take
    the cp.async ring with 16-byte rows, the others and the same values
    off 16-byte alignment its aligned windows, with the same bits."""
    X, W, H = _x_pass_problem(K + n, 70, n, K, dtype, cuda)
    before = dict(kernels.launches)
    got_h, got_w = kernels.hxt(X, H), kernels.wtx(X, W)
    moved_h = kernels.hxt(_unaligned(X), _unaligned(H))
    moved_w = kernels.wtx(_unaligned(X), _unaligned(W))
    torch.cuda.synchronize()
    assert kernels.launches["hxt"] == before["hxt"] + 2
    assert kernels.launches["wtx"] == before["wtx"] + 2
    assert got_h.shape == (K, 70) and got_w.shape == (K, n)
    _close(got_h, kernels.hxt_plain(X, H), 1e-4, 1e-5)
    _close(got_w, kernels.wtx_plain(X, W), 1e-4, 1e-5)
    assert torch.equal(got_h, moved_h) and torch.equal(got_w, moved_w)


def _x_pass_grid(kind, g, n, K, xdt):
    """(cells a split or tile, splits or tiles) of the grid hxt or wtx runs."""
    if kind == "hxt":
        rule = kernels.hxt_grid if xdt in (torch.int8, torch.bfloat16) else kernels.hxt_fma_grid
        _, n_split, cps, _, _ = rule(g, n, K, xdt)
        return cps, n_split
    rule = kernels.wtx_grid if xdt in (torch.int8, torch.bfloat16) else kernels.wtx_fma_grid
    T, _, _, _, blocks = rule(g, n, K, xdt)
    return T, blocks


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32", "int16"])
@pytest.mark.parametrize("n", [50_000, 50_001, 50_016])
def test_hxt_cuda_same_bits(cuda, dtype, n):
    """Two launches of P1 give the same bits (fixed-order partial sums) at a
    width that splits the cells over many blocks, the last split ragged;
    50,001 cells take the ring's aligned windows, 50,000 and 50,016 its
    16-byte rows, and the same values off 16-byte alignment give the same
    bits too.  int16 X holds counts above 127.  The result matches the
    plain version."""
    X, _, H = _x_pass_problem(5, 300, n, 40, dtype, cuda)
    cps, n_split = _x_pass_grid("hxt", 300, n, 40, X.dtype)
    assert n_split > 1 and n % cps != 0  # the last split is ragged
    got = kernels.hxt(X, H)
    assert torch.equal(got, kernels.hxt(X, H))
    assert torch.equal(got, kernels.hxt(_unaligned(X), _unaligned(H)))
    _close(got, kernels.hxt_plain(X, H), 1e-4, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32", "int16"])
@pytest.mark.parametrize("n", [50_000, 50_001, 50_016])
def test_wtx_cuda_same_bits(cuda, dtype, n):
    """Two launches of P2 give the same bits (each output written once, by
    the block of its cells) at a width of many tiles, the last ragged;
    50,001 cells take the ring's aligned windows, 50,000 and 50,016 its
    16-byte rows, and the same values off 16-byte alignment give the
    same bits too.  int16 X holds counts above 127.  The result matches the
    plain version, at k = 30 and k = 5."""
    for K in (30, 5):
        X, W, _ = _x_pass_problem(6, 300, n, K, dtype, cuda)
        T, blocks = _x_pass_grid("wtx", 300, n, K, X.dtype)
        assert blocks > 1 and n % T != 0  # the last tile is ragged
        got = kernels.wtx(X, W)
        assert torch.equal(got, kernels.wtx(X, W))
        assert torch.equal(got, kernels.wtx(_unaligned(X), _unaligned(W)))
        _close(got, kernels.wtx_plain(X, W), 1e-4, 1e-5)


def _at_byte_offset(t, offset):
    """The same values in a contiguous tensor that starts ``offset`` bytes
    into its buffer."""
    nbytes = t.numel() * t.element_size()
    buf = torch.empty(nbytes + 16, dtype=torch.uint8, device=t.device)
    u = buf[offset:offset + nbytes].view(t.dtype).view(t.shape)
    u.copy_(t)
    return u


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("n", [8193, 8198, 8203, 66_667])
def test_x_passes_cuda_any_byte_offset(cuda, dtype, n):
    """P1/P2's bf16 path with X rows off 16-byte alignment (n mod 16 = 1,
    6, 11; 600 genes, so P2 splits its genes at 8k cells and P1 its cells):
    each matches its plain version, X copied to every base offset of 1-15
    bytes (bf16: the even ones) gives the same bits, and a copy with the
    cells padded by zeros to a multiple of 16 (every row aligned: the
    16-byte rows of the ring) gives them too where its grid is the same."""
    X, W, H = _x_pass_problem(n, 600, n, 40, dtype, cuda)
    got_h, got_w = kernels.hxt(X, H), kernels.wtx(X, W)
    _close(got_h, kernels.hxt_plain(X, H), 1e-4, 1e-5)
    _close(got_w, kernels.wtx_plain(X, W), 1e-4, 1e-5)
    for off in range(X.element_size(), 16, X.element_size()):
        Xo = _at_byte_offset(X, off)
        assert torch.equal(kernels.hxt(Xo, H), got_h), off
        assert torch.equal(kernels.wtx(Xo, W), got_w), off
    n16 = -(-n // 16) * 16
    Xp = torch.zeros((600, n16), dtype=X.dtype, device=cuda)
    Xp[:, :n] = X
    Hp = torch.zeros((40, n16), device=cuda)
    Hp[:, :n] = H
    grids = lambda m: (kernels.hxt_grid(600, m, 40, X.dtype), kernels.wtx_grid(600, m, 40, X.dtype),
                       kernels.wtx_gene_split(600, m, 40, X.dtype))
    same = [a == b for a, b in zip(grids(n), grids(n16))]
    assert same[1] and same[2]  # P2's grid at these widths
    assert torch.equal(kernels.wtx(Xp, W)[:, :n], got_w)
    if same[0]:
        assert torch.equal(kernels.hxt(Xp, Hp), got_h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("n", [8192, 8195])
def test_x_passes_cuda_split_grids_same_bits(cuda, dtype, n):
    """At the minibatch shape (2,000 genes x 8,192 cells, K = 40) P1 sums
    its splits and P2 its gene ranges in the last block to finish (integer
    arrival counters): two launches give the same bits, and the results
    match the plain versions."""
    X, W, H = _x_pass_problem(7, 2000, n, 40, dtype, cuda)
    assert kernels.hxt_grid(2000, n, 40, X.dtype)[1] > 1
    assert kernels.wtx_gene_split(2000, n, 40, X.dtype)[0] > 1
    got_h, got_w = kernels.hxt(X, H), kernels.wtx(X, W)
    for _ in range(2):
        assert torch.equal(kernels.hxt(X, H), got_h)
        assert torch.equal(kernels.wtx(X, W), got_w)
    _close(got_h, kernels.hxt_plain(X, H), 1e-4, 1e-5)
    _close(got_w, kernels.wtx_plain(X, W), 1e-4, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,tile", [(1001, 128), (1024, 256), (100, None),
                                    (5000, None)])
def test_stream_probe_cuda_matches_plain(cuda, dtype, n, tile):
    """P3 against its plain version, exactly (integers 0..99: every sum is
    exact in f32); 1001 and 100 cells take the element-by-element reads."""
    r = np.random.default_rng(n)
    X = torch.from_numpy(r.integers(0, 100, (37, n)).astype(np.float32))
    X = X.to(cuda).to(DTYPES[dtype])
    before = kernels.launches["stream_probe"]
    fold, colsum = kernels.stream_probe(X, tile)
    torch.cuda.synchronize()
    assert kernels.launches["stream_probe"] == before + 1
    want_fold, want_colsum = kernels.stream_probe_plain(X, tile)
    assert torch.equal(fold, want_fold) and torch.equal(colsum, want_colsum)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_als_fit_scan_fused_matches_plain_on_card(cuda, dtype):
    """A small ALS fit through the kernels (1 hxt and 3 wtx launches an
    iteration) against the same fit through the plain X products."""
    from alpine_tpu_torch.ops import mu

    iters = 10 if dtype == "float32" else 5
    X, W, H = _x_pass_problem(3, 80, 600, 12, dtype, cuda)
    r = np.random.default_rng(4)
    Ys = []
    for nl in (2, 3):
        y = np.zeros((nl, 600), np.float32)
        y[r.integers(0, nl, 600), np.arange(600)] = 1.0
        Ys.append(torch.from_numpy(y).to(cuda))
    Bs = [torch.from_numpy(r.random((nl, k), dtype=np.float32)).to(cuda)
          for nl, k in ((2, 3), (3, 4))]
    hyper = (torch.tensor([3.0, 1.5], device=cuda), 0.2, 0.4, 0.3, EPS)
    out = {}
    for backend in ("fused", "plain"):
        cfg = mu.MUConfig(blocks=(3, 4, 5), n_labels=(2, 3), n_cells=600,
                          max_iter=iters, x_dtype=dtype, backend=backend,
                          use_als=True)
        kernels.reset_launches()
        out[backend] = mu.fit_scan(cfg, W, H, Bs, X, Ys, hyper)
        torch.cuda.synchronize()
        if backend == "fused":
            assert kernels.launches["hxt"] == iters
            assert kernels.launches["wtx"] == 3 * iters
            assert kernels.launches["fused_iteration"] == 0
    fused, plain = out["fused"], out["plain"]
    _close(fused[3], plain[3], 5e-4, 0.0)
    for a, b in ((fused[0], plain[0]), (fused[1], plain[1])):
        _close(a, b, 5e-3, 1e-5)


@pytest.mark.cuda
def test_load_transform_export_on_card(cuda, tmp_path):
    """A model saved from the card loads onto the card and onto the CPU; the
    card's uncached transform (one K3 launch) matches the CPU's (plain K3)
    at rtol 2e-4; by default the export runs one ``torch.matmul`` a slab on
    the card, equal to ``on_device=True``, and matches the host's
    (``on_device=False``) at rtol 1e-5, atol 1e-6."""
    from alpine_tpu_torch import ALPINE, AnnData

    r = np.random.default_rng(2)
    X = np.minimum(r.poisson(r.gamma(2.0, 1.0, (400, 6)) @ r.gamma(2.0, 0.3, (6, 70))),
                   127).astype(np.float32)
    obs = {"batch": np.array(["b0", "b1"], dtype=object)[r.integers(0, 2, 400)]}
    m = ALPINE(n_components=6, n_covariate_components=[2], lam=[10.0],
               device="cuda", random_state=3)
    m.fit(AnnData(X, obs=obs), ["batch"], max_iter=8)
    m.save(str(tmp_path / "m"))
    out = {}
    for where in ("cuda", "cpu"):
        loaded = ALPINE.load(str(tmp_path / "m"), device=where)
        assert loaded.device.type == where
        ad = AnnData(X, obs=obs)
        kernels.reset_launches()
        loaded.transform(ad)
        if where == "cuda":
            assert kernels.launches["fused_transform"] == 1
        out[where] = ad.obsm["ALPINE_embedding"]
    emb = out["cuda"]
    _close(torch.from_numpy(emb), torch.from_numpy(out["cpu"]), 2e-4, 1e-6 * float(np.abs(emb).max()))
    ad.obsm["ALPINE_embedding"] = emb
    loaded = ALPINE.load(str(tmp_path / "m"), device="cuda")
    with MatmulDevices() as rec:
        loaded.get_normalized_expression(ad, library_size=100.0, cell_block_size=150)
    assert rec.devices == ["cuda"] * 3  # 400 cells in slabs of 150
    default = ad.layers["normalized_expression"].copy()
    loaded.get_normalized_expression(ad, library_size=100.0, cell_block_size=150,
                                     on_device=True)
    np.testing.assert_array_equal(ad.layers["normalized_expression"], default)
    loaded.get_normalized_expression(ad, library_size=100.0, cell_block_size=150,
                                     on_device=False)
    np.testing.assert_allclose(default, ad.layers["normalized_expression"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("use_als", [False, True], ids=["joint", "als"])
@pytest.mark.parametrize("sampling", ["random", "weighted"])
def test_minibatch_fit_on_card_matches_cpu(cuda, monkeypatch, use_als, sampling):
    """A minibatch (or gathered weighted) fit on the card, whose steps run
    hxt and wtx on the gathered batches and wtx for each epoch's loss,
    against the same fit on the CPU, both fed one cell stream made with
    numpy.  Launches: joint 1 hxt + 1 wtx a batch, ALS 1 hxt + 3 wtx a
    batch, and 1 wtx an epoch."""
    import alpine_tpu_torch.models.alpine as talpine
    from alpine_tpu_torch import ALPINE, AnnData

    def stream(n_cells, random_state, device, probs=None, restart=0, chunk=None):
        def draw(t):
            r = np.random.default_rng([random_state, t])
            idx = (r.permutation(n_cells) if probs is None
                   else r.choice(n_cells, n_cells, p=probs / probs.sum()))
            return torch.from_numpy(idx.astype(np.int64)).to(device)
        return draw

    monkeypatch.setattr(talpine, "draw_cells_stream", stream)
    r = np.random.default_rng(5)
    n, epochs, bs = 500, 3, 128  # int8: 12 steps, short of the bf16 chaos
    X = np.minimum(r.poisson(r.gamma(2.0, 1.0, (n, 6)) @ r.gamma(2.0, 0.3, (6, 80))),
                   127).astype(np.float32)
    obs = {"batch": np.array(["b0", "b1"], dtype=object)[r.integers(0, 2, n)],
           "cond": np.array(["c0", "c1", "c2"], dtype=object)[r.integers(0, 3, n)]}
    fits = {}
    for where in ("cuda", "cpu"):
        ad = AnnData(X, obs=obs)
        m = ALPINE(n_components=6, n_covariate_components=[2, 2], lam=[10.0, 10.0],
                   device=where, random_state=7, use_als=use_als)
        kernels.reset_launches()
        m.fit(ad, ["batch", "cond"], max_iter=epochs, batch_size=bs,
              sampling_method=sampling)
        if where == "cuda":
            batches = epochs * -(-n // bs)
            assert kernels.launches["hxt"] == batches
            assert kernels.launches["wtx"] == (3 if use_als else 1) * batches + epochs
            assert kernels.launches["fused_iteration"] == 0
        fits[where] = (m.loss_history_, ad.obsm["ALPINE_embedding"])
    floor = 2e-6 * float(np.sum(np.square(X.astype(np.float64))))
    np.testing.assert_allclose(fits["cuda"][0], fits["cpu"][0], rtol=5e-4, atol=floor)
    np.testing.assert_allclose(fits["cuda"][1], fits["cpu"][1], rtol=5e-3, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_phantom_components_stay_zero_through_k1(cuda, dtype):
    """Bucket-padded blocks (5, 5, 30) -> (8, 8, 32) through fused_iteration
    on the card from masked inits: the phantom rows of H and columns of W
    stay exactly zero; on float32 X the genuine components follow the
    unpadded fit (the two K differ, so the kernel sums in another order)."""
    from alpine_tpu_torch.ops import mu

    true, padded, n_labels, iters = (5, 5, 30), (8, 8, 32), (2, 3), 10
    X, W, H, _, Ys, Bs, lam = _problem(8, 300, 5000, true, n_labels, dtype, cuda)
    valid = mu.block_valid_mask(padded, true, cuda)
    Wp = torch.zeros((300, 48), device=cuda)
    Hp = torch.zeros((48, 5000), device=cuda)
    Wp[:, valid], Hp[valid] = W, H
    Bsp = [torch.nn.functional.pad(b, (0, kp - b.shape[1])) for b, kp in zip(Bs, padded)]
    hyper = (lam, 0.0, 0.0, 0.0, EPS)
    out = {}
    for blocks, init in ((padded, (Wp, Hp, Bsp)), (true, (W, H, Bs))):
        cfg = mu.MUConfig(blocks=blocks, n_labels=n_labels, n_cells=5000,
                          max_iter=iters, x_dtype=dtype)
        kernels.reset_launches()
        out[blocks] = mu.fit_scan(cfg, *init, X, Ys, hyper)
        torch.cuda.synchronize()
        assert kernels.launches["fused_iteration"] == iters
    Wo, Ho, Bso, L = out[padded]
    assert not Wo[:, ~valid].any() and not Ho[~valid].any()
    assert all(not b[:, k:].any() for b, k in zip(Bso, true))
    assert torch.isfinite(L).all()
    if dtype == "float32":
        Wt, Ht, _, Lt = out[true]
        _close(L, Lt, 1e-4, 0.0)
        _close(Wo[:, valid], Wt, 1e-3, 1e-6)
        _close(Ho[valid], Ht, 1e-3, 1e-6)


@pytest.mark.cuda
def test_tiled_fit_on_card_matches_cpu(cuda, monkeypatch):
    """sampling_method="tiled" on the card against the same fit on the CPU
    (the kernels' plain versions), both fed one tile stream made with
    numpy: 500 cells (4 tiles of 128, 12 pad columns), one tile a batch,
    3 epochs.  Launches: hxt and wtx once a batch, wtx once an epoch."""
    import alpine_tpu_torch.models.alpine as talpine
    from alpine_tpu_torch import ALPINE, AnnData

    def stream(n_tiles, random_state, device, restart=0, chunk=None):
        return lambda t: torch.from_numpy(
            np.random.default_rng([random_state, t]).permutation(n_tiles)).to(device)

    monkeypatch.setattr(talpine, "draw_tiles_stream", stream)
    r = np.random.default_rng(5)
    n, epochs = 500, 3
    X = np.minimum(r.poisson(r.gamma(2.0, 1.0, (n, 6)) @ r.gamma(2.0, 0.3, (6, 80))),
                   127).astype(np.float32)
    obs = {"batch": np.array(["b0", "b1"], dtype=object)[r.integers(0, 2, n)],
           "cond": np.array(["c0", "c1", "c2"], dtype=object)[r.integers(0, 3, n)]}
    fits = {}
    for where in ("cuda", "cpu"):
        ad = AnnData(X, obs=obs)
        m = ALPINE(n_components=6, n_covariate_components=[2, 2], lam=[10.0, 10.0],
                   device=where, random_state=7)
        kernels.reset_launches()
        m.fit(ad, ["batch", "cond"], max_iter=epochs, batch_size=100,
              sampling_method="tiled")
        if where == "cuda":
            assert m._x_cache[0].shape == (80, 512) and m._x_cache[4] == 12
            assert kernels.launches["hxt"] == 4 * epochs
            assert kernels.launches["wtx"] == 4 * epochs + epochs
            assert kernels.launches["fused_iteration"] == 0
        m.transform(ad)
        fits[where] = (m.loss_history_, ad.obsm["ALPINE_embedding"])
    floor = 2e-6 * float(np.sum(np.square(X.astype(np.float64))))
    np.testing.assert_allclose(fits["cuda"][0], fits["cpu"][0], rtol=5e-4, atol=floor)
    np.testing.assert_allclose(fits["cuda"][1], fits["cpu"][1], rtol=5e-3, atol=1e-5)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A checkpointed fit on the card interrupted after its second snapshot
    and resumed by a fresh model: the uninterrupted checkpointed fit's
    bits (the snapshot holds float32 W, H and Bs exactly), one hxt launch
    a chunk start, the snapshot gone after success."""
    import alpine_tpu_torch.io.checkpoint as tckpt
    from alpine_tpu_torch import ALPINE, AnnData

    r = np.random.default_rng(2)
    X = np.minimum(r.poisson(r.gamma(2.0, 1.0, (800, 6)) @ r.gamma(2.0, 0.3, (6, 90))),
                   127).astype(np.float32)
    obs = {"batch": np.array(["b0", "b1"], dtype=object)[r.integers(0, 2, 800)]}
    kw = dict(max_iter=12, checkpoint_every=4)
    make = lambda: ALPINE(n_components=6, n_covariate_components=[2], lam=[10.0],
                          device="cuda", random_state=3)
    full = make().fit(AnnData(X, obs=obs), ["batch"],
                      checkpoint_dir=str(tmp_path / "full"), **kw)
    orig, calls = tckpt.FitCheckpointer.save, []

    def interrupting_save(self, *args):
        orig(self, *args)
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt

    tckpt.FitCheckpointer.save = interrupting_save
    try:
        with pytest.raises(KeyboardInterrupt):
            make().fit(AnnData(X, obs=obs), ["batch"],
                       checkpoint_dir=str(tmp_path / "part"), **kw)
    finally:
        tckpt.FitCheckpointer.save = orig
    kernels.reset_launches()
    resumed = make().fit(AnnData(X, obs=obs), ["batch"],
                         checkpoint_dir=str(tmp_path / "part"), **kw)
    assert kernels.launches["fused_iteration"] == 4
    assert kernels.launches["hxt"] == 1
    np.testing.assert_array_equal(resumed.loss_history_, full.loss_history_)
    assert not list((tmp_path / "part").iterdir())
    assert not list((tmp_path / "full").iterdir())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3000, 24), (5003, 96)])
def test_knn_on_card_matches_host(cuda, shape):
    """The blocked float32 kNN on the card against the float64 host search:
    self first, distances at rtol 1e-4 (float32 expansion and refinement),
    neighbour sets equal on at least 99.9 % of the rows (near-ties at the
    k-th place may swap)."""
    from alpine_tpu_torch.ops.knn import exact_knn

    n, d = shape
    r = np.random.default_rng(n)
    emb = np.abs(r.normal(0, 1, (n, d)) + r.integers(0, 4, (n, 1))).astype(np.float32)
    emb[-5:] = emb[:5]  # duplicate rows at exactly zero distance
    hd, hi = exact_knn(emb, 15)
    cd, ci = exact_knn(emb, 15, device=cuda)
    assert ci[:, 0].tolist() == list(range(n))
    np.testing.assert_allclose(np.sort(cd, axis=1), np.sort(hd, axis=1), rtol=1e-4, atol=1e-5)
    same = (np.sort(ci, axis=1) == np.sort(hi, axis=1)).all(axis=1)
    assert same.mean() >= 0.999, int((~same).sum())
    for i in range(5):
        assert cd[i][ci[i] == n - 5 + i][0] == 0.0


@pytest.mark.cuda
def test_search_on_card_launches(cuda):
    """A 2-trial search on the card at a small shape: the first trial runs
    the batched route (max_iter given), every fold fit launches K1 once an
    iteration and every validation projection K3 once, scores finite;
    fit_the_best_param launches K1 max_iter more times."""
    from alpine_tpu_torch import AnnData, ComponentOptimizer
    from alpine_tpu_torch.native import leiden_backend

    r = np.random.default_rng(1)
    n = 1500
    X = np.minimum(r.poisson(r.gamma(2.0, 1.0, (n, 6)) @ r.gamma(2.0, 0.3, (6, 120))),
                   127).astype(np.float32)
    obs = {"batch": np.array(["b0", "b1"], dtype=object)[r.integers(0, 2, n)],
           "cond": np.array(["c0", "c1", "c2"], dtype=object)[r.integers(0, 3, n)]}
    co = ComponentOptimizer(AnnData(X, obs=obs), ["batch", "cond"], max_iter=12,
                            random_state=0)
    kernels.reset_launches()
    co.search_hyperparams(n_total_components_range=(10, 60), n_splits=3, max_evals=2)
    torch.cuda.synchronize()
    valid = [t for t in co.trials.trials if t["result"]["status"] == "ok"]
    assert valid and all(np.isfinite(t["result"]["loss"]) for t in valid)
    assert kernels.launches["fused_iteration"] == len(valid) * 3 * 12
    assert kernels.launches["fused_transform"] == len(valid) * 3
    assert co._fold_cache[1].Xtr.device.type == "cuda"
    assert leiden_backend() == "native"
    kernels.reset_launches()
    model = co.fit_the_best_param()
    assert kernels.launches["fused_iteration"] == 12
    assert co._fold_cache is None and np.isfinite(model.loss_history_).all()


@pytest.mark.cuda
@pytest.mark.parametrize("guided", [True, False], ids=["K1", "K2"])
def test_world_of_one_nccl_fit_is_the_single_device_fit(cuda, guided):
    """A cell mesh of one NCCL rank runs the sharded fit loop (one all-reduce
    an iteration; fused_iteration, or fused_h_update without covariates)
    and the sharded transform: the loss history, W and both embeddings
    equal the single-device fit's bit for bit."""
    import socket

    from alpine_tpu_torch import ALPINE, AnnData
    from alpine_tpu_torch.parallel import distributed as dist

    r = np.random.default_rng(3)
    X = np.minimum(r.poisson(r.gamma(2.0, 1.0, (1001, 6)) @ r.gamma(2.0, 0.3, (6, 90))),
                   127).astype(np.float32)
    obs = {"batch": np.array(["b0", "b1"], dtype=object)[r.integers(0, 2, 1001)],
           "cond": np.array(["c0", "c1", "c2"], dtype=object)[r.integers(0, 3, 1001)]}
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    dist.initialize(f"localhost:{port}", num_processes=1, process_id=0,
                    backend="nccl", timeout=120.0)
    try:
        fits = []
        for device in ("cuda", dist.global_cell_mesh()):
            ad = AnnData(X, obs=obs)
            keys = ["batch", "cond"] if guided else []
            m = ALPINE(n_components=8, n_covariate_components=[2, 2][:len(keys)],
                       lam=[10.0, 10.0][:len(keys)], device=device, random_state=7)
            kernels.reset_launches()
            dist.reset_collectives()
            m.fit(ad, keys, max_iter=6)
            fit_emb = ad.obsm["ALPINE_embedding"].copy()
            m.transform(ad)
            fits.append((m.loss_history_, np.concatenate(m.matrices["Ws"], axis=1),
                         fit_emb, ad.obsm["ALPINE_embedding"], dict(kernels.launches),
                         dist.collective_summary()))
    finally:
        dist.shutdown()
    (La, Wa, Fa, Ta, ka, ca), (Lb, Wb, Fb, Tb, kb, cb) = fits
    k = "fused_iteration" if guided else "fused_h_update"
    assert ka[k] == kb[k] == 6 and ka["hxt"] == kb["hxt"] == 1
    assert ka["fused_transform"] == kb["fused_transform"] == 1
    assert ca == {} and cb["iteration"]["calls"] == 6 and cb["setup"]["calls"] == 1
    for a, b in ((La, Lb), (Wa, Wb), (Fa, Fb), (Ta, Tb)):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# K > 512: the large-K routes (kernels.route), at chip_smoke.py's kernel_wide
# small shapes: 70 genes x 17, 1,001 and 5,040 cells
# ---------------------------------------------------------------------------

WIDE_CASES = [(d, K, n) for d in DTYPES for K in (513, 600, 768, 1024, 2048)
              for n in (17, 1001, 5040)]


def _wide_blocks(K):
    return (K // 4, K // 8, K - K // 4 - K // 8)


def _hold_xht_on_own_hs(dtype, X, got, want, scale=None):
    """int8/bf16 X: XHt against the plain product over the kernel's own Hs
    (an Hn one ulp off the plain one can round Hs to the next bf16 value,
    which moves a sum over 17 cells past rtol 1e-4)."""
    want = list(want)
    if dtype in ("int8", "bfloat16"):
        Hs = got[0] if scale is None else got[0] * scale
        want[1] = kernels.hxt_plain(X, Hs).T
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,K,n", WIDE_CASES)
def test_wide_fused_iteration_cuda_matches_plain(cuda, dtype, K, n):
    """K1, K4 and K2 on the large-K chain against their plain versions
    (rtol 1e-4 / atol 1e-5), undrawn columns bit for bit, a second launch
    bit for bit the first."""
    blocks = _wide_blocks(K)
    X, W, H, WtW, Ys, Bs, lam = _problem(K + n, 70, n, blocks, (2, 3), dtype, cuda)
    C = torch.randint(0, 4, (2, n), generator=torch.Generator().manual_seed(n)).float().to(cuda)
    flat = lambda o: [t for v in o for t in (v if isinstance(v, tuple) else (v,))]
    for counts in (None, C):
        before = dict(kernels.launches)
        got = kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS, counts, blocks=blocks,
                                      loss_kl=dtype != "int16")
        again = kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS, counts, blocks=blocks,
                                        loss_kl=dtype != "int16")
        torch.cuda.synchronize()
        name = "fused_iteration" if counts is None else "fused_iteration_counts"
        assert kernels.launches[name] == before[name] + 2
        want = kernels.fused_iteration_plain(X, W, H, WtW, Ys, Bs, lam, EPS, counts,
                                             blocks=blocks, loss_kl=dtype != "int16")
        want = _hold_xht_on_own_hs(dtype, X, got, want, None if counts is None else C[1])
        for a, b, c in zip(flat(got), flat(want), flat(again), strict=True):
            _close(a, b, 1e-4, 1e-5)
            assert torch.equal(a, c)
        if counts is not None:
            undrawn = C[0] == 0
            assert torch.equal(got[0][:, undrawn], H[:, undrawn])
    got = kernels.fused_h_update(X, W, H, WtW, EPS)
    want = _hold_xht_on_own_hs(dtype, X, got, kernels.fused_h_update_plain(X, W, H, WtW, EPS))
    for a, b in zip(got, want, strict=True):
        _close(a, b, 1e-4, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [513, 768, 1030, 2048])
@pytest.mark.parametrize("n", [17, 1001, 5040])
@pytest.mark.parametrize("L,counts", [(0, False), (5, False), (5, True), (9, True)])
def test_gram_wide_cuda_matches_plain(cuda, K, n, L, counts):
    """gram_wide alone (the large-K chain's H Hᵀ, HHtU, rowsum and Bnum)
    against its plain version (rtol 1e-4 / atol 1e-5): HHt and HHtU exactly
    symmetric, a second launch bit for bit the first, the same values off
    16-byte alignment the same bits, one launch counted a call; 9 labels
    take a second chunk of extra columns, blocks of their own."""
    r = np.random.default_rng(K * 3 + n + L)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    Hn = t(r.random((K, n), dtype=np.float32) + 0.05)
    c = t(r.integers(0, 4, n).astype(np.float32)) if counts else None
    Q = t(r.random((L, n), dtype=np.float32)) if L else None
    before = kernels.launches["gram_wide"]
    got = kernels.gram_wide(Hn, c, Q)
    again = kernels.gram_wide(Hn, c, Q)
    moved = kernels.gram_wide(_unaligned(Hn), None if c is None else _unaligned(c),
                              None if Q is None else _unaligned(Q))
    torch.cuda.synchronize()
    assert kernels.launches["gram_wide"] == before + 3
    want = kernels.gram_wide_plain(Hn, c, Q)
    for a, b, x, y in zip(got, want, again, moved, strict=True):
        if b is None:
            assert a is None and x is None and y is None
            continue
        _close(a, b, 1e-4, 1e-5)
        assert torch.equal(a, x) and torch.equal(a, y)
    assert torch.equal(got[0], got[0].T)
    assert not counts or torch.equal(got[1], got[1].T)


@pytest.mark.cuda
@pytest.mark.parametrize("K,n", [(513, 17), (768, 1001), (1030, 5040)])
def test_wide_chain_launches_gram_wide(cuda, K, n):
    """K1, K4 and K2 above K = 512 launch gram_wide once a call; their HHt
    (and K4's HHtU) come out exactly symmetric and equal to gram_wide's over
    the chain's own Hn and counts row."""
    blocks = _wide_blocks(K)
    X, W, H, WtW, Ys, Bs, lam = _problem(K + 2 * n, 70, n, blocks, (2, 3), "int8", cuda)
    C = torch.randint(0, 4, (2, n), generator=torch.Generator().manual_seed(K)).float().to(cuda)
    before = kernels.launches["gram_wide"]
    k1 = kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS, blocks=blocks, loss_kl=True)
    k4 = kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS, C, blocks=blocks,
                                 loss_kl=True)
    k2 = kernels.fused_h_update(X, W, H, WtW, EPS)
    torch.cuda.synchronize()
    assert kernels.launches["gram_wide"] == before + 3
    for out in (k1, k4, k2):
        assert torch.equal(out[2], out[2].T)
    assert torch.equal(k4[3], k4[3].T)
    assert torch.equal(k1[2], kernels.gram_wide(k1[0])[0])
    alone = kernels.gram_wide(k4[0], C[1].contiguous())
    assert torch.equal(k4[2], alone[0]) and torch.equal(k4[3], alone[1])
    assert torch.equal(k2[2], kernels.gram_wide(k2[0])[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_wide_chain_many_labels_cuda_matches_plain(cuda, dtype):
    """60 labels over 768 guided components at K = 2048: Bg does not fit
    iter_wide's shared memory beside its label rows, so it is read through
    the cache (``kernels.wide_stages_bg``), and the labels take 8 passes of
    iter_wide's sums and 8 blocks of gram_wide's extra columns a row tile;
    K1 and K4 against their plain versions (rtol 1e-4 / atol 1e-5)."""
    K, n, labels = 2048, 1001, (30, 30)
    blocks = _wide_blocks(K)
    assert not kernels.wide_stages_bg(sum(labels), sum(blocks[:-1]), False)
    X, W, H, WtW, Ys, Bs, lam = _problem(K + 7, 70, n, blocks, labels, dtype, cuda)
    C = torch.randint(0, 4, (2, n), generator=torch.Generator().manual_seed(3)).float().to(cuda)
    flat = lambda o: [t for v in o for t in (v if isinstance(v, tuple) else (v,))]
    for counts in (None, C):
        got = kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS, counts, blocks=blocks,
                                      loss_kl=True)
        want = kernels.fused_iteration_plain(X, W, H, WtW, Ys, Bs, lam, EPS, counts,
                                             blocks=blocks, loss_kl=True)
        torch.cuda.synchronize()
        want = _hold_xht_on_own_hs(dtype, X, got, want, None if counts is None else C[1])
        for a, b in zip(flat(got), flat(want), strict=True):
            _close(a, b, 1e-4, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,K,n", WIDE_CASES)
def test_wide_x_passes_cuda_match_plain(cuda, dtype, K, n):
    """P1 and P2 at K > 512 (int8/bf16 X: the wgmma kernels hxt_wide and
    wtx_wide; float32/int16 X: the FP32 tiles hxt_fma_wide and
    wtx_fma_wide) against their plain versions; X off 16-byte alignment
    gives the same bits."""
    X, W, H = _x_pass_problem(K + n, 70, n, K, dtype, cuda)
    got_h, got_w = kernels.hxt(X, H), kernels.wtx(X, W)
    moved_h = kernels.hxt(_unaligned(X), _unaligned(H))
    moved_w = kernels.wtx(_unaligned(X), _unaligned(W))
    torch.cuda.synchronize()
    _close(got_h, kernels.hxt_plain(X, H), 1e-4, 1e-5)
    _close(got_w, kernels.wtx_plain(X, W), 1e-4, 1e-5)
    assert torch.equal(got_h, moved_h) and torch.equal(got_w, moved_w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("K", [513, 520, 768, 1024])
@pytest.mark.parametrize("n", [17, 1001, 5003, 8192, 66_667, 100_000])
def test_wide_passes_cuda_match_plain(cuda, dtype, K, n):
    """hxt_wide and wtx_wide (P1/P2 above K = 512 on int8/bf16 X) against
    their plain versions (rtol 1e-4 / atol 1e-5) over 300 genes: a second
    launch bit for bit the first, one launch of each kernel a call, and
    the same values at an odd byte offset (bf16: 2 bytes) the same bits;
    5,003 and 66,667 cells take the aligned windows, the others TMA's
    tiles.  At 66,667 cells the 66,672-cell copy padded with zeros has the
    same grid, so P2's outputs of the first 66,667 cells are its bits."""
    X, W, H = _x_pass_problem(K + n, 300, n, K, dtype, cuda)
    before = dict(kernels.launches)
    got_h, got_w = kernels.hxt(X, H), kernels.wtx(X, W)
    again_h, again_w = kernels.hxt(X, H), kernels.wtx(X, W)
    torch.cuda.synchronize()
    assert kernels.launches["hxt_wide"] == before["hxt_wide"] + 2
    assert kernels.launches["wtx_wide"] == before["wtx_wide"] + 2
    assert torch.equal(got_h, again_h) and torch.equal(got_w, again_w)
    _close(got_h, kernels.hxt_plain(X, H), 1e-4, 1e-5)
    _close(got_w, kernels.wtx_plain(X, W), 1e-4, 1e-5)
    Xo = _at_byte_offset(X, X.element_size())
    assert torch.equal(kernels.hxt(Xo, H), got_h)
    assert torch.equal(kernels.wtx(Xo, W), got_w)
    if n == 66_667:
        Xp = torch.zeros((300, 66_672), dtype=X.dtype, device=cuda)
        Xp[:, :n] = X
        assert kernels.wtx_wide_grid(300, n, K, X.dtype) == kernels.wtx_wide_grid(
            300, 66_672, K, X.dtype)
        assert torch.equal(kernels.wtx(Xp, W)[:, :n], got_w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("K", [513, 768, 1024, 2048])
@pytest.mark.parametrize("n", [17, 1001, 5040, 66_667])
def test_fma_wide_passes_cuda_match_plain(cuda, dtype, K, n):
    """hxt_fma_wide and wtx_fma_wide (P1/P2 above K = 512 on float32/int16
    X) against their plain versions (rtol 1e-4 / atol 1e-5) over 300
    genes: a second launch bit for bit the first, one launch of each kernel
    a call, and the same values off 16-byte alignment (X, H and W one
    element into their buffers: int16 rows at a 2-byte offset) the same
    bits; 17, 1,001 and 66,667 cells take the 4-byte copies.  At 66,667
    cells the 66,672-cell copy padded with zeros has the same grids, so its
    outputs (P2: of the first 66,667 cells) are the same bits."""
    X, W, H = _x_pass_problem(K + n, 300, n, K, dtype, cuda)
    before = dict(kernels.launches)
    got_h, got_w = kernels.hxt(X, H), kernels.wtx(X, W)
    again_h, again_w = kernels.hxt(X, H), kernels.wtx(X, W)
    torch.cuda.synchronize()
    assert kernels.launches["hxt_fma_wide"] == before["hxt_fma_wide"] + 2
    assert kernels.launches["wtx_fma_wide"] == before["wtx_fma_wide"] + 2
    assert torch.equal(got_h, again_h) and torch.equal(got_w, again_w)
    _close(got_h, kernels.hxt_plain(X, H), 1e-4, 1e-5)
    _close(got_w, kernels.wtx_plain(X, W), 1e-4, 1e-5)
    assert torch.equal(kernels.hxt(_unaligned(X), _unaligned(H)), got_h)
    assert torch.equal(kernels.wtx(_unaligned(X), _unaligned(W)), got_w)
    if n == 66_667:
        Xp = torch.zeros((300, 66_672), dtype=X.dtype, device=cuda)
        Xp[:, :n] = X
        Hp = torch.zeros((K, 66_672), device=cuda)
        Hp[:, :n] = H
        assert kernels.hxt_fma_wide_grid(300, n, K, X.dtype) == kernels.hxt_fma_wide_grid(
            300, 66_672, K, X.dtype)
        assert torch.equal(kernels.hxt(Xp, Hp), got_h)
        assert torch.equal(kernels.wtx(Xp, W)[:, :n], got_w)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [513, 768, 1024, 1536, 2048, 2056, 2600])
@pytest.mark.parametrize("n", [17, 1001, 5040])
def test_wide_fused_transform_cuda_matches_plain(cuda, K, n):
    """K3's per-step path (every K > 512) against the plain loop (rtol
    2e-4), a second launch bit for bit."""
    r = np.random.default_rng(K + n)
    t = lambda a: torch.from_numpy(a).to(cuda)
    W = r.random((70, K), dtype=np.float32)
    X = r.poisson(1.5, (70, n)).astype(np.float32)
    num2, WtW2 = t(2.0 * (W.T @ X)), t(2.0 * (W.T @ W))
    H0 = t(r.random((K, n), dtype=np.float32) + 0.05)
    got = kernels.fused_transform(num2, H0, WtW2, EPS, n_iter=20)
    again = kernels.fused_transform(num2, H0, WtW2, EPS, n_iter=20)
    want = kernels.fused_transform_plain(num2, H0, WtW2, EPS, n_iter=20)
    _close(got, want, 2e-4, 1e-6)
    assert torch.equal(got, again)
    assert kernels.transform_path(K) == "steps"


@pytest.fixture(scope="module")
def wtw_parent(tmp_path_factory):
    """The design of wtw_gemm before the ring (scripts/wtw_gemm_variants.cu,
    variant 0), built with the package's nvcc flags: fn(epi, A, B, num2,
    out) launches it, epi 0 the store and 1 the update."""
    import ctypes
    import subprocess
    from pathlib import Path

    from alpine_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    src = Path(__file__).resolve().parent.parent / "scripts" / "wtw_gemm_variants.cu"
    lib = tmp_path_factory.mktemp("wtw_parent") / "libwtw_variants.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).alpine_wtw_variant
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, I, P, P, I, I, P, ctypes.c_float, P, P, P]
    fn.restype = I

    def run(epi, A, B, num2, out):
        K, n = B.shape
        rc = fn(0, epi, A.data_ptr(), B.data_ptr(), K, n,
                None if num2 is None else num2.data_ptr(), EPS, None, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        torch.cuda.synchronize()
        return out

    return run


@pytest.mark.cuda
@pytest.mark.parametrize("K,n", [(513, 17), (513, 1001), (768, 5040), (1024, 1001),
                                 (2048, 17)])
def test_wtw_gemm_gives_the_parent_designs_bits(cuda, wtw_parent, K, n):
    """wtw_gemm's ring (A transposed once, both operands by cp.async, rows
    off 16-byte alignment by 4-byte copies) forms each sum over j in order
    from 0, as the design before it did: its store (``kernels.wtw_gemm``,
    B also at a 4-byte offset) and its update (one step of K3's per-step
    path) give that design's bits, and a second launch its own."""
    r = np.random.default_rng(K + n)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    A = t(r.random((K, K), dtype=np.float32))
    Bm = t(r.random((K * n + 1,), dtype=np.float32) + 0.05)
    num2 = t(r.random((K, n), dtype=np.float32) * K)
    for B in (Bm[:K * n].view(K, n), Bm[1:].view(K, n)):
        want = wtw_parent(0, A, B, None, torch.empty((K, n), device=cuda))
        got, again = kernels.wtw_gemm(A, B), kernels.wtw_gemm(A, B)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(again, got)
        want = wtw_parent(1, A, B, num2, torch.empty((K, n), device=cuda))
        step = kernels.fused_transform(num2, B, A, EPS, n_iter=1)
        again = kernels.fused_transform(num2, B, A, EPS, n_iter=1)
        torch.cuda.synchronize()
        assert kernels.transform_path(K) == "steps"
        assert torch.equal(step, want) and torch.equal(again, step)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [40, 65, 300, 512])
def test_per_step_transform_gives_the_other_paths_bits(cuda, K):
    """K3's per-step path, called through the C entry (T = 0) at a K the
    register or tiled path takes, gives that path's bits: every path forms
    each sum over j in order from 0 and the same update."""
    from alpine_tpu_torch.ops import _build

    n = 1001
    num2, H0, WtW2 = _transform_problem(17, K, n, cuda)
    got = kernels.fused_transform(num2, H0, WtW2, EPS, n_iter=20)
    steps, scratch = torch.empty_like(got), torch.empty_like(got)
    At = torch.empty((K, K), dtype=torch.float32, device=cuda)
    rc = _build.entry("fused_transform")(
        num2.data_ptr(), H0.data_ptr(), WtW2.data_ptr(), K, 0, n, 0, 0, 0, 0, 20, EPS,
        scratch.data_ptr(), At.data_ptr(), steps.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert kernels.transform_path(K) != "steps"
    assert torch.equal(steps, got)

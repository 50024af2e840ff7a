"""On an NVIDIA GPU: each CUDA kernel of alpine_tpu_torch against its plain
PyTorch version on the same tensors.  Skipped where there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: rtol 1e-4 / atol 1e-5 for one fused iteration (fp32 sums in
another order than cuBLAS), rtol 2e-4 for the 20-step transform loop; a
fit on the card against the same fit on the CPU as chip_smoke.py holds it
(loss rtol 5e-4 plus 2e-6·‖X‖², embeddings rtol 5e-3 / atol 1e-5).
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

    def stream(tables, n_cells, random_state, device):
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
                        300, 512)] + [(40, 1000), (7, 333), (300, 500)])
def test_fused_transform_cuda_matches_plain(cuda, K, n):
    """Both paths (the register path up to the largest bucket, K = 1 and
    K one past a bucket included; the tiled path above it) against the
    plain version; 1001 cells fill no block or tile."""
    num2, H0, WtW2 = _transform_problem(8, K, n, cuda)
    before = kernels.launches["fused_transform"]
    got = kernels.fused_transform(num2, H0, WtW2, EPS, n_iter=20)
    torch.cuda.synchronize()
    assert kernels.launches["fused_transform"] == before + 1
    want = kernels.fused_transform_plain(num2, H0, WtW2, EPS, n_iter=20)
    _close(got, want, 2e-4, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("K,eps", [(9, EPS), (40, EPS), (_LARGEST_BUCKET + 1, EPS),
                                   (9, 0.0)])
def test_fused_transform_cuda_same_bits(cuda, K, eps):
    """Two launches give the same bits; where K has a bucket, the register
    path gives the bits of the tiled path (the same sums in the same order),
    which the library still holds for larger K.  At eps = 0 the padded rows
    of K = 9's bucket must stay 0 (a 0 / 0 there would spread NaN)."""
    from alpine_tpu_torch.ops import _build

    num2, H0, WtW2 = _transform_problem(13, K, 1001, cuda)
    run = lambda: kernels.fused_transform(num2, H0, WtW2, eps, n_iter=20)
    got, again = run(), run()
    tiled = torch.empty_like(got)
    fn = _build.entry("fused_transform")
    rc = fn(num2.data_ptr(), H0.data_ptr(), WtW2.data_ptr(), K, 0, 1001,
            kernels.tile_width(K), 20, eps, tiled.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    assert torch.equal(got, tiled)


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
    for K in (40, 300):  # either path of fused_transform
        num2, H0, WtW2 = _transform_problem(3, K, 64, cuda)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            kernels.fused_transform(num2, H0, WtW2, EPS, n_iter=2)

"""The port's CV folds from one upload (alpine_tpu_torch/optimize/batched.py)
against the JAX package's vmapped folds (alpine_tpu/optimize/batched.py)
on the CPU.

Both start from the JAX package's draws: the shared fold init and the
transform H0 (split(PRNGKey(seed)) and transform_key), and the fit key's
streams — permutations for minibatch folds, balanced choices for gathered
"weighted" folds, ``mu.multinomial_counts`` for weighted_fast folds, tile
permutations for tiled folds.  On float32 data the validation embeddings
agree at rtol 5e-3 (the fused fit loop and XLA sum in different orders,
as tests/test_torch_model.py); int8 X (bf16 compute) is held over 5
iterations, where last-bit bf16 roundings have not yet flipped.  Padding
is neutral: pad columns of H stay exactly zero, and a padded fold fit
follows the unpadded one (bit for bit in minibatch epochs, which sum over
the same batch; to 1 ulp-level noise in full batch, where BLAS sums the
longer cell axis in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import StratifiedKFold

import alpine_tpu_torch.optimize.batched as tbatched
from alpine_tpu.ops import mu as jmu
from alpine_tpu.optimize.batched import batched_fold_embeddings as jax_folds
from alpine_tpu.utils.encoder import FeatureEncoders
from alpine_tpu_torch.convert import state_from_numpy
from alpine_tpu_torch.ops import mu as tmu

from .conftest import make_synthetic_adata
from .test_torch_minibatch import _jax_cells
from .test_torch_model import jax_fit_key
from .test_torch_tiled import _jax_tiles

torch.set_num_threads(1)

_MAX_DRAWS = 256  # split(key, T)[t] does not depend on T


@pytest.fixture
def jax_fold_draws(monkeypatch):
    """The folds' draws replaced by the JAX package's batched draws."""
    def draw_init(cfg, n_genes, random_state, eps, device):
        init_key, _ = jax.random.split(jax.random.PRNGKey(random_state))
        jcfg = jmu.MUConfig(blocks=cfg.blocks, n_labels=cfg.n_labels, n_cells=cfg.n_cells)
        return state_from_numpy(*jmu.init_matrices(jcfg, n_genes, init_key, eps), device)

    def draw_transform_h0(n_components, n_cells, random_state, eps, device):
        key = jmu.transform_key(jax.random.PRNGKey(random_state))
        H0 = jnp.maximum(jax.random.uniform(key, (n_components, n_cells),
                                            dtype=jnp.float32), eps)
        return torch.from_numpy(np.array(H0)).to(device)

    def draw_counts_stream(weights, n, random_state):
        keys = jax.random.split(jax_fit_key(random_state), _MAX_DRAWS)
        w = jnp.asarray(weights.cpu().numpy())
        return lambda t: torch.from_numpy(np.array(jmu.multinomial_counts(keys[t], n, w, n)))

    def draw_cells_stream(n_cells, random_state, device, probs=None):
        return lambda t: torch.from_numpy(_jax_cells(jax_fit_key(random_state), t,
                                                     n_cells, probs))

    def draw_tiles_stream(n_tiles, random_state, device):
        return lambda t: torch.from_numpy(_jax_tiles(jax_fit_key(random_state), t, n_tiles))

    for name, fn in list(locals().items()):
        if name.startswith("draw_"):
            monkeypatch.setattr(tbatched, name, fn)


def _setup(n_cells=90, seed=11, integer=False):
    ad = make_synthetic_adata(n_cells=n_cells, n_genes=25, covariates=(("batch", 2),),
                              seed=seed)
    X = np.round(ad.X) if integer else ad.X
    Ys = FeatureEncoders(["batch"]).fit_transform(ad.obs)
    folds = list(StratifiedKFold(n_splits=3, shuffle=True, random_state=0)
                 .split(X, ad.obs["batch"].astype(str)))
    return X, Ys, folds


COMMON = dict(lam=[5.0], orth_w=0.1, alpha_w=0.5, l1_ratio=0.3, eps=1e-6, loss_kl=True,
              use_als=False, batch_size=None, weighted=False, max_iter=10, seed=0)


@pytest.mark.parametrize("case,blocks,true_blocks,kw", [
    ("full", (2, 6), None, {}),
    ("full_frobenius", (3, 5), None, dict(loss_kl=False)),
    ("bucketed", (4, 8), (2, 6), {}),
    ("weighted_fast", (2, 6), None, dict(weighted=True, weighted_counts=True)),
    ("weighted", (2, 5), None, dict(weighted=True, batch_size=32)),
    ("als", (2, 5), None, dict(use_als=True)),
    ("minibatch", (2, 6), None, dict(batch_size=25)),
    ("minibatch_als", (2, 6), None, dict(batch_size=25, use_als=True)),
    ("tiled", (2, 6), None, dict(batch_size=200, tile=128, n_cells=600)),
])
def test_fold_embeddings_match_jax(jax_fold_draws, case, blocks, true_blocks, kw):
    kw = dict(COMMON, **kw)
    X, Ys, folds = _setup(n_cells=kw.pop("n_cells", 90))
    tile = kw.pop("tile", 0)
    args = dict(blocks=blocks, true_blocks=true_blocks, **kw)
    want = jax_folds(X, Ys, folds, tile=tile, scale=True, **args)
    fd = tbatched.prepare_fold_data(X, Ys, folds, weighted=kw["weighted"], device="cpu",
                                    tile=tile, shuffle_seed=kw["seed"])
    got = tbatched.batched_fold_embeddings(fd, **args)
    k = (true_blocks or blocks)[-1]
    for (_, va), g, w in zip(folds, got, want):
        assert g.shape == w.shape == (len(va), k)
        np.testing.assert_allclose(g, w, rtol=5e-3, atol=1e-5)


def test_int8_fold_embeddings_match_jax(jax_fold_draws):
    X, Ys, folds = _setup(integer=True)
    args = dict(COMMON, blocks=(2, 6), max_iter=5)
    want = jax_folds(X, Ys, folds, x_dtype="int8", scale=True, **args)
    fd = tbatched.prepare_fold_data(X, Ys, folds, weighted=False, device="cpu",
                                    x_dtype="int8")
    got = tbatched.batched_fold_embeddings(fd, **args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=5e-3, atol=1e-5)


def test_fold_data_layout():
    """Folds stacked at the storage width with a zero pad, balanced
    weights per fold, the tiled shuffle, and valid columns."""
    X, Ys, folds = _setup(n_cells=91, integer=True)
    fd = tbatched.prepare_fold_data(X, Ys, folds, weighted=True, device="cpu",
                                    x_dtype="int8")
    assert fd.Xtr.dtype == fd.Xva.dtype == torch.int8 and fd.Ystr[0].dtype == torch.int8
    assert fd.Xtr.shape == (3, 25, fd.n_tr) and fd.n_tr == max(len(t) for t, _ in folds)
    for f, (tr, va) in enumerate(folds):
        np.testing.assert_array_equal(fd.Xtr[f, :, :len(tr)].numpy(), X[tr].T)
        np.testing.assert_array_equal(fd.Xva[f, :, :len(va)].numpy(), X[va].T)
        assert not fd.Xtr[f, :, len(tr):].any() and not fd.weights[f, len(tr):].any()
        assert abs(float(fd.weights[f].sum()) - 1.0) < 1e-6
        assert fd.valid_cols[f, 0].sum() == len(tr)
    tl = tbatched.prepare_fold_data(X, Ys, folds, weighted=False, device="cpu",
                                    x_dtype="int8", tile=128, shuffle_seed=3)
    assert tl.n_tr == 128
    tr = folds[1][0][np.random.default_rng(4).permutation(len(folds[1][0]))]
    np.testing.assert_array_equal(tl.Xtr[1, :, :len(tr)].numpy(), X[tr].T)
    with pytest.raises(ValueError, match="exclusive"):
        tbatched.prepare_fold_data(X, Ys, folds, weighted=True, device="cpu", tile=128)


def test_tiled_batch_size_checked_as_jax():
    X, Ys, folds = _setup()
    for bs in (None, 60):
        kw = dict(COMMON, blocks=(2, 6), batch_size=bs)
        with pytest.raises(ValueError) as ej:
            jax_folds(X, Ys, folds, tile=128, scale=True, **kw)
        fd = tbatched.prepare_fold_data(X, Ys, folds, weighted=False, device="cpu",
                                        tile=128, shuffle_seed=kw["seed"])
        with pytest.raises(ValueError) as et:
            tbatched.batched_fold_embeddings(fd, **kw)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("kw", [{}, dict(use_als=True), dict(batch_size=8),
                                dict(weighted_counts=True)],
                         ids=["full", "als", "minibatch", "weighted_fast"])
def test_fold_padding_is_neutral(kw):
    """A fold padded with zero columns (zero X, Ys and H) follows the
    unpadded fit: pad columns of H stay exactly zero; minibatch epochs sum
    over the same batches and match bit for bit, full-batch sums over the
    longer axis to 1-ulp noise (as tests/test_batched.py holds JAX's)."""
    r = np.random.default_rng(0)
    g, n, pad = 18, 30, 7
    X = r.random((g, n)).astype(np.float32)
    Y = np.zeros((2, n), np.float32)
    Y[r.integers(0, 2, n), np.arange(n)] = 1.0
    hyper = (torch.tensor([3.0]), 0.2, 0.1, 0.4, float(np.float32(1e-6)))
    counts = kw.pop("weighted_counts", False)
    runs = []
    for width in (n, n + pad):
        cfg = tmu.MUConfig(blocks=(2, 5), n_labels=(2,), n_cells=width, max_iter=8,
                           weighted_counts=counts, **kw)
        W0, H0, Bs0 = tmu.init_matrices(
            tmu.MUConfig(blocks=(2, 5), n_labels=(2,), n_cells=n), g,
            torch.Generator().manual_seed(0), 1e-6, "cpu")
        zeros = lambda a: np.zeros((a.shape[0], width - n), np.float32)
        Xp, Yp = np.concatenate([X, zeros(X)], 1), np.concatenate([Y, zeros(Y)], 1)
        H0p = torch.cat([H0, torch.zeros(7, width - n)], 1)
        cells = lambda t: torch.from_numpy(np.random.default_rng(t).permutation(n))
        w = torch.from_numpy(np.pad(np.full(n, 1.0 / n, np.float32), (0, width - n)))
        draws = (lambda t: tmu.multinomial_counts(torch.Generator().manual_seed(t), n, w))
        runs.append(tmu.fit_scan(cfg, W0, H0p, Bs0, torch.from_numpy(Xp),
                                 [torch.from_numpy(Yp)], hyper, draw_cells=cells,
                                 draw_counts=draws if counts else None))
    (Wa, Ha, Ba, _), (Wb, Hb, Bb, _) = runs
    assert not Hb[:, n:].any()
    if "batch_size" in kw:
        assert torch.equal(Wa, Wb) and torch.equal(Ha, Hb[:, :n]) and torch.equal(Ba[0], Bb[0])
    np.testing.assert_allclose(Wb.numpy(), Wa.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(Hb[:, :n].numpy(), Ha.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Bb[0].numpy(), Ba[0].numpy(), rtol=1e-5, atol=1e-7)


def test_multinomial_counts_pad_and_total():
    w = torch.tensor([0.5, 0.25, 0.25, 0.0, 0.0])
    c = tmu.multinomial_counts(torch.Generator().manual_seed(1), 3, w)
    assert c.dtype == torch.float32 and c.shape == (5,)
    assert float(c.sum()) == 3.0 and not c[3:].any()

"""Component bucketing in the port (``ALPINE(component_bucket=...)``,
``mu.bucket_blocks``, ``auto_bucket_blocks``, ``mask_block_padding``)
against the JAX package on the CPU (tests/test_bucketing.py's anchors):

- the block rules equal the JAX package's on a grid of block tuples;
- padding is exactly neutral on both port backends: the genuine
  components of a padded fit follow the unpadded fit from the same genuine
  values, and the phantom ones stay exactly zero;
- the mask, and ``scale_matrices`` keeping all-zero columns finite;
- the estimator with an int and a tuple bucket against
  ``alpine_tpu.ALPINE`` from the JAX package's init draws (loss rtol 5e-4,
  factors rtol 5e-3 atol 1e-5, as tests/test_torch_model.py), true-sized
  stored matrices, and the constructor's messages.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from alpine_tpu import ALPINE as JaxALPINE
from alpine_tpu.ops import mu as jmu
from alpine_tpu_torch import ALPINE
from alpine_tpu_torch.convert import state_from_numpy
from alpine_tpu_torch.ops import mu as tmu

from .conftest import make_synthetic_adata
from .test_torch_model import KEYS, _check_fit_and_transform
from .test_torch_model import jax_draws  # noqa: F401  (fixture)
from .test_torch_mu import _hypers

torch.set_num_threads(1)

EPS = 1e-6
_SIZES = (1, 2, 3, 5, 7, 8, 13, 30, 47, 100, 513, 1100)


@pytest.mark.parametrize("bucket", [1, 4, 8, 16, 128])
def test_bucket_blocks_match_jax(bucket):
    for blocks in itertools.product(_SIZES[:6], _SIZES[4:9]):
        assert tmu.bucket_blocks(blocks, bucket) == jmu.bucket_blocks(blocks, bucket)


def test_auto_bucket_blocks_match_jax():
    grid = [(k,) for k in _SIZES] + list(itertools.product(_SIZES, repeat=2)) + \
        list(itertools.product((2, 5, 13, 48), (1, 11, 50), (25, 30, 1100)))
    for blocks in grid:
        got = tmu.auto_bucket_blocks(blocks)
        assert got == jmu.auto_bucket_blocks(blocks)
        assert all(p >= t for p, t in zip(got, blocks))
    assert tmu.auto_bucket_blocks((5, 11, 27)) == (12, 12, 32)
    assert tmu.auto_bucket_blocks((1100,)) == (1152,)


def _problem(seed, g, n, n_labels):
    r = np.random.default_rng(seed)
    X = r.random((g, n), dtype=np.float32)
    Ys = []
    for nl in n_labels:
        y = np.zeros((nl, n), np.float32)
        y[r.integers(0, nl, n), np.arange(n)] = 1.0
        Ys.append(y)
    return torch.from_numpy(X), [torch.from_numpy(y) for y in Ys]


@pytest.mark.parametrize("backend", ["fused", "plain"])
@pytest.mark.parametrize("loss_kl", [True, False], ids=["kl", "fro"])
def test_bucket_padding_is_exactly_neutral(loss_kl, backend):
    """The same genuine initial values at exact shapes and embedded in
    bucket-padded blocks: the genuine components follow the same
    trajectory, the losses agree, and the phantom components stay exactly
    zero (alpine_tpu's init draw, so both packages start alike)."""
    g, n = 24, 120
    true_blocks, n_labels = (3, 5, 7), (2, 3)
    pad_blocks = tmu.bucket_blocks(true_blocks, 8)
    X, Ys = _problem(0, g, n, n_labels)
    _, th = _hypers([2.0, 0.5], 0.2, 0.4, 0.3, EPS)
    jcfg = jmu.MUConfig(blocks=true_blocks, n_labels=n_labels, n_cells=n)
    W0, H0, Bs0 = (np.asarray(a) if not isinstance(a, tuple) else [np.asarray(b) for b in a]
                   for a in jmu.init_matrices(jcfg, g, jax.random.PRNGKey(7), EPS))
    cfg_t = tmu.MUConfig(blocks=true_blocks, n_labels=n_labels, n_cells=n,
                         loss_kl=loss_kl, max_iter=12, backend=backend)
    Wt, Ht, Bst, Lt = tmu.fit_scan(cfg_t, *state_from_numpy(W0, H0, Bs0, "cpu"),
                                   X, Ys, th)
    valid = tmu.block_valid_mask(pad_blocks, true_blocks).numpy()
    Kp = sum(pad_blocks)
    Wp0, Hp0 = np.zeros((g, Kp), np.float32), np.zeros((Kp, n), np.float32)
    Wp0[:, valid], Hp0[valid] = W0, H0
    Bsp0 = [np.pad(b, ((0, 0), (0, kp - b.shape[1])))
            for b, kp in zip(Bs0, pad_blocks)]
    cfg_p = tmu.MUConfig(blocks=pad_blocks, n_labels=n_labels, n_cells=n,
                         loss_kl=loss_kl, max_iter=12, backend=backend)
    Wp, Hp, Bsp, Lp = tmu.fit_scan(cfg_p, *state_from_numpy(Wp0, Hp0, Bsp0, "cpu"),
                                   X, Ys, th)
    np.testing.assert_allclose(Lp.numpy(), Lt.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Wp.numpy()[:, valid], Wt.numpy(), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(Hp.numpy()[valid], Ht.numpy(), rtol=1e-3, atol=1e-6)
    for bp, bt, kt in zip(Bsp, Bst, true_blocks):
        np.testing.assert_allclose(bp.numpy()[:, :kt], bt.numpy(), rtol=1e-3, atol=1e-6)
    assert not Wp.numpy()[:, ~valid].any()
    assert not Hp.numpy()[~valid].any()


def test_mask_block_padding_and_scale_guard():
    g, n = 10, 30
    pad_blocks, true_blocks = (8, 8), (3, 5)
    cfg = tmu.MUConfig(blocks=pad_blocks, n_labels=(2,), n_cells=n)
    W, H, Bs = tmu.init_matrices(cfg, g, torch.Generator().manual_seed(0), EPS, "cpu")
    W, H, Bs = tmu.mask_block_padding(pad_blocks, true_blocks, W, H, Bs)
    valid = tmu.block_valid_mask(pad_blocks, true_blocks)
    np.testing.assert_array_equal(
        valid.numpy(), np.asarray(jmu.block_valid_mask(pad_blocks, true_blocks)))
    assert not W[:, ~valid].any() and not H[~valid].any()
    assert not Bs[0][:, 3:].any() and Bs[0][:, :3].all()
    assert W[:, valid].all()  # genuine entries untouched (>= eps)
    Ws, Hs, Bss = tmu.scale_matrices(pad_blocks, W, H, Bs)
    assert torch.isfinite(Ws).all() and torch.isfinite(Hs).all()
    np.testing.assert_allclose(Ws.sum(dim=0)[valid].numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("bucket,fkw,max_iter", [
    (8, dict(), 10),
    ((4, 4, 8), dict(), 10),
    (8, dict(batch_size=40), 8),
    (8, dict(sampling_method="weighted_fast"), 8),
], ids=["int", "tuple", "minibatch", "weighted_fast"])
def test_component_bucket_estimator_matches_jax(jax_draws, monkeypatch, bucket,
                                                fkw, max_iter):
    """The estimator with a bucket against the JAX estimator (both from the
    JAX package's init at the padded blocks, then masked); the stored
    matrices have the true sizes.  The sampled fits use the JAX streams."""
    from .test_torch_minibatch import _jax_cells
    from .test_torch_model import jax_fit_key
    from .test_torch_weighted import _jax_counts
    import alpine_tpu_torch.models.alpine as talpine
    import jax.numpy as jnp

    monkeypatch.setattr(talpine, "draw_cells_stream", lambda n, rs, dev, probs=None, **k:
                        lambda t: torch.from_numpy(_jax_cells(jax_fit_key(rs, **k), t, n, probs)))
    monkeypatch.setattr(talpine, "draw_counts_stream", lambda tab, n, rs, dev, **k:
                        lambda t: torch.from_numpy(_jax_counts(
                            jax_fit_key(rs, **k), t, n,
                            tuple(jnp.asarray(a.numpy()) for a in tab))))
    ad = make_synthetic_adata(n_cells=80, n_genes=25, seed=3)
    kw = dict(n_components=5, n_covariate_components=[3, 2], lam=[2.0, 1.0],
              random_state=0, component_bucket=bucket)
    jm, tm = JaxALPINE(device="cpu", **kw), ALPINE(device="cpu", **kw)
    ad_j, ad_t = ad.copy(), ad.copy()
    jm.fit(ad_j, KEYS, max_iter=max_iter, **fkw)
    tm.fit(ad_t, KEYS, max_iter=max_iter, **fkw)
    assert tm._cfg_blocks() == jm._cfg_blocks()
    assert [w.shape[1] for w in tm.matrices["Ws"]] == [3, 2, 5]
    assert [h.shape[0] for h in tm.matrices["Hs"]] == [3, 2, 5]
    assert [b.shape[1] for b in tm.matrices["Bs"]] == [3, 2]
    _check_fit_and_transform(jm, tm, ad_j, ad_t)


@pytest.mark.parametrize("bucket", [(2, 8), (4, 4), (3, 8, 8, 8), 0, -2, 2.5, "8"])
def test_component_bucket_messages_match_jax(bucket):
    kw = dict(n_components=5, n_covariate_components=[3], lam=[1.0],
              component_bucket=bucket)
    with pytest.raises(ValueError) as ej:
        JaxALPINE(device="cpu", **kw)
    with pytest.raises(ValueError) as et:
        ALPINE(device="cpu", **kw)
    assert str(et.value) == str(ej.value)


def test_component_bucket_is_kept_as_given():
    m = ALPINE(n_components=5, n_covariate_components=[3], lam=[1.0],
               device="cpu", component_bucket=[4, 8])
    assert m.component_bucket == (4, 8) and m._cfg_blocks() == (4, 8)
    assert ALPINE(n_components=5, n_covariate_components=[3], lam=[1.0],
                  device="cpu", component_bucket=8)._cfg_blocks() == (8, 8)
    assert ALPINE(n_components=5, n_covariate_components=[3], lam=[1.0],
                  device="cpu")._cfg_blocks() == (3, 5)

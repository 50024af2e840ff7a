"""Mid-fit checkpoints in the port (``fit(checkpoint_dir=...,
checkpoint_every=...)``, ``io.checkpoint.FitCheckpointer``, npz backend)
against the JAX package on the CPU (tests/test_checkpoint.py's anchors):

- a checkpointed full-batch fit equals the single fit (the fused loop
  recomputes X Hᵀ with ``hxt`` at each chunk start: rtol 1e-4), and its
  snapshot is gone after success;
- a fit interrupted after its second snapshot and resumed by a fresh model
  finishes on the uninterrupted trajectory; a complete snapshot resumes at
  once; an unreadable snapshot warns and the fit starts over; ``clear()``
  removes a preempted save's leftover; the verbose bar reaches the global
  total; ``"orbax"`` is refused;
- a snapshot the JAX package wrote resumes in the port and the reverse:
  the same file name (the config keys hash alike), and the trajectory of
  the resumed fit is the JAX package's uninterrupted one (loss rtol 5e-4,
  factors rtol 5e-3 atol 1e-5, as tests/test_torch_model.py);
- sampled checkpointed fits (minibatch, weighted_fast, tiled) against the
  JAX package's with its per-chunk streams (``fold_in(fit key, chunk)``)
  injected.
"""

import os

import numpy as np
import pytest
import torch

import alpine_tpu.io.checkpoint as jckpt
import alpine_tpu_torch.io.checkpoint as tckpt
from alpine_tpu import ALPINE as JaxALPINE
from alpine_tpu_torch import ALPINE

from .conftest import make_synthetic_adata
from .test_torch_minibatch import jax_cells  # noqa: F401  (fixture)
from .test_torch_model import KEYS, KW, _adata, _check_fit_and_transform
from .test_torch_model import jax_draws  # noqa: F401  (fixture)
from .test_torch_tiled import jax_tiles  # noqa: F401  (fixture)
from .test_torch_weighted import jax_counts  # noqa: F401  (fixture)

torch.set_num_threads(1)


def _model(cls=ALPINE, **kw):
    return cls(device="cpu", **{**KW, **kw})


def _interrupted_fit(module, cls, ad, d, **kw):
    """A fit whose second snapshot is its last: the save raises after
    writing it (tests/test_checkpoint.py:88-98)."""
    calls = {"n": 0}
    orig = module.FitCheckpointer.save

    def interrupting_save(self, *args):
        orig(self, *args)
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt

    module.FitCheckpointer.save = interrupting_save
    try:
        with pytest.raises(KeyboardInterrupt):
            _model(cls).fit(ad, KEYS, checkpoint_dir=str(d), **kw)
    finally:
        module.FitCheckpointer.save = orig
    (name,) = os.listdir(d)
    return name


def test_checkpointed_fit_matches_plain(tmp_path):
    ad = _adata(integer=False)
    plain = _model().fit(ad.copy(), KEYS, max_iter=12)
    a2 = ad.copy()
    ck = _model().fit(a2, KEYS, max_iter=12, checkpoint_dir=str(tmp_path),
                      checkpoint_every=5)
    np.testing.assert_allclose(ck.loss_history_, plain.loss_history_, rtol=1e-4)
    np.testing.assert_allclose(a2.obsm["ALPINE_embedding"],
                               plain.matrices["Hs"][-1].T, rtol=2e-3, atol=1e-5)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("fkw", [dict(), dict(batch_size=40),
                                 dict(sampling_method="tiled", batch_size=100)],
                         ids=["full", "minibatch", "tiled"])
def test_checkpoint_resume(tmp_path, fkw):
    """Interrupted after 8 of 12 iterations, resumed by a fresh model: the
    uninterrupted checkpointed fit's trajectory (chunk c's streams are
    keyed on c, so a resumed fit draws what the uninterrupted one drew)."""
    ad = _adata(integer=False)
    kw = dict(max_iter=12, checkpoint_every=4, **fkw)
    full = _model().fit(ad.copy(), KEYS, checkpoint_dir=str(tmp_path / "full"), **kw)
    _interrupted_fit(tckpt, ALPINE, ad.copy(), tmp_path / "part", **kw)
    resumed = _model().fit(ad.copy(), KEYS, checkpoint_dir=str(tmp_path / "part"), **kw)
    np.testing.assert_allclose(resumed.loss_history_, full.loss_history_, rtol=1e-4)
    np.testing.assert_allclose(np.vstack(resumed.matrices["Hs"]),
                               np.vstack(full.matrices["Hs"]), rtol=1e-3, atol=1e-6)
    assert not os.listdir(tmp_path / "part")


def test_resume_after_complete_snapshot(tmp_path, monkeypatch):
    """A snapshot at done == max_iter (killed before clear()) resumes at
    once, with the full history and no further fitting."""
    ad = _adata(integer=False)
    with monkeypatch.context() as mp:
        mp.setattr(tckpt.FitCheckpointer, "clear", lambda self: None)
        m1 = _model().fit(ad.copy(), KEYS, max_iter=8, checkpoint_dir=str(tmp_path),
                          checkpoint_every=4)
    assert len(os.listdir(tmp_path)) == 1
    calls = []
    monkeypatch.setattr("alpine_tpu_torch.models.alpine.mu.fit_scan",
                        lambda *a, **k: calls.append(1))
    m2 = _model().fit(ad.copy(), KEYS, max_iter=8, checkpoint_dir=str(tmp_path),
                      checkpoint_every=4)
    assert not calls and not os.listdir(tmp_path)
    np.testing.assert_array_equal(m1.loss_history_, m2.loss_history_)
    for a, b in zip(m1.matrices["Hs"], m2.matrices["Hs"]):
        np.testing.assert_array_equal(a, b)


def test_corrupt_snapshot_warns_and_starts_over(tmp_path):
    ck = tckpt.FitCheckpointer(str(tmp_path), {"k": 1})
    with open(ck.path, "wb") as f:
        f.write(b"not a zip archive")
    with pytest.warns(UserWarning, match="unreadable"):
        assert ck.load() is None
    # a fit over an unreadable snapshot of its own configuration
    ad = _adata(integer=False)
    ref = _model().fit(ad.copy(), KEYS, max_iter=6, checkpoint_dir=str(tmp_path / "a"),
                       checkpoint_every=3)
    name = _interrupted_fit(tckpt, ALPINE, ad.copy(), tmp_path / "b", max_iter=9,
                            checkpoint_every=3)
    # the same configuration as ref's, under ref's name
    with open(tmp_path / "b" / name, "wb") as f:
        f.write(b"\x00" * 64)
    with pytest.warns(UserWarning, match="unreadable"):
        m = _model().fit(ad.copy(), KEYS, max_iter=9, checkpoint_dir=str(tmp_path / "b"),
                         checkpoint_every=3)
    np.testing.assert_allclose(m.loss_history_[:6], ref.loss_history_, rtol=1e-4)


def test_clear_removes_crash_leaked_tmp(tmp_path):
    ck = tckpt.FitCheckpointer(str(tmp_path), {"x": 1})
    W = np.ones((2, 2), np.float32)
    ck.save(1, W, W, (), np.zeros((1, 2), np.float32))
    with open(ck.path + ".tmp.npz", "wb") as f:
        f.write(b"partial write from a preempted save")
    ck.clear()
    assert not os.listdir(tmp_path)


def test_checkpointed_verbose_bar_reaches_global_total(tmp_path, monkeypatch):
    positions = []

    class FakeBar:
        def __init__(self, total=None, **kw):
            self.total, self.n = total, 0

        def set_postfix(self, *a, **kw):
            pass

        def refresh(self):
            positions.append(self.n)

        def close(self):
            pass

    import tqdm as tqdm_mod

    monkeypatch.setattr(tqdm_mod, "tqdm", FakeBar)
    _model().fit(_adata(integer=False), KEYS, max_iter=12, verbose=True,
                 checkpoint_dir=str(tmp_path), checkpoint_every=5)
    assert positions and max(positions) == 12, positions
    assert all(b >= a for a, b in zip(positions, positions[1:])), positions


def test_orbax_backend_is_refused(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        tckpt.FitCheckpointer(str(tmp_path), {"x": 1}, backend="orbax")
    with pytest.raises(ValueError, match="'npz' or 'orbax'"):
        tckpt.FitCheckpointer(str(tmp_path), {"x": 1}, backend="bogus")
    with pytest.raises(ValueError, match="orbax imports JAX"):
        _model().fit(_adata(integer=False), KEYS, max_iter=2,
                     checkpoint_dir=str(tmp_path), checkpoint_backend="orbax")
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_resumes_across_packages(jax_draws, tmp_path, writer):
    """One package's fit interrupted after its second snapshot; the other
    resumes it under the same file name and finishes on the JAX package's
    uninterrupted trajectory."""
    ad = _adata(integer=False)
    kw = dict(max_iter=12, checkpoint_every=4)
    jfull = _model(JaxALPINE)
    ad_j = ad.copy()
    jfull.fit(ad_j, KEYS, checkpoint_dir=str(tmp_path / "ref"), **kw)
    module, cls, other = ((jckpt, JaxALPINE, ALPINE) if writer == "jax"
                          else (tckpt, ALPINE, JaxALPINE))
    name = _interrupted_fit(module, cls, ad.copy(), tmp_path / "part", **kw)
    assert name.startswith("fit_snapshot_") and name.endswith(".npz")
    resumed = _model(other)
    ad_r = ad.copy()
    resumed.fit(ad_r, KEYS, checkpoint_dir=str(tmp_path / "part"), **kw)
    assert not os.listdir(tmp_path / "part")
    if other is ALPINE:
        _check_fit_and_transform(jfull, resumed, ad_j, ad_r)
    else:
        np.testing.assert_allclose(resumed.loss_history.values,
                                   jfull.loss_history.values, rtol=5e-4)
        np.testing.assert_allclose(ad_r.obsm["ALPINE_embedding"],
                                   ad_j.obsm["ALPINE_embedding"], rtol=5e-3, atol=1e-5)


@pytest.mark.parametrize("fkw,max_iter", [
    (dict(batch_size=64), 9),
    (dict(sampling_method="weighted_fast"), 9),
    (dict(sampling_method="tiled", batch_size=130), 9),
], ids=["minibatch", "weighted_fast", "tiled"])
def test_sampled_checkpointed_fit_matches_jax(jax_draws, jax_cells, jax_counts,
                                              jax_tiles, tmp_path, fkw, max_iter):
    """Chunks of 4, 4 and 1 iterations, each drawing the JAX package's
    chunk stream: the same trajectory as the JAX package's checkpointed
    fit."""
    ad = make_synthetic_adata(n_cells=300, n_genes=30, seed=2)
    kw = dict(max_iter=max_iter, checkpoint_every=4, **fkw)
    jm, tm = _model(JaxALPINE), _model()
    ad_j, ad_t = ad.copy(), ad.copy()
    jm.fit(ad_j, KEYS, checkpoint_dir=str(tmp_path / "j"), **kw)
    tm.fit(ad_t, KEYS, checkpoint_dir=str(tmp_path / "t"), **kw)
    jm.free_device_cache()
    _check_fit_and_transform(jm, tm, ad_j, ad_t)

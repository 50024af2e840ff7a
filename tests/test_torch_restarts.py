"""Restarts in the port (``fit(n_restarts=k)``) against the JAX package on
the CPU.  The port runs the restarts one after another through its normal
fit path (the JAX package vmaps them on XLA; the arithmetic is the same):

- the winner, its loss history and its factors against
  ``alpine_tpu.ALPINE(...).fit(..., n_restarts=3)`` with the JAX package's
  per-restart inits (and, for a sampled fit, per-restart streams)
  injected; loss rtol 5e-4, factors rtol 5e-3 atol 1e-5, as
  tests/test_torch_model.py.  int8 (bf16 rounding, chaotic at the last
  bit) is held over 2 iterations: the JAX package's vmapped restarts sum
  in another order than a single fit, and on this data its winner's loss
  is 1.9e-5 from the port's after one iteration, 1.2e-4 after two and
  1.4e-3 after three;
- restart 0 is the single fit, bit for bit;
- the winner is ``nanargmin`` of the final total losses, restart 0 when
  every restart diverged (alpine_tpu/models/alpine.py:990-994);
- no progress is reported while restarts run, and the warm-up elbow runs
  through them.
"""

import jax
import numpy as np
import pytest
import torch

import alpine_tpu_torch.models.alpine as talpine
from alpine_tpu import ALPINE as JaxALPINE
from alpine_tpu.ops import mu as jmu
from alpine_tpu_torch import ALPINE
from alpine_tpu_torch.convert import state_from_numpy

from .test_torch_minibatch import jax_cells  # noqa: F401  (fixture)
from .test_torch_model import KEYS, KW, _adata, _check_fit_and_transform
from .test_torch_model import jax_draws  # noqa: F401  (fixture)

torch.set_num_threads(1)


@pytest.fixture
def jax_restart_draws(monkeypatch, jax_draws):
    """Restart r > 0 draws its init as the JAX estimator does:
    init_matrices(split(fold_in(PRNGKey(seed), r))[0])."""
    def draw_restart_init(cfg, n_genes, random_state, restart, eps, device):
        key = jax.random.fold_in(jax.random.PRNGKey(random_state), restart)
        init_key, _ = jax.random.split(key)
        jcfg = jmu.MUConfig(blocks=cfg.blocks, n_labels=cfg.n_labels,
                            n_cells=cfg.n_cells)
        return state_from_numpy(*jmu.init_matrices(jcfg, n_genes, init_key, eps),
                                device)

    monkeypatch.setattr(talpine, "draw_restart_init", draw_restart_init)


@pytest.fixture
def restart_runs(monkeypatch):
    """Each fit_scan's (W, H, Bs, losses), in call order."""
    runs = []
    fit_scan = talpine.mu.fit_scan

    def spy(*args, **kw):
        out = fit_scan(*args, **kw)
        runs.append(out)
        return out

    monkeypatch.setattr(talpine.mu, "fit_scan", spy)
    return runs


@pytest.mark.parametrize("integer,fkw,max_iter", [
    (False, dict(), 15),
    (True, dict(), 2),
    (False, dict(batch_size=64), 6),
], ids=["float32", "int8", "minibatch"])
def test_restarts_match_jax(jax_restart_draws, jax_cells, restart_runs, integer,
                            fkw, max_iter):
    ad = _adata(integer=integer)
    jm, tm = JaxALPINE(device="cpu", **KW), ALPINE(device="cpu", **KW)
    ad_j, ad_t = ad.copy(), ad.copy()
    jm.fit(ad_j, KEYS, max_iter=max_iter, n_restarts=3, **fkw)
    tm.fit(ad_t, KEYS, max_iter=max_iter, n_restarts=3, **fkw)
    finals = [float(r[3][-1, 0]) for r in restart_runs]
    assert len(finals) == 3 and len(set(finals)) == 3
    best = int(np.nanargmin(finals))
    np.testing.assert_array_equal(tm.loss_history_, restart_runs[best][3].numpy())
    _check_fit_and_transform(jm, tm, ad_j, ad_t)


def test_restart_zero_is_the_single_fit(restart_runs):
    ad = _adata(integer=True)
    single = ALPINE(device="cpu", **KW).fit(ad.copy(), KEYS, max_iter=6)
    multi = ALPINE(device="cpu", **KW).fit(ad.copy(), KEYS, max_iter=6, n_restarts=2)
    np.testing.assert_array_equal(restart_runs[1][3].numpy(), single.loss_history_)
    assert multi.loss_history_[-1, 0] <= single.loss_history_[-1, 0]
    # restart 1 started elsewhere
    assert not np.array_equal(restart_runs[2][3].numpy(), single.loss_history_)


@pytest.mark.parametrize("finals,winner", [
    ([np.nan, 5.0, 3.0], 2),
    ([5.0, np.nan, 5.0], 0),
    ([7.0, 4.0, np.nan], 1),
    ([np.nan, np.nan, np.nan], 0),
])
def test_winner_is_nanargmin(monkeypatch, finals, winner):
    """The lowest final total loss wins, NaN never does unless every
    restart is NaN (then restart 0)."""
    fit_scan = talpine.mu.fit_scan
    calls = []

    def fake(cfg, *args, **kw):
        W, H, Bs, L = fit_scan(cfg, *args, **kw)
        L = L.clone()
        L[-1, 0] = finals[len(calls)]
        L[0, 0] = len(calls)  # marks the restart
        calls.append(kw["draw_counts"])
        return W, H, Bs, L

    monkeypatch.setattr(talpine.mu, "fit_scan", fake)
    m = ALPINE(device="cpu", **KW).fit(_adata(integer=True), KEYS, max_iter=3,
                                       n_restarts=3)
    assert len(calls) == 3 and m.loss_history_[0, 0] == winner


def test_restart_streams_are_keyed_on_the_restart(monkeypatch):
    """A sampled fit's streams: restart r is asked for with restart=r."""
    asked = []
    cells = talpine.draw_cells_stream

    def spy(n, rs, dev, probs=None, restart=0, chunk=None):
        asked.append((restart, chunk))
        return cells(n, rs, dev, probs, restart=restart, chunk=chunk)

    monkeypatch.setattr(talpine, "draw_cells_stream", spy)
    m = ALPINE(device="cpu", **KW).fit(_adata(integer=True), KEYS, max_iter=2,
                                       batch_size=40, n_restarts=3)
    assert asked == [(0, None), (1, None), (2, None)]
    assert np.isfinite(m.loss_history_).all()


def test_restarts_report_no_progress_and_run_the_elbow(monkeypatch, restart_runs):
    """verbose restarts move no bar (the JAX package turns progress off
    under vmap); max_iter=None runs the 200-iteration warm-up through the
    restarts, then the fit through them again."""
    reported = []
    monkeypatch.setattr(talpine._Progress, "__call__",
                        lambda self, done, loss: reported.append(done))
    m = ALPINE(device="cpu", **KW).fit(_adata(integer=False), KEYS, max_iter=None,
                                       n_restarts=2, verbose=True)
    assert reported == []
    assert [r[3].shape[0] for r in restart_runs] == [200, 200, m.max_iter, m.max_iter]
    assert 0 < m.max_iter <= 200


def test_elbow_restarts_match_jax(jax_restart_draws):
    ad = _adata(integer=False, seed=1)
    jm, tm = JaxALPINE(device="cpu", **KW), ALPINE(device="cpu", **KW)
    ad_j, ad_t = ad.copy(), ad.copy()
    jm.fit(ad_j, KEYS, max_iter=None, n_restarts=2)
    tm.fit(ad_t, KEYS, max_iter=None, n_restarts=2)
    _check_fit_and_transform(jm, tm, ad_j, ad_t)

"""The estimator's API against the JAX package's where this slice leaves a
feature out or reports on it: the verbose progress bar, the checkpoint
keywords of ``fit``, ``ALPINE.load`` and ``save`` on a missing file or an
untrained model, the refused tiled configurations and the ``batch_size`` a
fit keeps.

The bar is tqdm's, as the JAX fit's ("Iteration", ``objective loss``
postfix, alpine_tpu/models/alpine.py:838-866), but the port updates it every
``mu.progress_every(max_iter)`` iterations and after the last, not every
iteration, so that a verbose fit does not sync the host each iteration.
Both bars must end at ``max_iter/max_iter``; tqdm shows the loss to three
significant digits, so the two shown losses may differ by one unit in the
third digit beyond the loss parity tolerance (rtol 5e-4).
"""

import math
import re
import sys

import numpy as np
import pytest
import torch

import alpine_tpu_torch.models.alpine as talpine
from alpine_tpu import ALPINE as JaxALPINE
from alpine_tpu_torch import ALPINE
from alpine_tpu_torch.ops import mu as tmu

from .conftest import make_synthetic_adata
from .test_torch_model import KEYS, KW, _adata, jax_draws  # noqa: F401

torch.set_num_threads(1)

_BAR_END = re.compile(r"Iteration: *100%.*?(\d+)/(\d+) \[.*?objective loss=([^\]\s]+)\]")


def _last_bar(err: str):
    """(n, total, shown loss) of the last bar line tqdm drew."""
    found = _BAR_END.findall(err)
    assert found, err[-2000:]
    n, total, loss = found[-1]
    return int(n), int(total), float(loss)


@pytest.mark.parametrize("max_iter,use_als", [(12, False), (7, True),
                                              (None, False)])
def test_verbose_bar_matches_jax(jax_draws, capsys, max_iter, use_als):
    ad = _adata(integer=False, seed=2)
    jm = JaxALPINE(device="cpu", use_als=use_als, **KW)
    jm.fit(ad.copy(), KEYS, max_iter=max_iter, verbose=True)
    jax_err = capsys.readouterr().err
    tm = ALPINE(device="cpu", use_als=use_als, **KW)
    tm.fit(ad.copy(), KEYS, max_iter=max_iter, verbose=True)
    out = capsys.readouterr()
    assert tm.max_iter == jm.max_iter
    n_j, total_j, shown_j = _last_bar(jax_err)
    n_t, total_t, shown_t = _last_bar(out.err)
    assert n_t == total_t == n_j == total_j == tm.max_iter
    final = float(tm.loss_history_[-1, 0])
    digit = lambda v: 10.0 ** (math.floor(math.log10(abs(v))) - 2)
    assert abs(shown_t - final) <= 0.5 * digit(final) * (1 + 1e-6)
    assert abs(shown_t - shown_j) <= 5e-4 * abs(shown_j) + digit(shown_j)
    # the summary line after the bar, as the JAX fit prints it
    assert f"ALPINE fit: {tm.max_iter} iterations, final objective loss" in out.out


def test_verbose_without_tqdm_prints_a_line_a_report(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "tqdm", None)  # import tqdm now fails
    tm = ALPINE(device="cpu", **KW)
    tm.fit(_adata(integer=True), KEYS, max_iter=23, verbose=True)
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("ALPINE fit: iteration")]
    every = tmu.progress_every(23)
    want = list(range(every, 23, every)) + [23]
    assert [int(re.search(r"iteration (\d+)/23", l).group(1))
            for l in lines] == want
    last = float(lines[-1].rsplit(" ", 1)[1])
    np.testing.assert_allclose(last, tm.loss_history_[-1, 0], rtol=1e-5)


def test_quiet_fit_installs_no_progress(capsys, monkeypatch):
    seen = []
    real = tmu.fit_scan

    def spy(*args, **kwargs):
        seen.append(kwargs.get("progress"))
        return real(*args, **kwargs)

    monkeypatch.setattr(talpine.mu, "fit_scan", spy)
    for kw in (dict(max_iter=6), dict(max_iter=6, sampling_method="weighted_fast")):
        ALPINE(device="cpu", **KW).fit(_adata(integer=True), KEYS, **kw)
    ALPINE(device="cpu", use_als=True, **KW).fit(_adata(integer=True), KEYS,
                                                 max_iter=6)
    assert seen == [None, None, None]
    out = capsys.readouterr()
    assert out.out == "" and out.err == ""


@pytest.mark.parametrize("use_als,weighted", [(False, False), (False, True),
                                              (True, False)])
def test_progress_reports_do_not_change_the_fit(use_als, weighted):
    """Every fit loop reports at progress_every and at the end, the loss it
    reports is the loss history's, and the trajectory is the same bits as
    without a callback."""
    r = np.random.default_rng(3)
    g, n, T = 12, 40, 17
    X = torch.from_numpy(r.poisson(3.0, (g, n)).astype(np.float32))
    Y = np.zeros((2, n), np.float32)
    Y[r.integers(0, 2, n), np.arange(n)] = 1.0
    cfg = tmu.MUConfig(blocks=(2, 3), n_labels=(2,), n_cells=n, max_iter=T,
                       use_als=use_als, weighted_counts=weighted)
    W0 = torch.from_numpy(r.random((g, 5), dtype=np.float32))
    H0 = torch.from_numpy(r.random((5, n), dtype=np.float32))
    B0 = (torch.from_numpy(r.random((2, 2), dtype=np.float32)),)
    hyper = (torch.ones(1), 0.0, 0.0, 0.0, 1e-6)
    draws = lambda t: torch.from_numpy(
        np.random.default_rng(t).integers(0, 3, n).astype(np.float32))
    calls = []
    got = tmu.fit_scan(cfg, W0, H0, B0, X, [torch.from_numpy(Y)], hyper,
                       draw_counts=draws,
                       progress=lambda d, loss: calls.append((d, loss)))
    want = tmu.fit_scan(cfg, W0, H0, B0, X, [torch.from_numpy(Y)], hyper,
                        draw_counts=draws)
    every = tmu.progress_every(T)
    assert [d for d, _ in calls] == list(range(every, T, every)) + [T]
    assert [l for _, l in calls] == [float(got[3][d - 1, 0]) for d, _ in calls]
    for a, b in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(checkpoint_every=0),
    dict(checkpoint_every=2.5),
    dict(checkpoint_dir="ckpt", checkpoint_backend="bogus"),
    dict(checkpoint_dir=5),
    dict(checkpoint_dir="ckpt", n_restarts=2),
], ids=["every-0", "every-float", "backend", "dir-type", "restarts"])
def test_checkpoint_arguments_match_jax(kw, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # a checkpoint_dir would be relative to it
    ad = _adata(integer=True)
    with pytest.raises((ValueError, TypeError)) as ej:
        JaxALPINE(device="cpu", **KW).fit(ad.copy(), KEYS, max_iter=2, **kw)
    with pytest.raises(type(ej.value)) as et:
        ALPINE(device="cpu", **KW).fit(ad.copy(), KEYS, max_iter=2, **kw)
    assert str(et.value) == str(ej.value)


def test_valid_checkpoint_arguments_are_accepted(tmp_path):
    """Checkpoint keywords without a directory change nothing; with one the
    npz backend runs a checkpointed fit (and clears its snapshot), and the
    orbax backend, which imports JAX, is refused before the fit."""
    ad = _adata(integer=True)
    m = ALPINE(device="cpu", **KW)
    m.fit(ad, KEYS, max_iter=2, checkpoint_every=10, checkpoint_backend="orbax")
    assert m.loss_history_.shape == (2, 4)
    m.fit(ad, KEYS, max_iter=2, checkpoint_dir=str(tmp_path), checkpoint_every=10)
    assert m.loss_history_.shape == (2, 4) and not list(tmp_path.iterdir())
    with pytest.raises(ValueError, match="orbax"):
        m.fit(ad, KEYS, max_iter=2, checkpoint_dir=str(tmp_path),
              checkpoint_backend="orbax")


def test_load_raises_not_implemented(tmp_path):
    """save/load are ported: ``load`` is a classmethod, an untrained save
    and a missing file raise what the JAX package raises, and nothing
    raises NotImplementedError."""
    assert isinstance(ALPINE.__dict__["load"], classmethod)
    for cls in (JaxALPINE, ALPINE):
        with pytest.raises(FileNotFoundError):
            cls.load(str(tmp_path / "missing"), device="cpu")
    with pytest.raises(RuntimeError) as ej:
        JaxALPINE(device="cpu", **KW).save(str(tmp_path / "model"))
    with pytest.raises(RuntimeError) as et:
        ALPINE(device="cpu", **KW).save(str(tmp_path / "model"))
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("batch_size", [None, 400], ids=["no-batch", "covering"])
def test_tiled_misconfigurations_match_jax(batch_size):
    """A tiled fit with no batch_size, or with one that covers every cell,
    raises the reference's ValueError with its message."""
    ad = make_synthetic_adata(n_cells=150, n_genes=40, seed=0)
    kw = dict(batch_size=batch_size, max_iter=3, sampling_method="tiled")
    with pytest.raises(ValueError) as ej:
        JaxALPINE(device="cpu", **KW).fit(ad.copy(), KEYS, **kw)
    with pytest.raises(ValueError) as et:
        ALPINE(device="cpu", **KW).fit(ad.copy(), KEYS, **kw)
    assert str(et.value) == str(ej.value)
    assert "tiled" in str(et.value)


@pytest.mark.parametrize("sampling_method", ["random", "weighted_fast"])
def test_covering_batch_size_is_kept(sampling_method):
    """A covering batch_size runs full-epoch and is kept as the caller gave
    it, as the reference keeps it; without one the fit records n_cells."""
    ad = make_synthetic_adata(n_cells=150, n_genes=40, seed=0)
    kw = dict(max_iter=3, sampling_method=sampling_method)
    jm = JaxALPINE(device="cpu", **KW).fit(ad.copy(), KEYS, batch_size=400, **kw)
    tm = ALPINE(device="cpu", **KW).fit(ad.copy(), KEYS, batch_size=400, **kw)
    assert tm.batch_size == jm.batch_size == 400
    tm = ALPINE(device="cpu", **KW).fit(ad.copy(), KEYS, **kw)
    assert tm.batch_size == 150

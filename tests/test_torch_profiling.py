"""The port's tracing and numerical-debug hooks (alpine_tpu_torch/
profiling.py), the counterparts of alpine_tpu/profiling.py: the phase
timer the estimator fills ``timings_`` with, a trace of a fit whose
phases appear as named ranges, and the finite-loss check of the fit
loops."""

import glob
import json
import time

import numpy as np
import pytest
import torch

from alpine_tpu_torch import ALPINE, AnnData, profiling
from alpine_tpu_torch.ops import mu

torch.set_num_threads(1)


def _adata(n=60, g=12, seed=0):
    r = np.random.default_rng(seed)
    X = r.poisson(3.0, (n, g)).astype(np.float32)
    return AnnData(X, obs={"batch": np.array(["a", "b", "c"] * (n // 3), dtype=object)})


def test_step_timer_accumulates_phases():
    sink = {}
    timer = profiling.StepTimer(sink)
    for _ in range(2):
        with timer.phase("a"):
            time.sleep(0.01)
    with pytest.raises(KeyError):
        with timer.phase("b"):
            raise KeyError("inside")
    assert sink["a"] >= 0.02 and "b" in sink


@pytest.mark.parametrize("max_iter,phases", [(3, {"fit"}), (None, {"warmup", "fit"})])
def test_fit_records_its_phases(max_iter, phases):
    model = ALPINE(n_components=3, n_covariate_components=[2], lam=[1.0], device="cpu")
    model.fit(_adata(), ["batch"], max_iter=max_iter)
    assert set(model.timings_) == phases
    assert all(v > 0 for v in model.timings_.values())


def test_trace_holds_the_fit_phases(tmp_path):
    model = ALPINE(n_components=3, n_covariate_components=[2], lam=[1.0], device="cpu")
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("outer"):
            model.fit(_adata(), ["batch"], max_iter=2)
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert {"outer", "alpine:fit"} <= names


def test_debug_checks_stop_a_non_finite_fit():
    g, n = 6, 20
    cfg = mu.MUConfig(blocks=(2, 3), n_labels=(2,), n_cells=n, max_iter=3)
    r = np.random.default_rng(0)
    X = torch.from_numpy(r.random((g, n), dtype=np.float32))
    X[0, 0] = float("inf")
    Y = torch.zeros((2, n))
    Y[0, ::2] = 1.0
    Y[1, 1::2] = 1.0
    W0, H0, Bs0 = mu.init_matrices(cfg, g, torch.Generator().manual_seed(0), 1e-6, "cpu")
    hyper = (torch.tensor([1.0]), 0.0, 0.0, 0.0, 1e-6)
    *_, L = mu.fit_scan(cfg, W0, H0, Bs0, X, [Y], hyper)
    assert not torch.isfinite(L).all()  # off by default: the fit runs on
    profiling.enable_debug_checks()
    try:
        with pytest.raises(FloatingPointError, match="iteration 0"):
            mu.fit_scan(cfg, W0, H0, Bs0, X, [Y], hyper)
    finally:
        profiling.disable_debug_checks()
    X[0, 0] = 1.0
    profiling.enable_debug_checks()
    try:
        *_, L = mu.fit_scan(cfg, W0, H0, Bs0, X, [Y], hyper)
    finally:
        profiling.disable_debug_checks()
    assert torch.isfinite(L).all()

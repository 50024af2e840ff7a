"""The port stands alone: alpine_tpu_torch, chip_smoke.py, the port's
scripts (scripts/torch_*.py) and the multi-process test workers import
nothing of JAX or of the JAX package, the fit/transform path (minibatch,
weighted, tiled, bucketed, restarted, checkpointed, cell-mesh and grid
fits included), save → load → transform → export and a
ComponentOptimizer search (both fold routes, its kNN, Leiden and folds)
need neither pandas nor scikit-learn, and the estimator never falls back
to the CPU silently."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_BLOCKED_RUN = r"""
import sys
for m in ("jax", "jaxlib", "alpine_tpu", "pandas", "sklearn"):
    sys.modules[m] = None  # any import of these now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
from alpine_tpu_torch import ALPINE, AnnData
r = np.random.default_rng(0)
X = r.poisson(2.0, (90, 16)).astype(np.float32)
obs = {"batch": np.array(["a", "b", "c"] * 30, dtype=object)}
ad = AnnData(X, obs=obs)
m = ALPINE(n_components=4, n_covariate_components=[2], lam=[1.0], device="cpu")
m.fit(ad, ["batch"], max_iter=4)
m.transform(ad)
assert ad.obsm["ALPINE_embedding"].shape == (90, 4)
assert np.isfinite(m.loss_history_).all()
m.fit(ad, ["batch"], max_iter=4, sampling_method="weighted_fast")
assert m._x_cache is not None and m._x_cache[3] is not None
m.transform(ad)  # through the device-X cache
assert np.isfinite(ad.obsm["ALPINE_embedding"]).all()
als = ALPINE(n_components=4, n_covariate_components=[2], lam=[1.0],
             use_als=True, device="cpu")
als.fit(ad, ["batch"], max_iter=4)
als.transform(ad)
assert np.isfinite(als.loss_history_).all()
for kw in (dict(batch_size=25), dict(batch_size=40, sampling_method="weighted")):
    mb = ALPINE(n_components=4, n_covariate_components=[2], lam=[1.0], device="cpu")
    mb.fit(ad, ["batch"], max_iter=3, **kw)
    assert np.isfinite(mb.loss_history_).all() and mb.loss_history_.shape == (3, 3)
tl = ALPINE(n_components=4, n_covariate_components=[2], lam=[1.0], device="cpu",
            component_bucket=4)
tl.fit(ad, ["batch"], max_iter=3, batch_size=40, sampling_method="tiled")
assert tl._x_cache[0].shape == (16, 128) and tl._x_cache[4] == 38
tl.transform(ad)
assert [w.shape[1] for w in tl.matrices["Ws"]] == [2, 4]
assert np.isfinite(ad.obsm["ALPINE_embedding"]).all()
import os
import tempfile
d = tempfile.mkdtemp()
ck = ALPINE(n_components=4, n_covariate_components=[2], lam=[1.0], device="cpu")
ck.fit(ad, ["batch"], max_iter=5, checkpoint_dir=d, checkpoint_every=2, n_restarts=1)
assert np.isfinite(ck.loss_history_).all() and not os.listdir(d)
rs = ALPINE(n_components=4, n_covariate_components=[2], lam=[1.0], device="cpu")
rs.fit(ad, ["batch"], max_iter=3, n_restarts=2)
assert np.isfinite(rs.loss_history_).all()
m.save(d + "/model")
loaded = ALPINE.load(d + "/model", device="cpu")
assert loaded.fe.encoded_labels == m.fe.encoded_labels
loaded.transform(ad, n_iter=5)
loaded.get_normalized_expression(ad, library_size=100.0, cell_block_size=7)
assert np.allclose(ad.layers["normalized_expression"].sum(axis=1), 100.0, rtol=1e-4)
from alpine_tpu_torch import ComponentOptimizer
obs["cond"] = np.array(["u", "v", None] * 30, dtype=object)
for batching in (False, True):
    co = ComponentOptimizer(AnnData(X, obs=obs), ["batch", "cond"], max_iter=4,
                            device="cpu", random_state=0, fold_batching=batching)
    best = co.search_hyperparams(n_total_components_range=(8, 14),
                                 lam_range=(1.0, 50.0), n_splits=2, max_evals=2)
    assert len(co.trials.trials) == 2 and best["random_state"] == 0
    assert all(np.isfinite(t["result"]["loss"]) for t in co.trials.trials
               if t["result"]["status"] == "ok")
assert co.fit_the_best_param().loss_history_.shape[0] == 4
import socket
s = socket.socket()
s.bind(("localhost", 0))
port = s.getsockname()[1]
s.close()
from alpine_tpu_torch.parallel import distributed as dist
dist.initialize(f"localhost:{port}", num_processes=1, process_id=0, timeout=30.0)
sm = ALPINE(n_components=4, n_covariate_components=[2], lam=[1.0],
            device=dist.global_cell_mesh())
sm.fit(ad, ["batch"], max_iter=3)
sm.transform(ad)
assert np.isfinite(sm.loss_history_).all() and sm.timings_["fit"] > 0
gm = ALPINE(n_components=4, n_covariate_components=[2], lam=[1.0],
            device=dist.global_gene_cell_mesh(1, 1))
gm.fit(ad, ["batch"], max_iter=3)
gm.transform(ad)
assert np.isfinite(gm.loss_history_).all()
dist.shutdown()
print("ok")
"""


def test_fit_transform_without_jax_pandas_sklearn():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|alpine_tpu)\b|from\s+(jax|alpine_tpu)(\.|\s))",
    re.MULTILINE)


def test_sources_import_no_jax():
    files = sorted((REPO / "alpine_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py"]
    files += sorted((REPO / "tests").glob("torch_dist_*worker.py"))
    files += sorted((REPO / "scripts").glob("torch_*.py"))
    assert len(files) > 5
    for name in ("alpine_tpu_torch/utils/sampling.py", "alpine_tpu_torch/probe.py",
                 "alpine_tpu_torch/parallel/distributed.py",
                 "alpine_tpu_torch/parallel/mesh.py", "alpine_tpu_torch/profiling.py",
                 "scripts/torch_envelope_probe.py", "scripts/torch_kernel_ab.py",
                 "tests/torch_dist_worker.py", "tests/torch_dist_grid_worker.py"):
        assert REPO / name in files
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(REPO)} imports {hits}"


def test_default_device_without_cuda_raises(monkeypatch):
    from alpine_tpu_torch import ALPINE

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(n_components=3, n_covariate_components=[], lam=[])
    for device in ("cuda", "auto"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ALPINE(device=device, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ALPINE(**kw)
    assert ALPINE(device="cpu", **kw).device == torch.device("cpu")

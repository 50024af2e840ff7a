"""The port stands alone: alpine_tpu_torch, chip_smoke.py and the port's
scripts (scripts/torch_*.py) import nothing of JAX or of the JAX package,
the fit/transform path needs neither pandas nor scikit-learn, and the
estimator never falls back to the CPU silently."""

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
    files.append(REPO / "chip_smoke.py")
    files += sorted((REPO / "scripts").glob("torch_*.py"))
    assert len(files) > 5
    for name in ("alpine_tpu_torch/utils/sampling.py", "alpine_tpu_torch/probe.py",
                 "scripts/torch_envelope_probe.py", "scripts/torch_kernel_ab.py"):
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

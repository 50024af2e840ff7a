"""Cell-axis sharding of the port over processes, on the CPU: two gloo
ranks (tests/torch_dist_worker.py, spawned once for the module) each fit
and transform their own cells, and the parent holds what they wrote
against the single-process port and the JAX package.

- ``process_cell_range`` against the JAX package's, errors included.
- The sharded fit loop ``mu._fit_scan_fused`` in float64 (the kernels'
  plain versions; KL, Frobenius, no covariates) against the
  single-process float64 loop
  ``mu._fit_scan_steps`` at rtol 1e-11.
- ``mu.fit_scan_sharded`` and the sharded ``run_transform`` on 2 ranks
  against the JAX package's on a 4-device (8 for the ragged transform)
  CPU mesh in interpret mode, on the inputs and at the tolerances of the
  five sharded tests of tests/test_pallas.py (:237, :279, :334, :356,
  :409), from ``alpine_tpu.ops.mu.init_matrices``'s draws.
- The estimator on 96 cells (48/48) and 95 cells (48/47) against the
  port's single-process fit at tests/test_multiprocess.py's tolerances
  (loss rtol 1e-4, embedding rtol 5e-3 atol 1e-5), an int8 fit at loss
  rtol 5e-4; W and the loss history bit-equal across the ranks.  The int8
  fit is held over 5 iterations, as tests/test_torch_model.py holds int8:
  it computes in bf16, where the shards' other summation order flips bf16
  roundings of W and H, and on these counts (up to 79) the two
  trajectories part by 1.0e-4 after 5 iterations and 1.05e-3 after 8.
- Its transform (96 cells through the fit's device X, 61 fresh cells) and
  a mesh model's pickle against the single-process transform with the
  same W: each column's projection is independent, so they agree to the
  summation order of 2WᵀX (rtol 1e-5).
- One all-reduce an iteration, of the same bytes at 2,048 and 8,192 cells.
- Refusals and inconsistent inputs raise on both ranks, with the JAX
  package's message where it has one, and the group still works after;
  the modes ported since (weighted_fast, ALS, minibatch, tiled,
  checkpoints, gathered weighted, ALS minibatch) fit on both ranks, and
  ComponentOptimizer constructs on both from the full data.
"""

import pickle
import socket
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpine_tpu.ops import mu as jmu
from alpine_tpu.parallel import distributed as jdist
from alpine_tpu_torch import ALPINE, AnnData
from alpine_tpu_torch.ops import mu as tmu
from alpine_tpu_torch.parallel import distributed as tdist
from alpine_tpu_torch.parallel import mesh as tmesh

from .conftest import make_synthetic_adata
from .torch_ranks import group_threads, run_ranks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_dist_worker.py"
KEYS = ["batch", "condition"]
KW = dict(n_components=6, n_covariate_components=[2, 3], lam=[1.0, 2.0],
          random_state=0)
EPS = 1e-6
BLOCKS, N_LABELS = (3, 4, 6), (2, 3)
WORLD = 2
JAX_SOURCE = (REPO / "alpine_tpu" / "models" / "alpine.py").read_text()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _labels(r, n, n_labels):
    Ys = []
    for nl in n_labels:
        y = np.zeros((nl, n), np.float32)
        y[r.integers(0, nl, n), np.arange(n)] = 1.0
        Ys.append(y)
    return Ys


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _f64_cases():
    out = {}
    for name, blocks, n_labels, kl in (("kl", BLOCKS, N_LABELS, True),
                                       ("fro", BLOCKS, N_LABELS, False),
                                       ("unguided", (5,), (), True)):
        r = np.random.default_rng(len(out))
        g, n = 20, 61  # 31 / 30 cells
        K = sum(blocks)
        out[name] = dict(
            cfg=dict(blocks=blocks, n_labels=n_labels, n_cells=n, loss_kl=kl,
                     max_iter=20, backend="plain"),
            X=r.random((g, n)) * 2, Ys=[y.astype(np.float64) for y in _labels(r, n, n_labels)],
            W0=r.random((g, K)) + 0.1, H0=r.random((K, n)) + 0.1,
            Bs0=[r.random((nl, k)) + 0.1 for nl, k in zip(n_labels, blocks)],
            lam=np.asarray([2.0, 0.5][:len(n_labels)]), hyper=(0.3, 0.7, 0.4, EPS))
    return out


def _jax_fit_cases():
    """The inputs of tests/test_pallas.py's sharded fit tests (:237, :279,
    :409) and the JAX package's initial state for them."""
    cases = {}
    for name, g, seed, key, blocks, n_labels, dtype, iters, hyper in (
            ("joint", 30, 3, 0, BLOCKS, N_LABELS, "float32", 8, ([2.0, 1.0], 0.1, 0.2, 0.3)),
            ("unguided", 20, 5, 1, (7,), (), "float32", 6, ([], 0.0, 0.0, 0.0)),
            ("int8", 30, 9, 0, BLOCKS, N_LABELS, "int8", 8, ([2.0, 1.0], 0.1, 0.2, 0.3))):
        n = 1024
        r = np.random.default_rng(seed)
        if dtype == "int8":
            X = r.poisson(2.0, (g, n)).clip(0, 127).astype(np.float32)
        else:
            X = r.random((g, n), dtype=np.float32)
        Ys = _labels(r, n, n_labels)
        jcfg = jmu.MUConfig(blocks=blocks, n_labels=n_labels, n_cells=n,
                            loss_kl=True, max_iter=iters, x_dtype=dtype,
                            backend="pallas_interpret")
        W0, H0, Bs0 = jmu.init_matrices(jcfg, g, jax.random.PRNGKey(key), EPS)
        cases[name] = dict(
            cfg=dict(blocks=blocks, n_labels=n_labels, n_cells=n, loss_kl=True,
                     max_iter=iters, x_dtype=dtype),
            X=X, Ys=Ys, W0=np.asarray(W0), H0=np.asarray(H0),
            Bs0=[np.asarray(b) for b in Bs0],
            lam=np.asarray(hyper[0], np.float32),
            hyper=tuple(float(np.float32(v)) for v in hyper[1:]) + (EPS,),
            jcfg=jcfg)
    return cases


def _jax_transform_cases():
    """The inputs of tests/test_pallas.py:334 and :356."""
    cases = {}
    for name, seed, g, K, n, iters, devices in (("transform", 7, 24, 9, 1000, 15, 4),
                                                ("transform_ragged", 11, 16, 7, 997, 10, 8)):
        r = np.random.default_rng(seed)
        W = r.random((g, K), dtype=np.float32)
        X = r.random((g, n), dtype=np.float32)
        H0 = r.random((K, n), dtype=np.float32) + 0.1
        cases[name] = dict(W=W, X=X, H0=H0, eps=EPS, n_iter=iters, devices=devices)
    return cases


def _payload_cases():
    out = {}
    g, blocks, n_labels = 20, (2, 3, 4), (2, 3)
    for n in (2048, 8192):
        r = np.random.default_rng(n)
        K = sum(blocks)
        out[str(n)] = dict(
            cfg=dict(blocks=blocks, n_labels=n_labels, n_cells=n, max_iter=3),
            X=r.random((g, n), dtype=np.float32), Ys=_labels(r, n, n_labels),
            W0=r.random((g, K), dtype=np.float32) + 0.1,
            H0=r.random((K, n), dtype=np.float32) + 0.1,
            Bs0=[r.random((nl, k), dtype=np.float32) + 0.1
                 for nl, k in zip(n_labels, blocks)],
            lam=np.asarray([1.0, 2.0], np.float32), hyper=(0.0, 0.0, 0.0, EPS))
    return out


def _adata_case(n_cells, seed, data_dtype="float32", max_iter=12, integer=False):
    ad = make_synthetic_adata(n_cells=n_cells, n_genes=32, seed=seed)
    X = np.asarray(ad.X, np.float32)
    if integer:
        X = np.round(X)
    return dict(X=X, obs={k: np.asarray(ad.obs[k].to_numpy(), dtype=object) for k in KEYS},
                data_dtype=data_dtype, max_iter=max_iter)


def _port_adata(case):
    return AnnData(np.array(case["X"]), obs={k: v.copy() for k, v in case["obs"].items()})


def _build_inputs():
    auto = _adata_case(96, 8)
    auto["X"] = np.floor(auto["X"]).clip(0, 100)
    auto["X"][60, 3] = 200.0  # in rank 1's cells only
    return {
        "f64": _f64_cases(),
        "jax_fit": {k: {kk: vv for kk, vv in v.items() if kk != "jcfg"}
                    for k, v in _jax_fit_cases().items()},
        "jax_transform": _jax_transform_cases(),
        "payload": _payload_cases(),
        "estimator": {"96": _adata_case(96, 2), "95": _adata_case(95, 4),
                      "int8": _adata_case(96, 5, "int8", 5, integer=True)},
        "fresh": _adata_case(61, 7),
        "auto": auto,
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the worker on two gloo ranks once; returns (inputs, [rank 0's
    outputs, rank 1's])."""
    workdir = tmp_path_factory.mktemp("torch_dist")
    inputs = _build_inputs()
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    return inputs, run_ranks(WORKER, workdir, WORLD, timeout=100)


def _cat(results, key, field="H", axis=1):
    return np.concatenate([res[key][field] for res in results], axis=axis)


def _same_across_ranks(results, key, fields):
    for field in fields:
        a = results[0][key][field]
        for res in results[1:]:
            b = res[key][field]
            if isinstance(a, list):
                assert all(np.array_equal(x, y) for x, y in zip(a, b)), field
            else:
                assert np.array_equal(a, b), (key, field)


# ---------------------------------------------------------------------------
# the cell ranges
# ---------------------------------------------------------------------------

_RANGE_GRID = sorted({(n, p, i) for n in (1, 3, 95, 96, 100_000)
                      for p in (1, 2, 3, 7) for i in (0, p - 1, p)}
                     | {(0, 2, 0), (-5, 2, 0), (10, 2, -1)})


@pytest.mark.parametrize("n,p,i", _RANGE_GRID)
def test_process_cell_range_matches_jax(n, p, i):
    try:
        want = jdist.process_cell_range(n, p, i)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tdist.process_cell_range(n, p, i)
        assert str(got.value) == str(e)
        return
    assert tdist.process_cell_range(n, p, i) == want


def test_process_cell_range_rejects_non_integers():
    for bad in (2.5, "10", None):
        with pytest.raises(ValueError, match="positive integer"):
            tdist.process_cell_range(bad, 2, 0)


def test_ranks_know_their_place(ranks):
    _, results = ranks
    assert [r["process_index"] for r in results] == [0, 1]
    assert [r["process_count"] for r in results] == [2, 2]
    assert [r["is_coordinator"] for r in results] == [True, False]


# ---------------------------------------------------------------------------
# the sharded fit loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["kl", "fro", "unguided"])
def test_sharded_fit_f64_matches_single_process(ranks, name):
    inputs, results = ranks
    case = inputs["f64"][name]
    t = torch.from_numpy
    cfg = tmu.MUConfig(**case["cfg"])
    W, H, Bs, L = tmu._fit_scan_steps(
        cfg, t(case["W0"]), t(case["H0"]), tuple(t(b) for b in case["Bs0"]),
        t(case["X"]), [t(y) for y in case["Ys"]], (t(case["lam"]), *case["hyper"]),
        None, None, None)
    key = f"f64_{name}"
    _same_across_ranks(results, key, ("W", "Bs", "L"))
    got = results[0][key]
    assert got["W"].dtype == np.float64 and got["L"].dtype == np.float64
    np.testing.assert_allclose(got["W"], W.numpy(), rtol=1e-11)
    np.testing.assert_allclose(_cat(results, key), H.numpy(), rtol=1e-11)
    np.testing.assert_allclose(got["L"], L.numpy(), rtol=1e-11)
    for b, want in zip(got["Bs"], Bs):
        np.testing.assert_allclose(b, want.numpy(), rtol=1e-11)


def _jax_sharded_fit(case, n_devices=4):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("cells",))
    sh = lambda a: jax.device_put(a, NamedSharding(mesh, P(None, "cells")))
    rp = lambda a: jax.device_put(a, NamedSharding(mesh, P()))
    jcfg = case["jcfg"]
    X = jnp.asarray(case["X"]).astype(jcfg.xdt)
    hyper = (jnp.asarray(case["lam"]),) + tuple(jnp.float32(v) for v in case["hyper"])
    W, H, _, L = jmu.fit_scan_sharded(
        jcfg, mesh, rp(jnp.asarray(case["W0"])), sh(jnp.asarray(case["H0"])),
        tuple(rp(jnp.asarray(b)) for b in case["Bs0"]), sh(X),
        tuple(sh(jnp.asarray(y)) for y in case["Ys"]), hyper)
    return np.asarray(W), np.asarray(H), np.asarray(L)


# (loss rtol, W rtol/atol, H rtol/atol) of tests/test_pallas.py's tests
_JAX_FIT_TOL = {"joint": (1e-4, (1e-3, 1e-6), (1e-3, 1e-5)),
                "unguided": (1e-4, None, None),
                "int8": (5e-4, (1e-3, 1e-6), None)}


@pytest.mark.parametrize("name", list(_JAX_FIT_TOL))
def test_sharded_fit_matches_jax_sharded(ranks, name):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    _, results = ranks
    case = _jax_fit_cases()[name]
    W, H, L = _jax_sharded_fit(case)
    key = f"jax_{name}"
    _same_across_ranks(results, key, ("W", "Bs", "L"))
    got = results[0][key]
    loss_rtol, w_tol, h_tol = _JAX_FIT_TOL[name]
    np.testing.assert_allclose(got["L"], L, rtol=loss_rtol)
    if w_tol:
        np.testing.assert_allclose(got["W"], W, rtol=w_tol[0], atol=w_tol[1])
    if h_tol:
        np.testing.assert_allclose(_cat(results, key), H, rtol=h_tol[0], atol=h_tol[1])


@pytest.mark.parametrize("name", ["transform", "transform_ragged"])
def test_sharded_transform_matches_jax_sharded(ranks, name):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    inputs, results = ranks
    case = inputs["jax_transform"][name]
    if len(jax.devices()) < case["devices"]:
        pytest.skip(f"needs {case['devices']} virtual devices")
    mesh = Mesh(np.asarray(jax.devices()[:case["devices"]]), ("cells",))
    want = jmu.run_transform(
        jax.device_put(jnp.asarray(case["W"]), NamedSharding(mesh, P())),
        jnp.asarray(case["X"]), jnp.asarray(case["H0"]), jnp.float32(EPS),
        n_iter=case["n_iter"], fused=True, mesh=mesh, interpret=True)
    got = _cat(results, f"jax_{name}")
    assert got.shape == case["H0"].shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=1e-5)


def test_one_all_reduce_an_iteration_independent_of_cells(ranks):
    """The counterpart of test_comm_audit_cell_count_invariance: the
    iteration's all-reduce carries genes × K + K × K + 1 + n_cov + the B
    statistics, whatever the cell count."""
    inputs, results = ranks
    case = inputs["payload"]["2048"]
    g, K = case["X"].shape[0], sum(case["cfg"]["blocks"])
    n_labels, blocks = case["cfg"]["n_labels"], case["cfg"]["blocks"]
    values = (g * K + K * K + 1 + len(n_labels)
              + sum(nl * k for nl, k in zip(n_labels, blocks)) + sum(blocks[:-1]))
    for res in results:
        small, big = res["payload_2048"], res["payload_8192"]
        for summary in (small, big):
            assert summary["iteration"]["calls"] == case["cfg"]["max_iter"]
            assert summary["setup"]["calls"] == 1
        assert small["iteration"]["bytes"] == big["iteration"]["bytes"]
        assert small["iteration"]["bytes"] == 4 * values * case["cfg"]["max_iter"]


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------


def _single_process_fit(case):
    model = ALPINE(device="cpu", data_dtype=case["data_dtype"], **KW)
    ad = _port_adata(case)
    model.fit(ad, KEYS, max_iter=case["max_iter"])
    return model, ad


@pytest.mark.parametrize("name,loss_rtol", [("96", 1e-4), ("95", 1e-4), ("int8", 5e-4)])
def test_estimator_matches_single_process(ranks, name, loss_rtol):
    inputs, results = ranks
    case = inputs["estimator"][name]
    model, ad = _single_process_fit(case)
    got = results[0][f"est_{name}"]
    assert got["data_dtype"] == model.data_dtype_ == case["data_dtype"]
    np.testing.assert_allclose(got["loss"], model.loss_history_, rtol=loss_rtol)
    if name != "int8":
        emb = _cat(results, f"est_{name}", "emb", axis=0)
        np.testing.assert_allclose(emb, ad.obsm["ALPINE_embedding"], rtol=5e-3, atol=1e-5)


@pytest.mark.parametrize("name", ["96", "95", "int8"])
def test_estimator_replicas_bit_equal(ranks, name):
    inputs, results = ranks
    key = f"est_{name}"
    _same_across_ranks(results, key, ("W", "loss", "Bs"))
    n = inputs["estimator"][name]["X"].shape[0]
    assert [r[key]["emb"].shape[0] for r in results] == [
        hi - lo for lo, hi in (tdist.process_cell_range(n, WORLD, i) for i in range(WORLD))]
    for res in results:
        c = res[key]["collectives"]
        assert c["iteration"]["calls"] == inputs["estimator"][name]["max_iter"]
        assert c["setup"]["calls"] == 1
        assert res[key]["timings"]["fit"] > 0


def _pickled_model(results):
    """Rank 0's fitted model, moved to one process on the CPU."""
    model = pickle.loads(results[0]["cpu_model"])
    assert model.device == torch.device("cpu")
    return model


@pytest.mark.parametrize("name", ["96", "61"])
def test_sharded_transform_matches_single_process(ranks, name):
    inputs, results = ranks
    model = _pickled_model(results)
    case = inputs["estimator"]["96"] if name == "96" else inputs["fresh"]
    ad = _port_adata(case)
    model.transform(ad, n_iter=7)
    want = np.concatenate([ad.obsm[k] for k in KEYS] + [ad.obsm["ALPINE_embedding"]], axis=1)
    got = _cat(results, f"tr_{name}", axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    if name == "96":
        assert all(r["tr_96"]["cache"] for r in results)


def test_mesh_model_pickle_round_trip(ranks, monkeypatch):
    """In the ranks a pickled mesh model rebuilds its mesh and transforms
    as the original.  Where no process group of its size exists it loads
    onto the card, and with no card it raises as ALPINE(device="cuda")
    does: there is no silent move to the CPU."""
    _, results = ranks
    for res in results:
        assert res["pickle"]["device"] == "DeviceMesh"
        assert res["pickle"]["mesh_size"] == WORLD
        assert np.array_equal(res["pickle"]["H"], res["tr_61"]["H"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        pickle.loads(results[0]["pickle"]["blob"])
    assert _pickled_model(results).matrices["Ws"][0].shape == (32, 2)


def test_elbow_runs_on_the_replicated_losses(ranks):
    """max_iter=None: the 200-iteration warm-up and the elbow give every
    rank the single-process fit's iteration count.  Over these ~100
    iterations the reconstruction loss (‖X‖² − 2·tr + tr, float32) parts
    from the single process's by a few ulps of ‖X‖², so the loss carries
    the repo's 2e-6·‖X‖² floor (tests/test_torch_model.py)."""
    inputs, results = ranks
    case = dict(inputs["estimator"]["96"], max_iter=None)
    model, _ = _single_process_fit(case)
    assert [r["elbow"]["max_iter"] for r in results] == [model.max_iter] * WORLD
    assert results[0]["elbow"]["timings"] == ["fit", "warmup"]
    _same_across_ranks(results, "elbow", ("loss",))
    floor = 2e-6 * float(np.sum(np.square(case["X"].astype(np.float64))))
    np.testing.assert_allclose(results[0]["elbow"]["loss"], model.loss_history_,
                               rtol=1e-4, atol=floor)


def test_auto_dtype_takes_the_widest(ranks):
    _, results = ranks
    assert [r["auto"]["local_max"] > 127 for r in results] == [False, True]
    assert [r["auto"]["data_dtype"] for r in results] == ["int16", "int16"]
    assert np.array_equal(results[0]["auto"]["loss"], results[1]["auto"]["loss"])


# the failure cases: (exception type, message the JAX package also raises)
_FAILURES = {
    "genes_differ": ("ValueError", "per-process fit inputs (gene count"),
    "int8_unstorable": ("ValueError", "cannot represent the data on at least one process's shard"),
    "n_restarts": ("ValueError", "n_restarts > 1 is not supported with a sharded (Mesh) device."),
    "transform_genes_differ": ("ValueError", "per-process transform inputs (genes"),
}
# the cases that raised until they were ported: each mode now fits on
# every rank (tests/test_torch_distributed_modes.py holds their results
# against the single process and the JAX package), and the optimizer
# constructs on every rank from the full data
# (tests/test_torch_optimizer_distributed.py runs its searches)
_NOW_RUN = ("minibatch", "weighted_fast", "tiled", "als", "checkpoint", "optimizer",
            "weighted", "als_minibatch")


@pytest.mark.parametrize("name", list(_FAILURES) + list(_NOW_RUN))
def test_failures_raise_on_every_rank(ranks, name):
    _, results = ranks
    got = [r["failures"][name] for r in results]
    if name in _NOW_RUN:
        assert got == [None] * WORLD, got
        assert [r["failures"]["after"] for r in results] == [float(WORLD)] * WORLD
        return
    kind, message = _FAILURES[name]
    assert all(g is not None for g in got), got
    assert [g[0] for g in got] == [kind] * WORLD, got
    for _, msg in got:
        assert message in msg
        assert message in " ".join(JAX_SOURCE.split()).replace('" "', ""), message
    # the process group outlived every refusal
    assert [r["failures"]["after"] for r in results] == [float(WORLD)] * WORLD


# ---------------------------------------------------------------------------
# one process: the degenerate mesh, the helpers, devices
# ---------------------------------------------------------------------------


def test_helpers_without_a_process_group():
    assert not torch.distributed.is_initialized()
    assert (tdist.process_count(), tdist.process_index(), tdist.is_coordinator()) == (1, 0, True)
    tdist.assert_same_across_processes([1, 2, 3], "anything")
    np.testing.assert_array_equal(tdist.process_allgather_rows([4, 5]), [[4, 5]])
    with pytest.raises(RuntimeError, match="initialize"):
        tdist.global_cell_mesh()


def test_initialize_needs_an_address(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        tdist.initialize()
    with pytest.raises(ValueError, match="out of range"):
        tdist.initialize("localhost:1", num_processes=2, process_id=2)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tdist.initialize("localhost:1", num_processes=1, process_id=0, backend="nccl")
    assert not torch.distributed.is_initialized()


def test_initialize_reads_torchrun_env(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    tdist.initialize(timeout=30.0)
    try:
        assert torch.distributed.get_backend() == "gloo"
        assert (tdist.process_count(), tdist.process_index()) == (1, 0)
        with pytest.raises(RuntimeError, match="already initialized"):
            tdist.initialize()
        np.testing.assert_array_equal(tdist.process_allgather_rows([[1.5, 2.0]]),
                                      [[[1.5, 2.0]]])
    finally:
        tdist.shutdown()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("kind", ["cells", "grid", "restored"])
def test_shutdown_ends_the_group_threads_while_meshes_live(kind):
    """A mesh holds its process groups; shutdown takes them from every mesh
    the port built, so the gloo group's threads end in the call even while
    the mesh, its sub-mesh and a model on it are still referenced (a
    thread left running to the interpreter's exit aborts the process
    there when it still holds tensors of the last collective)."""
    before = group_threads()
    tdist.initialize(f"localhost:{_free_port()}", num_processes=1, process_id=0,
                     timeout=30.0)
    try:
        if kind == "cells":
            mesh = tdist.global_cell_mesh()
        elif kind == "grid":
            mesh = tdist.global_gene_cell_mesh(1, 1)
        else:
            mesh = tmesh.restore_device(("__mesh__", ("cells",), (1,), "cpu"))
        model = ALPINE(device=mesh, **KW)
        placement = tmesh.Placement(mesh)
        assert placement.group is not None
        sub = mesh["cells"] if kind == "grid" else mesh
        np.testing.assert_array_equal(tdist.process_allgather_rows([7]), [[7]])
        assert len(group_threads()) > len(before)
    finally:
        tdist.shutdown()
    assert group_threads() == before
    assert model.device is mesh and sub is not None


@pytest.fixture
def world_of_one():
    tdist.initialize(f"localhost:{_free_port()}", num_processes=1, process_id=0,
                     timeout=30.0)
    try:
        yield tdist.global_cell_mesh()
    finally:
        tdist.shutdown()


def test_world_of_one_is_the_single_device_fit(world_of_one):
    """A mesh of one process runs the sharded path, whose all-reduce
    changes nothing: the fit and transform equal the single-device ones
    bit for bit."""
    case = _adata_case(96, 2, max_iter=10)
    out = []
    for device in ("cpu", world_of_one):
        model = ALPINE(device=device, **KW)
        ad = _port_adata(case)
        tdist.reset_collectives()
        model.fit(ad, KEYS, max_iter=10)
        fit_emb = ad.obsm["ALPINE_embedding"].copy()
        model.transform(ad)
        out.append((model.loss_history_, np.concatenate(model.matrices["Ws"], axis=1),
                    fit_emb, ad.obsm["ALPINE_embedding"], dict(tdist.collectives)))
    (La, Wa, Fa, Ta, ca), (Lb, Wb, Fb, Tb, cb) = out
    assert ca == {} and cb["iteration"]["calls"] == 10
    for a, b in ((La, Lb), (Wa, Wb), (Fa, Fb), (Ta, Tb)):
        assert np.array_equal(a, b)


def test_mesh_refusals_and_descriptors(world_of_one, monkeypatch):
    from torch.distributed.device_mesh import init_device_mesh

    placement = tmesh.Placement(world_of_one)
    assert placement.is_sharded
    assert (placement.n_processes, placement.process_chunk_index,
            placement.device) == (1, 0, torch.device("cpu"))
    assert tmesh.resolve_device(world_of_one) is world_of_one
    desc = tmesh.describe_device(world_of_one)
    assert desc == ("__mesh__", ("cells",), (1,), "cpu")
    rebuilt = tmesh.restore_device(desc)
    assert tmesh.is_mesh(rebuilt) and rebuilt.mesh_dim_names == ("cells",)
    # a mesh of another size than the group's: the card, which is absent
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        tmesh.restore_device(("__mesh__", ("cells",), (2,), "cpu"))
    # the ("genes", "cells") grid is accepted (tests/test_torch_gene_cell_mesh.py
    # fits on it), its descriptor round-trips
    grid = init_device_mesh("cpu", (1, 1), mesh_dim_names=("genes", "cells"))
    assert tmesh.resolve_device(grid) is grid
    desc = tmesh.describe_device(grid)
    assert desc == ("__mesh__", ("genes", "cells"), (1, 1), "cpu")
    assert tmesh.restore_device(desc).mesh_dim_names == ("genes", "cells")
    with pytest.raises(ValueError, match="ALPINE expects a 1-D mesh"):
        tmesh.resolve_device(init_device_mesh("cpu", (1, 1), mesh_dim_names=("a", "b")))
    assert tmesh.describe_device(torch.device("cpu")) == torch.device("cpu")

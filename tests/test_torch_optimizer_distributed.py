"""ComponentOptimizer over processes (trial-level parallel TPE rounds on a
cell mesh), on the CPU: two gloo ranks (tests/torch_dist_optimizer_worker.py,
spawned once for the module) each hold the full data, and the parent
holds what they wrote against each other and against the JAX package.

The scenario is tests/test_multiprocess.py's: 96 cells × 32 genes
(``make_synthetic_adata(seed=2)``), ``["batch"]``, ``max_iter=6``,
``random_state=0``, float32, ranges (8, 16) and (1, 100), ``n_splits=2``,
``max_evals=6``, then ``fit_the_best_param``, a pickle round trip and a
``max_iter=None`` search of 5 evaluations.

- Both ranks end with the same trials (tids, points, losses, statuses,
  records), best parameters and refit loss; each fit only its own trials.
- Against the JAX package: its ``fmin_parallel`` over two JAX
  ComponentOptimizers in lockstep threads (the barrier exchange of
  tests/test_torch_tpe.py), fed their ``objective`` and
  ``_remote_trial_result``; the ranks draw the folds' inits from the JAX
  package's streams (tables made here).  Points equal, losses within
  atol 1e-6 (tests/test_torch_optimizer.py's tolerance for a sequential
  search), the same ``best_param``.
- Mismatches (one cell of the data, ``lam_range``, loaded trials, an
  ``objective`` that raises on rank 1 in a parallel or a replicated
  round) raise on both ranks with the JAX package's message, before any
  trial fit where the JAX package checks first, and the group still
  works after each.
- In this process, a world of one: the mesh search is the ``device="cpu"``
  search bit for bit; a mesh that does not span every process raises,
  and a 1 × 1 ("genes", "cells") grid builds and searches.
"""

import pickle
import socket
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpine_tpu import ComponentOptimizer as JaxCO
from alpine_tpu.ops import mu as jmu
from alpine_tpu.optimize import tpe as jtpe
from alpine_tpu.optimize.optimizer import SearchSpace as JaxSpace
from alpine_tpu_torch import AnnData, ComponentOptimizer
from alpine_tpu_torch.parallel import distributed as tdist

from .conftest import make_synthetic_adata
from .torch_ranks import run_ranks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_dist_optimizer_worker.py"
WORLD = 2
CTOR = dict(max_iter=6, random_state=0, data_dtype="float32")
SEARCH = dict(n_total_components_range=(8, 16), lam_range=(1.0, 100.0), n_splits=2)
EPS = 1e-6


def _source(*parts):
    """A JAX package source with its adjacent string literals joined."""
    text = (REPO / "alpine_tpu").joinpath(*parts).read_text()
    return " ".join(text.split()).replace('" "', "")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def full():
    return make_synthetic_adata(n_cells=96, n_genes=32, seed=2)


def _port(ad):
    return AnnData(np.asarray(ad.X), obs={"batch": ad.obs["batch"].to_numpy(dtype=object)})


def _jax_lockstep(ad, n_workers=WORLD, max_evals=6):
    """The JAX package's fmin_parallel over one JAX ComponentOptimizer a
    worker thread, exchanging through a barrier; returns the optimizers."""
    barrier = threading.Barrier(n_workers)
    shared = np.full(n_workers, np.nan)
    cos = [JaxCO(ad, ["batch"], device="cpu", **CTOR) for _ in range(n_workers)]
    errors = []

    def run(w):
        co = cos[w]
        space = JaxSpace(SEARCH["n_total_components_range"], SEARCH["lam_range"],
                         (0.0, 1.0), (0.0, 100.0), (0.0, 1.0), n_covariates=1)
        co.iter_records, co.n_splits, co._search_space = [], SEARCH["n_splits"], space
        co.space = space.to_tpe()
        co.min_covariate_components = co._resolve_floors(None)
        co.trials = jtpe.Trials()

        def exchange(v):
            shared[w] = v
            barrier.wait()
            row = shared.copy()
            barrier.wait()
            return row
        try:
            best = jtpe.fmin_parallel(
                co.objective, co.space, fn_remote=co._remote_trial_result,
                exchange_losses=exchange, n_workers=n_workers, worker_index=w,
                algo=jtpe.tpe.suggest, max_evals=max_evals, trials=co.trials,
                rstate=np.random.default_rng(co.random_state),
                round_size=lambda: 1 if co.max_iter is None else n_workers)
            co._decode_best(best)
        except BaseException as exc:
            errors.append(exc)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(w,)) for w in range(n_workers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads), "a lockstep worker did not finish"
    assert not errors, errors
    return cos


def _jax_draw_tables(ad, trials):
    """The JAX package's fold draws (its batched route's init and
    validation H0) for the block shape of every successful trial, keyed as
    the port's batched draws are called."""
    co = ComponentOptimizer(_port(ad), ["batch"], device="cpu", **CTOR)
    co.n_splits = SEARCH["n_splits"]
    folds = co._stratified_folds()
    n_tr = max(len(tr) for tr, _ in folds)
    n_va = max(len(va) for _, va in folds)
    n_labels = (len(set(ad.obs["batch"])),)
    seed, g = CTOR["random_state"], ad.X.shape[1]
    init_key, _ = jax.random.split(jax.random.PRNGKey(seed))
    t_key = jmu.transform_key(jax.random.PRNGKey(seed))
    init, h0 = {}, {}
    for t in trials.trials:
        if t["result"]["status"] != "ok":
            continue
        p = t["result"]["params"]
        true = tuple(p["n_covariate_components"]) + (p["n_components"],)
        blocks = co._bucketed(true) or true
        jcfg = jmu.MUConfig(blocks=blocks, n_labels=n_labels, n_cells=n_tr)
        W0, H0, Bs0 = jmu.init_matrices(jcfg, g, init_key, EPS)
        init[(blocks, n_labels, n_tr, g, seed)] = (
            np.array(W0), np.array(H0), [np.array(b) for b in Bs0])
        h0[(sum(blocks), n_va, seed)] = np.array(jnp.maximum(
            jax.random.uniform(t_key, (sum(blocks), n_va), dtype=jnp.float32), EPS))
    return init, h0


@pytest.fixture(scope="module")
def jax_search(full):
    return _jax_lockstep(full)


@pytest.fixture(scope="module")
def ranks(full, jax_search, tmp_path_factory):
    """Run the worker on two gloo ranks once; returns [rank 0's outputs,
    rank 1's]."""
    workdir = tmp_path_factory.mktemp("torch_dist_optimizer")
    init, h0 = _jax_draw_tables(full, jax_search[0].trials)
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump({"X": np.asarray(full.X, np.float32),
                     "batch": full.obs["batch"].to_numpy(dtype=object),
                     "draw_init": init, "draw_transform_h0": h0}, f)
    return run_ranks(WORKER, workdir, WORLD, timeout=150)


def _losses(rows):
    return np.asarray([row[2] for row in rows], np.float64)


def test_topology(ranks):
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    assert [r["topology"] for r in ranks] == [(WORLD, i, "cpu") for i in range(WORLD)]


@pytest.mark.parametrize("search", ["search", "detect"])
def test_trials_identical_on_every_rank(ranks, search):
    rows = [r[search]["trials"] for r in ranks]
    assert len(rows[0]) == {"search": 6, "detect": 5}[search]
    for other in rows[1:]:
        assert [row[:2] + row[3:] for row in other] == [row[:2] + row[3:] for row in rows[0]]
        assert np.array_equal(_losses(other), _losses(rows[0]))


def test_work_is_split(ranks):
    n_ok = sum(row[3] == "ok" for row in ranks[0]["search"]["trials"])
    evals = [r["search"]["evals"] for r in ranks]
    assert sum(evals) == n_ok, (evals, n_ok)
    assert n_ok >= 2 and all(e > 0 for e in evals), evals


def test_best_param_and_refit_identical(ranks):
    assert ranks[1]["search"]["best"] == ranks[0]["search"]["best"]
    refit = [r["search"]["refit_loss"] for r in ranks]
    assert np.isfinite(refit[0]).all() and refit[0].shape[0] == CTOR["max_iter"]
    assert np.array_equal(refit[1], refit[0])


def test_matches_jax_fmin_parallel(ranks, jax_search):
    """Points exactly, losses within atol 1e-6, the same best_param."""
    want = jax_search[0]
    for co in jax_search[1:]:  # the JAX workers agree among themselves
        assert [t["result"]["loss"] for t in co.trials.trials] == \
            [t["result"]["loss"] for t in want.trials.trials]
    got = ranks[0]["search"]["trials"]
    assert [row[0] for row in got] == [t["tid"] for t in want.trials.trials]
    assert [row[1] for row in got] == [t["misc"]["vals"] for t in want.trials.trials]
    assert [row[3] for row in got] == [t["result"]["status"] for t in want.trials.trials]
    np.testing.assert_allclose(_losses(got), [t["result"]["loss"] for t in want.trials.trials],
                               rtol=0, atol=1e-6)
    assert ranks[0]["search"]["best"] == want.best_param


def test_pickle_round_trip_reruns_the_digest(ranks):
    for i, r in enumerate(ranks):
        assert r["pickle"] == {"topology": (WORLD, i, "cpu"), "digests": 1,
                               "mesh": "DeviceMesh", "trials": True}


def test_max_iter_detection_search(ranks):
    """The first trial runs replicated on every rank (the elbow's side
    effects replayed), the rest in parallel rounds: the local evaluations
    exceed a pure split and stay below every rank evaluating everything
    (tests/test_multiprocess.py's bounds)."""
    assert len({r["detect"]["max_iter"] for r in ranks}) == 1
    assert ranks[0]["detect"]["max_iter"] is not None
    n_ok = sum(row[3] == "ok" for row in ranks[0]["detect"]["trials"])
    evals = sum(r["detect"]["evals"] for r in ranks)
    assert n_ok > 0 and n_ok < evals < WORLD * n_ok + WORLD, (evals, n_ok)
    # the frozen max_iter is recorded on every trial after the first
    for row in ranks[0]["detect"]["trials"][1:]:
        if row[3] == "ok":
            assert row[4]["max_iter"] == ranks[0]["detect"]["max_iter"]


def test_shutdown_ends_the_group_threads(ranks):
    """Each rank, whose meshes outlive dist.shutdown() (rank 1's also in the
    traceback of its objective's error), has no thread of the gloo group
    left after it, and so leaves through the interpreter's exit with code 0
    (the fixture holds the exit codes)."""
    assert [r["group_threads"] for r in ranks] == [[]] * WORLD


OPTIMIZER_SRC = ("optimize", "optimizer.py")
TPE_SRC = ("optimize", "tpe.py")
DIST_SRC = ("parallel", "distributed.py")
# per case: (each rank's exception type, a message each rank's error holds
# and where the JAX package raises it, or None where rank 1 raises its own
# objective's error, and whether no trial may have been fit first)
_MISMATCHES = {
    "data_differs": (("ValueError",) * 2, "ComponentOptimizer inputs (adata digest, "
                     "covariate labels, settings)", OPTIMIZER_SRC, True),
    "lam_range_differs": (("ValueError",) * 2, "search state (completed trials, "
                          "max_evals, n_splits, space bounds, loaded trial contents, "
                          "floors, max_iter)", OPTIMIZER_SRC, True),
    "trials_differ": (("ValueError",) * 2, "search state (completed trials, max_evals, "
                      "n_splits, space bounds, loaded trial contents, floors, max_iter)",
                      OPTIMIZER_SRC, True),
    "objective_raises": (("RuntimeError",) * 2, "worker(s) [1] failed during a "
                         "parallel round", TPE_SRC, False),
    "objective_raises_replicated": (("RuntimeError",) * 2, "worker(s) [1] failed "
                                    "during a replicated round", TPE_SRC, False),
}


@pytest.mark.parametrize("name", list(_MISMATCHES))
def test_mismatches_raise_on_every_rank(ranks, name):
    kinds, message, src, before_fit = _MISMATCHES[name]
    got = [r["failures"][name] for r in ranks]
    assert all(g is not None for g in got), got
    assert tuple(g[0] for g in got) == kinds, got
    # the JAX package's text (after the failed ranks its f-string names)
    assert message.split("] ")[-1] in _source(*src), message
    if name.startswith("objective_raises"):
        # rank 0 names the failed rank; rank 1 raises its own error
        assert message in got[0][1], got
        assert got[1][1] == "objective failed on rank 1", got
    else:
        for _, msg in got:
            assert message in msg and "differs across processes" in msg, msg
        assert "differs across processes" in _source(*DIST_SRC)
    if before_fit:
        assert [r["failures"][name + "/evals"] for r in ranks] == [0] * WORLD
    # no rank waited out the group's 30 s timeout, and the group still works
    assert all(r["failures"][name + "/seconds"] < 20.0 for r in ranks)
    assert [r["failures"][name + "/after"] for r in ranks] == [list(range(WORLD))] * WORLD


# ---------------------------------------------------------------------------
# one process: a world of one
# ---------------------------------------------------------------------------


@pytest.fixture
def world_of_one():
    tdist.initialize(f"localhost:{_free_port()}", num_processes=1, process_id=0,
                     timeout=30.0)
    try:
        yield tdist.global_cell_mesh()
    finally:
        tdist.shutdown()


def test_world_of_one_is_the_cpu_search(world_of_one, full):
    """A mesh of one process runs the sequential search on this process's
    device: its trials are the device="cpu" search's bit for bit."""
    runs = []
    for device in ("cpu", world_of_one):
        co = ComponentOptimizer(_port(full), ["batch"], device=device, **CTOR)
        best = co.search_hyperparams(max_evals=4, **SEARCH)
        runs.append((co, best))
    (a, best_a), (b, best_b) = runs
    assert (b._mp_workers, b._mp_rank, b._exec_device) == (1, 0, torch.device("cpu"))
    assert best_a == best_b
    assert [(t["tid"], t["misc"]["vals"], t["result"]) for t in a.trials.trials] == \
        [(t["tid"], t["misc"]["vals"], t["result"]) for t in b.trials.trials]
    back = pickle.loads(pickle.dumps(b))
    assert type(back.device).__name__ == "DeviceMesh" and back._mp_workers == 1


def test_mesh_refusals(world_of_one, full, monkeypatch):
    from torch.distributed.device_mesh import init_device_mesh

    # a ("genes", "cells") grid, which the JAX package refuses over
    # processes, builds and searches (tests/test_torch_optimizer_grid.py
    # holds a 2 x 2 grid's search)
    grid = init_device_mesh("cpu", (1, 1), mesh_dim_names=("genes", "cells"))
    co = ComponentOptimizer(_port(full), ["batch"], **CTOR, device=grid)
    assert co._grid is not None and co._exec_device is grid
    best = co.search_hyperparams(max_evals=2, **SEARCH)
    assert best and all(np.isfinite(t["result"]["loss"]) for t in co.trials.trials
                        if t["result"]["status"] == "ok")
    # a mesh of fewer processes than the group: the exchange is global
    monkeypatch.setattr(tdist, "process_count", lambda: 2)
    with pytest.raises(ValueError) as e:
        ComponentOptimizer(_port(full), ["batch"], device=world_of_one, **CTOR)
    want = "a multi-process search mesh must span every process"
    assert str(e.value).startswith(want + " (mesh has 1 of 2 processes)")
    assert want in _source(*OPTIMIZER_SRC)

"""ComponentOptimizer on the ("genes", "cells") grid of processes, on the
CPU: four gloo ranks (tests/torch_dist_optimizer_grid_worker.py, spawned
once for the module) form a 2 × 2 grid, each holding the full data, and
the parent holds what they wrote against the JAX package's search on
``make_gene_cell_mesh(2, 2)`` (its single-process 2-D mesh), against the
port's ``device="cpu"`` search and against each other.

The scenario is tests/test_torch_optimizer_distributed.py's: 96 cells ×
32 genes (``make_synthetic_adata(seed=2)``), ``["batch"]``,
``random_state=0``, float32, ranges (8, 16) and (1, 100), ``n_splits=2``,
4 evaluations a search:

- ``batched``: ``max_iter=6``, each fold fit whole on the card of its
  owner (fold f on rank f mod 4), the scores exchanged;
- ``detect``: ``max_iter=None`` with ``fold_batching=False``: every fold
  a grid fit (each rank its cell column's cells of the fold, every gene),
  the validation embedding gathered for the fold's scorer, the elbow the
  coordinator's;
- ``weighted_fast``, ``als_minibatch`` (``use_als=True``, batches of 24)
  and ``tiled`` (batches of 24): batched folds of those modes.

The ranks draw the searches' inits, validation H0 and the folds' count,
cell and tile streams from the JAX package's streams, passed in as tables
made here.  Against the JAX package: points equal, losses within atol
1e-6, the same ``best_param`` and frozen ``max_iter``.  The batched
searches' trials are the port's ``device="cpu"`` search's bit for bit
(from the same tables).  Trials, ``best_param`` and the refit's W and
losses are bit-equal on the four ranks.  The refit (a grid fit of the
full data, from the port's own draws) is held against the port's
single-process CPU refit at the grid estimator's tolerances (loss rtol
1e-4, embedding rtol 5e-3 atol 1e-5; tests/test_torch_gene_cell_mesh.py).
A gene count that the gene axis does not divide raises in the constructor
on every rank, a tiled search under ``max_iter=None`` raises the JAX
package's refusal at its first sequential fold fit, and a pickled
optimizer rebuilds its grid.
"""

import pickle
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alpine_tpu_torch.optimize.batched as tbatched
from alpine_tpu import ComponentOptimizer as JaxCO
from alpine_tpu.ops import mu as jmu
from alpine_tpu.parallel.mesh import make_gene_cell_mesh
from alpine_tpu.utils.encoder import FeatureEncoders
from alpine_tpu_torch import ALPINE, AnnData, ComponentOptimizer

from .conftest import make_synthetic_adata
from .test_torch_minibatch import _jax_cells
from .test_torch_model import jax_fit_key
from .test_torch_tiled import _jax_tiles
from .torch_ranks import run_ranks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_dist_optimizer_grid_worker.py"
WORLD, GRID = 4, (2, 2)
COORDS = [(r // GRID[1], r % GRID[1]) for r in range(WORLD)]
CTOR = dict(random_state=0, data_dtype="float32")
SEARCH = dict(n_total_components_range=(8, 16), lam_range=(1.0, 100.0), n_splits=2)
MAX_EVALS = 4
EPS = 1e-6
CASES = {
    "batched": dict(max_iter=6),
    "detect": dict(max_iter=None, fold_batching=False),
    "weighted_fast": dict(max_iter=6, sampling_method="weighted_fast"),
    "als_minibatch": dict(max_iter=6, use_als=True, batch_size=24),
    "tiled": dict(max_iter=6, sampling_method="tiled", batch_size=24),
}
BATCHED = [name for name, kw in CASES.items() if kw["max_iter"] is not None]
_MAX_DRAWS = 256  # split(key, T)[t] does not depend on T


def _port(ad):
    return AnnData(np.asarray(ad.X), obs={"batch": ad.obs["batch"].to_numpy(dtype=object)})


@pytest.fixture(scope="module")
def full():
    return make_synthetic_adata(n_cells=96, n_genes=32, seed=2)


@pytest.fixture(scope="module")
def jax_searches(full):
    """The JAX package's searches on its 2 × 2 mesh: {case: optimizer}, and
    what its tiled search under max_iter=None raises."""
    mesh = make_gene_cell_mesh(*GRID, devices=jax.devices()[:WORLD])
    out = {}
    for name, kw in CASES.items():
        co = JaxCO(full, ["batch"], device=mesh, **CTOR, **kw)
        co.search_hyperparams(max_evals=MAX_EVALS, **SEARCH)
        out[name] = co
    co = JaxCO(full, ["batch"], device=mesh, max_iter=None, sampling_method="tiled",
               batch_size=24, **CTOR)
    with pytest.raises(ValueError) as e:
        co.search_hyperparams(max_evals=2, **SEARCH)
    out["tiled_refusal"] = str(e.value)
    return out


def _tables(ad, jax_searches):
    """The JAX package's draws, keyed as the port's draws are called: the
    init and validation H0 of every successful trial's block shape (batched
    folds at the stack's widths, sequential folds at their own), and the
    batched folds' count, cell and tile streams."""
    co = ComponentOptimizer(_port(ad), ["batch"], device="cpu", max_iter=6, **CTOR)
    co.n_splits = SEARCH["n_splits"]
    folds = co._stratified_folds()
    n_tr = max(len(tr) for tr, _ in folds)
    n_va = max(len(va) for _, va in folds)
    n_labels = (len(set(ad.obs["batch"])),)
    seed, g = CTOR["random_state"], ad.X.shape[1]
    n_tiles = -(-n_tr // jmu.DEFAULT_TILE)  # the tiled folds' width in tiles
    init_key, _ = jax.random.split(jax.random.PRNGKey(seed))
    t_key = jmu.transform_key(jax.random.PRNGKey(seed))
    init, h0 = {}, {}
    for jco in jax_searches.values():
        if isinstance(jco, str):
            continue
        for t in jco.trials.trials:
            if t["result"]["status"] != "ok":
                continue
            p = t["result"]["params"]
            true = tuple(p["n_covariate_components"]) + (p["n_components"],)
            blocks = co._bucketed(true) or true
            for n in {n_tr, n_tiles * jmu.DEFAULT_TILE} | {len(tr) for tr, _ in folds}:
                jcfg = jmu.MUConfig(blocks=blocks, n_labels=n_labels, n_cells=n)
                W0, H0, Bs0 = jmu.init_matrices(jcfg, g, init_key, EPS)
                init[(blocks, n_labels, n, g, seed)] = (
                    np.array(W0), np.array(H0), [np.array(b) for b in Bs0])
            for k, n in {(sum(blocks), n_va)} | {(sum(true), len(va)) for _, va in folds}:
                h0[(k, n, seed)] = np.array(jnp.maximum(
                    jax.random.uniform(t_key, (k, n), dtype=jnp.float32), EPS))
    fit_key = jax_fit_key(seed)
    epochs = range(CASES["batched"]["max_iter"] + 1)  # a draw ahead
    Ys = FeatureEncoders(["batch"]).fit_transform(ad.obs)
    fd = tbatched.prepare_fold_data(np.asarray(ad.X), Ys, folds, weighted=True,
                                    device="cpu")
    keys = jax.random.split(fit_key, _MAX_DRAWS)
    counts = {}
    for w in fd.weights:
        w = w.numpy()
        for t in epochs:
            counts[(zlib.crc32(w.tobytes()), fd.n_tr, t)] = np.array(
                jmu.multinomial_counts(keys[t], fd.n_tr, jnp.asarray(w), fd.n_tr))
    return {"init": init, "h0": h0, "counts": counts,
            "cells": {(n_tr, t): _jax_cells(fit_key, t, n_tr) for t in epochs},
            "tiles": {(n_tiles, t): _jax_tiles(fit_key, t, n_tiles) for t in epochs}}


@pytest.fixture(scope="module")
def tables(full, jax_searches):
    return _tables(full, jax_searches)


@pytest.fixture(scope="module")
def ranks(full, tables, tmp_path_factory):
    """Run the worker on four gloo ranks once; returns their outputs in
    rank order."""
    workdir = tmp_path_factory.mktemp("torch_dist_optimizer_grid")
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump({"X": np.asarray(full.X, np.float32),
                     "batch": full.obs["batch"].to_numpy(dtype=object),
                     "cases": CASES, "max_evals": MAX_EVALS, "tables": tables}, f)
    return run_ranks(WORKER, workdir, WORLD, timeout=300)


@pytest.fixture(scope="module")
def cpu_searches(full, tables):
    """The port's device="cpu" searches of the batched cases, from the same
    tables as the ranks."""
    from .torch_dist_optimizer_grid_worker import JaxDraws

    out = {}
    with JaxDraws(tables):
        for name in BATCHED:
            co = ComponentOptimizer(_port(full), ["batch"], device="cpu", **CTOR,
                                    **CASES[name])
            co.search_hyperparams(max_evals=MAX_EVALS, **SEARCH)
            out[name] = co
    return out


def _losses(rows):
    return np.asarray([row[2] for row in rows], np.float64)


def _ok(rows):
    return [row for row in rows if row[3] == "ok"]


def test_topology(ranks):
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    for r, res in enumerate(ranks):
        for name in CASES:
            assert res[name]["topology"] == (WORLD, r, "cpu", "DeviceMesh")


@pytest.mark.parametrize("name", list(CASES))
def test_trials_identical_on_every_rank(ranks, name):
    rows = [r[name]["trials"] for r in ranks]
    assert len(rows[0]) == MAX_EVALS and _ok(rows[0])
    for res in ranks[1:]:
        other = res[name]["trials"]
        assert [row[:2] + row[3:] for row in other] == [row[:2] + row[3:] for row in rows[0]]
        assert np.array_equal(_losses(other), _losses(rows[0]))
        assert res[name]["best"] == ranks[0][name]["best"]
        assert res[name]["max_iter"] == ranks[0][name]["max_iter"]


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_2d_mesh_search(ranks, jax_searches, name):
    """Points exactly, losses within atol 1e-6, the same best_param and
    max_iter as the JAX package's search on its 2 × 2 mesh."""
    want = jax_searches[name]
    got = ranks[0][name]["trials"]
    assert [row[0] for row in got] == [t["tid"] for t in want.trials.trials]
    assert [row[1] for row in got] == [t["misc"]["vals"] for t in want.trials.trials]
    assert [row[3] for row in got] == [t["result"]["status"] for t in want.trials.trials]
    np.testing.assert_allclose(_losses(got), [t["result"]["loss"] for t in want.trials.trials],
                               rtol=0, atol=1e-6)
    assert ranks[0][name]["best"] == want.best_param
    assert ranks[0][name]["max_iter"] == want.max_iter
    if name == "detect":
        assert want.max_iter == 98  # frozen from the first trial's elbows


@pytest.mark.parametrize("name", BATCHED)
def test_batched_trials_are_the_cpu_search(ranks, cpu_searches, name):
    """Each fold fit whole on its owner's device, at the stack's widths:
    the trials are the single-device batched search's bit for bit."""
    want = cpu_searches[name]
    got = ranks[0][name]["trials"]
    assert [row[1] for row in got] == [t["misc"]["vals"] for t in want.trials.trials]
    assert np.array_equal(_losses(got), [t["result"].get("loss", np.inf)
                                         for t in want.trials.trials])
    assert [row[4] for row in got] == [t["result"].get("params") for t in want.trials.trials]


@pytest.mark.parametrize("name", list(CASES))
def test_folds_and_exchanges(ranks, name):
    """Batched: fold f fit on rank f mod 4 only, once a trial; sequential:
    no batched fit, one embedding gather a fold.  One score exchange a
    successful trial, of one float a fold (and a failure flag) a rank."""
    n_ok = len(_ok(ranks[0][name]["trials"]))
    n_splits = SEARCH["n_splits"]
    for r, res in enumerate(ranks):
        mine = [f for f in range(n_splits) if f % WORLD == r]
        coll = res[name]["collectives"]
        assert coll["fold scores"]["calls"] == n_ok
        assert coll["fold scores"]["bytes"] == n_ok * WORLD * (n_splits + 1) * 8
        if name in BATCHED:
            assert res[name]["fitted"] == mine * n_ok
            assert "embedding gather" not in coll
        else:
            assert res[name]["fitted"] == []
            assert coll["embedding gather"]["calls"] == n_ok * n_splits


def test_refit_bit_equal_on_every_rank(ranks):
    for res in ranks[1:]:
        assert np.array_equal(res["refit"]["W"], ranks[0]["refit"]["W"])
        assert np.array_equal(res["refit"]["loss"], ranks[0]["refit"]["loss"])
    for r, res in enumerate(ranks):  # within a cell column, the same H
        assert np.array_equal(res["refit"]["H"], ranks[COORDS[r][1]]["refit"]["H"])
        assert res["refit"]["adata_obsm"] == []  # the refit's cells are a copy


def test_refit_matches_the_single_process_refit(ranks, full):
    """The grid refit against the port's CPU fit of the same parameters on
    the full data, both from the port's own draws."""
    best = ranks[0]["batched"]["best"]
    model = ALPINE(device="cpu", data_dtype="float32", **best)
    model.fit(_port(full), ["batch"], max_iter=CASES["batched"]["max_iter"])
    np.testing.assert_allclose(ranks[0]["refit"]["loss"], model.loss_history_, rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["refit"]["W"],
                               np.concatenate(model.matrices["Ws"], axis=1),
                               rtol=5e-3, atol=1e-5)
    H = np.concatenate(model.matrices["Hs"], axis=0)
    for r in range(GRID[1]):  # gene row 0's ranks: one each cell column
        lo, hi = ranks[r]["refit"]["cells"]
        np.testing.assert_allclose(ranks[r]["refit"]["H"], H[:, lo:hi],
                                   rtol=5e-3, atol=1e-5)


def test_pickle_round_trip_rebuilds_the_grid(ranks):
    for r, res in enumerate(ranks):
        assert res["pickle"] == {"topology": (WORLD, r, "cpu", "DeviceMesh", True),
                                 "trials": True}


def test_gene_count_indivisible_raises_in_the_constructor(ranks):
    from alpine_tpu.parallel.mesh import Placement as JPlacement

    with pytest.raises(ValueError) as want:
        JPlacement(make_gene_cell_mesh(*GRID, devices=jax.devices()[:WORLD])
                   ).check_gene_axis(31)
    for res in ranks:
        assert res["failures"]["genes_indivisible"] == ("ValueError", str(want.value))
        assert res["failures"]["genes_indivisible/after"] == list(range(WORLD))


def test_tiled_sequential_fold_refused_as_jax(ranks, jax_searches):
    for res in ranks:
        assert res["failures"]["tiled_sequential"] == ("ValueError",
                                                       jax_searches["tiled_refusal"])
        assert res["failures"]["tiled_sequential/after"] == list(range(WORLD))


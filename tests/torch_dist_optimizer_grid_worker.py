"""One rank of tests/test_torch_optimizer_grid.py: joins a gloo process
group of four on the CPU as one cell of a 2 × 2 ("genes", "cells") grid,
runs ComponentOptimizer searches over the grid on the full data of
``inputs.pkl`` (every rank passes all of it) and writes ``rank<i>.pkl``:
each search's trials, best parameters and frozen ``max_iter``, the folds
this rank fit on its own card, the host collectives it made, the refit of
the first search, a pickle round trip, and the type and message of what
each refusal raised.

    python tests/torch_dist_optimizer_grid_worker.py PORT RANK WORLD WORKDIR

Imports neither JAX nor the JAX package: the searches' draws come from
the tables in ``inputs.pkl`` (the JAX package's draws, made by the
parent); the refit takes the port's own draws.  The process group's
timeout is short, so a rank left waiting in a collective raises instead
of hanging.
"""

import os
import pickle
import sys
import traceback
import zlib

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import alpine_tpu_torch.models.alpine as talpine  # noqa: E402
import alpine_tpu_torch.optimize.batched as batched  # noqa: E402
from alpine_tpu_torch import AnnData, ComponentOptimizer  # noqa: E402
from alpine_tpu_torch.convert import state_from_numpy  # noqa: E402
from alpine_tpu_torch.parallel import distributed as dist  # noqa: E402

KEYS = ["batch"]
CTOR = dict(random_state=0, data_dtype="float32")
SEARCH = dict(n_total_components_range=(8, 16), lam_range=(1.0, 100.0), n_splits=2)
GRID = (2, 2)


def trial_rows(trials):
    return [(t["tid"], t["misc"]["vals"], t["result"].get("loss", np.inf),
             t["result"]["status"], t["result"].get("params"))
            for t in trials.trials]


class JaxDraws:
    """The searches' draws replaced by the JAX package's (the tables of
    ``inputs.pkl``): the folds' init and validation H0 in the batched
    route and in the estimator, and the batched folds' count, cell and
    tile streams."""

    def __init__(self, tables):
        t = tables

        def draw_init(cfg, n_genes, random_state, eps, device):
            W0, H0, Bs0 = t["init"][(tuple(cfg.blocks), tuple(cfg.n_labels),
                                     cfg.n_cells, n_genes, random_state)]
            return state_from_numpy(W0, H0, Bs0, device)

        def draw_transform_h0(n_components, n_cells, random_state, eps, device):
            return torch.from_numpy(t["h0"][(n_components, n_cells, random_state)]).to(device)

        def draw_counts_stream(weights, n, random_state):
            key = zlib.crc32(weights.cpu().numpy().tobytes())
            return lambda it: torch.from_numpy(t["counts"][(key, n, it)])

        def draw_cells_stream(n_cells, random_state, device, probs=None):
            return lambda it: torch.from_numpy(t["cells"][(n_cells, it)])

        def draw_tiles_stream(n_tiles, random_state, device):
            return lambda it: torch.from_numpy(t["tiles"][(n_tiles, it)])

        self.patches = [(batched, name, fn) for name, fn in (
            ("draw_init", draw_init), ("draw_transform_h0", draw_transform_h0),
            ("draw_counts_stream", draw_counts_stream),
            ("draw_cells_stream", draw_cells_stream),
            ("draw_tiles_stream", draw_tiles_stream))]
        self.patches += [(talpine, "draw_init", draw_init),
                         (talpine, "draw_transform_h0", draw_transform_h0)]

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.patches]
        for module, name, fn in self.patches:
            setattr(module, name, fn)

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def main():
    port, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    dist.initialize(coordinator_address=f"localhost:{port}",
                    num_processes=world, process_id=rank, timeout=30.0)
    mesh = dist.global_gene_cell_mesh(*GRID)
    X, labels = inputs["X"], inputs["batch"]

    def adata(X_=X):
        return AnnData(np.array(X_), obs={"batch": labels.copy()})

    out = {"rank": dist.process_index()}
    # the folds this rank fit on its own card (batched route)
    fitted = []
    fit_fold = batched.fit_fold

    def counted_fit_fold(fd, f, *args, **kw):
        fitted.append(f)
        return fit_fold(fd, f, *args, **kw)

    batched.fit_fold = counted_fit_fold
    for name, kw in inputs["cases"].items():
        del fitted[:]
        with JaxDraws(inputs["tables"]):
            co = ComponentOptimizer(adata(), KEYS, device=mesh, **CTOR, **kw)
            dist.reset_collectives()
            best = co.search_hyperparams(max_evals=inputs["max_evals"], **SEARCH)
        out[name] = {"trials": trial_rows(co.trials), "best": best, "max_iter": co.max_iter,
                     "fitted": list(fitted), "collectives": dist.collective_summary(),
                     "topology": (co._mp_workers, co._mp_rank, str(co._local_device),
                                  type(co._exec_device).__name__)}
        if name == "batched":
            # the refit on the grid, from the port's own draws
            model = co.fit_the_best_param()
            out["refit"] = {"loss": model.loss_history_.copy(),
                            "W": np.concatenate(model.matrices["Ws"], axis=1),
                            "H": np.concatenate(model.matrices["Hs"], axis=0),
                            "cells": dist.mesh_cell_range(mesh, X.shape[0]),
                            "adata_obsm": sorted(co.adata.obsm)}
            back = pickle.loads(pickle.dumps(co))
            out["pickle"] = {"topology": (back._mp_workers, back._mp_rank,
                                          str(back._local_device),
                                          type(back._exec_device).__name__,
                                          back._grid is not None),
                             "trials": trial_rows(back.trials) == trial_rows(co.trials)}
    batched.fit_fold = fit_fold

    failures = {}

    def attempt(name, fn):
        try:
            fn()
            failures[name] = None
        except Exception as e:  # noqa: BLE001 (recorded for the parent)
            failures[name] = (type(e).__name__, str(e))
        # the group still works after the refusal
        failures[name + "/after"] = dist.process_allgather_rows([rank]).ravel().tolist()

    attempt("genes_indivisible", lambda: ComponentOptimizer(
        adata(X[:, :-1]), KEYS, device=mesh, max_iter=6, **CTOR))
    attempt("tiled_sequential", lambda: ComponentOptimizer(
        adata(), KEYS, device=mesh, max_iter=None, sampling_method="tiled",
        batch_size=24, **CTOR).search_hyperparams(max_evals=2, **SEARCH))
    out["failures"] = failures
    dist.shutdown()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)

"""One rank of tests/test_torch_optimizer_distributed.py: joins a gloo
process group on the CPU, runs ComponentOptimizer searches over the cell
mesh on the full data of ``inputs.pkl`` and writes ``rank<i>.pkl`` (the
trials, the work this rank did, and the type and message of what each
mismatch case raised).

    python tests/torch_dist_optimizer_worker.py PORT RANK WORLD WORKDIR

Imports neither JAX nor the JAX package: the main search's fold draws come
from the tables in ``inputs.pkl`` (the JAX package's draws, made by the
parent).  The process group's timeout is short, so a rank left waiting in
a collective raises instead of hanging.  After ``dist.shutdown()`` the
rank records the threads of the process group still running while its
meshes are still referenced (on rank 1 also by the traceback of the
objective's error), then leaves through the interpreter's normal exit.
"""

import copy
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import alpine_tpu_torch.optimize.batched as batched  # noqa: E402
from alpine_tpu_torch import AnnData, ComponentOptimizer  # noqa: E402
from alpine_tpu_torch.convert import state_from_numpy  # noqa: E402
from alpine_tpu_torch.parallel import distributed as dist  # noqa: E402
from tests.torch_ranks import group_threads  # noqa: E402

KEYS = ["batch"]
CTOR = dict(max_iter=6, random_state=0, data_dtype="float32")
SEARCH = dict(n_total_components_range=(8, 16), lam_range=(1.0, 100.0), n_splits=2)


class Counter:
    """Counts calls of a ComponentOptimizer method on this rank (patched on
    the class, so every optimizer of the worker is counted)."""

    def __init__(self, name, fail=None):
        self.name, self.calls, self.fail = name, 0, fail
        self.orig = getattr(ComponentOptimizer, name)

    def __enter__(self):
        counter = self

        def counted(opt, *args, **kw):
            counter.calls += 1
            if counter.fail is not None:
                raise counter.fail
            return counter.orig(opt, *args, **kw)

        setattr(ComponentOptimizer, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(ComponentOptimizer, self.name, self.orig)


def trial_rows(trials):
    return [(t["tid"], t["misc"]["vals"], t["result"].get("loss", np.inf),
             t["result"]["status"], t["result"].get("params"))
            for t in trials.trials]


def main():
    port, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    dist.initialize(coordinator_address=f"localhost:{port}",
                    num_processes=world, process_id=rank, timeout=30.0)
    mesh = dist.global_cell_mesh()
    X, labels = inputs["X"], inputs["batch"]

    def adata(X_=X):
        return AnnData(np.array(X_), obs={"batch": labels.copy()})

    out = {"rank": dist.process_index()}

    # the main search, from the JAX package's fold draws
    init, h0 = inputs["draw_init"], inputs["draw_transform_h0"]

    def draw_init(cfg, n_genes, random_state, eps, device):
        W0, H0, Bs0 = init[(tuple(cfg.blocks), tuple(cfg.n_labels), cfg.n_cells,
                            n_genes, random_state)]
        return state_from_numpy(W0, H0, Bs0, device)

    def draw_transform_h0(n_components, n_cells, random_state, eps, device):
        return torch.from_numpy(h0[(n_components, n_cells, random_state)]).to(device)

    own_draws = batched.draw_init, batched.draw_transform_h0
    batched.draw_init, batched.draw_transform_h0 = draw_init, draw_transform_h0
    try:
        opt = ComponentOptimizer(adata(), KEYS, device=mesh, **CTOR)
        out["topology"] = (opt._mp_workers, opt._mp_rank, str(opt._exec_device))
        with Counter("calc_score") as evals:
            best = opt.search_hyperparams(max_evals=6, **SEARCH)
    finally:
        batched.draw_init, batched.draw_transform_h0 = own_draws
    model = opt.fit_the_best_param()
    out["search"] = {"best": best, "trials": trial_rows(opt.trials),
                     "evals": evals.calls, "refit_loss": model.loss_history_.copy()}

    # a pickle round trip: the topology rebuilt, the inputs' digest re-run
    with Counter("_assert_consistent_across_processes") as digests:
        back = pickle.loads(pickle.dumps(opt))
    out["pickle"] = {"topology": (back._mp_workers, back._mp_rank, str(back._exec_device)),
                     "digests": digests.calls, "mesh": type(back.device).__name__,
                     "trials": trial_rows(back.trials) == trial_rows(opt.trials)}

    # max_iter detection: replicated rounds until max_iter is frozen
    det = ComponentOptimizer(adata(), KEYS, device=mesh,
                             **dict(CTOR, max_iter=None, random_state=1))
    with Counter("calc_score") as det_evals:
        det.search_hyperparams(max_evals=5, **SEARCH)
    out["detect"] = {"trials": trial_rows(det.trials), "max_iter": det.max_iter,
                     "evals": det_evals.calls}

    # mismatches: each must raise on every rank, in step, before a fit
    failures = {}

    def attempt(name, fn, fail=None):
        t0 = time.perf_counter()
        with Counter("calc_score", fail=fail) as calls:
            try:
                fn()
                failures[name] = None
            except Exception as e:  # noqa: BLE001 (recorded for the parent)
                failures[name] = (type(e).__name__, str(e))
        failures[name + "/evals"] = calls.calls
        failures[name + "/seconds"] = time.perf_counter() - t0
        # the group still works after the refusal
        failures[name + "/after"] = dist.process_allgather_rows([rank]).ravel().tolist()

    X1 = X.copy()
    if rank == 1:
        X1[5, 3] += 1.0  # one cell differs
    attempt("data_differs", lambda: ComponentOptimizer(adata(X1), KEYS, device=mesh, **CTOR))

    def search(opt_, **kw):
        opt_.search_hyperparams(**{**SEARCH, "max_evals": 2, **kw})

    attempt("lam_range_differs", lambda: search(
        ComponentOptimizer(adata(), KEYS, device=mesh, **CTOR),
        lam_range=(1.0, 100.0 if rank == 0 else 50.0)))

    mine = copy.deepcopy(opt.trials)
    if rank == 1:
        mine.trials[2]["result"]["loss"] += 1e-3
    path = os.path.join(workdir, f"trials{rank}.pkl")
    with open(path, "wb") as f:
        pickle.dump(mine, f)
    attempt("trials_differ", lambda: search(
        ComponentOptimizer(adata(), KEYS, device=mesh, **CTOR), trials_filename=path))

    boom = RuntimeError("objective failed on rank 1")
    attempt("objective_raises", lambda: search(
        ComponentOptimizer(adata(), KEYS, device=mesh, **CTOR)),
        fail=boom if rank == 1 else None)
    attempt("objective_raises_replicated", lambda: search(
        ComponentOptimizer(adata(), KEYS, device=mesh, **dict(CTOR, max_iter=None))),
        fail=boom if rank == 1 else None)
    out["failures"] = failures
    dist.shutdown()
    # the gloo group's threads (worker loops, transport, store) left running
    out["group_threads"] = group_threads()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)

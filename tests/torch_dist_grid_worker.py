"""One rank of tests/test_torch_gene_cell_mesh.py: joins a gloo process
group of four on the CPU as one cell of a 2 × 2 ("genes", "cells") grid,
runs every case of ``inputs.pkl`` on its block (its gene rows of its
cells), then the checkpointed fits (snapshots a rank in shared
directories, beside a 1-D mesh's and a 2 × 1 grid's) and a ``max_iter=None``
fit whose elbow this rank alone may move, and writes ``rank<i>.pkl``
(outputs, or the type and message of what a case raised).

    python tests/torch_dist_grid_worker.py PORT RANK WORLD WORKDIR

Imports neither JAX nor the JAX package.  The process group's timeout is
short, so a rank left waiting in a collective raises instead of hanging.
"""

import os
import pickle
import shutil
import sys
import traceback
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from alpine_tpu_torch import ALPINE, AnnData, ComponentOptimizer  # noqa: E402
from alpine_tpu_torch.io.checkpoint import FitCheckpointer  # noqa: E402
from alpine_tpu_torch.ops import kernels, mu  # noqa: E402
from alpine_tpu_torch.parallel import distributed as dist  # noqa: E402
from alpine_tpu_torch.parallel.mesh import Placement  # noqa: E402

KEYS = ["batch", "condition"]
KW = dict(n_components=6, n_covariate_components=[2, 3], lam=[1.0, 2.0],
          random_state=0)
GRID = (2, 2)


def local_adata(case, lo, hi):
    """Rows lo:hi (cells) of a case's (cells × genes) data, every gene."""
    return AnnData(np.array(case["X"][lo:hi]),
                   obs={k: case["obs"][k][lo:hi] for k in KEYS})


def obsm_blocks(adata):
    return np.concatenate([adata.obsm[k] for k in KEYS]
                          + [adata.obsm["ALPINE_embedding"]], axis=1)


def fit_outputs(model, adata):
    return {"loss": model.loss_history_.copy(),
            "W": np.concatenate(model.matrices["Ws"], axis=1),
            "H": np.concatenate(model.matrices["Hs"], axis=0),
            "Bs": [b.copy() for b in model.matrices["Bs"]],
            "emb": np.asarray(adata.obsm["ALPINE_embedding"]).copy()}


class TwoByOne:
    """The fields of a 2 × 1 grid's DeviceMesh that ``Placement`` reads,
    at this rank's gene block."""
    ndim = 2
    shape = (2, 1)

    def __init__(self, gene_index):
        self.gene_index = gene_index

    def get_coordinate(self):
        return [self.gene_index, 0]

    def size(self):
        return 2


def main():
    port, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    dist.initialize(coordinator_address=f"localhost:{port}",
                    num_processes=world, process_id=rank, timeout=30.0)
    out, failures = {}, {}

    def attempt(name, fn):
        try:
            fn()
            failures[name] = None
        except Exception as e:  # noqa: BLE001 (recorded for the parent)
            failures[name] = (type(e).__name__, str(e))

    # grids that do not span the group raise before any collective
    attempt("grid_too_big", lambda: dist.global_gene_cell_mesh(2, 3))
    attempt("grid_too_small", lambda: dist.global_gene_cell_mesh(1, 2))
    mesh = dist.global_gene_cell_mesh(*GRID)
    place = Placement(mesh)
    group, gene_group = place.group, place.gene_group
    tdist = torch.distributed
    out["place"] = {
        "coord": (place.gene_index, place.process_chunk_index),
        "shards": (place.gene_shards, place.cell_shards, place.n_processes),
        "group_ranks": sorted(tdist.get_process_group_ranks(group)),
        "gene_group_ranks": sorted(tdist.get_process_group_ranks(gene_group)),
        "gene_range": place.gene_range(32),
        "cell_range": dist.mesh_cell_range(mesh, 61),
    }
    t = torch.from_numpy

    def ops_fit(case, f64, backend=None):
        """The grid's loop on this rank's block of a case; a minibatch
        case's epochs take its global permutations."""
        g0, g1 = place.gene_range(case["X"].shape[0])
        lo, hi = dist.mesh_cell_range(mesh, case["X"].shape[1])
        cfg = mu.MUConfig(**{**case["cfg"], **({"backend": backend} if backend else {})})
        args = (cfg, t(case["W0"][g0:g1]).contiguous(),
                t(case["H0"][:, lo:hi]).contiguous(),
                tuple(t(b) for b in case["Bs0"]),
                t(case["X"][g0:g1, lo:hi]).contiguous(),
                [t(y[:, lo:hi]).contiguous() for y in case["Ys"]],
                (t(case["lam"]), *case["hyper"]))
        draw = cells = cell_range = None
        if "counts" in case:
            draw = lambda it: t(case["counts"][it, lo:hi])  # noqa: E731
        if "perms" in case:
            cells = lambda it: t(case["perms"][it])  # noqa: E731
            cell_range = (lo, hi)
        dist.reset_collectives()
        if f64:
            # past fit_scan's cast of X to a storage dtype
            W, H, Bs, L = mu._fit_scan_steps(*args, draw, cells, None, group,
                                             hi - lo, gene_group, cell_range)
        elif draw is None and cells is None:
            W, H, Bs, L = mu.fit_scan_sharded(cfg, mesh, *args[1:])
        else:
            W, H, Bs, L = mu.fit_scan(*args, draw_counts=draw, draw_cells=cells,
                                      group=group, gene_group=gene_group,
                                      cell_range=cell_range)
        return {"W": W.numpy(), "H": H.numpy(), "Bs": [b.numpy() for b in Bs],
                "L": L.numpy(), "collectives": dist.collective_summary()}

    for name, case in inputs["f64"].items():
        out[f"f64_{name}"] = ops_fit(case, True)
    for name, case in inputs["jax_fit"].items():
        out[f"jax_{name}"] = ops_fit(case, False)
    for name, case in inputs["payload"].items():
        out[f"payload_{name}"] = ops_fit(case, False)["collectives"]
    # the kernel wrappers' calls in a fused float32 minibatch fit whose
    # first batch holds no cell of column 1: (kind, cells) a call
    calls, real_passes = [], (kernels.hxt, kernels.wtx)
    kernels.hxt = lambda X, H: calls.append(("hxt", X.shape[1])) or real_passes[0](X, H)
    kernels.wtx = lambda X, W: calls.append(("wtx", X.shape[1])) or real_passes[1](X, W)
    case = inputs["f64"]["mb_empty"]
    f32 = {**case, **{k: np.asarray(case[k], np.float32) for k in ("X", "W0", "H0", "lam")},
           "Bs0": [np.asarray(b, np.float32) for b in case["Bs0"]],
           "Ys": [np.asarray(y, np.float32) for y in case["Ys"]]}
    try:
        fused = ops_fit(f32, False, backend="fused")
    finally:
        kernels.hxt, kernels.wtx = real_passes
    out["mb_empty_fused"] = {"calls": calls, "collectives": fused["collectives"],
                             "L": fused["L"]}
    for name, case in inputs["jax_transform"].items():
        g0, g1 = place.gene_range(case["X"].shape[0])
        lo, hi = dist.mesh_cell_range(mesh, case["X"].shape[1])
        dist.reset_collectives()
        H = mu.run_transform(t(case["W"][g0:g1]).contiguous(),
                             t(case["X"][g0:g1, lo:hi]).contiguous(),
                             t(case["H0"][:, lo:hi]).contiguous(), case["eps"],
                             n_iter=case["n_iter"],
                             reduce=mu.reducer(gene_group, "genes transform"))
        out[f"jax_{name}"] = {"H": H.numpy(), "collectives": dist.collective_summary()}

    # the estimator: each rank passes its column's cells with every gene
    models = {}
    for name, case in inputs["estimator"].items():
        lo, hi = dist.mesh_cell_range(mesh, case["X"].shape[0])
        ad = local_adata(case, lo, hi)
        model = ALPINE(device=mesh, data_dtype=case["data_dtype"],
                       **{**KW, **case["model_kw"]})
        dist.reset_collectives()
        model.fit(ad, KEYS, max_iter=case["max_iter"], **case["fit_kw"])
        out[f"est_{name}"] = {
            "loss": model.loss_history_.copy(),
            "W": np.concatenate(model.matrices["Ws"], axis=1),
            "H": np.concatenate(model.matrices["Hs"], axis=0),
            "Bs": [b.copy() for b in model.matrices["Bs"]],
            "emb": np.asarray(ad.obsm["ALPINE_embedding"]).copy(),
            "data_dtype": model.data_dtype_,
            "collectives": dist.collective_summary(),
            "timings": dict(model.timings_)}
        models[name] = (model, ad)
    model, ad = models["96"]
    dist.reset_collectives()
    model.transform(ad, n_iter=7)  # the fit's data: through the device-X cache
    out["tr_96"] = {"H": obsm_blocks(ad), "cache": model._x_cache is not None,
                    "collectives": dist.collective_summary()}
    model, ad = models["wf"]
    model.transform(ad, n_iter=7)  # the fit's group-sorted device X
    out["tr_wf"] = {"H": obsm_blocks(ad)}
    model = models["96"][0]
    fresh = inputs["fresh"]
    lo, hi = dist.mesh_cell_range(mesh, fresh["X"].shape[0])
    ad61 = local_adata(fresh, lo, hi)
    model.transform(ad61, n_iter=7)
    out["tr_61"] = {"H": obsm_blocks(ad61)}
    blob = pickle.dumps(model)
    restored = pickle.loads(blob)
    again = local_adata(fresh, lo, hi)
    restored.transform(again, n_iter=7)
    out["pickle"] = {"device": type(restored.device).__name__,
                     "dims": tuple(restored.device.mesh_dim_names),
                     "shape": tuple(restored.device.mesh.shape),
                     "H": obsm_blocks(again)}
    # the fitted models moved to one process on the CPU: the parent's
    # single-process references for the transforms
    restored.device = torch.device("cpu")
    wf_cpu = pickle.loads(pickle.dumps(models["wf"][0]))
    wf_cpu.device = torch.device("cpu")
    out["cpu_model"] = {"96": pickle.dumps(restored), "wf": pickle.dumps(wf_cpu)}

    # refusals and inconsistent inputs: each must raise on every rank
    base = inputs["estimator"]["96"]
    lo, hi = dist.mesh_cell_range(mesh, base["X"].shape[0])

    def fit_case(model_kw=None, fit_kw=None, mutate=None):
        ad = local_adata(base, lo, hi)
        if mutate is not None:
            ad = mutate(ad)
        ALPINE(device=mesh, **{**KW, **(model_kw or {})}).fit(
            ad, KEYS, max_iter=3, **(fit_kw or {}))

    def drop_gene(ad):
        return AnnData(ad.X[:, :-1].copy(), obs=ad.obs)

    def other_cells_on_gene_block_1(ad):
        if place.gene_index == 1:
            ad.X = ad.X.copy()
            ad.X[0, 0] += 1.0
        return ad

    attempt("genes_indivisible", lambda: fit_case(mutate=drop_gene))
    attempt("column_differs", lambda: fit_case(mutate=other_cells_on_gene_block_1))
    attempt("tiled", lambda: fit_case(fit_kw={"sampling_method": "tiled",
                                              "batch_size": 24}))
    attempt("weighted", lambda: fit_case(fit_kw={"sampling_method": "weighted"}))
    attempt("n_restarts", lambda: fit_case(fit_kw={"n_restarts": 2}))
    attempt("als_minibatch", lambda: fit_case(model_kw={"use_als": True},
                                              fit_kw={"batch_size": 24}))
    attempt("optimizer", lambda: ComponentOptimizer(
        local_adata(base, 0, base["X"].shape[0]), KEYS, max_iter=3, device=mesh))
    attempt("transform_column_differs", lambda: model.transform(
        other_cells_on_gene_block_1(local_adata(base, lo, hi)), n_iter=3))
    # the groups still work after every refusal
    probe = torch.ones(1)
    dist.all_reduce_sum(probe, group)
    dist.all_reduce_sum(probe, gene_group)
    failures["after"] = float(probe)
    out["failures"] = failures
    out["checkpoint"] = checkpoints(inputs, workdir, mesh, rank)
    out["agreed"] = agreed_max_iter(inputs, mesh, rank, world)
    dist.shutdown()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def checkpoints(inputs, workdir, mesh, rank):
    """Checkpointed fits of the 96-cell case on the grid: joint, minibatch
    and gathered weighted, each uninterrupted, then interrupted after a
    snapshot and resumed by a fresh model; the ranks' snapshots at different
    iterations; and a shared directory holding a 1-D mesh's and a 2 × 1
    grid's snapshots of the same fit.  Every FitCheckpointer's key and
    path and every load's iteration are recorded."""
    place = Placement(mesh)
    base = inputs["estimator"]["96"]
    n = base["X"].shape[0]
    keys, loaded = [], []
    orig_init, orig_save, orig_load = (FitCheckpointer.__init__, FitCheckpointer.save,
                                       FitCheckpointer.load)

    def recording_init(self, directory, config_key, backend="npz"):
        orig_init(self, directory, config_key, backend)
        keys.append((dict(config_key), self.path))

    def recording_load(self):
        r = orig_load(self)
        loaded.append(None if r is None else int(r[0]))
        return r

    def interrupting_save(stop, back):
        # after the snapshot at iteration `stop` the fit is interrupted; the
        # snapshot at iteration `back` is kept aside, to be put back after
        def save(self, iteration, *args):
            orig_save(self, iteration, *args)
            if iteration == back:
                shutil.copy(self.path, self.path + ".back")
            if iteration >= stop:
                raise KeyboardInterrupt
        return save

    def ck_fit(directory, fit_kw, stop=None, back=None, device=mesh):
        lo, hi = dist.mesh_cell_range(device, n)
        FitCheckpointer.save = orig_save if stop is None else interrupting_save(stop, back)
        try:
            model = ALPINE(device=device, **KW)
            ad = local_adata(base, lo, hi)
            model.fit(ad, KEYS, checkpoint_dir=os.path.join(workdir, directory), **fit_kw)
            return model, fit_outputs(model, ad)
        except KeyboardInterrupt:
            if back is not None:
                os.replace(keys[-1][1] + ".back", keys[-1][1])
            return None, "interrupted"
        finally:
            FitCheckpointer.save = orig_save

    FitCheckpointer.__init__ = recording_init
    FitCheckpointer.load = recording_load
    ck, whole = {}, {}
    try:
        for name, fit_kw in (("joint", dict(max_iter=12, checkpoint_every=4)),
                             ("mb", dict(max_iter=6, checkpoint_every=2, batch_size=24)),
                             ("wt", dict(max_iter=6, checkpoint_every=2, batch_size=24,
                                         sampling_method="weighted"))):
            whole[name], ck[f"{name}_whole"] = ck_fit(f"ck_{name}_whole", fit_kw)
            ck[f"{name}_first"] = ck_fit(f"ck_{name}", fit_kw, stop=fit_kw["checkpoint_every"])[1]
            del loaded[:]
            ck[f"{name}_resumed"] = ck_fit(f"ck_{name}", fit_kw)[1]
            ck[f"{name}_resumed_from"] = list(loaded)
        ck["files_left"] = sorted(os.listdir(os.path.join(workdir, "ck_joint")))
        joint = dict(max_iter=12, checkpoint_every=4)
        # snapshots at iteration 8 on ranks 0-2, at 4 on rank 3
        ck_fit("ck_disagree", joint, stop=8, back=4 if rank == 3 else None)
        dist.process_allgather_rows([0])  # every rank's snapshot is in place
        del loaded[:]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ck["disagree"] = ck_fit("ck_disagree", joint)[1]
        ck["disagree_warnings"] = [str(w.message) for w in caught
                                   if "disagree across processes" in str(w.message)]
        ck["disagree_loaded"] = list(loaded)
        # a 1-D cell mesh's snapshots of the same fit (interrupted at 4),
        # and the snapshots a 2 × 1 grid's ranks would write, in one
        # directory: the grid resumes neither
        ck_fit("ck_shared", joint, stop=4, device=dist.global_cell_mesh())
        if place.process_chunk_index == 0:
            two_by_one = Placement(torch.device("cpu"))
            two_by_one.mesh = TwoByOne(place.gene_index)  # is_mesh takes a DeviceMesh only
            m = whole["joint"]  # the grid's fit of these settings
            ys = [np.zeros((len(m.fe.encoded_labels[k]), 1)) for k in KEYS]
            key = m._checkpoint_key(ys, n, 12, 4, two_by_one, np.asarray([n]))
            g0, g1 = two_by_one.gene_range(base["X"].shape[1])
            FitCheckpointer(os.path.join(workdir, "ck_shared"), key).save(
                4, np.concatenate(m.matrices["Ws"], axis=1)[g0:g1],
                np.concatenate(m.matrices["Hs"], axis=0), m.matrices["Bs"],
                m.loss_history_[:4])
        dist.process_allgather_rows([0])
        del loaded[:]
        ck["shared"] = ck_fit("ck_shared", joint)[1]
        ck["shared_loaded"] = list(loaded)
        ck["shared_files"] = sorted(os.listdir(os.path.join(workdir, "ck_shared")))
    finally:
        FitCheckpointer.__init__, FitCheckpointer.save, FitCheckpointer.load = (
            orig_init, orig_save, orig_load)
    ck["keys"] = keys
    return ck


def agreed_max_iter(inputs, mesh, rank, world):
    """A max_iter=None fit whose last rank moves its own elbow by 3: every
    rank records the elbow it computed, the fit's max_iter, its losses and
    the warnings naming the disagreement."""
    base = inputs["estimator"]["96"]
    lo, hi = dist.mesh_cell_range(mesh, base["X"].shape[0])
    real = ALPINE._compute_best_iter
    own = []

    def elbow(self, recon):
        own.append(real(self, recon) + (3 if rank == world - 1 else 0))
        return own[-1]

    ALPINE._compute_best_iter = elbow
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model = ALPINE(device=mesh, **KW)
            model.fit(local_adata(base, lo, hi), KEYS, max_iter=None)
    finally:
        ALPINE._compute_best_iter = real
    return {"own": own, "max_iter": model.max_iter, "loss": model.loss_history_.copy(),
            "warnings": [str(w.message) for w in caught
                         if "differs across processes" in str(w.message)]}


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)

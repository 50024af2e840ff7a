"""One rank of tests/test_torch_gene_cell_mesh.py: joins a gloo process
group of four on the CPU as one cell of a 2 × 2 ("genes", "cells") grid,
runs every case of ``inputs.pkl`` on its block (its gene rows of its
cells) and writes ``rank<i>.pkl`` (outputs, or the type and message of
what a case raised).

    python tests/torch_dist_grid_worker.py PORT RANK WORLD WORKDIR

Imports neither JAX nor the JAX package.  The process group's timeout is
short, so a rank left waiting in a collective raises instead of hanging.
"""

import os
import pickle
import sys
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from alpine_tpu_torch import ALPINE, AnnData, ComponentOptimizer  # noqa: E402
from alpine_tpu_torch.ops import mu  # noqa: E402
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

    def ops_fit(case, f64):
        """The grid's loop on this rank's block of a case."""
        g0, g1 = place.gene_range(case["X"].shape[0])
        lo, hi = dist.mesh_cell_range(mesh, case["X"].shape[1])
        cfg = mu.MUConfig(**case["cfg"])
        args = (cfg, t(case["W0"][g0:g1]).contiguous(),
                t(case["H0"][:, lo:hi]).contiguous(),
                tuple(t(b) for b in case["Bs0"]),
                t(case["X"][g0:g1, lo:hi]).contiguous(),
                [t(y[:, lo:hi]).contiguous() for y in case["Ys"]],
                (t(case["lam"]), *case["hyper"]))
        draw = None
        if "counts" in case:
            draw = lambda it: t(case["counts"][it, lo:hi])  # noqa: E731
        dist.reset_collectives()
        if f64:
            # past fit_scan's cast of X to a storage dtype
            W, H, Bs, L = mu._fit_scan_steps(*args, draw, None, None, group,
                                             hi - lo, gene_group)
        elif draw is None:
            W, H, Bs, L = mu.fit_scan_sharded(cfg, mesh, *args[1:])
        else:
            W, H, Bs, L = mu.fit_scan(*args, draw_counts=draw, group=group,
                                      gene_group=gene_group)
        return {"W": W.numpy(), "H": H.numpy(), "Bs": [b.numpy() for b in Bs],
                "L": L.numpy(), "collectives": dist.collective_summary()}

    for name, case in inputs["f64"].items():
        out[f"f64_{name}"] = ops_fit(case, True)
    for name, case in inputs["jax_fit"].items():
        out[f"jax_{name}"] = ops_fit(case, False)
    for name, case in inputs["payload"].items():
        out[f"payload_{name}"] = ops_fit(case, False)["collectives"]
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
    attempt("minibatch", lambda: fit_case(fit_kw={"batch_size": 24}))
    attempt("checkpoint", lambda: fit_case(
        fit_kw={"checkpoint_dir": os.path.join(workdir, f"ckpt{rank}")}))
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
    dist.shutdown()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)

"""One rank of tests/test_torch_distributed.py: joins a gloo process group
on the CPU, runs every case of ``inputs.pkl`` on its own cells and writes
``rank<i>.pkl`` (outputs, or the type and message of what a case raised).

    python tests/torch_dist_worker.py PORT RANK WORLD WORKDIR

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

KEYS = ["batch", "condition"]
KW = dict(n_components=6, n_covariate_components=[2, 3], lam=[1.0, 2.0],
          random_state=0)


def local_adata(case, lo, hi):
    """This rank's rows of a case's (cells × genes) data."""
    X = case["X"][lo:hi]
    obs = {k: case["obs"][k][lo:hi] for k in KEYS}
    return AnnData(np.array(X), obs=obs)


def fit_outputs(model, adata):
    return {"loss": model.loss_history_.copy(),
            "W": np.concatenate(model.matrices["Ws"], axis=1),
            "H": np.concatenate(model.matrices["Hs"], axis=0),
            "Bs": [b.copy() for b in model.matrices["Bs"]],
            "emb": np.asarray(adata.obsm["ALPINE_embedding"]).copy(),
            "data_dtype": model.data_dtype_}


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
    mesh = dist.global_cell_mesh()
    out = {"process_count": dist.process_count(), "process_index": dist.process_index(),
           "is_coordinator": dist.is_coordinator()}

    def cols(n):
        return dist.process_cell_range(n)

    # the sharded fit loop in float64 (the kernels' plain versions), past
    # fit_scan's cast of X to a storage dtype
    for name, case in inputs["f64"].items():
        lo, hi = cols(case["X"].shape[1])
        t = torch.from_numpy
        cfg = mu.MUConfig(**case["cfg"])
        W, H, Bs, L = mu._fit_scan_fused(
            cfg, t(case["W0"]), t(case["H0"][:, lo:hi]).contiguous(),
            tuple(t(b) for b in case["Bs0"]), t(case["X"][:, lo:hi]).contiguous(),
            [t(y[:, lo:hi]).contiguous() for y in case["Ys"]],
            (t(case["lam"]), *case["hyper"]), None, None, group=mesh.get_group())
        out[f"f64_{name}"] = {"W": W.numpy(), "H": H.numpy(),
                              "Bs": [b.numpy() for b in Bs], "L": L.numpy()}

    # fit_scan_sharded and run_transform on the inputs of the JAX package's
    # sharded tests
    for name, case in inputs["jax_fit"].items():
        lo, hi = cols(case["X"].shape[1])
        t = torch.from_numpy
        cfg = mu.MUConfig(**case["cfg"])
        X = t(case["X"][:, lo:hi]).contiguous()
        W, H, Bs, L = mu.fit_scan_sharded(
            cfg, mesh, t(case["W0"]), t(case["H0"][:, lo:hi]).contiguous(),
            tuple(t(b) for b in case["Bs0"]), X,
            [t(y[:, lo:hi]).contiguous() for y in case["Ys"]],
            (t(case["lam"]), *case["hyper"]))
        out[f"jax_{name}"] = {"W": W.numpy(), "H": H.numpy(),
                              "Bs": [b.numpy() for b in Bs], "L": L.numpy()}
    for name, case in inputs["jax_transform"].items():
        lo, hi = cols(case["X"].shape[1])
        t = torch.from_numpy
        H = mu.run_transform(t(case["W"]), t(case["X"][:, lo:hi]).contiguous(),
                             t(case["H0"][:, lo:hi]).contiguous(), case["eps"],
                             n_iter=case["n_iter"])
        out[f"jax_{name}"] = {"H": H.numpy()}

    # the all-reduce payload of an iteration at two cell counts
    for name, case in inputs["payload"].items():
        lo, hi = cols(case["X"].shape[1])
        t = torch.from_numpy
        cfg = mu.MUConfig(**case["cfg"])
        dist.reset_collectives()
        mu.fit_scan_sharded(cfg, mesh, t(case["W0"]), t(case["H0"][:, lo:hi]).contiguous(),
                            tuple(t(b) for b in case["Bs0"]),
                            t(case["X"][:, lo:hi]).contiguous(),
                            [t(y[:, lo:hi]).contiguous() for y in case["Ys"]],
                            (t(case["lam"]), *case["hyper"]))
        out[f"payload_{name}"] = dist.collective_summary()

    # the estimator: fits, transforms, a pickle round trip
    models = {}
    for name, case in inputs["estimator"].items():
        lo, hi = cols(case["X"].shape[0])
        ad = local_adata(case, lo, hi)
        model = ALPINE(device=mesh, data_dtype=case["data_dtype"], **KW)
        dist.reset_collectives()
        model.fit(ad, KEYS, max_iter=case["max_iter"])
        res = fit_outputs(model, ad)
        res["collectives"] = dist.collective_summary()
        res["timings"] = dict(model.timings_)
        models[name] = (model, ad)
        out[f"est_{name}"] = res
    model, ad = models["96"]
    model.transform(ad, n_iter=7)  # the fit's data: through the device-X cache
    out["tr_96"] = {"H": obsm_blocks(ad), "cache": model._x_cache is not None}
    fresh = inputs["fresh"]
    lo, hi = cols(fresh["X"].shape[0])
    ad61 = local_adata(fresh, lo, hi)
    model.transform(ad61, n_iter=7)
    out["tr_61"] = {"H": obsm_blocks(ad61)}
    blob = pickle.dumps(model)
    restored = pickle.loads(blob)
    again = local_adata(fresh, lo, hi)
    restored.transform(again, n_iter=7)
    out["pickle"] = {"blob": blob, "device": type(restored.device).__name__,
                     "mesh_size": int(restored.device.size()),
                     "H": obsm_blocks(again)}
    # the fitted model moved to one process on the CPU: the parent's
    # single-process reference
    restored.device = torch.device("cpu")
    out["cpu_model"] = pickle.dumps(restored)

    # max_iter=None: the warm-up and the elbow on the replicated losses
    case = inputs["estimator"]["96"]
    lo, hi = cols(case["X"].shape[0])
    elbow = ALPINE(device=mesh, data_dtype="float32", **KW)
    elbow.fit(local_adata(case, lo, hi), KEYS, max_iter=None)
    out["elbow"] = {"max_iter": elbow.max_iter, "loss": elbow.loss_history_.copy(),
                    "timings": sorted(elbow.timings_)}

    # data_dtype="auto": only rank 1 holds counts above 127
    auto = inputs["auto"]
    lo, hi = cols(auto["X"].shape[0])
    ad = local_adata(auto, lo, hi)
    m = ALPINE(device=mesh, **KW)
    m.fit(ad, KEYS, max_iter=2)
    out["auto"] = {"data_dtype": m.data_dtype_, "local_max": float(ad.X.max()),
                   "loss": m.loss_history_.copy()}

    # failures: each must raise on every rank, in step
    base = inputs["estimator"]["96"]
    lo, hi = cols(base["X"].shape[0])
    failures = {}

    def attempt(name, fn):
        try:
            fn()
            failures[name] = None
        except Exception as e:  # noqa: BLE001 (recorded for the parent)
            failures[name] = (type(e).__name__, str(e))

    def fit_case(model_kw=None, fit_kw=None, mutate=None):
        ad = local_adata(base, lo, hi)
        if mutate is not None:
            ad = mutate(ad)
        ALPINE(device=mesh, **{**KW, **(model_kw or {})}).fit(
            ad, KEYS, max_iter=3, **(fit_kw or {}))

    def drop_gene_on_rank1(ad):
        return AnnData(ad.X[:, :-1].copy(), obs=ad.obs) if rank == 1 else ad

    def big_count_on_rank1(ad):
        ad.X = np.floor(ad.X).clip(0, 100)
        if rank == 1:
            ad.X[0, 0] = 300.0
        return ad

    attempt("genes_differ", lambda: fit_case(mutate=drop_gene_on_rank1))
    attempt("int8_unstorable", lambda: fit_case(model_kw={"data_dtype": "int8"},
                                                mutate=big_count_on_rank1))
    attempt("n_restarts", lambda: fit_case(fit_kw={"n_restarts": 2}))
    attempt("weighted", lambda: fit_case(fit_kw={"sampling_method": "weighted"}))
    attempt("als_minibatch", lambda: fit_case(model_kw={"use_als": True},
                                              fit_kw={"batch_size": 24}))
    attempt("minibatch", lambda: fit_case(fit_kw={"batch_size": 24}))
    attempt("weighted_fast", lambda: fit_case(fit_kw={"sampling_method": "weighted_fast"}))
    attempt("tiled", lambda: fit_case(fit_kw={"sampling_method": "tiled", "batch_size": 24}))
    attempt("als", lambda: fit_case(model_kw={"use_als": True}))
    attempt("checkpoint", lambda: fit_case(
        fit_kw={"checkpoint_dir": os.path.join(workdir, f"ckpt{rank}")}))
    # every rank holds the full data: a search's trials fit on each rank
    attempt("optimizer", lambda: ComponentOptimizer(
        local_adata(base, 0, base["X"].shape[0]), KEYS, max_iter=3, device=mesh))
    attempt("transform_genes_differ", lambda: model.transform(
        drop_gene_on_rank1(local_adata(base, lo, hi)), n_iter=3))
    # the group still works after every refusal
    probe = torch.ones(1)
    dist.all_reduce_sum(probe, mesh.get_group())
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

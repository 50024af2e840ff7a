"""One rank of tests/test_torch_distributed_modes.py: joins a gloo process
group on the CPU, runs every case of ``inputs.pkl`` on its own cells (the
fit modes beyond full-batch joint: weighted_fast, ALS, random minibatch,
tiled, and the global-draw fits: ALS minibatch and gathered weighted;
checkpoints) and writes ``rank<i>.pkl``.

    python tests/torch_dist_modes_worker.py PORT RANK WORLD WORKDIR

Imports neither JAX nor the JAX package.  The process group's timeout is
short, so a rank left waiting in a collective raises instead of hanging.
"""

import os
import pickle
import sys
import traceback
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from alpine_tpu_torch import ALPINE, AnnData  # noqa: E402
from alpine_tpu_torch.io.checkpoint import FitCheckpointer  # noqa: E402
from alpine_tpu_torch.models import alpine as talpine  # noqa: E402
from alpine_tpu_torch.ops import kernels, mu  # noqa: E402
from alpine_tpu_torch.parallel import distributed as dist  # noqa: E402

KEYS = ["batch", "condition"]
KW = dict(n_components=6, n_covariate_components=[2, 3], lam=[1.0, 2.0],
          random_state=0, data_dtype="float32")


def local_adata(case, lo, hi):
    """Rows lo:hi of a case's (cells × genes) data."""
    return AnnData(np.array(case["X"][lo:hi]),
                   obs={k: case["obs"][k][lo:hi] for k in KEYS})


def blocks_of(adata):
    return np.concatenate([adata.obsm[k] for k in KEYS]
                          + [adata.obsm["ALPINE_embedding"]], axis=1)


def fit_outputs(model, adata):
    return {"loss": model.loss_history_.copy(),
            "W": np.concatenate(model.matrices["Ws"], axis=1),
            "Bs": [b.copy() for b in model.matrices["Bs"]],
            "H": np.concatenate(model.matrices["Hs"], axis=0),
            "emb": np.asarray(adata.obsm["ALPINE_embedding"]).copy(),
            "blocks": blocks_of(adata)}


def main():
    port, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    dist.initialize(coordinator_address=f"localhost:{port}",
                    num_processes=world, process_id=rank, timeout=30.0)
    mesh = dist.global_cell_mesh()
    group = mesh.get_group()
    t = torch.from_numpy
    out = {}

    # the global group layout, gathered from each rank's codes
    for name, codes in inputs["layout"].items():
        g_codes, m_gp = dist.allgather_group_layout(
            _Place(rank, world), codes[rank])
        out[f"layout_{name}"] = (g_codes, m_gp)

    def ops_fit(case, lo, hi, draws=None, backend=None):
        """mu.fit_scan (or its step loop in float64) over the group on
        columns lo:hi of a case; a "global" case's draws are the
        single-device epochs, of which the rank keeps its share."""
        cfg = mu.MUConfig(**{**case["cfg"], **({"backend": backend} if backend else {})})
        X = t(case["X"][:, lo:hi]).contiguous()
        Ys = [t(y[:, lo:hi]).contiguous() for y in case["Ys"]]
        hyper = (t(case["lam"]), *case["hyper"])
        args = (cfg, t(case["W0"]), t(case["H0"][:, lo:hi]).contiguous(),
                tuple(t(b) for b in case["Bs0"]), X, Ys, hyper)
        draw_counts = draw_cells = None
        if "counts" in case:
            draw_counts = lambda it: t(case["counts"][it, lo:hi])  # noqa: E731
        if draws is not None:
            draw_cells = lambda it: t(draws[it])  # noqa: E731
        cell_range = (lo, hi) if case.get("global") else None
        if case.get("f64") and backend is None:
            # past fit_scan's cast of X to a storage dtype
            if cfg.weighted_counts:
                W, H, Bs, L = mu._fit_scan_fused(*args, draw_counts, None, group)
            else:
                W, H, Bs, L = mu._fit_scan_steps(*args, None, draw_cells, None, group,
                                                 hi - lo, None, cell_range)
        else:
            W, H, Bs, L = mu.fit_scan(*args, draw_counts=draw_counts,
                                      draw_cells=draw_cells, group=group,
                                      cell_range=cell_range)
        return {"W": W.numpy(), "H": H.numpy(), "Bs": [b.numpy() for b in Bs],
                "L": L.numpy()}

    def cols(n):
        return dist.process_cell_range(n)

    for name, case in inputs["ops"].items():
        lo, hi = case["ranges"][rank] if "ranges" in case else cols(case["X"].shape[1])
        dist.reset_collectives()
        out[f"ops_{name}"] = ops_fit(case, lo, hi, case.get("draws", [None] * world)[rank])
        out[f"ops_{name}"]["collectives"] = dist.collective_summary()

    # the kernel wrappers' calls in a fused float32 ALS minibatch fit whose
    # first batch holds no cell of rank 1: (kind, cells) a call
    calls, real_passes = [], (kernels.hxt, kernels.wtx)
    kernels.hxt = lambda X, H: calls.append(("hxt", X.shape[1])) or real_passes[0](X, H)
    kernels.wtx = lambda X, W: calls.append(("wtx", X.shape[1])) or real_passes[1](X, W)
    case = inputs["ops"]["als_mb_empty_f64"]
    f32 = {**case, **{k: np.asarray(case[k], np.float32) for k in ("X", "W0", "H0", "lam")},
           "Bs0": [np.asarray(b, np.float32) for b in case["Bs0"]],
           "Ys": [np.asarray(y, np.float32) for y in case["Ys"]]}
    lo, hi = cols(case["X"].shape[1])
    dist.reset_collectives()
    try:
        fused = ops_fit(f32, lo, hi, case["draws"][rank], backend="fused")
    finally:
        kernels.hxt, kernels.wtx = real_passes
    out["als_mb_empty_fused"] = {"calls": calls, "L": fused["L"],
                                 "collectives": dist.collective_summary()}

    # the all-reduces of each mode at two cell counts
    for name, case in inputs["payload"].items():
        lo, hi = cols(case["X"].shape[1])
        dist.reset_collectives()
        ops_fit(case, lo, hi, case.get("draws", [None] * world)[rank])
        out[f"payload_{name}"] = dist.collective_summary()

    # the estimator
    real_stream = talpine.draw_counts_stream

    def recording_stream(first):
        def stream(*args, **kw):
            draw = real_stream(*args, **kw)

            def recorded(it):
                c = draw(it)
                if it == 0:
                    first.append(c.numpy().copy())
                return c
            return recorded
        return stream

    est = inputs["estimator"]
    for name, spec in est.items():
        case = inputs["data"][spec["data"]]
        lo, hi = spec["ranges"][rank] if "ranges" in spec else cols(case["X"].shape[0])
        ad = local_adata(case, lo, hi)
        if "mark" in spec:  # one cell of each rank far from the others
            ad.X[spec["mark"]] += 50.0
        model = ALPINE(device=mesh, **{**KW, **spec.get("model", {})})
        dist.reset_collectives()
        first = []
        if spec.get("record_draw"):
            talpine.draw_counts_stream = recording_stream(first)
        try:
            model.fit(ad, KEYS, **spec["fit"])
        finally:
            talpine.draw_counts_stream = real_stream
        res = fit_outputs(model, ad)
        res["collectives"] = dist.collective_summary()
        if first:
            # this rank's first draw, back in its caller order
            res["first_draw"] = first[0][np.argsort(model._x_cache[3])]
        if spec.get("cpu_model"):
            # the fitted model moved to one process on the CPU
            model.device = torch.device("cpu")
            res["cpu_model"] = pickle.dumps(model)
            model.device = mesh
        if spec.get("transform"):
            model.transform(ad, n_iter=5)
            res["cached"] = (model._x_cache is not None, blocks_of(ad))
            model.free_device_cache()
            model.transform(ad, n_iter=5)
            res["uncached"] = blocks_of(ad)
        out[f"est_{name}"] = res

    # checkpoints: per-rank snapshots in one shared directory
    base = inputs["data"]["96"]
    lo, hi = cols(base["X"].shape[0])
    keys, loaded = [], {}
    orig_init, orig_save, orig_load = (FitCheckpointer.__init__, FitCheckpointer.save,
                                       FitCheckpointer.load)

    def recording_init(self, directory, config_key, backend="npz"):
        orig_init(self, directory, config_key, backend)
        keys.append((dict(config_key), self.path))

    def interrupting_save(stop):
        def save(self, iteration, W, H, Bs, losses):
            orig_save(self, iteration, W, H, Bs, losses)
            if iteration >= stop:
                raise KeyboardInterrupt
        return save

    def recording_load(self):
        r = orig_load(self)
        loaded.setdefault("it", []).append(None if r is None else int(r[0]))
        return r

    def ck_fit(directory, fit_kw, stop=None, model_kw=None):
        FitCheckpointer.save = orig_save if stop is None else interrupting_save(stop)
        try:
            model = ALPINE(device=mesh, **{**KW, **(model_kw or {})})
            ad = local_adata(base, lo, hi)
            model.fit(ad, KEYS, checkpoint_dir=os.path.join(workdir, directory), **fit_kw)
            return fit_outputs(model, ad)
        except KeyboardInterrupt:
            return "interrupted"
        finally:
            FitCheckpointer.save = orig_save

    FitCheckpointer.__init__ = recording_init
    FitCheckpointer.load = recording_load
    ck = {}
    try:
        joint = dict(max_iter=12, checkpoint_every=4)
        ck["chunked"] = ck_fit("ck_plain", joint)
        ck["first"] = ck_fit("ck_resume", joint, stop=8)
        loaded.clear()
        ck["resumed"] = ck_fit("ck_resume", joint)
        ck["resumed_from"] = list(loaded["it"])
        ck_fit("ck_disagree", joint, stop=8)
        dist.process_allgather_rows([0])  # both snapshots are written
        if rank == 1:  # its own snapshot only; rank 0's stays
            os.remove(keys[-1][1])
        dist.process_allgather_rows([0])
        loaded.clear()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ck["disagree"] = ck_fit("ck_disagree", joint)
        ck["disagree_warnings"] = [str(w.message) for w in caught
                                   if "disagree across processes" in str(w.message)]
        ck["disagree_loaded"] = list(loaded["it"])
        wf = dict(max_iter=8, checkpoint_every=4, sampling_method="weighted_fast")
        ck["wf_plain"] = ck_fit("ck_wf_plain", wf)
        ck["wf_first"] = ck_fit("ck_wf", wf, stop=4)
        loaded.clear()
        ck["wf_resumed"] = ck_fit("ck_wf", wf)
        ck["wf_resumed_from"] = list(loaded["it"])
        ck["tiled"] = ck_fit("ck_tiled", dict(max_iter=4, checkpoint_every=2,
                                              batch_size=24, sampling_method="tiled"))
        ck["als"] = ck_fit("ck_als", dict(max_iter=4, checkpoint_every=2),
                           model_kw={"use_als": True})
        ck["minibatch"] = ck_fit("ck_mb", dict(max_iter=4, checkpoint_every=2,
                                               batch_size=24))
        # the global-draw fits: uninterrupted, then interrupted after the
        # first snapshot and resumed
        for name, model_kw, fit_kw in (
                ("wt", {}, dict(sampling_method="weighted", batch_size=24)),
                ("als_mb", {"use_als": True}, dict(batch_size=24))):
            fit_kw = dict(fit_kw, max_iter=6, checkpoint_every=2)
            ck[f"{name}_plain"] = ck_fit(f"ck_{name}_plain", fit_kw, model_kw=model_kw)
            ck[f"{name}_first"] = ck_fit(f"ck_{name}", fit_kw, stop=2, model_kw=model_kw)
            loaded.clear()
            ck[f"{name}_resumed"] = ck_fit(f"ck_{name}", fit_kw, model_kw=model_kw)
            ck[f"{name}_resumed_from"] = list(loaded["it"])
        ck["files_left"] = sorted(os.listdir(os.path.join(workdir, "ck_plain")))
    finally:
        FitCheckpointer.__init__, FitCheckpointer.save, FitCheckpointer.load = (
            orig_init, orig_save, orig_load)
    ck["keys"] = keys
    out["checkpoint"] = ck

    # a sampling_method that differs across the ranks raises on both
    try:
        ALPINE(device=mesh, **KW).fit(
            local_adata(base, lo, hi), KEYS, max_iter=2,
            sampling_method="weighted_fast" if rank == 0 else "random")
        out["mixed_sampling"] = None
    except Exception as e:  # noqa: BLE001 (recorded for the parent)
        out["mixed_sampling"] = (type(e).__name__, str(e))
    probe = torch.ones(1)
    dist.all_reduce_sum(probe, group)
    out["after"] = float(probe)
    dist.shutdown()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class _Place:
    """The placement fields ``allgather_group_layout`` reads."""

    def __init__(self, rank, world):
        self.process_chunk_index, self.n_processes = rank, world
        # a cell mesh: one gene block, a cell run a process
        self.gene_index, self.cell_shards = 0, world


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)

"""The ALPINE estimator on PyTorch/CUDA — the port's main path.

Counterpart of ``alpine_tpu/models/alpine.py`` for the single-device
full-epoch fits and their transform: same constructor, same validation
messages, same ``obsm``/``varm`` keys.  ``fit`` runs the fused fit loop
(``ops/mu.py``), which launches one CUDA kernel per iteration on the card
and runs each kernel's plain PyTorch version on the CPU; with
``use_als=True`` it runs block-cyclic ALS steps, whose X passes are the
kernels ``hxt`` and ``wtx``.  ``transform`` runs the fused projection
kernel.  ``sampling_method`` is "random" (full batch) or "weighted_fast"
(class-balanced draws as per-cell counts over a group-sorted cell axis;
joint mode only).  A fit keeps its device copy of X, and a ``transform``
of the same data reuses it.  ``verbose=True`` shows the JAX package's
progress bar.

What this slice leaves out raises ``NotImplementedError``: minibatch and
gathered weighted or tiled sampling, checkpoints, restarts, component
bucketing, multi-GPU and multi-process fits, ``get_normalized_expression``
and save/load.

Random draws come from ``torch.Generator``s seeded with ``random_state``
through ``draw_init``, ``draw_counts_stream`` and ``draw_transform_h0``;
they differ from the JAX package's ``jax.random`` streams by design.
"""

from __future__ import annotations

import os
import time
import warnings
from copy import copy, deepcopy
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from alpine_tpu_torch.models.state import AlpineMatrices, split_h, split_w
from alpine_tpu_torch.ops import mu
from alpine_tpu_torch.ops.elbow import find_elbow
from alpine_tpu_torch.parallel.mesh import resolve_device
from alpine_tpu_torch.utils.adata import (
    as_compressed, dense_x, is_anndata, is_sparse_x, obs_is_categorical,
    obs_keys, suggest_data_dtype, x_min,
)
from alpine_tpu_torch.utils.encoder import FeatureEncoders
from alpine_tpu_torch.utils.sampling import balanced_group_tables, joint_label_ids

Float32Array = np.ndarray

# salts of the transform H0 and the weighted_fast count streams, so they
# never coincide with the fit's init stream or with each other
_TRANSFORM_SALT = 0x7472616E  # "tran"
_COUNTS_SALT = 0x636E7473  # "cnts"


def draw_init(cfg: mu.MUConfig, n_genes: int, random_state: int, eps: float,
              device):
    """The fit's initial (W0, H0, Bs0), drawn from ``random_state``."""
    gen = torch.Generator().manual_seed(random_state)
    return mu.init_matrices(cfg, n_genes, gen, eps, device)


def draw_transform_h0(n_components: int, n_cells: int, random_state: int,
                      eps: float, device) -> torch.Tensor:
    """The transform's initial H, drawn from a stream separate from the fit's."""
    gen = torch.Generator().manual_seed(random_state + _TRANSFORM_SALT)
    H0 = torch.rand((n_components, n_cells), generator=gen, dtype=torch.float32)
    return torch.clamp(H0, min=eps).to(device)


def draw_counts_stream(tables, n_cells: int, random_state: int, device):
    """weighted_fast's draws: returns ``draw(t)``, epoch t's balanced draw
    as a (n_cells,) float32 count tensor on ``device``.  ``tables`` are the
    (start, sizes) group tables of the group-sorted cell axis, on
    ``device``.  Draw t comes from a device generator seeded from
    (random_state, salt, t), so it depends on t alone."""
    gen = torch.Generator(device=device)

    def draw(t: int) -> torch.Tensor:
        seed = np.random.SeedSequence([random_state, _COUNTS_SALT, t])
        gen.manual_seed(int(seed.generate_state(1, np.uint64)[0] >> 1))
        return mu.grouped_balanced_counts(gen, n_cells, tables)

    return draw


def _no_x_cache() -> bool:
    """ALPINE_TPU_NO_X_CACHE (the JAX package's switch): unset, '', '0' or
    'false' mean the device-X cache is on."""
    return os.environ.get("ALPINE_TPU_NO_X_CACHE", "").lower() not in (
        "", "0", "false")


def _not_in_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to alpine_tpu_torch yet (a later slice of the "
        "port); the JAX package alpine_tpu supports it.")


class _Progress:
    """A verbose fit's progress as the JAX package shows it
    (alpine_tpu/models/alpine.py:838-866): a tqdm bar "Iteration" over the
    fit's iterations with the objective loss as its postfix or, where tqdm
    is not installed, one printed line a report (as its
    ``run_progress_chunks``, :804-836).  ``mu.fit_scan`` calls it every
    ``mu.progress_every`` iterations and after the last."""

    def __init__(self, total: int):
        self.total = total
        try:
            from tqdm import tqdm
        except ImportError:
            self.bar = None
        else:
            self.bar = tqdm(total=total, desc="Iteration", ncols=100)

    def __call__(self, done: int, loss: float) -> None:
        if self.bar is None:
            print(f"ALPINE fit: iteration {done}/{self.total}, objective loss "
                  f"{loss:.6g}", flush=True)
            return
        self.bar.set_postfix({"objective loss": loss}, refresh=False)
        self.bar.n = done
        self.bar.refresh()

    def reset(self, total: int) -> None:
        """The elbow's fit after its 200-iteration warm-up."""
        self.total = total
        if self.bar is not None:
            self.bar.reset(total=total)

    def close(self) -> None:
        if self.bar is not None:
            self.bar.close()


class ALPINE:
    def __init__(
        self,
        n_components: int,
        n_covariate_components: List[int],
        lam: List[float],
        orth_W: float = 0.0,
        alpha_W: float = 0.0,
        l1_ratio_W: float = 0.0,
        use_als: bool = False,
        scale_needed: bool = True,
        loss_type: str = "kl-divergence",
        device="cuda",
        eps: float = 1e-6,
        random_state: int = 42,
        matmul_precision: str = "highest",
        data_dtype: str = "auto",
        component_bucket=None,
    ):
        self.n_components = n_components
        self.n_covariate_components = n_covariate_components
        self.lam = lam
        self.orth_W = orth_W
        self.alpha_W = alpha_W
        self.l1_ratio_W = l1_ratio_W
        self.use_als = use_als
        self.scale_needed = scale_needed
        self.device = resolve_device(device)
        self.loss_type = loss_type
        self.eps = eps
        self.random_state = random_state
        self.matmul_precision = matmul_precision
        self.data_dtype = data_dtype
        if component_bucket is not None:
            raise _not_in_slice("component_bucket")
        self.component_bucket = None

        self._validate_init_args()

        # derived attributes (reference main.py:79-80)
        self.n_all_components = self.n_covariate_components + [self.n_components]
        self.total_components = sum(self.n_all_components)

    # ------------------------------------------------------------------ fit
    def fit(
        self,
        adata,
        covariate_keys: List[str],
        batch_size: Optional[int] = None,
        max_iter: Optional[int] = None,
        sampling_method: str = "random",
        verbose: bool = False,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 50,
        checkpoint_backend: str = "npz",
        n_restarts: int = 1,
    ) -> "ALPINE":
        self._validate_fit_args(
            adata, covariate_keys, batch_size, max_iter, sampling_method, verbose
        )
        # the reference's checks and messages (alpine_tpu/models/alpine.py:
        # 153-171), then what this slice leaves out
        if checkpoint_dir is not None and not isinstance(checkpoint_dir, str):
            raise TypeError("checkpoint_dir must be a string or None.")
        if not isinstance(checkpoint_every, int) or checkpoint_every <= 0:
            raise ValueError("checkpoint_every must be a positive integer.")
        if not isinstance(n_restarts, int) or n_restarts <= 0:
            raise ValueError("n_restarts must be a positive integer.")
        if n_restarts > 1 and checkpoint_dir is not None:
            raise ValueError("n_restarts > 1 is incompatible with checkpointing.")
        if checkpoint_dir is not None and checkpoint_backend not in ("npz", "orbax"):
            raise ValueError("checkpoint backend must be 'npz' or 'orbax'")
        if checkpoint_dir is not None:
            raise _not_in_slice("fit(checkpoint_dir=...)")
        if n_restarts > 1:
            raise _not_in_slice("fit(n_restarts > 1)")
        if sampling_method in ("weighted", "weighted_fast") and not covariate_keys:
            raise ValueError(
                "weighted sampling requires at least one covariate "
                "(balancing is over the joint covariate labels)."
            )
        if sampling_method == "tiled" and self.use_als:
            raise ValueError(
                "tiled sampling requires joint mode on a 1-D cell mesh "
                "(or one device); use sampling_method='random'."
            )
        if sampling_method == "weighted_fast" and self.use_als:
            raise ValueError(
                "sampling_method='weighted_fast' supports full-epoch joint "
                "mode only (batch_size=None, use_als=False); minibatch or "
                "ALS weighted fits use sampling_method='weighted'."
            )
        n_sample = adata.shape[0]
        if (sampling_method == "weighted_fast" and batch_size is not None
                and batch_size < n_sample):
            raise ValueError(
                f"sampling_method='weighted_fast' supports full-epoch joint "
                f"mode only: batch_size ({batch_size}) must be None or >= "
                f"n_cells ({n_sample}); minibatch weighted fits use "
                f"sampling_method='weighted'."
            )
        if sampling_method not in ("random", "weighted_fast"):
            raise _not_in_slice(f"sampling_method={sampling_method!r}")
        if batch_size is not None and batch_size < n_sample:
            raise _not_in_slice("minibatch fitting (batch_size < n_cells)")

        # (genes x cells) layout, as in the reference (main.py:104)
        X: Float32Array = dense_x(adata.X).T
        resolved_dtype = (suggest_data_dtype(adata.X) if self.data_dtype == "auto"
                          else self.data_dtype)
        fe = FeatureEncoders(covariate_keys)
        Ys = [y.T.copy() for y in fe.fit_transform(adata.obs)]

        # commit estimator state only after the encoders fitted
        self.fe = fe
        self.data_dtype_ = resolved_dtype
        if verbose and self.data_dtype == "auto":
            print(f"ALPINE fit: data_dtype='auto' resolved to '{resolved_dtype}'")
        self.feature_names: List[str] = list(adata.var_names.tolist())
        self.n_features: int = adata.shape[1]
        self.covariate_keys: List[str] = covariate_keys
        self.sampling_method: str = sampling_method
        self.verbose: bool = verbose
        self.batch_size: int = n_sample

        dev = self.device
        # X in its storage dtype first, so the group sort below permutes
        # the narrow copy (200 MB of int8 at 100k x 2,000, not 800 MB)
        Xd = self._cast_x_host(X).to(dev)
        Ysd = [torch.from_numpy(y).to(dev) for y in Ys]
        cell_perm = tables = None
        if sampling_method == "weighted_fast":
            # group-sort the cells (stable) for the grouped sampler; H0
            # pairs positionally with the sorted cells and H is un-sorted
            # on extraction
            cell_perm, start, sizes = balanced_group_tables(joint_label_ids(Ys))
            perm = torch.from_numpy(cell_perm).to(dev)
            Xd = Xd[:, perm]
            Ysd = [y[:, perm] for y in Ysd]
            tables = (torch.from_numpy(start).to(dev),
                      torch.from_numpy(sizes).to(dev))
        # the device X of a same-data transform; installed after the fit
        new_x_cache = (None if _no_x_cache() else
                       (Xd, self._x_fingerprint(adata.X), n_sample, cell_perm))
        hyper = self._hyper()
        self.timings_: Dict[str, float] = {}
        # no callback without verbose: the fit loop then never syncs
        progress = _Progress(max_iter or 200) if verbose else None

        def run(n_iter: int):
            cfg = self._make_cfg(Ys, n_sample, n_iter)
            W0, H0, Bs0 = draw_init(cfg, self.n_features, self.random_state,
                                    self.eps, dev)
            draw = (None if tables is None else
                    draw_counts_stream(tables, n_sample, self.random_state, dev))
            return cfg, mu.fit_scan(cfg, W0, H0, Bs0, Xd, Ysd, hyper,
                                    draw_counts=draw, progress=progress)

        try:
            t0 = time.perf_counter()
            if max_iter is None:
                # warm-up elbow search (reference main.py:114-131)
                _, (_, _, _, losses) = run(200)
                recon = losses[:, 1].cpu().numpy()
                self.max_iter: int = self._compute_best_iter(recon)
                self.timings_["warmup"] = time.perf_counter() - t0
                if progress is not None:
                    progress.reset(self.max_iter)
                t0 = time.perf_counter()
            else:
                self.max_iter = max_iter
            cfg, (Wd, Hd, Bsd, losses) = run(self.max_iter)
            if self.scale_needed:
                Wd, Hd, Bsd = mu.scale_matrices(cfg.blocks, Wd, Hd, Bsd)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.timings_["fit"] = time.perf_counter() - t0
        finally:
            if progress is not None:
                progress.close()

        self.loss_history_ = losses.cpu().numpy()
        if verbose and len(self.loss_history_):
            print(f"ALPINE fit: {self.max_iter} iterations, final objective "
                  f"loss {self.loss_history_[-1, 0]:.6g}")

        H_np = Hd.cpu().numpy()
        if cell_perm is not None:
            H_np = H_np[:, np.argsort(cell_perm)]  # back to caller order
        m = AlpineMatrices(
            X=X,
            Ys=[np.asarray(y, dtype=np.float32) for y in Ys],
            Ws=split_w(Wd.cpu().numpy(), self.n_all_components),
            Hs=split_h(H_np, self.n_all_components),
            Bs=[b.cpu().numpy() for b in Bsd],
        )
        self.matrices: Dict[str, Union[Float32Array, List[Float32Array]]] = m.to_numpy()
        # the fit succeeded: pair its device X with this model
        self._x_cache = new_x_cache
        self.store_embeddings(adata)
        return self

    @property
    def loss_history(self):
        """The per-iteration losses as a pandas DataFrame (reference
        main.py:666-676); ``loss_history_`` holds the raw array."""
        import pandas as pd

        colnames = ["total loss", "reconstruction loss"] + [
            f"prediction loss({k})" for k in self.covariate_keys
        ]
        return pd.DataFrame(self.loss_history_, columns=colnames)

    # ------------------------------------------------------------ transform
    def transform(self, adata, n_iter: Optional[int] = None) -> None:
        if not hasattr(self, "matrices"):
            raise RuntimeError("Model is not trained yet. Please fit the model first.")
        if not is_anndata(adata):
            raise TypeError("adata must be an AnnData object.")
        if not isinstance(n_iter, (int, type(None))) or (
            n_iter is not None and n_iter <= 0
        ):
            raise ValueError("n_iter must be a positive integer or None.")
        n_iter = n_iter if n_iter is not None else self.max_iter
        self._transform(adata, n_iter)

    def fit_transform(
        self,
        adata,
        covariate_keys: List[str],
        batch_size: Optional[int] = None,
        max_iter: Optional[int] = None,
        sampling_method: str = "random",
        verbose: bool = False,
    ) -> None:
        self.fit(
            adata,
            covariate_keys,
            batch_size=batch_size,
            max_iter=max_iter,
            sampling_method=sampling_method,
            verbose=verbose,
        ).transform(adata)

    # --------------------------------------------------------------- loss
    def compute_loss(self, adata):
        """Post-hoc numpy recomputation of the total loss from stored
        embeddings (reference main.py:187-236)."""
        if not hasattr(self, "matrices"):
            raise RuntimeError("Model is not trained yet. Please fit the model first.")
        if not is_anndata(adata):
            raise TypeError("adata must be an AnnData object.")
        if "ALPINE_embedding" not in adata.obsm:
            raise ValueError(
                "ALPINE_embedding not found in adata.obsm. Please transform the data first."
            )

        def kl_divergence(y, y_hat):
            y_hat = np.clip(y_hat, a_min=self.eps, a_max=None)
            return np.sum(
                y * np.log(np.clip(y / y_hat, a_min=self.eps, a_max=None)) - y + y_hat
            )

        X = dense_x(adata.X).T
        Ws, Hs = [], []
        for covariate in self.covariate_keys:
            Hs.append(copy(np.asarray(adata.obsm[covariate]).T))
            Ws.append(copy(np.asarray(adata.varm[covariate])))
        Hs.append(copy(np.asarray(adata.obsm["ALPINE_embedding"]).T))
        Ws.append(copy(np.asarray(adata.varm["ALPINE_weights"])))

        W = np.concatenate(Ws, axis=1)
        H = np.concatenate(Hs, axis=0)
        recon_loss = np.linalg.norm(X - W @ H, ord="fro") ** 2

        Ys = self.fe.transform(adata.obs)
        Bs = self.matrices["Bs"]
        if self.loss_type == "kl-divergence":
            pred_loss = [kl_divergence(Ys[i].T, Bs[i] @ Hs[i]) for i in range(len(Ys))]
        else:
            pred_loss = [
                np.linalg.norm(Ys[i].T - Bs[i] @ Hs[i], ord="fro") ** 2
                for i in range(len(Ys))
            ]
        return recon_loss + sum(self.lam[i] * pl for i, pl in enumerate(pred_loss))

    # ----------------------------------------------------------- accessors
    def get_decomposed_matrices(self):
        if not hasattr(self, "matrices"):
            raise RuntimeError("Model is not trained yet. Please fit the model first.")
        return self.matrices

    def get_covariate_gene_scores(self, adata=None):
        """Per-covariate (genes x labels) scores W_i @ (H_i Y_iᵀ / rowsum(Y_i))
        as pandas DataFrames (reference main.py:246-273)."""
        if not hasattr(self, "matrices"):
            raise RuntimeError("Model is not trained yet. Please fit the model first.")
        import pandas as pd

        cov_gene_scores = {}
        for i, covariate in enumerate(self.covariate_keys):
            W = self.matrices["Ws"][i]
            H = self.matrices["Hs"][i]
            Y = self.matrices["Ys"][i]
            HY = H @ Y.T / Y.sum(axis=1)
            cov_gene_scores[covariate] = pd.DataFrame(
                W @ HY, index=self.feature_names,
                columns=self.fe.encoded_labels[covariate])
        if adata is None:
            return cov_gene_scores
        for condition, df in cov_gene_scores.items():
            adata.varm[condition + "_gene_scores"] = df
        return None

    def free_device_cache(self) -> None:
        """Release the device copy of X kept for same-data transforms
        (200 MB of int8 at 100k cells x 2,000 genes)."""
        self._x_cache = None

    def __getstate__(self):
        # a pickle carries no device tensors (the cache holds all of X)
        state = dict(self.__dict__)
        state["_x_cache"] = None
        return state

    def get_normalized_expression(self, *args, **kwargs):
        raise _not_in_slice("get_normalized_expression")

    def save(self, path: str) -> None:
        raise _not_in_slice("save/load")

    @classmethod
    def load(cls, path: str, device="auto") -> "ALPINE":
        raise _not_in_slice("save/load")

    def store_embeddings(self, adata) -> None:
        """Write obsm/varm keys (reference main.py:303-320): the unguided block
        to 'ALPINE_embedding'/'ALPINE_weights'; per covariate its H/W blocks
        and '{cov}_dummy_matrix'."""
        if not hasattr(self, "matrices"):
            raise RuntimeError("Model is not trained yet. Please fit the model first.")
        elif not is_anndata(adata):
            raise TypeError("adata must be an AnnData object.")

        adata.obsm["ALPINE_embedding"] = copy(self.matrices["Hs"][-1].T)
        adata.varm["ALPINE_weights"] = copy(self.matrices["Ws"][-1])
        dummy_matrices = self.fe.transform(adata.obs)
        for i, covariate in enumerate(self.covariate_keys):
            adata.obsm[covariate] = copy(self.matrices["Hs"][i].T)
            adata.obsm[f"{covariate}_dummy_matrix"] = dummy_matrices[i]
            adata.varm[covariate] = copy(self.matrices["Ws"][i])

    # ------------------------------------------------------------ internals
    @property
    def _storage_dtype(self) -> str:
        """The resolved X storage dtype (`data_dtype_`, set at fit); before
        any fit, the constructor dtype with "auto" read as float32."""
        dt = getattr(self, "data_dtype_", None)
        if dt is None:
            dt = "float32" if self.data_dtype == "auto" else self.data_dtype
        return dt

    def _make_cfg(self, Ys, n_sample: int, n_iter: int) -> mu.MUConfig:
        return mu.MUConfig(
            blocks=tuple(self.n_all_components),
            n_labels=tuple(y.shape[0] for y in Ys),
            n_cells=n_sample,
            loss_kl=(self.loss_type == "kl-divergence"),
            max_iter=n_iter,
            precision=self.matmul_precision,
            x_dtype=self._storage_dtype,
            backend="fused",
            weighted_counts=(self.sampling_method == "weighted_fast"),
            use_als=self.use_als,
        )

    def _hyper(self):
        """(lam, orth_W, alpha_W, l1_ratio_W, eps): lam a float32 tensor on
        the device, the rest Python floats rounded to float32."""
        f32 = lambda v: float(np.float32(v))
        return (
            torch.tensor(np.asarray(self.lam, dtype=np.float32).reshape(-1),
                         device=self.device),
            f32(self.orth_W), f32(self.alpha_W), f32(self.l1_ratio_W),
            f32(self.eps),
        )

    def _cast_x_host(self, arr: np.ndarray, *, strict: bool = True) -> torch.Tensor:
        """X in its storage dtype as a contiguous host tensor.  int8/int16
        are EXACT for raw counts: the cast is verified by round trip and any
        value the integer dtype cannot represent raises (or, with
        ``strict=False`` on the transform path, falls back to the compute
        dtype's float storage).  bfloat16 rounds by documented design."""
        dt = self._storage_dtype
        if dt == "bfloat16":
            return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
                torch.bfloat16)
        if dt in ("int8", "int16"):
            with np.errstate(invalid="ignore"):  # NaN→int is diagnosed below
                cast = arr.astype(dt)
            if np.array_equal(arr, cast) and (
                    not cast.size or int(cast.min()) >= 0):
                return torch.from_numpy(np.ascontiguousarray(cast))
            if not strict:
                f32 = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
                return f32.to(torch.bfloat16) if dt == "int8" else f32
            if np.isnan(arr).any():
                raise ValueError(
                    f"data_dtype='{dt}' requires integer-valued "
                    "adata.X, but it contains NaN."
                )
            limit = np.iinfo(dt).max
            if float(arr.max(initial=0.0)) > limit or float(
                    arr.min(initial=0.0)) < 0:
                alternatives = ("'int16', 'bfloat16', or 'float32'"
                                if dt == "int8"
                                else "'bfloat16' or 'float32'")
                raise ValueError(
                    f"data_dtype='{dt}' requires all values "
                    f"of adata.X to be >= 0 and <= {limit}; found range "
                    f"[{arr.min()}, {arr.max()}]. Use {alternatives} instead."
                )
            raise ValueError(
                f"data_dtype='{dt}' requires integer-valued "
                "adata.X (raw counts); found fractional values. Use "
                "'bfloat16' or 'float32' for normalized/transformed data."
            )
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32))

    @staticmethod
    def _x_fingerprint(X_host) -> tuple:
        """Identity of a host X for the device-X cache: shape, a
        4096-element strided sample, the float64 sum and minimum, and a
        position-weighted hash of the row sums (which catches reordered
        cells).  Sparse inputs hash their stored values, row sums and a
        position-weighted hash of the column sums without densifying.
        Same rule as the JAX package's ``ALPINE._x_fingerprint``."""
        if is_sparse_x(X_host):
            Xc = as_compressed(X_host)
            data = np.asarray(Xc.data)
            flat = data.reshape(-1)
            total = float(data.sum(dtype=np.float64))
            minimum = x_min(Xc)
            row_sums = np.asarray(Xc.sum(axis=1), dtype=np.float64).ravel()
            col_sums = np.asarray(Xc.sum(axis=0), dtype=np.float64).ravel()
            colkey = np.random.default_rng(0xC01).random(len(col_sums))
            col_hash = float(np.dot(col_sums, colkey))
            shape = ("sparse",) + tuple(Xc.shape) + (int(Xc.nnz), col_hash)
        else:
            arr = np.asarray(X_host)
            flat = arr.reshape(-1)
            total = float(arr.sum(dtype=np.float64))
            minimum = float(arr.min())
            row_sums = (arr.sum(axis=-1, dtype=np.float64)
                        if arr.ndim == 2 else flat)
            shape = arr.shape
        stride = max(1, flat.size // 4096)
        sample = np.asarray(flat[::stride][:4096], dtype=np.float32)
        poskey = np.random.default_rng(0xA1F1E).random(len(row_sums))
        return (shape, sample.tobytes(), total, minimum,
                float(np.dot(np.asarray(row_sums, dtype=np.float64), poskey)))

    def _transform(self, adata, n_iter: int) -> None:
        """Out-of-sample projection: Frobenius MU onto the frozen W
        (reference main.py:678-724), through the fused kernel.  On the data
        the model was fit on, the fit's device X is reused; after a
        weighted_fast fit its cells are group-sorted, so H0 is re-paired to
        them and the result un-sorted (each cell's projection is independent
        of the others)."""
        if adata.shape[1] != self.n_features:
            raise ValueError(
                f"adata has {adata.shape[1]} genes but the model was fit "
                f"on {self.n_features}; transform requires the same gene "
                "axis (same order) as the training data."
            )
        dev = self.device
        n_sample = adata.shape[0]
        cached = getattr(self, "_x_cache", None)
        if (cached is not None and not _no_x_cache() and cached[2] == n_sample
                and cached[1] == self._x_fingerprint(adata.X)):
            X, cell_perm = cached[0], cached[3]  # validated at fit
        else:
            if not (x_min(adata.X) >= 0):  # NaN fails this like a negative
                raise ValueError("All elements in adata.X must be non-negative.")
            # out-of-sample data need not be integer-representable
            X = self._cast_x_host(dense_x(adata.X).T, strict=False).to(dev)
            cell_perm = None
        H0 = draw_transform_h0(self.total_components, n_sample,
                               self.random_state, self.eps, dev)
        if cell_perm is not None:
            # device column p is caller cell cell_perm[p]
            H0 = H0[:, torch.from_numpy(cell_perm).to(dev)]
        W = torch.from_numpy(np.concatenate(self.matrices["Ws"], axis=1)).to(dev)
        H = mu.run_transform(W, X, H0, float(np.float32(self.eps)),
                             n_iter=n_iter, precision=self.matmul_precision)
        H_np = H.cpu().numpy()
        if cell_perm is not None:
            H_np = H_np[:, np.argsort(cell_perm)]
        Hs = split_h(H_np, self.n_all_components)

        for i, covariate in enumerate(self.covariate_keys):
            adata.obsm[covariate] = Hs[i].T
            adata.varm[covariate] = deepcopy(self.matrices["Ws"][i])
        adata.obsm["ALPINE_embedding"] = Hs[-1].T
        adata.varm["ALPINE_weights"] = deepcopy(self.matrices["Ws"][-1])

    def _compute_best_iter(self, train_loss) -> int:
        """Kneedle elbow of log10(recon loss) (reference main.py:755-770)."""
        elbow = find_elbow(
            np.log10(np.asarray(train_loss, dtype=np.float64)),
            curve="convex",
            direction="decreasing",
            polynomial_degree=2,
        )
        if elbow is not None and elbow > 0:
            return int(elbow)
        warnings.warn("Kneedle elbow not found, using default max_iter=200")
        return 200

    # ----------------------------------------------------------- validation
    def _validate_init_args(self) -> None:
        """Constructor arg validation (reference main.py:322-381, identical
        messages)."""
        if self.n_components <= 0:
            raise ValueError("n_components must be greater than 0.")

        if not isinstance(self.n_covariate_components, list):
            raise TypeError("n_covariate_components must be a list.")
        for n in self.n_covariate_components:
            if not isinstance(n, int) or n < 0:
                raise ValueError(
                    "Each element in n_covariate_components must be a non-negative integer."
                )

        if not isinstance(self.lam, list):
            raise TypeError("lam must be in a list.")
        for lam in self.lam:
            if not isinstance(lam, float) or lam < 0:
                raise ValueError("Each element in lam must be a non-negative float.")

        if not isinstance(self.alpha_W, float) or self.alpha_W < 0:
            raise ValueError("alpha_W must be a non-negative float.")

        if not isinstance(self.orth_W, float) or self.orth_W < 0:
            raise ValueError("orth_W must be a non-negative float.")

        if (
            not isinstance(self.l1_ratio_W, float)
            or self.l1_ratio_W < 0
            or self.l1_ratio_W > 1
        ):
            raise ValueError("l1_ratio_W must be a float between 0 and 1.")

        if not isinstance(self.scale_needed, bool):
            raise TypeError("scale_needed must be a boolean.")

        if not isinstance(self.loss_type, str):
            raise TypeError("loss_type must be a string.")
        valid_loss_types = ["kl-divergence", "frobenius"]
        if self.loss_type not in valid_loss_types:
            raise ValueError(f"loss_type must be one of {valid_loss_types}.")

        if not isinstance(self.eps, float) or self.eps < 0:
            raise ValueError("eps must be a non-negative float.")

        if not isinstance(self.random_state, int) or self.random_state < 0:
            raise ValueError("random_state must be a non-negative integer.")

        if self.matmul_precision not in ("highest", "default"):
            raise ValueError("matmul_precision must be 'highest' or 'default'.")

        if self.data_dtype not in mu.DATA_DTYPES:
            choices = ", ".join(f"'{d}'" for d in mu.DATA_DTYPES)
            raise ValueError(f"data_dtype must be one of: {choices}.")

    def _validate_fit_args(
        self, adata, covariate_keys, batch_size, max_iter, sampling_method, verbose
    ) -> None:
        """Fit arg validation (reference main.py:383-434), with the
        reference's unreachable batch_size/max_iter checks made to fire."""
        if not is_anndata(adata):
            raise TypeError("adata must be an AnnData object.")

        if not (isinstance(adata.X, np.ndarray) or is_sparse_x(adata.X)):
            raise TypeError("adata.X must be a numpy array.")
        elif len(adata.X.shape) != 2:
            raise ValueError("adata.X must be a 2D numpy array.")
        elif not (x_min(adata.X) >= 0):  # NaN fails this like a negative
            raise ValueError("All elements in adata.X must be non-negative.")

        if not isinstance(covariate_keys, list):
            raise TypeError("covariate_keys must be a list.")
        elif not len(covariate_keys) == len(self.n_covariate_components):
            raise ValueError(
                "Length of covariate_keys must match length of n_covariate_components."
            )
        else:
            columns = obs_keys(adata.obs)
            for key in covariate_keys:
                if not isinstance(key, str):
                    raise TypeError("Each element in covariate_keys must be a string.")
                if key not in columns:
                    raise ValueError(f"Covariate key '{key}' not found in adata.obs.")
                if not obs_is_categorical(adata.obs, key):
                    raise TypeError(
                        f"Covariate '{key}' in adata.obs must be a categorical or object type variable."
                    )

        if batch_size is not None and (not isinstance(batch_size, int) or batch_size <= 0):
            raise TypeError("batch_size must be a positive integer.")

        if max_iter is not None and (not isinstance(max_iter, int) or max_iter <= 0):
            raise TypeError("max_iter must be a positive integer.")

        if not isinstance(sampling_method, str):
            raise TypeError("sampling_method must be a string.")
        if sampling_method not in ("random", "weighted", "weighted_fast",
                                   "tiled"):
            raise ValueError(
                f"Unknown sampling method: {sampling_method}. Only 'weighted', and 'random' are supported."
            )

        if not isinstance(verbose, bool):
            raise TypeError("verbose must be a boolean.")

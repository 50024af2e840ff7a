"""ComponentOptimizer — TPE Bayesian hyperparameter search with CV scoring.

The port's counterpart of ``alpine_tpu/optimize/optimizer.py`` (one
process).  It searches n_total_components (quniform), a lam per covariate
(qloguniform), orth_W / alpha_W / l1_ratio_W (uniform) and a split ratio
per block; each trial is scored by stratified K-fold cross-validation:
fit on the training folds, project the validation fold, cluster its
unguided embedding, and average ARI + homogeneity against every covariate
(low = covariate-free embedding = good; the score is minimized).  The
public API, validation messages, printed strings and the history
DataFrame's layout (with its descending-score sort) are the JAX package's.

What differs from the JAX package:
- the CV folds of a trial run one after another on the card from one
  upload of the stacked fold tensors (``optimize/batched.py``), where the
  JAX package vmaps them into one program;
- the kNN graph of each validation fold is searched on the card
  (``ops/knn.py``), the Leiden clustering runs in the port's copy of the
  native library (``native/``), and the folds, ARI and homogeneity are the
  port's copies of scikit-learn's (``optimize/metrics.py``): the search
  needs neither scikit-learn nor pandas, which only ``get_train_history``
  imports;
- a ``device`` that ``resolve_device`` rejects raises its error.

Over processes (``device=distributed.global_cell_mesh()``, one process a
card) the search runs the JAX package's trial-level parallel rounds
(``tpe.fmin_parallel``): every rank holds the full dataset, computes the
same ``n_processes`` suggestions a round from identical TPE state, fits
and scores one of them on its own card, and only the losses cross
processes, one float a trial over the gloo rows group
(``distributed.process_allgather_rows``), so the Trials stay identical
everywhere.  While ``max_iter`` detection is live the rounds are
replicated (size 1).  Digests of the inputs (constructor, unpickling), of
the search state (before the rounds) and of the trials (after them) make
a disagreement raise on every rank instead of forking the TPE streams.
The trial fits run on this rank's card, never over the mesh: CV folds are
host-side subsets of the full data, which a mesh fit would read as
per-rank shards.  The JAX package shards a trial's folds over the devices
of a process (``batched._fold_sharding``); a port process drives one
card, so the largest divisor of ``n_splits`` that fits is always 1 and
every fold runs on that card, as the JAX package places the folds of a
one-device process on its device.

On a ("genes", "cells") grid of processes
(``device=distributed.global_gene_cell_mesh(n_g, n_c)``) the search runs
the JAX package's single-process 2-D mesh search: every process passes
the full data and runs the same sequential ``fmin`` over the same losses
(no trial-parallel rounds).  A batched trial fits fold f whole on the card
of process f mod P (P the grid's processes) from that process's upload
of its own folds, padded to the width of the whole stack so that the
fold's bits are the single-device batched fold's; the owner scores its
folds and one host exchange of the per-fold scores gives every process
the same list.  A sequential trial (the first one under ``max_iter=None``,
every one with ``fold_batching=False``) fits each training fold as a grid
fit (each process passes its cell column's cells of the fold, with every
gene), projects the validation fold on the grid and gathers its
embedding rows for the fold's scorer; ``fit_the_best_param`` is a grid
fit of the full data.  Only embeddings (validation cells × k floats) and
scores cross processes, never a cell of X.
"""

from __future__ import annotations

import pickle
import zlib
from copy import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from alpine_tpu_torch.models.alpine import ALPINE
from alpine_tpu_torch.ops import mu
from alpine_tpu_torch.optimize import scoring
from alpine_tpu_torch.optimize.metrics import stratified_kfold
from alpine_tpu_torch.optimize.tpe import (
    STATUS_FAIL,
    STATUS_OK,
    Trials,
    fmin,
    fmin_parallel,
    hp,
    import_hyperopt_trials,
    load_foreign_pickle,
    tpe,
)
from alpine_tpu_torch.parallel import distributed as dist
from alpine_tpu_torch.parallel.mesh import (
    Placement, describe_device, resolve_device, restore_device,
)
from alpine_tpu_torch.utils.adata import (
    dtype_can_store, is_anndata, is_na, obs_column, obs_keys, suggest_data_dtype,
)
from alpine_tpu_torch.utils.encoder import FeatureEncoders

# hyperparameters drawn by every search, as (name, kwarg-of-range) pairs;
# ranges are validated and turned into TPE expressions table-driven
_UNIFORM_DIMS = ("orth_W", "alpha_W", "l1_ratio_W")


def allocate_components(
    total: int, ratios: Sequence[float], floors: Sequence[int]
) -> Tuple[int, List[int]]:
    """Partition a total component budget into guided blocks + unguided rest.

    Provisionally reserves ceil(total/2) for the guided side, hands covariate
    i its normalized-ratio share of that reserve (rounded, floored at
    ``floors[i]``), and leaves whatever remains of the *full* budget to the
    unguided block — which can therefore go small or negative when floors
    bite; the caller rejects such draws.  The reference's
    `_distribute_components` (optimization.py:153-176).
    """
    weights = np.asarray([float(r) for r in ratios], dtype=float)
    weights = weights / weights.sum()
    reserve = total - total // 2
    guided = [
        max(int(floor), int(round(reserve * w)))
        for floor, w in zip(floors, weights[:-1])
    ]
    return total - sum(guided), guided


@dataclass(frozen=True)
class SearchSpace:
    """Declarative search-space: owns range validation, the TPE expression
    tree, and decoding of raw TPE points into model hyperparameters."""

    n_total_components_range: Tuple[int, int]
    lam_range: Tuple[float, float]
    orth_W_range: Tuple[float, float]
    alpha_W_range: Tuple[float, float]
    l1_ratio_W_range: Tuple[float, float]
    n_covariates: int

    def validate(self) -> None:
        """The reference's messages (optimization.py:552-596)."""
        rng = self.n_total_components_range
        if not isinstance(rng, tuple) or len(rng) != 2:
            raise TypeError("n_total_components_range must be a tuple of two integers")
        lo, hi = rng
        if lo >= hi:
            raise ValueError(
                "n_total_components_range must be a tuple with the first element less than the second"
            )
        if lo < 2:
            raise ValueError(
                "n_total_components_range must be a tuple with the first element greater than or equal to 2"
            )

        for name in ("lam_range",) + tuple(f"{d}_range" for d in _UNIFORM_DIMS):
            rng = getattr(self, name)
            if not isinstance(rng, tuple) or len(rng) != 2:
                raise TypeError(f"{name} must be a tuple of two floats")
            if not all(isinstance(x, float) for x in rng):
                raise TypeError(f"All elements of {name} must be floats")
            if rng[0] >= rng[1]:
                raise ValueError(
                    f"{name} must be a tuple with the first element less than the second"
                )
        if self.l1_ratio_W_range[1] > 1.0:
            raise ValueError(
                "l1_ratio_W_range's second element must be less than or equal to 1.0"
            )

    def to_tpe(self) -> Dict:
        """TPE expression tree; the reference's labels and distributions
        (optimization.py:95-120): quniform component total, uniform
        regularizers, qloguniform lambdas, one uniform ratio per block."""
        tree = {
            "n_total_components": hp.quniform(
                "n_total_components", *self.n_total_components_range, 1
            ),
            "splits": [
                hp.uniform(f"split_{i}", 0, 1) for i in range(self.n_covariates + 1)
            ],
        }
        for dim in _UNIFORM_DIMS:
            tree[dim] = hp.uniform(dim, *getattr(self, f"{dim}_range"))
        lo, hi = self.lam_range
        for i in range(self.n_covariates):
            tree[f"lam_{i}"] = hp.qloguniform(f"lam_{i}", np.log(lo), np.log(hi), 1)
        return tree

    def structure_point(self, flat: Dict) -> Dict:
        """Lift a flat label->value dict (fmin's `best`) into the structured
        form `objective` receives (with the "splits" list)."""
        point = {k: flat[k] for k in ("n_total_components",) + _UNIFORM_DIMS}
        point["splits"] = [flat[f"split_{i}"] for i in range(self.n_covariates + 1)]
        for i in range(self.n_covariates):
            point[f"lam_{i}"] = flat[f"lam_{i}"]
        return point


def _column_labels(obs, key: str) -> np.ndarray:
    """One covariate as strings, a missing value as "nan"."""
    return np.array(["nan" if is_na(v) else str(v) for v in obs_column(obs, key)],
                    dtype=object)


class ComponentOptimizer:
    # validated at construction, so a bad value fails before the first
    # trial fit; "tiled" is the tile-permutation minibatch sampler
    _VALID_SAMPLING = ("random", "weighted", "weighted_fast", "tiled")

    def __init__(
        self,
        adata,
        covariate_keys: List[str],
        use_als: bool = False,
        loss_type: str = "kl-divergence",
        max_iter: Optional[int] = None,
        batch_size: Optional[int] = None,
        sampling_method: str = "random",
        device="auto",
        random_state: int = 42,
        fold_batching: bool = True,
        shape_bucket="auto",
        data_dtype: str = "auto",
    ):
        self._validate_init_args(
            adata, covariate_keys, loss_type, max_iter, batch_size, device, random_state
        )
        if not isinstance(fold_batching, bool):
            raise TypeError("fold_batching must be a boolean")
        if shape_bucket is not None and shape_bucket != "auto" and (
            not isinstance(shape_bucket, int) or shape_bucket < 1
        ):
            raise ValueError("shape_bucket must be 'auto', a positive integer, or None")
        if sampling_method not in self._VALID_SAMPLING:
            raise ValueError(
                f"Unknown sampling method: {sampling_method}. Only 'weighted', "
                "'random', 'weighted_fast', and 'tiled' are supported."
            )
        if sampling_method == "weighted_fast":
            # the model layer's contract: full-epoch joint mode; the fold
            # fits draw per-fold counts (mu.multinomial_counts)
            if batch_size is not None:
                raise ValueError(
                    "sampling_method='weighted_fast' supports full-epoch "
                    "joint mode only (batch_size=None); minibatch weighted "
                    "searches use sampling_method='weighted'."
                )
            if use_als:
                raise ValueError(
                    "weighted_fast requires joint mode (use_als=False)."
                )
        if sampling_method == "tiled":
            # the model layer's contract: a joint-mode minibatch sampler
            if batch_size is None:
                raise ValueError(
                    "sampling_method='tiled' is a minibatch mode: pass "
                    "batch_size; full-batch searches use "
                    "sampling_method='random'."
                )
            if use_als:
                raise ValueError(
                    "tiled sampling requires joint mode (use_als=False)."
                )
        if data_dtype not in mu.DATA_DTYPES:
            choices = ", ".join(f"'{d}'" for d in mu.DATA_DTYPES)
            raise ValueError(f"data_dtype must be one of: {choices}.")

        # where the trial fits run: this process's device, also on a cell
        # mesh (trial-level parallel rounds, _run_tpe); the grid, for a
        # grid's sequential fold fits and refit
        self._setup_execution(device)

        self.adata = adata.copy()
        self.covariate_keys: List[str] = covariate_keys
        self.use_als: bool = use_als
        self.loss_type: str = loss_type
        self.max_iter: Optional[int] = max_iter
        self.batch_size: Optional[int] = batch_size
        self.sampling_method: str = sampling_method
        self.device = device
        self.random_state: int = random_state
        # fit a trial's CV folds from the stacked fold tensors uploaded once
        # a search (optimize/batched.py); needs a frozen max_iter, so the
        # first trial under max_iter detection still runs sequentially
        self.fold_batching: bool = fold_batching
        # trial fits run at bucket-padded block shapes (phantom components
        # that stay exactly zero): "auto" pads to shared geometric levels
        # (mu.auto_bucket_blocks), an int rounds each block to a multiple,
        # None runs exact shapes; fit_the_best_param refits at exact shapes
        self.shape_bucket = shape_bucket
        # X storage dtype of every trial fit, resolved once from the full
        # dataset so every fold and trial shares one storage regime
        self.data_dtype: str = data_dtype
        self.data_dtype_: str = (
            suggest_data_dtype(self.adata.X) if data_dtype == "auto"
            else data_dtype
        )
        # an explicit integer dtype is validated here: the stacked fold
        # tensors are cast directly (batched.prepare_fold_data), where a
        # value out of range would wrap instead of raising ("auto" stores X
        # by construction, and a second scan of X costs seconds at 10^5
        # cells)
        if data_dtype != "auto" and not dtype_can_store(self.data_dtype_, self.adata.X):
            limit = np.iinfo(self.data_dtype_).max
            raise ValueError(
                f"data_dtype='{self.data_dtype_}' requires adata.X to hold "
                f"integer values in [0, {limit}]; use 'auto' to select a "
                "storage dtype that fits the data."
            )
        self.best_param: dict = {}

        # the TPE streams, and so the collectives, stay in step only if
        # every process built the optimizer from the same data and
        # settings: checked here, before any trial fit
        self._check_processes()

        self.max_iter_detect = self.max_iter is None
        if self.max_iter_detect:
            print(
                "Owing to max_iter being None, it will be determine by the "
                "average of the first n_splits iterations."
            )

    # ---------------------------------------------------- multi-process
    def _setup_execution(self, device) -> None:
        """Where this process's trial fits run: ``_local_device`` is the
        resolved device, or on a mesh this rank's own device
        (``Placement.device``), where the batched folds and the kNN run;
        ``_exec_device`` is the device of the sequential fold fits and the
        refit, the grid itself on a grid (``_grid`` its placement, else
        None), else ``_local_device``.  ``_mp_workers`` is the mesh's
        process count and ``_mp_rank`` this process's index, the row of
        its loss in a cell mesh's exchange."""
        placement = Placement(resolve_device(device))
        self._mp_workers, self._mp_rank = 1, 0
        self._local_device = self._exec_device = placement.device
        self._grid = None
        if not placement.is_sharded:
            return
        if placement.n_processes != dist.process_count():
            raise ValueError(
                "a multi-process search mesh must span every process "
                f"(mesh has {placement.n_processes} of "
                f"{dist.process_count()} processes) — the per-round score "
                "exchange is a global collective."
            )
        self._mp_workers = placement.n_processes
        self._mp_rank = dist.process_index()
        if placement.is_grid:
            self._grid, self._exec_device = placement, placement.mesh

    def _check_processes(self) -> None:
        """Over processes, the inputs' digest (``_assert_consistent_across_
        processes``), then on a grid the gene count against its gene axis
        (the grid fits' equal gene blocks; the digest compared the count,
        so every process raises together)."""
        if self._mp_workers > 1:
            self._assert_consistent_across_processes()
        if self._grid is not None:
            self._grid.check_gene_axis(self.adata.shape[1])

    def _assert_consistent_across_processes(self) -> None:
        """Raise on every process unless all of them built this optimizer
        from the same data and settings (digests of X, the covariate
        labels and the settings; the JAX package's)."""
        shape, sample_bytes, total, minimum, row_hash = ALPINE._x_fingerprint(
            self.adata.X)
        labels = "\x1f".join(
            "\x1e".join(_column_labels(self.adata.obs, key))
            for key in self.covariate_keys
        )
        settings = repr((
            self.covariate_keys, self.use_als, self.loss_type,
            self.max_iter, self.batch_size, self.sampling_method,
            self.random_state, self.fold_batching, self.shape_bucket,
            self.data_dtype_,
        ))
        dist.assert_same_across_processes(
            [
                float(zlib.crc32(repr(shape).encode())),
                float(zlib.crc32(sample_bytes)),
                total, minimum, row_hash,
                float(zlib.crc32(labels.encode())),
                float(zlib.crc32(settings.encode())),
            ],
            "ComponentOptimizer inputs (adata digest, covariate labels, "
            "settings)",
        )

    def _search_state_digest(self, additional_evals: int) -> List[float]:
        """Digest of everything the rounds depend on: the space's bounds
        (not only its labels), the contents of loaded trials, the floors
        and max_iter.  Same-shaped spaces or trial files with other values
        would fork the suggestion streams while every count still agreed."""
        space_repr = repr([(k, self.space[k]) for k in sorted(self.space)])
        trials_repr = repr([
            (
                t.get("tid"),
                sorted((k, tuple(v))
                       for k, v in t.get("misc", {}).get("vals", {}).items()),
                t.get("result", {}).get("loss"),
                t.get("result", {}).get("status"),
            )
            for t in self.trials.trials
        ])
        return [
            float(len(self.trials.trials)),
            float(additional_evals),
            float(self.n_splits),
            float(zlib.crc32(space_repr.encode())),
            float(zlib.crc32(trials_repr.encode())),
            float(zlib.crc32(repr((
                self.min_covariate_components,
                -1 if self.max_iter is None else self.max_iter,
            )).encode())),
        ]

    def _remote_trial_result(self, point: Dict, loss: float) -> Dict:
        """The record of a trial another process evaluated this round: all
        but the exchanged loss follows from the point, so every process
        appends the same record."""
        params = self._point_to_params(point)
        if params is None:
            return {"loss": np.inf, "status": STATUS_FAIL}
        record = dict(params)
        record["lam"] = list(record["lam"])
        # parallel rounds run only once max_iter is frozen (round_size in
        # _run_tpe), so the evaluating process recorded this same value
        record["max_iter"] = self.max_iter
        record["score"] = loss
        return {"loss": loss, "status": STATUS_OK, "params": record}

    # ------------------------------------------------------------- search
    def search_hyperparams(
        self,
        n_total_components_range: Tuple[int, int] = (10, 100),
        lam_range: Tuple[float, float] = (1.0, 1e4),
        orth_W_range: Tuple[float, float] = (0.0, 1.0),
        alpha_W_range: Tuple[float, float] = (0.0, 100.0),
        l1_ratio_W_range: Tuple[float, float] = (0.0, 1.0),
        min_covariate_components: Optional[List[int]] = None,
        n_splits: int = 3,
        max_evals: int = 100,
        trials_filename: Optional[str] = None,
    ):
        space = SearchSpace(
            n_total_components_range,
            lam_range,
            orth_W_range,
            alpha_W_range,
            l1_ratio_W_range,
            n_covariates=len(self.covariate_keys),
        )
        space.validate()
        self._check_cv_args(n_splits, max_evals)

        self.iter_records: List = []
        self.n_splits: int = n_splits
        self._search_space = space
        self.space = space.to_tpe()
        self.min_covariate_components = self._resolve_floors(min_covariate_components)

        if trials_filename is not None:
            self.load_trials(trials_filename)
        else:
            self.trials = Trials()

        return self._run_tpe(max_evals)

    def extend_training(self, extra_evals=50):
        """Continue the Bayesian optimization with more evaluations
        (reference optimization.py:289-333)."""
        if not hasattr(self, "trials"):
            raise RuntimeError("Please run bayesian_search() before extending training.")
        return copy(self._run_tpe(extra_evals))

    def _run_tpe(self, additional_evals: int):
        """Drive fmin for `additional_evals` more trials on top of whatever
        the Trials object already holds, then decode + record the best.

        Over a cell mesh: ``fmin_parallel``'s rounds of ``_mp_workers``
        trials, each process evaluating one and the losses exchanged; a
        round of one (every process evaluates it, no loss crosses) while
        max_iter detection is live, so every process replays the freeze.
        On a grid: the sequential ``fmin`` on every process, whose trials
        are the grid's fits and exchanged fold scores."""
        if self._mp_workers > 1:
            dist.assert_same_across_processes(
                self._search_state_digest(additional_evals),
                "search state (completed trials, max_evals, n_splits, "
                "space bounds, loaded trial contents, floors, max_iter)",
            )
        if self._mp_workers == 1 or self._grid is not None:
            best = fmin(
                self.objective,
                self.space,
                algo=tpe.suggest,
                max_evals=len(self.trials.trials) + additional_evals,
                trials=self.trials,
                rstate=np.random.default_rng(self.random_state),
            )
        else:
            best = fmin_parallel(
                self.objective,
                self.space,
                fn_remote=self._remote_trial_result,
                exchange_losses=lambda v: dist.process_allgather_rows(
                    np.asarray([v], np.float64)).ravel(),
                n_workers=self._mp_workers,
                worker_index=self._mp_rank,
                algo=tpe.suggest,
                max_evals=len(self.trials.trials) + additional_evals,
                trials=self.trials,
                rstate=np.random.default_rng(self.random_state),
                round_size=lambda: (1 if self.max_iter is None
                                    else self._mp_workers),
            )
        if self._mp_workers > 1:
            # the replicated rounds (on a grid, the whole search) exchange
            # no loss: a process whose fits drifted would fork the TPE
            # stream silently, so every loss and the frozen max_iter are
            # compared once the search is over
            dist.assert_same_across_processes(
                [float(t["result"].get("loss", np.inf))
                 for t in self.trials.trials]
                + [float(-1 if self.max_iter is None else self.max_iter)],
                "post-search trials (replicated rounds diverged across "
                "processes — per-device float drift in max_iter detection?)",
            )
        if best is None:
            raise RuntimeError("Hyperparameter optimization did not return any result.")
        return self._decode_best(best)

    def _decode_best(self, best: Dict) -> dict:
        """Flat fmin point -> self.best_param (the ALPINE ctor kwargs)."""
        params = self._point_to_params(self._search_space.structure_point(best))
        if params is None:  # fmin returns the best *successful* trial's
            # point, so an invalid allocation here cannot happen; guard anyway
            raise RuntimeError("Best trial decodes to an invalid component split.")
        self.best_param = dict(params, random_state=self.random_state)
        return self.best_param

    def _resolve_floors(self, min_covariate_components):
        """Per-covariate component floors; default = observed level count
        (missing values not counted)."""
        if min_covariate_components is None:
            return [
                len({v for v in obs_column(self.adata.obs, key) if not is_na(v)})
                for key in self.covariate_keys
            ]
        if isinstance(min_covariate_components, list):
            if len(min_covariate_components) != len(self.covariate_keys):
                raise ValueError(
                    "min_covariate_components should have the same length as the number of covariates."
                )
        if any(comp < 2 for comp in min_covariate_components):
            raise ValueError(
                "min_covariate_components should be greater than or equal to 2."
            )
        return min_covariate_components

    # ------------------------------------------------------------ trials
    def _point_to_params(self, point: Dict) -> Optional[dict]:
        """Decode one structured TPE point into model hyperparameters, or
        None when the component allocation is invalid (the reference's
        cond_1/cond_2 rejection, optimization.py:184-187)."""
        n_unguided, guided = allocate_components(
            int(point["n_total_components"]),
            [float(s) for s in point["splits"]],
            self.min_covariate_components,
        )
        if sum(guided) > n_unguided or any(n < 2 for n in guided):
            return None
        return {
            "n_components": n_unguided,
            "n_covariate_components": guided,
            "lam": [float(point[f"lam_{i}"]) for i in range(len(guided))],
            "orth_W": point["orth_W"],
            "alpha_W": point["alpha_W"],
            "l1_ratio_W": point["l1_ratio_W"],
        }

    def objective(self, space):
        """One trial.  Invalid component distributions fail with loss=inf
        (reference optimization.py:178-218)."""
        params = self._point_to_params(space)
        if params is None:
            return {"loss": np.inf, "status": STATUS_FAIL}

        score = self.calc_score(params)

        record = dict(params)
        record["lam"] = list(record["lam"])
        # the max_iter this trial ran: the frozen/user value, or — for the
        # trial that ran elbow detection — its last fold's elbow
        record["max_iter"] = (
            self.max_iter if self.max_iter is not None else self.iter_records[-1]
        )
        record["score"] = score

        # freeze max_iter to the mean elbow once one full CV round ran
        if self.max_iter is None and len(self.iter_records) >= self.n_splits:
            self.max_iter = int(sum(self.iter_records) / len(self.iter_records))

        return {"loss": score, "status": STATUS_OK, "params": record}

    # ------------------------------------------------------------ scoring
    def _stratified_folds(self):
        """Stratified K-fold index pairs over the joint covariate label
        ("_"-joined strings, reference optimization.py:229-241), a missing
        value read as "nan" (one stratification class)."""
        labels = _column_labels(self.adata.obs, self.covariate_keys[0])
        for key in self.covariate_keys[1:]:
            labels = labels + "_" + _column_labels(self.adata.obs, key)
        return stratified_kfold(labels, self.n_splits, shuffle=True,
                                random_state=self.random_state)

    def _scoring_device(self):
        """The card for the folds' kNN search (ops/knn.py), or None (the
        float64 host search) when the fits run on the CPU.  On a mesh it is
        this rank's card, where its trials' folds run."""
        dev = self._local_device
        return dev if dev.type != "cpu" else None

    def _leakage_score(self, embedding: np.ndarray, rows: np.ndarray) -> float:
        """Cluster a validation embedding and average ARI+homogeneity leakage
        across covariates (reference optimization.py:271-278)."""
        clusters = scoring.leiden(
            np.asarray(embedding), n_neighbors=15, resolution=1.0,
            seed=self.random_state, device=self._scoring_device(),
        )
        per_cov = [
            scoring.embedding_score(clusters, obs_column(self.adata.obs, key)[rows])
            for key in self.covariate_keys
        ]
        return float(np.mean(per_cov))

    def calc_score(self, args) -> float:
        """Stratified-CV covariate-leakage score for one hyperparameter
        setting (reference optimization.py:220-287): fit on train folds,
        transform validation, score the unguided embedding; mean over folds."""
        folds = self._stratified_folds()
        batched = self.fold_batching and self.max_iter is not None
        if self._grid is not None:
            return float(np.mean(self._grid_fold_scores(args, folds, batched)))
        if batched:
            embeddings = self._batched_fold_embeddings(args, folds)
        else:
            embeddings = (self._fit_one_fold(args, tr, va) for tr, va in folds)
        scores = [
            self._leakage_score(emb, val_idx)
            for (_, val_idx), emb in zip(folds, embeddings)
        ]
        return float(np.mean(scores))

    def _owned_folds(self, n_folds: int) -> List[int]:
        """The folds this process fits (batched) or scores on a grid: fold
        f belongs to process f mod P."""
        P = self._mp_workers
        return [f for f in range(n_folds) if f % P == self._mp_rank]

    def _grid_fold_scores(self, args, folds, batched: bool) -> List[float]:
        """Every fold's score, in fold order, the same on every process of
        a grid.  Batched: this process fits its folds whole on its card;
        sequential: every fold is a grid fit, its validation embedding
        gathered for its owner.  Each process scores the folds it owns,
        then one host exchange of a row of scores (NaN at the folds it
        does not own) and a failure flag gives every process the list.  A
        failure on one process raises on every one, after the exchange,
        so that no process waits in a collective its peers left."""
        n_folds = len(folds)
        owned = self._owned_folds(n_folds)
        row = np.full(n_folds + 1, np.nan)
        error = None
        try:
            if batched:
                embeddings = self._batched_fold_embeddings(args, folds) if owned else []
            else:
                embeddings = [self._fit_one_fold(args, tr, va) for tr, va in folds]
                embeddings = [embeddings[f] for f in owned]
            for f, emb in zip(owned, embeddings):
                row[f] = self._leakage_score(emb, folds[f][1])
            row[-1] = 0.0
        except Exception as exc:  # raised again below, on every process
            error = exc
            row[-1] = 1.0
        rows = dist.counted_allgather_rows(row, "fold scores")
        failed = np.flatnonzero(rows[:, -1] != 0).tolist()
        if error is not None:
            raise error
        if failed:
            raise RuntimeError(
                f"the fold fits or scores of process(es) {failed} failed; "
                "see their logs.")
        return [float(rows[f % self._mp_workers, f]) for f in range(n_folds)]

    def _bucketed(self, true_blocks):
        """Padded block shape for one trial's blocks (None = exact)."""
        if self.shape_bucket == "auto":
            return mu.auto_bucket_blocks(true_blocks)
        if self.shape_bucket:
            return mu.bucket_blocks(true_blocks, self.shape_bucket)
        return None

    def _fit_one_fold(self, args, train_idx, val_idx) -> np.ndarray:
        """Fit on one training fold, return the validation fold's unguided
        embedding (host-side).  On a grid the fit and the projection are
        grid fits: each process passes its cell column's cells of each fold
        (``distributed.mesh_cell_range``) with every gene, and the
        validation embedding's rows are gathered from every column."""
        if self._grid is not None:
            train_idx = self._column_cells(train_idx)
            val_all, val_idx = val_idx, self._column_cells(val_idx)
        train_adata = self.adata[train_idx].copy()
        val_adata = self.adata[val_idx].copy()

        true_blocks = tuple(args["n_covariate_components"]) + (args["n_components"],)
        model = ALPINE(
            use_als=self.use_als,
            random_state=self.random_state,
            loss_type=self.loss_type,
            device=self._exec_device,
            component_bucket=self._bucketed(true_blocks),
            data_dtype=self.data_dtype_,
            **args,
        )
        model.fit(
            adata=train_adata,
            covariate_keys=self.covariate_keys,
            max_iter=self.max_iter,
            batch_size=self.batch_size,
            sampling_method=self.sampling_method,
            verbose=False,
        )
        model.store_embeddings(train_adata)
        model.transform(val_adata)

        if self.max_iter_detect and self.max_iter is None:
            # only while elbow detection is live: after the freeze the fits
            # run at the frozen value and must not drift the recorded mean
            self.iter_records.append(model.max_iter)
        embedding = np.asarray(val_adata.obsm["ALPINE_embedding"])
        if self._grid is not None:
            embedding = dist.allgather_cell_rows(self._grid, embedding, len(val_all))
        return embedding

    def _column_cells(self, cells: np.ndarray) -> np.ndarray:
        """This process's cell column's run of ``cells`` on the grid."""
        lo, hi = dist.mesh_cell_range(self._exec_device, len(cells))
        return np.asarray(cells)[lo:hi]

    def _fold_data(self, folds):
        """The trial-invariant stacked fold tensors, built and uploaded once
        a search (they depend only on the data, folds, sampling mode and
        dtype)."""
        from alpine_tpu_torch.optimize.batched import prepare_fold_data

        key = (self.n_splits, self.sampling_method, self.data_dtype_)
        cached = getattr(self, "_fold_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        self._fold_cache = None  # the old tensors go before the new upload
        Ys = FeatureEncoders(self.covariate_keys).fit_transform(self.adata.obs)
        fd = prepare_fold_data(
            self.adata.X, Ys, folds,
            weighted=(self.sampling_method in ("weighted", "weighted_fast")),
            device=self._local_device,
            x_dtype=self.data_dtype_,
            tile=mu.DEFAULT_TILE if self.sampling_method == "tiled" else 0,
            shuffle_seed=self.random_state,
            # on a grid, the folds this process owns
            owned=None if self._grid is None else self._owned_folds(len(folds)),
        )
        self._fold_cache = (key, fd)
        return fd

    def _batched_fold_embeddings(self, args, folds) -> List[np.ndarray]:
        """The CV folds of this trial from the uploaded fold tensors
        (optimize/batched.py): one validation embedding per fold, of every
        fold (on a grid, of this process's folds)."""
        from alpine_tpu_torch.optimize.batched import batched_fold_embeddings

        true_blocks = tuple(args["n_covariate_components"]) + (args["n_components"],)
        blocks = self._bucketed(true_blocks) or true_blocks
        return batched_fold_embeddings(
            self._fold_data(folds),
            blocks=blocks,
            true_blocks=true_blocks,
            lam=[float(lam) for lam in args["lam"]],
            orth_w=float(args["orth_W"]),
            alpha_w=float(args["alpha_W"]),
            l1_ratio=float(args["l1_ratio_W"]),
            eps=1e-6,
            loss_kl=(self.loss_type == "kl-divergence"),
            use_als=self.use_als,
            batch_size=self.batch_size,
            weighted=(self.sampling_method in ("weighted", "weighted_fast")),
            weighted_counts=(self.sampling_method == "weighted_fast"),
            max_iter=self.max_iter,
            seed=self.random_state,
        )

    # -------------------------------------------------------- persistence
    def __getstate__(self):
        # no device tensors in a pickle: the fold cache is rebuilt on
        # demand; the execution device and the topology follow from
        # `device` and the live process group on load
        state = dict(self.__dict__)
        for key in ("_fold_cache", "_exec_device", "_local_device", "_grid",
                    "_mp_workers", "_mp_rank"):
            state.pop(key, None)
        state["device"] = describe_device(state.get("device"))
        return state

    def __setstate__(self, state):
        state["device"] = restore_device(state.get("device"))
        self.__dict__.update(state)
        self._setup_execution(self.device)
        # each rank unpickles its own copy (the data travels in the
        # pickle): a stale one would mix losses of other data
        self._check_processes()

    def save_trials(self, filename: str):
        """Pickle the current trials (reference optimization.py:335-345)."""
        with open(filename, "wb") as f:
            pickle.dump(self.trials, f)
        print(f"Trials saved to {filename}")

    def load_trials(self, filename: str):
        """Load pickled trials (reference optimization.py:347-357): this
        module's Trials pickles, the JAX package's, and, best-effort, real
        hyperopt Trials pickles (import shim in optimize/tpe.py)."""
        loaded = load_foreign_pickle(filename)
        if not isinstance(loaded, Trials):
            loaded = import_hyperopt_trials(loaded)
        self.trials = loaded
        print(f"Trials loaded from {filename}")

    # -------------------------------------------------------- inspection
    def get_hyperparameter(self, idx):
        """Hyperparameters of the idx-th row of the (score-sorted) history
        (reference optimization.py:359-385)."""
        wanted = self.get_train_history().iloc[idx]["tid"]
        for trial in self.trials.trials:
            if trial["tid"] == wanted:
                return trial["result"]["params"]

    #: get_train_history column layout (the reference's post-reorder frame,
    #: optimization.py:452-470): component columns first, then the scalar
    #: params in trial-record order, per-covariate lambdas last.
    @staticmethod
    def _history_row(params: Dict, loss: float, tid) -> Dict:
        guided = params["n_covariate_components"]
        row = {"n_components": params["n_components"]}
        row.update({f"n_covariate_components_{i}": k for i, k in enumerate(guided)})
        row["n_total_components"] = params["n_components"] + sum(guided)
        for key in ("orth_W", "alpha_W", "l1_ratio_W", "max_iter"):
            row[key] = params[key]
        row["score"] = loss
        row["tid"] = tid
        row.update({f"lam_{i}": v for i, v in enumerate(params["lam"])})
        return row

    def get_train_history(self):
        """pandas DataFrame of successful trials with expanded per-covariate
        columns, sorted by score DESCENDING (the reference's order, kept for
        API compatibility; the search itself minimizes —
        optimization.py:473-475 vs :216)."""
        import pandas as pd

        rows = [
            self._history_row(t["result"]["params"], t["result"]["loss"], t["tid"])
            for t in self.trials.trials
            if t.get("result", {}).get("status") == STATUS_OK
        ]
        if not rows:
            raise RuntimeError(
                "No successful trials recorded yet — run search_hyperparams "
                "(all trials may have failed the component-distribution check)."
            )
        frame = pd.DataFrame(rows)
        return frame.sort_values("score", ascending=False).reset_index(drop=True)

    def fit_the_best_param(self):
        """Refit on the full data with the best found parameters
        (reference optimization.py:479-510), random_state taken from
        best_param alone.

        After a search over a cell mesh every process holds the full data,
        so the refit runs on each rank's own card and is the same
        everywhere.  For a sharded final fit, pass ``best_param`` to
        ``ALPINE(device=distributed.global_cell_mesh(), **best_param)`` and
        fit each process's cells.  On a grid the refit is a grid fit of the
        full data: each process fits its cell column's cells
        (``distributed.mesh_cell_range``) with every gene; the model's W is
        whole on every process, its H holds the column's cells, and the
        embeddings go to a copy of those cells (``self.adata`` is left as
        it is)."""
        if not self.best_param:
            raise RuntimeError(
                "Please run bayesian_search() to find the best parameters first."
            )

        # the search is over: release the uploaded fold tensors (about
        # n_splits copies of the dataset on the card) before the full-data
        # fit uploads X again
        self.free_device_cache()
        model = ALPINE(
            **self.best_param,
            use_als=self.use_als,
            loss_type=self.loss_type,
            device=self._exec_device,
            data_dtype=self.data_dtype_,
        )
        adata = self.adata
        if self._grid is not None:
            adata = adata[self._column_cells(np.arange(adata.shape[0]))].copy()
        model.fit(
            adata=adata,
            covariate_keys=self.covariate_keys,
            max_iter=self.max_iter,
            batch_size=self.batch_size,
            verbose=False,
        )
        return model

    def free_device_cache(self) -> None:
        """Release the stacked CV fold tensors kept on the device across
        trials (about n_splits copies of the dataset).  They are rebuilt on
        demand if another search runs."""
        self._fold_cache = None

    # -------------------------------------------------------- validation
    @staticmethod
    def _validate_init_args(
        adata, covariate_keys, loss_type, max_iter, batch_size, device, random_state
    ) -> None:
        """(reference optimization.py:512-550, identical messages)"""
        if not is_anndata(adata):
            raise TypeError("adata must be an instance of AnnData")

        if not isinstance(covariate_keys, list):
            raise TypeError("covariate_keys must be a list")
        if not all(isinstance(key, str) for key in covariate_keys):
            raise TypeError("All covariate_keys must be strings")
        columns = obs_keys(adata.obs)
        if not all(key in columns for key in covariate_keys):
            raise ValueError("All covariate_keys must be present in adata.obs")

        if loss_type not in ("kl-divergence", "frobenius"):
            raise ValueError("loss_type must be either 'kl-divergence' or 'frobenius'")

        for name, value in (("max_iter", max_iter), ("batch_size", batch_size)):
            if value is not None and (not isinstance(value, int) or value < 0):
                raise ValueError(f"{name} must be a non-negative integer")

        if not isinstance(random_state, int):
            raise TypeError("random_state must be an integer")

    @staticmethod
    def _check_cv_args(n_splits, max_evals) -> None:
        """(reference optimization.py:598-604, identical messages)"""
        if not isinstance(n_splits, int):
            raise TypeError("n_splits must be an integer")
        if n_splits < 2:
            raise ValueError("n_splits must be greater than or equal to 2")
        if not isinstance(max_evals, int) or max_evals <= 0:
            raise ValueError("max_evals must be a positive integer")

"""The ALPINE estimator on PyTorch/CUDA — the port's main path.

Counterpart of ``alpine_tpu/models/alpine.py`` for single-device fits and
their transform: same constructor, same validation messages, same
``obsm``/``varm``/``layers`` keys.  ``fit`` runs the fused fit loop
(``ops/mu.py``), which launches one CUDA kernel per iteration on the card
and runs each kernel's plain PyTorch version on the CPU; with
``use_als=True`` it runs block-cyclic ALS steps, whose X passes are the
kernels ``hxt`` and ``wtx``.  ``transform`` runs the fused projection
kernel.  ``sampling_method`` is "random" (full batch, or minibatches of
``batch_size`` cells from a permutation an epoch), "weighted" (balanced
draws with replacement, gathered in batches), "weighted_fast" (the
balanced draws as per-cell counts over a group-sorted cell axis; joint
full-epoch mode only) or "tiled" (minibatches of whole 128-cell tiles of
a seeded shuffle of the cells); the gathered steps run their X products
through ``hxt`` and ``wtx``.  ``component_bucket`` pads the blocks with
phantom components that stay zero (the stored matrices keep their true
sizes), ``fit(n_restarts=k)`` runs k fits from different inits one after
another and keeps the one with the lowest final loss, and
``fit(checkpoint_dir=...)`` runs the fit in chunks of ``checkpoint_every``
iterations with a snapshot after each, resuming from a matching snapshot.
A fit keeps its device copy of X, and a ``transform`` of the same data
reuses it.  ``verbose=True`` shows the JAX package's progress bar.
``get_normalized_expression`` exports corrected expression blockwise;
``save``/``load`` read and write the JAX package's files
(``io/checkpoint.py``).

``device=distributed.global_cell_mesh()`` fits over processes, one a
device: each process passes its own cells as ``adata``, its fit and
transform compute on those cells (``mu.fit_scan`` with the mesh's process
group: all-reduces of the small statistics only) and write its rows of
``obsm``, while W, the Bs and the loss history are replicated.  Every fit
mode runs so but the JAX package's refusal of ``n_restarts > 1``:
full-batch joint and ALS fits give the single-process trajectory,
weighted_fast too (every process draws the global balanced draw and
counts its own cells), random joint minibatch and tiled fits sample each
process's own cells (stratified by process, as in the JAX package), and
``checkpoint_dir`` snapshots each process's state in a file of its own.
ALS minibatch and gathered "weighted" fits (joint or ALS) take the global
draw: every process draws the single-device epoch (a permutation, or the
balanced draw with replacement over the global probabilities, which one
host gather of the cells' joint-label codes gives every process) and
runs its share of every batch, so the trajectory is the single-process
one.  For "weighted" this departs by design from the JAX package's 1-D
mesh, which pre-shuffles the cells globally and draws within each shard:
here no cell crosses processes, and the draw is the single-device one
(the JAX package's 2-D mesh semantics).

``device=distributed.global_gene_cell_mesh(n_g, n_c)`` fits over a grid of
processes: the process at (gi, ci) passes the cells of run ci with every
gene (``distributed.mesh_cell_range``), moves only its block of X (gene
block gi, which the gene count must divide evenly) to its card and fits
its W rows and H columns, summing each iteration's statistics over its
gene row and its cell column (``mu.fit_scan`` with both groups: P1/P2 on
the block, never K1/K4).  Full-batch joint, ALS and weighted_fast fits run
so, and the minibatch fits too (random, ALS and "weighted"): every
process draws the global epoch (seeded as a single-device fit seeds it)
and keeps its column's cells of every batch.  ``checkpoint_dir``
snapshots each process's W rows and H columns in a file of its own,
whose key holds the grid's shape, the process's place and its gene rows;
the processes agree on the resume.  After the fit one gather of W's rows
gives every process the whole W.  A transform sums 2WᵀX and WᵀW over the gene blocks and runs
K3 on the process's columns.  On a grid the JAX package's refusals stay
(restarts, tiled).  A sharded fit with ``max_iter=None`` takes the
coordinator's elbow on every process.

Random draws come from ``torch.Generator``s seeded with ``random_state``
through ``draw_init``, ``draw_restart_init``, ``draw_counts_stream``,
``draw_cells_stream``, ``draw_tiles_stream`` and ``draw_transform_h0``;
they differ from the JAX package's ``jax.random`` streams by design.  The
tiled pre-shuffle is numpy's, as in the JAX package.  On a cell mesh the
random joint minibatch's cell stream and the tile stream of the process at
mesh position s > 0 take s as a word of their seeds; the counts stream
does not (every process draws the global draw), nor does the cell stream
of a global-draw fit (a grid's, ALS minibatch, "weighted").
"""

from __future__ import annotations

import hashlib
import os
import warnings
from copy import copy, deepcopy
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from alpine_tpu_torch import profiling
from alpine_tpu_torch.io.checkpoint import (
    FitCheckpointer, check_backend, load_model, save_model,
)
from alpine_tpu_torch.models.state import AlpineMatrices, split_h, split_w
from alpine_tpu_torch.ops import mu
from alpine_tpu_torch.ops.elbow import find_elbow
from alpine_tpu_torch.parallel.mesh import (
    Placement, describe_device, resolve_device, restore_device,
)
from alpine_tpu_torch.utils.adata import (
    as_compressed, dense_x, dtype_can_store, is_anndata, is_sparse_x,
    obs_is_categorical, obs_keys, suggest_data_dtype, x_min,
)
from alpine_tpu_torch.utils.encoder import FeatureEncoders
from alpine_tpu_torch.utils.sampling import (
    balanced_group_tables, balanced_sample_probabilities, check_group_sizes,
    joint_label_codes, joint_label_ids, window_group_tables,
)
from alpine_tpu_torch.utils.single_cell import library_size_factors

Float32Array = np.ndarray

# salts of the transform H0, the weighted_fast count, the minibatch cell
# and the tile streams, and of restarts and checkpoint chunks, so no two
# streams coincide
_TRANSFORM_SALT = 0x7472616E  # "tran"
_COUNTS_SALT = 0x636E7473  # "cnts"
_CELLS_SALT = 0x63656C6C  # "cell": minibatch permutations and weighted draws
_TILES_SALT = 0x74696C65  # "tile": tiled permutations
_RESTART_SALT = 0x72737472  # "rstr"
_CHUNK_SALT = 0x63686E6B  # "chnk"
_SHARD_SALT = 0x73686172  # "shar"


def _draw_seed(random_state: int, salt: int, t: int, restart: int = 0,
               chunk: Optional[int] = None, shard: int = 0) -> int:
    """The generator seed of draw t of a stream, from (random_state, salt,
    t): restart r > 0, checkpoint chunk c and mesh position s > 0 each add
    their own words, so restart 0 of a fit without checkpoints draws as a
    single fit does, and so does the process at mesh position 0 (a tiled
    fit's cell shuffle is not such a stream: see ``ALPINE.fit``)."""
    words = [random_state, salt]
    if restart:
        words += [_RESTART_SALT, restart]
    if chunk is not None:
        words += [_CHUNK_SALT, chunk]
    if shard:
        words += [_SHARD_SALT, shard]
    seq = np.random.SeedSequence(words + [t])
    return int(seq.generate_state(1, np.uint64)[0] >> 1)


def draw_init(cfg: mu.MUConfig, n_genes: int, random_state: int, eps: float,
              device):
    """The fit's initial (W0, H0, Bs0), drawn from ``random_state``."""
    gen = torch.Generator().manual_seed(random_state)
    return mu.init_matrices(cfg, n_genes, gen, eps, device)


def draw_restart_init(cfg: mu.MUConfig, n_genes: int, random_state: int,
                      restart: int, eps: float, device):
    """Restart ``restart``'s initial (W0, H0, Bs0) (restart 0 is
    ``draw_init``'s)."""
    gen = torch.Generator().manual_seed(_draw_seed(random_state, _RESTART_SALT, restart))
    return mu.init_matrices(cfg, n_genes, gen, eps, device)


def draw_transform_h0(n_components: int, n_cells: int, random_state: int,
                      eps: float, device) -> torch.Tensor:
    """The transform's initial H, drawn from a stream separate from the fit's."""
    gen = torch.Generator().manual_seed(random_state + _TRANSFORM_SALT)
    H0 = torch.rand((n_components, n_cells), generator=gen, dtype=torch.float32)
    return torch.clamp(H0, min=eps).to(device)


def draw_counts_stream(tables, n_cells: int, random_state: int, device,
                       restart: int = 0, chunk: Optional[int] = None,
                       n_out: Optional[int] = None):
    """weighted_fast's draws: returns ``draw(t)``, epoch t's balanced draw
    as a (n_cells,) float32 count tensor on ``device``.  ``tables`` are the
    (start, sizes) group tables of the group-sorted cell axis, on
    ``device``, or on a cell mesh this process's window tables, whose draw
    counts its ``n_out`` cells (``mu.grouped_balanced_counts``).  Draw t
    comes from a device generator seeded from (random_state, salt,
    restart, chunk, t), so it depends on t alone, and not on the
    process."""
    gen = torch.Generator(device=device)

    def draw(t: int) -> torch.Tensor:
        gen.manual_seed(_draw_seed(random_state, _COUNTS_SALT, t, restart, chunk))
        return mu.grouped_balanced_counts(gen, n_cells, tables, n_out)

    return draw


def draw_cells_stream(n_cells: int, random_state: int, device, probs=None,
                      restart: int = 0, chunk: Optional[int] = None,
                      shard: int = 0):
    """The cell draws of minibatch and gathered weighted fits: returns
    ``draw(t)``, epoch t's (n_cells,) int64 cell indices on ``device`` — a
    permutation, or with ``probs`` (the balanced per-cell probabilities,
    host numpy) n draws with replacement by inverse CDF.  Draw t comes
    from a device generator seeded from (random_state, salt, restart,
    chunk, shard, t), so it depends on t alone (on a cell mesh, ``shard``
    is this process's position and ``n_cells`` its cell count)."""
    gen = torch.Generator(device=device)
    cdf = None
    if probs is not None:
        cdf = torch.from_numpy(np.cumsum(probs, dtype=np.float64)).to(device)

    def draw(t: int) -> torch.Tensor:
        gen.manual_seed(_draw_seed(random_state, _CELLS_SALT, t, restart, chunk,
                                   shard))
        if cdf is None:
            return torch.randperm(n_cells, generator=gen, device=device)
        u = torch.rand(n_cells, generator=gen, dtype=torch.float64,
                       device=device) * cdf[-1]
        return torch.clamp(torch.searchsorted(cdf, u, right=True),
                           max=n_cells - 1)

    return draw


def draw_tiles_stream(n_tiles: int, random_state: int, device,
                      restart: int = 0, chunk: Optional[int] = None,
                      shard: int = 0):
    """The tile draws of tiled fits: returns ``draw(t)``, epoch t's
    permutation of the n_tiles tiles (int64, on ``device``), from a device
    generator seeded from (random_state, salt, restart, chunk, shard, t)
    (``shard`` as in ``draw_cells_stream``)."""
    gen = torch.Generator(device=device)

    def draw(t: int) -> torch.Tensor:
        gen.manual_seed(_draw_seed(random_state, _TILES_SALT, t, restart, chunk,
                                   shard))
        return torch.randperm(n_tiles, generator=gen, device=device)

    return draw


def _digest(blob: bytes) -> int:
    """A 48-bit digest of ``blob`` (exact as a float64 in the host
    gathers)."""
    return int.from_bytes(hashlib.sha256(blob).digest()[:6], "big")


def _no_x_cache() -> bool:
    """ALPINE_TPU_NO_X_CACHE (the JAX package's switch): unset, '', '0' or
    'false' mean the device-X cache is on."""
    return os.environ.get("ALPINE_TPU_NO_X_CACHE", "").lower() not in (
        "", "0", "false")


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
        # blocks padded past their true sizes with phantom components that
        # start and stay zero: int N rounds each block up to a multiple of
        # N, a tuple gives each padded size; the stored matrices keep the
        # true sizes
        if isinstance(component_bucket, (tuple, list)):
            component_bucket = tuple(int(b) for b in component_bucket)
            true = tuple(n_covariate_components) + (n_components,)
            if len(component_bucket) != len(true) or any(
                b < t for b, t in zip(component_bucket, true)
            ):
                raise ValueError(
                    "component_bucket tuple must give a padded size >= the "
                    "true size for every block (covariates first, unguided "
                    "last)."
                )
        elif component_bucket is not None and (
            not isinstance(component_bucket, int) or component_bucket < 1
        ):
            raise ValueError(
                "component_bucket must be a positive integer, a tuple of "
                "padded block sizes, or None."
            )
        self.component_bucket = component_bucket

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
        # 153-236)
        if checkpoint_dir is not None and not isinstance(checkpoint_dir, str):
            raise TypeError("checkpoint_dir must be a string or None.")
        if not isinstance(checkpoint_every, int) or checkpoint_every <= 0:
            raise ValueError("checkpoint_every must be a positive integer.")
        if not isinstance(n_restarts, int) or n_restarts <= 0:
            raise ValueError("n_restarts must be a positive integer.")
        if n_restarts > 1 and checkpoint_dir is not None:
            raise ValueError("n_restarts > 1 is incompatible with checkpointing.")
        placement = Placement(self.device)
        sharded, grid = placement.is_sharded, placement.is_grid
        if n_restarts > 1 and sharded:
            # before the upload, as the reference refuses it
            raise ValueError(
                "n_restarts > 1 is not supported with a sharded (Mesh) device."
            )
        if checkpoint_dir is not None and checkpoint_backend not in ("npz", "orbax"):
            raise ValueError("checkpoint backend must be 'npz' or 'orbax'")
        if checkpoint_dir is not None:
            check_backend(checkpoint_backend)  # before the upload
        if sampling_method in ("weighted", "weighted_fast") and not covariate_keys:
            raise ValueError(
                "weighted sampling requires at least one covariate "
                "(balancing is over the joint covariate labels)."
            )
        if sampling_method == "tiled" and (self.use_als or grid):
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
        if sampling_method == "tiled" and batch_size is None:
            raise ValueError(
                "sampling_method='tiled' is a minibatch mode: pass "
                "batch_size (< n_cells); full-batch fits use "
                "sampling_method='random'."
            )

        # (genes x cells) layout, as in the reference (main.py:104); on a
        # cell mesh this process's cells
        X: Float32Array = dense_x(adata.X).T
        n_local = X.shape[1]
        resolved_dtype = (suggest_data_dtype(adata.X) if self.data_dtype == "auto"
                          else self.data_dtype)
        fe = FeatureEncoders(covariate_keys)
        Ys = [y.T.copy() for y in fe.fit_transform(adata.obs)]
        # the device-X cache's key, and on a grid the digest of the cells
        # that the processes of a cell column must share
        x_fp = self._x_fingerprint(adata.X) if grid or not _no_x_cache() else None
        # the global cell count, the cell counts of the mesh's processes
        # and this process's position and first cell
        n_sample, chunk_sizes, shard, offset = n_local, None, 0, 0
        if sharded:
            resolved_dtype, chunk_sizes = self._agree_fit_inputs(
                placement, X, Ys, fe, covariate_keys, resolved_dtype, x_fp,
                max_iter=max_iter, batch_size=batch_size,
                sampling_method=sampling_method, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every)
            n_sample = int(chunk_sizes.sum())
            shard = placement.process_chunk_index
            offset = int(chunk_sizes[:shard].sum())
        if sampling_method == "tiled" and batch_size >= n_sample:
            raise ValueError(
                f"sampling_method='tiled' is a minibatch mode: batch_size "
                f"({batch_size}) must be < n_cells ({n_sample}); full-batch "
                f"fits use sampling_method='random'."
            )
        if (sampling_method == "weighted_fast" and batch_size is not None
                and batch_size < n_sample):
            raise ValueError(
                f"sampling_method='weighted_fast' supports full-epoch joint "
                f"mode only: batch_size ({batch_size}) must be None or >= "
                f"n_cells ({n_sample}); minibatch weighted fits use "
                f"sampling_method='weighted'."
            )
        coordinator = shard == 0 and placement.gene_index == 0
        # over processes the minibatch fits of a grid and the ALS minibatch
        # and gathered weighted fits of either mesh draw the single-device
        # epoch, and each process runs its share of every batch
        global_draw = sharded and (grid or sampling_method == "weighted" or (
            self.use_als and batch_size is not None and batch_size < n_sample))

        # commit estimator state only after the encoders fitted
        self.fe = fe
        self.data_dtype_ = resolved_dtype
        if verbose and coordinator and self.data_dtype == "auto":
            print(f"ALPINE fit: data_dtype='auto' resolved to '{resolved_dtype}'")
        self.feature_names: List[str] = list(adata.var_names.tolist())
        self.n_features: int = adata.shape[1]
        self.covariate_keys: List[str] = covariate_keys
        self.sampling_method: str = sampling_method
        self.verbose: bool = verbose
        self.batch_size: int = batch_size if batch_size is not None else n_sample

        dev = placement.device
        rs = self.random_state
        tiled = sampling_method == "tiled"
        # the largest process's cell count (a tiled fit's common width)
        widest = n_local if chunk_sizes is None else int(chunk_sizes.max())
        # tiled fits permute whole tiles, so the cell axis is zero-padded to
        # a tile multiple (zero columns are fixed points of every update);
        # on a cell mesh every process pads to the widest one's multiple,
        # so all of them draw batches of the same tiles
        pad = -(-widest // mu.DEFAULT_TILE) * mu.DEFAULT_TILE - n_local if tiled else 0
        # this process's gene rows (on a grid, its block; else every gene)
        g0, g1 = placement.gene_range(self.n_features)
        # X in its storage dtype first, so the pad and the permutation below
        # copy the narrow X (200 MB of int8 at 100k x 2,000, not 800 MB)
        Xh = self._cast_x_host(X[g0:g1])
        if pad:
            Xh = torch.nn.functional.pad(Xh, (0, pad))
        Xd = Xh.to(dev)
        del Xh
        Ysd = [torch.from_numpy(np.pad(y, ((0, 0), (0, pad)))).to(dev) for y in Ys]
        cell_perm = tables = probs = h0_cols = None
        if sampling_method == "weighted" and sharded:
            # the global probabilities, in the global cell order
            from alpine_tpu_torch.parallel import distributed as dist

            probs = balanced_sample_probabilities(dist.allgather_cell_codes(
                placement, joint_label_codes(Ys), chunk_sizes))
        elif sampling_method == "weighted":
            probs = balanced_sample_probabilities(joint_label_ids(Ys))
        if sampling_method == "weighted_fast" and sharded:
            cell_perm, h0_cols, tables = self._sharded_group_tables(
                placement, Ys, dev)
        elif sampling_method == "weighted_fast":
            # group-sort the cells (stable) for the grouped sampler; H0
            # pairs positionally with the sorted cells and H is un-sorted
            # on extraction
            cell_perm, start, sizes = balanced_group_tables(joint_label_ids(Ys))
            tables = (torch.from_numpy(start).to(dev),
                      torch.from_numpy(sizes).to(dev))
        elif tiled:
            # one seeded shuffle of the cells (numpy's, as the JAX package
            # draws it; undone on extraction): cells adjacent in storage
            # (usually sorted by sample) would otherwise always share a
            # tile, and a tile would be a cluster rather than a subsample.
            # On a cell mesh each process shuffles its own cells (tiles
            # are drawn from a process's cells anyway), seeded with its
            # position as the JAX package seeds it: position 0's seed is
            # (rs, 0), so unlike the _draw_seed streams a mesh of one
            # process shuffles otherwise than a single-device fit
            cell_perm = np.random.default_rng(
                (rs, shard) if sharded else rs).permutation(n_local)
        if cell_perm is not None:
            perm = torch.from_numpy(np.concatenate(
                [cell_perm, np.arange(n_local, n_local + pad)])).to(dev)
            Xd = Xd[:, perm]
            Ysd = [y[:, perm] for y in Ysd]
        # the device X of a same-data transform; installed after the fit
        new_x_cache = (None if _no_x_cache() else
                       (Xd, x_fp, n_local, cell_perm, pad))
        hyper = self._hyper()
        true_blocks = tuple(self.n_all_components)
        self.timings_: Dict[str, float] = {}
        timer = profiling.StepTimer(self.timings_)
        # no callback without verbose (the fit loop then never syncs), and
        # one bar a sharded fit, the coordinator's
        progress = _Progress(max_iter or 200) if verbose and coordinator else None

        def init(cfg, restart=0):
            if restart:
                W0, H0, Bs0 = draw_restart_init(cfg, self.n_features, rs, restart,
                                                self.eps, dev)
            else:
                W0, H0, Bs0 = draw_init(cfg, self.n_features, rs, self.eps, dev)
            if self.component_bucket:
                # phantom components start (and stay) exactly zero
                W0, H0, Bs0 = mu.mask_block_padding(cfg.blocks, true_blocks,
                                                    W0, H0, Bs0)
            if grid:
                # the global W0's rows of this process's gene block
                W0 = W0[g0:g1].contiguous()
            if h0_cols is not None:
                # weighted_fast: the single-process fit pairs group-sorted
                # position q with H0 column q, so this process takes the
                # columns of its cells' global sorted positions
                H0 = H0[:, torch.from_numpy(h0_cols).to(dev)]
            elif sharded:
                # every process draws the global H0 and keeps its own
                # columns, so the trajectory is the single-process one
                H0 = H0[:, offset:offset + n_local].contiguous()
            return W0, H0, Bs0

        def fit_from(cfg, W0, H0, Bs0, restart=0, chunk=None, report=progress):
            key = dict(restart=restart, chunk=chunk)
            # on a mesh this process's window of the global count draw; the
            # global cell draw, of which it keeps its cells' share; else on
            # a cell mesh its own cells' and tiles' streams
            draw_key = dict(key, n_out=n_local) if sharded else key
            cell_range = None
            if global_draw:
                cell_range = (offset, offset + n_local)
            elif sharded:
                key["shard"] = shard
            draw = (None if tables is None else
                    draw_counts_stream(tables, n_sample, rs, dev, **draw_key))
            if cfg.tiled:
                cells = draw_tiles_stream(Xd.shape[1] // cfg.tile, rs, dev, **key)
            elif cfg.minibatch:
                cells = draw_cells_stream(n_sample if global_draw else n_local,
                                          rs, dev, probs, **key)
            else:
                cells = None
            return mu.fit_scan(cfg, W0, H0, Bs0, Xd, Ysd, hyper, draw_counts=draw,
                               progress=report, draw_cells=cells,
                               group=placement.group,
                               gene_group=placement.gene_group,
                               cell_range=cell_range)

        def run(n_iter: int):
            cfg = self._make_cfg(Ys, n_sample, n_iter)
            if n_restarts == 1:
                return cfg, fit_from(cfg, *init(cfg))
            # restarts one after another on the same device X, without
            # progress; the lowest final total loss wins (NaN never does,
            # unless every restart is NaN: then restart 0), and only the
            # best state is kept while the others run
            best, best_loss = None, float("nan")
            for r in range(n_restarts):
                out = fit_from(cfg, *init(cfg, r), restart=r, report=None)
                final = float(out[3][-1, 0])
                if best is None or final < best_loss or (
                        np.isnan(best_loss) and not np.isnan(final)):
                    best, best_loss = out, final
                del out
            return cfg, best

        def run_checkpointed(n_iter: int):
            """The fit in chunks of checkpoint_every iterations, with a
            snapshot after each; a matching snapshot is resumed.  Chunk c's
            sampled streams are keyed on c, so a resumed fit draws what the
            uninterrupted one did."""
            ckpt = FitCheckpointer(checkpoint_dir, config_key=self._checkpoint_key(
                Ys, n_sample, n_iter, checkpoint_every, placement, chunk_sizes))
            cfg = self._make_cfg(Ys, n_sample, n_iter)
            W, H, Bs = init(cfg)
            done, parts = 0, []
            resumed = ckpt.load()
            if sharded:
                # each process resumes its own snapshot (its H columns, on a
                # grid its W rows too; the Bs and the losses are
                # replicated): unequal iterations would put the chunk loops,
                # and so the collectives, out of step, so every process of
                # the mesh compares them and all restart together where
                # they differ
                from alpine_tpu_torch.parallel import distributed as dist

                ranks_done = dist.process_allgather_rows(np.asarray(
                    [-1 if resumed is None else int(resumed[0])], np.int64))
                if not (ranks_done == ranks_done[0]).all():
                    if coordinator:
                        warnings.warn(
                            "fit checkpoints disagree across processes "
                            f"(iterations {sorted(set(ranks_done.ravel().tolist()))}); "
                            "restarting the fit from scratch on every rank.")
                    resumed = None
            if resumed is not None:
                done, W_np, H_np, Bs_np, losses0 = resumed
                to = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
                W, H, Bs = to(W_np), to(H_np), tuple(to(b) for b in Bs_np)
                parts.append(np.asarray(losses0, np.float32))
                if verbose and coordinator:
                    print(f"ALPINE fit: resumed from iteration {done}")
            chunk = done // checkpoint_every
            while done < n_iter:
                size = min(checkpoint_every, n_iter - done)
                cfg = self._make_cfg(Ys, n_sample, size)
                # the bar's position stays global across chunks
                report = (None if progress is None else
                          lambda d, loss, base=done: progress(base + d, loss))
                W, H, Bs, L = fit_from(cfg, W, H, Bs, chunk=chunk, report=report)
                parts.append(L.cpu().numpy())
                done += size
                chunk += 1
                ckpt.save(done, W.cpu().numpy(), H.cpu().numpy(),
                          [b.cpu().numpy() for b in Bs], np.concatenate(parts))
            ckpt.clear()
            return cfg, (W, H, Bs, torch.from_numpy(np.concatenate(parts)))

        try:
            if max_iter is None:
                # warm-up elbow search (reference main.py:114-131) on the
                # loss history, replicated on a mesh
                with timer.phase("warmup"):
                    _, (_, _, _, losses) = run(200)
                    recon = losses[:, 1].cpu().numpy()
                self.max_iter: int = self._compute_best_iter(recon)
                if sharded:
                    self.max_iter = self._agree_max_iter(self.max_iter, coordinator)
                if progress is not None:
                    progress.reset(self.max_iter)
            else:
                self.max_iter = max_iter
            with timer.phase("fit"):
                if checkpoint_dir is not None:
                    cfg, (Wd, Hd, Bsd, losses) = run_checkpointed(self.max_iter)
                else:
                    cfg, (Wd, Hd, Bsd, losses) = run(self.max_iter)
                if grid:
                    # every process takes the whole W: its cell column's
                    # gene blocks, in gene order (before the scaling, which
                    # reads W's column sums over every gene)
                    from alpine_tpu_torch.parallel import distributed as dist

                    Wd = torch.from_numpy(dist.allgather_gene_blocks(
                        placement, Wd.cpu().numpy())).to(dev)
                if self.scale_needed:
                    Wd, Hd, Bsd = mu.scale_matrices(cfg.blocks, Wd, Hd, Bsd)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        finally:
            if progress is not None:
                progress.close()

        self.loss_history_ = losses.cpu().numpy()
        if verbose and coordinator and len(self.loss_history_):
            print(f"ALPINE fit: {self.max_iter} iterations, final objective "
                  f"loss {self.loss_history_[-1, 0]:.6g}")

        # on a cell mesh H holds this process's cells; W, Bs and the losses
        # are replicated
        W_np, H_np = Wd.cpu().numpy(), Hd.cpu().numpy()
        Bs_np = [b.cpu().numpy() for b in Bsd]
        if cell_perm is not None:
            H_np = H_np[:, np.argsort(cell_perm)]  # back to caller order
        if self.component_bucket:
            # drop the phantom components: the stored matrices are true-sized
            valid = mu.block_valid_mask(cfg.blocks, true_blocks).numpy()
            W_np, H_np = W_np[:, valid], H_np[valid]
            Bs_np = [b[:, :kt] for b, kt in zip(Bs_np, self.n_covariate_components)]
        m = AlpineMatrices(
            X=X,
            Ys=[np.asarray(y, dtype=np.float32) for y in Ys],
            Ws=split_w(W_np, self.n_all_components),
            Hs=split_h(H_np, self.n_all_components),
            Bs=Bs_np,
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

        return pd.DataFrame(self.loss_history_, columns=self.loss_columns())

    def loss_columns(self) -> List[str]:
        """The names of ``loss_history_``'s columns."""
        return ["total loss", "reconstruction loss"] + [
            f"prediction loss({k})" for k in self.covariate_keys
        ]

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
        # a pickle carries no device tensors (the cache holds all of X), and
        # a cell mesh travels as a descriptor rebuilt on load
        state = dict(self.__dict__)
        state["_x_cache"] = None
        state["device"] = describe_device(state.get("device"))
        return state

    def __setstate__(self, state):
        state["device"] = restore_device(state.get("device"))
        self.__dict__.update(state)

    def get_normalized_expression(self, adata, library_size: Optional[float] = None,
                                  on_device: bool = True,
                                  cell_block_size: Optional[int] = None,
                                  out: Optional[np.ndarray] = None) -> None:
        """Batch-corrected expression from the unguided block only
        (reference main.py:275-301), into
        ``adata.layers["normalized_expression"]``: W_unguided @ H of
        ``adata.obsm["ALPINE_embedding"]``, each cell scaled to
        ``library_size`` (the median of the cells' totals when None).

        Two passes over ``cell_block_size``-cell slabs (about 256 MB of
        float32 by default) write straight into ``out``, so the transient
        memory is one slab: the products and the cells' totals, then the
        scaling.  ``out`` is a preallocated (cells × genes) float32 array
        (an ``np.memmap`` for out-of-core export); by default one is
        allocated.  Each slab's product runs on the model's device;
        ``on_device=False`` runs it with numpy on the host (the JAX
        package's default)."""
        if not hasattr(self, "matrices"):
            raise RuntimeError("Model is not trained yet. Please fit the model first.")
        elif not is_anndata(adata):
            raise TypeError("adata must be an AnnData object.")
        elif "ALPINE_embedding" not in adata.obsm:
            raise ValueError(
                "ALPINE_embedding not found in adata.obsm. Please transform the data first."
            )
        elif (library_size is not None) and (library_size <= 0):
            raise ValueError("library_size must be a positive float.")

        W: Float32Array = self.matrices["Ws"][-1]
        H: Float32Array = np.asarray(adata.obsm["ALPINE_embedding"]).T
        n_cells, g = H.shape[1], W.shape[0]
        if cell_block_size is None:
            cell_block_size = max(1, min(n_cells, (64 << 20) // max(g, 1)))
        if not isinstance(cell_block_size, int) or cell_block_size <= 0:
            raise ValueError("cell_block_size must be a positive integer.")
        if out is None:
            out = np.empty((n_cells, g), np.float32)
        elif out.shape != (n_cells, g) or out.dtype != np.float32:
            raise ValueError(
                f"out must be a float32 array of shape {(n_cells, g)}, got "
                f"{out.dtype} {out.shape}."
            )

        counts = np.empty(n_cells, np.float32)
        mu.reconstruct_expression_blocks(
            W, H, out, counts, cell_block_size, device=self._compute_device,
            precision=self.matmul_precision, on_device=on_device)
        fac = library_size_factors(counts, library_size)
        for lo in range(0, n_cells, cell_block_size):
            hi = min(lo + cell_block_size, n_cells)
            out[lo:hi] *= fac[lo:hi, None]

        adata.layers["normalized_expression"] = out

    def save(self, path: str) -> None:
        """Write the fitted model to ``<path>.npz`` and
        ``<path>.encoders.pkl`` in the JAX package's format
        (``alpine_tpu_torch/io/checkpoint.py``)."""
        save_model(self, path)

    @classmethod
    def load(cls, path: str, device="auto") -> "ALPINE":
        """A fitted model from files written by ``save`` or by the JAX
        package's ``ALPINE.save``, on ``device`` ("auto": the card).  It has
        no device copy of X, so its first ``transform`` uploads the data."""
        return load_model(path, device=device)

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
    def _compute_device(self) -> torch.device:
        """The device this process computes on (its own on a cell mesh)."""
        return Placement(self.device).device

    def _agree_fit_inputs(self, placement, X, Ys, fe, covariate_keys,
                          resolved_dtype, x_fp, *, max_iter, batch_size,
                          sampling_method, checkpoint_dir, checkpoint_every):
        """The sharded fit's first collectives, in the reference's order
        (alpine_tpu/models/alpine.py:264-374): every fit input that shapes
        the collective sequence or the replicated trajectory is compared
        across processes, ``data_dtype="auto"`` takes the widest storage any
        process resolved, the processes' cell counts are gathered, and an
        explicit integer dtype that one process's cells cannot store raises
        on every process.  Returns (storage dtype, cell counts in mesh
        order).  Unlike the JAX package it also compares
        ``sampling_method``: weighted_fast gathers a group layout and
        "weighted" the cells' label codes, which the other modes do not,
        and ``use_als`` (in the constructor's digest) and ``batch_size``
        decide whether the draw is the global one, so a mixed fleet would
        hang rather than raise.  On a grid the gene count must divide the
        gene axis (the JAX package's check, before the upload), and the
        processes of a cell column must pass the same cells: a digest of
        X's fingerprint (``x_fp``) and the labels is compared along it."""
        from alpine_tpu_torch.parallel import distributed as dist

        def digest(blob: str) -> int:
            return _digest(blob.encode())

        def label_hash(key):
            return digest("\x1f".join(map(str, fe.encoded_labels[key])))

        ctor = digest(repr((
            self.n_components, tuple(self.n_covariate_components),
            tuple(float(v) for v in np.atleast_1d(self.lam)),
            float(self.orth_W), float(self.alpha_W), float(self.l1_ratio_W),
            self.loss_type, self.use_als, self.scale_needed, float(self.eps),
            self.random_state, self.matmul_precision, self.component_bucket,
        )))
        dist.assert_same_across_processes(
            [X.shape[0], mu.DATA_DTYPES.index(self.data_dtype), ctor,
             int(checkpoint_dir is not None),
             checkpoint_every if checkpoint_dir is not None else -1,
             -1 if max_iter is None else int(max_iter),
             -1 if batch_size is None else int(batch_size),
             digest(sampling_method)]
            + [y.shape[0] for y in Ys]
            + [label_hash(k) for k in covariate_keys],
            "per-process fit inputs (gene count, data_dtype setting, "
            "model hyperparameters, checkpointing, max_iter, batch_size, "
            "sampling_method, covariate label sets)",
        )
        placement.check_gene_axis(X.shape[0])
        dist.assert_same_along_genes(
            placement, [_digest(repr(x_fp).encode()
                                + b"".join(y.tobytes() for y in Ys))],
            "the cells (a digest of X and the covariate labels)")
        if self.data_dtype == "auto":
            codes = dist.process_allgather_rows(np.asarray(
                [mu.STORAGE_DTYPES.index(resolved_dtype)], np.int64))
            resolved_dtype = mu.STORAGE_DTYPES[int(codes.max())]
        sizes = dist.chunk_cell_sizes(placement, X.shape[1])
        if self.data_dtype != "auto" and resolved_dtype in ("int8", "int16"):
            bad = float(not dtype_can_store(resolved_dtype, X))
            if dist.process_allgather_rows(np.asarray([bad])).any():
                limit = np.iinfo(resolved_dtype).max
                raise ValueError(
                    f"data_dtype='{resolved_dtype}' cannot represent "
                    "the data on at least one process's shard "
                    f"(requires integer values in [0, {limit}])."
                )
        return resolved_dtype, sizes

    @staticmethod
    def _agree_max_iter(best: int, coordinator: bool) -> int:
        """The coordinator's elbow, on every process of a sharded fit (one
        host allgather): loss rows that part by a rounding (a grid's
        ragged columns) could otherwise give the processes different
        ``max_iter`` and put their collectives out of step.  Where the
        processes' elbows differ the coordinator warns, naming them."""
        from alpine_tpu_torch.parallel import distributed as dist

        rows = dist.process_allgather_rows(np.asarray([int(coordinator), best],
                                                      np.int64))
        agreed = int(rows[rows[:, 0] == 1][0, 1])
        if coordinator and not (rows[:, 1] == agreed).all():
            warnings.warn(
                "the max_iter=None elbow differs across processes "
                f"({sorted(set(rows[:, 1].tolist()))}); every process takes "
                f"the coordinator's, {agreed}.")
        return agreed

    @staticmethod
    def _sharded_group_tables(placement, Ys, dev):
        """weighted_fast over processes (alpine_tpu/models/alpine.py:
        486-518, 600-612): this process group-sorts its own cells (stable),
        and one host allgather of (code, count) pairs gives the global
        group layout, which under the stable sort is the single-process
        group sort of the processes' cells in mesh order.  Returns (this
        process's cell order, the global sorted position of each of its
        sorted cells, its window tables (start_loc, m, off, m_loc) on
        ``dev``).  The group sizes are checked on their global values, so
        every process raises together."""
        from alpine_tpu_torch.parallel import distributed as dist

        codes = joint_label_codes(Ys)
        order = np.argsort(codes, kind="stable")
        g_codes, m_gp = dist.allgather_group_layout(placement, codes)
        m_g = m_gp.sum(axis=0)
        check_group_sizes(m_g)
        shard = placement.process_chunk_index
        base_off = m_gp[:shard].sum(axis=0)
        local_sizes = m_gp[shard]
        local_start = np.concatenate([[0], np.cumsum(local_sizes)[:-1]])
        gid = np.searchsorted(g_codes, codes[order])
        g_start = np.concatenate([[0], np.cumsum(m_g)[:-1]])
        h0_cols = (g_start[gid] + base_off[gid] + np.arange(len(codes))
                   - local_start[gid])
        start_loc, off, m_loc = window_group_tables(
            local_start, local_sizes, base_off, 1, len(codes))[0]
        tables = tuple(torch.from_numpy(np.asarray(t, np.int32)).to(dev)
                       for t in (start_loc, m_g, off, m_loc))
        return order, h0_cols, tables

    @property
    def _storage_dtype(self) -> str:
        """The resolved X storage dtype (`data_dtype_`, set at fit); before
        any fit, the constructor dtype with "auto" read as float32."""
        dt = getattr(self, "data_dtype_", None)
        if dt is None:
            dt = "float32" if self.data_dtype == "auto" else self.data_dtype
        return dt

    def _cfg_blocks(self) -> tuple:
        """The blocks the fit runs at: bucket-padded where component_bucket
        is set (alpine_tpu/models/alpine.py:1255-1264)."""
        blocks = tuple(self.n_all_components)
        if isinstance(self.component_bucket, tuple):
            return self.component_bucket
        if self.component_bucket:
            return mu.bucket_blocks(blocks, self.component_bucket)
        return blocks

    def _checkpoint_key(self, Ys, n_sample: int, n_iter: int,
                        checkpoint_every: int, placement,
                        chunk_sizes) -> dict:
        """What a fit snapshot's name hashes: the JAX package's keys and
        value types (alpine_tpu/models/alpine.py:690-729), so either package
        resumes the other's snapshot of the same single-device fit.  On a
        cell mesh the topology joins it (one card a process): the shard and
        process counts, this process's position, which gives each process
        a file of its own in the shared directory, and the processes' cell
        counts (``chunk_sizes``, None unsharded).  On a grid so do its
        shape (n_g, n_c), this process's place (gene block, cell run) and
        its gene rows, so that no other grid, gene split or cell mesh
        resumes its snapshot."""
        key = {
            "blocks": self.n_all_components,
            "n_labels": [y.shape[0] for y in Ys],
            "n_cells": n_sample,
            "lam": self.lam, "orth_W": self.orth_W,
            "alpha_W": self.alpha_W, "l1_ratio_W": self.l1_ratio_W,
            "loss_type": self.loss_type, "use_als": self.use_als,
            "data_dtype": self.data_dtype_,
            "matmul_precision": self.matmul_precision,
            "batch_size": self.batch_size,
            "sampling": self.sampling_method,
            "tile": mu.DEFAULT_TILE if self.sampling_method == "tiled" else 0,
            "bucket": self.component_bucket,
            "cell_shards": placement.cell_shards,
            "seed": self.random_state, "max_iter": n_iter,
            "checkpoint_every": checkpoint_every,
            "n_processes": placement.n_processes,
            "process_index": placement.process_chunk_index,
            "cell_layout": (None if chunk_sizes is None
                            else tuple(int(v) for v in chunk_sizes)),
        }
        if placement.is_grid:
            key.update(
                grid=(placement.gene_shards, placement.cell_shards),
                grid_place=(placement.gene_index, placement.process_chunk_index),
                gene_range=placement.gene_range(self.n_features))
        return key

    def _make_cfg(self, Ys, n_sample: int, n_iter: int) -> mu.MUConfig:
        return mu.MUConfig(
            blocks=self._cfg_blocks(),
            n_labels=tuple(y.shape[0] for y in Ys),
            n_cells=n_sample,
            loss_kl=(self.loss_type == "kl-divergence"),
            max_iter=n_iter,
            precision=self.matmul_precision,
            x_dtype=self._storage_dtype,
            backend="fused",
            weighted_counts=(self.sampling_method == "weighted_fast"),
            use_als=self.use_als,
            batch_size=None if self.batch_size >= n_sample else self.batch_size,
            weighted=(self.sampling_method == "weighted"),
            tile=mu.DEFAULT_TILE if self.sampling_method == "tiled" else 0,
        )

    def _hyper(self):
        """(lam, orth_W, alpha_W, l1_ratio_W, eps): lam a float32 tensor on
        the device, the rest Python floats rounded to float32."""
        f32 = lambda v: float(np.float32(v))
        return (
            torch.tensor(np.asarray(self.lam, dtype=np.float32).reshape(-1),
                         device=self._compute_device),
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
        weighted_fast or tiled fit its cells are permuted (and, tiled,
        zero-padded), so H0 is re-paired to them, padded with zero columns
        and the result stripped and un-permuted (each cell's projection is
        independent of the others).

        On a cell mesh each process projects its own cells: the inputs are
        compared across processes first, the global H0 is drawn on every
        process and sliced to its columns, and the device-X cache is used
        only where every process hits it (alpine_tpu/models/alpine.py:
        1536-1670).  On a grid each process moves its block of X (or
        reuses the fit's), 2WᵀX and WᵀW of its gene rows are summed over
        its cell column, and K3 projects its columns; the processes of a
        column must pass the same cells."""
        placement = Placement(self.device)
        sharded, grid = placement.is_sharded, placement.is_grid
        if sharded:
            from alpine_tpu_torch.parallel import distributed as dist

            # before any check that one process could fail alone
            dist.assert_same_across_processes(
                [adata.shape[1], mu.STORAGE_DTYPES.index(self._storage_dtype)],
                "per-process transform inputs (genes, model storage dtype)",
            )
        if adata.shape[1] != self.n_features:
            raise ValueError(
                f"adata has {adata.shape[1]} genes but the model was fit "
                f"on {self.n_features}; transform requires the same gene "
                "axis (same order) as the training data."
            )
        dev = placement.device
        n_sample = adata.shape[0]
        cached = getattr(self, "_x_cache", None)
        x_fp = (self._x_fingerprint(adata.X)
                if grid or (cached is not None and cached[2] == n_sample) else None)
        use_cache = (cached is not None and not _no_x_cache()
                     and cached[2] == n_sample and cached[1] == x_fp)
        n_global, offset = n_sample, 0
        if sharded:
            sizes = dist.chunk_cell_sizes(placement, n_sample)
            dist.assert_same_along_genes(placement, [_digest(repr(x_fp).encode())],
                                         "the cells (a digest of X)")
            n_global = int(sizes.sum())
            offset = int(sizes[:placement.process_chunk_index].sum())
            use_cache = bool(dist.process_allgather_rows(
                np.asarray([float(use_cache)])).all())
        g0, g1 = placement.gene_range(self.n_features)
        if use_cache:
            X, cell_perm, pad = cached[0], cached[3], cached[4]  # validated at fit
        else:
            if not (x_min(adata.X) >= 0):  # NaN fails this like a negative
                raise ValueError("All elements in adata.X must be non-negative.")
            # out-of-sample data need not be integer-representable
            X = self._cast_x_host(dense_x(adata.X).T[g0:g1], strict=False).to(dev)
            cell_perm, pad = None, 0
        H0 = draw_transform_h0(self.total_components, n_global,
                               self.random_state, self.eps, dev)
        if sharded:
            H0 = H0[:, offset:offset + n_sample].contiguous()
        if cell_perm is not None:
            # device column p is caller cell cell_perm[p]
            H0 = H0[:, torch.from_numpy(cell_perm).to(dev)]
        if pad:
            H0 = torch.nn.functional.pad(H0, (0, pad))
        W = torch.from_numpy(np.ascontiguousarray(
            np.concatenate(self.matrices["Ws"], axis=1)[g0:g1])).to(dev)
        H = mu.run_transform(W, X, H0, float(np.float32(self.eps)),
                             n_iter=n_iter, precision=self.matmul_precision,
                             reduce=mu.reducer(placement.gene_group,
                                               "genes transform"))
        H_np = H[:, :n_sample].cpu().numpy()
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

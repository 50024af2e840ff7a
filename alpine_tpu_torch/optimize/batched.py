"""Cross-validation folds of the ComponentOptimizer from one upload.

Counterpart of ``alpine_tpu/optimize/batched.py``.  The JAX package vmaps
all folds of a trial into one XLA program; the port uploads the stacked,
zero-padded fold tensors once a search (``prepare_fold_data``) and fits
the folds one after another from them through ``mu.fit_scan``: the fused
fit loop (K1, or K4 for weighted_fast folds) on the card, the step loop
(P1/P2) for ALS, minibatch and tiled folds.  Each fold's validation cells
are projected by ``mu.run_transform`` (K3).

Mechanics, as in the JAX package:
- training and validation matrices are zero-padded to the largest fold
  and stacked on a leading fold axis.  Zero cell columns (with zero H)
  are exactly neutral in every MU numerator and denominator, so a padded
  fold follows its unpadded trajectory from the same initial values;
- W0, H0 and Bs0 are drawn once from the trial seed and shared by the
  folds (H0 zeroed past each fold's size); one transform H0 is shared by
  the validation projections;
- only the unguided embeddings return to the host, where each fold is
  clustered and scored.

A process may hold some of the folds only (``prepare_fold_data(owned=)``:
a search on a grid of processes fits each fold on the card of the process
that owns it).  The widths stay those of the whole stack, so a fold's
fit is the single-device batched fit of that fold bit for bit.

The draws come from this module's ``draw_init``, ``draw_transform_h0``,
``draw_counts_stream``, ``draw_cells_stream`` and ``draw_tiles_stream``
(the model layer's torch-generator streams, seeded by ``random_state``);
every fold takes the same streams, as the JAX package's folds share one
fit key.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# the model layer's draws, bound here so that the folds' streams can be
# replaced apart from the estimator's
from alpine_tpu_torch.models.alpine import (
    _COUNTS_SALT, _draw_seed, draw_cells_stream, draw_init, draw_tiles_stream,
    draw_transform_h0,
)
from alpine_tpu_torch.ops import mu
from alpine_tpu_torch.parallel.mesh import resolve_device
from alpine_tpu_torch.utils import sampling
from alpine_tpu_torch.utils.adata import is_sparse_x


def draw_counts_stream(weights: torch.Tensor, n: int, random_state: int):
    """weighted_fast folds' draws: returns ``draw(t)``, epoch t's ``n``
    with-replacement draws over the fold's probability vector ``weights``
    as counts (``mu.multinomial_counts``), from a generator on the weights'
    device seeded from (random_state, salt, t)."""
    gen = torch.Generator(device=weights.device)

    def draw(t: int) -> torch.Tensor:
        gen.manual_seed(_draw_seed(random_state, _COUNTS_SALT, t))
        return mu.multinomial_counts(gen, n, weights)

    return draw


@dataclass
class FoldData:
    """Stacked, zero-padded CV fold tensors on one device.

    They depend only on (adata, folds, sampling mode, dtype) — not on a
    trial's hyperparameters — so the optimizer builds them once a search
    and every trial's fold fits read them.  The stack holds the folds of
    ``owned`` (indices into ``folds``), in that order; ``n_tr`` and
    ``n_va`` are the widest of all the folds."""

    folds: Sequence[Tuple[np.ndarray, np.ndarray]]
    owned: Tuple[int, ...]
    g: int
    n_labels: Tuple[int, ...]
    n_tr: int
    n_va: int
    Xtr: torch.Tensor                 # (n_owned, g, n_tr), storage dtype
    Xva: torch.Tensor                 # (n_owned, g, n_va), storage dtype
    Ystr: Tuple[torch.Tensor, ...]    # each (n_owned, labels_i, n_tr)
    weights: Optional[torch.Tensor]   # (n_owned, n_tr) float32, or None
    valid_cols: torch.Tensor          # (n_owned, 1, n_tr) bool: real cells
    device: torch.device
    x_dtype: str = "float32"          # storage dtype name
    tile: int = 0                     # > 0: folds staged for "tiled"

    def slot(self, f: int) -> int:
        """The stack position of fold ``f``."""
        return self.owned.index(f)


def _storage_rows(X, x_dtype: str) -> torch.Tensor:
    """The (cells × genes) X as a host tensor in its storage dtype, without
    a float32 copy of integer data (the caller validated integer dtypes:
    every value is an exact small integer)."""
    if is_sparse_x(X):
        X = X.toarray()
    X = np.asarray(X)
    if x_dtype in ("int8", "int16"):
        return torch.from_numpy(np.ascontiguousarray(X.astype(x_dtype)))
    Xf = torch.from_numpy(np.ascontiguousarray(X, np.float32))
    return Xf.to(torch.bfloat16) if x_dtype == "bfloat16" else Xf


def prepare_fold_data(
    X_cells_by_genes,
    Ys_cells_by_labels: Sequence[np.ndarray],
    folds: Sequence[Tuple[np.ndarray, np.ndarray]],
    *,
    weighted: bool,
    device="cuda",
    x_dtype: str = "float32",
    tile: int = 0,
    shuffle_seed: int = 0,
    owned: Optional[Sequence[int]] = None,
) -> FoldData:
    """Build the trial-invariant stacked fold tensors on ``device``.

    X is cast once on the host to its storage dtype (int8 counts stay 1
    byte a value), uploaded once as (cells × genes), and each fold's
    training and validation columns are gathered and transposed on the
    device.  The validation X keeps the storage width; the projection
    widens it.  ``tile > 0`` stages the folds for "tiled" sampling: the
    training width rounds up to a tile multiple and each fold's training
    cells take a seeded shuffle ``default_rng(shuffle_seed + f)`` (the
    batched form of the estimator's cell pre-shuffle: stratified fold
    indices arrive grouped by class, and a tile of adjacent columns would
    otherwise be a biased sample).  ``weighted`` adds each fold's balanced
    per-cell probabilities over its training cells.  ``owned`` (default:
    every fold) names the folds to stack; the widths are all folds'."""
    if tile and weighted:
        raise ValueError("tiled and weighted sampling are exclusive")
    dev = resolve_device(device)
    owned = tuple(range(len(folds)) if owned is None else (int(f) for f in owned))
    n_folds = len(owned)
    g = X_cells_by_genes.shape[1]
    storage = mu.x_storage_dtype(x_dtype)
    Ys_all = [np.asarray(y, np.float32) for y in Ys_cells_by_labels]
    n_labels = tuple(y.shape[1] for y in Ys_all)
    n_tr = max(len(tr) for tr, _ in folds)
    n_va = max(len(va) for _, va in folds)
    if tile:
        n_tr = -(-n_tr // tile) * tile  # tile-aligned cell axis

    # the one upload (none for a process that holds no fold)
    X_dev = _storage_rows(X_cells_by_genes, x_dtype).to(dev) if owned else None
    Xtr = torch.zeros((n_folds, g, n_tr), dtype=storage, device=dev)
    Xva = torch.zeros((n_folds, g, n_va), dtype=storage, device=dev)
    Ystr = [np.zeros((n_folds, nl, n_tr), np.float32) for nl in n_labels]
    weights = np.zeros((n_folds, n_tr), np.float32) if weighted else None
    for i, f in enumerate(owned):
        tr, va = folds[f]
        tr = np.asarray(tr)
        if tile:
            tr = tr[np.random.default_rng(shuffle_seed + f).permutation(len(tr))]
        for dst, rows in ((Xtr, tr), (Xva, np.asarray(va))):
            idx = torch.from_numpy(rows.astype(np.int64)).to(dev)
            dst[i, :, :len(rows)] = X_dev.index_select(0, idx).T
        for j, y in enumerate(Ys_all):
            Ystr[j][i, :, :len(tr)] = y[tr].T
        if weighted:
            ids = sampling.joint_label_ids([y[tr].T for y in Ys_all])
            w = sampling.balanced_sample_probabilities(ids)
            weights[i, :len(tr)] = w / w.sum()
    del X_dev
    col = torch.arange(n_tr, device=dev)[None, None, :]
    sizes = torch.tensor([len(folds[f][0]) for f in owned], device=dev)[:, None, None]
    return FoldData(
        folds=folds, owned=owned, g=g, n_labels=n_labels, n_tr=n_tr, n_va=n_va,
        Xtr=Xtr, Xva=Xva,
        # one-hot Ys are exact in any storage dtype
        Ystr=tuple(torch.from_numpy(y).to(storage).to(dev) for y in Ystr),
        weights=None if weights is None else torch.from_numpy(weights).to(dev),
        valid_cols=col < sizes, device=dev, x_dtype=x_dtype, tile=tile,
    )


def fold_config(fd: FoldData, blocks: Tuple[int, ...], *, loss_kl: bool,
                use_als: bool, batch_size, weighted: bool,
                weighted_counts: bool, max_iter: int) -> mu.MUConfig:
    """The fit configuration every fold of a trial shares.  weighted_fast
    folds (``weighted_counts``) run the counts mode on all cells;
    ``weighted`` alone gathers balanced draws."""
    return mu.MUConfig(
        blocks=tuple(blocks), n_labels=fd.n_labels, n_cells=fd.n_tr,
        loss_kl=loss_kl, use_als=use_als,
        batch_size=None if (batch_size is None or batch_size >= fd.n_tr)
        else batch_size,
        weighted=weighted and not weighted_counts,
        weighted_counts=weighted_counts, tile=fd.tile, max_iter=max_iter,
        precision="highest",
        # the storage regime of the stacked fold tensors
        x_dtype=fd.x_dtype, backend="fused",
    )


def fit_fold(fd: FoldData, f: int, cfg: mu.MUConfig, W0, H0, Bs0, hyper,
             seed: int):
    """Fit fold ``f`` (an index into ``fd.folds``, held by ``fd``) from
    the shared init: H0 zeroed past the fold's cells (a phantom cell with
    nonzero H would add to HHᵀ and rowsum(H) on the first iteration), the
    fold's streams.  Returns mu.fit_scan's (W, H, Bs, losses)."""
    i = fd.slot(f)
    H0f = torch.where(fd.valid_cols[i], H0, 0.0)
    draw_counts = draw_cells = None
    if cfg.weighted_counts:
        draw_counts = draw_counts_stream(fd.weights[i], fd.n_tr, seed)
    elif cfg.tiled:
        draw_cells = draw_tiles_stream(fd.n_tr // cfg.tile, seed, fd.device)
    elif cfg.minibatch:
        probs = None if not cfg.weighted else fd.weights[i].cpu().numpy()
        draw_cells = draw_cells_stream(fd.n_tr, seed, fd.device, probs)
    return mu.fit_scan(cfg, W0, H0f, Bs0, fd.Xtr[i], [y[i] for y in fd.Ystr],
                       hyper, draw_counts=draw_counts, draw_cells=draw_cells)


def batched_fold_embeddings(
    fd: FoldData,
    *,
    blocks: Tuple[int, ...],
    lam: Sequence[float],
    orth_w: float,
    alpha_w: float,
    l1_ratio: float,
    eps: float,
    loss_kl: bool,
    use_als: bool,
    batch_size,
    weighted: bool,
    max_iter: int,
    weighted_counts: bool = False,
    seed: int,
    true_blocks: Tuple[int, ...] = None,
) -> List[np.ndarray]:
    """Fit one model per fold that ``fd`` holds (``prepare_fold_data``,
    built once a search) and return each one's validation unguided
    embedding, from the scaled fit, as a (n_val_fold, k_unguided) numpy
    array, in the order of ``fd.owned``.

    With ``true_blocks``, ``blocks`` is a bucket-padded shape
    (``mu.auto_bucket_blocks``): the phantom components start at zero, stay
    zero, and are sliced off the returned embeddings."""
    if true_blocks is None:
        true_blocks = blocks
    if fd.tile:
        # the model layer's contract: tiled IS a minibatch mode, so a batch
        # covering a training fold would run it full batch
        min_tr = min(len(tr) for tr, _ in fd.folds)
        if batch_size is None or batch_size >= min_tr:
            raise ValueError(
                "sampling_method='tiled' is a minibatch mode: batch_size "
                f"must be smaller than every training fold ({min_tr} cells).")
    cfg = fold_config(fd, blocks, loss_kl=loss_kl, use_als=use_als,
                      batch_size=batch_size, weighted=weighted,
                      weighted_counts=weighted_counts, max_iter=max_iter)
    dev = fd.device
    f32 = lambda v: float(np.float32(v))
    hyper = (torch.tensor(np.asarray(lam, np.float32), device=dev),
             f32(orth_w), f32(alpha_w), f32(l1_ratio), f32(eps))
    W0, H0, Bs0 = draw_init(cfg, fd.g, seed, eps, dev)
    if tuple(true_blocks) != tuple(blocks):
        W0, H0, Bs0 = mu.mask_block_padding(blocks, true_blocks, W0, H0, Bs0)
    H0v = draw_transform_h0(sum(blocks), fd.n_va, seed, eps, dev)
    # the genuine unguided rows: the first true_blocks[-1] rows of the
    # (possibly padded) last block
    off_last = sum(blocks[:-1])
    k_unguided = true_blocks[-1]
    out = []
    for i, f in enumerate(fd.owned):
        va = fd.folds[f][1]
        W, H, Bs, _ = fit_fold(fd, f, cfg, W0, H0, Bs0, hyper, seed)
        W, H, Bs = mu.scale_matrices(blocks, W, H, Bs)
        Hva = mu.run_transform(W, fd.Xva[i], H0v, f32(eps), n_iter=max_iter,
                               precision="highest")
        out.append(np.ascontiguousarray(
            Hva[off_last:off_last + k_unguided, :len(va)].T.cpu().numpy()))
        del W, H, Bs, Hva
    return out

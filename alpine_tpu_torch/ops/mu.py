"""Multiplicative-update (MU) numerical core of the port: the fit loops,
the out-of-sample projection and the expression export.

Counterpart of ``alpine_tpu/ops/mu.py`` (its single-device subset).  The
update math is the same:

- ``(WᵀW)H`` and ``W(HHᵀ)`` replace the reference's ``Wᵀ(WH)`` and
  ``(WH)Hᵀ``, so no (genes × cells) product is formed;
- the reconstruction loss uses the trace identity
  ``‖X‖² − 2·Σ(WᵀX)∘H + Σ(WᵀW)∘(HHᵀ)``;
- W and H are stored concatenated across blocks, covariate blocks first
  and the unguided block last; ``Bs`` is a tuple of (labels_i × k_i).

Two fit loops run the same trajectory: ``backend="fused"`` (what the
estimator runs) calls one kernel per iteration through ops/kernels.py and
carries the next iteration's statistics, as the JAX package's Pallas
fit loop does; ``backend="plain"`` is the step-by-step PyTorch reference
the tests hold the fused fit loop against.  JAX's ``lax.scan`` becomes a
Python loop; the loss history stays on the device and is fetched once by
the caller.

``MUConfig.weighted_counts`` is ``sampling_method="weighted_fast"``: each
iteration's balanced with-replacement draw of n cells becomes a count
vector c, every contraction over cells against H is scaled by c, and
undrawn cells keep their H (``joint_weighted_counts_update``).

``MUConfig.use_als`` is ALS mode: block-cyclic steps (``als_batch_update``)
that read X n_blocks + 1 times an iteration; its fused backend runs those
X passes through the kernels ``hxt`` and ``wtx``.

``MUConfig.batch_size`` below n_cells (random minibatch) or
``MUConfig.weighted`` (``sampling_method="weighted"``: balanced draws with
replacement) gathers each epoch's batches of cells and runs one joint or
ALS step on each (``_fit_scan_steps``); the fused backend runs the
steps' X products through ``hxt`` and ``wtx``.  ``MUConfig.tile``
("tiled" sampling) permutes whole tiles of ``tile`` adjacent cells
instead of single cells, so a batch's copy of X moves contiguous runs.

Component bucketing pads each block with phantom components that start
at zero and stay exactly zero (``bucket_blocks``, ``auto_bucket_blocks``,
``mask_block_padding``).

With a process group (``fit_scan_sharded``) each rank holds a run of the
cells and every mode runs on it: the same loops, whose sums over cells
are all-reduced (the steps' ``r``, the fused loop's one call an
iteration).  On a ("genes", "cells") grid a rank holds a block of genes ×
cells: the steps also sum their sums over genes (WᵀX, WᵀW) over the genes
group (``rg``), and every fit runs as steps whose X products are P1
``hxt`` and P2 ``wtx`` on the rank's block.  Gathered weighted draws and
ALS minibatches (on either mesh) and a grid's random minibatches take the
global draw: every rank draws the single-device epoch and runs its share
of each batch (``cell_range``, ``_column_shares``).

A verbose fit passes ``progress``: the loops call it every
``progress_every(max_iter)`` iterations and after the last with the
iterations done and the objective loss, which syncs the host there.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from alpine_tpu_torch import profiling

# The model-layer data_dtype vocabulary, narrowest storage first.
STORAGE_DTYPES = ("int8", "int16", "bfloat16", "float32")
DATA_DTYPES = ("auto",) + STORAGE_DTYPES

_STORAGE = {"int8": torch.int8, "int16": torch.int16,
            "bfloat16": torch.bfloat16, "float32": torch.float32}


# "tiled" sampling's tile: one 128-cell run per gene row of X (the JAX
# package's DEFAULT_TILE, alpine_tpu/ops/mu.py:188-192)
DEFAULT_TILE = 128


def x_storage_dtype(x_dtype: str) -> torch.dtype:
    """Storage name -> torch dtype of X (and Ys) on the device."""
    return _STORAGE[x_dtype]


def x_compute_dtype(storage_dtype: torch.dtype) -> torch.dtype:
    """THE storage -> compute mapping for X: int8 computes in bfloat16 (ints
    ≤ 256 are exact there), int16 in float32, float storage as stored."""
    if storage_dtype == torch.int8:
        return torch.bfloat16
    if storage_dtype == torch.int16:
        return torch.float32
    return storage_dtype


def round_partner(v: torch.Tensor, x_dtype: torch.dtype) -> torch.Tensor:
    """The float32 operand multiplied with X, rounded as the compute dtype
    rounds it: bf16 for int8/bf16 X (the JAX kernels cast W and Hn before
    their X dots), unchanged for f32/int16 X.  With the rounded operand and
    X widened to f32 every product is exact, so an f32 matmul gives the
    bf16 matmul's f32-accumulated result up to summation order."""
    if x_compute_dtype(x_dtype) == torch.bfloat16:
        return v.to(torch.bfloat16).float()
    return v


def block_offsets(blocks: Tuple[int, ...]) -> Tuple[int, ...]:
    """Start offset of each component block in the concatenated W/H."""
    out, acc = [], 0
    for k in blocks:
        out.append(acc)
        acc += k
    return tuple(out)


def guided_width(blocks: Tuple[int, ...]) -> int:
    """Total width of the guided blocks (at the top of W/H)."""
    return sum(blocks[:-1])


@dataclass(frozen=True)
class MUConfig:
    """Static configuration of one full-epoch joint fit."""

    blocks: Tuple[int, ...]  # k per block; covariate blocks first, unguided last
    n_labels: Tuple[int, ...]  # labels per covariate block
    n_cells: int
    loss_kl: bool = True  # "kl-divergence" vs "frobenius" (prediction term)
    max_iter: int = 200
    precision: str = "highest"  # "highest": true fp32, no TF32
    x_dtype: str = "float32"  # storage of X and Ys: see STORAGE_DTYPES
    backend: str = "fused"  # "fused" (kernels) | "plain" (step-by-step)
    weighted_counts: bool = False  # weighted_fast: count-scaled epochs
    use_als: bool = False  # block-cyclic (ALS) steps instead of joint ones
    batch_size: Optional[int] = None  # cells a step; None: all of them
    weighted: bool = False  # "weighted": n balanced draws an epoch, gathered
    tile: int = 0  # "tiled": cells a tile (0: single cells)

    def __post_init__(self):
        if self.backend not in ("fused", "plain"):
            raise ValueError("backend must be 'fused' or 'plain'")
        if self.x_dtype not in STORAGE_DTYPES:
            raise ValueError(f"x_dtype must be one of {STORAGE_DTYPES}")
        if self.batch_size is not None and self.batch_size <= 0:
            raise ValueError("batch_size must be a positive integer or None")

    @property
    def n_cov(self) -> int:
        return len(self.n_labels)

    @property
    def K(self) -> int:
        return sum(self.blocks)

    @property
    def offsets(self) -> Tuple[int, ...]:
        return block_offsets(self.blocks)

    @property
    def xdt(self) -> torch.dtype:
        return x_storage_dtype(self.x_dtype)

    @property
    def minibatch(self) -> bool:
        """Gathered steps: a batch size below n_cells, or weighted draws
        (with replacement, so never the full-batch step even when one batch
        holds them all)."""
        bs = self.batch_size
        return self.weighted or (bs is not None and bs < self.n_cells)

    @property
    def eff_batch_size(self) -> int:
        bs = self.batch_size
        return self.n_cells if bs is None else min(bs, self.n_cells)

    @property
    def tiled(self) -> bool:
        """Minibatches of whole tiles ("tiled" sampling); a batch covering
        every cell has no tiles to permute."""
        return self.tile > 0 and self.minibatch


@contextmanager
def matmul_precision(precision: str):
    """float32 matmuls on the card run in true fp32 under "highest" (no
    TF32) and may use TF32 under "default"; the flag is restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision != "highest"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _clamp(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.clamp(x, min=eps)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or float64 where it is float64 (integer and bf16
    values widen exactly)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _norm_x2(X: torch.Tensor) -> torch.Tensor:
    """‖X‖_F² in float32 (float64 for float64 X; integer X widens first:
    int squares overflow), summed over chunks of about 2^24 values, so that
    no float32 copy of all of X is made (a single chunk, and one sum, below
    that size)."""
    rows = max(1, (1 << 24) // max(1, X.shape[1]))
    total = 0.0
    for chunk in torch.split(X, rows):
        cf = _wide(chunk)
        total = total + torch.sum(cf * cf)
    return total


def _dot_x(X: torch.Tensor, A: torch.Tensor, Xf: torch.Tensor) -> torch.Tensor:
    """A @ X with A rounded to X's compute dtype; Xf is X widened to f32."""
    return round_partner(A, X.dtype) @ Xf


def _x_ht(X: torch.Tensor, Xf: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """X @ Hᵀ (genes × K) with H rounded to X's compute dtype."""
    return (round_partner(H, X.dtype) @ Xf.T).T


# ---------------------------------------------------------------------------
# The plain joint step (the port's reference for the fused fit loop)
# ---------------------------------------------------------------------------


def _update_b(cfg: MUConfig, hyper, i: int, B, bnum, bden, HHt_ii):
    """Covariate block i's B update from its statistics over the cells
    (reference main.py:614-628; ``_b_stats``): KL -> λ·bnum over
    λ·rowsum(H_i), Frobenius -> 2·bnum over 2·B (H Hᵀ)_ii."""
    lam, eps = hyper[0], hyper[4]
    if cfg.loss_kl:
        num = lam[i] * bnum
        den = lam[i] * bden[None, :].expand_as(B)
    else:
        num = 2.0 * bnum
        den = 2.0 * (B @ HHt_ii)
    return B * (num / _clamp(den, eps))


def _guided_h_terms(cfg: MUConfig, B, Hi, Yi, lam_i, eps):
    """Guided-row numerator/denominator of the H update
    (reference main.py:637-650)."""
    if cfg.loss_kl:
        gnum = lam_i * (B.T @ (Yi / _clamp(B @ Hi, eps)))
        gden = lam_i * torch.sum(B, dim=0)[:, None].expand_as(Hi)
    else:
        gnum = 2.0 * lam_i * (B.T @ Yi)
        gden = 2.0 * lam_i * (B.T @ (B @ Hi))
    return gnum, gden


def _no_reduce(parts):
    return parts


def _xht_pass(cfg: MUConfig, X, Xf, H) -> torch.Tensor:
    """X Hᵀ (genes × K): the kernel ``hxt`` on the fused backend,
    ``_x_ht`` on ``Xf`` on the plain one.  Zero cells (a rank's empty
    batch) launch nothing and give zeros."""
    from alpine_tpu_torch.ops import kernels

    if not X.shape[1]:
        return H.new_zeros((X.shape[0], H.shape[0]))
    return kernels.hxt(X, H).T if cfg.backend == "fused" else _x_ht(X, Xf, H)


def _wtx_pass(cfg: MUConfig, X, Xf, Wm) -> torch.Tensor:
    """Wmᵀ X (k × cells): the kernel ``wtx`` on the fused backend,
    ``_dot_x`` on ``Xf`` on the plain one; nothing is launched on zero
    cells."""
    from alpine_tpu_torch.ops import kernels

    if not X.shape[1]:
        return Wm.new_zeros((Wm.shape[1], 0))
    if cfg.backend == "fused":
        return kernels.wtx(X, Wm.contiguous())
    return _dot_x(X, Wm.T, Xf)


def joint_batch_update(cfg: MUConfig, hyper, W, Bs, H, X, Xf, Ys_f, r=None,
                       rg=None):
    """One joint MU step: W, then Bs, then H (reference main.py:589-663).
    ``X`` is the stored X (its dtype decides the rounding), ``Xf`` the same
    values in f32 (unused by the fused backend) and ``Ys_f`` the label
    matrices in f32.  Returns (W, Bs, H, (WtX, WtW)) with WtX/WtW valid
    for the new W.  ``cfg.backend == "fused"`` runs the two X products
    through the kernels ``hxt`` (X Hᵀ) and ``wtx`` (Wᵀ X), "plain" through
    ``_x_ht``/``_dot_x`` on ``Xf``.

    ``r`` sums a list of statistics over the ranks of a cell-sharded fit
    (the JAX package's ``r=psum``): X Hᵀ, H Hᵀ and the B statistics all
    read the step's starting H, so they go in one call; W, the Bs and the
    H update of this rank's columns are then computed locally.  Without
    ``r`` nothing is reduced.

    ``rg`` sums over the gene blocks of a grid (X holds this rank's gene
    rows, W the same rows): WᵀX and WᵀW, in one call after the W update,
    so the H update reads the whole of both."""
    r, rg = r or _no_reduce, rg or _no_reduce
    HHt = H @ H.T
    XHt = _xht_pass(cfg, X, Xf, H)
    bnums, bdens = _b_stats(cfg, hyper, Bs, H, Ys_f)
    XHt, HHt, bnums, bdens = r([XHt, HHt, bnums, bdens])
    W = _update_w(hyper, W, XHt, HHt)
    Bs = _update_bs(cfg, hyper, Bs, bnums, bdens, HHt)

    lam, eps = hyper[0], hyper[4]
    WtX, WtW = rg([_wtx_pass(cfg, X, Xf, W), W.T @ W])
    num = 2.0 * WtX
    den = 2.0 * (WtW @ H)
    for i in range(cfg.n_cov):
        o, k = cfg.offsets[i], cfg.blocks[i]
        gnum, gden = _guided_h_terms(cfg, Bs[i], H[o:o + k], Ys_f[i], lam[i],
                                     eps)
        num[o:o + k] += gnum  # num/den are fresh tensors of this step
        den[o:o + k] += gden
    H = H * (num / _clamp(den, eps))
    return W, Bs, H, (WtX, WtW)


def joint_weighted_counts_update(cfg: MUConfig, hyper, W, Bs, H, X, Xf, Ys_f,
                                 c, r=None, rg=None):
    """One weighted_fast joint MU step over a whole epoch, with the epoch's
    draw given as per-cell counts ``c`` (n,) (the counterpart of
    ``alpine_tpu.ops.mu.joint_weighted_counts_update``).  A contraction
    over the drawn multiset is a count-weighted one over all cells —
    H_D H_Dᵀ = (c ⊙ H) Hᵀ, X_D H_Dᵀ = X (c ⊙ H)ᵀ, and likewise for the B
    statistics — while the H update is per column, so undrawn cells
    (c = 0) keep their H.  ``c ⊙ H`` is rounded to X's compute dtype as a
    whole, as the JAX step rounds it.  The X products are
    ``_xht_pass``/``_wtx_pass`` (the kernels on the fused backend).  ``r``
    and ``rg`` as in ``joint_batch_update``: the count-scaled statistics
    over the cells (each rank passes its own cells' counts), then WᵀX and
    WᵀW over the gene blocks."""
    lam, eps = hyper[0], hyper[4]
    r, rg = r or _no_reduce, rg or _no_reduce
    Hc = H * c[None, :]

    HHt = Hc @ H.T
    XHt = _xht_pass(cfg, X, Xf, Hc)
    bnums, bdens = _b_stats(cfg, hyper, Bs, H, Ys_f, scale=c)
    XHt, HHt, bnums, bdens = r([XHt, HHt, bnums, bdens])
    W = _update_w(hyper, W, XHt, HHt)
    Bs = _update_bs(cfg, hyper, Bs, bnums, bdens, HHt)

    WtX, WtW = rg([_wtx_pass(cfg, X, Xf, W), W.T @ W])
    num = 2.0 * WtX
    den = 2.0 * (WtW @ H)
    for i in range(cfg.n_cov):
        o, k = cfg.offsets[i], cfg.blocks[i]
        gnum, gden = _guided_h_terms(cfg, Bs[i], H[o:o + k], Ys_f[i], lam[i],
                                     eps)
        num[o:o + k] += gnum
        den[o:o + k] += gden
    H = torch.where(c[None, :] > 0, H * (num / _clamp(den, eps)), H)
    return W, Bs, H, (WtX, WtW)


def als_batch_update(cfg: MUConfig, hyper, W, Bs, H, X, Xf, Ys_f, r=None,
                     rg=None):
    """One block-cyclic ("ALS mode") MU step (reference main.py:523-588; the
    counterpart of ``alpine_tpu.ops.mu.als_batch_update``): for each block
    in order, W[idx], then B[idx] (covariate blocks), then H[idx]; later
    blocks see the earlier updates.  Arguments as ``joint_batch_update``'s
    (``Xf`` unused by the fused backend).  The inputs are not modified.

    X is read n_blocks + 1 times: one X·H_startᵀ serves every W numerator
    (block idx's rows of H change only in its own H update), and one WᵢᵀX a
    block, with block i's final Wᵢ.  Their row concatenation is WᵀX of the
    new W and is returned for the loss, with WtW None.  ``cfg.backend ==
    "fused"`` runs these passes through ``kernels.hxt`` and ``kernels.wtx``
    (their plain versions on the CPU), "plain" through ``_x_ht``/``_dot_x``
    on ``Xf``.

    ``r`` (as in ``joint_batch_update``) makes n_blocks calls a step: one
    at the start with X·H_startᵀ, block 0's H·H₀ᵀ and every covariate
    block's B statistics (a block's statistics read only its own rows of
    H, which no earlier block's update changes), then one with H·Hᵢᵀ
    before each later block's W update.  WᵢᵀX and the H updates stay
    local, but on a grid (``rg``) WᵢᵀX and WᵢᵀW are summed over the gene
    blocks before block i's H update: n_blocks calls a step."""
    lam, orth_w, alpha_w, l1_ratio, eps = hyper
    r, rg = r or _no_reduce, rg or _no_reduce
    o0, k0 = cfg.offsets[0], cfg.blocks[0]
    XHt = _xht_pass(cfg, X, Xf, H)
    HHi = H @ H[o0:o0 + k0].T
    bnums, bdens = _b_stats(cfg, hyper, Bs, H, Ys_f)
    XHt, HHi, bnums, bdens = r([XHt, HHi, bnums, bdens])
    W, H, Bs = W.clone(), H.clone(), list(Bs)
    WtX_rows = []
    for idx, (o, k) in enumerate(zip(cfg.offsets, cfg.blocks)):
        Hi = H[o:o + k]
        Wi = W[:, o:o + k]
        if idx:
            (HHi,) = r([H @ Hi.T])
        den = (2.0 * (W @ HHi)
               + (1.0 - l1_ratio) * alpha_w * Wi
               + orth_w * (torch.sum(Wi, dim=1, keepdim=True) - Wi)
               + l1_ratio * alpha_w)
        Wi = Wi * (2.0 * XHt[:, o:o + k] / _clamp(den, eps))
        W[:, o:o + k] = Wi
        if idx < cfg.n_cov:
            Bs[idx] = _update_b(cfg, hyper, idx, Bs[idx], bnums[idx],
                                bdens[idx], HHi[o:o + k])
        WtXi, WiW = rg([_wtx_pass(cfg, X, Xf, Wi), Wi.T @ W])
        WtX_rows.append(WtXi)
        num = 2.0 * WtXi
        den = 2.0 * (WiW @ H)
        if idx < cfg.n_cov:
            gnum, gden = _guided_h_terms(cfg, Bs[idx], Hi, Ys_f[idx], lam[idx],
                                         eps)
            num, den = num + gnum, den + gden
        H[o:o + k] = Hi * (num / _clamp(den, eps))
    return W, tuple(Bs), H, (torch.cat(WtX_rows), None)


def multinomial_counts(generator: torch.Generator, n: int,
                       weights: torch.Tensor) -> torch.Tensor:
    """One epoch of the balanced with-replacement draw over a probability
    vector, as a (len(weights),) float32 count vector on the weights'
    device (the counterpart of ``alpine_tpu.ops.mu.multinomial_counts``,
    used by the optimizer's weighted_fast folds, whose zero-padded cell
    axes hold no group tables): ``n`` cells drawn by ``torch.multinomial``,
    counted with an integer ``index_add_``.  Pad columns (weight 0) are
    never drawn and keep count 0."""
    idx = torch.multinomial(weights, n, replacement=True, generator=generator)
    counts = torch.zeros(weights.shape[0], dtype=torch.int32, device=weights.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts.to(torch.float32)


# the window sampler's sink columns for out-of-window draws (a power of 2)
_SINK = 1024


def grouped_balanced_counts(generator: torch.Generator, n: int, tables,
                            n_out: Optional[int] = None):
    """One epoch of the balanced sampler as a (n,) float32 count vector on
    the generator's device (the counterpart of
    ``alpine_tpu.ops.mu.grouped_balanced_counts``).

    With (start, m) tables the cell axis is sorted by joint group: group g
    holds columns [start[g], start[g] + m[g]).  Every group carries the
    same probability mass, so a draw is a group, uniform over the J
    groups, then a cell, uniform within it — two uniform vectors instead of
    an inverse-CDF search over n cells.  The draws are counted with an
    integer ``index_add_`` (exact; ``bincount`` would read the largest
    index back to the host and stall the fit loop every iteration).

    The window form ``(start_loc, m, off, m_loc)`` serves a process that
    holds ``n_out`` of the n cells (a group-sorted run of its own, from
    ``utils.sampling.window_group_tables``): it draws the same n (group,
    position) pairs from the same generator state, over the global group
    sizes m, and counts only the draws whose position in group g falls in
    its window [off[g], off[g] + m_loc[g]), at local column start_loc[g] +
    position − off[g].  The other draws go to sink columns past n_out
    that are sliced off (``index_add_`` cannot drop them): _SINK of them,
    picked by the draw's position, so that the out-of-window draws, most
    of the n on a wide mesh, do not all add at one address.  Every
    process draws with the same seed, so the processes' count vectors
    are, integer for integer, the single-process draw of their cells; the
    returned vector has n_out entries."""
    window = len(tables) == 4
    start, m = tables[:2]
    J = m.shape[0]
    u1 = torch.rand(n, generator=generator, device=m.device)
    u2 = torch.rand(n, generator=generator, device=m.device)
    gid = torch.clamp((u1 * J).to(torch.int64), max=J - 1)
    m_g = m[gid].to(torch.int64)
    pos = torch.minimum((u2 * m_g.to(torch.float32)).to(torch.int64), m_g - 1)
    if window:
        off, m_loc = tables[2][gid].to(torch.int64), tables[3][gid].to(torch.int64)
        lpos = pos - off
        cell = torch.where((lpos >= 0) & (lpos < m_loc),
                           start[gid].to(torch.int64) + lpos,
                           n_out + (pos & (_SINK - 1)))
        size = n_out + _SINK
    else:
        cell = start[gid].to(torch.int64) + pos
        size = n
    counts = torch.zeros(size, dtype=torch.int32, device=m.device)
    counts.index_add_(0, cell, torch.ones_like(cell, dtype=torch.int32))
    return counts[:n_out if window else n].to(torch.float32)


def compute_loss_parts(cfg: MUConfig, hyper, W, H, Bs, X, Xf, Ys_f, normX2,
                       WtX: Optional[torch.Tensor] = None,
                       WtW: Optional[torch.Tensor] = None,
                       kl_pad: int = 0, r=None, rg=None) -> torch.Tensor:
    """Loss vector [total, recon, pred_0, ...] on the full matrices
    (reference main.py:726-753), with the trace identity for recon.
    ``kl_pad`` zero columns of X, H and Ys (a tiled fit's pad) each add
    clamp(B·0, eps) = eps per label row to the KL prediction term; that
    constant is subtracted, so the pad never reaches the loss.  In a
    cell-sharded fit (``r``, as in ``joint_batch_update``) the cell sums —
    Σ(WᵀX)∘H, H Hᵀ and the prediction terms, each rank's pad constant
    already out — go in one call; ``normX2`` is the summed ‖X‖².  On a
    grid the WᵀX and WᵀW passed in are summed over the gene blocks
    already, and one computed here is summed by ``rg``."""
    lam, _, _, _, eps = hyper
    r, rg = r or _no_reduce, rg or _no_reduce
    if WtX is None:
        (WtX,) = rg([_dot_x(X, W.T, Xf)])
    if WtW is None:
        (WtW,) = rg([W.T @ W])
    dot = torch.sum(WtX * H)
    HHt = H @ H.T
    preds = []
    for i in range(cfg.n_cov):
        o, k = cfg.offsets[i], cfg.blocks[i]
        yhat = Bs[i] @ H[o:o + k]
        Y = Ys_f[i]
        if cfg.loss_kl:
            yh = _clamp(yhat, eps)
            pred = torch.sum(Y * torch.log(_clamp(Y / yh, eps)) - Y + yh)
            if kl_pad:
                pred = pred - cfg.n_labels[i] * kl_pad * eps
        else:
            d = Y - yhat
            pred = torch.sum(d * d)
        preds.append(pred)
    dot, HHt, preds = r([dot, HHt, tuple(preds)])
    recon = normX2 - 2.0 * dot + torch.sum(WtW * HHt)
    total = recon
    for i, pred in enumerate(preds):
        total = total + lam[i] * pred
    return torch.stack([total, recon, *preds])


def _check_inputs(cfg: MUConfig, W0, H0, X, Ys, n_cells: int,
                  sharded: bool = False) -> None:
    """Shapes of the inputs, X with ``n_cells`` columns (``cfg.n_cells``,
    or this process's cells in a sharded fit); a tiled fit's X (and Ys)
    may carry a zero pad to a tile multiple past n_cells (in a sharded fit,
    to the ranks' common width: any number of tiles), and H0 then has
    n_cells columns or X's."""
    t = cfg.tile
    if cfg.tiled:
        if cfg.weighted:
            raise ValueError("tiled and weighted sampling are exclusive")
        if cfg.use_als:
            raise ValueError("tiled sampling supports joint mode only")
        if X.shape[1] % t:
            raise ValueError(
                f"tiled sampling needs the cell axis padded to a multiple "
                f"of tile={t}; got {X.shape[1]} columns")
    n_x = X.shape[1]
    pad_ok = cfg.tiled and n_cells <= n_x and (sharded or n_x < n_cells + t)
    if not (n_x == n_cells or pad_ok) or H0.shape not in (
            (cfg.K, n_cells), (cfg.K, n_x)):
        raise ValueError(
            f"X must be (genes, {n_cells}) and H0 ({cfg.K}, "
            f"{n_cells}); got X {tuple(X.shape)}, H0 {tuple(H0.shape)}")
    if W0.shape != (X.shape[0], cfg.K) or len(Ys) != cfg.n_cov or any(
            y.shape[1] != n_x for y in Ys):
        raise ValueError("W0 must be (genes, K) and Ys hold one matrix per "
                         "covariate")


def progress_every(max_iter: int) -> int:
    """Iterations between two progress reports of a verbose fit: a tenth of
    the fit, at most 50 (the JAX package's chunk rule,
    alpine_tpu/models/alpine.py:814)."""
    return max(1, min(50, -(-max_iter // 10)))


def _report(progress, losses, it: int, max_iter: int) -> None:
    """``progress(done, objective loss)`` every ``progress_every(max_iter)``
    iterations and after the last one; the loss is read to the host there.
    With ``profiling.enable_debug_checks()`` every loss row is checked for
    non-finite values first."""
    profiling.check_loss_row(losses, it)
    done = it + 1
    if progress is not None and (done % progress_every(max_iter) == 0
                                 or done == max_iter):
        progress(done, float(losses[it, 0]))


def _column_shares(idx: torch.Tensor, batch: int, lo: int, hi: int):
    """A rank's share of each batch of a global epoch draw ``idx``: the
    draw cut into ⌈n / batch⌉ batches of ``batch`` cells (the last one
    short), each kept to the cells in [lo, hi) (the rank's, on a grid its
    column's) in draw order, duplicates included, and shifted by −lo; a
    share is empty where its batch holds none of them.  Two reads to the
    host an epoch: the kept cells and the shares' sizes."""
    keep = (idx >= lo) & (idx < hi)
    nb = -(-idx.shape[0] // batch)
    sizes = torch.nn.functional.pad(keep.to(torch.int32),
                                    (0, nb * batch - idx.shape[0]))
    return torch.split(idx[keep] - lo, sizes.view(nb, batch).sum(1).tolist())


def _fit_scan_steps(cfg: MUConfig, W0, H0, Bs0, X, Ys, hyper, draw_counts,
                    draw_cells, progress, group=None, n_local=None,
                    gene_group=None, cell_range=None):
    """Whole steps: the joint steps of the plain backend, ALS on either
    backend, and the random-minibatch, gathered weighted and tiled epochs
    of both (the minibatch branch of ``alpine_tpu.ops.mu.fit_scan`` and its
    ``_tiled_epoch``).  The fused backend runs every X product through the
    kernels (``hxt`` and ``wtx`` in the steps, ``wtx`` for a minibatch
    epoch's WᵀX) and makes no float32 copy of X.

    Full batch, iteration t is one step on all cells, and the loss takes
    that step's WᵀX and WᵀW.  With ``cfg.minibatch``, epoch t takes
    ``draw_cells(t)``: n cell indices (a permutation, or n balanced draws
    with replacement) or, when ``cfg.tiled``, a permutation of the tiles of
    ``cfg.tile`` adjacent columns (X's columns, a tile multiple, include a
    zero pad past n_cells).  The draws are cut into batches of
    ``cfg.eff_batch_size`` cells (tiled: that many rounded up to whole
    tiles); the last batch is short where the size does not divide the
    epoch (the JAX package zero-fills it, which adds nothing to any sum, so
    the two agree up to summation order).  Each batch copies X_b (in X's
    storage dtype: single columns, or contiguous runs of a tile per gene
    row), Ys_b and H_b, runs one step on them and scatters H_b back.  A
    cell drawn twice into one batch gets the same update in both columns
    (an H column's update reads only that column), so the scatter writes
    equal values.  The loss is taken once an epoch over all cells, less
    the pad's KL constant.

    With a process ``group`` (X, H0 and the Ys hold this rank's
    ``n_local`` cells; a tiled fit pads them to the ranks' common width)
    the steps' sums over cells are all-reduced (``r`` of the steps and of
    ``compute_loss_parts``; ‖X‖² once before the loop), so W, the Bs and
    the losses stay bit-equal across the ranks.  A full-batch ALS step
    makes n_blocks calls, its loss one more.  A minibatch epoch samples
    each rank's own cells (the JAX package's ``_build_sharded_minibatch_fit``
    stratifies by shard the same way): with nb = ⌈n_cells / batch size⌉,
    a batch takes ⌈w / nb⌉ of each rank's draws, w being the widest rank's
    units (cells, or tiles for a tiled fit, whose batch is rounded up to
    whole tiles; the ranks agree on w in one MAX all-reduce before the
    loop), and every rank runs the widest rank's batches: nb of them
    (fewer only where ⌈w / nb⌉·(nb − 1) ≥ w, when the last would be empty
    on every rank; the JAX package runs that all-pad batch, which zeroes
    W).  A rank with fewer units has short batches at the end of its
    epoch, or empty ones, which launch no kernel but join the all-reduce
    with zeros, so the ranks' collectives stay in step: one a batch and
    the loss's an epoch.

    With a ``gene_group`` too (a grid: X holds this rank's gene rows and
    W0 the same rows) the steps sum WᵀX and WᵀW over it (``rg``, counted
    under "genes iteration"), and ‖X‖² is summed over both axes before the
    loop ("genes setup").  An iteration then makes, over cells and over
    genes: joint and weighted_fast 2 and 1 (the step, the loss over
    cells), ALS n_blocks + 1 and n_blocks + 1 (the loss's WᵀW over genes).
    With a ``cell_range`` = (lo, hi), the cells of this rank's run (on a
    grid, of its cell column), a minibatch epoch takes the global draw
    instead: ``draw_cells(t)`` is the single-device epoch over the
    cfg.n_cells cells (a permutation, or n balanced draws with
    replacement: the JAX package's global sampler, not a shard-local
    one), and each rank keeps its share of every batch, the drawn cells in
    [lo, hi) in draw order, duplicates included (``_column_shares``).
    Every rank runs all nb = ⌈n / batch size⌉ batches, an empty share
    launching nothing but joining every all-reduce of its step with
    zeros, so the ranks stay in step.  An epoch then makes, over cells
    and (on a grid) over genes: a joint step's nb + 1 each (one a batch,
    the loss's; the loss sums WᵀX and WᵀW over the genes in one call),
    an ALS step's nb · n_blocks + 1 each (n_blocks a batch, the loss's).
    The ranks of a column hold the same share, so their calls over genes
    have equal lengths."""
    fused = cfg.backend == "fused"
    wide = torch.promote_types(X.dtype, torch.float32)  # float64 stays float64
    Xf = None if fused else X.to(wide)
    Ys_f = [y.to(wide) for y in Ys]
    (normX2,) = _all_reduce_parts([_norm_x2(X)], group, "setup")
    (normX2,) = _all_reduce_parts([normX2], gene_group, "genes setup")
    n_local = cfg.n_cells if n_local is None else n_local
    kl_pad = X.shape[1] - n_local
    r = reducer(group, "iteration")
    rg = reducer(gene_group, "genes iteration")

    def step(W, Bs, H, X, Xf, Ys_f, it):
        if cfg.use_als:
            return als_batch_update(cfg, hyper, W, Bs, H, X, Xf, Ys_f, r, rg)
        if cfg.weighted_counts:
            return joint_weighted_counts_update(cfg, hyper, W, Bs, H, X, Xf,
                                                Ys_f, draw_counts(it), r, rg)
        return joint_batch_update(cfg, hyper, W, Bs, H, X, Xf, Ys_f, r, rg)

    # a batch is a set of units: tiles of cfg.tile columns, or single cells
    unit = cfg.tile if cfg.tiled else 1
    n_units = X.shape[1] // unit
    if cell_range is not None:
        per_batch = cfg.eff_batch_size  # the global draw's batches
    elif group is None or not cfg.minibatch:
        per_batch = min(-(-cfg.eff_batch_size // unit), n_units)
    else:
        # the units of the widest rank, whose batches every rank runs
        from alpine_tpu_torch.parallel.distributed import all_reduce_max

        span = all_reduce_max(n_units, group, X.device)
        nb = -(-cfg.n_cells // cfg.eff_batch_size)
        batch = -(-span * unit // nb)  # ⌈w / nb⌉ cells
        per_batch = min(-(-batch // unit), span)

    def take(A, u):
        return A.view(A.shape[0], n_units, unit).index_select(1, u).view(
            A.shape[0], -1)

    W, Bs = W0, tuple(Bs0)
    H = H0.clone() if cfg.minibatch else H0  # batches scatter into H
    losses = torch.empty((cfg.max_iter, 2 + cfg.n_cov), device=X.device,
                         dtype=torch.promote_types(W0.dtype, torch.float32))
    for it in range(cfg.max_iter):
        if not cfg.minibatch:
            W, Bs, H, (WtX, WtW) = step(W, Bs, H, X, Xf, Ys_f, it)
        else:
            idx = draw_cells(it)
            if cell_range is not None:
                shares = _column_shares(idx, per_batch, *cell_range)
            else:
                n_batches = -(-(idx.shape[0] if group is None else span)
                              // per_batch)
                shares = [idx[b * per_batch:(b + 1) * per_batch]
                          for b in range(n_batches)]
            for u in shares:
                W, Bs, H_b, _ = step(
                    W, Bs, take(H, u), take(X, u),
                    None if fused else take(Xf, u),
                    [take(y, u) for y in Ys_f], it)
                H.view(H.shape[0], n_units, unit).index_copy_(
                    1, u, H_b.view(H.shape[0], -1, unit))
            WtX, WtW = (rg or _no_reduce)([_wtx_pass(cfg, X, Xf, W), W.T @ W])
        losses[it] = compute_loss_parts(cfg, hyper, W, H, Bs, X, Xf, Ys_f,
                                        normX2, WtX=WtX, WtW=WtW,
                                        kl_pad=kl_pad, r=r, rg=rg)
        _report(progress, losses, it, cfg.max_iter)
    return W, H, Bs, losses


# ---------------------------------------------------------------------------
# The fused fit loop: one kernel launch per iteration
# ---------------------------------------------------------------------------


def _b_stats(cfg: MUConfig, hyper, Bs, H, Ys_f, scale=None):
    """B-update statistics over the current H (reference main.py:617-626):
    KL -> ((Y ⊘ max(BH, eps)) Hᵀ, rowsum(H_i)); Frobenius -> (Y Hᵀ, unused).
    ``scale`` (weighted_fast): per-cell draw counts; the contractions
    against H are count-scaled, the per-column B@H is not."""
    eps = hyper[4]
    bnums, bdens = [], []
    for i in range(cfg.n_cov):
        o, k = cfg.offsets[i], cfg.blocks[i]
        Hi = H[o:o + k]
        His = Hi if scale is None else Hi * scale[None, :]
        if cfg.loss_kl:
            bnums.append((Ys_f[i] / _clamp(Bs[i] @ Hi, eps)) @ His.T)
            bdens.append(torch.sum(His, dim=1))
        else:
            bnums.append(Ys_f[i] @ His.T)
            bdens.append(H.new_zeros((k,)))
    return tuple(bnums), tuple(bdens)


def _update_bs(cfg: MUConfig, hyper, Bs, bnums, bdens, HHt):
    """Every B from the carried statistics (reference main.py:614-628)."""
    return tuple(_update_b(cfg, hyper, i, Bs[i], bnums[i], bdens[i],
                           HHt[o:o + k, o:o + k])
                 for i, (o, k) in enumerate(zip(cfg.offsets, cfg.blocks[:cfg.n_cov])))


def _update_w(hyper, W, XHt, HHt):
    """W update from the carried XHt/HHt (reference main.py:592-612)."""
    _, orth_w, alpha_w, l1_ratio, eps = hyper
    num = 2.0 * XHt
    den = (2.0 * (W @ HHt)
           + (1.0 - l1_ratio) * alpha_w * W
           + orth_w * (torch.sum(W, dim=1, keepdim=True) - W)
           + l1_ratio * alpha_w)
    return W * (num / _clamp(den, eps))


def _all_reduce_parts(parts, group, tag: str):
    """Sum the tensors of ``parts`` (each a tensor or a tuple of tensors)
    over the ranks of ``group`` with ONE all-reduce of a flat buffer
    (counted under ``tag``), and return them in the same structure.  With
    no group, ``parts`` comes back as it is."""
    if group is None:
        return parts
    from alpine_tpu_torch.parallel.distributed import all_reduce_sum

    def leaves(p):
        return p if isinstance(p, tuple) else (p,)

    flat = torch.cat([t.reshape(-1) for p in parts for t in leaves(p)])
    all_reduce_sum(flat, group, tag=tag)
    out, off = [], 0
    for p in parts:
        ts = []
        for t in leaves(p):
            ts.append(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
        out.append(tuple(ts) if isinstance(p, tuple) else ts[0])
    return out


def reducer(group, tag: str):
    """The steps' reducer over ``group``: ``parts`` summed in one
    all-reduce counted under ``tag`` (``_all_reduce_parts``), or None
    without a group (the steps then reduce nothing)."""
    if group is None:
        return None
    return lambda parts: _all_reduce_parts(parts, group, tag)


def _fit_scan_fused(cfg: MUConfig, W0, H0, Bs0, X, Ys, hyper, draw_counts,
                    progress, group=None):
    """Full-batch joint MU with one fused kernel per iteration (the
    counterpart of ``alpine_tpu.ops.mu._fit_scan_pallas``).  The loop
    carries (W, H, Bs, XHt, HHt, bnums, bdens): XHt = X Hᵀ and HHt = H Hᵀ
    feed the next W update, bnums/bdens the next B update, and the kernel
    returns all of them for the new H.  The kernels mask the ragged last
    cell tile, so nothing is padded and the KL loss carries no padding
    bias.

    With ``cfg.weighted_counts`` the statistics carried into iteration t
    are scaled by that iteration's draw c_t, so the kernel of iteration t
    gets [c_t, c_{t+1}]: row 0 masks its H update, row 1 scales the
    statistics it returns.  T iterations take T + 1 draws; the
    reconstruction loss uses the kernel's unscaled H Hᵀ (HHtU).  The first
    X Hᵀ is the kernel ``hxt``, so no float32 copy of X is made.

    With a process ``group`` (``fit_scan_sharded``) X, H0 and the Ys hold
    this process's cells and W0 and Bs0 are replicated.  The statistics
    before the loop (‖X‖², X Hᵀ, H Hᵀ, the B statistics) and after each
    kernel (X Hᵀ, H Hᵀ, the loss dot, the prediction losses, the B
    statistics, and with counts the unscaled H Hᵀ) are then summed over
    the group, each set in one all-reduce: genes × K + K × K + 1 + n_cov +
    Σ labels_i × k_i + Σ k_i values an iteration (K × K more with counts),
    whatever the cell count.  Every process computes W and the Bs from the
    same summed values, so they stay bit-identical across processes, and
    so does the loss history.  The shards are not padded (the JAX package
    pads each to a tile multiple and strips that padding's KL bias; the
    kernels here mask the ragged tile).  With counts each rank's
    ``draw_counts(t)`` is its own cells' part of the global draw
    (``grouped_balanced_counts``' window form), and each rank runs the
    kernel's counts mode (K4) on its cells; the JAX package runs the
    sharded weighted_fast fit through XLA under ``shard_map`` instead
    (alpine_tpu/ops/mu.py:1272-1289), the same function.
    ``cfg.backend == "plain"`` runs the kernels' plain versions in X's
    precision (float64 X stays float64), for the float64 checks."""
    from alpine_tpu_torch.ops import kernels

    lam, _, _, _, eps = hyper
    fused = cfg.backend == "fused"
    if fused:
        iteration, h_update = kernels.fused_iteration, kernels.fused_h_update
    else:
        iteration = kernels.fused_iteration_plain
        h_update = kernels.fused_h_update_plain
    normX2 = _norm_x2(X)
    W, H, Bs = W0, H0, tuple(Bs0)
    c_cur = draw_counts(0) if cfg.weighted_counts else None
    Hc = H if c_cur is None else H * c_cur[None, :]
    XHt = kernels.hxt(X, Hc.contiguous()).T if fused else _x_ht(X, _wide(X), Hc)
    HHt = Hc @ H.T
    Ys_f = [_wide(y) for y in Ys]
    bnums, bdens = (_b_stats(cfg, hyper, Bs, H, Ys_f, scale=c_cur)
                    if cfg.n_cov else ((), ()))
    del Ys_f, Hc
    normX2, XHt, HHt, bnums, bdens = _all_reduce_parts(
        [normX2, XHt, HHt, bnums, bdens], group, "setup")

    losses = torch.empty((cfg.max_iter, 2 + cfg.n_cov), device=X.device,
                         dtype=torch.promote_types(W0.dtype, torch.float32))
    for it in range(cfg.max_iter):
        W = _update_w(hyper, W, XHt, HHt)
        WtW = W.T @ W
        HHtU = ()  # the unscaled H Hᵀ of a counts iteration (its loss's)
        if cfg.weighted_counts:
            c_next = draw_counts(it + 1)
            Bs = _update_bs(cfg, hyper, Bs, bnums, bdens, HHt)
            (H, XHt, HHt, HHtU, lossdot, preds, bnums,
             bdens) = iteration(
                X, W, H, WtW, Ys, Bs, lam, eps, torch.stack([c_cur, c_next]),
                blocks=cfg.blocks, loss_kl=cfg.loss_kl)
            c_cur = c_next
        elif cfg.n_cov:
            Bs = _update_bs(cfg, hyper, Bs, bnums, bdens, HHt)
            H, XHt, HHt, lossdot, preds, bnums, bdens = iteration(
                X, W, H, WtW, Ys, Bs, lam, eps, blocks=cfg.blocks,
                loss_kl=cfg.loss_kl)
        else:
            H, XHt, HHt, lossdot = h_update(X, W, H, WtW, eps)
            preds = ()
        XHt, HHt, lossdot, preds, bnums, bdens, HHtU = _all_reduce_parts(
            [XHt, HHt, lossdot, tuple(preds), bnums, bdens, HHtU], group,
            "iteration")
        recon = normX2 - 2.0 * lossdot + torch.sum(
            WtW * (HHtU if cfg.weighted_counts else HHt))
        total = recon
        for i in range(cfg.n_cov):
            total = total + lam[i] * preds[i]
        losses[it] = torch.stack([total, recon, *preds])
        _report(progress, losses, it, cfg.max_iter)
    return W, H, Bs, losses


def fit_scan(cfg: MUConfig, W0, H0, Bs0, X, Ys, hyper, draw_counts=None,
             progress=None, draw_cells=None, group=None, gene_group=None,
             cell_range=None):
    """Run ``cfg.max_iter`` MU epochs.

    ``X`` (genes × cells) and ``Ys`` (labels_i × cells) are cast to the
    storage dtype; ``hyper = (lam, orth_W, alpha_W, l1_ratio_W, eps)`` with
    ``lam`` a float32 tensor on X's device and the rest Python floats.
    With ``cfg.weighted_counts``, ``draw_counts(t)`` returns draw t as a
    (n_cells,) float32 count tensor on X's device; iteration t uses draw t.
    With ``cfg.minibatch``, ``draw_cells(t)`` returns epoch t's (n_cells,)
    int64 cell indices on X's device, and with ``cfg.tiled`` its
    permutation of X's tiles: X and Ys then hold a zero pad to a tile
    multiple past n_cells, and H0 has n_cells columns or X's.
    ``progress(done, objective loss)``, when given, is called as
    ``progress_every`` says.

    With a process ``group`` (see ``fit_scan_sharded``) ``cfg.n_cells`` is
    the global cell count, H0 holds this process's cells and X and Ys the
    same (a tiled fit pads them to the ranks' common width), and
    ``draw_counts`` and ``draw_cells`` draw for this process's cells.
    Returns (W, H, Bs, losses), H with n_cells columns (this
    process's, with a group) and losses (max_iter, 2 + n_cov) on the
    device: [total, recon, pred_0, ...] per iteration.

    ``cell_range`` = (lo, hi), this process's cells (on a grid its
    column's), makes a minibatch fit over a group take the global draw:
    ``draw_cells`` then draws the single-device epoch of cfg.n_cells cells
    and the rank keeps its share of every batch (``_fit_scan_steps``).  A
    gathered weighted fit, an ALS minibatch fit and any minibatch fit on a
    grid need it; a random joint minibatch fit on a cell mesh without it
    samples each rank's own cells.

    On a ("genes", "cells") grid ``group`` is the process's cells group
    (its gene row) and ``gene_group`` its genes group (its cell column):
    X and W0 hold its gene block's rows, X, H0 and the Ys its cells, and
    ``draw_counts`` draws its column's counts.  Every fit runs as steps
    (``_fit_scan_steps``, P1/P2 on the block), never the fused loop, whose
    kernels need all of WᵀX inside.
    W comes back as this process's rows, bit-equal along its gene row; H
    bit-equal along its cell column; the Bs and losses on every process.
    Each sum over genes is one all-reduce of a column, whose length
    follows the column's cell count: where the gene axis has more than
    two processes and the columns hold different cell counts, the
    columns' WᵀW, and so the losses, may part by a rounding."""
    X = X.to(cfg.xdt).contiguous()
    Ys = [y.to(cfg.xdt).contiguous() for y in Ys]
    n_local = cfg.n_cells if group is None else H0.shape[1]
    _check_inputs(cfg, W0, H0, X, Ys, n_local, sharded=group is not None)
    if gene_group is not None and group is None:
        raise ValueError("a fit over a grid needs its cells group and its "
                         "genes group")
    if gene_group is not None and cfg.tiled:
        raise ValueError("tiled sampling runs on one device or a 1-D cell "
                         "mesh, not on a ('genes', 'cells') grid")
    # the fits over a group that take the global draw
    global_draw = group is not None and cfg.minibatch and not cfg.tiled and (
        cell_range is not None or gene_group is not None or cfg.weighted
        or cfg.use_als)
    if global_draw and (cell_range is None
                        or cell_range[1] - cell_range[0] != n_local):
        raise ValueError("a gathered weighted, ALS minibatch or grid minibatch "
                         "fit over processes needs this process's cell_range "
                         f"(lo, hi) of {n_local} cells; got {cell_range}")
    if cfg.weighted_counts and (draw_counts is None or not cfg.n_cov):
        raise ValueError("weighted_counts needs covariates and a draw_counts "
                         "callable (weighted sampling balances over them)")
    if cfg.weighted_counts and (cfg.use_als or cfg.minibatch):
        raise ValueError("weighted_counts is a full-epoch joint-mode strategy "
                         "(batch_size covering all cells, use_als=False)")
    if cfg.minibatch and draw_cells is None:
        raise ValueError("a minibatch or weighted fit needs a draw_cells "
                         "callable")
    W0, H0 = W0.contiguous(), H0.contiguous()
    if H0.shape[1] != X.shape[1]:
        # zero columns for a tiled fit's pad: fixed points of every update
        H0 = torch.nn.functional.pad(H0, (0, X.shape[1] - H0.shape[1]))
    Bs0 = tuple(b.contiguous() for b in Bs0)
    with matmul_precision(cfg.precision):
        if not (cfg.use_als or cfg.minibatch) and gene_group is None and (
                group is not None or cfg.backend == "fused"):
            W, H, Bs, losses = _fit_scan_fused(cfg, W0, H0, Bs0, X, Ys, hyper,
                                               draw_counts, progress, group)
        else:
            W, H, Bs, losses = _fit_scan_steps(
                cfg, W0, H0, Bs0, X, Ys, hyper, draw_counts, draw_cells,
                progress, group, n_local, gene_group,
                cell_range if global_draw else None)
    return W, H[:, :n_local], Bs, losses


def fit_scan_sharded(cfg: MUConfig, mesh, W0, H0, Bs0, X, Ys, hyper,
                     progress=None):
    """Full-batch MU (joint or ALS) over a 1-D cell mesh or a ("genes",
    "cells") grid, one process a device (the counterpart of
    ``alpine_tpu.ops.mu.fit_scan_sharded``): ``fit_scan`` over the mesh's
    process groups, which also runs the sampled modes given their draws.
    On a grid X and W0 hold this process's gene rows too.

    ``cfg.n_cells`` is the global cell count; ``X`` (genes × n_local),
    ``H0`` (K × n_local) and ``Ys`` hold this process's cells, ``W0`` and
    ``Bs0`` the replicated initial state; every process of the mesh calls
    this with the same ``cfg``, ``W0``, ``Bs0`` and ``hyper``.  Returns
    (W, H, Bs, losses) with H this process's columns and W, Bs and losses
    replicated (bit-identical on every process).  ``progress`` as in
    ``fit_scan``."""
    from alpine_tpu_torch.parallel.mesh import Placement

    placement = Placement(mesh)
    return fit_scan(cfg, W0, H0, Bs0, X, Ys, hyper, progress=progress,
                    group=placement.group, gene_group=placement.gene_group)


# ---------------------------------------------------------------------------
# Transform (out-of-sample projection)
# ---------------------------------------------------------------------------


def transform_scan(W, X, H0, eps: float, *, n_iter: int,
                   reduce=None) -> torch.Tensor:
    """Plain Frobenius MU projection onto a frozen W (reference
    main.py:705-709): H *= 2WᵀX / max(2(WᵀW)H, eps), with 2WᵀX and WᵀW
    hoisted out of the loop (and, on a grid, summed over the gene blocks
    by ``reduce``)."""
    num = 2.0 * (W.T @ X.float())
    WtW = W.T @ W
    if reduce is not None:
        num, WtW = reduce([num, WtW])
    H = H0
    for _ in range(n_iter):
        H = H * (num / _clamp(2.0 * (WtW @ H), eps))
    return H


def run_transform(W, X, H0, eps: float, *, n_iter: int,
                  precision: str = "highest", fused: bool = True,
                  reduce=None):
    """Projection entry point: the fused kernel (all iterations on chip
    per cell tile) or the plain loop.  ``2WᵀX`` widens X to f32 without
    rounding W, as the JAX package's transform does.

    On a cell mesh each process passes its own columns of X and H0 and
    gets its own columns back: a column's projection reads only that
    column and the replicated W, so it needs no communication (the JAX
    package's shard_map of the kernel).  On a grid it passes its block of
    X and W's rows of that block, and ``reduce`` sums 2WᵀX and 2WᵀW over
    the gene blocks (one all-reduce) before the kernel runs on its
    columns."""
    from alpine_tpu_torch.ops import kernels

    with matmul_precision(precision):
        if not fused:
            return transform_scan(W, X, H0, eps, n_iter=n_iter, reduce=reduce)
        num2 = 2.0 * (W.T @ X.float())
        WtW2 = 2.0 * (W.T @ W)
        if reduce is not None:
            num2, WtW2 = reduce([num2, WtW2])
        return kernels.fused_transform(num2, H0.contiguous(), WtW2, eps,
                                       n_iter=n_iter)


def reconstruct_expression_blocks(W, H, out, counts, block: int, device=None,
                                  precision: str = "highest",
                                  on_device: bool = True) -> None:
    """Fill ``out[lo:hi] = (W @ H[:, lo:hi]).T`` and ``counts[lo:hi]`` (the
    per-cell totals) one ``block``-cell slab at a time (the counterpart of
    ``alpine_tpu.ops.mu.reconstruct_expression_blocks``): the transient
    memory is one slab, and ``out`` may be an ``np.memmap``.  Each cell's
    values depend only on its own column of H, so the blocking changes no
    value.

    By default W stays resident on ``device`` (the CPU when None) and each
    slab's product is a ``torch.matmul`` there under ``matmul_precision``
    (true fp32 at "highest"); ``on_device=False`` computes it with numpy on
    the host, as the JAX package does by default."""
    n = H.shape[1]
    if on_device:
        Wd = torch.from_numpy(np.ascontiguousarray(W, np.float32)).to(device)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        if on_device:
            Hd = torch.from_numpy(np.ascontiguousarray(H[:, lo:hi],
                                                       np.float32)).to(device)
            with matmul_precision(precision):
                slab = (Wd @ Hd).cpu().numpy().T
        else:
            slab = np.dot(W, H[:, lo:hi]).astype(np.float32).T
        out[lo:hi] = slab
        # the totals come from the C-contiguous rows of out, not from the
        # transposed slab: numpy's pairwise summation order follows the
        # layout, and the slab's would make the totals (and so the median
        # library size) depend on the block size by an ulp
        counts[lo:hi] = out[lo:hi].sum(axis=1)


# ---------------------------------------------------------------------------
# Initialization & scaling
# ---------------------------------------------------------------------------


def init_matrices(cfg: MUConfig, n_genes: int, generator: torch.Generator,
                  eps: float, device) -> Tuple[torch.Tensor, torch.Tensor,
                                               Tuple[torch.Tensor, ...]]:
    """Uniform(0, 1) init clamped at eps (reference main.py:436-472), drawn
    on the host from ``generator`` (so a seed gives the same state on every
    device) and moved to ``device``."""
    def draw(*shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return _clamp(u, eps).to(device)

    W = draw(n_genes, cfg.K)
    H = draw(cfg.K, cfg.n_cells)
    Bs = tuple(draw(cfg.n_labels[i], cfg.blocks[i]) for i in range(cfg.n_cov))
    return W, H, Bs


def scale_matrices(blocks: Sequence[int], W, H, Bs):
    """Column-normalize W to unit sum and rescale H rows and B columns so
    W@H and B@H are unchanged (reference main.py:772-781).  All-zero
    columns keep scale 1."""
    s = torch.sum(W, dim=0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    offsets = block_offsets(tuple(blocks))
    newBs = tuple(B / s[offsets[i]:offsets[i] + blocks[i]]
                  for i, B in enumerate(Bs))
    return W / s, H * s[:, None], newBs


# ---------------------------------------------------------------------------
# Component bucketing (alpine_tpu/ops/mu.py:1672-1739)
# ---------------------------------------------------------------------------


def bucket_blocks(blocks: Tuple[int, ...], bucket: int) -> Tuple[int, ...]:
    """Each block size rounded up to a multiple of ``bucket``."""
    return tuple(-(-k // bucket) * bucket for k in blocks)


# about sqrt(2)-spaced size levels for auto bucketing
_GEO_LEVELS = (2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256,
               384, 512, 768, 1024)


def auto_bucket_blocks(blocks: Tuple[int, ...]) -> Tuple[int, ...]:
    """Every guided block padded to the level of the largest one, the
    unguided block to its own level (past the table: a multiple of 128),
    so a search over component splits meets few distinct shapes."""
    def level(k: int) -> int:
        for lv in _GEO_LEVELS:
            if lv >= k:
                return lv
        return -(-k // 128) * 128
    guided = blocks[:-1]
    if not guided:
        return (level(blocks[-1]),)
    shared = level(max(guided))
    return (shared,) * len(guided) + (level(blocks[-1]),)


def block_valid_mask(blocks: Tuple[int, ...], true_blocks: Tuple[int, ...],
                     device=None) -> torch.Tensor:
    """Boolean (K_padded,) mask of the genuine components of each padded
    block."""
    return torch.cat([torch.arange(kp, device=device) < kt
                      for kp, kt in zip(blocks, true_blocks)])


def mask_block_padding(blocks: Tuple[int, ...], true_blocks: Tuple[int, ...],
                       W, H, Bs):
    """Zero the phantom components of bucket-padded blocks.  A zero
    component is a fixed point of every MU update (its numerators are
    contractions with zero rows or columns) and adds nothing to W·H, B·H,
    HHᵀ, WᵀW or any loss term, so the genuine components of a padded fit
    follow the unpadded fit's trajectory from the same genuine values."""
    valid = block_valid_mask(blocks, true_blocks, W.device)
    offsets = block_offsets(tuple(blocks))
    return (W * valid[None, :], H * valid[:, None],
            tuple(B * valid[offsets[i]:offsets[i] + blocks[i]][None, :]
                  for i, B in enumerate(Bs)))

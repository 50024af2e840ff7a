"""Multiplicative-update (MU) numerical core of the port: full-batch joint
fits and the out-of-sample projection.

Counterpart of ``alpine_tpu/ops/mu.py`` (the full-batch joint subset).  The
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

A verbose fit passes ``progress``: the loops call it every
``progress_every(max_iter)`` iterations and after the last with the
iterations done and the objective loss, which syncs the host there.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

# The model-layer data_dtype vocabulary, narrowest storage first.
STORAGE_DTYPES = ("int8", "int16", "bfloat16", "float32")
DATA_DTYPES = ("auto",) + STORAGE_DTYPES

_STORAGE = {"int8": torch.int8, "int16": torch.int16,
            "bfloat16": torch.bfloat16, "float32": torch.float32}


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

    def __post_init__(self):
        if self.backend not in ("fused", "plain"):
            raise ValueError("backend must be 'fused' or 'plain'")
        if self.x_dtype not in STORAGE_DTYPES:
            raise ValueError(f"x_dtype must be one of {STORAGE_DTYPES}")

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


def _norm_x2(X: torch.Tensor) -> torch.Tensor:
    """‖X‖_F² in float32 (integer X widens first: int squares overflow),
    summed over chunks of about 2^24 values, so that no float32 copy of
    all of X is made (a single chunk, and one sum, below that size)."""
    rows = max(1, (1 << 24) // max(1, X.shape[1]))
    total = 0.0
    for chunk in torch.split(X, rows):
        cf = chunk.float()
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


def _update_b(cfg: MUConfig, B, Hi, Yi, lam_i, eps, HHt_ii):
    """B update (reference main.py:614-628)."""
    if cfg.loss_kl:
        num = lam_i * ((Yi / _clamp(B @ Hi, eps)) @ Hi.T)
        den = lam_i * torch.sum(Hi, dim=1)[None, :].expand_as(B)
    else:
        num = 2.0 * (Yi @ Hi.T)
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


def joint_batch_update(cfg: MUConfig, hyper, W, Bs, H, X, Xf, Ys_f):
    """One joint MU step: W, then Bs, then H (reference main.py:589-663).
    ``X`` is the stored X (its dtype decides the rounding), ``Xf`` the same
    values in f32 and ``Ys_f`` the label matrices in f32.  Returns
    (W, Bs, H, (WtX, WtW)) with WtX/WtW valid for the new W."""
    lam, orth_w, alpha_w, l1_ratio, eps = hyper

    HHt = H @ H.T
    num = 2.0 * _x_ht(X, Xf, H)
    den = (2.0 * (W @ HHt)
           + (1.0 - l1_ratio) * alpha_w * W
           + orth_w * (torch.sum(W, dim=1, keepdim=True) - W)
           + l1_ratio * alpha_w)
    W = W * (num / _clamp(den, eps))

    newBs = []
    for i in range(cfg.n_cov):
        o, k = cfg.offsets[i], cfg.blocks[i]
        newBs.append(_update_b(cfg, Bs[i], H[o:o + k], Ys_f[i], lam[i], eps,
                               HHt[o:o + k, o:o + k]))
    Bs = tuple(newBs)

    WtX = _dot_x(X, W.T, Xf)
    WtW = W.T @ W
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
                                 c):
    """One weighted_fast joint MU step over a whole epoch, with the epoch's
    draw given as per-cell counts ``c`` (n,) (the counterpart of
    ``alpine_tpu.ops.mu.joint_weighted_counts_update``).  A contraction
    over the drawn multiset is a count-weighted one over all cells —
    H_D H_Dᵀ = (c ⊙ H) Hᵀ, X_D H_Dᵀ = X (c ⊙ H)ᵀ, and likewise for the B
    statistics — while the H update is per column, so undrawn cells
    (c = 0) keep their H.  ``c ⊙ H`` is rounded to X's compute dtype as a
    whole, as the JAX step rounds it."""
    lam, orth_w, alpha_w, l1_ratio, eps = hyper
    Hc = H * c[None, :]

    HHt = Hc @ H.T
    num = 2.0 * _x_ht(X, Xf, Hc)
    den = (2.0 * (W @ HHt)
           + (1.0 - l1_ratio) * alpha_w * W
           + orth_w * (torch.sum(W, dim=1, keepdim=True) - W)
           + l1_ratio * alpha_w)
    W = W * (num / _clamp(den, eps))

    bnums, bdens = _b_stats(cfg, hyper, Bs, H, Ys_f, scale=c)
    Bs = _update_bs(cfg, hyper, Bs, bnums, bdens, HHt)

    WtX = _dot_x(X, W.T, Xf)
    WtW = W.T @ W
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


def als_batch_update(cfg: MUConfig, hyper, W, Bs, H, X, Xf, Ys_f):
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
    on ``Xf``."""
    from alpine_tpu_torch.ops import kernels

    lam, orth_w, alpha_w, l1_ratio, eps = hyper
    fused = cfg.backend == "fused"
    XHt = kernels.hxt(X, H).T if fused else _x_ht(X, Xf, H)
    W, H, Bs = W.clone(), H.clone(), list(Bs)
    WtX_rows = []
    for idx, (o, k) in enumerate(zip(cfg.offsets, cfg.blocks)):
        Hi = H[o:o + k]
        Wi = W[:, o:o + k]
        den = (2.0 * (W @ (H @ Hi.T))
               + (1.0 - l1_ratio) * alpha_w * Wi
               + orth_w * (torch.sum(Wi, dim=1, keepdim=True) - Wi)
               + l1_ratio * alpha_w)
        Wi = Wi * (2.0 * XHt[:, o:o + k] / _clamp(den, eps))
        W[:, o:o + k] = Wi
        if idx < cfg.n_cov:
            Bs[idx] = _update_b(cfg, Bs[idx], Hi, Ys_f[idx], lam[idx], eps,
                                None if cfg.loss_kl else Hi @ Hi.T)
        WtXi = (kernels.wtx(X, Wi.contiguous()) if fused
                else _dot_x(X, Wi.T, Xf))
        WtX_rows.append(WtXi)
        num = 2.0 * WtXi
        den = 2.0 * ((Wi.T @ W) @ H)
        if idx < cfg.n_cov:
            gnum, gden = _guided_h_terms(cfg, Bs[idx], Hi, Ys_f[idx], lam[idx],
                                         eps)
            num, den = num + gnum, den + gden
        H[o:o + k] = Hi * (num / _clamp(den, eps))
    return W, tuple(Bs), H, (torch.cat(WtX_rows), None)


def grouped_balanced_counts(generator: torch.Generator, n: int, tables):
    """One epoch of the balanced sampler as a (n,) float32 count vector on
    the generator's device (the counterpart of
    ``alpine_tpu.ops.mu.grouped_balanced_counts`` with (start, m) tables).

    The cell axis is sorted by joint group: group g holds columns
    [start[g], start[g] + m[g]).  Every group carries the same probability
    mass, so a draw is a group, uniform over the J groups, then a cell,
    uniform within it — two uniform vectors instead of an inverse-CDF
    search over n cells.  The draws are counted with an integer
    ``index_add_`` (exact; ``bincount`` would read the largest index back to
    the host and stall the fit loop every iteration)."""
    start, m = tables
    J = m.shape[0]
    u1 = torch.rand(n, generator=generator, device=m.device)
    u2 = torch.rand(n, generator=generator, device=m.device)
    gid = torch.clamp((u1 * J).to(torch.int64), max=J - 1)
    m_g = m[gid].to(torch.int64)
    pos = torch.minimum((u2 * m_g.to(torch.float32)).to(torch.int64), m_g - 1)
    cell = start[gid].to(torch.int64) + pos
    counts = torch.zeros(n, dtype=torch.int32, device=m.device)
    counts.index_add_(0, cell, torch.ones_like(cell, dtype=torch.int32))
    return counts.to(torch.float32)


def compute_loss_parts(cfg: MUConfig, hyper, W, H, Bs, X, Xf, Ys_f, normX2,
                       WtX: Optional[torch.Tensor] = None,
                       WtW: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Loss vector [total, recon, pred_0, ...] on the full matrices
    (reference main.py:726-753), with the trace identity for recon."""
    lam, _, _, _, eps = hyper
    if WtX is None:
        WtX = _dot_x(X, W.T, Xf)
    if WtW is None:
        WtW = W.T @ W
    HHt = H @ H.T
    recon = normX2 - 2.0 * torch.sum(WtX * H) + torch.sum(WtW * HHt)
    parts = [recon]
    total = recon
    for i in range(cfg.n_cov):
        o, k = cfg.offsets[i], cfg.blocks[i]
        yhat = Bs[i] @ H[o:o + k]
        Y = Ys_f[i]
        if cfg.loss_kl:
            yh = _clamp(yhat, eps)
            pred = torch.sum(Y * torch.log(_clamp(Y / yh, eps)) - Y + yh)
        else:
            d = Y - yhat
            pred = torch.sum(d * d)
        parts.append(pred)
        total = total + lam[i] * pred
    return torch.stack([total] + parts)


def _check_inputs(cfg: MUConfig, W0, H0, X, Ys) -> None:
    if X.shape[1] != cfg.n_cells or H0.shape != (cfg.K, cfg.n_cells):
        raise ValueError(
            f"X must be (genes, {cfg.n_cells}) and H0 ({cfg.K}, "
            f"{cfg.n_cells}); got X {tuple(X.shape)}, H0 {tuple(H0.shape)}")
    if W0.shape != (X.shape[0], cfg.K) or len(Ys) != cfg.n_cov:
        raise ValueError("W0 must be (genes, K) and Ys hold one matrix per "
                         "covariate")


def progress_every(max_iter: int) -> int:
    """Iterations between two progress reports of a verbose fit: a tenth of
    the fit, at most 50 (the JAX package's chunk rule,
    alpine_tpu/models/alpine.py:814)."""
    return max(1, min(50, -(-max_iter // 10)))


def _report(progress, losses, it: int, max_iter: int) -> None:
    """``progress(done, objective loss)`` every ``progress_every(max_iter)``
    iterations and after the last one; the loss is read to the host there."""
    done = it + 1
    if progress is not None and (done % progress_every(max_iter) == 0
                                 or done == max_iter):
        progress(done, float(losses[it, 0]))


def _fit_scan_steps(cfg: MUConfig, W0, H0, Bs0, X, Ys, hyper, draw_counts,
                    progress):
    """One whole step an iteration, and the loss from its WᵀX (and WᵀW):
    the joint steps of the plain backend, and ALS on either backend (the
    fused one runs its X passes as kernels and needs no float32 copy of
    X)."""
    Xf = X.float() if cfg.backend == "plain" else None
    Ys_f = [y.float() for y in Ys]
    normX2 = _norm_x2(X)
    W, H, Bs = W0, H0, tuple(Bs0)
    losses = torch.empty((cfg.max_iter, 2 + cfg.n_cov), dtype=torch.float32,
                         device=X.device)
    for it in range(cfg.max_iter):
        if cfg.use_als:
            W, Bs, H, (WtX, WtW) = als_batch_update(cfg, hyper, W, Bs, H, X,
                                                    Xf, Ys_f)
        elif cfg.weighted_counts:
            W, Bs, H, (WtX, WtW) = joint_weighted_counts_update(
                cfg, hyper, W, Bs, H, X, Xf, Ys_f, draw_counts(it))
        else:
            W, Bs, H, (WtX, WtW) = joint_batch_update(cfg, hyper, W, Bs, H, X,
                                                      Xf, Ys_f)
        losses[it] = compute_loss_parts(cfg, hyper, W, H, Bs, X, Xf, Ys_f,
                                        normX2, WtX=WtX, WtW=WtW)
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
            bdens.append(torch.zeros((k,), dtype=torch.float32, device=H.device))
    return tuple(bnums), tuple(bdens)


def _update_bs(cfg: MUConfig, hyper, Bs, bnums, bdens, HHt):
    """B_t from the carried statistics (reference main.py:614-628)."""
    lam, _, _, _, eps = hyper
    out = []
    for i in range(cfg.n_cov):
        o, k = cfg.offsets[i], cfg.blocks[i]
        B = Bs[i]
        if cfg.loss_kl:
            num = lam[i] * bnums[i]
            den = lam[i] * bdens[i][None, :].expand_as(B)
        else:
            num = 2.0 * bnums[i]
            den = 2.0 * (B @ HHt[o:o + k, o:o + k])
        out.append(B * (num / _clamp(den, eps)))
    return tuple(out)


def _update_w(hyper, W, XHt, HHt):
    """W update from the carried XHt/HHt (reference main.py:592-612)."""
    _, orth_w, alpha_w, l1_ratio, eps = hyper
    num = 2.0 * XHt
    den = (2.0 * (W @ HHt)
           + (1.0 - l1_ratio) * alpha_w * W
           + orth_w * (torch.sum(W, dim=1, keepdim=True) - W)
           + l1_ratio * alpha_w)
    return W * (num / _clamp(den, eps))


def _fit_scan_fused(cfg: MUConfig, W0, H0, Bs0, X, Ys, hyper, draw_counts,
                    progress):
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
    X Hᵀ is the kernel ``hxt``, so no float32 copy of X is made."""
    from alpine_tpu_torch.ops import kernels

    lam, _, _, _, eps = hyper
    normX2 = _norm_x2(X)
    W, H, Bs = W0, H0, tuple(Bs0)
    c_cur = draw_counts(0) if cfg.weighted_counts else None
    Hc = H if c_cur is None else H * c_cur[None, :]
    XHt = kernels.hxt(X, Hc.contiguous()).T
    HHt = Hc @ H.T
    Ys_f = [y.float() for y in Ys]
    bnums, bdens = (_b_stats(cfg, hyper, Bs, H, Ys_f, scale=c_cur)
                    if cfg.n_cov else ((), ()))
    del Ys_f, Hc

    losses = torch.empty((cfg.max_iter, 2 + cfg.n_cov), dtype=torch.float32,
                         device=X.device)
    for it in range(cfg.max_iter):
        W = _update_w(hyper, W, XHt, HHt)
        WtW = W.T @ W
        if cfg.weighted_counts:
            c_next = draw_counts(it + 1)
            Bs = _update_bs(cfg, hyper, Bs, bnums, bdens, HHt)
            (H, XHt, HHt, HHtU, lossdot, preds, bnums,
             bdens) = kernels.fused_iteration(
                X, W, H, WtW, Ys, Bs, lam, eps, torch.stack([c_cur, c_next]),
                blocks=cfg.blocks, loss_kl=cfg.loss_kl)
            c_cur = c_next
        elif cfg.n_cov:
            Bs = _update_bs(cfg, hyper, Bs, bnums, bdens, HHt)
            H, XHt, HHt, lossdot, preds, bnums, bdens = kernels.fused_iteration(
                X, W, H, WtW, Ys, Bs, lam, eps, blocks=cfg.blocks,
                loss_kl=cfg.loss_kl)
            HHtU = HHt
        else:
            H, XHt, HHt, lossdot = kernels.fused_h_update(X, W, H, WtW, eps)
            HHtU, preds = HHt, ()
        recon = normX2 - 2.0 * lossdot + torch.sum(WtW * HHtU)
        total = recon
        for i in range(cfg.n_cov):
            total = total + lam[i] * preds[i]
        losses[it] = torch.stack([total, recon, *preds])
        _report(progress, losses, it, cfg.max_iter)
    return W, H, Bs, losses


def fit_scan(cfg: MUConfig, W0, H0, Bs0, X, Ys, hyper, draw_counts=None,
             progress=None):
    """Run ``cfg.max_iter`` full-epoch joint MU iterations.

    ``X`` (genes × cells) and ``Ys`` (labels_i × cells) are cast to the
    storage dtype; ``hyper = (lam, orth_W, alpha_W, l1_ratio_W, eps)`` with
    ``lam`` a float32 tensor on X's device and the rest Python floats.
    With ``cfg.weighted_counts``, ``draw_counts(t)`` returns draw t as a
    (n_cells,) float32 count tensor on X's device; iteration t uses draw t.
    ``progress(done, objective loss)``, when given, is called as
    ``progress_every`` says.  Returns (W, H, Bs, losses) with losses
    (max_iter, 2 + n_cov) on the device: [total, recon, pred_0, ...] per
    iteration."""
    X = X.to(cfg.xdt).contiguous()
    Ys = [y.to(cfg.xdt).contiguous() for y in Ys]
    _check_inputs(cfg, W0, H0, X, Ys)
    if cfg.weighted_counts and (draw_counts is None or not cfg.n_cov):
        raise ValueError("weighted_counts needs covariates and a draw_counts "
                         "callable (weighted sampling balances over them)")
    if cfg.weighted_counts and cfg.use_als:
        raise ValueError("weighted_counts is a full-epoch joint-mode strategy "
                         "(batch_size covering all cells, use_als=False)")
    fused_joint = cfg.backend == "fused" and not cfg.use_als
    run = _fit_scan_fused if fused_joint else _fit_scan_steps
    with matmul_precision(cfg.precision):
        return run(cfg, W0.contiguous(), H0.contiguous(),
                   tuple(b.contiguous() for b in Bs0), X, Ys, hyper,
                   draw_counts, progress)


# ---------------------------------------------------------------------------
# Transform (out-of-sample projection)
# ---------------------------------------------------------------------------


def transform_scan(W, X, H0, eps: float, *, n_iter: int) -> torch.Tensor:
    """Plain Frobenius MU projection onto a frozen W (reference
    main.py:705-709): H *= 2WᵀX / max(2(WᵀW)H, eps), with 2WᵀX and WᵀW
    hoisted out of the loop."""
    num = 2.0 * (W.T @ X.float())
    WtW = W.T @ W
    H = H0
    for _ in range(n_iter):
        H = H * (num / _clamp(2.0 * (WtW @ H), eps))
    return H


def run_transform(W, X, H0, eps: float, *, n_iter: int,
                  precision: str = "highest", fused: bool = True):
    """Projection entry point: the fused kernel (all iterations on chip
    per cell tile) or the plain loop.  ``2WᵀX`` widens X to f32 without
    rounding W, as the JAX package's transform does."""
    from alpine_tpu_torch.ops import kernels

    with matmul_precision(precision):
        if not fused:
            return transform_scan(W, X, H0, eps, n_iter=n_iter)
        num2 = 2.0 * (W.T @ X.float())
        WtW2 = 2.0 * (W.T @ W)
        return kernels.fused_transform(num2, H0.contiguous(), WtW2, eps,
                                       n_iter=n_iter)


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

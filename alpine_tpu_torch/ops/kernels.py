"""The port's hand-written kernels: wrappers, plain versions, tile rule and
launch counts.  Counterpart of ``alpine_tpu/ops/pallas_kernels.py``.

Each wrapper checks its inputs and, for CUDA tensors, launches its kernel
from ``csrc/`` (built at first use, see ops/_build.py) on the current
stream.  It runs its plain PyTorch version only for CPU tensors: a CUDA
tensor launches the kernel or raises, and a failed build raises.

``launches`` counts each wrapper's kernel launches (plain runs do not
count), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from alpine_tpu_torch.ops.mu import (
    block_offsets, guided_width, round_partner,
)

launches: Dict[str, int] = {"fused_iteration": 0, "fused_h_update": 0,
                            "fused_transform": 0}

# X storage dtype -> code of csrc/common.cuh:XType
_XTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int16: 3}
_THREADS = 256
_MAX_TILE_VALUES = 4096  # csrc/common.cuh: kThreads * kMaxOut
_MAX_SMEM = 232448  # bytes of dynamic shared memory a Hopper block may use
# Grid sizes of fused_iteration's two passes: fixed numbers (not the SM
# count), so a given shape sums its partials in the same order on any card.
# Several blocks per SM hide the latency of each block's staged loads.
_MAX_PART_BLOCKS = 2112  # blocks of the per-tile pass (16 per H100 SM)
_TARGET_HXT_BLOCKS = 4224  # blocks of the X Hnᵀ pass (32 per H100 SM)
_CELL_CHUNK = 32  # csrc/fused_iteration.cu: kCellChunk
_GENE_CHUNK = 16  # csrc/fused_iteration.cu: kGeneChunk


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def tile_width(K: int) -> int:
    """The port's tile rule: cells per tile (and genes per block of the
    X Hnᵀ pass) for K components.  A block keeps a K × width output tile in
    registers, at most 4096 values, so the width halves from 64 as K grows;
    K > 512 is not supported by the kernels."""
    if not 1 <= K <= _MAX_TILE_VALUES // 8:
        raise ValueError(f"the CUDA kernels support 1 <= K <= "
                         f"{_MAX_TILE_VALUES // 8} components, got K={K}")
    w = 64
    while K * w > _MAX_TILE_VALUES:
        w //= 2
    return w


def _iter_smem_bytes(K: int, T: int, L: int, Kg: int) -> int:
    """csrc/fused_iteration.cu:iter_smem_floats, in bytes."""
    TP = T + 1
    return 4 * (_GENE_CHUNK * K + _GENE_CHUNK * T + 3 * K * TP + 3 * L * TP
                + L * Kg + 2 * Kg + _THREADS)


def _embed_b(Bs: Sequence[torch.Tensor], blocks: Tuple[int, ...]) -> torch.Tensor:
    """Block-embedded Bg (Σlabels × Kg): B_c at its block's columns, exact
    zeros elsewhere, so one product serves every covariate."""
    Kg = guided_width(blocks)
    L = sum(b.shape[0] for b in Bs)
    Bg = torch.zeros((L, Kg), dtype=torch.float32, device=Bs[0].device)
    row = 0
    for c, (B, o) in enumerate(zip(Bs, block_offsets(blocks))):
        Bg[row:row + B.shape[0], o:o + blocks[c]] = B
        row += B.shape[0]
    return Bg


def _lam_rows(lam: torch.Tensor, blocks: Tuple[int, ...]) -> torch.Tensor:
    """λ of each guided row of H (Kg,)."""
    return torch.cat([lam[c:c + 1].expand(k) for c, k in enumerate(blocks[:-1])])


def _split_stats(blocks, n_labels, bnum_all, rowsum, pred_rows):
    """Per-covariate (preds, bnums, bdens), each sliced to its block."""
    preds, bnums, bdens = [], [], []
    row = 0
    for c, (o, nl) in enumerate(zip(block_offsets(blocks), n_labels)):
        k = blocks[c]
        bnums.append(bnum_all[row:row + nl, o:o + k])
        bdens.append(rowsum[o:o + k])
        preds.append(torch.sum(pred_rows[row:row + nl]))
        row += nl
    return tuple(preds), tuple(bnums), tuple(bdens)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def fused_iteration_plain(X, W, H, WtW, Ys, Bs, lam, eps, *, blocks, loss_kl):
    """Plain PyTorch version of ``fused_iteration`` (same arguments and
    return tuple)."""
    blocks = tuple(blocks)
    Xf = X.float()
    WtX = round_partner(W, X.dtype).T @ Xf
    num = 2.0 * WtX
    den = 2.0 * (WtW @ H)
    Kg = guided_width(blocks)
    if Ys:
        Yf = torch.cat([y.float() for y in Ys])
        Bg = _embed_b(Bs, blocks)
        lam_rows = _lam_rows(lam, blocks)[:, None]
        BH = Bg @ H[:Kg]
        if loss_kl:
            num[:Kg] += lam_rows * (Bg.T @ (Yf / torch.clamp(BH, min=eps)))
            den[:Kg] += lam_rows * torch.sum(Bg, dim=0)[:, None]
        else:
            num[:Kg] += 2.0 * lam_rows * (Bg.T @ Yf)
            den[:Kg] += 2.0 * lam_rows * (Bg.T @ BH)
    Hn = H * (num / torch.clamp(den, min=eps))
    XHt = (round_partner(Hn, X.dtype) @ Xf.T).T
    HHt = Hn @ Hn.T
    lossdot = torch.sum(WtX * Hn)
    if not Ys:
        return Hn, XHt, HHt, lossdot, (), (), ()
    yhat = Bg @ Hn[:Kg]
    if loss_kl:
        yh = torch.clamp(yhat, min=eps)
        Q = Yf / yh
        E = Yf * torch.log(torch.clamp(Q, min=eps)) - Yf + yh
    else:
        Q, E = Yf, (Yf - yhat) ** 2
    preds, bnums, bdens = _split_stats(
        blocks, [y.shape[0] for y in Ys], Q @ Hn.T, torch.sum(Hn, dim=1),
        torch.sum(E, dim=1))
    return Hn, XHt, HHt, lossdot, preds, bnums, bdens


def fused_h_update_plain(X, W, H, WtW, eps):
    """Plain PyTorch version of ``fused_h_update``."""
    return fused_iteration_plain(X, W, H, WtW, (), (), None, eps,
                                 blocks=(H.shape[0],), loss_kl=True)[:4]


def fused_transform_plain(num2, H0, WtW2, eps, *, n_iter):
    """Plain PyTorch version of ``fused_transform``."""
    H = H0
    for _ in range(n_iter):
        H = H * (num2 / torch.clamp(WtW2 @ H, min=eps))
    return H


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_or_cpu(X: torch.Tensor) -> bool:
    """True for CUDA inputs (launch the kernel), False for CPU inputs (run
    the plain version); any other device raises."""
    if X.device.type == "cuda":
        return True
    if X.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {X.device}")


def _launch_iteration(X, W, H, WtW, Ys, Bs, lam, eps, blocks, loss_kl):
    """Run csrc/fused_iteration.cu; returns (Hn, XHt, stats, n_labels) with
    stats = [HHt (K·K), rowsum (K), Bnum (L·K), pred rows (L), lossdot]."""
    from alpine_tpu_torch.ops import _build

    dev = X.device
    f32 = torch.float32
    if X.dim() != 2 or X.dtype not in _XTYPE:
        raise ValueError(f"X must be 2-D with dtype in {list(_XTYPE)}, "
                         f"got {X.dtype} {tuple(X.shape)}")
    g, n = X.shape
    K = H.shape[0]
    _check("X", X, (g, n), X.dtype, dev)
    _check("W", W, (g, K), f32, dev)
    _check("H", H, (K, n), f32, dev)
    _check("WtW", WtW, (K, K), f32, dev)
    n_labels = [y.shape[0] for y in Ys]
    L = sum(n_labels)
    Kg = guided_width(blocks) if Ys else 0
    if Ys:
        if len(blocks) != len(Ys) + 1 or sum(blocks) != K:
            raise ValueError(f"blocks {blocks} do not match K={K} and "
                             f"{len(Ys)} covariates")
        for c, (y, B) in enumerate(zip(Ys, Bs)):
            _check(f"Ys[{c}]", y, (n_labels[c], n), X.dtype, dev)
            _check(f"Bs[{c}]", B, (n_labels[c], blocks[c]), f32, dev)
        _check("lam", lam, (len(Ys),), f32, dev)
        Y_all = torch.cat(list(Ys)) if len(Ys) > 1 else Ys[0]
        Bg = _embed_b(Bs, blocks)
        lam_rows = _lam_rows(lam, blocks).contiguous()
    if not isinstance(eps, float):
        raise TypeError("eps must be a Python float")
    T = tile_width(K)
    smem = _iter_smem_bytes(K, T, L, Kg)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"fused_iteration needs {smem} bytes of shared memory at K={K}, "
            f"{L} labels, guided width {Kg}; a Hopper block has {_MAX_SMEM}")
    n_tiles = -(-n // T)
    tiles_per_block = -(-n_tiles // _MAX_PART_BLOCKS)
    n_part = -(-n_tiles // tiles_per_block)
    GB = T
    gene_blocks = -(-g // GB)
    n_chunks = -(-n // _CELL_CHUNK)
    want = max(1, min(n_chunks, -(-_TARGET_HXT_BLOCKS // gene_blocks)))
    cells_per_split = -(-n_chunks // want) * _CELL_CHUNK
    n_split = -(-n // cells_per_split)
    S_len = K * K + K + L * K + L + 1

    Hn = torch.empty((K, n), dtype=f32, device=dev)
    XHt = torch.empty((g, K), dtype=f32, device=dev)
    stats = torch.empty((S_len,), dtype=f32, device=dev)
    part = torch.empty((n_part, S_len), dtype=f32, device=dev)
    part_hxt = torch.empty((n_split, K, g), dtype=f32, device=dev)
    fn = _build.entry("fused_iteration")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(X.data_ptr(), _XTYPE[X.dtype], W.data_ptr(), H.data_ptr(),
                WtW.data_ptr(), Y_all.data_ptr() if Ys else None,
                Bg.data_ptr() if Ys else None,
                lam_rows.data_ptr() if Ys else None,
                g, n, K, L, Kg, int(bool(loss_kl)), eps, T, n_part,
                tiles_per_block, GB, n_split, cells_per_split,
                Hn.data_ptr(), XHt.data_ptr(), stats.data_ptr(),
                part.data_ptr(), part_hxt.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_iteration kernel failed to launch: CUDA "
                           f"error {rc}")
    return Hn, XHt, stats, n_labels


def fused_iteration(X, W, H, WtW, Ys, Bs, lam, eps, *, blocks, loss_kl):
    """One full-batch joint H-update pass with the guided terms of every
    covariate, the prediction-loss partials and the next iteration's B
    statistics (the counterpart of ``pallas_kernels.fused_iteration``
    without counts mode).  Any cell count: the last tile is masked.

    X (g, n) int8/int16/bf16/f32; W (g, K), H (K, n), WtW (K, K) f32; Ys
    (labels_c, n) in X's dtype; Bs (labels_c, k_c) f32; lam (n_cov,) f32;
    eps a float.  Returns (Hn, XHt (g, K), HHt, lossdot, preds, bnums,
    bdens), bnums/bdens sliced to each block's columns."""
    blocks = tuple(blocks)
    if not Ys:
        raise ValueError("fused_iteration needs covariates; use fused_h_update")
    if not _cuda_or_cpu(X):
        return fused_iteration_plain(X, W, H, WtW, Ys, Bs, lam, eps,
                                     blocks=blocks, loss_kl=loss_kl)
    Hn, XHt, stats, n_labels = _launch_iteration(X, W, H, WtW, Ys, Bs, lam,
                                                 eps, blocks, loss_kl)
    launches["fused_iteration"] += 1
    K, L = H.shape[0], sum(n_labels)
    HHt = stats[:K * K].view(K, K)
    rowsum = stats[K * K:K * K + K]
    off = K * K + K
    bnum_all = stats[off:off + L * K].view(L, K)
    pred_rows = stats[off + L * K:off + L * K + L]
    preds, bnums, bdens = _split_stats(blocks, n_labels, bnum_all, rowsum,
                                       pred_rows)
    return Hn, XHt, HHt, stats[-1], preds, bnums, bdens


def fused_h_update(X, W, H, WtW, eps):
    """The unguided H update pass (the counterpart of
    ``pallas_kernels.fused_h_update``): returns (Hn, XHt (g, K), HHt,
    lossdot)."""
    if not _cuda_or_cpu(X):
        return fused_h_update_plain(X, W, H, WtW, eps)
    Hn, XHt, stats, _ = _launch_iteration(X, W, H, WtW, (), (), None, eps,
                                          (H.shape[0],), True)
    launches["fused_h_update"] += 1
    K = H.shape[0]
    return Hn, XHt, stats[:K * K].view(K, K), stats[-1]


def fused_transform(num2, H0, WtW2, eps, *, n_iter: int):
    """All ``n_iter`` projection steps ``H ← H ∘ num2 / max(WtW2 H, eps)``
    in one pass (the counterpart of ``pallas_kernels.fused_transform``).
    num2 = 2WᵀX and H0 (K, n) f32, WtW2 = 2WᵀW (K, K) f32."""
    if not _cuda_or_cpu(H0):
        return fused_transform_plain(num2, H0, WtW2, eps, n_iter=n_iter)
    from alpine_tpu_torch.ops import _build

    dev = H0.device
    K, n = H0.shape
    _check("num2", num2, (K, n), torch.float32, dev)
    _check("H0", H0, (K, n), torch.float32, dev)
    _check("WtW2", WtW2, (K, K), torch.float32, dev)
    if not isinstance(eps, float) or not isinstance(n_iter, int) or n_iter < 0:
        raise TypeError("eps must be a float and n_iter a non-negative int")
    T = tile_width(K)
    out = torch.empty((K, n), dtype=torch.float32, device=dev)
    fn = _build.entry("fused_transform")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(num2.data_ptr(), H0.data_ptr(), WtW2.data_ptr(), K, n, T,
                n_iter, eps, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_transform kernel failed to launch: CUDA "
                           f"error {rc}")
    launches["fused_transform"] += 1
    return out

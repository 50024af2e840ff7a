"""The port's hand-written kernels: wrappers, plain versions, tile rule and
launch counts.  Counterpart of ``alpine_tpu/ops/pallas_kernels.py``.

Each wrapper checks its inputs and, for CUDA tensors, launches its kernel
from ``csrc/`` (built at first use, see ops/_build.py) on the current
stream.  It runs its plain PyTorch version only for CPU tensors: a CUDA
tensor launches the kernel or raises, and a failed build raises.

``launches`` counts each wrapper's kernel launches (plain runs do not
count; ``fused_iteration`` counts its counts mode, K4, apart from K1), so a
run can show that its main path went through the kernels.

``hxt`` and ``wtx`` are the X passes of ALS mode (and ``hxt`` the first
X Hᵀ of the joint fit loops); ``stream_probe`` is the streaming read-rate
probe's kernel, on no fit path (``alpine_tpu_torch/probe.py``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from alpine_tpu_torch.ops.mu import (
    block_offsets, guided_width, round_partner,
)

launches: Dict[str, int] = {"fused_iteration": 0, "fused_iteration_counts": 0,
                            "fused_h_update": 0, "fused_transform": 0,
                            "hxt": 0, "wtx": 0, "stream_probe": 0}

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
# fused_iteration's bf16 path (X products on tensor cores, wmma 16x16x16)
_MMA_XTYPES = (torch.int8, torch.bfloat16)  # X storage that computes in bf16
_MMA_GENE_CHUNK = 32  # csrc/fused_iteration.cu: kMmaGeneChunk
# accumulator fragments a block holds in one pass over the genes or cells
# (kWarps * kMmaFrags); a larger output takes more passes
_MMA_PASS_FRAGS = 16
# fused_transform's register path: the K buckets it is compiled for
# (csrc/fused_transform.cu: the instantiations of transform_columns)
_TRANSFORM_BUCKETS = (8, 16, 24, 32, 40, 48, 56, 64)
# stream_probe: blocks of column sums a launch aims at (8 per H100 SM); a
# block sums 32 lanes x one 16-byte vector of columns over its genes
_STREAM_BLOCKS = 1056


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


def iteration_tile_width(K: int, x_dtype: torch.dtype) -> int:
    """fused_iteration's tile width for K components and X's storage dtype.

    float32 and int16 X (fp32 FMA) keep ``tile_width``.  int8 and bf16 X
    run their X products on tensor cores, whose 16 × 16 accumulator
    fragments take the place of the per-thread register tile: that path
    takes max(16, tile_width(K)), which differs only for 256 < K <= 512
    (16 instead of 8).  Its Kp × T output, Kp = K rounded up to 16, is one
    pass of at most 16 fragments for K <= 256 and two passes above."""
    w = tile_width(K)
    return max(16, w) if x_dtype in _MMA_XTYPES else w


def transform_bucket(K: int) -> int:
    """fused_transform's path for K components: the smallest bucket of
    ``_TRANSFORM_BUCKETS`` that holds K (the register path: the cells'
    columns of H, padded to the bucket, stay in registers), or 0 above the
    largest bucket (the tiled path, ``tile_width(K)`` cells a tile)."""
    tile_width(K)  # 1 <= K <= 512
    return next((b for b in _TRANSFORM_BUCKETS if K <= b), 0)


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def _iter_smem_bytes(K: int, T: int, L: int, Kg: int, counts: bool,
                     mma: bool = False) -> int:
    """csrc/fused_iteration.cu:iter_smem_floats, in bytes; ``mma`` for the
    bf16 (tensor-core) path."""
    TP = T + 1
    if mma:
        stage = _MMA_GENE_CHUNK * (_pad16(K) + 8 + T + 8) // 2
        h = -(-K * TP // 8) * 8
        wtx = _pad16(K) * (T + 4)
    else:
        stage = _GENE_CHUNK * K + _GENE_CHUNK * T
        h = wtx = K * TP
    return 4 * (stage + h + wtx + K * TP + 3 * L * TP + L * Kg + 2 * Kg
                + _THREADS + ((K + 2) * TP if counts else 0))


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


def _stats_len(K: int, L: int, counts: bool) -> int:
    """Length of fused_iteration's stats vector: HHt (K·K), rowsum (K),
    Bnum (L·K), prediction-loss rows (L), the loss dot (1) and, in counts
    mode, the unscaled HHtU (K·K)."""
    return K * K + K + L * K + L + 1 + (K * K if counts else 0)


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


def fused_iteration_plain(X, W, H, WtW, Ys, Bs, lam, eps, counts=None, *,
                          blocks, loss_kl):
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
    Hs = Hn  # the operand of every contraction over cells against Hn
    if counts is not None:
        Hn = torch.where(counts[0] > 0, Hn, H)
        Hs = Hn * counts[1]
    XHt = (round_partner(Hs, X.dtype) @ Xf.T).T
    HHt = Hs @ Hn.T
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
        blocks, [y.shape[0] for y in Ys], Q @ Hs.T, torch.sum(Hs, dim=1),
        torch.sum(E, dim=1))
    if counts is not None:
        return Hn, XHt, HHt, Hn @ Hn.T, lossdot, preds, bnums, bdens
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


def hxt_plain(X, H):
    """Plain PyTorch version of ``hxt``: H Xᵀ (K, g), H rounded as X's
    partner and X widened to f32."""
    return round_partner(H, X.dtype) @ X.float().T


def wtx_plain(X, W):
    """Plain PyTorch version of ``wtx``: Wᵀ X (K, n), W rounded as X's
    partner and X widened to f32."""
    return round_partner(W, X.dtype).T @ X.float()


def stream_tile(g: int, itemsize: int) -> int:
    """The streaming probe's tile width (benchmarks/envelope_probe.py:114):
    the cells of a 6 MiB slab of X, rounded down to 128, at least 128."""
    return max(128, (6 * 1024 * 1024 // (g * itemsize)) // 128 * 128)


def stream_probe_plain(X, tile=None):
    """Plain PyTorch version of ``stream_probe``: (fold (8, 128), column
    sums (n,)), both f32."""
    g, n = X.shape
    tile = _stream_tile_arg(X, tile)
    colsum = torch.sum(X.float(), dim=0)
    cols = (torch.arange(0, n, tile, device=X.device)[:, None]
            + torch.arange(128, device=X.device)[None, :])
    first = torch.where(cols < n, colsum[cols.clamp(max=n - 1)],
                        torch.zeros((), device=X.device))
    return torch.sum(first, dim=0).expand(8, 128).contiguous(), colsum


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


def _cell_splits(g: int, n: int, GB: int) -> Tuple[int, int]:
    """(n_split, cells_per_split) of an X Hᵀ pass over blocks of GB genes:
    about _TARGET_HXT_BLOCKS blocks, each summing a range of cells that is
    a multiple of _CELL_CHUNK into a partial of its own."""
    gene_blocks = -(-g // GB)
    n_chunks = -(-n // _CELL_CHUNK)
    want = max(1, min(n_chunks, -(-_TARGET_HXT_BLOCKS // gene_blocks)))
    cells_per_split = -(-n_chunks // want) * _CELL_CHUNK
    return -(-n // cells_per_split), cells_per_split


def _launch_iteration(X, W, H, WtW, Ys, Bs, lam, eps, counts, blocks, loss_kl):
    """Run csrc/fused_iteration.cu; returns (Hn, XHt, stats, n_labels) with
    stats laid out as ``_stats_len`` says."""
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
    T = iteration_tile_width(K, X.dtype)
    smem = _iter_smem_bytes(K, T, L, Kg, counts is not None,
                            X.dtype in _MMA_XTYPES)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"fused_iteration needs {smem} bytes of shared memory at K={K}, "
            f"{L} labels, guided width {Kg}; a Hopper block has {_MAX_SMEM}")
    n_tiles = -(-n // T)
    tiles_per_block = -(-n_tiles // _MAX_PART_BLOCKS)
    n_part = -(-n_tiles // tiles_per_block)
    GB = T
    n_split, cells_per_split = _cell_splits(g, n, GB)
    S_len = _stats_len(K, L, counts is not None)

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
                counts.data_ptr() if counts is not None else None,
                g, n, K, L, Kg, int(bool(loss_kl)), eps, T, n_part,
                tiles_per_block, GB, n_split, cells_per_split,
                Hn.data_ptr(), XHt.data_ptr(), stats.data_ptr(),
                part.data_ptr(), part_hxt.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_iteration kernel failed to launch: CUDA "
                           f"error {rc}")
    return Hn, XHt, stats, n_labels


def fused_iteration(X, W, H, WtW, Ys, Bs, lam, eps, counts=None, *, blocks,
                    loss_kl):
    """One full-batch joint H-update pass with the guided terms of every
    covariate, the prediction-loss partials and the next iteration's B
    statistics (the counterpart of ``pallas_kernels.fused_iteration``).
    Any cell count: the last tile is masked.

    X (g, n) int8/int16/bf16/f32; W (g, K), H (K, n), WtW (K, K) f32; Ys
    (labels_c, n) in X's dtype; Bs (labels_c, k_c) f32; lam (n_cov,) f32;
    eps a float.  Returns (Hn, XHt (g, K), HHt, lossdot, preds, bnums,
    bdens), bnums/bdens sliced to each block's columns.

    ``counts`` (weighted_fast) is a (2, n) f32 tensor: row 0 this
    iteration's draw counts (columns drawn 0 times keep their H), row 1 the
    next iteration's, which scale every contraction over cells against Hn
    (Hs = c_next ⊙ Hn feeds XHt, HHt = Hs Hnᵀ, rowsum and Bnum; the losses
    stay unscaled).  The return then gains the unscaled HHtU = Hn Hnᵀ after
    HHt, as the JAX function's does.

    On the card, int8 and bf16 X run both X products on bf16 tensor cores
    (exact products, fp32 sums: the plain version's result up to summation
    order) with tiles from ``iteration_tile_width``, which gives them
    16 cells per tile where float32/int16 X take 8 (256 < K <= 512): a rule
    by X's dtype and K, not a fallback.  float32 and int16 X keep fp32 FMA
    (no TF32)."""
    blocks = tuple(blocks)
    if counts is not None and not Ys:
        raise ValueError("counts mode requires covariates (weighted "
                         "sampling balances over them)")
    if not Ys:
        raise ValueError("fused_iteration needs covariates; use fused_h_update")
    if counts is not None:
        _check("counts", counts, (2, X.shape[-1]), torch.float32, X.device)
    if not _cuda_or_cpu(X):
        return fused_iteration_plain(X, W, H, WtW, Ys, Bs, lam, eps, counts,
                                     blocks=blocks, loss_kl=loss_kl)
    Hn, XHt, stats, n_labels = _launch_iteration(
        X, W, H, WtW, Ys, Bs, lam, eps, counts, blocks, loss_kl)
    launches["fused_iteration" if counts is None
             else "fused_iteration_counts"] += 1
    K, L = H.shape[0], sum(n_labels)
    HHt = stats[:K * K].view(K, K)
    rowsum = stats[K * K:K * K + K]
    off = K * K + K
    bnum_all = stats[off:off + L * K].view(L, K)
    pred_rows = stats[off + L * K:off + L * K + L]
    lossdot = stats[off + L * K + L]
    preds, bnums, bdens = _split_stats(blocks, n_labels, bnum_all, rowsum,
                                       pred_rows)
    if counts is not None:
        HHtU = stats[off + L * K + L + 1:].view(K, K)
        return Hn, XHt, HHt, HHtU, lossdot, preds, bnums, bdens
    return Hn, XHt, HHt, lossdot, preds, bnums, bdens


def fused_h_update(X, W, H, WtW, eps):
    """The unguided H update pass (the counterpart of
    ``pallas_kernels.fused_h_update``): returns (Hn, XHt (g, K), HHt,
    lossdot)."""
    if not _cuda_or_cpu(X):
        return fused_h_update_plain(X, W, H, WtW, eps)
    Hn, XHt, stats, _ = _launch_iteration(X, W, H, WtW, (), (), None, eps,
                                          None, (H.shape[0],), True)
    launches["fused_h_update"] += 1
    K = H.shape[0]
    return Hn, XHt, stats[:K * K].view(K, K), stats[-1]


def fused_transform(num2, H0, WtW2, eps, *, n_iter: int):
    """All ``n_iter`` projection steps ``H ← H ∘ num2 / max(WtW2 H, eps)``
    in one pass (the counterpart of ``pallas_kernels.fused_transform``).
    num2 = 2WᵀX and H0 (K, n) f32, WtW2 = 2WᵀW (K, K) f32.

    On the card K up to the largest bucket takes the register path (two
    lanes share two cells, whose columns of H stay in registers for all
    steps), larger K the tiled path: a rule by K (``transform_bucket``).
    Both give the same bits for the same inputs."""
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
    KB = transform_bucket(K)
    T = 0 if KB else tile_width(K)
    out = torch.empty((K, n), dtype=torch.float32, device=dev)
    fn = _build.entry("fused_transform")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(num2.data_ptr(), H0.data_ptr(), WtW2.data_ptr(), K, KB, n, T,
                n_iter, eps, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_transform kernel failed to launch: CUDA "
                           f"error {rc}")
    launches["fused_transform"] += 1
    return out


def _check_x(X: torch.Tensor) -> None:
    if X.dim() != 2 or X.dtype not in _XTYPE:
        raise ValueError(f"X must be 2-D with dtype in {list(_XTYPE)}, "
                         f"got {X.dtype} {tuple(X.shape)}")
    _check("X", X, X.shape, X.dtype, X.device)


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed to launch: CUDA error {rc}")
    launches[name] += 1


def hxt(X, H):
    """H Xᵀ (K, g) f32, summed over all cells (the counterpart of
    benchmarks/als_probe.py's ``hxt`` kernel): X (g, n) int8/int16/bf16/f32,
    H (K, n) f32, 1 <= K <= 512.  ALS runs it once an iteration for
    X H_startᵀ; the joint fit loops for their first X Hᵀ.

    On the card, int8 and bf16 X run on bf16 tensor cores (H rounded to
    bf16, exact products, fp32 sums), float32 and int16 X on fp32 FMA; each
    block sums a range of cells into a partial of its own and the partials
    are added in a fixed order, so two launches give the same bits."""
    _check_x(X)
    g, n = X.shape
    K = H.shape[0]
    _check("H", H, (K, n), torch.float32, X.device)
    if not _cuda_or_cpu(X):
        return hxt_plain(X, H)
    from alpine_tpu_torch.ops import _build

    GB = iteration_tile_width(K, X.dtype)  # genes a block
    n_split, cells_per_split = _cell_splits(g, n, GB)
    dev = X.device
    part = torch.empty((n_split, K, g), dtype=torch.float32, device=dev)
    out = torch.empty((K, g), dtype=torch.float32, device=dev)
    fn = _build.entry("hxt")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(X.data_ptr(), _XTYPE[X.dtype], H.data_ptr(), g, n, K, GB,
                n_split, cells_per_split, part.data_ptr(), out.data_ptr(),
                stream)
    _launched("hxt", rc)
    return out


def wtx_tile_width(K: int, x_dtype: torch.dtype) -> int:
    """wtx's cells a block for K outputs a cell.  On the tensor-core path
    (int8, bf16 X) a block holds at most 16 accumulator fragments of
    16 x 16 a pass, so T = 256 / (K rounded up to 16), between 16 and 256 (K
    above 256 takes two passes); the fp32 path keeps ``tile_width(K)``."""
    w = tile_width(K)
    if x_dtype not in _MMA_XTYPES:
        return w
    t = 256
    while t > 16 and _pad16(K) * t > 256 * 16:
        t //= 2
    return t


def wtx(X, W):
    """Wᵀ X (K, n) f32 (the counterpart of benchmarks/als_probe.py's ``wtx``
    kernel): X (g, n) int8/int16/bf16/f32, W (g, K) f32, 1 <= K <= 512.
    ALS runs it once a block an iteration, with the block's Wᵢ.

    Each block computes the K x T outputs of T cells over all genes and
    writes each once; int8 and bf16 X on bf16 tensor cores (W rounded to
    bf16, exact products, fp32 sums), float32 and int16 X on fp32 FMA."""
    _check_x(X)
    g, n = X.shape
    K = W.shape[1] if W.dim() == 2 else -1
    _check("W", W, (g, K), torch.float32, X.device)
    if not _cuda_or_cpu(X):
        return wtx_plain(X, W)
    from alpine_tpu_torch.ops import _build

    T = wtx_tile_width(K, X.dtype)
    dev = X.device
    out = torch.empty((K, n), dtype=torch.float32, device=dev)
    fn = _build.entry("wtx")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(X.data_ptr(), _XTYPE[X.dtype], W.data_ptr(), g, n, K, T,
                out.data_ptr(), stream)
    _launched("wtx", rc)
    return out


def _stream_tile_arg(X, tile):
    if tile is None:
        return stream_tile(X.shape[0], X.element_size())
    if not isinstance(tile, int) or tile < 128 or tile % 128:
        raise ValueError(f"tile must be a multiple of 128, got {tile!r}")
    return tile


def stream_probe(X, tile=None):
    """The streaming probe (the counterpart of
    benchmarks/envelope_probe.py:probe_streaming's kernel): reads and
    widens every element of X (g, n) to f32 and sums over the genes.
    Returns (fold, colsum): colsum (n,) the column sums, fold (8, 128) the
    TPU kernel's accumulator, every row the sum over tiles of ``tile``
    cells (default ``stream_tile``) of each tile's first 128 column sums,
    columns past n counting as zero.

    On the card, a block's 8 warps split its genes, each lane summing one
    16-byte vector of columns a row; the partial sums of the gene splits
    are added in a fixed order."""
    _check_x(X)
    tile = _stream_tile_arg(X, tile)
    if not _cuda_or_cpu(X):
        return stream_probe_plain(X, tile)
    from alpine_tpu_torch.ops import _build

    g, n = X.shape
    col_blocks = -(-n // (32 * (16 // X.element_size())))
    n_split = max(1, min(g, -(-_STREAM_BLOCKS // col_blocks)))
    genes_per_split = -(-g // n_split)
    n_split = -(-g // genes_per_split)
    dev = X.device
    part = torch.empty((n_split, n), dtype=torch.float32, device=dev)
    colsum = torch.empty((n,), dtype=torch.float32, device=dev)
    fold = torch.empty((8, 128), dtype=torch.float32, device=dev)
    fn = _build.entry("stream_probe")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(X.data_ptr(), _XTYPE[X.dtype], g, n, n_split, genes_per_split,
                tile, part.data_ptr(), colsum.data_ptr(), fold.data_ptr(),
                stream)
    _launched("stream_probe", rc)
    return fold, colsum

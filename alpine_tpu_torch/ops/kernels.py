"""The port's hand-written kernels: wrappers, plain versions, tile rule and
launch counts.  Counterpart of ``alpine_tpu/ops/pallas_kernels.py``.

Each wrapper checks its inputs and, for CUDA tensors, launches its kernel
from ``csrc/`` (built at first use, see ops/_build.py) on the current
stream.  It runs its plain PyTorch version only for CPU tensors: a CUDA
tensor launches the kernel or raises, and a failed build raises.

``launches`` counts each wrapper's kernel launches (plain runs do not
count; ``fused_iteration`` counts its counts mode, K4, apart from K1), so a
run can show that its main path went through the kernels.

``hxt`` and ``wtx`` are the X passes of ALS mode and of the minibatch
steps (and ``hxt`` the first X Hᵀ of the joint fit loops); ``stream_probe``
is the streaming read-rate probe's kernel, on no fit path
(``alpine_tpu_torch/probe.py``).

Every kernel of the fit and transform path takes any component count K
(``route``): K <= 512 runs the routes that hold a tile or a thread's rows
of all of K, K > 512 the large-K routes (``hxt_wide_grid`` and
``wtx_wide_grid`` for P1/P2 on int8/bf16 X, ``hxt_fma_wide_grid`` and
``wtx_fma_wide_grid`` for their fp32 paths, ``wide_iteration_grid`` for
K1/K2/K4, ``transform_path`` for K3).
No rule caps K: what does is the card's memory, which must hold the K x n
and K x K operands, outputs and scratch of a call.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from alpine_tpu_torch.ops import _build
from alpine_tpu_torch.ops.mu import (
    _wide, block_offsets, guided_width, round_partner,
)

launches: Dict[str, int] = {"fused_iteration": 0, "fused_iteration_counts": 0,
                            "fused_h_update": 0, "fused_transform": 0,
                            "hxt": 0, "wtx": 0, "stream_probe": 0,
                            # the large-K wgmma kernels of P1/P2 (int8/bf16 X):
                            # from hxt/wtx and from K1/K2/K4's large-K chain
                            "hxt_wide": 0, "wtx_wide": 0,
                            # their fp32 counterparts (float32/int16 X), from
                            # the same callers
                            "hxt_fma_wide": 0, "wtx_fma_wide": 0,
                            # the large-K chain's H Hᵀ, rowsum and Bnum: one a
                            # K1/K2/K4 call at K > 512, and gram_wide's own
                            "gram_wide": 0,
                            # the large-K chain's D = WᵀW H (wtw_gemm's store):
                            # one a K1/K2/K4 call at K > 512, and wtw_gemm's
                            # own; K3's per-step updates count as fused_transform
                            "wtw_gemm": 0}

# X storage dtype -> code of csrc/common.cuh:XType
_XTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int16: 3}
_THREADS = 256
_MAX_TILE_VALUES = 4096  # K × cells of a tile at most (tile_width)
# the largest K of the routes that hold all of K in a tile or a thread's
# rows; above it, the large-K routes (route)
_RANGE_K = _MAX_TILE_VALUES // 8
# the large-K H update (csrc/x_passes.cu: iter_wide): cells a tile, 4 a
# lane (one 16-byte load of a row), labels a pass of its sums over the
# guided rows, and its blocks at most (4 an H100 SM: the blocks that fit
# at once at 5 labels), a fixed number so the partials sum in a fixed order
_WIDE_T = 128
_WIDE_LC = 8
_WIDE_PART_BLOCKS = 528
# the large-K chain's statistics against Hn (csrc/gram_wide.cuh: gram_wide):
# 128 x 128 tiles of K x K, chunks of 8 cells, 8 extra columns (rows of Q
# and the ones row) a block, and about this many tile-pair blocks a launch
# (8 an H100 SM: finer splits even out the SMs' loads and let the extra
# columns' blocks share the last waves; scripts/torch_gram_variants.py
# times the rule's grid beside 12, 24 and 48 splits)
_GRAM_BM = 128
_GRAM_BK = 8
_GRAM_XC = 8
_GRAM_BLOCKS = 1056
# P1's cell splits on the large-K route: at most this many cells a split,
# so that no fp32 accumulator sums a whole 100k-cell row (one split of
# 100k cells left P1 at K = 768 1.2x its rtol 1e-4 from the plain version
# on an H100)
_WIDE_SPLIT_CELLS = 16384
_MAX_SMEM = 232448  # bytes of dynamic shared memory a Hopper block may use
# Grid sizes of fused_iteration's two passes: fixed numbers (not the SM
# count), so a given shape sums its partials in the same order on any card.
# Several blocks per SM hide the latency of each block's staged loads.
_MAX_PART_BLOCKS = 2112  # blocks of the per-tile pass (16 per H100 SM)
# the bf16 path's X Hnᵀ pass (hxt_partial): about this many blocks (32 per
# H100 SM), each split a multiple of _CELL_CHUNK cells
_TARGET_HXT_BLOCKS = 4224
_CELL_CHUNK = 32
# fused_iteration's bf16 path (X products on tensor cores, wmma 16x16x16)
_MMA_XTYPES = (torch.int8, torch.bfloat16)  # X storage that computes in bf16
_MMA_GENE_CHUNK = 32  # csrc/fused_iteration.cu: kMmaGeneChunk
# accumulator fragments a block holds in one pass over the genes or cells
# (kWarps * kMmaFrags); a larger output takes more passes
_MMA_PASS_FRAGS = 16
# fused_transform's register path: the K buckets it is compiled for
# (csrc/fused_transform.cu: the instantiations of transform_columns)
_TRANSFORM_BUCKETS = (8, 16, 24, 32, 40, 48, 56, 64)
# fused_transform's tiled path (csrc/fused_transform.cu: transform_tiles<T,
# G>): (T, KP) instantiated, in the order the rule takes them, T cells a tile
# and K padded to KP = 2 TR G, TR = 2048 / T threads along K; a thread holds
# G pairs of rows x 8 cells and their num2 (G <= 6: 252 registers at 6).
# Chunks of 32 rows of WtW2ᵀ in a ring of two stages: on an H100, 16-row
# chunks cost 2 ms more at K = 300 and more stages bought nothing (PERF.md).
# Past K = 512 the per-step path (transform_path)
_TRANSFORM_TILES = tuple((64, 64 * g) for g in range(1, 7)) + ((32, 512),)
_TRANSFORM_J = 32
_TRANSFORM_STAGES = 2
# stream_probe: blocks of column sums a launch aims at (8 per H100 SM); a
# block sums 32 lanes x one 16-byte vector of columns over its genes
_STREAM_BLOCKS = 1056
# hxt's bf16 path (csrc/x_passes.cu: hxt_mma): chunks of 128 or 64 cells in
# a ring of 2..8 stages, at most 4 accumulator fragments of 16 × 16 a warp
# (32 a block, one pass); its grid is one wave on a fixed SM count, so a
# shape sums its partials in the same order on any card
_HXT_CHUNKS = (128, 64)
_HXT_MAX_FRAGS = 32
_HXT_STAGES = range(2, 9)
# wtx's bf16 path (csrc/x_passes.cu: wtx_mma): chunks of 64 or 32 genes in
# a ring of 2..8 stages; a warp holds at most 48 accumulators (6 fragments
# of 16 x 16) over 1, 2 or 3 groups of 16 cells (the kernel's
# instantiations)
_WTX_GENE_CHUNKS = (64, 32)
_WTX_ACC = 48
_WTX_GROUPS = (1, 2, 3)
_WTX_STAGES = range(2, 9)
# wtx's gene ranges (small n): at least this many ring chunks a range
_WTX_RANGE_CHUNKS = 4
# P1/P2 above K = 512 on int8/bf16 X (csrc/x_passes_wide.cuh: hxt_wide,
# wtx_wide): output tiles of 128 rows (genes, or cells: two warpgroups of
# wgmma's 64) x 256 rows of K (wgmma's widest N), 64 reduction values a ring
# stage; blocks a cluster (hxt_wide: two gene tiles share each stage's tile
# of Hb by TMA multicast; wtx_wide alone: kHxtWideCL, kWtxWideCL); X rows
# off 16-byte alignment staged in rows of these bytes
_WIDE_BM, _WIDE_BN, _WIDE_BK = 128, 256, 64
_WIDE_CL = {"hxt": 2, "wtx": 1}
_WIDE_XROW = {"hxt": {1: 96, 2: 160}, "wtx": {1: 144, 2: 272}}
# the fp32 paths of hxt and wtx at K <= 512 (csrc/fma_passes.cuh: hxt_fma,
# wtx_fma): hxt stages 64 or 32 cells a ring stage, 8 genes and at most 7
# rows of H a thread (8 only at K > 448; lanes 8 along K x 4 along genes),
# at most 4 columns of 32 genes a block; wtx stages 32 genes, 12 cells and
# at most 6 rows of W a thread
_FMA_CHUNKS = (64, 32)
_FMA_MAX_MK = 7
_WTX_FMA_GC = 32
_WTX_FMA_CELLS = 12
_WTX_FMA_MAX_MK = 6
_FMA_STAGES = range(2, 9)
# the fp32 paths above K = 512 (csrc/fma_wide.cuh: hxt_fma_wide,
# wtx_fma_wide) take wtw_gemm's tile and chunk (``wtw_design``) in a ring of
# _FW_STAGES stages; the header's own sizes, in floats: hxt's staged rows of
# 16 cells and its turned tiles' pitch, and the words of an int16 row of a
# stage (wtx: 16 threads' 8 cells as 5 words each, hxt: 2 threads' 2 x 4
# cells as 3 words each, at any 2-byte offset; ``fma_wide_smem_bytes``)
_FW_STAGES = 2
_FW_ROW, _FW_TURN = 24, 132
_FW_WORDS = {"wtx": 80, "hxt": 12}
_SMS = 132  # SMs of an H100 SXM
_SM_SMEM = 233472  # shared memory of one H100 SM, in bytes
_BLOCK_SMEM_RESERVED = 1024  # of it, what the card keeps for each block


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def route(K: int) -> str:
    """The rule by K that names each kernel's route: "tile" for 1 <= K <=
    512 (a tile, a thread's rows or a warp's fragments hold all of K),
    "wide" above (P1/P2 as the wgmma kernels of ``hxt_wide_grid`` and
    ``wtx_wide_grid`` on int8/bf16 X and as the FP32 tiles of
    ``hxt_fma_wide_grid`` and ``wtx_fma_wide_grid`` on float32/int16 X,
    K1/K2/K4 as the chain of
    ``wide_iteration_grid``, K3 on ``transform_path``'s per-step path).
    K < 1 raises; no K above is refused: the card's memory is the cap."""
    if K < 1:
        raise ValueError(f"the CUDA kernels take K >= 1 components, got K={K}")
    return "tile" if K <= _RANGE_K else "wide"


def tile_width(K: int) -> int:
    """The port's tile rule: cells per tile for K components (fused_iteration's
    per-tile pass and, on its bf16 path, genes per block of the X Hnᵀ pass).
    A tile holds K × width values, at most 4096, so the width halves from 64
    as K grows to 512; above, the large-K H update's tile of 128 cells, 4 a
    lane (``route``)."""
    if route(K) == "wide":
        return _WIDE_T
    w = 64
    while K * w > _MAX_TILE_VALUES:
        w //= 2
    return w


def iteration_tile_width(K: int, x_dtype: torch.dtype) -> int:
    """fused_iteration's tile width for K components and X's storage dtype.

    float32 and int16 X keep ``tile_width``: their X products run in
    wtx_fma and hxt_fma over grids of their own (``iteration_grid``), and
    the tile holds the H update and the statistics.  int8 and bf16 X run
    their X products on tensor cores, whose 16 × 16 accumulator fragments
    take the place of a per-thread register tile: that path takes
    max(16, tile_width(K)), which differs only for 256 < K <= 512 (16
    instead of 8).  Its Kp × T output, Kp = K rounded up to 16, is one pass
    of at most 16 fragments for K <= 256 and two passes above."""
    w = tile_width(K)
    return max(16, w) if x_dtype in _MMA_XTYPES and route(K) == "tile" else w


def transform_bucket(K: int) -> int:
    """fused_transform's register-path bucket for K components: the smallest
    bucket of ``_TRANSFORM_BUCKETS`` that holds K (the cells' columns of H,
    padded to the bucket, stay in registers), or 0 above the largest bucket
    (``transform_path``: the tiled or the per-step path)."""
    route(K)  # K >= 1
    return next((b for b in _TRANSFORM_BUCKETS if K <= b), 0)


def transform_path(K: int) -> str:
    """fused_transform's path, a rule by K: "registers" up to the largest
    bucket, "tiles" up to K = 512, "steps" above: one launch a step, a
    tiled fp32 product of WtW2 and H with the update in its epilogue, H
    ping-ponged in device memory (csrc/wtw_gemm.cuh), for any K the card's
    memory holds.  On an H100 the per-step path took 0.87, 0.89 and 0.64
    times the time of a tiled path of 16- and 8-cell tiles at K = 768, 1024
    and 2048 (PERF.md).  Every path forms each
    sum d = fmaf(WtW2[k][j], H[j][c], d) over j in order from 0 and updates
    h * (num2 / max(d, eps)), so all three give the same bits."""
    if transform_bucket(K):
        return "registers"
    return "tiles" if K <= _TRANSFORM_TILES[-1][1] else "steps"


class TransformGrid(NamedTuple):
    """fused_transform's tiled path (csrc/fused_transform.cu:
    transform_tiles): T cells a tile, K padded to KP, chunks of J rows of
    WtW2ᵀ in a ring of S stages, and the block's shared-memory bytes."""
    T: int
    KP: int
    J: int
    S: int
    smem: int


def transform_tiles_smem_bytes(KP: int, T: int, J: int, S: int) -> int:
    """csrc/fused_transform.cu:tiles_smem_bytes: H's tile (KP × T fp32) and
    S stages of J rows of the padded WtW2ᵀ."""
    return 4 * (KP * T + S * J * KP)


def transform_row_pairs(T: int, KP: int) -> int:
    """G, the pairs of rows a thread of transform_tiles holds (KP = 2 TR G
    with TR = 2048 / T threads along K, 8 cells a thread)."""
    return KP // (2 * (_THREADS // (T // 8)))


def transform_tiles_registers(T: int, KP: int) -> int:
    """An estimate of a transform_tiles thread's registers: 16 G
    accumulators, 16 G values of num2, the next j's 2 G values of the ring
    and 48 for H's operands, addresses and indices (ptxas, sm_90a, CUDA
    12.9: 87, 115, 155, 177, 219 and 252 at G = 1..6)."""
    return 34 * transform_row_pairs(T, KP) + 48


def transform_blocks_per_sm(T: int, KP: int) -> int:
    """csrc/fused_transform.cu:tiles_min_blocks: two blocks an SM for a
    64-cell tile of at most 2 pairs of rows (at most 128 registers a
    thread), else one."""
    return 2 if T == 64 and transform_row_pairs(T, KP) <= 2 else 1


@lru_cache(maxsize=None)  # called once a transform
def transform_tiles_grid(K: int) -> TransformGrid:
    """fused_transform's tiled path for K components.

    A tile of T = 64 cells (32 threads along K, KP = K rounded up to 64)
    where a thread's accumulators and num2 fit its registers (G = KP / 64 <=
    6 pairs of rows: K <= 384), else T = 32 (64 threads along K, KP = 512,
    4 pairs).  Each thread holds 2 G rows × 8 cells (80 accumulators at
    K = 300).  The ring: two stages of 32 rows of WtW2ᵀ, beside H's tile in
    the block's share of an SM (``transform_blocks_per_sm``) for every K up
    to 512; K > 512 takes the per-step path (``transform_path``) and raises
    here."""
    route(K)  # K >= 1
    if K > _TRANSFORM_TILES[-1][1]:
        raise ValueError(f"fused_transform's tiled path holds K <= "
                         f"{_TRANSFORM_TILES[-1][1]}; K={K} takes the per-step path")
    T, KP = next(tile for tile in _TRANSFORM_TILES if tile[1] >= K)
    J, S = _TRANSFORM_J, _TRANSFORM_STAGES
    return TransformGrid(T, KP, J, S, transform_tiles_smem_bytes(KP, T, J, S))


def transform_scratch_shapes(K: int, n: int) -> Tuple[Tuple[int, int], ...]:
    """The scratch tensors a fused_transform call on the card allocates, by
    path: none on the register path, WtW2ᵀ padded to KP × KP on the tiled
    path, and on the per-step path H's second buffer (K × n) and WtW2ᵀ
    (``wtw_scratch_shape``: K × K, shared by the steps)."""
    path = transform_path(K)
    if path == "tiles":
        KP = transform_tiles_grid(K).KP
        return ((KP, KP),)
    if path == "steps":
        return ((K, n), wtw_scratch_shape(K))
    return ()


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _iter_smem_bytes(K: int, T: int, L: int, Kg: int, counts: bool,
                     mma: bool = False) -> int:
    """csrc/fused_iteration.cu:iter_smem_floats, in bytes; ``mma`` for the
    bf16 (tensor-core) path.  The fp32 path stages no X or W: its tile of
    WᵀX comes from wtx_fma."""
    TP = T + 1
    if mma:
        stage = _MMA_GENE_CHUNK * (_pad16(K) + 8 + T + 8) // 2
        h = -(-K * TP // 8) * 8
        wtx = _pad16(K) * (T + 4)
    else:
        stage = 0
        h = wtx = K * TP
    return 4 * (stage + h + wtx + K * TP + 3 * L * TP + L * Kg + 2 * Kg
                + _THREADS + ((K + 2) * TP if counts else 0))


def _embed_b(Bs: Sequence[torch.Tensor], blocks: Tuple[int, ...]) -> torch.Tensor:
    """Block-embedded Bg (Σlabels × Kg): B_c at its block's columns, exact
    zeros elsewhere, so one product serves every covariate."""
    Kg = guided_width(blocks)
    L = sum(b.shape[0] for b in Bs)
    Bg = torch.zeros((L, Kg), dtype=Bs[0].dtype, device=Bs[0].device)
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
    return tuple; float64 inputs compute in float64)."""
    blocks = tuple(blocks)
    Xf = _wide(X)
    WtX = round_partner(W, X.dtype).T @ Xf
    num = 2.0 * WtX
    den = 2.0 * (WtW @ H)
    Kg = guided_width(blocks)
    if Ys:
        Yf = torch.cat([_wide(y) for y in Ys])
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


def wtw_gemm_plain(A, B):
    """Plain PyTorch version of ``wtw_gemm``: A B."""
    return A @ B


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


def _hxt_row_bytes(data: int, target: int) -> int:
    """csrc/x_passes.cu:hxt_row_bytes: ``data`` bytes padded so that rows
    start ``target`` bytes apart modulo 128."""
    return data + (target - data) % 128


def hxt_smem_bytes(K: int, GB: int, S: int, x_dtype: torch.dtype,
                   chunk: int) -> int:
    """csrc/x_passes.cu:hxt_mma_smem_bytes: S ring stages of a chunk of Hb
    (Kp rows of ``chunk`` bf16) and of X's GB rows (``chunk`` values as
    stored and 16 bytes more, the aligned window of a row off 16-byte
    alignment), each row padded against bank conflicts; at least the
    Kp × (GB + 4) fp32 output tile that reuses the bytes."""
    Kp = _pad16(K)
    x_row = (_hxt_row_bytes(chunk + 16, 32) if x_dtype == torch.int8
             else _hxt_row_bytes(2 * chunk + 16, 64))
    ring = S * (Kp * _hxt_row_bytes(2 * chunk, 64) + GB * x_row)
    return max(ring, 4 * Kp * (GB + 4))


@lru_cache(maxsize=None)  # called once an ALS iteration
def hxt_grid(g: int, n: int, K: int, x_dtype: torch.dtype
             ) -> Tuple[int, int, int, int, int]:
    """(GB, n_split, cells_per_split, S, chunk) of hxt's bf16 path (int8,
    bf16 X).

    GB, the genes a block, is the widest of 128, 64, 32 and 16 whose
    Kp × GB outputs (Kp = K rounded up to 16) fit 32 accumulator fragments,
    so X is read in one pass for every K <= 512.  The ring takes the wider
    of 128 and 64 cells a stage and the most stages (2..8) for which two
    blocks share an SM, else one block takes it.  The splits, each a
    multiple of the chunk, make gene blocks × splits at most one wave of
    those blocks on 132 SMs; their fp32 partials (splits × K × g, summed in
    split order by a second pass) are a few % of X's bytes from 33k cells
    up, and a third of them at 8,192 cells, where filling the wave took
    less time than fewer splits (PERF.md).  K > 512 takes
    ``hxt_wide_grid`` (and raises here)."""
    if x_dtype not in _MMA_XTYPES:
        raise ValueError(f"hxt_grid is for int8 and bf16 X, got {x_dtype}")
    _check_tile_route(K, "hxt_wide_grid")
    rows = _pad16(K) // 16
    GB = next(w for w in (128, 64, 32, 16) if rows * (w // 16) <= _HXT_MAX_FRAGS)
    S = 0
    for per_sm in (2, 1):
        budget = min(_MAX_SMEM, _SM_SMEM // per_sm - _BLOCK_SMEM_RESERVED)
        for chunk in _HXT_CHUNKS:
            S = max((s for s in _HXT_STAGES
                     if hxt_smem_bytes(K, GB, s, x_dtype, chunk) <= budget), default=0)
            if S:
                break
        if S:
            break
    gene_blocks = -(-g // GB)
    n_chunks = -(-n // chunk)
    want = max(1, min(n_chunks, _SMS * per_sm // gene_blocks))
    cells_per_split = -(-n_chunks // want) * chunk
    return GB, -(-n // cells_per_split), cells_per_split, S, chunk


def _check_tile_route(K: int, wide_rule: str) -> None:
    """K <= 512, or a ValueError naming the large-K rule that takes K."""
    if route(K) == "wide":
        raise ValueError(f"K={K} > {_RANGE_K} takes the large-K route ({wide_rule})")


def x_wide_stage_bytes(kind: str, x_dtype: torch.dtype, aligned: bool = False) -> int:
    """csrc/x_passes_wide.cuh:hxt_wide_stage / wtx_wide_stage: a ring stage
    of ``kind`` ("hxt" or "wtx"): the 256 x 64 bf16 tile of Hb or Wb, then
    X's rows (hxt: 128 genes x 64 cells, wtx: 64 genes x 128 cells), as
    stored where X's rows are 16-byte aligned, else as the aligned windows
    that cover them; rounded up to 1,024 bytes."""
    sz = 1 if x_dtype == torch.int8 else 2
    rows, vals = (_WIDE_BM, _WIDE_BK) if kind == "hxt" else (_WIDE_BK, _WIDE_BM)
    x = rows * (vals * sz if aligned else _WIDE_XROW[kind][sz])
    return -(-(_WIDE_BN * _WIDE_BK * 2 + x) // 1024) * 1024


def x_wide_smem_bytes(kind: str, S: int, x_dtype: torch.dtype, aligned: bool = False) -> int:
    """csrc/x_passes_wide.cuh:x_wide_smem: 1,024 bytes to align the ring, S
    stages and two mbarriers a stage."""
    return 1024 + S * (x_wide_stage_bytes(kind, x_dtype, aligned) + 16)


def _x_wide_stages(kind: str, x_dtype: torch.dtype) -> int:
    """The most ring stages (2..8) of ``kind`` within a Hopper block's shared
    memory, for X's rows off 16-byte alignment (the larger stage), so that
    an aligned X and its misaligned copy take one grid."""
    return max(s for s in range(2, 9)
               if x_wide_smem_bytes(kind, s, x_dtype) <= _MAX_SMEM)


def _wave_share(blocks: int, per_sm: int = 1) -> float:
    """The share of the last of ceil(blocks / (132 per_sm)) waves' block
    slots (``per_sm`` blocks an SM) that ``blocks`` fill."""
    slots = _SMS * per_sm
    return blocks / (slots * -(-blocks // slots))


def _wide_tiles(kind: str, rows: int, K: int) -> int:
    """Output tiles of a large-K pass ("hxt": rows = genes, "wtx": cells):
    128-row tiles in whole clusters x 256-row tiles of K."""
    CL = _WIDE_CL[kind]
    return -(-_cdiv(rows, _WIDE_BM) // CL) * CL * _cdiv(K, _WIDE_BN)


@lru_cache(maxsize=None)
def hxt_wide_grid(g: int, n: int, K: int, x_dtype: torch.dtype) -> Tuple[int, int, int, int]:
    """(CL, n_split, cells_per_split, S) of P1 above K = 512 on int8/bf16 X
    (csrc/x_passes_wide.cuh: hxt_wide).

    Tiles of 128 genes x 256 rows of K, in clusters of CL = 2 blocks along
    the genes (each stage of Hb multicast to both); the cells are split
    into whole 64-cell stages, at most _WIDE_SPLIT_CELLS a split (no fp32
    accumulator sums longer runs), at least that many splits and at most
    twice as many (or as many as fill one wave), taking the count whose
    tiles x splits best fill their last wave of 132 blocks (ties: fewer).
    The splits' partials are added in split order.  S: the most ring
    stages within a block's shared memory.  The grid depends on the shape
    only, so a shape sums each output in the same order on any card, X's
    rows aligned or not."""
    if x_dtype not in _MMA_XTYPES:
        raise ValueError(f"hxt_wide_grid is for int8 and bf16 X, got {x_dtype}")
    if route(K) != "wide":
        raise ValueError(f"hxt_wide_grid is for K > {_RANGE_K}, got K={K}")
    tiles = _wide_tiles("hxt", g, K)
    chunks = -(-n // _WIDE_BK)
    least = -(-n // _WIDE_SPLIT_CELLS)
    most = max(least, min(chunks, max(2 * least, -(-_SMS // tiles))))
    want = max(range(least, most + 1), key=lambda s: (_wave_share(tiles * s), -s))
    cells_per_split = -(-chunks // want) * _WIDE_BK
    return (_WIDE_CL["hxt"], -(-n // cells_per_split), cells_per_split,
            _x_wide_stages("hxt", x_dtype))


@lru_cache(maxsize=None)
def wtx_wide_grid(g: int, n: int, K: int, x_dtype: torch.dtype) -> Tuple[int, int, int, int]:
    """(CL, ranges, range_genes, S) of P2 above K = 512 on int8/bf16 X
    (csrc/x_passes_wide.cuh: wtx_wide).

    Tiles of 128 cells x 256 rows of K, one block a cluster (CL = 1:
    sharing each stage of Wb between two cell tiles ran slower); each block
    sums its outputs over all genes, or, where the tiles fill less than
    four waves of 132 blocks, over one of 1..4 ranges of whole 64-gene
    stages (at least 4 a range), taking the count whose tiles x ranges best
    fill their last wave (ties: fewer); the ranges' partials are added in
    range order.
    S: the most ring stages within a block's shared memory.  The grid
    depends on the shape only."""
    if x_dtype not in _MMA_XTYPES:
        raise ValueError(f"wtx_wide_grid is for int8 and bf16 X, got {x_dtype}")
    if route(K) != "wide":
        raise ValueError(f"wtx_wide_grid is for K > {_RANGE_K}, got K={K}")
    tiles = _wide_tiles("wtx", n, K)
    chunks = -(-g // _WIDE_BK)
    most = 1 if tiles >= 4 * _SMS else max(1, min(4, chunks // _WTX_RANGE_CHUNKS))
    want = max(range(1, most + 1), key=lambda r: (_wave_share(tiles * r), -r))
    per = -(-chunks // want)
    return _WIDE_CL["wtx"], -(-chunks // per), per * _WIDE_BK, _x_wide_stages("wtx", x_dtype)


def hxt_fma_rows(K: int) -> Tuple[int, int]:
    """(WK, MK) of hxt's fp32 path (csrc/x_passes.cu:hxt_fma_wk): the
    fewest warp rows WK (1, 2, 4, 8) that keep a thread at MK = ceil(K /
    (8 WK)) <= 7 rows of H (8 at WK = 8, K > 448); Kp = 8 WK MK rows are
    computed, those past K on zeros."""
    wk = 1
    while wk < 8 and -(-K // (8 * wk)) > _FMA_MAX_MK:
        wk *= 2
    return wk, -(-K // (8 * wk))


def hxt_fma_smem_bytes(K: int, GB: int, S: int, x_dtype: torch.dtype,
                       chunk: int) -> int:
    """csrc/x_passes.cu:hxt_fma_smem_bytes: S ring stages of a chunk of
    ``chunk`` cells of H (Kp rows) and of X's GB rows (float32 padded to
    chunk + 4 values, int16 as stored), the int16 chunk widened to fp32, and
    at least the Q warp tiles (Q x Kp x (GB + 4) fp32) that reuse the
    bytes."""
    WK, MK = hxt_fma_rows(K)
    Kp, Q, row = 8 * WK * MK, 8 // (WK * (GB // 32)), chunk + 4
    int16 = x_dtype == torch.int16
    stage = Kp * row * 4 + GB * (2 * chunk if int16 else 4 * row)
    ring = S * stage + (GB * row * 4 if int16 else 0)
    return max(ring, Q * Kp * (GB + 4) * 4)


def _fma_ring(smem_of, chunks) -> Tuple[int, int, int]:
    """(S, chunk, blocks an SM) of an fp32 pass's ring: the widest of
    ``chunks`` and the most stages (2..8) whose ``smem_of(S, chunk)`` bytes
    let two blocks share an SM, else one block an SM."""
    for per_sm in (2, 1):
        budget = min(_MAX_SMEM, _SM_SMEM // per_sm - _BLOCK_SMEM_RESERVED)
        for chunk in chunks:
            S = max((s for s in _FMA_STAGES if smem_of(s, chunk) <= budget),
                    default=0)
            if S:
                return S, chunk, per_sm
    raise ValueError("no ring of two stages fits a Hopper block")


@lru_cache(maxsize=None)  # called once an ALS iteration
def hxt_fma_grid(g: int, n: int, K: int, x_dtype: torch.dtype
                 ) -> Tuple[int, int, int, int, int]:
    """(GB, n_split, cells_per_split, S, chunk) of hxt's fp32 path (float32,
    int16 X).

    The 8 warps of a block are Q cell groups × WK rows × WG columns of 32
    genes (``hxt_fma_rows``): WG = min(4, 8 / WK), so GB = 32 WG is the
    widest block whose Kp × GB outputs fit 7 × 8 accumulators a thread, and
    all of K is one pass over X for every K <= 512.  The ring holds chunks
    of 64 cells where two stages fit with two blocks an SM, else 32, and the
    most stages (2..8) that fit; else one block takes an SM (K > 448 always:
    a thread of 8 rows takes an SM's registers).  The splits, each a
    multiple of the chunk, make gene blocks × splits at most one wave of
    those blocks on 132 SMs.  K > 512 takes ``hxt_fma_wide_grid`` (and
    raises here)."""
    if x_dtype not in (torch.float32, torch.int16):
        raise ValueError(f"hxt_fma_grid is for float32 and int16 X, got {x_dtype}")
    _check_tile_route(K, "hxt_fma_wide_grid")
    WK, MK = hxt_fma_rows(K)
    GB = 32 * min(4, 8 // WK)
    S, chunk, per_sm = _fma_ring(
        lambda s, c: hxt_fma_smem_bytes(K, GB, s, x_dtype, c), _FMA_CHUNKS)
    if MK > _FMA_MAX_MK:
        per_sm = 1
    gene_blocks = -(-g // GB)
    n_chunks = -(-n // chunk)
    want = max(1, min(n_chunks, _SMS * per_sm // gene_blocks))
    cells_per_split = -(-n_chunks // want) * chunk
    return GB, -(-n // cells_per_split), cells_per_split, S, chunk


def fma_wide_smem_bytes(kind: str, x_dtype: torch.dtype) -> int:
    """csrc/fma_wide.cuh:fma_wide_smem, the shared memory of ``kind``
    ("hxt" or "wtx") above K = 512 on float32/int16 X: the ring's stages
    (wtx: 16 genes of W's 128 columns and of X's 128 cells; hxt: 16 cells of
    H's 128 rows and of X's 128 gene rows, padded to 24 floats; int16 X
    rows as the words that cover them), then two of wtx's widened int16
    tiles or of hxt's pairs of turned tiles (16 x 132 floats each);
    independent of K."""
    d = wtw_design()
    (bm, bn), bk, stages = d["tile"], d["chunk"], _FW_STAGES
    int16 = x_dtype == torch.int16
    if kind == "wtx":
        stage = bk * bm + (bk * _FW_WORDS["wtx"] if int16 else bk * bn)
        tail = 2 * bk * bn if int16 else 0
    else:
        stage = bm * _FW_ROW + (bn * _FW_WORDS["hxt"] if int16 else bn * _FW_ROW)
        tail = 2 * 2 * bk * _FW_TURN
    return 4 * (stages * stage + tail)


def _check_fma_wide(rule: str, K: int, x_dtype: torch.dtype) -> None:
    if x_dtype not in (torch.float32, torch.int16):
        raise ValueError(f"{rule} is for float32 and int16 X, got {x_dtype}")
    if route(K) != "wide":
        raise ValueError(f"{rule} is for K > {_RANGE_K}, got K={K}")


@lru_cache(maxsize=None)
def hxt_fma_wide_grid(g: int, n: int, K: int, x_dtype: torch.dtype) -> Tuple[int, int]:
    """(n_split, cells_per_split) of P1 above K = 512 on float32/int16 X
    (csrc/fma_wide.cuh: hxt_fma_wide, all of K in one launch).

    Output tiles of 128 rows of K x 128 genes (``wtw_design``), two blocks
    an SM; the cells are split into whole 16-cell chunks, at most
    _WIDE_SPLIT_CELLS a split (no fp32 sum runs longer), at least enough
    splits for tiles x splits to fill two waves of 264 blocks (fewer only
    where the cells run out) and at most twice that count, taking the one
    whose blocks best fill their last wave (ties: fewer).  At the bench
    shape (2,000 genes x 100k cells, K = 768) 96 tiles x 11 splits of 9,104
    cells: 1,056 blocks, four whole waves.  The splits' K x g partials are
    added in split order.  The grid depends on the shape only, so a shape
    sums each output in the same order on any card, X's rows aligned or
    not."""
    _check_fma_wide("hxt_fma_wide_grid", K, x_dtype)
    d = wtw_design()
    (bm, bn), bk = d["tile"], d["chunk"]
    tiles = _cdiv(K, bm) * _cdiv(g, bn)
    chunks = _cdiv(n, bk)
    least = max(_cdiv(n, _WIDE_SPLIT_CELLS), min(chunks, _cdiv(2 * 2 * _SMS, tiles)))
    most = max(least, min(chunks, 2 * least))
    want = max(range(least, most + 1), key=lambda s: (_wave_share(tiles * s, 2), -s))
    cells_per_split = _cdiv(chunks, want) * bk
    return _cdiv(n, cells_per_split), cells_per_split


@lru_cache(maxsize=None)
def wtx_fma_wide_grid(g: int, n: int, K: int, x_dtype: torch.dtype
                      ) -> Tuple[int, int, int, int]:
    """(T, chunk, S, blocks) of P2 above K = 512 on float32/int16 X
    (csrc/fma_wide.cuh: wtx_fma_wide, all of K in one launch): output tiles
    of 128 rows of K x T = 128 cells (``wtw_design``), each summed over all
    genes in chunks of 16 through a ring of S = _FW_STAGES stages, two
    blocks an SM; the K / 128 row tiles of a cell tile run back to back."""
    _check_fma_wide("wtx_fma_wide_grid", K, x_dtype)
    d = wtw_design()
    (bm, bn), bk = d["tile"], d["chunk"]
    return bn, bk, _FW_STAGES, _cdiv(K, bm) * _cdiv(n, bn)


class IterationGrid(NamedTuple):
    """fused_iteration's launch parameters (csrc/fused_iteration.cu:
    launch).  T, n_part, tiles_per_block: the per-tile pass iter_tiles;
    GB, n_split, cells_per_split: the X Hnᵀ pass (both paths); S, chunk:
    hxt_fma's ring, and wtx_T, wtx_LK, wtx_GC, wtx_S: wtx_fma's grid (fp32
    path only, 0 on the bf16 path)."""
    T: int
    n_part: int
    tiles_per_block: int
    GB: int
    n_split: int
    cells_per_split: int
    S: int = 0
    chunk: int = 0
    wtx_T: int = 0
    wtx_LK: int = 0
    wtx_GC: int = 0
    wtx_S: int = 0


class WideIterationGrid(NamedTuple):
    """fused_iteration's large-K chain (K > 512; csrc/x_passes.cu:
    launch_iteration_wide): iter_wide's T-cell tiles (T, n_part,
    tiles_per_block); P2's grid for WᵀX (wtx_T, wtx_WR, wtx_GC, wtx_S,
    wtx_ranges, wtx_range_genes: on int8/bf16 X wtx_wide's 128-cell tiles,
    its cluster size, 64-gene stages, stages and gene ranges of
    ``wtx_wide_grid``; on float32/int16 wtx_fma_wide's 128-cell tiles, no
    cluster (1), its 16-gene chunks and stages of ``wtx_fma_wide_grid``,
    all genes in one range); P1's for X Hsᵀ (GB, n_split, cells_per_split,
    S, chunk: on int8/bf16 X hxt_wide's cluster size, splits, cells a
    split, stages and 64-cell stages of ``hxt_wide_grid``; on float32/int16
    hxt_fma_wide's 128-gene tiles and the splits of ``hxt_fma_wide_grid``,
    its stages and 16-cell chunks); and gram_wide's splits for H Hᵀ, HHtU,
    rowsum and Bnum (gram_split, gram_cells_per_split:
    ``gram_wide_grid``)."""
    T: int
    n_part: int
    tiles_per_block: int
    wtx_T: int
    wtx_WR: int
    wtx_GC: int
    wtx_S: int
    wtx_ranges: int
    wtx_range_genes: int
    GB: int
    n_split: int
    cells_per_split: int
    S: int
    chunk: int
    gram_split: int
    gram_cells_per_split: int


def _part_grid(n: int, T: int, most: int = _MAX_PART_BLOCKS) -> Tuple[int, int]:
    """(n_part, tiles_per_block): the per-tile pass's blocks, at most
    ``most``, each a run of T-cell tiles."""
    n_tiles = -(-n // T)
    tiles_per_block = -(-n_tiles // most)
    return -(-n_tiles // tiles_per_block), tiles_per_block


def gram_wide_pairs(K: int) -> Tuple[Tuple[int, int], ...]:
    """gram_wide's tile pairs (ti, tj), ti <= tj, of the upper triangle of
    128 x 128 tiles of K x K, in block order (row by row); block p of a
    split owns pair p (csrc/gram_wide.cuh: gram_pair_index)."""
    T = _cdiv(K, _GRAM_BM)
    return tuple((ti, tj) for ti in range(T) for tj in range(ti, T))


def gram_items(K: int, L: int) -> int:
    """gram_wide's blocks a split: the tile pairs, and for every row tile a
    block a chunk of _GRAM_XC extra columns (L rows of Q, the ones row)."""
    return len(gram_wide_pairs(K)) + _cdiv(K, _GRAM_BM) * _cdiv(L + 1, _GRAM_XC)


def gram_split_floats(K: int, L: int, counts: bool) -> int:
    """Floats of one split's partials of gram_wide: a 128 x 128 tile a pair
    (two in counts mode: HHt and HHtU), then 128 rows of each row tile for
    each of the L + 1 extra columns."""
    T = _cdiv(K, _GRAM_BM)
    return len(gram_wide_pairs(K)) * (2 if counts else 1) * _GRAM_BM ** 2 + T * (L + 1) * _GRAM_BM


@lru_cache(maxsize=None)
def gram_wide_grid(n: int, K: int) -> Tuple[int, int]:
    """(n_split, cells_per_split) of gram_wide: about _GRAM_BLOCKS tile-pair
    blocks in all, never a split over _WIDE_SPLIT_CELLS cells (fp32 sums
    over at most 16,384 terms), each split a multiple of a chunk's
    _GRAM_BK cells: at K = 768 and 100k cells 21 pairs x 50 splits of
    2,000 cells.  Fixed numbers, so a shape sums its partials in the same
    order on any card."""
    want = max(_cdiv(n, _WIDE_SPLIT_CELLS), round(_GRAM_BLOCKS / len(gram_wide_pairs(K))))
    cps = _cdiv(_cdiv(n, want), _GRAM_BK) * _GRAM_BK
    return _cdiv(n, cps), cps


@lru_cache(maxsize=None)  # called once a fit iteration
def wide_iteration_grid(g: int, n: int, K: int, x_dtype: torch.dtype) -> WideIterationGrid:
    """fused_iteration's launch parameters for K > 512: the chain WᵀX (P2's
    large-K kernel) → D = WᵀW H (csrc/wtw_gemm.cuh) → iter_wide (the H
    update with the guided terms, Q, and the prediction loss and the loss
    dot as one partial a block of 128-cell tiles) → X Hsᵀ (P1's large-K
    kernel, its splits' partials) → gram_wide (H Hᵀ = Hs Hnᵀ over the
    upper triangle of 128 x 128 tiles, HHtU = Hn Hnᵀ in counts mode, rowsum
    and Bnum = Q Hsᵀ, from one read of Hn: ``gram_wide_grid``) → the
    partials' sums.  Every kernel's shared memory is independent of K (but
    iter_wide's of the labels), so any K the card's memory holds runs."""
    if route(K) != "wide":
        raise ValueError(f"the large-K chain is for K > {_RANGE_K}, got K={K}")
    n_part, tiles_per_block = _part_grid(n, _WIDE_T, _WIDE_PART_BLOCKS)
    if x_dtype in _MMA_XTYPES:
        CL, ranges, range_genes, S = wtx_wide_grid(g, n, K, x_dtype)
        wtx = (_WIDE_BM, CL, _WIDE_BK, S, ranges, range_genes)
        CL, n_split, cells_per_split, S = hxt_wide_grid(g, n, K, x_dtype)
        hxt_g = (CL, n_split, cells_per_split, S, _WIDE_BK)
    else:
        T, chunk, S, _ = wtx_fma_wide_grid(g, n, K, x_dtype)
        wtx = (T, 1, chunk, S, 1, g)
        hxt_g = (wtw_design()["tile"][1], *hxt_fma_wide_grid(g, n, K, x_dtype), S, chunk)
    return WideIterationGrid(_WIDE_T, n_part, tiles_per_block, *wtx, *hxt_g,
                             *gram_wide_grid(n, K))


def wide_smem_bytes(L: int, Kg: int, counts: bool, stage_bg: bool = True) -> int:
    """csrc/x_passes.cu:wide_smem_floats, in bytes: iter_wide's Y and B H
    (L × 128 fp32 each), its warps' partial sums over the guided rows
    (8 × _WIDE_LC × 128, with labels), the counts rows (2 × 128), a block
    reduction's kThreads values, the prediction-loss rows (L, rounded up to
    4) and, with ``stage_bg``, Bg (L × Kg); independent of K."""
    labels = 2 * L * _WIDE_T + 8 * _WIDE_LC * _WIDE_T if L else 0
    return 4 * (labels + (2 * _WIDE_T if counts else 0) + _THREADS + -(-L // 4) * 4
                + (L * Kg if stage_bg else 0))


def wide_stages_bg(L: int, Kg: int, counts: bool) -> bool:
    """Whether iter_wide stages Bg in shared memory: where it fits, else it
    reads Bg through the cache (the same values in the same order).  Staged
    is 0.18 ms faster a call at the bench shape and 5 labels (0.61 against
    0.79 device ms on an H100; scripts/torch_gram_variants.py).  The launch
    takes this choice as it is."""
    return L > 0 and wide_smem_bytes(L, Kg, counts) <= _MAX_SMEM


@lru_cache(maxsize=None)  # called once a fit iteration
def iteration_grid(g: int, n: int, K: int, x_dtype: torch.dtype):
    """fused_iteration's launch parameters for X (g, n) of ``x_dtype`` and
    K components.  iter_tiles walks tiles of ``iteration_tile_width`` cells,
    at most _MAX_PART_BLOCKS blocks.  int8/bf16 X: the X Hnᵀ pass takes
    GB = T genes a block and ``_cell_splits``.  float32/int16 X: WᵀX comes
    from wtx_fma over ``wtx_fma_grid`` and X Hnᵀ from hxt_fma over
    ``hxt_fma_grid``, the kernels of ALS's fp32 X passes.  K > 512 (a rule
    by K, ``route``): the large-K chain's ``wide_iteration_grid``."""
    if route(K) == "wide":
        return wide_iteration_grid(g, n, K, x_dtype)
    T = iteration_tile_width(K, x_dtype)
    n_part, tiles_per_block = _part_grid(n, T)
    if x_dtype in _MMA_XTYPES:
        return IterationGrid(T, n_part, tiles_per_block, T, *_cell_splits(g, n, T))
    GB, n_split, cells_per_split, S, chunk = hxt_fma_grid(g, n, K, x_dtype)
    wtx_T, wtx_LK, wtx_GC, wtx_S, _ = wtx_fma_grid(g, n, K, x_dtype)
    return IterationGrid(T, n_part, tiles_per_block, GB, n_split, cells_per_split,
                         S, chunk, wtx_T, wtx_LK, wtx_GC, wtx_S)


def _launch_iteration(X, W, H, WtW, Ys, Bs, lam, eps, counts, blocks, loss_kl):
    """Run csrc/fused_iteration.cu; returns (Hn, XHt, stats, n_labels) with
    stats laid out as ``_stats_len`` says."""
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
    if route(K) == "wide":
        return _launch_iteration_wide(X, W, H, WtW, Y_all if Ys else None,
                                      Bg if Ys else None, lam_rows if Ys else None,
                                      eps, counts, L, Kg, loss_kl, n_labels)
    mma = X.dtype in _MMA_XTYPES
    grid = iteration_grid(g, n, K, X.dtype)
    smem = _iter_smem_bytes(K, grid.T, L, Kg, counts is not None, mma)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"fused_iteration needs {smem} bytes of shared memory at K={K}, "
            f"{L} labels, guided width {Kg}; a Hopper block has {_MAX_SMEM}")
    S_len = _stats_len(K, L, counts is not None)

    Hn = torch.empty((K, n), dtype=f32, device=dev)
    XHt = torch.empty((g, K), dtype=f32, device=dev)
    stats = torch.empty((S_len,), dtype=f32, device=dev)
    part = torch.empty((grid.n_part, S_len), dtype=f32, device=dev)
    part_hxt = torch.empty((grid.n_split, K, g), dtype=f32, device=dev)
    # fp32 path: wtx_fma's WᵀX and, in counts mode, Hs = c_next ⊙ Hn
    wtx = None if mma else torch.empty((K, n), dtype=f32, device=dev)
    hs = None if mma or counts is None else torch.empty((K, n), dtype=f32, device=dev)
    fn = _build.entry("fused_iteration")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(X.data_ptr(), _XTYPE[X.dtype], W.data_ptr(), H.data_ptr(),
                WtW.data_ptr(), Y_all.data_ptr() if Ys else None,
                Bg.data_ptr() if Ys else None,
                lam_rows.data_ptr() if Ys else None,
                counts.data_ptr() if counts is not None else None,
                g, n, K, L, Kg, int(bool(loss_kl)), eps, *grid,
                Hn.data_ptr(), XHt.data_ptr(), stats.data_ptr(),
                part.data_ptr(), part_hxt.data_ptr(),
                wtx.data_ptr() if wtx is not None else None,
                hs.data_ptr() if hs is not None else None, stream)
    if rc != 0:
        raise RuntimeError(f"fused_iteration kernel failed to launch: CUDA "
                           f"error {rc}")
    return Hn, XHt, stats, n_labels


def _launch_iteration_wide(X, W, H, WtW, Y_all, Bg, lam_rows, eps, counts, L,
                           Kg, loss_kl, n_labels):
    """Run the large-K chain (csrc/x_passes.cu: alpine_fused_iteration_wide,
    one C call) over ``wide_iteration_grid``; returns what
    ``_launch_iteration`` does, stats in the same layout."""
    dev, f32 = X.device, torch.float32
    g, n = X.shape
    K = H.shape[0]
    grid = wide_iteration_grid(g, n, K, X.dtype)
    stage_bg = wide_stages_bg(L, Kg, counts is not None)
    smem = wide_smem_bytes(L, Kg, counts is not None, stage_bg)
    if smem > _MAX_SMEM:
        raise ValueError(f"fused_iteration needs {smem} bytes of shared memory "
                         f"for {L} labels; a Hopper block has {_MAX_SMEM}")
    mma = X.dtype in _MMA_XTYPES
    buf = lambda *shape: torch.empty(shape, dtype=f32, device=dev)
    Hn, XHt, stats = buf(K, n), buf(g, K), buf(_stats_len(K, L, counts is not None))
    wtx, D = buf(K, n), buf(K, n)
    hs = buf(K, n) if counts is not None else None
    q = buf(L, n) if L else None  # iter_wide's Q, gram_wide's extra columns
    part = buf(grid.n_part, L + 1)  # prediction rows, loss dot
    part_x = buf(grid.n_split, K, g)
    part_hh = buf(grid.gram_split, gram_split_floats(K, L, counts is not None))
    wtwt = buf(*wtw_scratch_shape(K))  # WᵀW transposed, for D = WᵀW H
    hb = wb = wpart = None
    if mma:  # H (Hs) rounded for P1, W transposed and rounded for P2
        hb = torch.empty(2 * K * -(-n // _WIDE_BK) * _WIDE_BK, dtype=torch.uint8, device=dev)
        wb = torch.empty(2 * _pad16(K) * -(-g // _WIDE_BK) * _WIDE_BK, dtype=torch.uint8,
                         device=dev)
        if grid.wtx_ranges > 1:
            wpart = buf(grid.wtx_ranges, K, n)
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _build.entry("fused_iteration_wide")
    rc = _on_device(dev, fn, X.data_ptr(), _XTYPE[X.dtype], W.data_ptr(), H.data_ptr(),
                    WtW.data_ptr(), ptr(Y_all), ptr(Bg), ptr(lam_rows), ptr(counts),
                    g, n, K, L, Kg, int(bool(loss_kl)), int(stage_bg), eps, *grid,
                    Hn.data_ptr(), XHt.data_ptr(), stats.data_ptr(), wtx.data_ptr(),
                    D.data_ptr(), ptr(hs), ptr(q), part.data_ptr(), part_x.data_ptr(),
                    part_hh.data_ptr(), ptr(hb), ptr(wb), ptr(wpart), wtwt.data_ptr(),
                    _stream(dev))
    if rc != 0:
        raise RuntimeError(f"fused_iteration's large-K chain failed to launch: CUDA "
                           f"error {rc}")
    wide = "" if mma else "_fma"
    launches[f"hxt{wide}_wide"] += 1
    launches[f"wtx{wide}_wide"] += 1
    launches["gram_wide"] += 1
    launches["wtw_gemm"] += 1
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
    by X's dtype and K, not a fallback.  float32 and int16 X run them on
    the FP32 units (true fp32, no TF32) in the kernels of ALS's fp32 X
    passes: wtx_fma (WᵀX), the per-tile pass, hxt_fma (X Hnᵀ, or X Hsᵀ
    in counts mode), then the partials' sum, over ``iteration_grid``.
    K > 512 runs the large-K chain (``wide_iteration_grid``), by the same
    rule by X's dtype for its X products: a rule by K, not a fallback."""
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


def wtw_design(K: int = None, n: int = None) -> Dict[str, object]:
    """wtw_gemm's output tile, ring chunk (values of j) and stages, read
    from csrc/wtw_gemm.cuh, whose launch alone decides them; with K and n
    also the launch's blocks, one an output tile.  For reports and checks:
    no launch reads it."""
    import re

    m = re.search(r"constexpr int kGemmBM = (\d+), kGemmBN = (\d+), kGemmBK = (\d+), "
                  r"kGemmStages = (\d+);", (_build.CSRC / "wtw_gemm.cuh").read_text())
    if m is None:
        raise RuntimeError("csrc/wtw_gemm.cuh declares no kGemm constants")
    bm, bn, bk, stages = (int(v) for v in m.groups())
    out = {"tile": [bm, bn], "chunk": bk, "stages": stages}
    if K is not None:
        out["blocks"] = _cdiv(K, bm) * _cdiv(n, bn)
    return out


def wtw_scratch_shape(K: int) -> Tuple[int, int]:
    """The scratch a wtw_gemm call writes A's transpose into, once a call
    (csrc/wtw_gemm.cuh: wtw_transpose): K x K, in the chain (WᵀW), in the
    per-step transform (WtW2, shared by its steps) and in ``wtw_gemm``."""
    route(K)  # K >= 1
    return (K, K)


def wtw_gemm(A, B):
    """The large-K chain's D = WᵀW H alone (csrc/wtw_gemm.cuh's store
    epilogue): A B for A (K, K) and B (K, n) float32.  On the card A is
    transposed into a ``wtw_scratch_shape`` scratch, then true fp32 over
    128 x 128 output tiles (the kernel's grid, chunk and ring are its own:
    csrc/wtw_gemm.cuh), each sum d = fmaf(A[k][j], B[j][c], d) over j in
    order from 0: the bits of the chain's product and of K3's per-step
    path's; any K and n."""
    if not _cuda_or_cpu(B):
        return wtw_gemm_plain(A, B)
    dev, f32 = B.device, torch.float32
    K, n = B.shape
    _check("A", A, (K, K), f32, dev)
    _check("B", B, (K, n), f32, dev)
    At = torch.empty(wtw_scratch_shape(K), dtype=f32, device=dev)
    out = torch.empty((K, n), dtype=f32, device=dev)
    rc = _on_device(dev, _build.entry("wtw_gemm"), A.data_ptr(), B.data_ptr(), K, n,
                    At.data_ptr(), out.data_ptr(), _stream(dev))
    _launched("wtw_gemm", rc)
    return out


def gram_wide_plain(Hn, c=None, Q=None):
    """Plain PyTorch version of ``gram_wide``."""
    Hs = Hn if c is None else Hn * c
    Q = Hn.new_zeros((0, Hn.shape[1])) if Q is None else Q
    return (Hs @ Hn.T, None if c is None else Hn @ Hn.T, torch.sum(Hs, dim=1), Q @ Hs.T)


def gram_wide(Hn, c=None, Q=None):
    """The large-K chain's statistics against Hn alone (csrc/gram_wide.cuh,
    K1/K2/K4's at K > 512): returns (HHt = Hn diag(c) Hnᵀ (K, K), HHtU =
    Hn Hnᵀ or None without ``c``, rowsum = Hn c (K,), Bnum = Q diag(c) Hnᵀ
    (L, K)).  Hn (K, n) and Q (L, n) float32, c (n,) float32 or None (all
    ones).  On the card true fp32 over the upper triangle of 128 × 128
    tiles, mirrored, over ``gram_wide_grid``'s splits; any K and n."""
    if not _cuda_or_cpu(Hn):
        return gram_wide_plain(Hn, c, Q)
    dev, f32 = Hn.device, torch.float32
    K, n = Hn.shape
    _check("Hn", Hn, (K, n), f32, dev)
    if c is not None:
        _check("c", c, (n,), f32, dev)
    L = 0 if Q is None else Q.shape[0]
    if Q is not None:
        _check("Q", Q, (L, n), f32, dev)
    n_split, cps = gram_wide_grid(n, K)
    counts = c is not None
    part = torch.empty((n_split, gram_split_floats(K, L, counts)), dtype=f32, device=dev)
    hht = torch.empty((K, K), dtype=f32, device=dev)
    hhtu = torch.empty((K, K), dtype=f32, device=dev) if counts else None
    rowsum = torch.empty((K,), dtype=f32, device=dev)
    bnum = torch.empty((L, K), dtype=f32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _on_device(dev, _build.entry("gram_wide"), Hn.data_ptr(), ptr(c), ptr(Q), K, n, L,
                    n_split, cps, part.data_ptr(), hht.data_ptr(), ptr(hhtu),
                    rowsum.data_ptr(), bnum.data_ptr(), _stream(dev))
    _launched("gram_wide", rc)
    return hht, hhtu, rowsum, bnum


def fused_transform(num2, H0, WtW2, eps, *, n_iter: int):
    """All ``n_iter`` projection steps ``H ← H ∘ num2 / max(WtW2 H, eps)``
    in one pass (the counterpart of ``pallas_kernels.fused_transform``).
    num2 = 2WᵀX and H0 (K, n) f32, WtW2 = 2WᵀW (K, K) f32.

    On the card K up to the largest bucket takes the register path (two
    lanes share two cells, whose columns of H stay in registers for all
    steps), larger K the tiled path (a block keeps a tile of cells in
    shared memory for all steps and streams WtW2ᵀ, padded into a KP × KP
    scratch once a call, through a ring; ``transform_tiles_grid``), and
    K > 512 the per-step path (WtW2 transposed once into a K × K scratch,
    then one tiled fp32 product a step with the update in its epilogue, H
    ping-ponged through a K × n scratch): a rule by K (``transform_path``).
    All three give the same bits for the same inputs."""
    if not _cuda_or_cpu(H0):
        return fused_transform_plain(num2, H0, WtW2, eps, n_iter=n_iter)
    dev = H0.device
    K, n = H0.shape
    _check("num2", num2, (K, n), torch.float32, dev)
    _check("H0", H0, (K, n), torch.float32, dev)
    _check("WtW2", WtW2, (K, K), torch.float32, dev)
    if not isinstance(eps, float) or not isinstance(n_iter, int) or n_iter < 0:
        raise TypeError("eps must be a float and n_iter a non-negative int")
    KB = transform_bucket(K)
    T = KP = J = S = 0
    if transform_path(K) == "tiles":
        T, KP, J, S, _ = transform_tiles_grid(K)
    # the tiled path's padded WtW2ᵀ, or the per-step path's second buffer of
    # H (T = 0) and its WtW2ᵀ, written by the call
    Wt, At = ([torch.empty(shape, dtype=torch.float32, device=dev)
               for shape in transform_scratch_shapes(K, n)] + [None, None])[:2]
    out = torch.empty((K, n), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _on_device(dev, _build.entry("fused_transform"), num2.data_ptr(), H0.data_ptr(),
                    WtW2.data_ptr(), K, KB, n, T, KP, J, S, n_iter, eps, ptr(Wt), ptr(At),
                    out.data_ptr(), _stream(dev))
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


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
# (device index, stream) -> (arrival counters, scratch bytes) of the X
# passes, kept for the calls on that stream (which run in order, so they
# share them) and grown when a call needs more; wtx's kernel leaves the
# counters zeroed.  One allocation a call fewer: at 8,192 cells the host's
# time a call is what sets these passes' times.
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _stream(dev: torch.device) -> int:
    """The raw handle of the current stream of ``dev``."""
    if _raw_stream is not None:
        return _raw_stream(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _on_device(dev: torch.device, fn, *args) -> int:
    """fn(*args) with ``dev`` the current CUDA device (switched to only
    where it is not: the switch costs host time on every call)."""
    if dev.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def _workspace(dev: torch.device, stream: int, counters: int, nbytes: int):
    """Addresses of at least ``counters`` zeroed int32 arrival counters
    (None for 0) and of ``nbytes`` scratch bytes for a launch on
    ``stream``."""
    arr, buf = _workspaces.get((dev.index, stream), (None, None))
    if counters and (arr is None or arr.numel() < counters):
        arr = torch.zeros(max(counters, 4096), dtype=torch.int32, device=dev)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8, device=dev)
    _workspaces[(dev.index, stream)] = arr, buf
    return arr.data_ptr() if counters else None, buf.data_ptr()


def hxt(X, H):
    """H Xᵀ (K, g) f32, summed over all cells (the counterpart of
    benchmarks/als_probe.py's ``hxt`` kernel): X (g, n) int8/int16/bf16/f32,
    H (K, n) f32, any K >= 1.  ALS runs it once an iteration (or a batch)
    for X H_startᵀ; a joint minibatch step once for X_b H_bᵀ; the joint fit
    loops for their first X Hᵀ.

    On the card, int8 and bf16 X run on bf16 tensor cores (H rounded to
    bf16 once a call, exact products, fp32 sums) over ``hxt_grid``'s grid,
    and above K = 512 as wgmma tiles fed by TMA over ``hxt_wide_grid``'s
    (a rule by K, ``route``); float32 and int16 X on the FP32 units (true
    fp32, register micro-tiles) over ``hxt_fma_grid``'s, above K = 512 as
    128 x 128 tiles over ``hxt_fma_wide_grid``'s.  Each block sums a range
    of cells into a partial of its own and the partials are added in a
    fixed order, so two launches give the same bits.  X's rows need not lie
    on 16-byte boundaries (any cell count, X at any address): the bf16
    paths and the large-K fp32 path give the bits of X's aligned copy."""
    _check_x(X)
    g, n = X.shape
    K = H.shape[0]
    _check("H", H, (K, n), torch.float32, X.device)
    if not _cuda_or_cpu(X):
        return hxt_plain(X, H)
    dev = X.device
    bf16 = X.dtype in _MMA_XTYPES
    if route(K) == "wide":
        return (_hxt_wide if bf16 else _hxt_fma_wide)(X, H)
    GB, n_split, cells_per_split, S, chunk = (hxt_grid if bf16 else hxt_fma_grid)(
        g, n, K, X.dtype)
    # bf16 path: H rounded (K x n padded to the chunk); then the splits'
    # partials
    hb_bytes = -(-2 * K * -(-n // chunk) * chunk // 256) * 256 if bf16 else 0
    stream = _stream(dev)
    _, hb = _workspace(dev, stream, 0, hb_bytes + 4 * n_split * K * g)
    out = torch.empty((K, g), dtype=torch.float32, device=dev)
    rc = _on_device(dev, _build.entry("hxt"), X.data_ptr(), _XTYPE[X.dtype], H.data_ptr(),
                    g, n, K, GB, n_split, cells_per_split, S, chunk, hb, hb + hb_bytes,
                    out.data_ptr(), stream)
    _launched("hxt", rc)
    return out


def _hxt_wide(X, H):
    """``hxt`` above K = 512 on int8/bf16 X: csrc/x_passes_wide.cuh's
    round_h_wide, hxt_wide over ``hxt_wide_grid`` and, with more than one
    split, reduce_splits."""
    dev = X.device
    g, n = X.shape
    K = H.shape[0]
    CL, n_split, cells_per_split, S = hxt_wide_grid(g, n, K, X.dtype)
    # H rounded in hxt_wide's slot order (K x n padded to 64) and the
    # splits' partials: a call's own scratch (hundreds of MB at large K,
    # returned to the allocator's cache after the call, where the per-stream
    # workspace would keep it)
    hb = torch.empty(2 * K * -(-n // _WIDE_BK) * _WIDE_BK, dtype=torch.uint8, device=dev)
    part = torch.empty((n_split, K, g), dtype=torch.float32, device=dev) if n_split > 1 else None
    out = torch.empty((K, g), dtype=torch.float32, device=dev)
    rc = _on_device(dev, _build.entry("hxt_wide"), X.data_ptr(), _XTYPE[X.dtype],
                    H.data_ptr(), g, n, K, CL, n_split, cells_per_split, S, hb.data_ptr(),
                    None if part is None else part.data_ptr(), out.data_ptr(), _stream(dev))
    _launched("hxt", rc)
    launches["hxt_wide"] += 1
    return out


def _hxt_fma_wide(X, H):
    """``hxt`` above K = 512 on float32/int16 X: csrc/fma_wide.cuh's
    hxt_fma_wide over ``hxt_fma_wide_grid`` and, with more than one split,
    reduce_splits."""
    dev = X.device
    g, n = X.shape
    K = H.shape[0]
    n_split, cells_per_split = hxt_fma_wide_grid(g, n, K, X.dtype)
    # the splits' partials: a call's own scratch, as _hxt_wide's
    part = torch.empty((n_split, K, g), dtype=torch.float32, device=dev) if n_split > 1 else None
    out = torch.empty((K, g), dtype=torch.float32, device=dev)
    rc = _on_device(dev, _build.entry("hxt_fma_wide"), X.data_ptr(), _XTYPE[X.dtype],
                    H.data_ptr(), g, n, K, n_split, cells_per_split,
                    None if part is None else part.data_ptr(), out.data_ptr(), _stream(dev))
    _launched("hxt", rc)
    launches["hxt_fma_wide"] += 1
    return out


def _ldsm_row_bytes(data: int) -> int:
    """csrc/x_passes.cu:ldsm_row_bytes: ``data`` bytes (a multiple of 16)
    padded so that rows start an odd multiple of 16 bytes apart modulo 128."""
    return data if data // 16 % 2 else data + 16


def wtx_smem_bytes(K: int, T: int, S: int, x_dtype: torch.dtype,
                   chunk: int) -> int:
    """csrc/x_passes.cu:wtx_mma_smem_bytes: S ring stages of a chunk of
    ``chunk`` genes of Wb (Kp rows of ``chunk`` bf16) and of X's ``chunk``
    rows (T cells as stored and 16 bytes more, the aligned window of a row
    off 16-byte alignment), each row padded against bank conflicts."""
    x_row = _ldsm_row_bytes(T * (1 if x_dtype == torch.int8 else 2) + 16)
    return S * (_pad16(K) * _ldsm_row_bytes(2 * chunk) + chunk * x_row)


@lru_cache(maxsize=None)  # called once a block an ALS iteration
def wtx_grid(g: int, n: int, K: int, x_dtype: torch.dtype
             ) -> Tuple[int, int, int, int, int]:
    """(T, WR, GC, S, blocks) of wtx's bf16 path (int8, bf16 X).

    The 8 warps of a block are WR rows × 8 / WR columns over its Kp × T
    outputs (Kp = K rounded up to 16); a warp holds at most 6 fragment
    rows, so all of K is one pass over X for every K <= 512, and its
    column is 1, 2 or 3 groups of 16 cells, at most 48 accumulators a
    thread.  WR is the fewest rows that fit or twice that, never more
    than Kp / 16 (no idle warp row).  Of those layouts the grid takes the
    one whose block slots (two blocks an SM on 132 SMs) stream the fewest
    bytes: waves × (T cells of X + Kp values of Wb) a gene; ties go to the
    wider tile.  The grid depends on the shape only, so a shape sums each
    output in the same order on any card.  GC, the genes a ring stage, is
    the wider of 64 and 32 for which two stages fit with two blocks an SM
    (fewer barriers a pass; the genes are summed in the same order either
    way), and S the most stages (2..8) that fit.  K > 512 takes
    ``wtx_wide_grid`` (and raises here)."""
    if x_dtype not in _MMA_XTYPES:
        raise ValueError(f"wtx_grid is for int8 and bf16 X, got {x_dtype}")
    _check_tile_route(K, "wtx_wide_grid")
    rows = _pad16(K) // 16
    fewest = next(w for w in (1, 2, 4, 8) if -(-rows // w) * 8 <= _WTX_ACC)
    itemsize = 1 if x_dtype == torch.int8 else 2
    layouts = []  # (bytes a block slot streams a gene, -T, WR)
    for WR in (fewest, 2 * fewest):
        frags = -(-rows // WR)  # fragment rows a warp
        for NT in _WTX_GROUPS:
            if WR <= min(rows, 8) and frags * NT * 8 <= _WTX_ACC:
                T = 8 // WR * 16 * NT
                waves = -(-_cdiv(n, T) // (2 * _SMS))  # ceil(blocks / slots)
                layouts.append((waves * (T * itemsize + 2 * rows * 16), -T, WR))
    _, neg_t, WR = min(layouts)
    T = -neg_t
    budget = min(_MAX_SMEM, _SM_SMEM // 2 - _BLOCK_SMEM_RESERVED)
    for GC in _WTX_GENE_CHUNKS:
        S = max((s for s in _WTX_STAGES
                 if wtx_smem_bytes(K, T, s, x_dtype, GC) <= budget), default=0)
        if S:
            break
    return T, WR, GC, S, -(-n // T)


@lru_cache(maxsize=None)
def wtx_gene_split(g: int, n: int, K: int, x_dtype: torch.dtype) -> Tuple[int, int]:
    """(ranges, genes a range) of wtx's bf16 path: where ``wtx_grid``'s
    tiles fill less than a wave (two blocks an SM on 132 SMs), the genes
    are split into ranges of whole ring chunks, at least 4 chunks a range,
    so that tiles × ranges fill at most one wave; each block sums its
    range into a K × T partial, and the last block of a tile to finish
    adds the partials in range order.  One range (all genes) otherwise.
    The split depends on the shape only, so a shape gives the same bits
    on every launch and card.  K > 512 takes ``wtx_wide_grid``."""
    T, _, GC, _, blocks = wtx_grid(g, n, K, x_dtype)
    chunks = -(-g // GC)
    ranges = max(1, min(2 * _SMS // blocks, chunks // _WTX_RANGE_CHUNKS))
    per_range = -(-chunks // ranges)
    return -(-chunks // per_range), per_range * GC


def wtx_fma_rows(K: int, LK: int) -> Tuple[int, int]:
    """(WK, MK) of wtx's fp32 path (csrc/x_passes.cu:wtx_fma_wk) with LK
    lanes along K: the fewest warp rows WK (1, 2, 4, 8) that keep a thread
    at MK = ceil(K / (LK WK)) <= 6 rows of W; Kp = WK LK MK."""
    wk = 1
    while wk < 8 and -(-K // (LK * wk)) > _WTX_FMA_MAX_MK:
        wk *= 2
    return wk, -(-K // (LK * wk))


def wtx_fma_smem_bytes(K: int, LK: int, S: int, x_dtype: torch.dtype) -> int:
    """csrc/x_passes.cu:wtx_fma_smem_bytes: S ring stages of a chunk of 32
    genes of W (room for 32 × Kp fp32) and of X's rows (T cells as stored),
    the int16 chunk widened to fp32, and, when the warps split the genes
    (Q > 1), at least the Q × Kp × T fp32 warp tiles that reuse the bytes."""
    WK, MK = wtx_fma_rows(K, LK)
    Kp, Q, T = WK * LK * MK, 8 // WK, 32 // LK * _WTX_FMA_CELLS
    int16 = x_dtype == torch.int16
    stage = _WTX_FMA_GC * Kp * 4 + _WTX_FMA_GC * T * (2 if int16 else 4)
    ring = S * stage + (_WTX_FMA_GC * T * 4 if int16 else 0)
    return max(ring, Q * Kp * T * 4 if Q > 1 else 0)


@lru_cache(maxsize=None)  # called once a block an ALS iteration
def wtx_fma_grid(g: int, n: int, K: int, x_dtype: torch.dtype
                 ) -> Tuple[int, int, int, int, int]:
    """(T, LK, GC, S, blocks) of wtx's fp32 path (float32, int16 X).

    A thread holds MK <= 6 rows × 12 cells (three float4).  LK, the lanes
    of a warp along K, is the fewest of 1, 2, 4, 8, 16 for which 8 warp
    rows reach K (K <= 48 LK); the other 32 / LK lanes lie along the cells,
    so a tile is T = 12 × 32 / LK cells (384 for K <= 48: one wave of 261
    blocks at two an SM at the bench shape), and all of K is one pass over
    X for every K <= 512.  The warps not needed along K (``wtx_fma_rows``)
    split each chunk's 32 genes.  S is the most ring stages (2..8) for
    which two blocks share an SM, else one block takes it.  K > 512 takes
    ``wtx_fma_wide_grid`` (and raises here)."""
    if x_dtype not in (torch.float32, torch.int16):
        raise ValueError(f"wtx_fma_grid is for float32 and int16 X, got {x_dtype}")
    _check_tile_route(K, "wtx_fma_wide_grid")
    LK = next(lk for lk in (1, 2, 4, 8, 16) if K <= 8 * lk * _WTX_FMA_MAX_MK)
    S, _, _ = _fma_ring(lambda s, _: wtx_fma_smem_bytes(K, LK, s, x_dtype),
                        (_WTX_FMA_GC,))
    T = 32 // LK * _WTX_FMA_CELLS
    return T, LK, _WTX_FMA_GC, S, -(-n // T)


def wtx(X, W):
    """Wᵀ X (K, n) f32 (the counterpart of benchmarks/als_probe.py's ``wtx``
    kernel): X (g, n) int8/int16/bf16/f32, W (g, K) f32, any K >= 1.
    ALS runs it once a block an iteration (or a batch), with the block's
    Wᵢ; a joint minibatch step once for Wᵀ X_b, and a minibatch fit once an
    epoch for the loss's WᵀX over all cells.

    Each block computes the K × T outputs of T cells over all genes (or, at
    small n on the bf16 paths, over a range of them, the ranges' partials
    added in a fixed order: ``wtx_gene_split``, ``wtx_wide_grid``), so two
    launches give the same bits.  On the card, int8 and bf16 X run on bf16
    tensor cores (W rounded to bf16 once a call, exact products, fp32
    sums) over ``wtx_grid``'s tiles, and above K = 512 as wgmma tiles fed
    by TMA over ``wtx_wide_grid``'s (a rule by K, ``route``); float32 and
    int16 X on the FP32 units (true fp32, register micro-tiles) over
    ``wtx_fma_grid``'s, above K = 512 as 128 x 128 tiles over
    ``wtx_fma_wide_grid``'s."""
    _check_x(X)
    g, n = X.shape
    K = W.shape[1] if W.dim() == 2 else -1
    _check("W", W, (g, K), torch.float32, X.device)
    if not _cuda_or_cpu(X):
        return wtx_plain(X, W)
    dev = X.device
    if route(K) == "wide":
        return (_wtx_wide if X.dtype in _MMA_XTYPES else _wtx_fma_wide)(X, W)
    ranges, range_genes, wb_bytes = 1, g, 0
    if X.dtype in _MMA_XTYPES:
        T, WR, GC, S, blocks = wtx_grid(g, n, K, X.dtype)
        ranges, range_genes = wtx_gene_split(g, n, K, X.dtype)
        # W transposed and rounded (Kp x g padded to the chunk); the ranges'
        # partials where the genes are split
        wb_bytes = -(-2 * _pad16(K) * -(-g // GC) * GC // 256) * 256
    else:  # WR carries the fp32 path's lanes along K
        T, WR, GC, S, blocks = wtx_fma_grid(g, n, K, X.dtype)
    stream = _stream(dev)
    arrivals, wb = _workspace(dev, stream, blocks if ranges > 1 else 0,
                              wb_bytes + (4 * ranges * K * n if ranges > 1 else 0))
    part = wb + wb_bytes
    out = torch.empty((K, n), dtype=torch.float32, device=dev)
    rc = _on_device(dev, _build.entry("wtx"), X.data_ptr(), _XTYPE[X.dtype], W.data_ptr(),
                    g, n, K, T, WR, GC, S, ranges, range_genes, wb, part, arrivals,
                    out.data_ptr(), stream)
    _launched("wtx", rc)
    return out


def _wtx_wide(X, W):
    """``wtx`` above K = 512 on int8/bf16 X: round_w, then
    csrc/x_passes_wide.cuh's wtx_wide over ``wtx_wide_grid`` and, with more
    than one gene range, reduce_splits."""
    dev = X.device
    g, n = X.shape
    K = W.shape[1]
    CL, ranges, range_genes, S = wtx_wide_grid(g, n, K, X.dtype)
    # W transposed and rounded (pad16(K) x g padded to 64) and the ranges'
    # partials where the genes are split: a call's own scratch, as hxt's
    wb = torch.empty(2 * _pad16(K) * -(-g // _WIDE_BK) * _WIDE_BK, dtype=torch.uint8,
                     device=dev)
    part = (torch.empty((ranges, K, n), dtype=torch.float32, device=dev) if ranges > 1
            else None)
    out = torch.empty((K, n), dtype=torch.float32, device=dev)
    rc = _on_device(dev, _build.entry("wtx_wide"), X.data_ptr(), _XTYPE[X.dtype],
                    W.data_ptr(), g, n, K, CL, ranges, range_genes, S, wb.data_ptr(),
                    None if part is None else part.data_ptr(), out.data_ptr(), _stream(dev))
    _launched("wtx", rc)
    launches["wtx_wide"] += 1
    return out


def _wtx_fma_wide(X, W):
    """``wtx`` above K = 512 on float32/int16 X: csrc/fma_wide.cuh's
    wtx_fma_wide over ``wtx_fma_wide_grid``, every output written once."""
    dev = X.device
    g, n = X.shape
    K = W.shape[1]
    out = torch.empty((K, n), dtype=torch.float32, device=dev)
    rc = _on_device(dev, _build.entry("wtx_fma_wide"), X.data_ptr(), _XTYPE[X.dtype],
                    W.data_ptr(), g, n, K, out.data_ptr(), _stream(dev))
    _launched("wtx", rc)
    launches["wtx_fma_wide"] += 1
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

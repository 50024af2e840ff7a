// The X passes of full-batch ALS mode, one kernel each:
//   hxt: out (K x g) = H Xᵀ, summed over all n cells;
//   wtx: out (K x n) = Wᵀ X, each cell's column summed over all g genes.
//
// Replaces: benchmarks/als_probe.py:_pallas_dots, its hxt_kernel (call :172)
// and wtx_kernel (call :180).  Those are the X products of ALS mode
// (alpine_tpu/ops/mu.py:als_batch_update): one X H_startᵀ an iteration and
// one Wᵢᵀ X a block.
//
// Bound on the H100: device-memory bytes.  At 100k cells x 2000 genes and
// int8 X a pass reads X (200 MB) and, for hxt, H (16 MB at K = 40), or
// writes the k x n outputs of wtx (2-12 MB at k = 5-30).  The products are
// 16 GFLOP or less, far below the bf16 tensor-core roof.
//
// Design:
//  * hxt: a grid of (gene block of GB genes) x (cell split).  A block sums
//    its K x GB outputs over its split's cells and writes one partial; the
//    partials are added in split order by reduce_splits (no float atomics),
//    so two launches give the same bits.  (The last block of each gene
//    block summing the partials in the kernel instead cost more than the
//    second pass at every shape measured: PERF.md.)
//  * wtx: one block per tile of T cells, looping over all genes in chunks;
//    every output is written once, by the block of its cells.  Where the
//    tiles fill less than a wave (8,192 cells), the bf16 path splits the
//    genes into ranges and the last block of a tile adds the ranges'
//    partials in order.
//  * int8 and bf16 X compute in bf16 (kBf16) on the tensor cores (bf16
//    operands, fp32 accumulators), as the TPU kernels run them on its matrix
//    unit in one exact bf16 pass.  K is padded with zero rows to
//    Kp = pad16(K); the ragged cells and genes are zeroed.  Products are
//    exact and sums fp32: the plain version's result up to summation order.
//  * Both bf16 paths share one design: a pre-pass rounds the small operand
//    to bf16 once a call (round_h: Hb; round_w: Wb, W transposed), then the
//    kernel streams raw X chunks (as stored) and the rounded operand's
//    chunks through a ring of S shared-memory stages filled by cp.async and
//    multiplies straight from the ring with mma.sync m16n8k16, int8 widened
//    in registers.  Each grid is about one wave at two blocks an SM
//    (ops/kernels.py: hxt_grid, wtx_grid, wtx_gene_split).  X rows off
//    16-byte alignment (n · sizeof(X) not a multiple of 16, or X at an odd
//    address) go through the same ring as the 16-byte-aligned windows that
//    cover them; hxt reads a lane's cells at the row's offset with funnel
//    shifts, wtx builds the B registers ldmatrix.trans would give from
//    byte loads at the rows' offsets, so the values meet the same k slots
//    and the bits do not depend on X's alignment.
//    The max-shared-memory attribute is set once a kernel and size
//    (allow_smem), not every call: the host's time a call is what sets
//    these passes' times at 8,192 cells.
//  * hxt_mma reduces over cells, X's contiguous axis: a lane reads 8 cells
//    of a gene row and feeds them to the k slots of two k16 steps.  GB is
//    as wide as one pass of 4 fragments a warp allows (128 genes at
//    K <= 64), so few partials are written.  What holds it back is latency,
//    not bytes: two blocks of 8 warps an SM, a dependent chain of shared
//    loads and products a warp (PERF.md).
//  * wtx_mma reduces over genes, X's strided axis, so its B operand (genes x
//    cells) lies in the ring as the transpose of what mma.sync takes:
//    ldmatrix.trans reads it (int8: as b16 pairs of cells, split by a byte
//    permute into even and odd cells).  All of K is one pass over X: the
//    warps split the Kp x T outputs into fragment rows and 16-cell groups
//    under kWtxAcc accumulators a thread.
//  * float32 and int16 X run on the FP32 units (true fp32 under
//    matmul_precision="highest": no TF32), through the same kind of ring of
//    raw X and of H or W as stored; each thread keeps a micro-tile of
//    outputs in registers and feeds each value it reads from shared memory
//    to several FMAs (hxt_fma, wtx_fma in fma_passes.cuh; grids
//    ops/kernels.py: hxt_fma_grid, wtx_fma_grid).  At the bench shape a pass is bound by
//    X's bytes and the fp32 FMA rate alike (float32 X: 816 MB, 16 GFLOP).
//  * Any K: above 512 the int8/bf16 passes are hxt_wide and wtx_wide
//    (x_passes_wide.cuh: wgmma tiles of 256 rows of K fed by TMA), and the
//    fp32 passes hxt_fma_wide and wtx_fma_wide (fma_wide.cuh: 128 x 128
//    FP32 tiles on wtw_gemm's ring, all of K in one launch).
//
// Also here, because its X products are these passes: fused_iteration (K1,
// K2, K4 at every K; replaces alpine_tpu/ops/pallas_kernels.py:
// fused_iteration with and without its counts mode, and fused_h_update),
// one C call launching a chain: WᵀX (P2's kernel) → D = WᵀW H (wtw_gemm.cuh,
// from WᵀW transposed into a K x K scratch) → iter_wide (the H update, Q
// and the loss rows) → X Hsᵀ (P1's kernel) → gram_wide (gram_wide.cuh: H Hᵀ
// over the upper triangle, HHtU, rowsum and Bnum from one read of Hn) →
// the partials' sums.  Its bound at 100k cells x 2000 genes, K = 768, int8:
// the fp32 (WᵀW)H and the upper triangle of Hn Hnᵀ, 177 GFLOP, 2.7 ms at 67
// TFLOP/s (the bf16 X products 614 GFLOP, 0.62 ms; bytes 0.25 ms); at
// K = 40, int8, X's bytes: 234 MB (X, H in and out, Y, the counts), 0.070
// ms at 3.35 TB/s, which needs the two X passes fused into one read of X
// (the chain reads X twice: ≈ 0.14 ms).
#include "fma_wide.cuh"
#include "mma_passes.cuh"
#include "wtw_gemm.cuh"

namespace alpine {

// out[k][gi] = sum over splits of part[s][k][gi], in split order.
__global__ void __launch_bounds__(kThreads)
reduce_splits(const float* __restrict__ part, int n_split, int K, int g,
              float* __restrict__ out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t KG = (size_t)K * g;
  if (idx >= KG) return;
  float s = 0.f;
  for (int sp = 0; sp < n_split; ++sp) s += part[(size_t)sp * KG + idx];
  out[idx] = s;
}

template <typename XT, bool kBf16>
static int launch_hxt(const void* X, const float* H, int g, int n, int K, int GB, int n_split,
                      int cells_per_split, int S, int CW,
                      __nv_bfloat16* Hb, float* part, float* out, cudaStream_t stream) {
  int rc;
  if constexpr (kBf16) {
    rc = launch_hxt_mma<XT>(X, H, g, n, K, GB, n_split, cells_per_split, S, CW, Hb, part,
                            stream);
  } else {
    rc = launch_hxt_fma<XT>(X, H, g, n, K, GB, n_split, cells_per_split, S, CW, part, stream);
  }
  if (rc != 0) return rc;
  const size_t total = (size_t)K * g;
  reduce_splits<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, n_split, K, g, out);
  return (int)cudaGetLastError();
}

}  // namespace alpine

#include "x_passes_wide.cuh"
#include "gram_wide.cuh"

namespace alpine {

// ---- the iteration (fused_iteration: K1, K2, K4) --------------------------
//
// No kernel of the chain holds a K x K partial or a tile of all of K a
// block, so no shared memory grows with K: the X products are P1's and P2's
// kernels (at K <= 512 hxt_mma / wtx_mma on int8/bf16 X, hxt_fma / wtx_fma
// on float32/int16; above, hxt_wide / wtx_wide and hxt_fma_wide /
// wtx_fma_wide), the denominator's (WᵀW)H is wtw_gemm, the H update is
// iter_wide (a pass at the card's read rate over H, WᵀX and D), and every
// statistic over cells against Hn (H Hᵀ, HHtU, rowsum, Bnum) is gram_wide,
// from one read of Hn.  (The K <= 512 route ran a per-tile pass that formed
// D and H Hᵀ in each T-cell tile and added a K x K partial a tile: at
// K = 144 it took longer than the two X passes together: PERF.md.)

constexpr int kWideV = 4;             // cells a lane of iter_wide (one 16-byte load)
constexpr int kWideT = 32 * kWideV;   // cells a tile (ops/kernels.py:_WIDE_T)
constexpr int kWideLC = 8;            // labels a pass of iter_wide's sums over j

// iter_wide's shared memory in floats: Y and B H (then the loss terms)
// (L x 128 each), the warps' partial sums over j (8 x kWideLC x 128), the
// counts rows (2 x 128), a block reduction (kThreads), the prediction-loss
// rows (L, rounded up to 4) and, where it fits, Bg (L x Kg).
// ops/kernels.py:wide_smem_bytes holds the same formula.
__host__ __device__ inline size_t wide_smem_floats(int L, int Kg, bool counts, bool stage_bg) {
  const size_t labels = L > 0 ? 2 * (size_t)L * kWideT + (size_t)kWarps * kWideLC * kWideT : 0;
  return labels + (counts ? 2 * kWideT : 0) + kThreads + (size_t)(L + 3) / 4 * 4 +
         (stage_bg ? (size_t)L * Kg : 0);
}

// The sum of v over a warp, in a fixed order (lane 0's value is used).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The 4 cells cb .. cb + 3 of a row: one 16-byte load where rows are 16-byte
// aligned (n % 4 == 0: the 4 cells are all in or all past n), else element
// loads; zeros past n either way.
__device__ __forceinline__ void wide_ld4(const float* row, int cb, int n, bool vec, float* v) {
  if (vec) {
    if (cb < n) {
      const float4 t = *reinterpret_cast<const float4*>(row + cb);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kWideV; ++q) v[q] = cb + q < n ? row[cb + q] : 0.f;
  }
}

__device__ __forceinline__ void wide_st4(float* row, int cb, int n, bool vec, const float* v) {
  if (vec) {
    if (cb < n) *reinterpret_cast<float4*>(row + cb) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < kWideV; ++q)
      if (cb + q < n) row[cb + q] = v[q];
  }
}

// The label sums of a 128-cell tile over the guided rows of src (H, or Hn):
// warp w takes rows j = w, w + 8, ... < Kg in order and writes its partial
// sums of labels l0 .. l0 + nl - 1, sum over its j of Bg[l][j] src[j][cell],
// to sP[w][l][cell] (fmaf in order from 0).
__device__ __forceinline__ void wide_label_sums(const float* src, const float* sBg,
                                                const float* __restrict__ Bg, bool stage_bg,
                                                int n, int Kg, int l0, int nl, int cb,
                                                bool vec, float* sP) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[kWideLC][kWideV];
#pragma unroll
  for (int l = 0; l < kWideLC; ++l)
#pragma unroll
    for (int q = 0; q < kWideV; ++q) acc[l][q] = 0.f;
  for (int j = warp; j < Kg; j += kWarps) {
    float v[kWideV];
    wide_ld4(src + (size_t)j * n, cb, n, vec, v);
#pragma unroll
    for (int l = 0; l < kWideLC; ++l) {
      if (l < nl) {
        const size_t o = (size_t)(l0 + l) * Kg + j;
        const float b = stage_bg ? sBg[o] : __ldg(Bg + o);
#pragma unroll
        for (int q = 0; q < kWideV; ++q) acc[l][q] = fmaf(b, v[q], acc[l][q]);
      }
    }
  }
#pragma unroll
  for (int l = 0; l < kWideLC; ++l)
    if (l < nl)
      *reinterpret_cast<float4*>(sP + (warp * kWideLC + l) * kWideT + kWideV * lane) =
          make_float4(acc[l][0], acc[l][1], acc[l][2], acc[l][3]);
}

// The H update of 128-cell tiles (lane t: cells c0 + 4 t .. + 3) with the
// guided terms of every covariate through the block-embedded Bg (L x Kg,
// staged in shared memory where it fits); it writes Hn (and, in counts mode,
// Hs = c_next ⊙ Hn), Q (L x n: Y / max(Bg Hn, eps) for KL, Y otherwise, the
// next B update's ratio, read by gram_wide), and a partial a block: the
// prediction-loss rows (L) and the loss dot sum(WᵀX ⊙ Hn) (1).
//  * B H and ŷ = Bg Hn[:Kg]: every warp takes an eighth of the guided rows
//    for all labels of a pass (kWideLC), and the eight partials of each
//    (label, cell) are added in warp order through shared memory.
//  * The update: one row of K a warp pass, 16-byte loads of H, WᵀX and D
//    where rows are 16-byte aligned (else element loads: the same bits);
//    each element's num / den formed as the plain version forms it (sums
//    over l in order from 0, IEEE division).  Counts mode: a column drawn
//    0 times keeps its H, bit for bit (a select).
//  * A label's loss terms over a tile: a warp adds a lane's 4 cells in
//    order, then a warp tree, into the block's row in shared memory.  The
//    loss dot: each thread's terms in order, a block tree at the end.  The
//    block walks a run of tiles in order on a fixed grid, so the partials
//    sum in a fixed order.
template <typename YT, bool kCounts>
__global__ void __launch_bounds__(kThreads, 4)
iter_wide(const float* __restrict__ H, const float* __restrict__ WtX,
          const float* __restrict__ D, const YT* __restrict__ Y,
          const float* __restrict__ Bg, const float* __restrict__ lam_rows,
          const float* __restrict__ C, int n, int K, int L, int Kg, int loss_kl, float eps,
          int stage_bg, int tiles_per_block, int n_tiles, float* Hn, float* Hs, float* Q,
          float* __restrict__ part) {
  extern __shared__ __align__(16) float sm[];
  const int LT = L * kWideT;
  float* sY = sm;                                     // L x 128: Y widened to fp32
  float* sA = sY + LT;                                // L x 128: B H (Y / max(B H, eps) for KL)
  float* sP = sA + LT;                                // 8 x kWideLC x 128 (L > 0)
  float* sC = sP + (L > 0 ? kWarps * kWideLC * kWideT : 0);  // 2 x 128: c_cur, c_next
  float* sRed = sC + (kCounts ? 2 * kWideT : 0);      // kThreads
  float* sPred = sRed + kThreads;                     // L
  float* sBg = sPred + (L + 3) / 4 * 4;               // L x Kg
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool bg_smem = stage_bg != 0;
  auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = n % 4 == 0 && a16(H) && a16(WtX) && a16(D) && a16(Hn) && (!kCounts || a16(Hs));
  if (bg_smem)
    for (int e = tid; e < L * Kg; e += kThreads) sBg[e] = Bg[e];
  for (int l = tid; l < L; l += kThreads) sPred[l] = 0.f;
  float ld = 0.f;
  const int tile_begin = blockIdx.x * tiles_per_block;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_block);
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int c0 = tile * kWideT, cb = c0 + kWideV * lane;
    __syncthreads();  // the previous tile is done with shared memory
    for (int e = tid; e < LT; e += kThreads) {
      const int l = e / kWideT, cell = c0 + e % kWideT;
      sY[e] = cell < n ? to_f(Y[(size_t)l * n + cell]) : 0.f;
    }
    if constexpr (kCounts) {
      for (int e = tid; e < 2 * kWideT; e += kThreads) {
        const int r = e / kWideT, cell = c0 + e % kWideT;
        sC[e] = cell < n ? C[(size_t)r * n + cell] : 0.f;
      }
    }
    __syncthreads();
    // B H, then A = Y / max(B H, eps) (KL) or B H (Frobenius)
    for (int l0 = 0; l0 < L; l0 += kWideLC) {
      const int nl = min(kWideLC, L - l0);
      wide_label_sums(H, sBg, Bg, bg_smem, n, Kg, l0, nl, cb, vec, sP);
      __syncthreads();
      for (int e = tid; e < nl * kWideT; e += kThreads) {
        const int l = e / kWideT, t = e % kWideT;
        float s = sP[e];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += sP[(w * kWideLC + l) * kWideT + t];
        const float y = sY[(l0 + l) * kWideT + t];
        sA[(l0 + l) * kWideT + t] = loss_kl ? y / fmaxf(s, eps) : s;
      }
      __syncthreads();
    }
    // the multiplicative update, one row of K a warp pass
    for (int k = warp; k < K; k += kWarps) {
      const size_t o = (size_t)k * n;
      float h[kWideV], w4[kWideV], d[kWideV], num[kWideV], den[kWideV];
      wide_ld4(H + o, cb, n, vec, h);
      wide_ld4(WtX + o, cb, n, vec, w4);
      wide_ld4(D + o, cb, n, vec, d);
#pragma unroll
      for (int q = 0; q < kWideV; ++q) num[q] = 2.f * w4[q], den[q] = 2.f * d[q];
      if (k < Kg) {
        const float lam = __ldg(lam_rows + k);
        float s1[kWideV] = {0.f, 0.f, 0.f, 0.f}, s2[kWideV] = {0.f, 0.f, 0.f, 0.f};
        float col = 0.f;
        for (int l = 0; l < L; ++l) {
          const size_t ob = (size_t)l * Kg + k;
          const float b = bg_smem ? sBg[ob] : __ldg(Bg + ob);
          const float4 a = *reinterpret_cast<const float4*>(sA + l * kWideT + kWideV * lane);
          const float av[kWideV] = {a.x, a.y, a.z, a.w};
          if (loss_kl) {
#pragma unroll
            for (int q = 0; q < kWideV; ++q) s1[q] = fmaf(b, av[q], s1[q]);
            col += b;
          } else {
            const float4 y = *reinterpret_cast<const float4*>(sY + l * kWideT + kWideV * lane);
            const float yv[kWideV] = {y.x, y.y, y.z, y.w};
#pragma unroll
            for (int q = 0; q < kWideV; ++q) {
              s1[q] = fmaf(b, yv[q], s1[q]);
              s2[q] = fmaf(b, av[q], s2[q]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kWideV; ++q) {
          if (loss_kl) {
            num[q] += lam * s1[q];
            den[q] += lam * col;
          } else {
            const float l2 = 2.f * lam;
            num[q] += l2 * s1[q];
            den[q] += l2 * s2[q];
          }
        }
      }
      float hn[kWideV];
#pragma unroll
      for (int q = 0; q < kWideV; ++q) {
        hn[q] = cb + q < n ? h[q] * (num[q] / fmaxf(den[q], eps)) : 0.f;
        if constexpr (kCounts) {
          if (!(sC[kWideV * lane + q] > 0.f)) hn[q] = h[q];  // undrawn (and past n): keep H
        }
        ld = fmaf(w4[q], hn[q], ld);
      }
      wide_st4(Hn + o, cb, n, vec, hn);
      if constexpr (kCounts) {  // Hs = c_next ⊙ Hn
#pragma unroll
        for (int q = 0; q < kWideV; ++q) hn[q] *= sC[kWideT + kWideV * lane + q];
        wide_st4(Hs + o, cb, n, vec, hn);
      }
    }
    if (L == 0) continue;
    __syncthreads();  // the tile's Hn, from every warp, visible to the block
    // ŷ = Bg Hn, the prediction-loss terms and Q
    for (int l0 = 0; l0 < L; l0 += kWideLC) {
      const int nl = min(kWideLC, L - l0);
      wide_label_sums(Hn, sBg, Bg, bg_smem, n, Kg, l0, nl, cb, vec, sP);
      __syncthreads();
      for (int e = tid; e < nl * kWideT; e += kThreads) {
        const int l = e / kWideT, t = e % kWideT, cell = c0 + t;
        float yh = sP[e];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) yh += sP[(w * kWideLC + l) * kWideT + t];
        const float y = sY[(l0 + l) * kWideT + t];
        float q, err;
        if (loss_kl) {
          const float yc = fmaxf(yh, eps);
          q = y / yc;
          err = y * logf(fmaxf(q, eps)) - y + yc;
        } else {
          const float dd = y - yh;
          q = y;
          err = dd * dd;
        }
        if (cell < n) Q[(size_t)(l0 + l) * n + cell] = q;
        sP[e] = cell < n ? err : 0.f;  // over warp 0's partial, read above by this thread
      }
      __syncthreads();
      for (int l = warp; l < nl; l += kWarps) {
        const float4 v = *reinterpret_cast<const float4*>(sP + l * kWideT + kWideV * lane);
        const float s = warp_sum(((v.x + v.y) + v.z) + v.w);
        if (lane == 0) sPred[l0 + l] += s;
      }
      __syncthreads();  // before sP is written again
    }
  }
  // the loss dot, a tree over the block's threads
  sRed[tid] = ld;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) sRed[tid] += sRed[tid + s];
    __syncthreads();
  }
  float* mypart = part + (size_t)blockIdx.x * (L + 1);
  for (int l = tid; l < L; l += kThreads) mypart[l] = sPred[l];
  if (tid == 0) mypart[L] = sRed[0];
}

// The launch parameters of the chain (ops/kernels.py:IterationGrid, in its
// order).  At K <= 512 P2 is wtx_mma (tiles wT, warp rows wWR, gene chunk
// wGC, stages wS, w_ranges gene ranges of w_range_genes) or wtx_fma (wWR its
// lanes along K, one range), P1 hxt_mma or hxt_fma (GB genes a block,
// n_split splits of cells_per_split, S stages of CW cells).  Above, P2 and
// P1 on int8/bf16 X: wtx_wide (wWR its cluster size) and hxt_wide (GB its
// cluster size); on float32/int16 X wtx_fma_wide and hxt_fma_wide (their
// tiles, chunk and stages are fma_wide.cuh's: P1 takes n_split and
// cells_per_split).  gram_wide's splits.
struct IterationGrid {
  int T, n_part, tiles_per_block;
  int wT, wWR, wGC, wS, w_ranges, w_range_genes;  // P2 for WᵀX
  int GB, n_split, cells_per_split, S, CW;        // P1 for X Hsᵀ
  int g_split, g_cells_per_split;                 // gram_wide
};

constexpr int kTileMaxK = 512;  // the X passes of all of K a block (ops/kernels.py:_RANGE_K)

// WᵀX → D = WᵀW H → iter_wide (Hn, Hs, Q) → X Hsᵀ partials → gram_wide (H Hᵀ,
// HHtU, rowsum, Bnum into stats) → reduce_partials: the prediction rows and
// the loss dot into stats, and XHt.  The X products take P1/P2's kernels by
// K and X's dtype (bf16 tensor cores for int8/bf16 X, FP32 units for
// float32/int16).  Scratch on the bf16 path: hb (Hs rounded), wb (W
// rounded and transposed), wpart and arrivals (P2's gene ranges'
// partials and, at K <= 512, a zeroed counter a tile).
template <typename XT, bool kBf16, bool kCounts>
static int launch_iteration(const void* X, const float* W, const float* H, const float* WtW,
                            const void* Y, const float* Bg, const float* lam_rows,
                            const float* C, int g, int n, int K, int L, int Kg, int loss_kl,
                            int stage_bg, float eps, const IterationGrid& p, float* Hn,
                            float* XHt, float* stats, float* WtX, float* D, float* Hs,
                            float* Q, float* part, float* part_x, float* part_hh, void* hb,
                            void* wb, float* wpart, void* arrivals, float* WtWt,
                            cudaStream_t stream) {
  if (p.T != kWideT || K < 1 || L < 0 || (kCounts && (C == nullptr || Hs == nullptr)) ||
      (L > 0 && (Y == nullptr || Bg == nullptr || lam_rows == nullptr || Q == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool tile = K <= kTileMaxK;
  __nv_bfloat16* Hb = static_cast<__nv_bfloat16*>(hb);
  __nv_bfloat16* Wb = static_cast<__nv_bfloat16*>(wb);
  int rc;
  if constexpr (kBf16) {
    rc = tile ? launch_wtx_mma<XT>(X, W, g, n, K, p.wT, p.wWR, p.wGC, p.wS, p.w_ranges,
                                   p.w_range_genes, Wb, wpart,
                                   static_cast<unsigned*>(arrivals), WtX, stream)
              : launch_wtx_wide<XT>(X, W, g, n, K, p.wWR, p.w_ranges, p.w_range_genes, p.wS,
                                    Wb, wpart, WtX, stream);
  } else {
    rc = tile ? launch_wtx_fma<XT>(X, W, g, n, K, p.wT, p.wWR, p.wGC, p.wS, WtX, stream)
              : launch_wtx_fma_wide<XT>(X, W, g, n, K, WtX, stream);
  }
  if (rc != 0) return rc;
  cudaError_t err = launch_wtw_transpose(WtW, K, WtWt, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_wtw_gemm<kGemmStore>(WtWt, H, K, n, nullptr, 0.f, D, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = wide_smem_floats(L, Kg, kCounts, stage_bg != 0) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  err = allow_smem(reinterpret_cast<const void*>(iter_wide<XT, kCounts>), smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n + kWideT - 1) / kWideT;
  iter_wide<XT, kCounts><<<p.n_part, kThreads, smem, stream>>>(
      H, WtX, D, static_cast<const XT*>(Y), Bg, lam_rows, C, n, K, L, Kg, loss_kl, eps,
      stage_bg, p.tiles_per_block, n_tiles, Hn, Hs, Q, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* Hx = kCounts ? Hs : Hn;  // X Hsᵀ
  if constexpr (kBf16) {  // the splits' partials, summed by reduce_partials
    rc = tile ? launch_hxt_mma<XT>(X, Hx, g, n, K, p.GB, p.n_split, p.cells_per_split, p.S,
                                   p.CW, Hb, part_x, stream)
              : launch_hxt_wide<XT>(X, Hx, g, n, K, p.GB, p.n_split, p.cells_per_split, p.S,
                                    Hb, part_x, nullptr, stream);
  } else {
    rc = tile ? launch_hxt_fma<XT>(X, Hx, g, n, K, p.GB, p.n_split, p.cells_per_split, p.S,
                                   p.CW, part_x, stream)
              : launch_hxt_fma_wide<XT>(X, Hx, g, n, K, p.n_split, p.cells_per_split, part_x,
                                        stream);
  }
  if (rc != 0) return rc;
  // stats: HHt (K K), rowsum (K), Bnum (L K), the prediction rows (L), the
  // loss dot (1) and, in counts mode, HHtU (ops/kernels.py:_stats_len)
  const size_t kk = (size_t)K * K;
  const size_t S_small = (size_t)K + (size_t)L * K + L + 1;
  rc = launch_gram_wide(Hn, kCounts ? C + n : nullptr, Q, K, n, L, p.g_split,
                        p.g_cells_per_split, part_hh, stats,
                        kCounts ? stats + kk + S_small : nullptr, stats + kk, stats + kk + K,
                        stream);
  if (rc != 0) return rc;
  const size_t total = (size_t)(L + 1) + (size_t)g * K;
  reduce_partials<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, p.n_part, L + 1, stats + kk + K + (size_t)L * K, part_x, p.n_split, K, g, XHt);
  return (int)cudaGetLastError();
}

}  // namespace alpine

// Plain C entry points (ctypes).  Each returns 0 or a cudaError_t code.
// hxt and wtx take K <= 512 (above: alpine_hxt_wide / alpine_wtx_wide on
// int8/bf16 X, alpine_hxt_fma_wide / alpine_wtx_fma_wide on float32/int16).
// hxt: `stages` and `chunk` (cells a ring stage holds) serve both paths,
// the scratch `hb` (K x n rounded up to the chunk, bf16) only the bf16 path
// (int8, bf16 X).  wtx: `T` (cells a tile), `chunk` (genes a ring stage) and
// `stages` serve both paths; `WR` is the bf16 path's warp rows and the fp32
// path's lanes along K (LK); `ranges`, `range_genes`, the scratch `wb` (Kp
// x g rounded up to the chunk, bf16), `part` (ranges x K x n) and
// `arrivals` (a zeroed counter a tile) serve the bf16 path only.
extern "C" int alpine_hxt(const void* X, int xtype, const float* H, int g, int n,
                          int K, int GB, int n_split, int cells_per_split, int stages,
                          int chunk, void* hb, float* part, float* out, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* Hb = static_cast<__nv_bfloat16*>(hb);
  switch (xtype) {
    case kF32:
      return launch_hxt<float, false>(X, H, g, n, K, GB, n_split, cells_per_split,
                                      stages, chunk, Hb, part, out, s);
    case kBF16:
      return launch_hxt<__nv_bfloat16, true>(X, H, g, n, K, GB, n_split, cells_per_split,
                                             stages, chunk, Hb, part, out, s);
    case kI8:
      return launch_hxt<int8_t, true>(X, H, g, n, K, GB, n_split, cells_per_split,
                                      stages, chunk, Hb, part, out, s);
    case kI16:
      return launch_hxt<int16_t, false>(X, H, g, n, K, GB, n_split, cells_per_split,
                                        stages, chunk, Hb, part, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int alpine_wtx(const void* X, int xtype, const float* W, int g, int n,
                          int K, int T, int WR, int chunk, int stages, int ranges,
                          int range_genes, void* wb, float* part, void* arrivals, float* out,
                          void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* Wb = static_cast<__nv_bfloat16*>(wb);
  unsigned* arr = static_cast<unsigned*>(arrivals);
  switch (xtype) {
    case kF32: return launch_wtx_fma<float>(X, W, g, n, K, T, WR, chunk, stages, out, s);
    case kBF16:
      return launch_wtx_mma<__nv_bfloat16>(X, W, g, n, K, T, WR, chunk, stages, ranges,
                                           range_genes, Wb, part, arr, out, s);
    case kI8:
      return launch_wtx_mma<int8_t>(X, W, g, n, K, T, WR, chunk, stages, ranges,
                                    range_genes, Wb, part, arr, out, s);
    case kI16:
      return launch_wtx_fma<int16_t>(X, W, g, n, K, T, WR, chunk, stages, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// P1 and P2 above K = 512 on float32/int16 X (fma_wide.cuh), all of K in
// one launch.  hxt: n_split splits of cells_per_split cells into `part`
// (n_split x K x g), added in split order into `out` (K x g) by
// reduce_splits; with one split the kernel writes `out` itself (part may be
// nullptr).  wtx: out (K x n).
extern "C" int alpine_hxt_fma_wide(const void* X, int xtype, const float* H, int g, int n,
                                   int K, int n_split, int cells_per_split, float* part,
                                   float* out, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = n_split > 1 ? part : out;
  if (dst == nullptr) return (int)cudaErrorInvalidValue;
  int rc;
  switch (xtype) {
    case kF32:
      rc = launch_hxt_fma_wide<float>(X, H, g, n, K, n_split, cells_per_split, dst, s);
      break;
    case kI16:
      rc = launch_hxt_fma_wide<int16_t>(X, H, g, n, K, n_split, cells_per_split, dst, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0 || n_split == 1) return rc;
  const size_t total = (size_t)K * g;
  reduce_splits<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, n_split, K, g, out);
  return (int)cudaGetLastError();
}

extern "C" int alpine_wtx_fma_wide(const void* X, int xtype, const float* W, int g, int n,
                                   int K, float* out, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (xtype) {
    case kF32: return launch_wtx_fma_wide<float>(X, W, g, n, K, out, s);
    case kI16: return launch_wtx_fma_wide<int16_t>(X, W, g, n, K, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// fused_iteration at every K (ops/kernels.py:_launch_iteration): the K1
// entry's inputs and outputs (stats in ops/kernels.py:_stats_len's layout:
// HHt, rowsum, Bnum, the prediction rows, the loss dot, HHtU), whether
// iter_wide stages Bg in shared memory (kernels.wide_stages_bg), the 16
// ints of IterationGrid, and scratch: wtx, d (K x n each), hs (K x n,
// counts mode), q (L x n), part (n_part x (L + 1)), part_x (n_split x K x
// g), part_hh (gram_split x gram_split_floats), and on the bf16 path hb (H
// rounded, K x n padded to P1's chunk), wb (W rounded, pad16(K) x g padded
// to P2's gene chunk), wpart (P2's gene ranges' partials, where it splits
// the genes) and arrivals (at K <= 512, a zeroed counter a tile of P2
// where it splits the genes).
extern "C" int alpine_fused_iteration(
    const void* X, int xtype, const float* W, const float* H, const float* WtW,
    const void* Y, const float* Bg, const float* lam_rows, const float* counts,
    int g, int n, int K, int L, int Kg, int loss_kl, int stage_bg, float eps, int T,
    int n_part,
    int tiles_per_block, int wtx_T, int wtx_WR, int wtx_GC, int wtx_S,
    int wtx_ranges, int wtx_range_genes, int GB, int n_split, int cells_per_split,
    int stages, int chunk, int gram_split, int gram_cells_per_split, float* Hn, float* XHt,
    float* stats, float* wtx, float* d, float* hs, float* q, float* part, float* part_x,
    float* part_hh, void* hb, void* wb, float* wpart, void* arrivals, float* wtwt,
    void* stream) {
  using namespace alpine;
  const IterationGrid p{T,       n_part,          tiles_per_block, wtx_T,      wtx_WR,
                        wtx_GC,  wtx_S,           wtx_ranges,      wtx_range_genes, GB,
                        n_split, cells_per_split, stages,          chunk,      gram_split,
                        gram_cells_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ALPINE_ITER_ARGS                                                                 \
  X, W, H, WtW, Y, Bg, lam_rows, counts, g, n, K, L, Kg, loss_kl, stage_bg, eps, p, Hn, XHt, \
      stats, wtx, d, hs, q, part, part_x, part_hh, hb, wb, wpart, arrivals, wtwt, s
  const bool c = counts != nullptr;
  switch (xtype) {
    case kF32:
      return c ? launch_iteration<float, false, true>(ALPINE_ITER_ARGS)
               : launch_iteration<float, false, false>(ALPINE_ITER_ARGS);
    case kBF16:
      return c ? launch_iteration<__nv_bfloat16, true, true>(ALPINE_ITER_ARGS)
               : launch_iteration<__nv_bfloat16, true, false>(ALPINE_ITER_ARGS);
    case kI8:
      return c ? launch_iteration<int8_t, true, true>(ALPINE_ITER_ARGS)
               : launch_iteration<int8_t, true, false>(ALPINE_ITER_ARGS);
    case kI16:
      return c ? launch_iteration<int16_t, false, true>(ALPINE_ITER_ARGS)
               : launch_iteration<int16_t, false, false>(ALPINE_ITER_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ALPINE_ITER_ARGS
}

// wtw_gemm's store alone (ops/kernels.py:wtw_gemm): out = A B for A K x K
// and B K x n, A transposed first into At (a K x K scratch).
extern "C" int alpine_wtw_gemm(const float* A, const float* B, int K, int n, float* At,
                               float* out, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_wtw_transpose(A, K, At, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wtw_gemm<kGemmStore>(At, B, K, n, nullptr, 0.f, out, s);
}

// gram_wide alone (ops/kernels.py:gram_wide): HHt = Hn diag(c) Hnᵀ (c: a
// row of n, or nullptr for all ones), HHtU = Hn Hnᵀ (only with c), rowsum =
// Hn c and Bnum = Q diag(c) Hnᵀ (Q: L x n) over gram_split splits of
// gram_cells_per_split cells; part: gram_split x gram_split_floats scratch.
extern "C" int alpine_gram_wide(const float* Hn, const float* c, const float* Q, int K, int n,
                                int L, int gram_split, int gram_cells_per_split, float* part,
                                float* hht, float* hhtu, float* rowsum, float* bnum,
                                void* stream) {
  return alpine::launch_gram_wide(Hn, c, Q, K, n, L, gram_split, gram_cells_per_split, part,
                                  hht, hhtu, rowsum, bnum, static_cast<cudaStream_t>(stream));
}

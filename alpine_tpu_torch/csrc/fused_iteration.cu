// One whole joint multiplicative-update iteration over the cells: the H
// update with its guided terms, plus every statistic the next iteration's
// W and B updates and the loss need.
//
// Replaces: alpine_tpu/ops/pallas_kernels.py:fused_iteration (_iter_kernel)
// with and without its counts mode and, with no covariates (L == 0),
// pallas_kernels.py:fused_h_update (_h_kernel).
//
// Bound on the H100: device-memory bytes.  At 100k cells x 2000 genes,
// K = 40, int8 X, one launch must move X (200 MB), H in and out (32 MB) and
// Y; the X products are 32 GFLOP, below the bf16 tensor-core roof.
//
// Design (a first, simple version: right before fast):
//  * iter_tiles: a grid of at most 2112 blocks, each walking a contiguous
//    range of T-cell tiles.  Per tile it accumulates WtX = W^T X over gene
//    chunks staged in shared memory (X widened to fp32, W rounded to bf16
//    where X computes in bf16), forms Hn = H * num / max(den, eps) with the
//    guided terms of all covariates through the block-embedded Bg, and adds
//    the tile's H-side statistics (HHt, rowsum, Bnum, the prediction-loss
//    rows and the loss dot) into that block's private partial in global
//    memory.  The ragged last tile is masked, so the cell axis needs no
//    padding and the KL loss carries no padding bias.
//  * hxt_partial: XHt = X Hn^T split over (gene block, cell range); each
//    block keeps its K x GB outputs in registers and writes one partial.
//    This reads X a second time from device memory (the TPU kernel reads it
//    once); fusing the two passes is later work.
//  * reduce_partials: sums every partial in a fixed order, so a run gives
//    the same bits each time (no floating-point atomics).
// All arithmetic is fp32 FMA: matmul_precision="highest" means true fp32,
// and no TF32 tensor-core path is taken.
//
// Counts mode (weighted_fast; pallas_kernels.py:fused_iteration with
// `counts`, _iter_kernel:471-592): a (2, n) f32 count block C rides along.
// Row 0 (this iteration's draw) masks the H update: a column drawn 0 times
// keeps its H, bit for bit (a select; the TPU kernel's lerp H + (Hn - H)·m
// is a Mosaic workaround that may differ by 1 ulp on drawn columns).  Row 1
// (the next draw) scales every contraction over cells against Hn:
// Hs = c_next * Hn feeds X Hsᵀ, HHt = Hs Hnᵀ, rowsum(Hs) and Bnum = Q Hsᵀ;
// the loss dot and the prediction-loss rows stay unscaled, and one more
// K x K output, HHtU = Hn Hnᵀ, carries the unscaled product the
// reconstruction loss needs.  hxt_partial rounds the product c_next * hn
// to X's partner dtype, as the TPU kernel rounds Hs.  Counts mode is a
// template parameter, so the passes above compile unchanged without it.  Bound at 100k cells x 2000 genes, K = 40, int8
// X: 234 MB (the 233 MB above + 0.8 MB of counts), 0.070 ms at 3.35 TB/s.
#include "common.cuh"

namespace alpine {

constexpr int kGeneChunk = 16;  // genes staged per phase-1 step
constexpr int kCellChunk = 32;  // cells staged per hxt_partial step

// Shared-memory layout of iter_tiles; ops/kernels.py:_iter_smem_bytes
// computes the same size.  K x T and L x T arrays use a row stride of T + 1
// so that column walks do not hit one bank.
__host__ __device__ inline size_t iter_smem_floats(int K, int T, int L, int Kg,
                                                   bool counts) {
  const size_t TP = T + 1;
  return (size_t)kGeneChunk * K + (size_t)kGeneChunk * T + 3 * K * TP +
         3 * L * TP + (size_t)L * Kg + 2 * (size_t)Kg + kThreads +
         (counts ? (K + 2) * TP : 0);
}

template <typename XT, bool kBf16, bool kCounts>
__global__ void __launch_bounds__(kThreads)
iter_tiles(const XT* __restrict__ X, const float* __restrict__ W,
           const float* __restrict__ H, const float* __restrict__ WtW,
           const XT* __restrict__ Y, const float* __restrict__ Bg,
           const float* __restrict__ lam_rows, const float* __restrict__ C,
           int g, int n, int K, int L, int Kg, int loss_kl, float eps, int T,
           int tiles_per_block, int n_tiles, int S_len,
           float* __restrict__ Hn, float* __restrict__ part) {
  extern __shared__ float sm[];
  const int TP = T + 1;
  float* sW = sm;                          // kGeneChunk x K
  float* sX = sW + kGeneChunk * K;         // kGeneChunk x T
  float* sH = sX + kGeneChunk * T;         // K x TP
  float* sWtX = sH + K * TP;               // K x TP
  float* sHn = sWtX + K * TP;              // K x TP
  float* sY = sHn + K * TP;                // L x TP (Y widened to fp32)
  float* sA = sY + L * TP;                 // L x TP: B H, then Y/max(BH), then Q
  float* sE = sA + L * TP;                 // L x TP: prediction-loss terms
  float* sBg = sE + L * TP;                // L x Kg
  float* sLam = sBg + L * Kg;              // Kg: lambda of each guided row
  float* sCol = sLam + Kg;                 // Kg: column sums of Bg
  float* sRed = sCol + Kg;                 // kThreads
  // counts mode only: the tile's count rows and Hs = c_next * Hn
  float* sC = sRed + kThreads;                // 2 x TP: c_cur, then c_next
  float* sHs = kCounts ? sC + 2 * TP : sHn;  // K x TP

  const int tid = threadIdx.x;
  const int KT = K * T;
  const int off_rowsum = K * K;
  const int off_bnum = off_rowsum + K;
  const int off_pred = off_bnum + L * K;
  const int off_ld = off_pred + L;
  const int off_hhtu = off_ld + 1;  // counts mode: unscaled Hn Hnᵀ
  float* mypart = part + (size_t)blockIdx.x * S_len;

  for (int j = tid; j < S_len; j += kThreads) mypart[j] = 0.f;
  for (int j = tid; j < L * Kg; j += kThreads) sBg[j] = Bg[j];
  for (int j = tid; j < Kg; j += kThreads) sLam[j] = lam_rows[j];
  __syncthreads();
  for (int k = tid; k < Kg; k += kThreads) {
    float s = 0.f;
    for (int l = 0; l < L; ++l) s += sBg[l * Kg + k];
    sCol[k] = s;
  }

  const int tile_begin = blockIdx.x * tiles_per_block;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_block);
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int c0 = tile * T;
    const int nv = min(T, n - c0);  // valid cells of this tile
    __syncthreads();  // the previous tile is done with shared memory
    for (int o = tid; o < KT; o += kThreads) {
      const int k = o / T, t = o - k * T;
      sH[k * TP + t] = t < nv ? H[(size_t)k * n + c0 + t] : 0.f;
    }
    for (int o = tid; o < L * T; o += kThreads) {
      const int l = o / T, t = o - l * T;
      sY[l * TP + t] = t < nv ? to_f(Y[(size_t)l * n + c0 + t]) : 0.f;
    }
    if constexpr (kCounts) {
      for (int o = tid; o < 2 * T; o += kThreads) {
        const int r = o / T, t = o - r * T;
        sC[r * TP + t] = t < nv ? C[(size_t)r * n + c0 + t] : 0.f;
      }
    }

    // phase 1: WtX over gene chunks, kept in registers
    float acc[kMaxOut];
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;
    for (int g0 = 0; g0 < g; g0 += kGeneChunk) {
      __syncthreads();
      for (int o = tid; o < kGeneChunk * K; o += kThreads) {
        const int gg = o / K, k = o - gg * K;
        sW[o] = g0 + gg < g ? round_op<kBf16>(W[(size_t)(g0 + gg) * K + k]) : 0.f;
      }
      for (int o = tid; o < kGeneChunk * T; o += kThreads) {
        const int gg = o / T, t = o - gg * T;
        sX[o] = (g0 + gg < g && t < nv) ? to_f(X[(size_t)(g0 + gg) * n + c0 + t]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kMaxOut; ++i) {
        const int o = tid + i * kThreads;
        if (o < KT) {
          const int k = o / T, t = o - k * T;
          float a = acc[i];
#pragma unroll
          for (int gg = 0; gg < kGeneChunk; ++gg)
            a = fmaf(sW[gg * K + k], sX[gg * T + t], a);
          acc[i] = a;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kThreads;
      if (o < KT) {
        const int k = o / T, t = o - k * T;
        sWtX[k * TP + t] = acc[i];
      }
    }
    __syncthreads();

    // guided rows: B H over the guided block of H (all covariates at once)
    if (L > 0) {
      for (int o = tid; o < L * T; o += kThreads) {
        const int l = o / T, t = o - l * T;
        float bh = 0.f;
        for (int j = 0; j < Kg; ++j) bh = fmaf(sBg[l * Kg + j], sH[j * TP + t], bh);
        sA[l * TP + t] = loss_kl ? sY[l * TP + t] / fmaxf(bh, eps) : bh;
      }
      __syncthreads();
    }

    // the multiplicative H update
    for (int o = tid; o < KT; o += kThreads) {
      const int k = o / T, t = o - k * T;
      float d = 0.f;
      for (int j = 0; j < K; ++j) d = fmaf(__ldg(&WtW[k * K + j]), sH[j * TP + t], d);
      float num = 2.f * sWtX[k * TP + t];
      float den = 2.f * d;
      if (k < Kg) {
        if (loss_kl) {
          float s = 0.f;
          for (int l = 0; l < L; ++l) s = fmaf(sBg[l * Kg + k], sA[l * TP + t], s);
          num += sLam[k] * s;
          den += sLam[k] * sCol[k];
        } else {
          float sy = 0.f, sb = 0.f;
          for (int l = 0; l < L; ++l) {
            sy = fmaf(sBg[l * Kg + k], sY[l * TP + t], sy);
            sb = fmaf(sBg[l * Kg + k], sA[l * TP + t], sb);
          }
          const float l2 = 2.f * sLam[k];
          num += l2 * sy;
          den += l2 * sb;
        }
      }
      float hn = t < nv ? sH[k * TP + t] * (num / fmaxf(den, eps)) : 0.f;
      if constexpr (kCounts) {
        if (!(sC[t] > 0.f)) hn = sH[k * TP + t];  // undrawn: keep H
        sHs[k * TP + t] = hn * sC[TP + t];
      }
      sHn[k * TP + t] = hn;
      if (t < nv) Hn[(size_t)k * n + c0 + t] = hn;
    }
    __syncthreads();

    // loss dot: sum of WtX * Hn over the tile
    float ld = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kThreads;
      if (o < KT) {
        const int k = o / T, t = o - k * T;
        ld = fmaf(acc[i], sHn[k * TP + t], ld);
      }
    }
    sRed[tid] = ld;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (tid < s) sRed[tid] += sRed[tid + s];
      __syncthreads();
    }
    if (tid == 0) mypart[off_ld] += sRed[0];

    // HHt = Hs Hnᵀ (and, in counts mode, HHtU = Hn Hnᵀ); row sums of Hs
    for (int j = tid; j < K * K; j += kThreads) {
      const int k1 = j / K, k2 = j - k1 * K;
      float s = 0.f;
      if constexpr (kCounts) {
        float u = 0.f;
        for (int t = 0; t < nv; ++t) {
          const float b = sHn[k2 * TP + t];
          s = fmaf(sHs[k1 * TP + t], b, s);
          u = fmaf(sHn[k1 * TP + t], b, u);
        }
        mypart[off_hhtu + j] += u;
      } else {
        for (int t = 0; t < nv; ++t) s = fmaf(sHn[k1 * TP + t], sHn[k2 * TP + t], s);
      }
      mypart[j] += s;
    }
    for (int k = tid; k < K; k += kThreads) {
      float s = 0.f;
      for (int t = 0; t < nv; ++t) s += sHs[k * TP + t];
      mypart[off_rowsum + k] += s;
    }

    if (L > 0) {
      // prediction loss on (B, Hn) and the next B update's numerators
      for (int o = tid; o < L * T; o += kThreads) {
        const int l = o / T, t = o - l * T;
        float yh = 0.f;
        for (int j = 0; j < Kg; ++j) yh = fmaf(sBg[l * Kg + j], sHn[j * TP + t], yh);
        const float y = sY[l * TP + t];
        float q, e;
        if (loss_kl) {
          const float yc = fmaxf(yh, eps);
          q = y / yc;
          e = y * logf(fmaxf(q, eps)) - y + yc;
        } else {
          const float dd = y - yh;
          q = y;
          e = dd * dd;
        }
        sA[l * TP + t] = q;
        sE[l * TP + t] = t < nv ? e : 0.f;
      }
      __syncthreads();
      for (int j = tid; j < L * K; j += kThreads) {
        const int l = j / K, k = j - l * K;
        float s = 0.f;
        for (int t = 0; t < nv; ++t) s = fmaf(sA[l * TP + t], sHs[k * TP + t], s);
        mypart[off_bnum + j] += s;
      }
      for (int l = tid; l < L; l += kThreads) {
        float s = 0.f;
        for (int t = 0; t < nv; ++t) s += sE[l * TP + t];
        mypart[off_pred + l] += s;
      }
    }
  }
}

template <typename XT, bool kBf16, bool kCounts>
__global__ void __launch_bounds__(kThreads)
hxt_partial(const XT* __restrict__ X, const float* __restrict__ Hn,
            const float* __restrict__ C, int g, int n, int K, int GB,
            int cells_per_split, float* __restrict__ part_hxt) {
  extern __shared__ float sm[];
  constexpr int CT = kCellChunk, CTP = kCellChunk + 1;
  float* sHc = sm;            // K x CTP: Hn (or c_next * Hn) rounded as X's partner
  float* sXc = sHc + K * CTP;  // GB x CTP
  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * GB;
  const int split = blockIdx.y;
  const int cbeg = split * cells_per_split;
  const int cend = min(n, cbeg + cells_per_split);
  const int KG = K * GB;

  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;
  for (int c0 = cbeg; c0 < cend; c0 += CT) {
    const int nv = min(CT, cend - c0);
    __syncthreads();
    for (int o = tid; o < K * CT; o += kThreads) {
      const int k = o / CT, t = o - k * CT;
      float h = 0.f;
      if (t < nv) {
        h = Hn[(size_t)k * n + c0 + t];
        if constexpr (kCounts) h *= C[(size_t)n + c0 + t];  // round c*hn, not hn
      }
      sHc[k * CTP + t] = round_op<kBf16>(h);
    }
    for (int o = tid; o < GB * CT; o += kThreads) {
      const int gg = o / CT, t = o - gg * CT;
      sXc[gg * CTP + t] =
          (t < nv && g0 + gg < g) ? to_f(X[(size_t)(g0 + gg) * n + c0 + t]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kThreads;
      if (o < KG) {
        const int k = o / GB, gg = o - k * GB;
        float a = acc[i];
#pragma unroll 8
        for (int t = 0; t < CT; ++t) a = fmaf(sHc[k * CTP + t], sXc[gg * CTP + t], a);
        acc[i] = a;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int o = tid + i * kThreads;
    if (o < KG) {
      const int k = o / GB, gg = o - k * GB;
      if (g0 + gg < g) part_hxt[((size_t)split * K + k) * g + g0 + gg] = acc[i];
    }
  }
}

// stats[j] = sum over blocks of part[b][j]; XHt[gi][k] = sum over splits of
// part_hxt[s][k][gi].  Fixed summation order: the same bits every run.
__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ part, int n_part, int S_len,
                float* __restrict__ stats, const float* __restrict__ part_hxt,
                int n_split, int K, int g, float* __restrict__ XHt) {
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < (size_t)S_len) {
    float s = 0.f;
    for (int b = 0; b < n_part; ++b) s += part[(size_t)b * S_len + idx];
    stats[idx] = s;
    return;
  }
  idx -= S_len;
  if (idx < (size_t)g * K) {
    const int gi = (int)(idx / K), k = (int)(idx - (size_t)gi * K);
    float s = 0.f;
    for (int sp = 0; sp < n_split; ++sp) s += part_hxt[((size_t)sp * K + k) * g + gi];
    XHt[idx] = s;
  }
}

template <typename XT, bool kBf16, bool kCounts>
static int launch(const void* X, const float* W, const float* H,
                  const float* WtW, const void* Y, const float* Bg,
                  const float* lam_rows, const float* C, int g, int n, int K,
                  int L, int Kg, int loss_kl, float eps, int T, int n_part,
                  int tiles_per_block, int GB, int n_split,
                  int cells_per_split, float* Hn, float* XHt, float* stats,
                  float* part, float* part_hxt, cudaStream_t stream) {
  const int n_tiles = (n + T - 1) / T;
  // ops/kernels.py:_stats_len: HHt, rowsum, Bnum, pred rows, loss dot, HHtU
  const int S_len = K * K + K + L * K + L + 1 + (kCounts ? K * K : 0);
  const size_t smem_a = iter_smem_floats(K, T, L, Kg, kCounts) * sizeof(float);
  const size_t smem_b = (size_t)(K + GB) * (kCellChunk + 1) * sizeof(float);
  if (K * T > kThreads * kMaxOut || K * GB > kThreads * kMaxOut ||
      smem_a > (size_t)kMaxSmem || smem_b > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      iter_tiles<XT, kBf16, kCounts>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(hxt_partial<XT, kBf16, kCounts>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;

  iter_tiles<XT, kBf16, kCounts><<<n_part, kThreads, smem_a, stream>>>(
      static_cast<const XT*>(X), W, H, WtW, static_cast<const XT*>(Y), Bg,
      lam_rows, C, g, n, K, L, Kg, loss_kl, eps, T, tiles_per_block, n_tiles,
      S_len, Hn, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_b((g + GB - 1) / GB, n_split);
  hxt_partial<XT, kBf16, kCounts><<<grid_b, kThreads, smem_b, stream>>>(
      static_cast<const XT*>(X), Hn, C, g, n, K, GB, cells_per_split, part_hxt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)S_len + (size_t)g * K;
  reduce_partials<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, n_part, S_len, stats, part_hxt, n_split, K, g, XHt);
  return (int)cudaGetLastError();
}

}  // namespace alpine

// Plain C entry point (ctypes).  Returns 0 or a cudaError_t code.
extern "C" int alpine_fused_iteration(
    const void* X, int xtype, const float* W, const float* H, const float* WtW,
    const void* Y, const float* Bg, const float* lam_rows, const float* counts,
    int g, int n, int K, int L, int Kg, int loss_kl, float eps, int T, int n_part,
    int tiles_per_block, int GB, int n_split, int cells_per_split, float* Hn,
    float* XHt, float* stats, float* part, float* part_hxt, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ALPINE_ITER_ARGS                                                      \
  X, W, H, WtW, Y, Bg, lam_rows, counts, g, n, K, L, Kg, loss_kl, eps, T,    \
      n_part, tiles_per_block, GB, n_split, cells_per_split, Hn, XHt, stats, \
      part, part_hxt, s
  // counts mode is a template parameter: K1 and K2 compile as without it
  const bool c = counts != nullptr;
  switch (xtype) {
    case kF32:
      return c ? launch<float, false, true>(ALPINE_ITER_ARGS)
               : launch<float, false, false>(ALPINE_ITER_ARGS);
    case kBF16:
      return c ? launch<__nv_bfloat16, true, true>(ALPINE_ITER_ARGS)
               : launch<__nv_bfloat16, true, false>(ALPINE_ITER_ARGS);
    case kI8:
      return c ? launch<int8_t, true, true>(ALPINE_ITER_ARGS)
               : launch<int8_t, true, false>(ALPINE_ITER_ARGS);
    case kI16:
      return c ? launch<int16_t, false, true>(ALPINE_ITER_ARGS)
               : launch<int16_t, false, false>(ALPINE_ITER_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ALPINE_ITER_ARGS
}

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
// Design (simple first, then the X products on tensor cores):
//  * iter_tiles: a grid of at most 2112 blocks, each walking a contiguous
//    range of T-cell tiles.  Per tile it has WtX = W^T X (bf16 path: over
//    gene chunks staged in shared memory; fp32 path: from wtx_fma), forms
//    Hn = H * num / max(den, eps) with the guided terms of all covariates
//    through the block-embedded Bg, and adds the tile's H-side statistics
//    (HHt, rowsum, Bnum, the prediction-loss rows and the loss dot) into
//    that block's private partial in global memory.  The ragged last tile is masked, so the cell
//    axis needs no padding and the KL loss carries no padding bias.
//  * hxt_partial (bf16 path; hxt_fma on the fp32 path): XHt = X Hn^T split
//    over (gene block, cell range); each block accumulates its K x GB
//    outputs and writes one partial.  This reads X a second time from
//    device memory (the TPU kernel reads it once); fusing the two passes is
//    later work.
//  * reduce_partials (fma_passes.cuh): sums every partial in a fixed order,
//    so a run gives the same bits each time (no floating-point atomics).
//
// Where X computes in bf16 (int8 and bf16 storage, kBf16), both X products
// run on the tensor cores through the WMMA API (bf16 m16n16k16, fp32
// accumulators), as the TPU kernel runs them on its matrix unit in one
// exact bf16 pass: W, Hn (or c_next * Hn) and X are staged in shared memory
// as bf16, K padded with zero rows to Kp = pad16(K), the ragged cells and
// genes zeroed.  Warp w of a block owns accumulator fragments w and w + 8
// of the Kp x T (iter_tiles) or Kp x GB (hxt_partial) output, 16 fragments
// a pass over the genes (cells); K > 256 takes a second pass, so that two
// fragments a warp keep each pass within the registers of three blocks an
// SM.  iter_tiles stores the fragments to shared memory (sWtX, row stride
// T + 4) for the H update and the loss dot, hxt_partial through shared
// memory to its partial.  Products are exact and sums fp32: the plain
// version's result up to summation order.  Fragments take 16 cells, so this
// path has its own tile rule (ops/kernels.py:iteration_tile_width):
// T = max(16, tile_width(K)), a multiple of 16 for every K up to 512.
//
// Staging, not the products, is what the bf16 path spends its time on (on
// the H100, the X loads alone took most of each pass when they moved a byte
// a thread): X, Hn·c and W move in 16-byte loads where their rows are
// 16-byte aligned (n a multiple of 16 / sizeof for X, of 4 for Hn; W always,
// as one contiguous run a chunk), else element by element, into the same
// bf16 values either way; X's loads are issued before W's (Hn's) so that
// the two latencies overlap.  What bounds these passes now is the latency
// of each chunk's loads, the per-tile scalar work (the H update's WtW·H,
// HHt, the guided rows) and, in hxt_partial, re-reading Hn from L2 for
// every gene block.
//
// Float32 and int16 X run both X products on the FP32 units
// (matmul_precision="highest" means true fp32: no TF32) through the
// kernels of ALS's fp32 X passes (fma_passes.cuh), one C call launching
// four kernels in order:
//  * wtx_fma writes WtX = Wᵀ X (K x n fp32) to a scratch buffer over its
//    own one-wave grid of wide cell tiles (ops/kernels.py:wtx_fma_grid);
//  * iter_tiles reads its tile of WtX into sWtX and does the H update and
//    the statistics as above (no gene loop of its own);
//  * hxt_fma sums X Hnᵀ (in counts mode X Hsᵀ, with Hs = c_next * Hn, which
//    iter_tiles writes to a second K x n scratch buffer) into one partial a
//    cell split over hxt_fma_grid's one-wave grid;
//  * reduce_partials adds the statistics' and the splits' partials.
// Each pass streams X as stored through a cp.async ring and keeps a
// register micro-tile a thread; int16 is widened exactly in shared memory.
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
// to bf16, as the TPU kernel rounds Hs; on the fp32 path hxt_fma reads the
// same fp32 product from the Hs buffer.  Counts mode is a template
// parameter, so the passes above compile unchanged without it.
// Bound at 100k cells x 2000 genes, K = 40, int8 X: 234 MB (the 233 MB
// above + 0.8 MB of counts), 0.070 ms at 3.35 TB/s.
#include "fma_passes.cuh"

#include <mma.h>

namespace alpine {

using namespace nvcuda;

// bf16 path: genes per phase-1 step (ops/kernels.py: _MMA_GENE_CHUNK), cells
// per hxt_partial step, and the accumulator fragments a warp holds in one
// pass over the genes or cells: a block holds kWarps * kMmaFrags = 16
// (ops/kernels.py: _MMA_PASS_FRAGS), and a larger output (K > 256) takes a
// second pass.  Two fragments a warp keep the passes within the registers
// that let three blocks share an SM (kMmaMinBlocks).
constexpr int kMmaGeneChunk = 32;
constexpr int kMmaCellChunk = 64;
constexpr int kMmaFrags = 2;
constexpr int kMmaMinBlocks = 3;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ inline int pad16(int v) { return (v + 15) / 16 * 16; }

// Shared-memory layout of iter_tiles, in floats:
//   staging | sH | sWtX | sHn | sY | sA | sE | sBg | sLam | sCol | sRed | sC, sHs
// ops/kernels.py:_iter_smem_bytes computes the same size.  K x T and L x T
// arrays use a row stride of T + 1 so that column walks do not hit one bank.
// On the bf16 path (mma) the staging holds bf16 W and X chunks with rows
// padded by 8 values, and sWtX has Kp rows of stride T + 4: a fragment store
// needs a stride that is a multiple of 4 floats and 32-byte aligned rows.
// The fp32 path stages nothing: its WtX comes from wtx_fma.
__host__ __device__ inline size_t iter_stage_floats(bool mma, int K, int T) {
  return mma ? (size_t)kMmaGeneChunk * (pad16(K) + 8 + T + 8) / 2 : 0;
}
__host__ __device__ inline size_t iter_h_floats(bool mma, int K, int T) {
  const size_t f = (size_t)K * (T + 1);
  return mma ? (f + 7) / 8 * 8 : f;  // keeps sWtX 32-byte aligned
}
__host__ __device__ inline size_t iter_wtx_floats(bool mma, int K, int T) {
  return mma ? (size_t)pad16(K) * (T + 4) : (size_t)K * (T + 1);
}
__host__ __device__ inline size_t iter_smem_floats(int K, int T, int L, int Kg,
                                                   bool counts, bool mma) {
  const size_t TP = T + 1;
  return iter_stage_floats(mma, K, T) + iter_h_floats(mma, K, T) +
         iter_wtx_floats(mma, K, T) + K * TP + 3 * L * TP + (size_t)L * Kg +
         2 * (size_t)Kg + kThreads + (counts ? (K + 2) * TP : 0);
}

// hxt_partial's bf16 path: Hc (Kp x LC) and X (GB x LC) chunks as bf16, LC =
// kMmaCellChunk + 8; after a pass's last chunk the same bytes hold the
// Kp x (GB + 4) fp32 output on its way to the partial.
__host__ __device__ inline size_t hxt_mma_smem_bytes(int K, int GB) {
  const size_t stage = (size_t)(pad16(K) + GB) * (kMmaCellChunk + 8) * 2;
  const size_t out = (size_t)pad16(K) * (GB + 4) * 4;
  return stage > out ? stage : out;
}

// dst[i * ld + j] = bf16(value(i, j)) for i < rows, j < cols: thread t takes
// the elements t, t + kThreads, ... of the row-major block, eight loads in
// flight before their stores.  (i, j) advance by a fixed step, so no
// element pays an integer division.
template <typename F>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int ld, int rows,
                                           int cols, F value) {
  const int t0 = threadIdx.x, di = kThreads / cols, dj = kThreads - di * cols;
  int i = t0 / cols, j = t0 - i * cols;
  while (i < rows) {
    float v[8];
    int at[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      at[r] = -1;
      if (i < rows) {
        v[r] = value(i, j);
        at[r] = i * ld + j;
      }
      i += di;
      j += dj;
      if (j >= cols) {
        j -= cols;
        ++i;
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (at[r] >= 0) dst[at[r]] = __float2bfloat16_rn(v[r]);
  }
}

// 16 loaded bytes of T (the pointer only picks the type) widened to floats.
__device__ __forceinline__ void widen16(uint4 u, const int8_t*, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 16; ++q) f[q] = (float)(int8_t)(w[q >> 2] >> (8 * (q & 3)));
}
__device__ __forceinline__ void widen16(uint4 u, const __nv_bfloat16*, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 v = __bfloat1622float2(h[q]);
    f[2 * q] = v.x;
    f[2 * q + 1] = v.y;
  }
}
__device__ __forceinline__ void widen16(uint4 u, const float*, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// One 16-byte vector (V = 16 / sizeof(T) values) of a rows x cols block on
// its way to shared memory as bf16: element (i, j) is src[i * stride + j]
// (times scale[j]), zero where i >= rv or j >= cv.  load() issues the read
// and store() widens, rounds and writes, so that other loads can be issued in
// between.  The caller has checked that src and stride keep every row's
// vectors 16-byte aligned, so stride, and with it the valid width cv of a
// tile or chunk that starts at a multiple of V, are multiples of V: a vector
// is valid or zero as a whole.
template <typename T, bool kScale>
struct VecSlot {
  static constexpr int V = 16 / sizeof(T);
  static_assert(!kScale || V == 4, "scale goes with fp32 sources");
  uint4 raw;
  float4 sc;
  int i, j;
  bool live, full;

  __device__ __forceinline__ void load(int q, int vpr, int rows, const T* src,
                                       size_t stride, int rv, int cv,
                                       const float* scale) {
    i = q / vpr;
    j = (q - i * vpr) * V;
    live = i < rows;
    full = live && i < rv && j < cv;
    if (full) {
      raw = __ldg(reinterpret_cast<const uint4*>(src + i * stride + j));
      if constexpr (kScale) sc = __ldg(reinterpret_cast<const float4*>(scale + j));
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16* dst, int ld) const {
    if (!live) return;
    float f[V];
    if (full) {
      widen16(raw, static_cast<const T*>(nullptr), f);
      if constexpr (kScale) {
        f[0] *= sc.x;
        f[1] *= sc.y;
        f[2] *= sc.z;
        f[3] *= sc.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) f[u] = 0.f;
    }
    __nv_bfloat162 p[V / 2];
#pragma unroll
    for (int u = 0; u < V / 2; ++u) p[u] = __floats2bfloat162_rn(f[2 * u], f[2 * u + 1]);
    __nv_bfloat16* d = dst + i * ld + j;
    if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(p);
    } else {
#pragma unroll
      for (int w = 0; w < V / 8; ++w)
        reinterpret_cast<uint4*>(d)[w] = reinterpret_cast<const uint4*>(p)[w];
    }
  }
};

// Vectors of X each thread stages for a rows x cols chunk of X.
template <typename XT>
__host__ __device__ constexpr int x_slots(int rows, int cols) {
  return (rows * cols / VecSlot<XT, false>::V + kThreads - 1) / kThreads;
}

// The whole rows x cols block through VecSlots, kBatch loads in flight a
// thread.
template <typename T, bool kScale, int kBatch = 2>
__device__ __forceinline__ void stage_vec(__nv_bfloat16* dst, int ld, int rows,
                                          int cols, const T* src, size_t stride,
                                          int rv, int cv, const float* scale) {
  const int vpr = cols / VecSlot<T, kScale>::V;
  for (int q0 = threadIdx.x; q0 < rows * vpr; q0 += kBatch * kThreads) {
    VecSlot<T, kScale> s[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r)
      s[r].load(q0 + r * kThreads, vpr, rows, src, stride, rv, cv, scale);
#pragma unroll
    for (int r = 0; r < kBatch; ++r) s[r].store(dst, ld);
  }
}

// Rows g0 .. g0 + rows - 1 of W (g x K, fp32) into the bf16 rows of sWb
// (stride LW).  They are one contiguous run of rows * K floats, starting
// 16-byte aligned when W is (g0 is a multiple of kMmaGeneChunk, a multiple
// of 4), so a thread reads 16 bytes a load whatever K is.  Columns K.. and
// rows past g are left as they are: the caller zeroes sWb once, and rows
// past g meet zero rows of X.
__device__ __forceinline__ void stage_w_run(__nv_bfloat16* sWb, int LW,
                                            const float* W, int g0, int rows,
                                            int K) {
  const float* src = W + (size_t)g0 * K;
  const int nw = rows * K;
  for (int e0 = threadIdx.x * 4; e0 < nw; e0 += 2 * 4 * kThreads) {
    float4 v[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = e0 + r * 4 * kThreads;
      if (e + 4 <= nw) {
        v[r] = __ldg(reinterpret_cast<const float4*>(src + e));
      } else if (e < nw) {  // the run's last, partial vector
        v[r].x = src[e];
        v[r].y = e + 1 < nw ? src[e + 1] : 0.f;
        v[r].z = e + 2 < nw ? src[e + 2] : 0.f;
        v[r].w = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = e0 + r * 4 * kThreads;
      if (e >= nw) break;
      int gg = e / K, k = e - gg * K;
      const float f[4] = {v[r].x, v[r].y, v[r].z, v[r].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (e + u < nw) sWb[gg * LW + k] = __float2bfloat16_rn(f[u]);
        if (++k == K) {
          k = 0;
          ++gg;
        }
      }
    }
  }
}

template <typename XT, bool kBf16, bool kCounts>
__global__ void __launch_bounds__(kThreads, kBf16 ? kMmaMinBlocks : 0)
iter_tiles(const XT* __restrict__ X, const float* __restrict__ W,
           const float* __restrict__ H, const float* __restrict__ WtW,
           const XT* __restrict__ Y, const float* __restrict__ Bg,
           const float* __restrict__ lam_rows, const float* __restrict__ C,
           const float* __restrict__ WtXg, int g, int n, int K, int L, int Kg,
           int loss_kl, float eps, int T, int tiles_per_block, int n_tiles,
           int S_len, float* __restrict__ Hn, float* __restrict__ Hs_out,
           float* __restrict__ part) {
  extern __shared__ __align__(128) float sm[];
  const int TP = T + 1;
  const int TW = kBf16 ? T + 4 : TP;       // row stride of sWtX
  // bf16 path: kMmaGeneChunk x (Kp + 8) W and kMmaGeneChunk x (T + 8) X
  const int Kp = pad16(K);
  __nv_bfloat16* sWb = reinterpret_cast<__nv_bfloat16*>(sm);
  __nv_bfloat16* sXb = sWb + kMmaGeneChunk * (Kp + 8);
  float* sH = sm + iter_stage_floats(kBf16, K, T);   // K x TP
  float* sWtX = sH + iter_h_floats(kBf16, K, T);     // K (Kp) x TW
  float* sHn = sWtX + iter_wtx_floats(kBf16, K, T);  // K x TP
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
  if constexpr (kBf16) {  // W's padding columns (and rows past g) stay zero
    for (int j = tid; j < kMmaGeneChunk * (Kp + 8); j += kThreads)
      sWb[j] = __float2bfloat16_rn(0.f);
  }
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

    if constexpr (kBf16) {
      // phase 1 on tensor cores: WtX (Kp x T) = Wᵀ (Kp x chunk) X (chunk x
      // T) over bf16 gene chunks, then stored to sWtX.  X and W move in
      // 16-byte loads where their rows allow, else element by element.
      const bool xvec = rows_aligned16(X, n);
      const bool wvec = (reinterpret_cast<uintptr_t>(W) & 15) == 0;
      const int LW = Kp + 8, LX = T + 8, tcols = T / 16;
      const int n_frag = (Kp / 16) * tcols;
      const int warp = tid / 32;
      // one pass over the genes for K <= 256, a second for the rest
      for (int f0 = 0; f0 < n_frag; f0 += kWarps * kMmaFrags) {
        FragAcc fr[kMmaFrags];
#pragma unroll
        for (int i = 0; i < kMmaFrags; ++i) wmma::fill_fragment(fr[i], 0.f);
        for (int g0 = 0; g0 < g; g0 += kMmaGeneChunk) {
          __syncthreads();
          // X's vectors are read first, so that their latency overlaps W's
          constexpr int kSlots = x_slots<XT>(kMmaGeneChunk, 64);
          VecSlot<XT, false> xs[kSlots];
          const XT* xsrc = X + (size_t)g0 * n + c0;
          const int xvpr = T / VecSlot<XT, false>::V;
          if (xvec) {
#pragma unroll
            for (int s = 0; s < kSlots; ++s)
              xs[s].load(tid + s * kThreads, xvpr, kMmaGeneChunk, xsrc, n, g - g0, nv,
                         nullptr);
          } else {
            stage_bf16(sXb, LX, kMmaGeneChunk, T, [&](int gg, int t) {
              return (g0 + gg < g && t < nv) ? to_f(X[(size_t)(g0 + gg) * n + c0 + t])
                                             : 0.f;
            });
          }
          if (wvec) {
            stage_w_run(sWb, LW, W, g0, min(kMmaGeneChunk, g - g0), K);
          } else {
            stage_bf16(sWb, LW, kMmaGeneChunk, Kp, [&](int gg, int k) {
              return (g0 + gg < g && k < K) ? W[(size_t)(g0 + gg) * K + k] : 0.f;
            });
          }
          if (xvec) {
#pragma unroll
            for (int s = 0; s < kSlots; ++s)
              xs[s].store(sXb, LX);
          }
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < kMmaGeneChunk; kk += 16) {
#pragma unroll
            for (int i = 0; i < kMmaFrags; ++i) {
              const int f = f0 + warp + i * kWarps;
              if (f < n_frag) {  // warp-uniform
                const int r = f / tcols, c = f - r * tcols;
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::col_major> a;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major> b;
                wmma::load_matrix_sync(a, sWb + kk * LW + r * 16, LW);
                wmma::load_matrix_sync(b, sXb + kk * LX + c * 16, LX);
                wmma::mma_sync(fr[i], a, b, fr[i]);
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kMmaFrags; ++i) {
          const int f = f0 + warp + i * kWarps;
          if (f < n_frag) {
            const int r = f / tcols, c = f - r * tcols;
            wmma::store_matrix_sync(sWtX + r * 16 * TW + c * 16, fr[i], TW,
                                    wmma::mem_row_major);
          }
        }
      }
    } else {  // the tile's columns of wtx_fma's WtX
      for (int o = tid; o < KT; o += kThreads) {
        const int k = o / T, t = o - k * T;
        sWtX[k * TP + t] = t < nv ? WtXg[(size_t)k * n + c0 + t] : 0.f;
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
      float num = 2.f * sWtX[k * TW + t];
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
        const float hs = hn * sC[TP + t];
        sHs[k * TP + t] = hs;
        if (!kBf16 && t < nv) Hs_out[(size_t)k * n + c0 + t] = hs;  // for hxt_fma
      }
      sHn[k * TP + t] = hn;
      if (t < nv) Hn[(size_t)k * n + c0 + t] = hn;
    }
    __syncthreads();

    // loss dot: sum of WtX * Hn over the tile
    float ld = 0.f;
    for (int o = tid; o < KT; o += kThreads) {
      const int k = o / T, t = o - k * T;
      ld = fmaf(sWtX[k * TW + t], sHn[k * TP + t], ld);
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

// XHt's partials on the bf16 path (int8, bf16 X); the fp32 path runs
// hxt_fma (fma_passes.cuh).
template <typename XT, bool kCounts>
__global__ void __launch_bounds__(kThreads, kMmaMinBlocks)
hxt_partial(const XT* __restrict__ X, const float* __restrict__ Hn,
            const float* __restrict__ C, int g, int n, int K, int GB,
            int cells_per_split, float* __restrict__ part_hxt) {
  extern __shared__ __align__(128) float sm[];
  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * GB;
  const int split = blockIdx.y;
  const int cbeg = split * cells_per_split;
  const int cend = min(n, cbeg + cells_per_split);

  // on tensor cores: out (Kp x GB) = Hc (Kp x CM) Xcᵀ (CM x GB) over bf16
  // cell chunks; Hc is c_next * Hn in counts mode, rounded after the product
  constexpr int CM = kMmaCellChunk, LC = kMmaCellChunk + 8;
  const int Kp = pad16(K), gcols = GB / 16;
  const int n_frag = (Kp / 16) * gcols;
  const int warp = tid / 32;
  __nv_bfloat16* sHb = reinterpret_cast<__nv_bfloat16*>(sm);  // Kp x LC
  __nv_bfloat16* sXb = sHb + Kp * LC;                          // GB x LC
  float* sOut = sm;  // Kp x (GB + 4), once a pass's last chunk is done
  const int LO = GB + 4;
  // 16-byte loads where the rows allow (Hn and C share X's cell count)
  const bool xvec = rows_aligned16(X, n);
  const bool hvec = rows_aligned16(Hn, n) && (!kCounts || rows_aligned16(C, n));
  // one pass over the cells for K <= 256, a second for the rest; a pass
  // holds whole fragment rows (16 is a multiple of gcols)
  for (int f0 = 0; f0 < n_frag; f0 += kWarps * kMmaFrags) {
    FragAcc fr[kMmaFrags];
#pragma unroll
    for (int i = 0; i < kMmaFrags; ++i) wmma::fill_fragment(fr[i], 0.f);
    for (int c0 = cbeg; c0 < cend; c0 += CM) {
      const int nv = min(CM, cend - c0);
      __syncthreads();
      // X's vectors are read first, so that their latency overlaps Hn's
      constexpr int kSlots = x_slots<XT>(64, CM);
      VecSlot<XT, false> xs[kSlots];
      const XT* xsrc = X + (size_t)g0 * n + c0;
      const int xvpr = CM / VecSlot<XT, false>::V;
      if (xvec) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          xs[s].load(tid + s * kThreads, xvpr, GB, xsrc, n, g - g0, nv, nullptr);
      } else {
        stage_bf16(sXb, LC, GB, CM, [&](int gg, int t) {
          return (t < nv && g0 + gg < g) ? to_f(X[(size_t)(g0 + gg) * n + c0 + t])
                                         : 0.f;
        });
      }
      if (hvec) {
        // bf16 X holds two X vectors a thread here; with the counts row as
        // well, one Hn vector in flight keeps the pass in its registers
        constexpr int kHBatch = kCounts && kSlots > 1 ? 1 : 2;
        stage_vec<float, kCounts, kHBatch>(sHb, LC, Kp, CM, Hn + c0, n, K, nv,
                                           kCounts ? C + (size_t)n + c0 : nullptr);
      } else {
        stage_bf16(sHb, LC, Kp, CM, [&](int k, int t) {
          float h = 0.f;
          if (k < K && t < nv) {
            h = Hn[(size_t)k * n + c0 + t];
            if constexpr (kCounts) h *= C[(size_t)n + c0 + t];
          }
          return h;
        });
      }
      if (xvec) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          xs[s].store(sXb, LC);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < CM; kk += 16) {
#pragma unroll
        for (int i = 0; i < kMmaFrags; ++i) {
          const int f = f0 + warp + i * kWarps;
          if (f < n_frag) {  // warp-uniform
            const int r = f / gcols, c = f - r * gcols;
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> b;
            wmma::load_matrix_sync(a, sHb + r * 16 * LC + kk, LC);
            wmma::load_matrix_sync(b, sXb + c * 16 * LC + kk, LC);
            wmma::mma_sync(fr[i], a, b, fr[i]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the staged chunks
#pragma unroll
    for (int i = 0; i < kMmaFrags; ++i) {
      const int f = f0 + warp + i * kWarps;
      if (f < n_frag) {
        const int r = f / gcols, c = f - r * gcols;
        wmma::store_matrix_sync(sOut + r * 16 * LO + c * 16, fr[i], LO,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();
    // this pass's rows k_lo .. k_hi - 1 to the partial
    const int k_lo = f0 / gcols * 16;
    const int k_hi = min(K, (f0 + kWarps * kMmaFrags) / gcols * 16);
    for (int o = tid; o < (k_hi - k_lo) * GB; o += kThreads) {
      const int k = k_lo + o / GB, gg = o - (k - k_lo) * GB;
      if (g0 + gg < g) part_hxt[((size_t)split * K + k) * g + g0 + gg] = sOut[k * LO + gg];
    }
  }
}

// The bf16 path: iter_tiles (its own phase 1), hxt_partial over
// _cell_splits' grid of GB-gene blocks, reduce_partials.  The fp32 path:
// wtx_fma into the scratch WtX (wtx_T, wtx_LK, wtx_GC, wtx_S: its grid),
// iter_tiles, hxt_fma on Hn (Hs in counts mode) over hxt_fma_grid's grid
// (GB, n_split, cells_per_split, S, CW), reduce_partials.
template <typename XT, bool kBf16, bool kCounts>
static int launch(const void* X, const float* W, const float* H,
                  const float* WtW, const void* Y, const float* Bg,
                  const float* lam_rows, const float* C, int g, int n, int K,
                  int L, int Kg, int loss_kl, float eps, int T, int n_part,
                  int tiles_per_block, int GB, int n_split,
                  int cells_per_split, int S, int CW, int wtx_T, int wtx_LK,
                  int wtx_GC, int wtx_S, float* Hn, float* XHt, float* stats,
                  float* part, float* part_hxt, float* WtX, float* Hs,
                  cudaStream_t stream) {
  const int n_tiles = (n + T - 1) / T;
  // ops/kernels.py:_stats_len: HHt, rowsum, Bnum, pred rows, loss dot, HHtU
  const int S_len = K * K + K + L * K + L + 1 + (kCounts ? K * K : 0);
  const size_t smem_a = iter_smem_floats(K, T, L, Kg, kCounts, kBf16) * sizeof(float);
  if (smem_a > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (kBf16) {
    // 16-wide fragments, and at most 64 cells (genes) for the X staging's slots
    const size_t smem_b = hxt_mma_smem_bytes(K, GB);
    if (T % 16 != 0 || GB % 16 != 0 || T > 64 || GB > 64 || smem_b > (size_t)kMaxSmem)
      return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(hxt_partial<XT, kCounts>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
    if (err != cudaSuccess) return (int)err;
  } else {
    if (WtX == nullptr || (kCounts && Hs == nullptr)) return (int)cudaErrorInvalidValue;
    const int rc =
        launch_wtx_fma<XT>(X, W, g, n, K, wtx_T, wtx_LK, wtx_GC, wtx_S, WtX, stream);
    if (rc != 0) return rc;
  }
  err = cudaFuncSetAttribute(iter_tiles<XT, kBf16, kCounts>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  iter_tiles<XT, kBf16, kCounts><<<n_part, kThreads, smem_a, stream>>>(
      static_cast<const XT*>(X), W, H, WtW, static_cast<const XT*>(Y), Bg,
      lam_rows, C, WtX, g, n, K, L, Kg, loss_kl, eps, T, tiles_per_block, n_tiles,
      S_len, Hn, Hs, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (kBf16) {
    dim3 grid_b((g + GB - 1) / GB, n_split);
    hxt_partial<XT, kCounts><<<grid_b, kThreads, hxt_mma_smem_bytes(K, GB), stream>>>(
        static_cast<const XT*>(X), Hn, C, g, n, K, GB, cells_per_split, part_hxt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  } else {
    const int rc = launch_hxt_fma<XT>(X, kCounts ? Hs : Hn, g, n, K, GB, n_split,
                                      cells_per_split, S, CW, part_hxt, stream);
    if (rc != 0) return rc;
  }
  const size_t total = (size_t)S_len + (size_t)g * K;
  reduce_partials<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, n_part, S_len, stats, part_hxt, n_split, K, g, XHt);
  return (int)cudaGetLastError();
}

}  // namespace alpine

// Plain C entry point (ctypes).  Returns 0 or a cudaError_t code.  GB,
// n_split and cells_per_split are the X Hnᵀ pass's grid on both paths;
// stages, chunk, the wtx_* grid and the scratch buffers wtx (K x n) and hs
// (K x n, counts mode) serve the fp32 path (float32, int16 X) only.
extern "C" int alpine_fused_iteration(
    const void* X, int xtype, const float* W, const float* H, const float* WtW,
    const void* Y, const float* Bg, const float* lam_rows, const float* counts,
    int g, int n, int K, int L, int Kg, int loss_kl, float eps, int T, int n_part,
    int tiles_per_block, int GB, int n_split, int cells_per_split, int stages,
    int chunk, int wtx_T, int wtx_LK, int wtx_GC, int wtx_stages, float* Hn,
    float* XHt, float* stats, float* part, float* part_hxt, float* wtx, float* hs,
    void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ALPINE_ITER_ARGS                                                       \
  X, W, H, WtW, Y, Bg, lam_rows, counts, g, n, K, L, Kg, loss_kl, eps, T,     \
      n_part, tiles_per_block, GB, n_split, cells_per_split, stages, chunk,   \
      wtx_T, wtx_LK, wtx_GC, wtx_stages, Hn, XHt, stats, part, part_hxt, wtx, \
      hs, s
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

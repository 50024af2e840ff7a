// Design variants of the fp32 X passes above K = 512 (csrc/fma_wide.cuh),
// for scripts/torch_fma_wide_variants.py, which builds this file beside
// the package's kernels and calls fw_variant.
//
// Each variant is a point of the kernels' design space, written out here
// so that the kernels stay at the chosen point (a ring of kFwStages = 2
// stages of 16 reduction values, 8 x 8 outputs a thread, one barrier a
// chunk, outputs stored a value at a time; P1 copying and turning cells in
// lane pairs of a row):
//   P2 (wtx, out = Wᵀ X summed over genes):
//     0 the kernel (launch_wtx_fma_wide);
//     1 a ring of 3 stages; 2 a ring of 4;
//     3 8 x 4 outputs a thread: tiles of 128 rows of K x 64 cells (float32
//       X only);
//     4 int16 widened on load: raw int16 rows in the ring, each thread
//       widening its 2 x 4 values of B every reduction step, no widened
//       tile (int16 X with rows on 16-byte boundaries only);
//     5 16-byte stores of the outputs;
//   P1 (hxt, part = H Xᵀ summed over a split's cells):
//     0 the kernel (launch_hxt_fma_wide);
//     1 a ring of 3 stages; 2 a ring of 4 (int16 X only: float32 X's ring
//       of 4 leaves room for one block an SM);
//     3 8 x 4 outputs a thread over tiles of 128 rows of K x 64 genes, a
//       lane copying and turning 8 consecutive cells of a row (float32 X
//       only);
//     4 staged rows not padded (16 floats: a turn's reads of 4 rows by 2
//       lanes touch 4 bank groups twice);
//     5 a lane a row: each lane copies and turns 8 consecutive cells of one
//       row (a copy instruction asks for each 32-byte sector twice);
//     6 16-byte stores of the outputs;
//   and the kernel's own launch at other split counts (the script passes
//   them).  Every variant keeps each output one thread's fmaf chain over
//   its terms in order, so at the same splits it gives the kernel's bits.
#include "fma_wide.cuh"

namespace alpine {
namespace variants {

// A chunk of kGemmBK reduction values into thread (ty, tx)'s 8 x kTN
// outputs: rows 4 ty + i and 64 + 4 ty + i of the [j][row] tile (pitch
// 128), cells 4 tx + u (and 64 + 4 tx + u when kTN = 8) of the [j][cell]
// tile (pitch kTN * 16).  kTN = 8 is gemm_chunk.
template <int kTN, int kPA = kGemmBM, int kPB = kTN * 16>
__device__ __forceinline__ void chunk_tn(float (&acc)[8][kTN], const float* sa,
                                         const float* sb) {
#pragma unroll
  for (int jj = 0; jj < kGemmBK; ++jj) {
    float a[8], b[kTN];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(sa + jj * kPA + 64 * h);
      a[4 * h] = v.x, a[4 * h + 1] = v.y, a[4 * h + 2] = v.z, a[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < kTN / 4; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(sb + jj * kPB + 64 * h);
      b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z, b[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int u = 0; u < kTN; ++u) acc[i][u] = fmaf(a[i], b[u], acc[i][u]);
  }
}

// The same chunk with B as raw int16 rows (pitch 128 values), widened on
// load (the 8 x 8 tile).
__device__ __forceinline__ void chunk_i16(float (&acc)[8][8], const float* sa,
                                          const int16_t* sb) {
#pragma unroll
  for (int jj = 0; jj < kGemmBK; ++jj) {
    float a[8], b[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(sa + jj * kGemmBM + 64 * h);
      a[4 * h] = v.x, a[4 * h + 1] = v.y, a[4 * h + 2] = v.z, a[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = widen_i16x4(*reinterpret_cast<const uint2*>(sb + jj * kGemmBN + 64 * h));
      b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z, b[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[i][u] = fmaf(a[i], b[u], acc[i][u]);
  }
}

// rows j0 .. j0 + kGemmBK - 1, columns x0 .. x0 + kW - 1 of the rows x cols
// matrix M into dst ([kGemmBK][kW]); zeros past rows and cols; 16-byte
// copies (kVec) or 4-byte ones
template <bool kVec, int kW>
__device__ __forceinline__ void copy_tile(float* dst, const float* __restrict__ M, int rows,
                                          int cols, int j0, int x0, int tid) {
  constexpr int kE = kVec ? 4 : 1, kRowCopies = kW / kE;
#pragma unroll
  for (int i = 0; i < kGemmBK * kRowCopies / kThreads; ++i) {
    const int o = tid + i * kThreads, r = o / kRowCopies, c = o % kRowCopies * kE;
    const bool full = j0 + r < rows && x0 + c < cols;
    const float* src = full ? M + (size_t)(j0 + r) * cols + x0 + c : M;
    if constexpr (kVec) {
      cp_async16(dst + r * kW + c, src, full);
    } else {
      cp_async4(dst + r * kW + c, src, full);
    }
  }
}

// Thread (ty, tx)'s 8 x kTN outputs into out (rows x cols, pitch cols) at
// (r0, c0): a value at a time (the kernels' stores), or 16 bytes at a time
// where the rows lie on 16-byte boundaries (kVecStore).
template <int kTN, bool kVecStore>
__device__ __forceinline__ void store_tile(const float (&acc)[8][kTN], float* out, int rows,
                                          int cols, int r0, int c0, int ty, int tx) {
  const bool ovec = kVecStore && cols % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= rows) continue;
#pragma unroll
    for (int h = 0; h < kTN / 4; ++h) {
      const int c = c0 + 64 * h + 4 * tx;
      float* o = out + (size_t)r * cols + c;
      if (ovec && c + 4 <= cols) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < cols) o[u] = acc[i][4 * h + u];
      }
    }
  }
}

// P2: kS stages, tiles of 128 rows x 16 kTN cells, one barrier a chunk.
// kMode 0: float32 X (wtw_gemm's loop); 1: int16 X widened once a stage by
// the thread that copied it into one of two fp32 tiles (the kernel's
// loop; kTN 8); 2: aligned int16 X widened on load (kTN 8).
template <typename XT, bool kVec, int kS, int kTN, int kMode, bool kVecStore>
__global__ void __launch_bounds__(kThreads, 2)
var_wtx(const XT* __restrict__ X, const float* __restrict__ W, int g, int n, int K,
        float* __restrict__ out) {
  constexpr int kBN = kTN * 16;
  constexpr int kXFloats = kMode == 0 ? kGemmBK * kBN
                           : kMode == 1 ? kGemmBK * kFwWtxWords : kGemmBK * kBN / 2;
  constexpr int kStage = kGemmBK * kGemmBM + kXFloats;
  extern __shared__ __align__(16) float ring[];
  float* wide = ring + kS * kStage;  // kMode 1: two widened tiles
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int KT = (K + kGemmBM - 1) / kGemmBM;
  const int k0 = blockIdx.x % KT * kGemmBM, c0 = blockIdx.x / KT * kBN;
  const int n_chunks = (g + kGemmBK - 1) / kGemmBK;
  const int xr = tid / 16, xc = tid % 16 * 8;
  const int16_t* X16 = reinterpret_cast<const int16_t*>(X);
  auto issue = [&](int q) {
    if (q < n_chunks) {
      float* sw = ring + (q % kS) * kStage;
      float* sx = sw + kGemmBK * kGemmBM;
      const int j0 = q * kGemmBK;
      copy_tile<kVec, kGemmBM>(sw, W, g, K, j0, k0, tid);
      if constexpr (kMode == 2) {  // 16 rows of 16 copies of 8 int16 cells
        const bool full = j0 + xr < g && c0 + xc < n;
        cp_async16(sx + xr * kGemmBN / 2 + xc / 2,
                   full ? X + (size_t)(j0 + xr) * n + c0 + xc : X, full);
      } else if constexpr (kMode == 1 && kVec) {
        const bool full = j0 + xr < g && c0 + xc < n;
        cp_async16(sx + xr * kFwWtxWords + xc / 8 * 4,
                   full ? X + (size_t)(j0 + xr) * n + c0 + xc : X, full);
      } else if constexpr (kMode == 1) {
        copy_int16_words<8>(sx + xr * kFwWtxWords + xc / 8 * 5, X16,
                            (size_t)min(j0 + xr, g - 1) * n + c0 + xc, j0 + xr < g, c0 + xc, n);
      } else {
        copy_tile<kVec, kBN>(sx, reinterpret_cast<const float*>(X), g, n, j0, c0, tid);
      }
    }
    cp_async_commit();
  };
  float acc[8][kTN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < kTN; ++u) acc[i][u] = 0.f;
#pragma unroll
  for (int q = 0; q < kS - 1; ++q) issue(q);
  for (int t = 0; t < n_chunks; ++t) {
    cp_async_wait(kS - 2);
    const float* sw = ring + (t % kS) * kStage;
    const float* sx = sw + kGemmBK * kGemmBM;
    if constexpr (kMode == 1) {
      const int j = t * kGemmBK + xr;
      float v[8];
      widen_int16<8, kVec>(v, sx + xr * kFwWtxWords + xc / 8 * (kVec ? 4 : 5), X16,
                           (size_t)min(j, g - 1) * n + c0 + xc, j < g, c0 + xc, n);
      float* wt = wide + (t % 2) * kGemmBK * kGemmBN + xr * kGemmBN + xc;
      *reinterpret_cast<float4*>(wt) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(wt + 4) = make_float4(v[4], v[5], v[6], v[7]);
      sx = wide + (t % 2) * kGemmBK * kGemmBN;
    }
    __syncthreads();
    issue(t + kS - 1);
    if constexpr (kMode == 2) {
      if constexpr (kTN == 8)
        chunk_i16(acc, sw + 4 * ty, reinterpret_cast<const int16_t*>(sx) + 4 * tx);
    } else {
      chunk_tn<kTN>(acc, sw + 4 * ty, sx + 4 * tx);
    }
  }
  store_tile<kTN, kVecStore>(acc, out, K, n, k0, c0, ty, tx);
}

// P1, a lane a row: kS stages, rows padded to kRowsRow floats, tiles of 128
// rows of K x 16 kTN genes, two sets of turned tiles, one barrier a chunk.
// Thread (r, c) = (tid mod 128, 8 (tid / 128)) copies and turns cells c ..
// c + 7 of row r of H's tile; of X's 8 (kTN 8) or, rows tid mod 64, 4
// (kTN 4).
constexpr int kRowsRow = kGemmBK + 4;  // 80 bytes: 8 consecutive rows, 8 bank groups

template <typename XT, bool kVec, int kS, int kTN>
__global__ void __launch_bounds__(kThreads, 2)
var_hxt_rows(const XT* __restrict__ X, const float* __restrict__ H, int g, int n, int K,
             int cells_per_split, float* __restrict__ part) {
  constexpr bool kI16 = sizeof(XT) == 2;
  constexpr int kBN = kTN * 16;
  constexpr int kXRow = kI16 ? kFwHxtWords : kRowsRow;
  constexpr int kStage = kGemmBM * kRowsRow + kBN * kXRow;
  constexpr int kTurned = kGemmBK * (kGemmBM + kBN);
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int KT = (K + kGemmBM - 1) / kGemmBM, GT = (g + kBN - 1) / kBN;
  const int k0 = blockIdx.x % KT * kGemmBM, g0 = blockIdx.x / KT % GT * kBN;
  const int split = blockIdx.x / (KT * GT), cbeg = split * cells_per_split;
  const int n_chunks = (min(n, cbeg + cells_per_split) - cbeg + kGemmBK - 1) / kGemmBK;
  const int tr = tid % kGemmBM, tc = tid / kGemmBM * 8;
  constexpr int kXC = kTN;  // X cells a thread
  const int xr = tid % kBN, xc = tid / kBN * kXC;
  const bool h_ok = k0 + tr < K, x_ok = g0 + xr < g;
  const float* hrow = H + (size_t)(h_ok ? k0 + tr : 0) * n;
  const XT* xrow = X + (size_t)(x_ok ? g0 + xr : 0) * n;
  const int16_t* X16 = reinterpret_cast<const int16_t*>(X);
  const size_t xe = (size_t)(x_ok ? g0 + xr : 0) * n;
  auto issue = [&](int q) {
    if (q < n_chunks) {
      float* sh = ring + (q % kS) * kStage;
      float* sx = sh + kGemmBM * kRowsRow;
      const int c = cbeg + q * kGemmBK;
#pragma unroll
      for (int u = 0; u < 8; u += kVec ? 4 : 1) {
        const bool full = h_ok && c + tc + u < n;
        if constexpr (kVec) {
          cp_async16(sh + tr * kRowsRow + tc + u, full ? hrow + c + tc + u : H, full);
        } else {
          cp_async4(sh + tr * kRowsRow + tc + u, full ? hrow + c + tc + u : H, full);
        }
      }
      if constexpr (kI16 && kVec) {  // 8 cells: 16 bytes
        const bool full = x_ok && c + xc < n;
        cp_async16(sx + xr * kXRow + xc / 2, full ? xrow + c + xc : X, full);
      } else if constexpr (kI16) {
        copy_int16_words<8>(sx + xr * kXRow + xc / 8 * 5, X16, xe + c + xc, x_ok, c + xc, n);
      } else {
#pragma unroll
        for (int u = 0; u < kXC; u += kVec ? 4 : 1) {
          const bool full = x_ok && c + xc + u < n;
          if constexpr (kVec) {
            cp_async16(sx + xr * kXRow + xc + u, full ? xrow + c + xc + u : X, full);
          } else {
            cp_async4(sx + xr * kXRow + xc + u, full ? xrow + c + xc + u : X, full);
          }
        }
      }
    }
    cp_async_commit();
  };
  float acc[8][kTN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < kTN; ++u) acc[i][u] = 0.f;
#pragma unroll
  for (int q = 0; q < kS - 1; ++q) issue(q);
  float* turned = ring + kS * kStage;
  for (int t = 0; t < n_chunks; ++t) {
    cp_async_wait(kS - 2);
    float* th = turned + (t % 2) * kTurned;
    float* tg = th + kGemmBK * kGemmBM;
    const float* sh = ring + (t % kS) * kStage;
    const float* sx = sh + kGemmBM * kRowsRow;
    float v[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = *reinterpret_cast<const float4*>(sh + tr * kRowsRow + tc + 4 * h);
      v[4 * h] = a.x, v[4 * h + 1] = a.y, v[4 * h + 2] = a.z, v[4 * h + 3] = a.w;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) th[(tc + u) * kGemmBM + tr] = v[u];
    if constexpr (kI16) {
      const int c = cbeg + t * kGemmBK + xc;
      widen_int16<8, kVec>(v, sx + xr * kXRow + xc / 8 * (kVec ? 4 : 5), X16, xe + c, x_ok, c,
                           n);
    } else {
#pragma unroll
      for (int h = 0; h < kXC / 4; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(sx + xr * kXRow + xc + 4 * h);
        v[4 * h] = a.x, v[4 * h + 1] = a.y, v[4 * h + 2] = a.z, v[4 * h + 3] = a.w;
      }
    }
#pragma unroll
    for (int u = 0; u < kXC; ++u) tg[(xc + u) * kBN + xr] = v[u];
    __syncthreads();
    issue(t + kS - 1);
    chunk_tn<kTN>(acc, th + 4 * ty, tg + 4 * tx);
  }
  store_tile<kTN, false>(acc, part + (size_t)split * K * g, K, g, k0, g0, ty, tx);
}

// P1 in lane pairs (the kernel's mapping): thread (r, p) = (tid / 2, tid
// mod 2) copies and turns cells 4 p .. and 8 + 4 p .. of row r of each
// operand; kS stages, staged rows of kRow floats, turned tiles of pitch
// kFwTurn, one barrier a chunk.
template <typename XT, bool kVec, int kS, int kRow, bool kVecStore>
__global__ void __launch_bounds__(kThreads, 2)
var_hxt_pairs(const XT* __restrict__ X, const float* __restrict__ H, int g, int n, int K,
              int cells_per_split, float* __restrict__ part) {
  constexpr bool kI16 = sizeof(XT) == 2;
  constexpr int kXRow = kI16 ? kFwHxtWords : kRow;
  constexpr int kStage = kGemmBM * kRow + kGemmBN * kXRow;
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int KT = (K + kGemmBM - 1) / kGemmBM, GT = (g + kGemmBN - 1) / kGemmBN;
  const int k0 = blockIdx.x % KT * kGemmBM, g0 = blockIdx.x / KT % GT * kGemmBN;
  const int split = blockIdx.x / (KT * GT), cbeg = split * cells_per_split;
  const int n_chunks = (min(n, cbeg + cells_per_split) - cbeg + kGemmBK - 1) / kGemmBK;
  const int tr = tid / 2, tp = tid % 2;
  const bool h_ok = k0 + tr < K, x_ok = g0 + tr < g;
  const float* hrow = H + (size_t)(h_ok ? k0 + tr : 0) * n;
  const XT* xrow = X + (size_t)(x_ok ? g0 + tr : 0) * n;
  const int16_t* X16 = reinterpret_cast<const int16_t*>(X);
  const size_t xe = (size_t)(x_ok ? g0 + tr : 0) * n;
  auto issue = [&](int q) {
    if (q < n_chunks) {
      float* sh = ring + (q % kS) * kStage + tr * kRow;
      float* sx = ring + (q % kS) * kStage + kGemmBM * kRow + tr * kXRow;
      const int c0 = cbeg + q * kGemmBK;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 8 * h + 4 * tp, c = c0 + o;
        if constexpr (kVec) {
          cp_async16(sh + o, h_ok && c < n ? hrow + c : H, h_ok && c < n);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            cp_async4(sh + o + u, h_ok && c + u < n ? hrow + c + u : H, h_ok && c + u < n);
        }
        if constexpr (kI16 && kVec) {
          cp_async8(sx + o / 2, x_ok && c < n ? xrow + c : X, x_ok && c < n);
        } else if constexpr (kI16) {
          copy_int16_words<4>(sx + 6 * tp + 3 * h, X16, xe + c, x_ok, c, n);
        } else if constexpr (kVec) {
          cp_async16(sx + o, x_ok && c < n ? xrow + c : X, x_ok && c < n);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            cp_async4(sx + o + u, x_ok && c + u < n ? xrow + c + u : X, x_ok && c + u < n);
        }
      }
    }
    cp_async_commit();
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.f;
#pragma unroll
  for (int q = 0; q < kS - 1; ++q) issue(q);
  for (int t = 0; t < n_chunks; ++t) {
    cp_async_wait(kS - 2);
    const float* sh = ring + (t % kS) * kStage + tr * kRow;
    const float* sx = ring + (t % kS) * kStage + kGemmBM * kRow + tr * kXRow;
    float* th = ring + kS * kStage + (t % 2) * kFwHxtTurned;
    float* tg = th + kGemmBK * kFwTurn;
    const int c0 = cbeg + t * kGemmBK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = 8 * h + 4 * tp;
      const float4 a = *reinterpret_cast<const float4*>(sh + o);
      th[(o + 0) * kFwTurn + tr] = a.x;
      th[(o + 1) * kFwTurn + tr] = a.y;
      th[(o + 2) * kFwTurn + tr] = a.z;
      th[(o + 3) * kFwTurn + tr] = a.w;
      float v[4];
      if constexpr (kI16) {
        widen_int16<4, kVec>(v, sx + (kVec ? o / 2 : 6 * tp + 3 * h), X16, xe + c0 + o, x_ok,
                             c0 + o, n);
      } else {
        const float4 b = *reinterpret_cast<const float4*>(sx + o);
        v[0] = b.x, v[1] = b.y, v[2] = b.z, v[3] = b.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) tg[(o + u) * kFwTurn + tr] = v[u];
    }
    __syncthreads();
    issue(t + kS - 1);
    chunk_tn<8, kFwTurn, kFwTurn>(acc, th + 4 * ty, tg + 4 * tx);
  }
  store_tile<8, kVecStore>(acc, part + (size_t)split * K * g, K, g, k0, g0, ty, tx);
}

__global__ void __launch_bounds__(kThreads)
var_reduce(const float* __restrict__ part, int n_split, size_t KG, float* __restrict__ out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= KG) return;
  float s = 0.f;
  for (int sp = 0; sp < n_split; ++sp) s += part[(size_t)sp * KG + idx];
  out[idx] = s;
}

// The max-dynamic-shared-memory attribute of kernel for smem bytes, or an
// error where smem or the grid is past what a launch takes.
template <typename Kern>
static int allow(Kern kernel, size_t smem, long long blocks) {
  if (smem > (size_t)kMaxSmem || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename XT, bool kVec, int kS, int kTN, int kMode, bool kVecStore>
static int launch_var_wtx(const XT* X, const float* W, int g, int n, int K, float* out,
                          cudaStream_t s) {
  constexpr int kBN = kTN * 16;
  constexpr int kX = kMode == 0 ? kGemmBK * kBN
                     : kMode == 1 ? kGemmBK * kFwWtxWords : kGemmBK * kBN / 2;
  const size_t smem = sizeof(float) * ((size_t)kS * (kGemmBK * kGemmBM + kX) +
                                       (kMode == 1 ? 2 * kGemmBK * kGemmBN : 0));
  const long long blocks = (long long)((K + kGemmBM - 1) / kGemmBM) * ((n + kBN - 1) / kBN);
  auto kern = var_wtx<XT, kVec, kS, kTN, kMode, kVecStore>;
  const int rc = allow(kern, smem, blocks);
  if (rc != 0) return rc;
  kern<<<(unsigned)blocks, kThreads, smem, s>>>(X, W, g, n, K, out);
  return (int)cudaGetLastError();
}

template <typename XT, int kS, int kTN, int kMode, bool kVecStore>
static int launch_var_wtx(bool vec, const XT* X, const float* W, int g, int n, int K,
                          float* out, cudaStream_t s) {
  return vec ? launch_var_wtx<XT, true, kS, kTN, kMode, kVecStore>(X, W, g, n, K, out, s)
             : launch_var_wtx<XT, false, kS, kTN, kMode, kVecStore>(X, W, g, n, K, out, s);
}

template <typename XT>
static int run_wtx(int v, const void* Xv, const float* W, int g, int n, int K, float* out,
                   cudaStream_t s) {
  const XT* X = static_cast<const XT*>(Xv);
  const bool vec = rows_aligned16(X, n) && rows_aligned16(W, K);
  constexpr bool kF = sizeof(XT) == 4;
  constexpr int kMode = kF ? 0 : 1;
  switch (v) {
    case 0: return launch_wtx_fma_wide<XT>(Xv, W, g, n, K, out, s);
    case 1: return launch_var_wtx<XT, 3, 8, kMode, false>(vec, X, W, g, n, K, out, s);
    case 2: return launch_var_wtx<XT, 4, 8, kMode, false>(vec, X, W, g, n, K, out, s);
    case 3:
      if constexpr (kF) return launch_var_wtx<XT, kFwStages, 4, 0, false>(vec, X, W, g, n, K,
                                                                          out, s);
      return (int)cudaErrorInvalidValue;
    case 4:
      if constexpr (!kF) {
        if (vec) return launch_var_wtx<XT, true, kFwStages, 8, 2, false>(X, W, g, n, K, out, s);
      }
      return (int)cudaErrorInvalidValue;
    case 5: return launch_var_wtx<XT, kFwStages, 8, kMode, true>(vec, X, W, g, n, K, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename XT, bool kVec, int kS, int kTN>
static int launch_var_rows(const XT* X, const float* H, int g, int n, int K, int n_split,
                           int cps, float* dst, cudaStream_t s) {
  constexpr bool kI16 = sizeof(XT) == 2;
  constexpr int kBN = kTN * 16;
  constexpr int kXRow = kI16 ? kFwHxtWords : kRowsRow;
  const size_t smem = sizeof(float) * ((size_t)kS * (kGemmBM * kRowsRow + kBN * kXRow) +
                                       2 * kGemmBK * (kGemmBM + kBN));
  const long long blocks =
      (long long)((K + kGemmBM - 1) / kGemmBM) * ((g + kBN - 1) / kBN) * n_split;
  auto kern = var_hxt_rows<XT, kVec, kS, kTN>;
  const int rc = allow(kern, smem, blocks);
  if (rc != 0) return rc;
  kern<<<(unsigned)blocks, kThreads, smem, s>>>(X, H, g, n, K, cps, dst);
  return (int)cudaGetLastError();
}

template <typename XT, bool kVec, int kS, int kRow, bool kVecStore>
static int launch_var_pairs(const XT* X, const float* H, int g, int n, int K, int n_split,
                            int cps, float* dst, cudaStream_t s) {
  constexpr bool kI16 = sizeof(XT) == 2;
  const size_t smem =
      sizeof(float) * ((size_t)kS * (kGemmBM * kRow + kGemmBN * (kI16 ? kFwHxtWords : kRow)) +
                       kFwHxtTail);
  const long long blocks =
      (long long)((K + kGemmBM - 1) / kGemmBM) * ((g + kGemmBN - 1) / kGemmBN) * n_split;
  auto kern = var_hxt_pairs<XT, kVec, kS, kRow, kVecStore>;
  const int rc = allow(kern, smem, blocks);
  if (rc != 0) return rc;
  kern<<<(unsigned)blocks, kThreads, smem, s>>>(X, H, g, n, K, cps, dst);
  return (int)cudaGetLastError();
}

template <typename XT>
static int run_hxt(int v, const void* Xv, const float* H, int g, int n, int K, int n_split,
                   int cps, float* part, float* out, cudaStream_t s) {
  const XT* X = static_cast<const XT*>(Xv);
  const bool vec = rows_aligned16(X, n) && rows_aligned16(H, n);
  constexpr bool kI16 = sizeof(XT) == 2;
  if (cps % kGemmBK != 0 || (long long)(n_split - 1) * cps >= n ||
      (long long)n_split * cps < n)
    return (int)cudaErrorInvalidValue;
  float* dst = n_split > 1 ? part : out;
  int rc = (int)cudaErrorInvalidValue;
#define FW_BOTH(LAUNCH, ...)                                                   \
  rc = vec ? LAUNCH<XT, true, __VA_ARGS__>(X, H, g, n, K, n_split, cps, dst, s) \
           : LAUNCH<XT, false, __VA_ARGS__>(X, H, g, n, K, n_split, cps, dst, s)
  switch (v) {
    case 0: rc = launch_hxt_fma_wide<XT>(Xv, H, g, n, K, n_split, cps, dst, s); break;
    case 1: FW_BOTH(launch_var_pairs, 3, kFwRow, false); break;
    case 2:
      if constexpr (kI16) FW_BOTH(launch_var_pairs, 4, kFwRow, false);
      break;
    case 3:
      if constexpr (!kI16) FW_BOTH(launch_var_rows, kFwStages, 4);
      break;
    case 4: FW_BOTH(launch_var_pairs, kFwStages, kGemmBK, false); break;
    case 5: FW_BOTH(launch_var_rows, kFwStages, 8); break;
    case 6: FW_BOTH(launch_var_pairs, kFwStages, kFwRow, true); break;
    default: break;
  }
#undef FW_BOTH
  if (rc != 0 || n_split == 1) return rc;
  const size_t KG = (size_t)K * g;
  var_reduce<<<(unsigned)((KG + kThreads - 1) / kThreads), kThreads, 0, s>>>(part, n_split,
                                                                            KG, out);
  return (int)cudaGetLastError();
}

}  // namespace variants
}  // namespace alpine

// kind 0: P2 (P = W, g x K; out K x n); kind 1: P1 (P = H, K x n; the
// splits' partials in part, n_split x K x g, added in split order into out,
// K x g).  Returns 0, or a CUDA error code (cudaErrorInvalidValue where the
// variant does not take this X).
extern "C" int fw_variant(int kind, int variant, int xtype, const void* X, const float* P,
                          int g, int n, int K, int n_split, int cells_per_split, float* part,
                          float* out, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return xtype == kF32   ? variants::run_wtx<float>(variant, X, P, g, n, K, out, s)
           : xtype == kI16 ? variants::run_wtx<int16_t>(variant, X, P, g, n, K, out, s)
                           : (int)cudaErrorInvalidValue;
  return xtype == kF32
             ? variants::run_hxt<float>(variant, X, P, g, n, K, n_split, cells_per_split, part,
                                        out, s)
         : xtype == kI16
             ? variants::run_hxt<int16_t>(variant, X, P, g, n, K, n_split, cells_per_split,
                                          part, out, s)
             : (int)cudaErrorInvalidValue;
}

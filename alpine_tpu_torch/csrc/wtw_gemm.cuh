// The fp32 product of a K x K matrix and a K x n one, for any K:
//   D[k][c] = sum over j of A[k][j] B[j][c],
// with one of two epilogues:
//   kGemmStore:  out = D (x_passes.cu: WᵀW H, the large-K H update's
//                denominator);
//   kGemmUpdate: out = B * (num2 / max(D, eps)), one step of the transform
//                (fused_transform.cu's per-step path, K > 512: B is H).
//
// Every output's sum is formed as fused_transform's other paths and
// fused_iteration's per-tile pass form it: d = fmaf(A[k][j], B[j][c], d) over
// j = 0 .. K - 1 in order from 0.f (zeros past K add nothing), IEEE
// division, no fast-math.  So the per-step transform gives the bits of the
// tiled and register paths.  True fp32 (no TF32, no tensor cores, no split
// of j): matmul_precision "highest".
//
// Bound on the H100: operations.  2 K^2 n FMA-flops against (2 K n + K^2) x 4
// bytes (the update reads num2 too): at K = 768 and 100k cells 118 GFLOP,
// 1.76 ms at 67 TFLOP/s, against 0.18 ms of bytes.  So the design feeds the
// FP32 units and keeps every other instruction off their issue slots.
//
// Design: A is transposed once a call into a K x K scratch (wtw_transpose:
// At[j][k] = A[k][j], an exact copy), so that a chunk of j of both operands
// is a set of row copies.  A block of 256 threads owns a 128 x 128 output
// tile; chunks of kGemmBK = 16 values of j of At and of B come into a ring
// of kGemmStages = 4 stages in shared memory by cp.async, straight from
// device memory (L2), with no register staging: 16-byte copies where both
// operands' rows lie on 16-byte boundaries (K and n multiples of 4), else
// 4-byte copies into the same ring (the ragged widths: 17 and 1,001 cells,
// an optimizer fold's cells, K = 513), an instantiation each.  Past K and
// n the copies write zeros.  One wait and one barrier a chunk: the ring
// keeps three chunks in flight while one is multiplied.  Thread (ty, tx)
// of the block's 16 x 16 grid (a warp spans two values of ty) holds the
// 8 x 8 outputs of rows 4 ty + i and 64 + 4 ty + i by cells 4 tx + u and
// 64 + 4 tx + u: every j, two 16-byte loads of At and two of B feed 64
// FMAs.
//
// Block order: the K / 128 row tiles of one cell tile run back to back in
// the grid, so that blocks resident together read the same 128-cell
// columns of B and each column comes from device memory about once a
// product.  Two blocks an SM: one block's epilogue (the update's 16-byte
// reads of B and num2, the store of out) runs under the other's main loop.
//
// On an H100 (700 W, the SM clock at 1,980 MHz) the store takes 2.51
// device ms at K = 768 and 100k cells, 47 TFLOP/s, against 2.76 for the
// design before it and 2.48 for fp32 cuBLAS, which gives the same bits
// (PERF.md).  scripts/torch_wtw_variants.py times this design beside the
// one before it and the other chunks, stages, block orders and thread
// tiles it was chosen from (scripts/wtw_gemm_variants.cu), each checked
// bit for bit first.
#pragma once

#include "common.cuh"

namespace alpine {

// a block's output tile (rows x cells), the ring's chunk of j and stages
constexpr int kGemmBM = 128, kGemmBN = 128, kGemmBK = 16, kGemmStages = 4;
enum GemmEpilogue { kGemmStore = 0, kGemmUpdate = 1 };
// a stage: kGemmBK rows of At's tile, then kGemmBK rows of B's
constexpr int kGemmStage = kGemmBK * (kGemmBM + kGemmBN);
constexpr size_t kGemmSmem = (size_t)kGemmStages * kGemmStage * sizeof(float);
static_assert(kGemmSmem <= (size_t)kMaxSmem, "the ring must fit a block's shared memory");

// cp.async of 4 bytes (or 4 zero bytes when !full): rows off 16-byte
// boundaries
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

// rows j0 .. j0 + kGemmBK - 1, columns x0 .. x0 + 127 of the rows x cols
// matrix M (row pitch cols) into dst ([kGemmBK][128]) by the block's
// threads; zeros past rows and cols.  kVec: 16-byte copies (cols % 4 == 0
// and M on a 16-byte boundary, so x0 + c < cols means the whole vector is
// in), else 4-byte ones.
template <bool kVec>
__device__ __forceinline__ void wtw_copy_tile(float* dst, const float* __restrict__ M, int rows,
                                              int cols, int j0, int x0, int tid) {
  constexpr int kW = kVec ? 4 : 1, kRow = 128 / kW;  // floats a copy, copies a row
#pragma unroll
  for (int i = 0; i < kGemmBK * kRow / kThreads; ++i) {
    const int o = tid + i * kThreads, r = o / kRow, c = o % kRow * kW;
    const bool full = j0 + r < rows && x0 + c < cols;
    const float* src = full ? M + (size_t)(j0 + r) * cols + x0 + c : M;
    if constexpr (kVec) {
      cp_async16(dst + r * 128 + c, src, full);
    } else {
      cp_async4(dst + r * 128 + c, src, full);
    }
  }
}

// One chunk of the ring into thread (ty, tx)'s 8 x 8 outputs: for each of
// its kGemmBK values of j, two 16-byte loads of the [j][row] tile (rows
// 4 ty .. and 64 + 4 ty .., kPA floats a j), two of the [j][cell] tile
// (cells 4 tx .. and 64 + 4 tx .., kPB floats a j) and 64 FMAs; sa and sb
// already offset by 4 ty and 4 tx.  Also the inner loop of fma_wide.cuh's
// kernels.
template <int kPA = kGemmBM, int kPB = kGemmBN>
__device__ __forceinline__ void gemm_chunk(float (&acc)[8][8], const float* sa, const float* sb) {
#pragma unroll
  for (int jj = 0; jj < kGemmBK; ++jj) {
    float a[8], b[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(sa + jj * kPA + 64 * h);
      a[4 * h] = v.x, a[4 * h + 1] = v.y, a[4 * h + 2] = v.z, a[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(sb + jj * kPB + 64 * h);
      b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z, b[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[i][u] = fmaf(a[i], b[u], acc[i][u]);
  }
}

template <int kEpi, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
wtw_gemm(const float* __restrict__ At, const float* __restrict__ B, int K, int n,
         const float* __restrict__ num2, float eps, float* __restrict__ out) {
  extern __shared__ __align__(16) float ring[];  // kGemmStages stages
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // the row tiles of a cell tile in consecutive blocks
  const int KT = (K + kGemmBM - 1) / kGemmBM;
  const int k0 = blockIdx.x % KT * kGemmBM, c0 = blockIdx.x / KT * kGemmBN;
  const int n_chunks = (K + kGemmBK - 1) / kGemmBK;
  // chunk q (j = q kGemmBK .. + kGemmBK - 1) into stage q mod kGemmStages;
  // one group committed, empty past the last chunk
  auto issue = [&](int q) {
    if (q < n_chunks) {
      float* sa = ring + (q % kGemmStages) * kGemmStage;
      wtw_copy_tile<kVec>(sa, At, K, K, q * kGemmBK, k0, tid);
      wtw_copy_tile<kVec>(sa + kGemmBK * kGemmBM, B, K, n, q * kGemmBK, c0, tid);
    }
    cp_async_commit();
  };

  // thread (ty, tx): rows 4 ty + i and 64 + 4 ty + i, cells 4 tx + u and
  // 64 + 4 tx + u
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.f;
#pragma unroll
  for (int q = 0; q < kGemmStages - 1; ++q) issue(q);
  for (int t = 0; t < n_chunks; ++t) {
    cp_async_wait(kGemmStages - 2);  // this thread's copies of chunk t
    // chunk t has landed; every warp is done with chunk t - 1, whose stage
    // the next copies refill
    __syncthreads();
    issue(t + kGemmStages - 1);
    const float* stage = ring + (t % kGemmStages) * kGemmStage;
    gemm_chunk<>(acc, stage + 4 * ty, stage + kGemmBK * kGemmBM + 4 * tx);
  }
  // the epilogue: 16-byte reads of B and num2 and stores of out where the
  // rows lie on 16-byte boundaries
  const bool ovec = kVec && (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                    (kEpi == kGemmStore || (reinterpret_cast<uintptr_t>(num2) & 15) == 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (k >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 64 * h + 4 * tx;
      const size_t o = (size_t)k * n + c;
      float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
      if (ovec && c + 4 <= n) {
        if constexpr (kEpi == kGemmUpdate) {
          const float4 hv = *reinterpret_cast<const float4*>(B + o);
          const float4 nv = *reinterpret_cast<const float4*>(num2 + o);
          v[0] = hv.x * (nv.x / fmaxf(v[0], eps));
          v[1] = hv.y * (nv.y / fmaxf(v[1], eps));
          v[2] = hv.z * (nv.z / fmaxf(v[2], eps));
          v[3] = hv.w * (nv.w / fmaxf(v[3], eps));
        }
        *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (c + u < n) {
            if constexpr (kEpi == kGemmUpdate) v[u] = B[o + u] * (num2[o + u] / fmaxf(v[u], eps));
            out[o + u] = v[u];
          }
        }
      }
    }
  }
}

// At[j][k] = A[k][j] for the K x K matrix A: an exact copy, through 32 x 32
// tiles in shared memory (both sides' accesses coalesced).
__global__ void __launch_bounds__(kThreads)
wtw_transpose(const float* __restrict__ A, int K, float* __restrict__ At) {
  __shared__ float t[32][33];
  const int j0 = blockIdx.x * 32, k0 = blockIdx.y * 32, x = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < 32; r += kThreads / 32)
    if (k0 + r < K && j0 + x < K) t[r][x] = A[(size_t)(k0 + r) * K + j0 + x];
  __syncthreads();
  for (int r = threadIdx.x / 32; r < 32; r += kThreads / 32)
    if (j0 + r < K && k0 + x < K) At[(size_t)(j0 + r) * K + k0 + x] = t[x][r];
}

// A's transpose into the K x K scratch At, once a call (the per-step
// transform's steps share it).
static cudaError_t launch_wtw_transpose(const float* A, int K, float* At, cudaStream_t stream) {
  if (K < 1 || At == nullptr) return cudaErrorInvalidValue;
  const unsigned tiles = (unsigned)((K + 31) / 32);
  wtw_transpose<<<dim3(tiles, tiles), kThreads, 0, stream>>>(A, K, At);
  return cudaGetLastError();
}

// One launch over the (K / 128) x (cells / 128) output tiles, from At (A
// transposed by launch_wtw_transpose): 16-byte copies where both operands'
// rows lie on 16-byte boundaries, else 4-byte copies of both.
template <int kEpi>
static cudaError_t launch_wtw_gemm(const float* At, const float* B, int K, int n,
                                   const float* num2, float eps, float* out,
                                   cudaStream_t stream) {
  if (K < 1 || n < 1) return cudaErrorInvalidValue;
  const long long blocks =
      (long long)((K + kGemmBM - 1) / kGemmBM) * ((n + kGemmBN - 1) / kGemmBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = K % 4 == 0 && n % 4 == 0 && (reinterpret_cast<uintptr_t>(At) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(B) & 15) == 0;
  auto kernel = vec ? wtw_gemm<kEpi, true> : wtw_gemm<kEpi, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, kGemmSmem, stream>>>(At, B, K, n, num2, eps, out);
  return cudaGetLastError();
}

}  // namespace alpine

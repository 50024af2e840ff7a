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
// tiled and register paths.
//
// Design: a block of 256 threads owns a 128 x 128 output tile; chunks of 8
// values of j of A (transposed) and of B pass through two shared-memory
// buffers, the next chunk loaded into registers while the current one is
// multiplied, one barrier a chunk.  Thread (ty, tx) holds the 8 x 8 outputs
// of rows 4 ty + i and 64 + 4 ty + i by cells 4 tx + u and 64 + 4 tx + u:
// every j, two 16-byte loads of A and two of B feed 64 FMAs.  True fp32 (no
// TF32): matmul_precision "highest".
#pragma once

#include "common.cuh"

namespace alpine {

constexpr int kGemmBM = 128, kGemmBN = 128, kGemmBK = 8;
enum GemmEpilogue { kGemmStore = 0, kGemmUpdate = 1 };

template <int kEpi>
__global__ void __launch_bounds__(kThreads, 2)
wtw_gemm(const float* __restrict__ A, const float* __restrict__ B, int K, int n,
         const float* __restrict__ num2, float eps, float* __restrict__ out) {
  __shared__ __align__(16) float As[2][kGemmBK][kGemmBM];
  __shared__ __align__(16) float Bs[2][kGemmBK][kGemmBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * kGemmBN, k0 = blockIdx.y * kGemmBM;
  const bool avec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const bool bvec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0;
  // the thread's loads: A row k0 + ar, columns j0 + ac .. + 3; B row j0 + br,
  // columns c0 + bc .. + 3 (zeros past K and n)
  const int ar = tid / 2, ac = (tid % 2) * 4, br = tid / 32, bc = (tid % 32) * 4;
  float ra[4], rb[4];
  auto load = [&](int j0) {
    const int k = k0 + ar, j = j0 + ac;
    if (avec && k < K && j + 4 <= K) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(A + (size_t)k * K + j));
      ra[0] = v.x, ra[1] = v.y, ra[2] = v.z, ra[3] = v.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) ra[u] = k < K && j + u < K ? A[(size_t)k * K + j + u] : 0.f;
    }
    const int jb = j0 + br, c = c0 + bc;
    if (bvec && jb < K && c + 4 <= n) {
      const float4 v = *reinterpret_cast<const float4*>(B + (size_t)jb * n + c);
      rb[0] = v.x, rb[1] = v.y, rb[2] = v.z, rb[3] = v.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) rb[u] = jb < K && c + u < n ? B[(size_t)jb * n + c + u] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < 4; ++u) As[buf][ac + u][ar] = ra[u];
    *reinterpret_cast<float4*>(&Bs[buf][br][bc]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.f;
  const int n_chunks = (K + kGemmBK - 1) / kGemmBK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < n_chunks; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_chunks) load((t + 1) * kGemmBK);
#pragma unroll
    for (int jj = 0; jj < kGemmBK; ++jj) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][jj][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][jj][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][jj][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][jj][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[i][u] = fmaf(a[i], b[u], acc[i][u]);
    }
    // the other buffer was last read before the previous chunk's barrier
    if (t + 1 < n_chunks) store(cur ^ 1);
    __syncthreads();
  }
  const bool ovec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                    (kEpi == kGemmStore ||
                     ((reinterpret_cast<uintptr_t>(num2) & 15) == 0 && bvec));
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (k >= K) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 64 * h + 4 * tx;
      const size_t o = (size_t)k * n + c;
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = acc[i][4 * h + u];
        if constexpr (kEpi == kGemmUpdate) {
          if (c + u < n) v[u] = B[o + u] * (num2[o + u] / fmaxf(v[u], eps));
        }
      }
      if (ovec && c + 4 <= n) {
        *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < n) out[o + u] = v[u];
      }
    }
  }
}

// One launch over the (cells / 128) x (K / 128) output tiles.
template <int kEpi>
static cudaError_t launch_wtw_gemm(const float* A, const float* B, int K, int n,
                                   const float* num2, float eps, float* out,
                                   cudaStream_t stream) {
  if (K < 1 || n < 1 || (K + kGemmBM - 1) / kGemmBM > 65535) return cudaErrorInvalidValue;
  dim3 grid((n + kGemmBN - 1) / kGemmBN, (K + kGemmBM - 1) / kGemmBM);
  wtw_gemm<kEpi><<<grid, kThreads, 0, stream>>>(A, B, K, n, num2, eps, out);
  return cudaGetLastError();
}

}  // namespace alpine

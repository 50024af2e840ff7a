// The whole out-of-sample projection loop: all n_iter steps of
// H <- H * num2 / max(WtW2 H, eps) on chip, for every cell at once.
//
// Replaces: alpine_tpu/ops/pallas_kernels.py:fused_transform
// (_transform_kernel).  num2 = 2 W^T X and WtW2 = 2 W^T W are loop-invariant
// and computed outside the kernel, as the JAX package leaves them to XLA.
//
// Bound on the H100: operations.  The loop reads num2 and H0 and writes H
// once (12 bytes per cell and component) but does 2 K^2 fp32 operations per
// cell and step: at K = 40 and 50 steps that is about 270 flop per byte.
//
// Why the CUDA cores and not the tensor cores: the transform runs at
// matmul_precision "highest", which is true fp32.  TF32 would drop mantissa
// bits, and a 3xTF32 split would change every bit of the result for a K x K
// operand this small.  So the design aims at the fp32 FMA rate.
//
// Design (transform_columns, K up to the largest bucket): the columns of H
// are independent, so no step needs a block barrier or H in shared memory.
// Two lanes of a warp, l and l ^ 16, own the same two cells and keep both
// cells' K values of H in registers for all n_iter steps.  In a step each of
// the two forms half of the K sums d_k = sum_j WtW2[k][j] h_j for both cells
// (j outer, so the K chains are independent and fill the FMA pipe), updates
// its rows h_k <- h_k * (num2_k / max(d_k, eps)) in place, and the two swap
// their updated halves with one shuffle per row and cell.  K is a template
// parameter (loops fully unrolled, so h and d stay in registers), rounded up
// to a bucket; WtW2 and H are padded with zeros after j = K - 1
// (fmaf(0, 0, d) = d) and the padded rows stay 0, so the sums and the update
// of the real rows are the tiled kernel's arithmetic, bit for bit: d from 0.f
// by fmaf in j order, IEEE division (no fast-math).  num2 sits in shared
// memory, each thread reading its own rows.
//
// WtW2 is uniform across each half-warp: it sits transposed in shared memory,
// and one 16-byte broadcast load feeds eight FMAs (four rows, two cells).
// With one cell a thread it fed four, and on an H100 that kernel ran at the
// rate of those loads, slower than this one (PERF.md).  Constant memory was
// tried first: ptxas (CUDA 12.9, sm_90a) does not fold a constant-bank
// operand into FFMA here but loads each entry into a uniform register with a
// ULDC of its own, and on an H100 that kernel ran slower than the tiled one.
// An empty asm with a "memory" clobber at the top
// of each step keeps ptxas from hoisting the K^2 loop-invariant loads out of
// the step loop, which would need K^2 registers and spill.
//
// Above the largest bucket the accumulators no longer fit in registers and
// transform_tiles (one block per tile of cells, H in shared memory, a barrier
// a step) runs instead: a rule by K (ops/kernels.py:transform_bucket).
#include "common.cuh"

namespace alpine {

// threads of a transform_columns block: four warps, 32 cells each
constexpr int kColThreads = 128;

// Blocks an SM should hold: three up to bucket 40 (at most 170 registers a
// thread), as many as fit above.
constexpr int columns_min_blocks(int KB) { return KB <= 40 ? 3 : 1; }

template <int KB>
__global__ void __launch_bounds__(kColThreads, columns_min_blocks(KB))
transform_columns(const float* __restrict__ num2, const float* __restrict__ H0,
                  const float* __restrict__ WtW2, int K, int n, int n_iter,
                  float eps, float* __restrict__ out) {
  constexpr int HK = KB / 2;    // rows of the sums a thread forms
  extern __shared__ __align__(16) float sm[];
  float* sWt = sm;              // [j][k]: WtW2 transposed, zero-padded to KB
  float* sStart = sWt + KB * KB;  // [k]: where row k's sum starts
  float* sNum = sStart + KB;    // [row][cell][thread]: this thread's rows
  const int tid = threadIdx.x;
  for (int o = tid; o < KB * KB; o += kColThreads) {
    const int j = o / KB, k = o - j * KB;
    sWt[o] = (j < K && k < K) ? WtW2[k * K + j] : 0.f;
  }
  for (int k = tid; k < KB; k += kColThreads) sStart[k] = k < K ? 0.f : 1.f;
  __syncthreads();
  // lanes l and l ^ 16 of a warp own the same two cells, c0 and c1
  const int warp_c = blockIdx.x * kColThreads + (tid & ~31);
  if (warp_c >= n) return;  // whole warps only: the step ends in a shuffle
  const int half = (tid >> 4) & 1;
  const int c0 = warp_c + (tid & 15), c1 = c0 + 16;
  const bool ok0 = c0 < n, ok1 = c1 < n;
  float h0[KB], h1[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    h0[k] = (k < K && ok0) ? H0[(size_t)k * n + c0] : 0.f;
    h1[k] = (k < K && ok1) ? H0[(size_t)k * n + c1] : 0.f;
  }
  // Padded rows (and cells past n) take num2 = 1 and start their sums at
  // 1: their h stays 0 = 0 * (1 / max(1, eps)) without a 0 / eps, which
  // would take the IEEE division's slow path, and without a 0 / 0 at eps = 0.
#pragma unroll
  for (int r = 0; r < HK; ++r) {
    const int k = half * HK + r;
    sNum[2 * r * kColThreads + tid] = (k < K && ok0) ? num2[(size_t)k * n + c0] : 1.f;
    sNum[(2 * r + 1) * kColThreads + tid] = (k < K && ok1) ? num2[(size_t)k * n + c1] : 1.f;
  }
  const float* wrows = sWt + half * HK;
  const float4* start = reinterpret_cast<const float4*>(sStart + half * HK);
  for (int it = 0; it < n_iter; ++it) {
    asm volatile("" ::: "memory");
    float d0[HK], d1[HK];
    if (K == KB) {  // no padded rows: every sum starts at 0, without loads
#pragma unroll
      for (int r = 0; r < HK; ++r) d0[r] = d1[r] = 0.f;
    } else {
#pragma unroll
      for (int q = 0; q < HK / 4; ++q) {
        const float4 v = start[q];
        d0[4 * q] = d1[4 * q] = v.x;
        d0[4 * q + 1] = d1[4 * q + 1] = v.y;
        d0[4 * q + 2] = d1[4 * q + 2] = v.z;
        d0[4 * q + 3] = d1[4 * q + 3] = v.w;
      }
    }
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const float4* col = reinterpret_cast<const float4*>(wrows + j * KB);
#pragma unroll
      for (int q = 0; q < HK / 4; ++q) {
        const float4 w = col[q];
        d0[4 * q] = fmaf(w.x, h0[j], d0[4 * q]);
        d0[4 * q + 1] = fmaf(w.y, h0[j], d0[4 * q + 1]);
        d0[4 * q + 2] = fmaf(w.z, h0[j], d0[4 * q + 2]);
        d0[4 * q + 3] = fmaf(w.w, h0[j], d0[4 * q + 3]);
        d1[4 * q] = fmaf(w.x, h1[j], d1[4 * q]);
        d1[4 * q + 1] = fmaf(w.y, h1[j], d1[4 * q + 1]);
        d1[4 * q + 2] = fmaf(w.z, h1[j], d1[4 * q + 2]);
        d1[4 * q + 3] = fmaf(w.w, h1[j], d1[4 * q + 3]);
      }
    }
    // update this thread's rows, then swap halves with lane ^ 16
#pragma unroll
    for (int r = 0; r < HK; ++r) {
      const float m0 = (half ? h0[HK + r] : h0[r]) *
                       (sNum[2 * r * kColThreads + tid] / fmaxf(d0[r], eps));
      const float m1 = (half ? h1[HK + r] : h1[r]) *
                       (sNum[(2 * r + 1) * kColThreads + tid] / fmaxf(d1[r], eps));
      const float o0 = __shfl_xor_sync(0xffffffffu, m0, 16);
      const float o1 = __shfl_xor_sync(0xffffffffu, m1, 16);
      h0[r] = half ? o0 : m0;
      h0[HK + r] = half ? m0 : o0;
      h1[r] = half ? o1 : m1;
      h1[HK + r] = half ? m1 : o1;
    }
  }
#pragma unroll
  for (int r = 0; r < HK; ++r) {
    const int k = half * HK + r;
    if (k < K) {
      if (ok0) out[(size_t)k * n + c0] = half ? h0[HK + r] : h0[r];
      if (ok1) out[(size_t)k * n + c1] = half ? h1[HK + r] : h1[r];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
transform_tiles(const float* __restrict__ num2, const float* __restrict__ H0,
                const float* __restrict__ WtW2, int K, int n, int T,
                int n_iter, float eps, float* __restrict__ out) {
  extern __shared__ float sm[];
  const int KT = K * T;
  float* sNum = sm;
  float* cur = sNum + KT;
  float* nxt = cur + KT;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * T;
  const int nv = min(T, n - c0);
  for (int o = tid; o < KT; o += kThreads) {
    const int k = o / T, t = o - k * T;
    const bool ok = t < nv;
    sNum[o] = ok ? num2[(size_t)k * n + c0 + t] : 0.f;
    cur[o] = ok ? H0[(size_t)k * n + c0 + t] : 0.f;
  }
  __syncthreads();
  for (int it = 0; it < n_iter; ++it) {
    for (int o = tid; o < KT; o += kThreads) {
      const int k = o / T, t = o - k * T;
      float d = 0.f;
      for (int j = 0; j < K; ++j) d = fmaf(__ldg(&WtW2[k * K + j]), cur[j * T + t], d);
      nxt[o] = cur[o] * (sNum[o] / fmaxf(d, eps));
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int o = tid; o < KT; o += kThreads) {
    const int k = o / T, t = o - k * T;
    if (t < nv) out[(size_t)k * n + c0 + t] = cur[o];
  }
}

template <int KB>
cudaError_t launch_columns(const float* num2, const float* H0,
                           const float* WtW2, int K, int n, int n_iter,
                           float eps, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)(KB * KB + KB + KB * kColThreads) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      transform_columns<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kColThreads - 1) / kColThreads;
  transform_columns<KB><<<blocks, kColThreads, smem, stream>>>(
      num2, H0, WtW2, K, n, n_iter, eps, out);
  return cudaGetLastError();
}

}  // namespace alpine

// Plain C entry point (ctypes).  Returns 0 or a cudaError_t code.  KB is
// the bucket of transform_columns, or 0 for transform_tiles with T cells a
// tile; WtW2 is K x K either way.
extern "C" int alpine_fused_transform(const float* num2, const float* H0,
                                      const float* WtW2, int K, int KB, int n,
                                      int T, int n_iter, float eps, float* out,
                                      void* stream) {
  using namespace alpine;
  if (n <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KB > 0) {
    if (K > KB) return (int)cudaErrorInvalidValue;
    switch (KB) {  // ops/kernels.py:_TRANSFORM_BUCKETS
#define ALPINE_BUCKET(B) \
  case B:                \
    return (int)launch_columns<B>(num2, H0, WtW2, K, n, n_iter, eps, out, s);
      ALPINE_BUCKET(8)
      ALPINE_BUCKET(16)
      ALPINE_BUCKET(24)
      ALPINE_BUCKET(32)
      ALPINE_BUCKET(40)
      ALPINE_BUCKET(48)
      ALPINE_BUCKET(56)
      ALPINE_BUCKET(64)
#undef ALPINE_BUCKET
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  const size_t smem = (size_t)3 * K * T * sizeof(float);
  if (T <= 0 || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      transform_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n + T - 1) / T;
  transform_tiles<<<n_tiles, kThreads, smem, s>>>(num2, H0, WtW2, K, n, T,
                                                  n_iter, eps, out);
  return (int)cudaGetLastError();
}

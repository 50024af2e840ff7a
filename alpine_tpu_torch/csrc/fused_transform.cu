// The whole out-of-sample projection loop: for each cell tile, all n_iter
// steps of H <- H * num2 / max(WtW2 H, eps) on chip.
//
// Replaces: alpine_tpu/ops/pallas_kernels.py:fused_transform
// (_transform_kernel).  num2 = 2 W^T X and WtW2 = 2 W^T W are loop-invariant
// and computed outside the kernel, as the JAX package leaves them to XLA.
//
// Bound on the H100: operations.  The loop reads num2 and H0 and writes H
// once (12 bytes per cell and component) but does 2 K^2 fp32 operations per
// cell and step: at K = 40 and 50 steps that is about 270 flop per byte.
//
// Design: columns are independent, so one block owns a tile of T cells and
// keeps num2, H and the next H in shared memory for every step; WtW2 is read
// through the read-only cache (every thread of a warp reads the same entry).
// fp32 FMA throughout (true fp32, no TF32).  The ragged last tile is masked.
#include "common.cuh"

namespace alpine {

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

}  // namespace alpine

// Plain C entry point (ctypes).  Returns 0 or a cudaError_t code.
extern "C" int alpine_fused_transform(const float* num2, const float* H0,
                                      const float* WtW2, int K, int n, int T,
                                      int n_iter, float eps, float* out,
                                      void* stream) {
  using namespace alpine;
  const size_t smem = (size_t)3 * K * T * sizeof(float);
  if (smem > (size_t)kMaxSmem || n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      transform_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n + T - 1) / T;
  transform_tiles<<<n_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      num2, H0, WtW2, K, n, T, n_iter, eps, out);
  return (int)cudaGetLastError();
}

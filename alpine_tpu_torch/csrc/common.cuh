// Shared definitions of the port's CUDA kernels (sm_90a, plain C interface,
// loaded from Python with ctypes; see alpine_tpu_torch/ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace alpine {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Per-thread register accumulators: a block's output tile holds at most
// kThreads * kMaxOut = 4096 values.  ops/kernels.py:tile_width derives the
// cell/gene tile widths from K under the same bound.  (fused_iteration's
// bf16 path keeps its X products in tensor-core fragments instead, under
// its own rule: ops/kernels.py:iteration_tile_width.)
constexpr int kMaxOut = 16;
// Largest dynamic shared memory a block may request on Hopper.
constexpr int kMaxSmem = 232448;

// X storage codes; ops/kernels.py:_XTYPE holds the same table.
enum XType { kF32 = 0, kBF16 = 1, kI8 = 2, kI16 = 3 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f(int16_t v) { return static_cast<float>(v); }

// The operand multiplied with X is rounded to bf16 when X computes in bf16
// (int8 and bf16 storage), as the JAX kernels cast W and Hn before their X
// dots.  fused_iteration.cu then runs both X products on bf16 tensor cores
// (wmma, fp32 accumulators): int8 widens to bf16 exactly (|x| <= 127), and
// products of two bf16 values are exact in fp32, so the result is the plain
// version's up to summation order.  Float32 and int16 X keep fp32 FMA
// (true fp32, no TF32), where round_op is the identity.
template <bool kBf16>
__device__ __forceinline__ float round_op(float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

}  // namespace alpine

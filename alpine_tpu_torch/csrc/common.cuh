// Shared definitions of the port's CUDA kernels (sm_90a, plain C interface,
// loaded from Python with ctypes; see alpine_tpu_torch/ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace alpine {

constexpr int kThreads = 256;
// Per-thread register accumulators: a block's output tile holds at most
// kThreads * kMaxOut = 4096 values.  ops/kernels.py:tile_width derives the
// cell/gene tile widths from K under the same bound.
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
// dots.  Products of an 8-bit mantissa with an integer <= 127 (or another
// bf16) are exact in fp32, so fp32 FMA gives the tensor-core result up to
// summation order.
template <bool kBf16>
__device__ __forceinline__ float round_op(float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

}  // namespace alpine

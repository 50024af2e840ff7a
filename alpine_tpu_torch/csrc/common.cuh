// Shared definitions of the port's CUDA kernels (sm_90a, plain C interface,
// loaded from Python with ctypes; see alpine_tpu_torch/ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace alpine {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Largest dynamic shared memory a block may request on Hopper.
constexpr int kMaxSmem = 232448;

// X storage codes; ops/kernels.py:_XTYPE holds the same table.
enum XType { kF32 = 0, kBF16 = 1, kI8 = 2, kI16 = 3 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f(int16_t v) { return static_cast<float>(v); }

}  // namespace alpine

// The streaming probe: read every element of X (g x n), widen it to fp32 and
// sum over the genes, giving the n column sums and the TPU probe's (8, 128)
// fold of them.
//
// Replaces: benchmarks/envelope_probe.py:probe_streaming (kernel :118, call
// :129), a pure-streaming Pallas kernel that measures the rate at which X is
// read from device memory and widened.
//
// Bound on the H100: device-memory bytes (X once; 200 MB at 100k cells x
// 2000 genes in int8), with one conversion and one addition an element.
//
// Design: CUDA, not Triton, so that the port keeps one build route (nvcc and
// ctypes) and the load width is explicit.
//  * stream_columns: a grid of (column group) x (gene split).  In a block
//    each lane owns one 16-byte vector of columns (16 int8, 8 bf16 or int16,
//    4 fp32 values), so a warp reads 512 contiguous bytes of a gene row, and
//    the 8 warps take every 8th gene of the split, four rows' loads in flight
//    before their sums.  int8 widens exactly with a byte permute and one
//    fp32 subtraction (the bits 0x4B0000uu are 2^23 + uu, uu = x + 128),
//    bf16 with a shift.  The warps' sums meet in shared memory in warp
//    order; each block writes its split's partial column sums once.  Rows
//    that are not 16-byte aligned are read element by element.
//  * column_sums adds the splits' partials in split order, and fold_tiles
//    adds, for each of the first 128 columns of a tile, that column of every
//    tile (columns past n count as zero), as the TPU kernel's revisited
//    (8, 128) accumulator does.  No float atomics: two launches give the same
//    bits.
#include "common.cuh"

namespace alpine {

// x[0..3] += the four signed bytes of w, each widened exactly to fp32.
__device__ __forceinline__ void add_bytes(unsigned w, float* x) {
  const unsigned u = w ^ 0x80808080u;  // x + 128, in [0, 255]
#pragma unroll
  for (int q = 0; q < 4; ++q)
    x[q] += __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + q)) - 8388736.f;
}

__device__ __forceinline__ void add_vec(uint4 v, const int8_t*, float* x) {
  add_bytes(v.x, x);
  add_bytes(v.y, x + 4);
  add_bytes(v.z, x + 8);
  add_bytes(v.w, x + 12);
}
// x[0..1] += the two bf16 (or int16) values of w, widened to fp32.
__device__ __forceinline__ void add_pair(unsigned w, const __nv_bfloat16*, float* x) {
  x[0] += __uint_as_float(w << 16);
  x[1] += __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ void add_pair(unsigned w, const int16_t*, float* x) {
  x[0] += (float)(int16_t)(w & 0xFFFFu);
  x[1] += (float)(int16_t)(w >> 16);
}
template <typename T>
__device__ __forceinline__ void add_vec(uint4 v, const T* p, float* x) {
  add_pair(v.x, p, x);
  add_pair(v.y, p, x + 2);
  add_pair(v.z, p, x + 4);
  add_pair(v.w, p, x + 6);
}
__device__ __forceinline__ void add_vec(uint4 v, const float*, float* x) {
  x[0] += __uint_as_float(v.x);
  x[1] += __uint_as_float(v.y);
  x[2] += __uint_as_float(v.z);
  x[3] += __uint_as_float(v.w);
}

// part[split][c] = sum over the split's genes of X[gi][c], for the 32 * V
// columns of this block.
template <typename XT, bool kVec>
__global__ void __launch_bounds__(kThreads)
stream_columns(const XT* __restrict__ X, int g, int n, int genes_per_split,
               float* __restrict__ part) {
  constexpr int V = 16 / sizeof(XT), CW = 32 * V;
  __shared__ float red[kWarps * CW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * CW + lane * V;
  const int gbeg = blockIdx.y * genes_per_split;
  const int gend = min(g, gbeg + genes_per_split);
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  if constexpr (kVec) {
    if (c0 < n) {  // n is a multiple of V: the vector is valid as a whole
      const XT* col = X + c0;
      int gi = gbeg + warp;
      for (; gi + 3 * kWarps < gend; gi += 4 * kWarps) {
        uint4 u[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          u[q] = __ldg(reinterpret_cast<const uint4*>(col + (size_t)(gi + q * kWarps) * n));
#pragma unroll
        for (int q = 0; q < 4; ++q) add_vec(u[q], static_cast<const XT*>(nullptr), acc);
      }
      for (; gi < gend; gi += kWarps)
        add_vec(__ldg(reinterpret_cast<const uint4*>(col + (size_t)gi * n)),
                static_cast<const XT*>(nullptr), acc);
    }
  } else {
    for (int gi = gbeg + warp; gi < gend; gi += kWarps) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (c0 + v < n) acc[v] += to_f(X[(size_t)gi * n + c0 + v]);
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) red[warp * CW + lane * V + v] = acc[v];
  __syncthreads();
  for (int c = threadIdx.x; c < CW; c += kThreads) {
    const int col = blockIdx.x * CW + c;
    if (col < n) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * CW + c];
      part[(size_t)blockIdx.y * n + col] = s;
    }
  }
}

// colsum[c] = sum over splits of part[s][c], in split order.
__global__ void __launch_bounds__(kThreads)
column_sums(const float* __restrict__ part, int n_split, int n,
            float* __restrict__ colsum) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  float s = 0.f;
  for (int sp = 0; sp < n_split; ++sp) s += part[(size_t)sp * n + c];
  colsum[c] = s;
}

// fold[r][j] = sum over tiles t of colsum[t * tile + j] (j < 128; columns
// past n count as zero), the same for all 8 rows.
__global__ void __launch_bounds__(128)
fold_tiles(const float* __restrict__ colsum, int n, int tile, float* __restrict__ fold) {
  const int j = threadIdx.x;
  float s = 0.f;
  for (int t0 = 0; t0 < n; t0 += tile)
    if (t0 + j < n) s += colsum[t0 + j];
#pragma unroll
  for (int r = 0; r < 8; ++r) fold[r * 128 + j] = s;
}

template <typename XT>
static int launch_stream(const void* Xv, int g, int n, int n_split, int genes_per_split,
                         int tile, float* part, float* colsum, float* fold,
                         cudaStream_t stream) {
  constexpr int CW = 32 * (16 / sizeof(XT));
  if (g <= 0 || n <= 0 || n_split <= 0 || genes_per_split <= 0 || tile < 128 ||
      (size_t)n_split * genes_per_split < (size_t)g)
    return (int)cudaErrorInvalidValue;
  const XT* X = static_cast<const XT*>(Xv);
  const bool vec = ((size_t)n * sizeof(XT)) % 16 == 0 && (reinterpret_cast<uintptr_t>(X) & 15) == 0;
  dim3 grid((n + CW - 1) / CW, n_split);
  if (vec) {
    stream_columns<XT, true><<<grid, kThreads, 0, stream>>>(X, g, n, genes_per_split, part);
  } else {
    stream_columns<XT, false><<<grid, kThreads, 0, stream>>>(X, g, n, genes_per_split, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  column_sums<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(part, n_split, n, colsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fold_tiles<<<1, 128, 0, stream>>>(colsum, n, tile, fold);
  return (int)cudaGetLastError();
}

}  // namespace alpine

// Plain C entry point (ctypes).  Returns 0 or a cudaError_t code.
extern "C" int alpine_stream_probe(const void* X, int xtype, int g, int n, int n_split,
                                   int genes_per_split, int tile, float* part,
                                   float* colsum, float* fold, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ALPINE_STREAM_ARGS X, g, n, n_split, genes_per_split, tile, part, colsum, fold, s
  switch (xtype) {
    case kF32: return launch_stream<float>(ALPINE_STREAM_ARGS);
    case kBF16: return launch_stream<__nv_bfloat16>(ALPINE_STREAM_ARGS);
    case kI8: return launch_stream<int8_t>(ALPINE_STREAM_ARGS);
    case kI16: return launch_stream<int16_t>(ALPINE_STREAM_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ALPINE_STREAM_ARGS
}

// Design variants of wtw_gemm (alpine_tpu_torch/csrc/wtw_gemm.cuh), built
// and timed by scripts/torch_wtw_variants.py.  Every variant forms each
// output's sum d = fmaf(A[k][j], B[j][c], d) over j in order from 0.f and
// the same epilogue, so every variant gives the parent's bits.
//   parent (variant 0): the design before the ring, kept here as the
//     reference: A read a row at a time and stored transposed into shared
//     memory through registers, B through registers too, chunks of 8 j in
//     two buffers, one barrier a chunk, the cells on x and the row tiles on
//     y of the grid.
//   Variant 2, "ring16x4": the kernel itself (launch_wtw_gemm): A
//   transposed once a call into a K x K scratch, both operands by cp.async
//   into a ring of 4 stages of 16 values of j, 16-byte copies where every
//   row allows them, the row tiles of a cell tile back to back, 256
//   threads of 8 x 8 outputs, two blocks an SM.
//   Variants 1 and 3 .. 10: ring_gemm below, the kernel's loop with its
//   choices as template parameters, a name "ringBKxS" (chunk of BK values
//   of j, S stages), with "t16" 128-thread blocks (two an SM, warps of 4
//   rows of 8 threads) whose threads hold 8 x 16 outputs and "n256"
//   256-thread blocks (one an SM) of 8 x 16 outputs a thread over 128 x
//   256 tiles (else 256 threads of 8 x 8, two an SM, as the kernel's):
//   1, ring16x4 in the parent's block order (the ring alone); 3, ring16x4
//   t16; 4, ring32x3; 5, ring8x4; 6, ring16x2; 7, ring16x4 n256; 8,
//   ring32x3 n256; 9, ring16x4 t12 and 10, ring32x3 t12: 128-thread blocks
//   (three an SM) of 8 x 12 outputs a thread over 128 x 96 tiles.
#include "wtw_gemm.cuh"

namespace alpine {
namespace variants {

constexpr int kPBM = 128, kPBN = 128, kPBK = 8;

template <int kEpi>
__global__ void __launch_bounds__(kThreads, 2)
parent_gemm(const float* __restrict__ A, const float* __restrict__ B, int K, int n,
            const float* __restrict__ num2, float eps, float* __restrict__ out) {
  __shared__ __align__(16) float As[2][kPBK][kPBM];
  __shared__ __align__(16) float Bs[2][kPBK][kPBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c0 = blockIdx.x * kPBN, k0 = blockIdx.y * kPBM;
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
  const int n_chunks = (K + kPBK - 1) / kPBK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < n_chunks; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_chunks) load((t + 1) * kPBK);
#pragma unroll
    for (int jj = 0; jj < kPBK; ++jj) {
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

template <int kEpi>
static cudaError_t launch_parent(const float* A, const float* B, int K, int n,
                                 const float* num2, float eps, float* out, cudaStream_t stream) {
  if (K < 1 || n < 1 || (K + kPBM - 1) / kPBM > 65535) return cudaErrorInvalidValue;
  dim3 grid((n + kPBN - 1) / kPBN, (K + kPBM - 1) / kPBM);
  parent_gemm<kEpi><<<grid, kThreads, 0, stream>>>(A, B, K, n, num2, eps, out);
  return cudaGetLastError();
}

enum RingOrder { kCellsOuter = 0, kRowsInner = 1 };

// rows j0 .. j0 + BK - 1, columns x0 .. x0 + W - 1 of the rows x cols
// matrix M into dst ([BK][W]) by the block's NT threads; zeros past rows
// and cols; 16-byte copies (kVec) or 4-byte ones
template <int BK, int W, bool kVec, int NT>
__device__ __forceinline__ void ring_copy_tile(float* dst, const float* __restrict__ M, int rows,
                                               int cols, int j0, int x0, int tid) {
  constexpr int kW = kVec ? 4 : 1;
  static_assert(BK * W % (4 * NT) == 0, "whole vectors a thread");
#pragma unroll
  for (int i = 0; i < BK * W / (kW * NT); ++i) {
    const int o = tid + i * NT, r = o / (W / kW), c = o % (W / kW) * kW;
    const bool full = j0 + r < rows && x0 + c < cols;
    const float* src = full ? M + (size_t)(j0 + r) * cols + x0 + c : M;
    if constexpr (kVec) {
      cp_async16(dst + r * W + c, src, full);
    } else {
      cp_async4(dst + r * W + c, src, full);
    }
  }
}

// Blocks an SM: two where a thread holds 8 x 8 outputs (256 threads, at
// most 128 registers), three of 128 threads of 8 x 12 (at most 170), two
// of 128 threads of 8 x 16, else one.
__host__ __device__ constexpr int ring_min_blocks(int TN, int TX) {
  return TN == 8 ? 2 : TN == 12 && TX == 8 ? 3 : TX == 8 ? 2 : 1;
}

// A block of 16 x TX threads (a warp spans kWarpRows values of ty by
// 32 / kWarpRows of tx), each holding 8 rows by TN cells, over a tile of
// 128 rows by BN = TX TN cells; chunks of BK values of j in S stages;
// kOrder: the row tiles of a cell tile back to back (kRowsInner) or the
// cells on x and the row tiles on y (kCellsOuter).
template <int kEpi, int BK, int S, int kOrder, bool kVec, int kWarpRows, int TN, int TX>
__global__ void __launch_bounds__(16 * TX, ring_min_blocks(TN, TX))
ring_gemm(const float* __restrict__ At, const float* __restrict__ B, int K, int n,
          const float* __restrict__ num2, float eps, float* __restrict__ out) {
  static_assert(BK % 8 == 0 && S >= 2 && S <= 8, "chunks of 8 j, 2 .. 8 stages");
  static_assert(TN % 4 == 0 && TN <= 16, "4, 8, 12 or 16 cells a thread");
  // threads, cells a tile, cells between a thread's groups of 4
  constexpr int NT = 16 * TX, BN = TX * TN, CS = 4 * TX;
  constexpr int LX = 32 / kWarpRows, WX = TX / LX;  // lanes, warps along tx
  static_assert(WX >= 1 && TX % LX == 0, "a warp's lanes within the grid's row");
  extern __shared__ __align__(16) float ring[];  // S stages: [BK][128] of At, [BK][BN] of B
  constexpr int kStage = BK * (kGemmBM + BN);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = warp / WX * kWarpRows + lane / LX, tx = warp % WX * LX + lane % LX;
  int kt, ct;
  if constexpr (kOrder == kRowsInner) {
    const int KT = (K + kGemmBM - 1) / kGemmBM;
    kt = blockIdx.x % KT;
    ct = blockIdx.x / KT;
  } else {
    ct = blockIdx.x;
    kt = blockIdx.y;
  }
  const int c0 = ct * BN, k0 = kt * kGemmBM;
  const int n_chunks = (K + BK - 1) / BK;
  auto issue = [&](int q) {
    if (q < n_chunks) {
      float* sa = ring + (q % S) * kStage;
      ring_copy_tile<BK, kGemmBM, kVec, NT>(sa, At, K, K, q * BK, k0, tid);
      ring_copy_tile<BK, BN, kVec, NT>(sa + BK * kGemmBM, B, K, n, q * BK, c0, tid);
    }
    cp_async_commit();
  };

  // thread (ty, tx): rows 4 ty + i and 64 + 4 ty + i, cells CS h + 4 tx + u
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < TN; ++u) acc[i][u] = 0.f;
#pragma unroll
  for (int q = 0; q < S - 1; ++q) issue(q);
  for (int t = 0; t < n_chunks; ++t) {
    cp_async_wait(S - 2);
    __syncthreads();
    issue(t + S - 1);
    const float* sa = ring + (t % S) * kStage + 4 * ty;
    const float* sb = ring + (t % S) * kStage + BK * kGemmBM + 4 * tx;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      float a[8], b[TN];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(sa + jj * kGemmBM + 64 * h);
        a[4 * h] = v.x, a[4 * h + 1] = v.y, a[4 * h + 2] = v.z, a[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(sb + jj * BN + CS * h);
        b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z, b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int u = 0; u < TN; ++u) acc[i][u] = fmaf(a[i], b[u], acc[i][u]);
    }
  }
  const bool ovec = kVec && (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                    (kEpi == kGemmStore || (reinterpret_cast<uintptr_t>(num2) & 15) == 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (k >= K) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int c = c0 + CS * h + 4 * tx;
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

template <int kEpi, int BK, int S, int kOrder = kRowsInner, int kWarpRows = 2, int TN = 8,
          int TX = 16>
static cudaError_t launch_ring(const float* At, const float* B, int K, int n, const float* num2,
                               float eps, float* out, cudaStream_t stream) {
  if (K < 1 || n < 1) return cudaErrorInvalidValue;
  constexpr int BN = TX * TN;
  const long long KT = (K + kGemmBM - 1) / kGemmBM, CT = (n + BN - 1) / BN;
  dim3 grid;
  if (kOrder == kRowsInner) {
    if (KT * CT > 0x7fffffffLL) return cudaErrorInvalidValue;
    grid = dim3((unsigned)(KT * CT));
  } else {
    if (KT > 65535) return cudaErrorInvalidValue;
    grid = dim3((unsigned)CT, (unsigned)KT);
  }
  constexpr size_t smem = (size_t)S * BK * (kGemmBM + BN) * sizeof(float);
  static_assert(smem <= (size_t)kMaxSmem, "the ring must fit a block's shared memory");
  const bool vec = K % 4 == 0 && n % 4 == 0 && (reinterpret_cast<uintptr_t>(At) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(B) & 15) == 0;
  auto kernel = vec ? ring_gemm<kEpi, BK, S, kOrder, true, kWarpRows, TN, TX>
                    : ring_gemm<kEpi, BK, S, kOrder, false, kWarpRows, TN, TX>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 16 * TX, smem, stream>>>(At, B, K, n, num2, eps, out);
  return cudaGetLastError();
}

template <int kEpi>
static cudaError_t launch_variant(int v, const float* A, const float* B, int K, int n,
                                  const float* num2, float eps, float* At, float* out,
                                  cudaStream_t s) {
  if (v == 0) return launch_parent<kEpi>(A, B, K, n, num2, eps, out, s);
  const cudaError_t err = launch_wtw_transpose(A, K, At, s);
  if (err != cudaSuccess) return err;
  constexpr int C = kCellsOuter, R = kRowsInner;
  switch (v) {
    case 1: return launch_ring<kEpi, 16, 4, C>(At, B, K, n, num2, eps, out, s);
    case 2: return launch_wtw_gemm<kEpi>(At, B, K, n, num2, eps, out, s);
    case 3: return launch_ring<kEpi, 16, 4, R, 4, 16, 8>(At, B, K, n, num2, eps, out, s);
    case 4: return launch_ring<kEpi, 32, 3>(At, B, K, n, num2, eps, out, s);
    case 5: return launch_ring<kEpi, 8, 4>(At, B, K, n, num2, eps, out, s);
    case 6: return launch_ring<kEpi, 16, 2>(At, B, K, n, num2, eps, out, s);
    case 7: return launch_ring<kEpi, 16, 4, R, 2, 16, 16>(At, B, K, n, num2, eps, out, s);
    case 8: return launch_ring<kEpi, 32, 3, R, 2, 16, 16>(At, B, K, n, num2, eps, out, s);
    case 9: return launch_ring<kEpi, 16, 4, R, 4, 12, 8>(At, B, K, n, num2, eps, out, s);
    case 10: return launch_ring<kEpi, 32, 3, R, 4, 12, 8>(At, B, K, n, num2, eps, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace variants
}  // namespace alpine

// Variant v (0 .. 10) of the store (epi 0: out = A B) or the update (epi 1:
// out = B * (num2 / max(A B, eps))); At a K x K scratch (variants 1 .. 10).
// Returns 0 or a cudaError_t code.
extern "C" int alpine_wtw_variant(int v, int epi, const float* A, const float* B, int K, int n,
                                  const float* num2, float eps, float* At, float* out,
                                  void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(epi == kGemmStore
                   ? variants::launch_variant<kGemmStore>(v, A, B, K, n, nullptr, 0.f, At, out, s)
                   : variants::launch_variant<kGemmUpdate>(v, A, B, K, n, num2, eps, At, out, s));
}

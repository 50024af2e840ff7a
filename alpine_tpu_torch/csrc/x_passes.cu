// The X passes of full-batch ALS mode, one kernel each:
//   hxt: out (K x g) = H Xᵀ, summed over all n cells;
//   wtx: out (K x n) = Wᵀ X, each cell's column summed over all g genes.
//
// Replaces: benchmarks/als_probe.py:_pallas_dots, its hxt_kernel (call :172)
// and wtx_kernel (call :180).  Those are the X products of ALS mode
// (alpine_tpu/ops/mu.py:als_batch_update): one X H_startᵀ an iteration and
// one Wᵢᵀ X a block.
//
// Bound on the H100: device-memory bytes.  At 100k cells x 2000 genes and
// int8 X a pass reads X (200 MB) and, for hxt, H (16 MB at K = 40), or
// writes the k x n outputs of wtx (2-12 MB at k = 5-30).  The products are
// 16 GFLOP or less, far below the bf16 tensor-core roof.
//
// Design (simple first; the joint fit's fused_iteration.cu holds the same
// two products inside K1, whose code is left as it is, so the device helpers
// below are copies of its own):
//  * hxt: a grid of (gene block of GB genes) x (cell split).  A block sums
//    its K x GB outputs over its split's cells and writes one partial;
//    reduce_splits adds the partials in a fixed order (no float atomics), so
//    two launches give the same bits.
//  * wtx: one block per tile of T cells, looping over all genes in chunks;
//    every output is written once, by the block of its cells.
//  * int8 and bf16 X compute in bf16 (kBf16): X and the partner (H or W) are
//    staged in shared memory as bf16 and multiplied on the tensor cores
//    through the WMMA API (bf16 m16n16k16, fp32 accumulators), as the TPU
//    kernels run them on its matrix unit in one exact bf16 pass.  K is padded
//    with zero rows to Kp = pad16(K); the ragged cells and genes are zeroed.
//    Warp w holds accumulator fragments w and w + 8 of a pass (16 fragments);
//    a larger output takes more passes over X.  Products are exact and sums
//    fp32: the plain version's result up to summation order.  X, H and W move
//    in 16-byte loads where their rows are 16-byte aligned, else element by
//    element, into the same bf16 values.
//  * float32 and int16 X use fp32 FMA with both operands in shared memory
//    (true fp32 under matmul_precision="highest": no TF32), outputs in
//    kMaxOut registers a thread.
#include "common.cuh"

#include <mma.h>

namespace alpine {

using namespace nvcuda;

constexpr int kCellChunk = 32;      // hxt: cells a split holds a multiple of; fp32 step
constexpr int kGeneChunk = 16;      // wtx fp32 path: genes a step
constexpr int kMmaCellChunk = 64;   // hxt bf16 path: cells a staged chunk
constexpr int kMmaGeneChunk = 32;   // wtx bf16 path: genes a staged chunk
constexpr int kMmaFrags = 2;        // accumulator fragments a warp holds in a pass
constexpr int kPassFrags = kWarps * kMmaFrags;
constexpr int kMaxWtxTile = 256;    // wtx bf16 path: the widest cell tile
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ inline int pad16(int v) { return (v + 15) / 16 * 16; }

// ---- device helpers (copies of fused_iteration.cu's) ----------------------

// dst[i * ld + j] = bf16(value(i, j)) for i < rows, j < cols: thread t takes
// the elements t, t + kThreads, ... of the row-major block, eight loads in
// flight before their stores.
template <typename F>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int ld, int rows,
                                           int cols, F value) {
  const int t0 = threadIdx.x, di = kThreads / cols, dj = kThreads - di * cols;
  int i = t0 / cols, j = t0 - i * cols;
  while (i < rows) {
    float v[8];
    int at[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      at[r] = -1;
      if (i < rows) {
        v[r] = value(i, j);
        at[r] = i * ld + j;
      }
      i += di;
      j += dj;
      if (j >= cols) {
        j -= cols;
        ++i;
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (at[r] >= 0) dst[at[r]] = __float2bfloat16_rn(v[r]);
  }
}

// 16 loaded bytes of T (the pointer only picks the type) widened to floats.
__device__ __forceinline__ void widen16(uint4 u, const int8_t*, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 16; ++q) f[q] = (float)(int8_t)(w[q >> 2] >> (8 * (q & 3)));
}
__device__ __forceinline__ void widen16(uint4 u, const __nv_bfloat16*, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 v = __bfloat1622float2(h[q]);
    f[2 * q] = v.x;
    f[2 * q + 1] = v.y;
  }
}
__device__ __forceinline__ void widen16(uint4 u, const float*, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// One 16-byte vector (V = 16 / sizeof(T) values) of a rows x cols block on
// its way to shared memory as bf16: element (i, j) is src[i * stride + j],
// zero where i >= rv or j >= cv.  load() issues the read and store() widens,
// rounds and writes, so that other loads can be issued in between.  The
// caller has checked that every row's vectors are 16-byte aligned, so the
// valid width cv of a block that starts at a multiple of V is a multiple of
// V: a vector is valid or zero as a whole.
template <typename T>
struct VecSlot {
  static constexpr int V = 16 / sizeof(T);
  uint4 raw;
  int i, j;
  bool live, full;

  __device__ __forceinline__ void load(int q, int vpr, int rows, const T* src,
                                       size_t stride, int rv, int cv) {
    i = q / vpr;
    j = (q - i * vpr) * V;
    live = i < rows;
    full = live && i < rv && j < cv;
    if (full) raw = __ldg(reinterpret_cast<const uint4*>(src + i * stride + j));
  }

  __device__ __forceinline__ void store(__nv_bfloat16* dst, int ld) const {
    if (!live) return;
    float f[V];
    if (full) {
      widen16(raw, static_cast<const T*>(nullptr), f);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) f[u] = 0.f;
    }
    __nv_bfloat162 p[V / 2];
#pragma unroll
    for (int u = 0; u < V / 2; ++u) p[u] = __floats2bfloat162_rn(f[2 * u], f[2 * u + 1]);
    __nv_bfloat16* d = dst + i * ld + j;
    if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(p);
    } else {
#pragma unroll
      for (int w = 0; w < V / 8; ++w)
        reinterpret_cast<uint4*>(d)[w] = reinterpret_cast<const uint4*>(p)[w];
    }
  }
};

// Vectors of T each thread stages for a rows x cols block.
template <typename T>
__host__ __device__ constexpr int vec_slots(int rows, int cols) {
  return (rows * cols / VecSlot<T>::V + kThreads - 1) / kThreads;
}

// The whole rows x cols block through VecSlots, two loads in flight a thread.
template <typename T>
__device__ __forceinline__ void stage_vec(__nv_bfloat16* dst, int ld, int rows,
                                          int cols, const T* src, size_t stride,
                                          int rv, int cv) {
  const int vpr = cols / VecSlot<T>::V;
  for (int q0 = threadIdx.x; q0 < rows * vpr; q0 += 2 * kThreads) {
    VecSlot<T> s[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) s[r].load(q0 + r * kThreads, vpr, rows, src, stride, rv, cv);
#pragma unroll
    for (int r = 0; r < 2; ++r) s[r].store(dst, ld);
  }
}

// Rows g0 .. g0 + rows - 1 of W (g x K, fp32) into the bf16 rows of sWb
// (stride LW).  They are one contiguous run of rows * K floats, starting
// 16-byte aligned when W is (g0 is a multiple of kMmaGeneChunk), so a thread
// reads 16 bytes a load whatever K is.  Columns K.. and rows past g are left
// as they are: the caller zeroes sWb once, and rows past g meet zero rows
// of X.
__device__ __forceinline__ void stage_w_run(__nv_bfloat16* sWb, int LW,
                                            const float* W, int g0, int rows,
                                            int K) {
  const float* src = W + (size_t)g0 * K;
  const int nw = rows * K;
  for (int e0 = threadIdx.x * 4; e0 < nw; e0 += 2 * 4 * kThreads) {
    float4 v[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = e0 + r * 4 * kThreads;
      if (e + 4 <= nw) {
        v[r] = __ldg(reinterpret_cast<const float4*>(src + e));
      } else if (e < nw) {  // the run's last, partial vector
        v[r].x = src[e];
        v[r].y = e + 1 < nw ? src[e + 1] : 0.f;
        v[r].z = e + 2 < nw ? src[e + 2] : 0.f;
        v[r].w = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = e0 + r * 4 * kThreads;
      if (e >= nw) break;
      int gg = e / K, k = e - gg * K;
      const float f[4] = {v[r].x, v[r].y, v[r].z, v[r].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (e + u < nw) sWb[gg * LW + k] = __float2bfloat16_rn(f[u]);
        if (++k == K) {
          k = 0;
          ++gg;
        }
      }
    }
  }
}

// True when every row of a (rows, n) array of T at p starts 16-byte aligned.
template <typename T>
__device__ __forceinline__ bool rows_aligned16(const T* p, int n) {
  return ((size_t)n * sizeof(T)) % 16 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---- hxt -----------------------------------------------------------------

// Shared memory of hxt's bf16 path: H (Kp x LC) and X (GB x LC) chunks as
// bf16, LC = kMmaCellChunk + 8; after a pass's last chunk the same bytes
// hold the Kp x (GB + 4) fp32 output on its way to the partial.
__host__ __device__ inline size_t hxt_mma_smem_bytes(int K, int GB) {
  const size_t stage = (size_t)(pad16(K) + GB) * (kMmaCellChunk + 8) * 2;
  const size_t out = (size_t)pad16(K) * (GB + 4) * 4;
  return stage > out ? stage : out;
}

// part[split][k][gi] = sum over the split's cells c of H[k][c] X[gi][c], for
// the GB genes of this block, on the tensor cores.
template <typename XT>
__global__ void __launch_bounds__(kThreads, 3)
hxt_mma(const XT* __restrict__ X, const float* __restrict__ H, int g, int n,
        int K, int GB, int cells_per_split, float* __restrict__ part) {
  extern __shared__ __align__(128) float sm[];
  constexpr int CM = kMmaCellChunk, LC = kMmaCellChunk + 8;
  const int tid = threadIdx.x, warp = tid / 32;
  const int g0 = blockIdx.x * GB, split = blockIdx.y;
  const int cbeg = split * cells_per_split;
  const int cend = min(n, cbeg + cells_per_split);
  const int Kp = pad16(K), gcols = GB / 16;
  const int n_frag = (Kp / 16) * gcols;
  __nv_bfloat16* sHb = reinterpret_cast<__nv_bfloat16*>(sm);  // Kp x LC
  __nv_bfloat16* sXb = sHb + Kp * LC;                          // GB x LC
  float* sOut = sm;  // Kp x (GB + 4), once a pass's last chunk is done
  const int LO = GB + 4;
  const bool xvec = rows_aligned16(X, n), hvec = rows_aligned16(H, n);
  // a pass holds whole fragment rows (16 is a multiple of gcols)
  for (int f0 = 0; f0 < n_frag; f0 += kPassFrags) {
    FragAcc fr[kMmaFrags];
#pragma unroll
    for (int i = 0; i < kMmaFrags; ++i) wmma::fill_fragment(fr[i], 0.f);
    for (int c0 = cbeg; c0 < cend; c0 += CM) {
      const int nv = min(CM, cend - c0);
      __syncthreads();
      // X's vectors are read first, so that their latency overlaps H's
      constexpr int kSlots = vec_slots<XT>(64, CM);
      VecSlot<XT> xs[kSlots];
      const XT* xsrc = X + (size_t)g0 * n + c0;
      const int xvpr = CM / VecSlot<XT>::V;
      if (xvec) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          xs[s].load(tid + s * kThreads, xvpr, GB, xsrc, n, g - g0, nv);
      } else {
        stage_bf16(sXb, LC, GB, CM, [&](int gg, int t) {
          return (t < nv && g0 + gg < g) ? to_f(X[(size_t)(g0 + gg) * n + c0 + t])
                                         : 0.f;
        });
      }
      if (hvec) {
        stage_vec<float>(sHb, LC, Kp, CM, H + c0, n, K, nv);
      } else {
        stage_bf16(sHb, LC, Kp, CM, [&](int k, int t) {
          return (k < K && t < nv) ? H[(size_t)k * n + c0 + t] : 0.f;
        });
      }
      if (xvec) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) xs[s].store(sXb, LC);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < CM; kk += 16) {
#pragma unroll
        for (int i = 0; i < kMmaFrags; ++i) {
          const int f = f0 + warp + i * kWarps;
          if (f < n_frag) {  // warp-uniform
            const int r = f / gcols, c = f - r * gcols;
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
            wmma::load_matrix_sync(a, sHb + r * 16 * LC + kk, LC);
            wmma::load_matrix_sync(b, sXb + c * 16 * LC + kk, LC);
            wmma::mma_sync(fr[i], a, b, fr[i]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the staged chunks
#pragma unroll
    for (int i = 0; i < kMmaFrags; ++i) {
      const int f = f0 + warp + i * kWarps;
      if (f < n_frag) {
        const int r = f / gcols, c = f - r * gcols;
        wmma::store_matrix_sync(sOut + r * 16 * LO + c * 16, fr[i], LO, wmma::mem_row_major);
      }
    }
    __syncthreads();
    // this pass's rows k_lo .. k_hi - 1 to the partial
    const int k_lo = f0 / gcols * 16;
    const int k_hi = min(K, (f0 + kPassFrags) / gcols * 16);
    for (int o = tid; o < (k_hi - k_lo) * GB; o += kThreads) {
      const int k = k_lo + o / GB, gg = o - (k - k_lo) * GB;
      if (g0 + gg < g) part[((size_t)split * K + k) * g + g0 + gg] = sOut[k * LO + gg];
    }
  }
}

// The same partials on fp32 FMA: K x GB outputs in registers (K * GB <=
// kThreads * kMaxOut), cells staged kCellChunk at a time as fp32.
template <typename XT>
__global__ void __launch_bounds__(kThreads)
hxt_fma(const XT* __restrict__ X, const float* __restrict__ H, int g, int n,
        int K, int GB, int cells_per_split, float* __restrict__ part) {
  extern __shared__ __align__(128) float sm[];
  constexpr int CT = kCellChunk, CTP = kCellChunk + 1;
  float* sH = sm;             // K x CTP
  float* sX = sH + K * CTP;   // GB x CTP
  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * GB, split = blockIdx.y;
  const int cbeg = split * cells_per_split;
  const int cend = min(n, cbeg + cells_per_split);
  const int KG = K * GB;
  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;
  for (int c0 = cbeg; c0 < cend; c0 += CT) {
    const int nv = min(CT, cend - c0);
    __syncthreads();
    for (int o = tid; o < K * CT; o += kThreads) {
      const int k = o / CT, t = o - k * CT;
      sH[k * CTP + t] = t < nv ? H[(size_t)k * n + c0 + t] : 0.f;
    }
    for (int o = tid; o < GB * CT; o += kThreads) {
      const int gg = o / CT, t = o - gg * CT;
      sX[gg * CTP + t] =
          (t < nv && g0 + gg < g) ? to_f(X[(size_t)(g0 + gg) * n + c0 + t]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kThreads;
      if (o < KG) {
        const int k = o / GB, gg = o - k * GB;
        float a = acc[i];
#pragma unroll 8
        for (int t = 0; t < CT; ++t) a = fmaf(sH[k * CTP + t], sX[gg * CTP + t], a);
        acc[i] = a;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int o = tid + i * kThreads;
    if (o < KG) {
      const int k = o / GB, gg = o - k * GB;
      if (g0 + gg < g) part[((size_t)split * K + k) * g + g0 + gg] = acc[i];
    }
  }
}

// out[k][gi] = sum over splits of part[s][k][gi], in split order.
__global__ void __launch_bounds__(kThreads)
reduce_splits(const float* __restrict__ part, int n_split, int K, int g,
              float* __restrict__ out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t KG = (size_t)K * g;
  if (idx >= KG) return;
  float s = 0.f;
  for (int sp = 0; sp < n_split; ++sp) s += part[(size_t)sp * KG + idx];
  out[idx] = s;
}

template <typename XT, bool kBf16>
static int launch_hxt(const void* X, const float* H, int g, int n, int K, int GB,
                      int n_split, int cells_per_split, float* part, float* out,
                      cudaStream_t stream) {
  const size_t smem = kBf16 ? hxt_mma_smem_bytes(K, GB)
                            : (size_t)(K + GB) * (kCellChunk + 1) * sizeof(float);
  const bool ok = kBf16 ? (GB % 16 == 0 && GB <= 64 && 16 % (GB / 16) == 0)
                        : (K * GB <= kThreads * kMaxOut);
  if (!ok || smem > (size_t)kMaxSmem || cells_per_split % kCellChunk != 0)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const XT*, const float*, int, int, int, int, int, float*);
  if constexpr (kBf16) {
    kernel = hxt_mma<XT>;
  } else {
    kernel = hxt_fma<XT>;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g + GB - 1) / GB, n_split);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const XT*>(X), H, g, n, K, GB,
                                           cells_per_split, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)K * g;
  reduce_splits<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, n_split, K, g, out);
  return (int)cudaGetLastError();
}

// ---- wtx -----------------------------------------------------------------

// Shared memory of wtx's bf16 path: W (kMmaGeneChunk x (Kp + 8)) and X
// (kMmaGeneChunk x (T + 8)) chunks as bf16, then the Kp x (T + 4) fp32
// output tile.
__host__ __device__ inline size_t wtx_mma_smem_bytes(int K, int T) {
  return (size_t)kMmaGeneChunk * (pad16(K) + 8 + T + 8) * 2 + (size_t)pad16(K) * (T + 4) * 4;
}

// out[k][c] = sum over genes gi of W[gi][k] X[gi][c] for the T cells of this
// block's tile, on the tensor cores.
template <typename XT>
__global__ void __launch_bounds__(kThreads, 2)
wtx_mma(const XT* __restrict__ X, const float* __restrict__ W, int g, int n,
        int K, int T, float* __restrict__ out) {
  extern __shared__ __align__(128) float sm[];
  constexpr int GC = kMmaGeneChunk;
  const int tid = threadIdx.x, warp = tid / 32;
  const int Kp = pad16(K), LW = Kp + 8, LX = T + 8, LO = T + 4;
  __nv_bfloat16* sWb = reinterpret_cast<__nv_bfloat16*>(sm);  // GC x LW (gene-major W)
  __nv_bfloat16* sXb = sWb + GC * LW;                          // GC x LX
  float* sOut = reinterpret_cast<float*>(sXb + GC * LX);       // Kp x LO
  const int c0 = blockIdx.x * T, nv = min(T, n - c0);
  const int tcols = T / 16, n_frag = (Kp / 16) * tcols;
  const bool xvec = rows_aligned16(X, n);
  const bool wvec = (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  // W's padding columns (and, with wvec, the rows past g) stay zero
  for (int j = tid; j < GC * LW; j += kThreads) sWb[j] = __float2bfloat16_rn(0.f);
  // a pass holds whole fragment rows (16 is a multiple of tcols)
  for (int f0 = 0; f0 < n_frag; f0 += kPassFrags) {
    FragAcc fr[kMmaFrags];
#pragma unroll
    for (int i = 0; i < kMmaFrags; ++i) wmma::fill_fragment(fr[i], 0.f);
    for (int gb = 0; gb < g; gb += GC) {
      const int rows = min(GC, g - gb);
      __syncthreads();
      // X's vectors are read first, so that their latency overlaps W's
      constexpr int kSlots = vec_slots<XT>(GC, kMaxWtxTile);
      VecSlot<XT> xs[kSlots];
      const XT* xsrc = X + (size_t)gb * n + c0;
      const int xvpr = T / VecSlot<XT>::V;
      if (xvec) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          xs[s].load(tid + s * kThreads, xvpr, GC, xsrc, n, rows, nv);
      } else {
        stage_bf16(sXb, LX, GC, T, [&](int gg, int t) {
          return (gg < rows && t < nv) ? to_f(X[(size_t)(gb + gg) * n + c0 + t]) : 0.f;
        });
      }
      if (wvec) {
        stage_w_run(sWb, LW, W, gb, rows, K);
      } else {
        stage_bf16(sWb, LW, GC, Kp, [&](int gg, int k) {
          return (gg < rows && k < K) ? W[(size_t)(gb + gg) * K + k] : 0.f;
        });
      }
      if (xvec) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) xs[s].store(sXb, LX);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < GC; kk += 16) {
#pragma unroll
        for (int i = 0; i < kMmaFrags; ++i) {
          const int f = f0 + warp + i * kWarps;
          if (f < n_frag) {  // warp-uniform
            const int r = f / tcols, c = f - r * tcols;
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
            wmma::load_matrix_sync(a, sWb + kk * LW + r * 16, LW);
            wmma::load_matrix_sync(b, sXb + kk * LX + c * 16, LX);
            wmma::mma_sync(fr[i], a, b, fr[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMmaFrags; ++i) {
      const int f = f0 + warp + i * kWarps;
      if (f < n_frag) {
        const int r = f / tcols, c = f - r * tcols;
        wmma::store_matrix_sync(sOut + r * 16 * LO + c * 16, fr[i], LO, wmma::mem_row_major);
      }
    }
    __syncthreads();
    // this pass's rows k_lo .. k_hi - 1, each output written once
    const int k_lo = f0 / tcols * 16;
    const int k_hi = min(K, (f0 + kPassFrags) / tcols * 16);
    for (int o = tid; o < (k_hi - k_lo) * T; o += kThreads) {
      const int k = k_lo + o / T, t = o - (k - k_lo) * T;
      if (t < nv) out[(size_t)k * n + c0 + t] = sOut[k * LO + t];
    }
  }
}

// The same outputs on fp32 FMA: K x T outputs in registers (K * T <=
// kThreads * kMaxOut), genes staged kGeneChunk at a time as fp32.
template <typename XT>
__global__ void __launch_bounds__(kThreads)
wtx_fma(const XT* __restrict__ X, const float* __restrict__ W, int g, int n,
        int K, int T, float* __restrict__ out) {
  extern __shared__ __align__(128) float sm[];
  constexpr int GC = kGeneChunk;
  float* sW = sm;            // GC x K: rows gb .. gb + GC - 1 of W
  float* sX = sW + GC * K;   // GC x T
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * T, nv = min(T, n - c0), KT = K * T;
  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;
  for (int gb = 0; gb < g; gb += GC) {
    const int rows = min(GC, g - gb);
    __syncthreads();
    for (int o = tid; o < GC * K; o += kThreads)
      sW[o] = o < rows * K ? W[(size_t)gb * K + o] : 0.f;
    for (int o = tid; o < GC * T; o += kThreads) {
      const int gg = o / T, t = o - gg * T;
      sX[o] = (gg < rows && t < nv) ? to_f(X[(size_t)(gb + gg) * n + c0 + t]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kThreads;
      if (o < KT) {
        const int k = o / T, t = o - k * T;
        float a = acc[i];
#pragma unroll
        for (int gg = 0; gg < GC; ++gg) a = fmaf(sW[gg * K + k], sX[gg * T + t], a);
        acc[i] = a;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int o = tid + i * kThreads;
    if (o < KT) {
      const int k = o / T, t = o - k * T;
      if (t < nv) out[(size_t)k * n + c0 + t] = acc[i];
    }
  }
}

template <typename XT, bool kBf16>
static int launch_wtx(const void* X, const float* W, int g, int n, int K, int T,
                      float* out, cudaStream_t stream) {
  const size_t smem = kBf16 ? wtx_mma_smem_bytes(K, T)
                            : (size_t)kGeneChunk * (K + T) * sizeof(float);
  const bool ok = kBf16 ? (T % 16 == 0 && T <= kMaxWtxTile && 16 % (T / 16) == 0)
                        : (K * T <= kThreads * kMaxOut);
  if (!ok || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  void (*kernel)(const XT*, const float*, int, int, int, int, float*);
  if constexpr (kBf16) {
    kernel = wtx_mma<XT>;
  } else {
    kernel = wtx_fma<XT>;
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + T - 1) / T, kThreads, smem, stream>>>(static_cast<const XT*>(X), W, g, n,
                                                      K, T, out);
  return (int)cudaGetLastError();
}

}  // namespace alpine

// Plain C entry points (ctypes).  Each returns 0 or a cudaError_t code.
extern "C" int alpine_hxt(const void* X, int xtype, const float* H, int g, int n,
                          int K, int GB, int n_split, int cells_per_split,
                          float* part, float* out, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (xtype) {
    case kF32:
      return launch_hxt<float, false>(X, H, g, n, K, GB, n_split, cells_per_split, part, out, s);
    case kBF16:
      return launch_hxt<__nv_bfloat16, true>(X, H, g, n, K, GB, n_split, cells_per_split,
                                             part, out, s);
    case kI8:
      return launch_hxt<int8_t, true>(X, H, g, n, K, GB, n_split, cells_per_split, part, out,
                                      s);
    case kI16:
      return launch_hxt<int16_t, false>(X, H, g, n, K, GB, n_split, cells_per_split, part,
                                        out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int alpine_wtx(const void* X, int xtype, const float* W, int g, int n,
                          int K, int T, float* out, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (xtype) {
    case kF32: return launch_wtx<float, false>(X, W, g, n, K, T, out, s);
    case kBF16: return launch_wtx<__nv_bfloat16, true>(X, W, g, n, K, T, out, s);
    case kI8: return launch_wtx<int8_t, true>(X, W, g, n, K, T, out, s);
    case kI16: return launch_wtx<int16_t, false>(X, W, g, n, K, T, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
// Design (the joint fit's fused_iteration.cu holds the same two products
// inside K1, whose code is left as it is, so the device helpers below are
// copies of its own):
//  * hxt: a grid of (gene block of GB genes) x (cell split).  A block sums
//    its K x GB outputs over its split's cells and writes one partial;
//    reduce_splits adds the partials in a fixed order (no float atomics), so
//    two launches give the same bits.
//  * wtx: one block per tile of T cells, looping over all genes in chunks;
//    every output is written once, by the block of its cells.
//  * int8 and bf16 X compute in bf16 (kBf16) on the tensor cores (bf16
//    operands, fp32 accumulators), as the TPU kernels run them on its matrix
//    unit in one exact bf16 pass.  K is padded with zero rows to
//    Kp = pad16(K); the ragged cells and genes are zeroed.  Products are
//    exact and sums fp32: the plain version's result up to summation order.
//  * hxt's bf16 path: round_h first rounds H to bf16 once a call (Hb,
//    padded with zero cells to a multiple of the ring's chunk), then hxt_mma
//    streams raw X and Hb chunks through a ring of S shared-memory stages
//    filled by cp.async and multiplies straight from the ring with mma.sync
//    (int8 widened in registers).  GB is as wide as one pass of 4 fragments
//    a warp allows (128 genes at K <= 64), and the grid is one wave of long
//    cell splits (ops/kernels.py:hxt_grid), so few partials are written.
//    What holds it back is latency, not bytes: two blocks of 8 warps an SM,
//    a dependent chain of shared loads and products a warp (PERF.md).
//  * wtx stages X and W in shared memory as bf16 and multiplies through the
//    WMMA API (m16n16k16); warp w holds accumulator fragments w and w + 8 of
//    a pass (16 fragments), and a larger output takes more passes over X.
//    X and W move in 16-byte loads where their rows are 16-byte aligned,
//    else element by element, into the same bf16 values; so does X in
//    hxt_mma (cp.async or element by element).
//  * float32 and int16 X use fp32 FMA with both operands in shared memory
//    (true fp32 under matmul_precision="highest": no TF32), outputs in
//    kMaxOut registers a thread.
#include "common.cuh"

#include <mma.h>

#include <type_traits>

namespace alpine {

using namespace nvcuda;

constexpr int kCellChunk = 32;      // hxt: cells a split holds a multiple of; fp32 step
constexpr int kGeneChunk = 16;      // wtx fp32 path: genes a step
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
#pragma unroll
    for (int w = 0; w < V / 8; ++w)
      reinterpret_cast<uint4*>(d)[w] = reinterpret_cast<const uint4*>(p)[w];
  }
};

// Vectors of T each thread stages for a rows x cols block.
template <typename T>
__host__ __device__ constexpr int vec_slots(int rows, int cols) {
  return (rows * cols / VecSlot<T>::V + kThreads - 1) / kThreads;
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

// cp.async: 16 bytes from global to shared memory without a register, or 16
// zero bytes when !full (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's committed groups are in
// flight (the instruction takes an immediate; waiting for fewer is safe).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Two floats that hold bf16 values exactly (here integers |x| <= 128) as
// one bf16x2 register: the upper halves of their bits, the first low.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Eight int8 values (two words) widened exactly to four bf16x2 registers:
// a byte permute makes the fp32 bits 2^23 + (x + 128) and one subtraction
// gives x (as in stream_probe.cu).
__device__ __forceinline__ void widen_i8x8(uint2 v, unsigned* out) {
  const unsigned w[2] = {v.x, v.y};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const unsigned u = w[q] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + b)) - 8388736.f;
    out[2 * q] = pack_bf16x2(f[0], f[1]);
    out[2 * q + 1] = pack_bf16x2(f[2], f[3]);
  }
}

// d += a b on the tensor cores: bf16 m16n8k16, fp32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float* d, const unsigned* a, unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Hb[k][c] = bf16(H[k][c]) for c < n, 0 for n <= c < n_pad: H rounded once
// a call (hxt_mma reads it as it is).  One thread an 8-cell vector.
__global__ void __launch_bounds__(kThreads)
round_h(const float* __restrict__ H, int K, int n, int n_pad,
        __nv_bfloat16* __restrict__ Hb) {
  const int vpr = n_pad / 8;
  const size_t q = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (q >= (size_t)K * vpr) return;
  const int k = (int)(q / vpr), c = (int)(q - (size_t)k * vpr) * 8;
  const float* src = H + (size_t)k * n;
  float v[8];
  if (rows_aligned16(H, n) && c + 8 <= n) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src + c));
    const float4 b = __ldg(reinterpret_cast<const float4*>(src + c + 4));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = c + u < n ? src[c + u] : 0.f;
  }
  __nv_bfloat16 r[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) r[u] = __float2bfloat16_rn(v[u]);
  *reinterpret_cast<uint4*>(Hb + (size_t)k * n_pad + c) = *reinterpret_cast<const uint4*>(r);
}

// Bytes of a staged row of `data` bytes, padded so that rows start
// `target` bytes apart modulo 128 (the banks of one shared-memory access).
__host__ __device__ constexpr int hxt_row_bytes(int data, int target) {
  return data + ((target - data) % 128 + 128) % 128;
}

// Shared memory of hxt's bf16 path: a ring of S stages, each a chunk of CW
// cells of Hb (Kp rows of CW bf16) and of X's GB rows (CW values as stored).
// Hb and bf16 X rows are read 16 bytes a lane and start 64 bytes apart
// modulo 128, int8 rows 8 bytes a lane and 32 apart: no bank conflicts.
// After the last chunk the same bytes hold the Kp x (GB + 4) fp32 output on
// its way to the partial.  ops/kernels.py:hxt_smem_bytes holds the same
// formula.
__host__ __device__ inline size_t hxt_mma_smem_bytes(int K, int GB, int S, int CW,
                                                     bool int8) {
  const size_t h = (size_t)pad16(K) * hxt_row_bytes(2 * CW, 64);
  const size_t x = (size_t)GB * (int8 ? hxt_row_bytes(CW, 32) : hxt_row_bytes(2 * CW, 64));
  const size_t ring = S * (h + x);
  const size_t out = (size_t)pad16(K) * (GB + 4) * 4;
  return ring > out ? ring : out;
}

constexpr int kHxtFrags = 4;  // 16-row fragments of H a warp holds (one pass)

// part[split][k][gi] = sum over the split's cells c of Hb[k][c] X[gi][c], for
// the GB genes of this block, on the tensor cores, in one pass over X.
//
// The split's chunks of CW cells flow through a ring of S stages filled by
// cp.async, S - 1 chunks ahead of the one being multiplied, one barrier a
// chunk.  Warp w holds gene column w % (GB / 16) (two 8-gene tiles) and
// every (8 / (GB / 16))-th 16-row fragment of H, and multiplies straight
// from the ring with mma.sync m16n8k16: int8 X is widened in registers.
// Within each 32 cells a lane reads 8 consecutive cells of a row (16 bytes
// of Hb, 8 or 16 of X) and feeds them to two k16 steps, cells 4 at a time
// into the k slots {2t, 2t + 1, 2t + 8, 2t + 9} of both operands: the
// same bijection on both sides, so the sums run over every cell once.  X
// rows off 16-byte alignment are staged element by element into the same
// places, so the summation order does not depend on X's alignment.
template <typename XT, int CW>
__global__ void __launch_bounds__(kThreads, 2)
hxt_mma(const XT* __restrict__ X, const __nv_bfloat16* __restrict__ Hb, int g, int n,
        int n_pad, int K, int GB, int cells_per_split, int S, float* __restrict__ part) {
  constexpr bool kInt8 = sizeof(XT) == 1;
  constexpr int V = 16 / sizeof(XT);  // values of a 16-byte copy
  // X's values as raw bits, for the element-by-element staging
  using Raw = typename std::conditional<kInt8, uint8_t, uint16_t>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g0 = blockIdx.x * GB, split = blockIdx.y;
  const int cbeg = split * cells_per_split;
  const int n_chunks = (min(n, cbeg + cells_per_split) - cbeg + CW - 1) / CW;
  constexpr int HR = hxt_row_bytes(2 * CW, 64);
  constexpr int XR = kInt8 ? hxt_row_bytes(CW, 32) : hxt_row_bytes(2 * CW, 64);
  constexpr int HV = CW / 8, XV = CW / V;  // 16-byte copies a row
  const int Kp = pad16(K), RF = Kp / 16, gcols = GB / 16;
  const int h_bytes = Kp * HR, stage_bytes = h_bytes + GB * XR;
  const bool xvec = rows_aligned16(X, n);
  // Hb's rows K .. Kp - 1 are never copied: zero in every stage
  for (int st = 0; st < S; ++st)
    for (int o = tid; o < (Kp - K) * HR / 16; o += kThreads)
      reinterpret_cast<uint4*>(smem + st * stage_bytes + K * HR)[o] = make_uint4(0, 0, 0, 0);

  // chunk c's copies into stage st; one group committed, empty past the split
  auto issue = [&](int c, int st) {
    if (c < n_chunks) {
      const int c0 = cbeg + c * CW;
      unsigned char* h = smem + st * stage_bytes;
      for (int q = tid; q < K * HV; q += kThreads) {
        const int k = q / HV, j = (q % HV) * 8;
        cp_async16(h + k * HR + j * 2, Hb + (size_t)k * n_pad + c0 + j, true);
      }
      unsigned char* x = h + h_bytes;
      if (xvec) {
        for (int q = tid; q < GB * XV; q += kThreads) {
          const int gg = q / XV, j = (q % XV) * V;
          // n is a multiple of V here: a vector is valid or zero as a whole
          const bool ok = g0 + gg < g && c0 + j < n;
          cp_async16(x + gg * XR + j * (int)sizeof(XT),
                     ok ? X + (size_t)(g0 + gg) * n + c0 + j : X, ok);
        }
      } else {  // the same values, element by element, eight loads in flight
        const Raw* src = reinterpret_cast<const Raw*>(X);
        for (int e0 = tid; e0 < GB * CW; e0 += 8 * kThreads) {
          Raw v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = e0 + u * kThreads, gg = e / CW, t = e % CW;
            v[u] = (e < GB * CW && g0 + gg < g && c0 + t < n)
                       ? src[(size_t)(g0 + gg) * n + c0 + t] : Raw(0);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = e0 + u * kThreads;
            if (e < GB * CW) reinterpret_cast<Raw*>(x + e / CW * XR)[e % CW] = v[u];
          }
        }
      }
    }
    cp_async_commit();
  };

  const int col = warp % gcols, r0 = warp / gcols, rstep = kWarps / gcols;
  const int gq = lane / 4, t8 = (lane % 4) * 8;  // the lane's row and cells
  float acc[kHxtFrags][2][4];
#pragma unroll
  for (int f = 0; f < kHxtFrags; ++f)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][nt][i] = 0.f;
  for (int c = 0; c < S - 1; ++c) issue(c, c);
  int st = 0;  // stage of chunk c
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait(S - 2);  // chunk c (this thread's copies)
    // chunk c has landed; every warp is done with chunk c - 1, whose stage
    // the next copies refill
    __syncthreads();
    issue(c + S - 1, st == 0 ? S - 1 : st - 1);
    const unsigned char* h = smem + st * stage_bytes;
    const unsigned char* x = h + h_bytes + (col * 16 + gq) * XR;
    // unrolled, so that a slice's loads can be issued under the previous
    // slice's products
#pragma unroll
    for (int c32 = 0; c32 < CW; c32 += 32) {
      unsigned b[2][4];  // per 8-gene tile: k16 step 0 {b0, b1}, step 1 {b0, b1}
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if constexpr (kInt8) {
          widen_i8x8(*reinterpret_cast<const uint2*>(x + nt * 8 * XR + c32 + t8), b[nt]);
        } else {
          const uint4 v = *reinterpret_cast<const uint4*>(x + nt * 8 * XR + (c32 + t8) * 2);
          b[nt][0] = v.x, b[nt][1] = v.y, b[nt][2] = v.z, b[nt][3] = v.w;
        }
      }
#pragma unroll
      for (int f = 0; f < kHxtFrags; ++f) {
        const int rf = r0 + f * rstep;
        if (rf < RF) {  // warp-uniform
          const unsigned char* hr = h + (rf * 16 + gq) * HR + (c32 + t8) * 2;
          const uint4 lo = *reinterpret_cast<const uint4*>(hr);
          const uint4 hi = *reinterpret_cast<const uint4*>(hr + 8 * HR);
          const unsigned a0[4] = {lo.x, hi.x, lo.y, hi.y};  // cells t8 .. t8 + 3
          const unsigned a1[4] = {lo.z, hi.z, lo.w, hi.w};  // cells t8 + 4 .. t8 + 7
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            mma_bf16_16816(acc[f][nt], a0, b[nt][0], b[nt][1]);
            mma_bf16_16816(acc[f][nt], a1, b[nt][2], b[nt][3]);
          }
        }
      }
    }
    st = st + 1 == S ? 0 : st + 1;
  }
  cp_async_wait(0);
  __syncthreads();  // every warp is done with the ring
  float* sOut = reinterpret_cast<float*>(smem);  // Kp x LO
  const int LO = GB + 4;
#pragma unroll
  for (int f = 0; f < kHxtFrags; ++f) {
    const int rf = r0 + f * rstep;
    if (rf < RF) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float* o = sOut + (rf * 16 + gq) * LO + col * 16 + nt * 8 + (lane % 4) * 2;
        o[0] = acc[f][nt][0];
        o[1] = acc[f][nt][1];
        o[8 * LO] = acc[f][nt][2];
        o[8 * LO + 1] = acc[f][nt][3];
      }
    }
  }
  __syncthreads();
  for (int o = tid; o < K * GB; o += kThreads) {
    const int k = o / GB, gg = o - k * GB;
    if (g0 + gg < g) part[((size_t)split * K + k) * g + g0 + gg] = sOut[k * LO + gg];
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

// The bf16 path: H rounded into Hb (K x n_pad, n_pad a multiple of CW), then
// hxt_mma over a grid of (gene block) x (cell split) with S ring stages of
// CW cells.
template <typename XT>
static int launch_hxt_mma(const void* X, const float* H, int g, int n, int K, int GB,
                          int n_split, int cells_per_split, int S, int CW,
                          __nv_bfloat16* Hb, float* part, cudaStream_t stream) {
  void (*kernel)(const XT*, const __nv_bfloat16*, int, int, int, int, int, int, int,
                 float*) = CW == 128 ? hxt_mma<XT, 128> : hxt_mma<XT, 64>;
  const int Kp = pad16(K), gcols = GB / 16;
  const size_t smem = hxt_mma_smem_bytes(K, GB, S, CW, sizeof(XT) == 1);
  const bool ok = GB % 16 == 0 && GB <= 128 && kWarps % gcols == 0 &&
                  (Kp / 16) * gcols <= kWarps * kHxtFrags && S >= 2 && S <= 8 &&
                  (CW == 64 || CW == 128) &&
                  cells_per_split % CW == 0 && Hb != nullptr;
  if (!ok || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int n_pad = (n + CW - 1) / CW * CW;
  const size_t vecs = (size_t)K * (n_pad / 8);
  round_h<<<(unsigned)((vecs + kThreads - 1) / kThreads), kThreads, 0, stream>>>(H, K, n,
                                                                                 n_pad, Hb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g + GB - 1) / GB, n_split);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const XT*>(X), Hb, g, n, n_pad, K, GB,
                                           cells_per_split, S, part);
  return (int)cudaGetLastError();
}

template <typename XT>
static int launch_hxt_fma(const void* X, const float* H, int g, int n, int K, int GB,
                          int n_split, int cells_per_split, float* part,
                          cudaStream_t stream) {
  const size_t smem = (size_t)(K + GB) * (kCellChunk + 1) * sizeof(float);
  if (K * GB > kThreads * kMaxOut || smem > (size_t)kMaxSmem ||
      cells_per_split % kCellChunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hxt_fma<XT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g + GB - 1) / GB, n_split);
  hxt_fma<XT><<<grid, kThreads, smem, stream>>>(static_cast<const XT*>(X), H, g, n, K, GB,
                                                cells_per_split, part);
  return (int)cudaGetLastError();
}

template <typename XT, bool kBf16>
static int launch_hxt(const void* X, const float* H, int g, int n, int K, int GB,
                      int n_split, int cells_per_split, int S, int CW,
                      __nv_bfloat16* Hb, float* part, float* out, cudaStream_t stream) {
  int rc;
  if constexpr (kBf16) {
    rc = launch_hxt_mma<XT>(X, H, g, n, K, GB, n_split, cells_per_split, S, CW, Hb, part,
                            stream);
  } else {
    rc = launch_hxt_fma<XT>(X, H, g, n, K, GB, n_split, cells_per_split, part, stream);
  }
  if (rc != 0) return rc;
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
// hxt: `stages`, `chunk` (cells a ring stage holds) and the scratch `hb`
// (K x n rounded up to the chunk, bf16) serve the bf16 path (int8, bf16 X)
// and are ignored by the fp32 one.
extern "C" int alpine_hxt(const void* X, int xtype, const float* H, int g, int n,
                          int K, int GB, int n_split, int cells_per_split, int stages,
                          int chunk, void* hb, float* part, float* out, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* Hb = static_cast<__nv_bfloat16*>(hb);
  switch (xtype) {
    case kF32:
      return launch_hxt<float, false>(X, H, g, n, K, GB, n_split, cells_per_split, stages,
                                      chunk, Hb, part, out, s);
    case kBF16:
      return launch_hxt<__nv_bfloat16, true>(X, H, g, n, K, GB, n_split, cells_per_split,
                                             stages, chunk, Hb, part, out, s);
    case kI8:
      return launch_hxt<int8_t, true>(X, H, g, n, K, GB, n_split, cells_per_split, stages,
                                      chunk, Hb, part, out, s);
    case kI16:
      return launch_hxt<int16_t, false>(X, H, g, n, K, GB, n_split, cells_per_split, stages,
                                        chunk, Hb, part, out, s);
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

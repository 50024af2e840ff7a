// The bf16 X passes (int8 and bf16 X, K <= 512):
//   hxt_mma: part[split][k][gi] = sum over a split's cells c of Hb[k][c] X[gi][c]
//            (Hb: H rounded to bf16 by round_h);
//   wtx_mma: out[k][c] = sum over genes gi of Wb[k][gi] X[gi][c] (Wb: W rounded
//            and transposed by round_w).
// x_passes.cu runs them as ALS's P1 and P2 (hxt, wtx) and as the two X
// products of K1/K2/K4's chain on int8/bf16 X at K <= 512, as
// fma_passes.cuh's kernels serve both on float32/int16 X.  Grids:
// ops/kernels.py:hxt_grid (K1: k1_hxt_grid), wtx_grid, wtx_gene_split.  The design (a ring of
// raw X chunks and of the rounded operand filled by cp.async, mma.sync
// m16n8k16 straight from it, X rows at any byte alignment read as the
// aligned windows that cover them) is x_passes.cu's header comment.
//
// Also here, for the kernels above K = 512 (x_passes_wide.cuh) too: the
// staging helpers of misaligned rows (row_offset, window_src, keep_bytes,
// lds8_at / lds16_at, CopyWalk), the int8 widening, ldmatrix, the arrival
// counter of a tile's last block (last_to_arrive) and allow_smem.
#pragma once

#include "fma_passes.cuh"

#include <mutex>

namespace alpine {

constexpr int kWtxAcc = 48;         // wtx bf16 path: accumulators a thread

__host__ __device__ inline int pad16(int v) { return (v + 15) / 16 * 16; }

// ---- hxt -----------------------------------------------------------------

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
// cells of Hb (Kp rows of CW bf16) and of X's GB rows (CW values as stored,
// and 16 bytes more: the aligned window of a row off 16-byte alignment).
// Hb and bf16 X rows are read 16 bytes a lane and start 64 bytes apart
// modulo 128, int8 rows 8 bytes a lane and 32 apart: no bank conflicts.
// After the last chunk the same bytes hold the Kp x (GB + 4) fp32 output on
// its way to the partial.  ops/kernels.py:hxt_smem_bytes holds the same
// formula.
__host__ __device__ inline size_t hxt_mma_smem_bytes(int K, int GB, int S, int CW,
                                                     bool int8) {
  const size_t h = (size_t)pad16(K) * hxt_row_bytes(2 * CW, 64);
  const size_t x =
      (size_t)GB * (int8 ? hxt_row_bytes(CW + 16, 32) : hxt_row_bytes(2 * CW + 16, 64));
  const size_t ring = S * (h + x);
  const size_t out = (size_t)pad16(K) * (GB + 4) * 4;
  return ring > out ? ring : out;
}

constexpr int kHxtFrags = 4;  // 16-row fragments of H a warp holds (one pass)

// ---- X rows at any byte alignment (both bf16 paths) ----------------------
//
// A chunk or tile starts a multiple of 16 bytes into each X row (its width
// is a multiple of 16 values), so a row's staged slice keeps the row's own
// byte offset from a 16-byte boundary.  Where some row is off alignment
// (n · sizeof(XT) not a multiple of 16, or X itself off), each row's slice
// is copied as the 16-byte-aligned window that covers it, one 16-byte copy
// longer, through the same cp.async ring; the consumers then read each row
// at its own offset, so every value lands in the k slot it takes on the
// aligned path and the sums are the aligned copy's, bit for bit.

// Byte offset of X's row gi from the 16-byte boundary below it (mod 16, so
// in 32 bits).
template <typename XT>
__device__ __forceinline__ int row_offset(const XT* X, int gi, int n) {
  return (int)(((unsigned)reinterpret_cast<uintptr_t>(X) +
                (unsigned)gi * ((unsigned)n * (unsigned)sizeof(XT))) & 15u);
}

// Copy jv (16 bytes) of the aligned window of X's row gi that covers the
// cells from c0; `ok` false (zero fill) once the copy starts past the row.
// A copy that starts inside the row is read whole: its bytes past the row
// (never past the 16-byte-aligned vector, so never past the allocation)
// are masked by hxt's consumer; wtx reads them as cells past n, whose
// outputs (a cell's sums read only its own column) are never stored.
template <typename XT>
__device__ __forceinline__ const void* window_src(const XT* X, int gi, int n, int c0, int jv,
                                                  bool& ok) {
  const unsigned char* row = reinterpret_cast<const unsigned char*>(X) + (size_t)gi * n * sizeof(XT);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(
      reinterpret_cast<uintptr_t>(row + (size_t)c0 * sizeof(XT)) & ~uintptr_t(15)) + 16 * jv;
  ok = src < row + (size_t)n * sizeof(XT);
  return src;
}

// Word w with only its first `keep` bytes (any int; <= 0: none, >= 4: all).
__device__ __forceinline__ unsigned keep_bytes(unsigned w, int keep) {
  return keep >= 4 ? w : keep <= 0 ? 0u : w & ((1u << (8 * keep)) - 1u);
}

// 8 and 16 bytes at byte o (any) of a staged row: the aligned words that
// cover them, funnel-shifted.  Reads at most 3 (5) words from o & ~3.
__device__ __forceinline__ uint2 lds8_at(const unsigned char* row, int o) {
  const unsigned* w = reinterpret_cast<const unsigned*>(row + (o & ~3));
  const int sh = (o & 3) * 8;
  return make_uint2(__funnelshift_r(w[0], w[1], sh), __funnelshift_r(w[1], w[2], sh));
}

__device__ __forceinline__ uint4 lds16_at(const unsigned char* row, int o) {
  const unsigned* w = reinterpret_cast<const unsigned*>(row + (o & ~3));
  const int sh = (o & 3) * 8;
  return make_uint4(__funnelshift_r(w[0], w[1], sh), __funnelshift_r(w[1], w[2], sh),
                    __funnelshift_r(w[2], w[3], sh), __funnelshift_r(w[3], w[4], sh));
}

// The thread's first 16-byte copy of a stage's X rows (row, copy) and its
// step to the next, for `per_row` copies a row and kThreads threads.
struct CopyWalk {
  int row, copy, drow, dcopy, per_row;
  __device__ CopyWalk(int tid, int per_row_)
      : row(tid / per_row_), copy(tid % per_row_), drow(kThreads / per_row_),
        dcopy(kThreads % per_row_), per_row(per_row_) {}
  __device__ void next() {
    row += drow, copy += dcopy;
    if (copy >= per_row) copy -= per_row, ++row;
  }
};

// Sums of the blocks of one output tile, taken in a fixed order by the
// last of them to finish (no float atomics): each block has written its
// partial; the arrival counter of the tile (zero before the launch, zero
// again after it) names the last one.  True in every thread of that block.
// `flag` is shared memory the block no longer needs.
__device__ __forceinline__ bool last_to_arrive(unsigned* arrivals, int tile, int blocks,
                                               volatile int* flag) {
  __threadfence();  // this block's partial, before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned before = atomicAdd(arrivals + tile, 1u);
    const bool last = before == (unsigned)blocks - 1;
    if (last) arrivals[tile] = 0u;  // ready for the next launch
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();  // the other blocks' partials, after their arrivals
  return last;
}

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
// rows off 16-byte alignment are staged as aligned windows and a lane reads
// its 8 cells at the row's offset with funnel shifts of aligned words (the
// last chunk masks cells past n), so the products and their order, and
// the bits, are the aligned copy's.
template <typename XT, int CW, bool kAligned>
__global__ void __launch_bounds__(kThreads, 2)
hxt_mma(const XT* __restrict__ X, const __nv_bfloat16* __restrict__ Hb, int g, int n,
        int n_pad, int K, int GB, int cells_per_split, int S, float* __restrict__ part) {
  constexpr bool kInt8 = sizeof(XT) == 1;
  constexpr int V = 16 / sizeof(XT);  // values of a 16-byte copy
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g0 = blockIdx.x * GB, split = blockIdx.y;
  const int cbeg = split * cells_per_split;
  const int n_chunks = (min(n, cbeg + cells_per_split) - cbeg + CW - 1) / CW;
  constexpr int HR = hxt_row_bytes(2 * CW, 64);
  constexpr int XR = kInt8 ? hxt_row_bytes(CW + 16, 32) : hxt_row_bytes(2 * CW + 16, 64);
  constexpr int HV = CW / 8;  // 16-byte copies an Hb row
  const int Kp = pad16(K), RF = Kp / 16, gcols = GB / 16;
  const int h_bytes = Kp * HR, stage_bytes = h_bytes + GB * XR;
  const CopyWalk walk0(tid, CW / V + (kAligned ? 0 : 1));  // 16-byte copies an X row
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
      for (CopyWalk cp = walk0; cp.row < GB; cp.next()) {
        bool ok;
        const void* src;
        if constexpr (kAligned) {  // n is a multiple of V: a copy is valid or zero as a whole
          ok = g0 + cp.row < g && c0 + cp.copy * V < n;
          src = X + (size_t)(g0 + cp.row) * n + c0 + cp.copy * V;
        } else {
          ok = false;
          src = g0 + cp.row < g ? window_src(X, g0 + cp.row, n, c0, cp.copy, ok) : X;
        }
        cp_async16(x + cp.row * XR + 16 * cp.copy, ok ? src : X, ok);
      }
    }
    cp_async_commit();
  };

  const int col = warp % gcols, r0 = warp / gcols, rstep = kWarps / gcols;
  const int gq = lane / 4, t8 = (lane % 4) * 8;  // the lane's row and cells
  // byte offsets of the lane's two X rows (0 where X is aligned)
  int xoff[2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int gi = g0 + col * 16 + nt * 8 + gq;
    xoff[nt] = !kAligned && gi < g ? row_offset(X, gi, n) : 0;
  }
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
    // cells of the chunk before n (the last chunk of a misaligned X masks
    // the bytes its windows read past the row)
    const int left = kAligned ? CW : n - (cbeg + c * CW);
    // unrolled, so that a slice's loads can be issued under the previous
    // slice's products
#pragma unroll
    for (int c32 = 0; c32 < CW; c32 += 32) {
      unsigned b[2][4];  // per 8-gene tile: k16 step 0 {b0, b1}, step 1 {b0, b1}
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const unsigned char* xr = x + nt * 8 * XR;
        const int keep = (left - (c32 + t8)) * (int)sizeof(XT);  // bytes before n
        if constexpr (kInt8) {
          uint2 v;
          if constexpr (kAligned) {
            v = *reinterpret_cast<const uint2*>(xr + c32 + t8);
          } else {
            v = lds8_at(xr, xoff[nt] + c32 + t8);
            v.x = keep_bytes(v.x, keep), v.y = keep_bytes(v.y, keep - 4);
          }
          widen_i8x8(v, b[nt]);
        } else {
          uint4 v;
          if constexpr (kAligned) {
            v = *reinterpret_cast<const uint4*>(xr + (c32 + t8) * 2);
          } else {
            v = lds16_at(xr, xoff[nt] + (c32 + t8) * 2);
            v.x = keep_bytes(v.x, keep), v.y = keep_bytes(v.y, keep - 4);
            v.z = keep_bytes(v.z, keep - 8), v.w = keep_bytes(v.w, keep - 12);
          }
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

// cudaFuncSetAttribute(max dynamic shared memory) once for each kernel,
// device and larger size: the attribute stays set, and the call costs host
// time on every launch.
static cudaError_t allow_smem(const void* kernel, size_t bytes) {
  struct Seen { const void* kernel; int device; size_t bytes; };
  static std::mutex mu;
  static Seen seen[64];
  static int n_seen = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  int i = 0;
  while (i < n_seen && (seen[i].kernel != kernel || seen[i].device != device)) ++i;
  if (i < n_seen && seen[i].bytes >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  if (i < n_seen) seen[i].bytes = bytes;
  else if (n_seen < 64) seen[n_seen++] = {kernel, device, bytes};
  return cudaSuccess;
}

// The bf16 path (K <= 512: all of K a block; above, hxt_wide): H rounded
// into Hb (K x n_pad, n_pad a multiple of CW), then hxt_mma over a grid of
// (gene block) x (cell split) with S ring stages of CW cells, X's rows on
// 16-byte boundaries or not.
template <typename XT>
static int launch_hxt_mma(const void* X, const float* H, int g, int n, int K, int GB,
                          int n_split, int cells_per_split, int S, int CW,
                          __nv_bfloat16* Hb, float* part, cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(X) & 15) == 0 && (size_t)n * sizeof(XT) % 16 == 0;
  void (*kernel)(const XT*, const __nv_bfloat16*, int, int, int, int, int, int, int, float*) =
      CW == 128 ? (aligned ? hxt_mma<XT, 128, true> : hxt_mma<XT, 128, false>)
                : (aligned ? hxt_mma<XT, 64, true> : hxt_mma<XT, 64, false>);
  const int Kp = pad16(K), gcols = GB / 16;
  const size_t smem = hxt_mma_smem_bytes(K, GB, S, CW, sizeof(XT) == 1);
  const bool ok = K >= 1 && GB % 16 == 0 &&
                  GB <= 128 && kWarps % gcols == 0 &&
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
  err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g + GB - 1) / GB, n_split);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const XT*>(X), Hb, g, n, n_pad, K, GB,
                                           cells_per_split, S, part);
  return (int)cudaGetLastError();
}

// ---- wtx -----------------------------------------------------------------

// ldmatrix: four 8 x 8 matrices of b16 from shared memory into r[0..3]; lane
// i gives the address of row i % 8 of matrix i / 8 (16 bytes).  Lane l gets
// row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1 of each matrix, or with
// .trans column l / 4, rows 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Bytes 0 and 2 of v, int8 values, widened exactly to one bf16x2 register:
// a byte b gives the bf16 bits 0x4300 | (b & 0x7f), the value
// 128 + (b & 0x7f), and 0x4300 | (b & 0x80), 128 or 256; their difference
// is b as a signed value, exact in bf16.
__device__ __forceinline__ unsigned widen_i8_halves(unsigned v) {
  const unsigned m = (v & 0x007F007Fu) | 0x43004300u, s = (v & 0x00800080u) | 0x43004300u;
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(m), "r"(s));
  return d;
}

// A register of int8 X from ldmatrix.trans over b16 pairs of cells: bytes
// x(k, c), x(k, c + 1), x(k + 1, c), x(k + 1, c + 1) for genes k, k + 1 and
// cells c, c + 1.  Widened into the bf16x2 B registers of cell c,
// {x(k, c), x(k + 1, c)}, and of cell c + 1.
__device__ __forceinline__ void widen_cell_pairs(unsigned r, unsigned& even, unsigned& odd) {
  even = widen_i8_halves(r);
  odd = widen_i8_halves(r >> 8);
}

// Bytes of a staged row of `data` bytes (a multiple of 16) that ldmatrix
// reads 8 rows at a time: rows start an odd multiple of 16 bytes apart
// modulo 128, so the 8 rows of a matrix fall in distinct banks.
__host__ __device__ constexpr int ldsm_row_bytes(int data) {
  return data / 16 % 2 ? data : data + 16;
}

// Bytes of a staged X row of wtx's bf16 path: T cells as stored and 16
// more (the aligned window of a row off 16-byte alignment).
__host__ __device__ constexpr int wtx_x_row_bytes(int T, bool int8) {
  return ldsm_row_bytes((int8 ? T : 2 * T) + 16);
}

// Shared memory of wtx's bf16 path: a ring of S stages, each a chunk of GC
// genes (32 or 64) of Wb (Kp rows) and of X's rows.
// ops/kernels.py:wtx_smem_bytes holds the same formula.
__host__ __device__ inline size_t wtx_mma_smem_bytes(int K, int T, int S, int GC, bool int8) {
  return (size_t)S * ((size_t)pad16(K) * ldsm_row_bytes(2 * GC) +
                      (size_t)GC * wtx_x_row_bytes(T, int8));
}

// Wb[k][gi] = bf16(W[gi][k]) for k < K and gi < g, 0 elsewhere in its
// Kp x g_pad: W transposed and rounded once a call (wtx_mma reads it as it
// is, so rows past K and genes past g multiply as zeros).  One thread an
// 8-gene vector of a row.
__global__ void __launch_bounds__(kThreads)
round_w(const float* __restrict__ W, int g, int K, int Kp, int g_pad,
        __nv_bfloat16* __restrict__ Wb) {
  const int vpr = g_pad / 8;
  const size_t q = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (q >= (size_t)Kp * vpr) return;
  const int k = (int)(q / vpr), g0 = (int)(q - (size_t)k * vpr) * 8;
  float v[8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
    v[u] = (k < K && g0 + u < g) ? __ldg(W + (size_t)(g0 + u) * K + k) : 0.f;
  __nv_bfloat16 r[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) r[u] = __float2bfloat16_rn(v[u]);
  *reinterpret_cast<uint4*>(Wb + (size_t)k * g_pad + g0) = *reinterpret_cast<const uint4*>(r);
}

// out[k][c] = sum over genes gi of Wb[k][gi] X[gi][c] for the T cells of
// this block's tile, on the tensor cores, in one pass over X.  The grid is
// tiles x gene ranges: with one range a block writes its outputs; with
// more, each block writes the sums over its range's genes as a partial and
// the last block of the tile to finish adds the partials in range order.
//
// The genes flow in chunks of GC (32 or 64) through a ring of S stages
// filled by cp.async (the chunk's Kp rows of Wb and its X rows as stored),
// S - 1 chunks ahead of the one being multiplied, one barrier a chunk.  The
// 8 warps are WR rows x (8 / WR) columns: warp (wr, wc) holds the 16-row
// fragments wr, wr + WR, ... of the output (at most MF) over NT groups of
// 16 cells, and multiplies straight from the ring with mma.sync m16n8k16:
// A (Wb) by ldmatrix, B (X, gene-major: the transpose of the .col operand
// mma.sync takes) by ldmatrix.trans.  bf16 X: one x4.trans gives both
// 8-cell tiles of a group for one k16 step.  int8 X: one x4.trans reads
// adjacent cells as one b16 element, 32 genes x 16 cells, and
// widen_cell_pairs splits each register into the operands of the even and
// of the odd cells, so n-tile 0 holds cells 2j and n-tile 1 cells 2j + 1 of
// the group; the epilogue puts them back in order.  Genes run in the same
// order on every path (chunks, then k16 steps, 16 genes a product).  X
// rows off 16-byte alignment are staged as aligned windows, where
// ldmatrix.trans cannot read them: each lane builds the same B registers
// from byte (int8) or 2-byte (bf16) shared loads at each row's offset, so
// the bits do not depend on X's alignment.  (Copying the rows into place
// in shared memory first, for ldmatrix, was within 6 % on int8 X and
// 16-19 % slower on bf16 X: PERF.md.)
template <typename XT, int NT, bool kAligned>
__global__ void __launch_bounds__(kThreads, 2)
wtx_mma(const XT* __restrict__ X, const __nv_bfloat16* __restrict__ Wb, int g, int n,
        int g_pad, int K, int T, int WR, int GC, int S, int range_genes,
        float* __restrict__ part, unsigned* __restrict__ arrivals, float* __restrict__ out) {
  constexpr bool kInt8 = sizeof(XT) == 1;
  constexpr int V = 16 / sizeof(XT);        // values of a 16-byte copy
  constexpr int MF = kWtxAcc / (8 * NT);    // fragment rows a warp holds
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * T, range = blockIdx.y, ranges = gridDim.y;
  const int Kp = pad16(K), RF = Kp / 16;
  const int WB = ldsm_row_bytes(2 * GC), XR = wtx_x_row_bytes(T, kInt8);
  const int wv_shift = GC == 64 ? 3 : 2;  // log2 of Wb's 16-byte copies a row
  const int w_bytes = Kp * WB, stage_bytes = w_bytes + GC * XR;
  // this block's gene range: chunks chunk0 .. chunk0 + n_chunks - 1
  const int chunk0 = range * (range_genes / GC);
  const int n_chunks = min(g_pad / GC - chunk0, range_genes / GC);
  const CopyWalk walk0(tid, T / V + (kAligned ? 0 : 1));  // 16-byte copies an X row

  // chunk c's copies into stage st; one group committed, empty past the range
  auto issue = [&](int c, int st) {
    if (c < n_chunks) {
      const int g0 = (chunk0 + c) * GC;
      unsigned char* w = smem + st * stage_bytes;
      for (int q = tid; q < Kp << wv_shift; q += kThreads) {
        const int k = q >> wv_shift, j = (q - (k << wv_shift)) * 8;
        cp_async16(w + k * WB + j * 2, Wb + (size_t)k * g_pad + g0 + j, true);
      }
      unsigned char* x = w + w_bytes;
      for (CopyWalk cp = walk0; cp.row < GC; cp.next()) {
        bool ok;
        const void* src;
        if constexpr (kAligned) {  // n is a multiple of V: a copy is valid or zero as a whole
          ok = g0 + cp.row < g && c0 + cp.copy * V < n;
          src = X + (size_t)(g0 + cp.row) * n + c0 + cp.copy * V;
        } else {
          ok = false;
          src = g0 + cp.row < g ? window_src(X, g0 + cp.row, n, c0, cp.copy, ok) : X;
        }
        cp_async16(x + cp.row * XR + 16 * cp.copy, ok ? src : X, ok);
      }
    }
    cp_async_commit();
  };

  const int WC = kWarps / WR, wr = warp / WC;
  const int cw = (warp % WC) * NT * 16;  // the warp's first cell in the tile
  float acc[MF][NT][2][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[f][nt][h][i] = 0.f;
  for (int c = 0; c < S - 1; ++c) issue(c, c);
  int st = 0;  // stage of chunk c
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait(S - 2);  // chunk c (this thread's copies)
    // chunk c has landed; every warp is done with chunk c - 1, whose stage
    // the next copies refill
    __syncthreads();
    issue(c + S - 1, st == 0 ? S - 1 : st - 1);
    const unsigned char* w = smem + st * stage_bytes;
    const unsigned char* x = w + w_bytes;
    const int gx = (chunk0 + c) * GC;  // the chunk's first gene
#pragma unroll 1
    for (int g32 = 0; g32 < GC; g32 += 32) {  // 32 genes: two k16 steps
      unsigned b[NT][2][2][2];  // [group][k16 step][n-tile][b0, b1]
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if constexpr (kInt8) {
          unsigned r[4];  // genes 8m .. 8m + 7 in r[m]
          if constexpr (kAligned) {
            ldsm_x4_trans(r, x + (g32 + lane) * XR + cw + nt * 16);
          } else {  // what ldmatrix.trans gives, from the rows at their offsets
            const int c = cw + nt * 16 + 2 * (lane >> 2);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int ga = g32 + 8 * m + 2 * (lane & 3);
              const unsigned char* pa = x + ga * XR + row_offset(X, gx + ga, n) + c;
              const unsigned char* pb = x + (ga + 1) * XR + row_offset(X, gx + ga + 1, n) + c;
              r[m] = (unsigned)pa[0] | (unsigned)pa[1] << 8 | (unsigned)pb[0] << 16 |
                     (unsigned)pb[1] << 24;
            }
          }
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              widen_cell_pairs(r[2 * ks + q], b[nt][ks][0][q], b[nt][ks][1][q]);
        } else {
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            unsigned r[4];  // (genes 0-7, 8-15) x (cells 0-7), then cells 8-15
            if constexpr (kAligned) {
              ldsm_x4_trans(r, x + (g32 + ks * 16 + (lane & 15)) * XR +
                                   (cw + nt * 16 + (lane >> 4) * 8) * 2);
            } else {  // what ldmatrix.trans gives, from the rows at their offsets
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                const int ga = g32 + ks * 16 + 8 * (m & 1) + 2 * (lane & 3);
                const int c = cw + nt * 16 + 8 * (m >> 1) + (lane >> 2);
                const unsigned lo = *reinterpret_cast<const unsigned short*>(
                    x + ga * XR + row_offset(X, gx + ga, n) + 2 * c);
                const unsigned hi = *reinterpret_cast<const unsigned short*>(
                    x + (ga + 1) * XR + row_offset(X, gx + ga + 1, n) + 2 * c);
                r[m] = lo | hi << 16;
              }
            }
            b[nt][ks][0][0] = r[0], b[nt][ks][0][1] = r[1];
            b[nt][ks][1][0] = r[2], b[nt][ks][1][1] = r[3];
          }
        }
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          const int rf = wr + f * WR;
          if (rf < RF) {  // warp-uniform
            unsigned a[4];
            ldsm_x4(a, w + (rf * 16 + (lane & 15)) * WB + (g32 + ks * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                mma_bf16_16816(acc[f][nt][h], a, b[nt][ks][h][0], b[nt][ks][h][1]);
          }
        }
      }
    }
    st = st + 1 == S ? 0 : st + 1;
  }
  cp_async_wait(0);
  // each lane writes rows gq and gq + 8 of its fragments: four consecutive
  // cells of a group (int8: even and odd n-tiles interleaved) or two pairs
  // (bf16: n-tiles of cells 0-7 and 8-15), whole 32-byte sectors a warp;
  // into out, or into its range's partial
  const int gq = lane / 4, t = lane % 4;
  float* dst = ranges == 1 ? out : part + (size_t)range * K * n;
  const bool vec = (reinterpret_cast<uintptr_t>(dst) & 15) == 0 && n % (kInt8 ? 4 : 2) == 0;
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    const int rf = wr + f * WR;
    if (rf >= RF) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int k = rf * 16 + gq + 8 * hr;
      if (k >= K) continue;
      float* o = dst + (size_t)k * n;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // acc[f][nt][h][2 hr + j]: n-tile h, column 2t + j of row k
        if constexpr (kInt8) {
          const int cc = c0 + cw + nt * 16 + 4 * t;  // even, odd, even, odd
          const float v[4] = {acc[f][nt][0][2 * hr], acc[f][nt][1][2 * hr],
                              acc[f][nt][0][2 * hr + 1], acc[f][nt][1][2 * hr + 1]};
          if (vec && cc + 3 < n) {
            *reinterpret_cast<float4*>(o + cc) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (cc + u < n) o[cc + u] = v[u];
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cc = c0 + cw + nt * 16 + 8 * h + 2 * t;
            const float v0 = acc[f][nt][h][2 * hr], v1 = acc[f][nt][h][2 * hr + 1];
            if (vec && cc + 1 < n) {
              *reinterpret_cast<float2*>(o + cc) = make_float2(v0, v1);
            } else {
              if (cc < n) o[cc] = v0;
              if (cc + 1 < n) o[cc + 1] = v1;
            }
          }
        }
      }
    }
  }
  if (ranges == 1) return;
  __syncthreads();  // the ring is free: its first word holds the arrival flag
  if (!last_to_arrive(arrivals, blockIdx.x, ranges, reinterpret_cast<volatile int*>(smem)))
    return;
  const int cells = min(T, n - c0);
  for (int o = tid; o < K * cells; o += kThreads) {
    const int k = o / cells;
    const size_t idx = (size_t)k * n + c0 + (o - k * cells);
    float s = 0.f;
    for (int r = 0; r < ranges; ++r) s += __ldcg(part + (size_t)r * K * n + idx);
    out[idx] = s;
  }
}

// The bf16 path (K <= 512: all of K a block; above, wtx_wide): W rounded
// and transposed into Wb (Kp x g_pad, g_pad a multiple of the gene chunk
// GC), then wtx_mma over tiles of T cells x `ranges` gene ranges of
// `range_genes` genes (a multiple of GC), with the warps as WR rows x
// (8 / WR) columns of NT groups of 16 cells, S stages of GC genes; with
// more than one gene range, `part` holds their partials (ranges x K x n)
// and `arrivals` one zeroed counter a tile.
template <typename XT>
static int launch_wtx_mma(const void* X, const float* W, int g, int n, int K, int T,
                          int WR, int GC, int S, int ranges, int range_genes,
                          __nv_bfloat16* Wb, float* part, unsigned* arrivals, float* out,
                          cudaStream_t stream) {
  const int WC = (WR >= 1 && kWarps % WR == 0) ? kWarps / WR : 0;
  const int NT = (WC && T % (16 * WC) == 0) ? T / (16 * WC) : 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(X) & 15) == 0 && (size_t)n * sizeof(XT) % 16 == 0;
  void (*kernel)(const XT*, const __nv_bfloat16*, int, int, int, int, int, int, int, int, int,
                 float*, unsigned*, float*) =
      NT == 1   ? (aligned ? wtx_mma<XT, 1, true> : wtx_mma<XT, 1, false>)
      : NT == 2 ? (aligned ? wtx_mma<XT, 2, true> : wtx_mma<XT, 2, false>)
      : NT == 3 ? (aligned ? wtx_mma<XT, 3, true> : wtx_mma<XT, 3, false>) : nullptr;
  const int Kp = pad16(K), MF = NT ? kWtxAcc / (8 * NT) : 0;
  const size_t smem = wtx_mma_smem_bytes(K, T, S, GC, sizeof(XT) == 1);
  const int g_pad = (g + GC - 1) / GC * GC;
  const bool ok = kernel != nullptr && K >= 1 &&
                  (Kp / 16 + WR - 1) / WR <= MF &&
                  S >= 2 && S <= 8 && (GC == 32 || GC == 64) && Wb != nullptr &&
                  ranges >= 1 &&
                  range_genes >= GC && range_genes % GC == 0 &&
                  (size_t)(ranges - 1) * range_genes < (size_t)g_pad &&
                  (size_t)ranges * range_genes >= (size_t)g_pad &&
                  (ranges == 1 || (part != nullptr && arrivals != nullptr));
  if (!ok || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const size_t vecs = (size_t)pad16(K) * (g_pad / 8);
  if (vecs > 0) {
    round_w<<<(unsigned)((vecs + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        W, g, K, pad16(K), g_pad, Wb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + T - 1) / T, ranges);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const XT*>(X), Wb, g, n, g_pad, K, T,
                                           WR, GC, S, range_genes, part, arrivals, out);
  return (int)cudaGetLastError();
}

}  // namespace alpine

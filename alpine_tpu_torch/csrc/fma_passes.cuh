// The fp32 X passes (float32 and int16 X), shared by two libraries:
//   hxt_fma: part[split][k][gi] = sum over a split's cells c of H[k][c] X[gi][c];
//   wtx_fma: out[k][c] = sum over genes gi of W[gi][k] X[gi][c].
// x_passes.cu runs them as ALS's P1 and P2 (hxt, wtx); fused_iteration.cu
// runs them as the two X products of its float32/int16 path (K1, K2, K4).
// Grids: ops/kernels.py:hxt_fma_grid, wtx_fma_grid.  K <= 512: a thread's
// rows hold all of K; above, fma_wide.cuh's kernels take both passes.
//
// Bound on the H100: X's bytes and the fp32 FMA rate alike (float32 X at
// 100k cells x 2000 genes, K = 40: 816 MB, 16 GFLOP a pass).
//
// Also here: the row-alignment test of both sources (the cp.async helpers
// of every ring are in common.cuh) and reduce_partials, the last launch of
// fused_iteration.cu's chain and of x_passes.cu's large-K one.
#pragma once

#include "common.cuh"

namespace alpine {

// True when every row of a (rows, n) array of T at p starts 16-byte aligned.
template <typename T>
__host__ __device__ __forceinline__ bool rows_aligned16(const T* p, int n) {
  return ((size_t)n * sizeof(T)) % 16 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---- the fp32 paths (float32 and int16 X) --------------------------------
//
// True fp32 (no TF32: matmul_precision="highest"), so the products run on
// the FP32 units.  Both kernels stream X as stored, and the operand it
// meets (H, W) as stored, through a ring of S stages filled by cp.async,
// S - 1 chunks ahead, one barrier a chunk; each thread keeps a micro-tile
// of outputs in registers and feeds every value it reads from shared
// memory to several FMAs.  int16 X is widened once a block, on its way
// from the ring into an fp32 tile (widen_i16x4: exact, no I2F), behind a
// second barrier.  Rows off 16-byte alignment are staged element by element
// into the same slots, so the bits do not depend on alignment.

constexpr int kFmaMG = 8;            // hxt: genes a thread
constexpr int kFmaMaxMK = 7;         // hxt: rows of H a thread (8 only at K > 448)
constexpr int kWtxGC = 32;           // wtx: genes a ring stage
constexpr int kWtxCells = 12;        // wtx: cells a thread (three 16-byte vectors)
constexpr int kWtxMaxMK = 6;         // wtx: rows of W a thread at most

// Four int16 values (two words) widened exactly to fp32: a byte permute
// makes the fp32 bits 2^23 + (x + 32768) and one subtraction gives x.
__device__ __forceinline__ float4 widen_i16x4(uint2 v) {
  const unsigned a = v.x ^ 0x80008000u, b = v.y ^ 0x80008000u;
  return make_float4(__uint_as_float(__byte_perm(a, 0x4B000000u, 0x7410)) - 8421376.f,
                     __uint_as_float(__byte_perm(a, 0x4B000000u, 0x7432)) - 8421376.f,
                     __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7410)) - 8421376.f,
                     __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7432)) - 8421376.f);
}

// hxt's fp32 layout: warps in WK rows along K (the fewest, up to 8, that
// keep a thread at <= kFmaMaxMK rows; 8 rows only at WK = 8, K > 448), a
// warp's lanes 8 along K x 4 along genes, MK = ceil(K / (8 WK)) rows a
// thread.  ops/kernels.py:hxt_fma_rows holds the same rule.
__host__ __device__ inline int hxt_fma_wk(int K) {
  int wk = 1;
  while (wk < kWarps && (K + 8 * wk - 1) / (8 * wk) > kFmaMaxMK) wk *= 2;
  return wk;
}

// Floats of a staged fp32 row of CW (32 or 64) cells: rows start 16 bytes
// apart modulo 128.
__host__ __device__ constexpr int hxt_fma_row(int CW) { return CW + 4; }

// Shared memory of hxt's fp32 path: S stages of a chunk of CW cells of H
// (Kp rows) and of X's GB rows (fp32 rows padded to hxt_fma_row, int16
// rows as stored), the int16 chunk widened (GB x hxt_fma_row fp32), and at
// the end the Q warp tiles (Q x Kp x (GB + 4) fp32) that reuse the bytes.
// ops/kernels.py:hxt_fma_smem_bytes holds the same formula.
__host__ __device__ inline size_t hxt_fma_smem_bytes(int K, int GB, int S, int CW, bool int16) {
  const int WK = hxt_fma_wk(K), MK = (K + 8 * WK - 1) / (8 * WK), Kp = 8 * WK * MK;
  const int Q = kWarps / (WK * (GB / 32));
  const int RW = hxt_fma_row(CW);
  const size_t stage = (size_t)Kp * RW * 4 + (size_t)GB * (int16 ? 2 * CW : 4 * RW);
  const size_t ring = S * stage + (int16 ? (size_t)GB * RW * 4 : 0);
  const size_t red = (size_t)Q * Kp * (GB + 4) * 4;
  return ring > red ? ring : red;
}

// part[split][k][gi] = sum over the split's cells c of H[k][c] X[gi][c] for
// the GB = 32 WG genes of this block, on the FP32 units, in one pass over X.
//
// The 8 warps are Q (cell groups) x WK (rows) x WG (32-gene columns).  Lane
// (tk, tg) = (lane % 8, lane / 8) of warp (q, wk, wg) holds the MK x 8
// outputs of rows wk 8 MK + tk + 8 i and genes wg 32 + tg + 4 j: for every
// 4 cells it reads 8 float4 of X and MK of H and does 32 MK FMAs.  The 4
// lanes of a row read its float4 as a broadcast, the 8 of a gene likewise,
// and rows start 16 bytes apart modulo 128, so a warp's load touches each
// bank once.  Warp q takes cells q CW / Q .. (q + 1) CW / Q - 1 of every
// chunk, in order; at the end the Q warp tiles are added in q order.  A
// thread of 8 rows (K > 448) takes an SM's registers alone.
template <typename XT, int MK>
__global__ void __launch_bounds__(kThreads, MK > kFmaMaxMK ? 1 : 2)
hxt_fma(const XT* __restrict__ X, const float* __restrict__ H, int g, int n, int K, int GB,
        int cells_per_split, int S, int CW, float* __restrict__ part) {
  constexpr bool kI16 = sizeof(XT) == 2;
  constexpr int V = 16 / sizeof(XT);  // values of a 16-byte copy
  const int RW = hxt_fma_row(CW);
  const int cs = CW == 64 ? 4 : 3;   // log2 of the 16-byte copies of a row of H
  const int xs = kI16 ? cs - 1 : cs;  // and of an X row as stored
  const int XRB = kI16 ? 2 * CW : 4 * RW;  // bytes of a staged X row
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int WK = hxt_fma_wk(K), WG = GB / 32, Q = kWarps / (WK * WG), Kp = 8 * WK * MK;
  const int g0 = blockIdx.x * GB, split = blockIdx.y;
  const int cbeg = split * cells_per_split;
  const int n_chunks = (min(n, cbeg + cells_per_split) - cbeg + CW - 1) >> (cs + 2);
  const int h_bytes = Kp * RW * 4, stage_bytes = h_bytes + GB * XRB;
  float* sXf = reinterpret_cast<float*>(smem + (size_t)S * stage_bytes);  // int16: widened
  const bool vec = rows_aligned16(X, n) && rows_aligned16(H, n);
  // H's rows K .. Kp - 1 are never copied: zero in every stage
  for (int st = 0; st < S; ++st)
    for (int o = tid; o < (Kp - K) * RW; o += kThreads)
      reinterpret_cast<float*>(smem + st * stage_bytes)[K * RW + o] = 0.f;

  // chunk c's copies into stage st; one group committed, empty past the split
  auto issue = [&](int c, int st) {
    if (c < n_chunks) {
      const int c0 = cbeg + c * CW;
      float* h = reinterpret_cast<float*>(smem + st * stage_bytes);
      unsigned char* x = smem + st * stage_bytes + h_bytes;
      if (vec) {  // n is a multiple of V here: a vector is valid or zero as a whole
        for (int q = tid; q < K << cs; q += kThreads) {
          const int k = q >> cs, j = (q & ((1 << cs) - 1)) * 4;
          const bool ok = c0 + j < n;
          cp_async16(h + k * RW + j, ok ? H + (size_t)k * n + c0 + j : H, ok);
        }
        for (int q = tid; q < GB << xs; q += kThreads) {
          const int gg = q >> xs, j = (q & ((1 << xs) - 1)) * V;
          const bool ok = g0 + gg < g && c0 + j < n;
          cp_async16(x + gg * XRB + j * (int)sizeof(XT),
                     ok ? X + (size_t)(g0 + gg) * n + c0 + j : X, ok);
        }
      } else {  // the same values, element by element
        for (int e = tid; e < K * CW; e += kThreads) {
          const int k = e >> (cs + 2), t = e & (CW - 1);
          h[k * RW + t] = c0 + t < n ? H[(size_t)k * n + c0 + t] : 0.f;
        }
        for (int e = tid; e < GB * CW; e += kThreads) {
          const int gg = e >> (cs + 2), t = e & (CW - 1);
          reinterpret_cast<XT*>(x + gg * XRB)[t] =
              (g0 + gg < g && c0 + t < n) ? X[(size_t)(g0 + gg) * n + c0 + t] : XT(0);
        }
      }
    }
    cp_async_commit();
  };

  const int wg = warp % WG, wk = warp / WG % WK, q = warp / (WG * WK);
  const int tk = lane % 8, tg = lane / 8, CQ = CW / Q;
  float acc[MK][kFmaMG];
#pragma unroll
  for (int i = 0; i < MK; ++i)
#pragma unroll
    for (int j = 0; j < kFmaMG; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < S - 1; ++c) issue(c, c);
  int st = 0;  // stage of chunk c
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait(S - 2);  // chunk c (this thread's copies)
    // chunk c has landed; every warp is done with chunk c - 1, whose stage
    // the next copies refill (and, for int16, with the widened tile)
    __syncthreads();
    issue(c + S - 1, st == 0 ? S - 1 : st - 1);
    const float* h = reinterpret_cast<const float*>(smem + st * stage_bytes);
    const float* x;
    if constexpr (kI16) {
      const unsigned char* raw = smem + st * stage_bytes + h_bytes;
      for (int v = tid; v < GB << cs; v += kThreads) {
        const int gg = v >> cs, j = (v & ((1 << cs) - 1)) * 4;
        *reinterpret_cast<float4*>(sXf + gg * RW + j) =
            widen_i16x4(*reinterpret_cast<const uint2*>(raw + gg * XRB + j * 2));
      }
      __syncthreads();
      x = sXf;
    } else {
      x = reinterpret_cast<const float*>(smem + st * stage_bytes + h_bytes);
    }
    const float* hr = h + (wk * 8 * MK + tk) * RW;
    const float* xr = x + (wg * 32 + tg) * RW;
    for (int c4 = q * CQ; c4 < (q + 1) * CQ; c4 += 4) {
      float4 hv[MK];
#pragma unroll
      for (int i = 0; i < MK; ++i)
        hv[i] = *reinterpret_cast<const float4*>(hr + 8 * i * RW + c4);
#pragma unroll
      for (int j = 0; j < kFmaMG; ++j) {
        const float4 x4 = *reinterpret_cast<const float4*>(xr + 4 * j * RW + c4);
#pragma unroll
        for (int i = 0; i < MK; ++i) {
          float a = acc[i][j];
          a = fmaf(hv[i].x, x4.x, a);
          a = fmaf(hv[i].y, x4.y, a);
          a = fmaf(hv[i].z, x4.z, a);
          acc[i][j] = fmaf(hv[i].w, x4.w, a);
        }
      }
    }
    st = st + 1 == S ? 0 : st + 1;
  }
  cp_async_wait(0);
  __syncthreads();  // every warp is done with the ring
  float* red = reinterpret_cast<float*>(smem);  // Q x Kp x LO
  const int LO = GB + 4;
#pragma unroll
  for (int i = 0; i < MK; ++i)
#pragma unroll
    for (int j = 0; j < kFmaMG; ++j)
      red[(q * Kp + wk * 8 * MK + tk + 8 * i) * LO + wg * 32 + tg + 4 * j] = acc[i][j];
  __syncthreads();
  for (int o = tid; o < K * GB; o += kThreads) {
    const int k = o / GB, gg = o - k * GB;
    if (g0 + gg < g) {
      float s = red[k * LO + gg];
      for (int qq = 1; qq < Q; ++qq) s += red[(qq * Kp + k) * LO + gg];
      part[((size_t)split * K + k) * g + g0 + gg] = s;
    }
  }
}

// hxt_fma<XT, MK> for MK = 1 .. kFmaMaxMK + 1, or nullptr.
template <typename XT>
using HxtFmaFn = void (*)(const XT*, const float*, int, int, int, int, int, int, int, float*);

template <typename XT>
static HxtFmaFn<XT> hxt_fma_kernel(int MK) {
  switch (MK) {
    case 1: return hxt_fma<XT, 1>;
    case 2: return hxt_fma<XT, 2>;
    case 3: return hxt_fma<XT, 3>;
    case 4: return hxt_fma<XT, 4>;
    case 5: return hxt_fma<XT, 5>;
    case 6: return hxt_fma<XT, 6>;
    case 7: return hxt_fma<XT, 7>;
    case 8: return hxt_fma<XT, 8>;
    default: return nullptr;
  }
}

// The fp32 path: hxt_fma over a grid of (gene block of GB = 32 WG genes) x
// (cell split), S ring stages of CW cells; ops/kernels.py:hxt_fma_grid.
template <typename XT>
static int launch_hxt_fma(const void* X, const float* H, int g, int n, int K, int GB,
                          int n_split, int cells_per_split, int S, int CW, float* part,
                          cudaStream_t stream) {
  const int WG = GB / 32;
  if (K < 1 || GB % 32 != 0 || WG < 1 || (CW != 32 && CW != 64) || S < 2 || S > 8 ||
      cells_per_split % CW != 0)
    return (int)cudaErrorInvalidValue;
  const int WK = hxt_fma_wk(K), MK = (K + 8 * WK - 1) / (8 * WK);
  const HxtFmaFn<XT> kernel = hxt_fma_kernel<XT>(MK);
  if (kernel == nullptr || kWarps % (WK * WG) != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = hxt_fma_smem_bytes(K, GB, S, CW, sizeof(XT) == 2);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g + GB - 1) / GB, n_split);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const XT*>(X), H, g, n, K, GB,
                                           cells_per_split, S, CW, part);
  return (int)cudaGetLastError();
}

// wtx's fp32 layout for K components and LK lanes along K (the rest of a
// warp's 32 lanes along cells): warps in WK rows along K (the fewest, up to
// 8, that keep a thread at <= kWtxMaxMK rows), MK = ceil(K / (LK WK)) rows
// a thread, the other 8 / WK warps (Q) splitting each chunk's genes.
// ops/kernels.py:wtx_fma_rows holds the same rule.
__host__ __device__ inline int wtx_fma_wk(int K, int LK) {
  int wk = 1;
  while (wk < kWarps && (K + LK * wk - 1) / (LK * wk) > kWtxMaxMK) wk *= 2;
  return wk;
}

// Shared memory of wtx's fp32 path: S stages of a chunk of kWtxGC genes of
// W (its GC x K values as stored, room for GC x Kp) and of X's rows (T cells
// as stored), the int16 chunk widened (GC x T fp32), and at the end the Q
// warp tiles (Q x Kp x T fp32) when Q > 1.  ops/kernels.py:wtx_fma_smem_bytes
// holds the same formula.
__host__ __device__ inline size_t wtx_fma_smem_bytes(int K, int LK, int S, bool int16) {
  const int WK = wtx_fma_wk(K, LK), MK = (K + LK * WK - 1) / (LK * WK);
  const int Kp = WK * LK * MK, Q = kWarps / WK, T = 32 / LK * kWtxCells;
  const size_t stage = (size_t)kWtxGC * Kp * 4 + (size_t)kWtxGC * T * (int16 ? 2 : 4);
  const size_t ring = S * stage + (int16 ? (size_t)kWtxGC * T * 4 : 0);
  const size_t red = Q > 1 ? (size_t)Q * Kp * T * 4 : 0;
  return ring > red ? ring : red;
}

// out[k][c] = sum over genes gi of W[gi][k] X[gi][c] for the T = 12 (32 /
// LK) cells of this block, on the FP32 units, in one pass over X.
//
// The genes flow in chunks of kWtxGC through a ring of S stages (W's rows
// and X's rows as stored).  The 8 warps are Q (gene groups) x WK (rows);
// lane (lk, lc) = (lane % LK, lane / LK) of warp (q, wk) holds the MK x 12
// outputs of rows (wk LK + lk) MK + i and cells 4 lc + 4 (32 / LK) v + u
// (v < 3, u < 4): for every gene it reads three float4 of X (consecutive
// lanes, consecutive 16 bytes) and MK values of W (a broadcast to the
// lanes of a row) and does 12 MK FMAs.  Warp q takes genes q GC / Q ..
// (q + 1) GC / Q - 1 of every chunk, in order; with Q > 1 the warp tiles
// are added in q order at the end.  Each output is written once.
template <typename XT, int MK>
__global__ void __launch_bounds__(kThreads, 2)
wtx_fma(const XT* __restrict__ X, const float* __restrict__ W, int g, int n, int K, int LK,
        int S, float* __restrict__ out) {
  constexpr bool kI16 = sizeof(XT) == 2;
  constexpr int V = 16 / sizeof(XT);  // values of a 16-byte copy
  constexpr int GC = kWtxGC;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int WK = wtx_fma_wk(K, LK), Q = kWarps / WK, Kp = WK * LK * MK;
  const int LC = 32 / LK, T = LC * kWtxCells;
  const int c0 = blockIdx.x * T;
  const int w_bytes = GC * Kp * 4, XRB = T * (int)sizeof(XT);
  const int stage_bytes = w_bytes + GC * XRB;
  float* sXf = reinterpret_cast<float*>(smem + (size_t)S * stage_bytes);  // int16: widened
  const int n_chunks = (g + GC - 1) / GC, xv = T / V;  // xv: 16-byte copies an X row
  const bool xvec = rows_aligned16(X, n);
  const bool wvec = (reinterpret_cast<uintptr_t>(W) & 15) == 0;

  // chunk c's copies into stage st; one group committed, empty past g
  auto issue = [&](int c, int st) {
    if (c < n_chunks) {
      const int g0 = c * GC, nw = min(GC, g - g0) * K;  // W values of the chunk
      float* w = reinterpret_cast<float*>(smem + st * stage_bytes);
      const float* wsrc = W + (size_t)g0 * K;  // 16-byte aligned with W (g0 K is a multiple of 16)
      for (int q = tid; q < GC * K / 4; q += kThreads) {
        const int e = 4 * q;
        if (wvec && e + 4 <= nw) {
          cp_async16(w + e, wsrc + e, true);
        } else {  // past g (zeros), or the same values element by element
#pragma unroll
          for (int u = 0; u < 4; ++u) w[e + u] = e + u < nw ? wsrc[e + u] : 0.f;
        }
      }
      unsigned char* x = smem + st * stage_bytes + w_bytes;
      if (xvec) {  // n is a multiple of V here: a vector is valid or zero as a whole
        for (int q = tid; q < GC * xv; q += kThreads) {
          const int gg = q / xv, j = (q - gg * xv) * V;
          const bool ok = g0 + gg < g && c0 + j < n;
          cp_async16(x + gg * XRB + j * (int)sizeof(XT),
                     ok ? X + (size_t)(g0 + gg) * n + c0 + j : X, ok);
        }
      } else {  // the same values, element by element
        for (int e = tid; e < GC * T; e += kThreads) {
          const int gg = e / T, t = e - gg * T;
          reinterpret_cast<XT*>(x + gg * XRB)[t] =
              (g0 + gg < g && c0 + t < n) ? X[(size_t)(g0 + gg) * n + c0 + t] : XT(0);
        }
      }
    }
    cp_async_commit();
  };

  const int wk = warp % WK, q = warp / WK, lk = lane % LK, lc = lane / LK;
  const int GQ = GC / Q, r0 = (wk * LK + lk) * MK;
  float acc[MK][kWtxCells];
#pragma unroll
  for (int i = 0; i < MK; ++i)
#pragma unroll
    for (int j = 0; j < kWtxCells; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < S - 1; ++c) issue(c, c);
  int st = 0;  // stage of chunk c
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait(S - 2);  // chunk c (this thread's copies)
    // chunk c has landed; every warp is done with chunk c - 1, whose stage
    // the next copies refill (and, for int16, with the widened tile)
    __syncthreads();
    issue(c + S - 1, st == 0 ? S - 1 : st - 1);
    const float* w = reinterpret_cast<const float*>(smem + st * stage_bytes);
    const float* x;
    if constexpr (kI16) {
      const unsigned char* raw = smem + st * stage_bytes + w_bytes;
      for (int v = tid; v < GC * T / 4; v += kThreads) {
        const int e = 4 * v;  // T is a multiple of 4: a vector lies in one row
        const int gg = e / T;
        *reinterpret_cast<float4*>(sXf + e) =
            widen_i16x4(*reinterpret_cast<const uint2*>(raw + gg * XRB + (e - gg * T) * 2));
      }
      __syncthreads();
      x = sXf;
    } else {
      x = reinterpret_cast<const float*>(smem + st * stage_bytes + w_bytes);
    }
    for (int gg = q * GQ; gg < (q + 1) * GQ; ++gg) {
      const float* xr = x + gg * T + 4 * lc;
      float4 xv4[3];
#pragma unroll
      for (int v = 0; v < 3; ++v) xv4[v] = *reinterpret_cast<const float4*>(xr + 4 * LC * v);
      // rows past K read other values of the stage: their outputs are never written
      const float* wr = w + gg * K + r0;
#pragma unroll
      for (int i = 0; i < MK; ++i) {
        const float a = wr[i];
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          acc[i][4 * v] = fmaf(a, xv4[v].x, acc[i][4 * v]);
          acc[i][4 * v + 1] = fmaf(a, xv4[v].y, acc[i][4 * v + 1]);
          acc[i][4 * v + 2] = fmaf(a, xv4[v].z, acc[i][4 * v + 2]);
          acc[i][4 * v + 3] = fmaf(a, xv4[v].w, acc[i][4 * v + 3]);
        }
      }
    }
    st = st + 1 == S ? 0 : st + 1;
  }
  cp_async_wait(0);
  if (Q == 1) {
    const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0 && n % 4 == 0;
#pragma unroll
    for (int i = 0; i < MK; ++i) {
      if (r0 + i >= K) continue;
      float* o = out + (size_t)(r0 + i) * n;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const int cc = c0 + 4 * lc + 4 * LC * v;
        if (vec && cc + 3 < n) {
          *reinterpret_cast<float4*>(o + cc) = make_float4(
              acc[i][4 * v], acc[i][4 * v + 1], acc[i][4 * v + 2], acc[i][4 * v + 3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (cc + u < n) o[cc + u] = acc[i][4 * v + u];
        }
      }
    }
    return;
  }
  __syncthreads();  // every warp is done with the ring
  float* red = reinterpret_cast<float*>(smem);  // Q x Kp x T
#pragma unroll
  for (int i = 0; i < MK; ++i)
#pragma unroll
    for (int v = 0; v < 3; ++v)
      *reinterpret_cast<float4*>(red + (size_t)(q * Kp + r0 + i) * T + 4 * lc + 4 * LC * v) =
          make_float4(acc[i][4 * v], acc[i][4 * v + 1], acc[i][4 * v + 2], acc[i][4 * v + 3]);
  __syncthreads();
  for (int o = tid; o < K * T; o += kThreads) {
    const int k = o / T, t = o - k * T;
    if (c0 + t < n) {
      float s = red[o];
      for (int qq = 1; qq < Q; ++qq) s += red[(size_t)(qq * Kp + k) * T + t];
      out[(size_t)k * n + c0 + t] = s;
    }
  }
}

// wtx_fma<XT, MK> for MK = 1 .. kWtxMaxMK, or nullptr.
template <typename XT>
using WtxFmaFn = void (*)(const XT*, const float*, int, int, int, int, int, float*);

template <typename XT>
static WtxFmaFn<XT> wtx_fma_kernel(int MK) {
  switch (MK) {
    case 1: return wtx_fma<XT, 1>;
    case 2: return wtx_fma<XT, 2>;
    case 3: return wtx_fma<XT, 3>;
    case 4: return wtx_fma<XT, 4>;
    case 5: return wtx_fma<XT, 5>;
    case 6: return wtx_fma<XT, 6>;
    default: return nullptr;
  }
}

// The fp32 path: wtx_fma over tiles of T = 12 (32 / LK) cells, S ring
// stages of kWtxGC genes; ops/kernels.py:wtx_fma_grid.
template <typename XT>
static int launch_wtx_fma(const void* X, const float* W, int g, int n, int K, int T, int LK,
                          int GC, int S, float* out, cudaStream_t stream) {
  const bool lk_ok = LK >= 1 && LK <= 16 && (LK & (LK - 1)) == 0 && K >= 1;
  const int WK = lk_ok ? wtx_fma_wk(K, LK) : 1;
  const int MK = lk_ok ? (K + LK * WK - 1) / (LK * WK) : 0;
  const WtxFmaFn<XT> kernel = wtx_fma_kernel<XT>(MK);
  const bool ok = kernel != nullptr && T == 32 / LK * kWtxCells && GC == kWtxGC && S >= 2 &&
                  S <= 8;
  if (!ok) return (int)cudaErrorInvalidValue;
  const size_t smem = wtx_fma_smem_bytes(K, LK, S, sizeof(XT) == 2);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + T - 1) / T, kThreads, smem, stream>>>(static_cast<const XT*>(X), W, g, n, K, LK,
                                                      S, out);
  return (int)cudaGetLastError();
}

// stats[j] = sum over blocks of part[b][j]; XHt[gi][k] = sum over splits of
// part_hxt[s][k][gi].  Fixed summation order: the same bits every run.
__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ part, int n_part, int S_len,
                float* __restrict__ stats, const float* __restrict__ part_hxt,
                int n_split, int K, int g, float* __restrict__ XHt) {
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < (size_t)S_len) {
    float s = 0.f;
    for (int b = 0; b < n_part; ++b) s += part[(size_t)b * S_len + idx];
    stats[idx] = s;
    return;
  }
  idx -= S_len;
  if (idx < (size_t)g * K) {
    const int gi = (int)(idx / K), k = (int)(idx - (size_t)gi * K);
    float s = 0.f;
    for (int sp = 0; sp < n_split; ++sp) s += part_hxt[((size_t)sp * K + k) * g + gi];
    XHt[idx] = s;
  }
}

}  // namespace alpine

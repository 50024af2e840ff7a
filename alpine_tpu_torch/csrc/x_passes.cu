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
// Design:
//  * hxt: a grid of (gene block of GB genes) x (cell split).  A block sums
//    its K x GB outputs over its split's cells and writes one partial; the
//    partials are added in split order by reduce_splits (no float atomics),
//    so two launches give the same bits.  (The last block of each gene
//    block summing the partials in the kernel instead cost more than the
//    second pass at every shape measured: PERF.md.)
//  * wtx: one block per tile of T cells, looping over all genes in chunks;
//    every output is written once, by the block of its cells.  Where the
//    tiles fill less than a wave (8,192 cells), the bf16 path splits the
//    genes into ranges and the last block of a tile adds the ranges'
//    partials in order.
//  * int8 and bf16 X compute in bf16 (kBf16) on the tensor cores (bf16
//    operands, fp32 accumulators), as the TPU kernels run them on its matrix
//    unit in one exact bf16 pass.  K is padded with zero rows to
//    Kp = pad16(K); the ragged cells and genes are zeroed.  Products are
//    exact and sums fp32: the plain version's result up to summation order.
//  * Both bf16 paths share one design: a pre-pass rounds the small operand
//    to bf16 once a call (round_h: Hb; round_w: Wb, W transposed), then the
//    kernel streams raw X chunks (as stored) and the rounded operand's
//    chunks through a ring of S shared-memory stages filled by cp.async and
//    multiplies straight from the ring with mma.sync m16n8k16, int8 widened
//    in registers.  Each grid is about one wave at two blocks an SM
//    (ops/kernels.py: hxt_grid, wtx_grid, wtx_gene_split).  X rows off
//    16-byte alignment (n · sizeof(X) not a multiple of 16, or X at an odd
//    address) go through the same ring as the 16-byte-aligned windows that
//    cover them; hxt reads a lane's cells at the row's offset with funnel
//    shifts, wtx builds the B registers ldmatrix.trans would give from
//    byte loads at the rows' offsets, so the values meet the same k slots
//    and the bits do not depend on X's alignment.
//    The max-shared-memory attribute is set once a kernel and size
//    (allow_smem), not every call: the host's time a call is what sets
//    these passes' times at 8,192 cells.
//  * hxt_mma reduces over cells, X's contiguous axis: a lane reads 8 cells
//    of a gene row and feeds them to the k slots of two k16 steps.  GB is
//    as wide as one pass of 4 fragments a warp allows (128 genes at
//    K <= 64), so few partials are written.  What holds it back is latency,
//    not bytes: two blocks of 8 warps an SM, a dependent chain of shared
//    loads and products a warp (PERF.md).
//  * wtx_mma reduces over genes, X's strided axis, so its B operand (genes x
//    cells) lies in the ring as the transpose of what mma.sync takes:
//    ldmatrix.trans reads it (int8: as b16 pairs of cells, split by a byte
//    permute into even and odd cells).  All of K is one pass over X: the
//    warps split the Kp x T outputs into fragment rows and 16-cell groups
//    under kWtxAcc accumulators a thread.
//  * float32 and int16 X run on the FP32 units (true fp32 under
//    matmul_precision="highest": no TF32), through the same kind of ring of
//    raw X and of H or W as stored; each thread keeps a micro-tile of
//    outputs in registers and feeds each value it reads from shared memory
//    to several FMAs (hxt_fma, wtx_fma in fma_passes.cuh, which
//    fused_iteration.cu shares; grids ops/kernels.py: hxt_fma_grid,
//    wtx_fma_grid).  At the bench shape a pass is bound by
//    X's bytes and the fp32 FMA rate alike (float32 X: 816 MB, 16 GFLOP).
//  * Any K: above 512 the int8/bf16 passes are hxt_wide and wtx_wide
//    (x_passes_wide.cuh: wgmma tiles of 256 rows of K fed by TMA), and the
//    fp32 passes hxt_fma_wide and wtx_fma_wide (fma_wide.cuh: 128 x 128
//    FP32 tiles on wtw_gemm's ring, all of K in one launch).
//
// Also here, because its X products are these passes: the large-K route of
// fused_iteration (K1, K2, K4 at K > 512; replaces alpine_tpu/ops/
// pallas_kernels.py:fused_iteration and fused_h_update where K > 512), one
// C call launching a chain: WᵀX (wtx_wide, or wtx_fma_wide) → D = WᵀW H
// (wtw_gemm.cuh, from WᵀW transposed into a K x K scratch) → iter_wide
// (the H update, Q and the loss rows) → X Hsᵀ (hxt_wide, or hxt_fma_wide) →
// gram_wide (gram_wide.cuh: H Hᵀ over the upper triangle, HHtU, rowsum
// and Bnum from one read of Hn) → the partials' sums.  Its bound at 100k cells x 2000 genes, K = 768, int8: the fp32
// (WᵀW)H and the upper triangle of Hn Hnᵀ, 177 GFLOP, 2.7 ms at 67 TFLOP/s
// (the bf16 X products 614 GFLOP, 0.62 ms; bytes 0.25 ms).
#include "fma_passes.cuh"
#include "fma_wide.cuh"
#include "wtw_gemm.cuh"

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

template <typename XT, bool kBf16>
static int launch_hxt(const void* X, const float* H, int g, int n, int K, int GB, int n_split,
                      int cells_per_split, int S, int CW,
                      __nv_bfloat16* Hb, float* part, float* out, cudaStream_t stream) {
  int rc;
  if constexpr (kBf16) {
    rc = launch_hxt_mma<XT>(X, H, g, n, K, GB, n_split, cells_per_split, S, CW, Hb, part,
                            stream);
  } else {
    rc = launch_hxt_fma<XT>(X, H, g, n, K, GB, n_split, cells_per_split, S, CW, part, stream);
  }
  if (rc != 0) return rc;
  const size_t total = (size_t)K * g;
  reduce_splits<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, n_split, K, g, out);
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

#include "x_passes_wide.cuh"
#include "gram_wide.cuh"

namespace alpine {

// ---- the large-K iteration (fused_iteration at K > 512) -------------------
//
// The K <= 512 kernel keeps a K x T tile a block and writes a K x K partial of
// H Hᵀ a block; neither holds at large K.  Here no kernel's shared memory
// grows with K: the X products are P1's and P2's large-K kernels (hxt_wide
// and wtx_wide on int8/bf16 X, the fp32 passes over their K ranges), the
// denominator's (WᵀW)H is wtw_gemm, the H update is iter_wide (a pass at
// the card's read rate over H, WᵀX and D), and every statistic over cells
// against Hn (H Hᵀ, HHtU, rowsum, Bnum) is gram_wide, from one read of Hn.

constexpr int kWideV = 4;             // cells a lane of iter_wide (one 16-byte load)
constexpr int kWideT = 32 * kWideV;   // cells a tile (ops/kernels.py:_WIDE_T)
constexpr int kWideLC = 8;            // labels a pass of iter_wide's sums over j

// iter_wide's shared memory in floats: Y and B H (then the loss terms)
// (L x 128 each), the warps' partial sums over j (8 x kWideLC x 128), the
// counts rows (2 x 128), a block reduction (kThreads), the prediction-loss
// rows (L, rounded up to 4) and, where it fits, Bg (L x Kg).
// ops/kernels.py:wide_smem_bytes holds the same formula.
__host__ __device__ inline size_t wide_smem_floats(int L, int Kg, bool counts, bool stage_bg) {
  const size_t labels = L > 0 ? 2 * (size_t)L * kWideT + (size_t)kWarps * kWideLC * kWideT : 0;
  return labels + (counts ? 2 * kWideT : 0) + kThreads + (size_t)(L + 3) / 4 * 4 +
         (stage_bg ? (size_t)L * Kg : 0);
}

// The sum of v over a warp, in a fixed order (lane 0's value is used).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The 4 cells cb .. cb + 3 of a row: one 16-byte load where rows are 16-byte
// aligned (n % 4 == 0: the 4 cells are all in or all past n), else element
// loads; zeros past n either way.
__device__ __forceinline__ void wide_ld4(const float* row, int cb, int n, bool vec, float* v) {
  if (vec) {
    if (cb < n) {
      const float4 t = *reinterpret_cast<const float4*>(row + cb);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kWideV; ++q) v[q] = cb + q < n ? row[cb + q] : 0.f;
  }
}

__device__ __forceinline__ void wide_st4(float* row, int cb, int n, bool vec, const float* v) {
  if (vec) {
    if (cb < n) *reinterpret_cast<float4*>(row + cb) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < kWideV; ++q)
      if (cb + q < n) row[cb + q] = v[q];
  }
}

// The label sums of a 128-cell tile over the guided rows of src (H, or Hn):
// warp w takes rows j = w, w + 8, ... < Kg in order and writes its partial
// sums of labels l0 .. l0 + nl - 1, sum over its j of Bg[l][j] src[j][cell],
// to sP[w][l][cell] (fmaf in order from 0).
__device__ __forceinline__ void wide_label_sums(const float* src, const float* sBg,
                                                const float* __restrict__ Bg, bool stage_bg,
                                                int n, int Kg, int l0, int nl, int cb,
                                                bool vec, float* sP) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[kWideLC][kWideV];
#pragma unroll
  for (int l = 0; l < kWideLC; ++l)
#pragma unroll
    for (int q = 0; q < kWideV; ++q) acc[l][q] = 0.f;
  for (int j = warp; j < Kg; j += kWarps) {
    float v[kWideV];
    wide_ld4(src + (size_t)j * n, cb, n, vec, v);
#pragma unroll
    for (int l = 0; l < kWideLC; ++l) {
      if (l < nl) {
        const size_t o = (size_t)(l0 + l) * Kg + j;
        const float b = stage_bg ? sBg[o] : __ldg(Bg + o);
#pragma unroll
        for (int q = 0; q < kWideV; ++q) acc[l][q] = fmaf(b, v[q], acc[l][q]);
      }
    }
  }
#pragma unroll
  for (int l = 0; l < kWideLC; ++l)
    if (l < nl)
      *reinterpret_cast<float4*>(sP + (warp * kWideLC + l) * kWideT + kWideV * lane) =
          make_float4(acc[l][0], acc[l][1], acc[l][2], acc[l][3]);
}

// The H update of 128-cell tiles (lane t: cells c0 + 4 t .. + 3) with the
// guided terms of every covariate through the block-embedded Bg (L x Kg,
// staged in shared memory where it fits); it writes Hn (and, in counts mode,
// Hs = c_next ⊙ Hn), Q (L x n: Y / max(Bg Hn, eps) for KL, Y otherwise, the
// next B update's ratio, read by gram_wide), and a partial a block: the
// prediction-loss rows (L) and the loss dot sum(WᵀX ⊙ Hn) (1).
//  * B H and ŷ = Bg Hn[:Kg]: every warp takes an eighth of the guided rows
//    for all labels of a pass (kWideLC), and the eight partials of each
//    (label, cell) are added in warp order through shared memory.
//  * The update: one row of K a warp pass, 16-byte loads of H, WᵀX and D
//    where rows are 16-byte aligned (else element loads: the same bits);
//    each element's num / den formed as iter_tiles forms it (sums over l
//    in order from 0, IEEE division).  Counts mode as in iter_tiles: a
//    column drawn 0 times keeps its H.
//  * A label's loss terms over a tile: a warp adds a lane's 4 cells in
//    order, then a warp tree, into the block's row in shared memory.  The
//    loss dot: each thread's terms in order, a block tree at the end.  The
//    block walks a run of tiles in order on a fixed grid, so the partials
//    sum in a fixed order.
template <typename YT, bool kCounts>
__global__ void __launch_bounds__(kThreads, 4)
iter_wide(const float* __restrict__ H, const float* __restrict__ WtX,
          const float* __restrict__ D, const YT* __restrict__ Y,
          const float* __restrict__ Bg, const float* __restrict__ lam_rows,
          const float* __restrict__ C, int n, int K, int L, int Kg, int loss_kl, float eps,
          int stage_bg, int tiles_per_block, int n_tiles, float* Hn, float* Hs, float* Q,
          float* __restrict__ part) {
  extern __shared__ __align__(16) float sm[];
  const int LT = L * kWideT;
  float* sY = sm;                                     // L x 128: Y widened to fp32
  float* sA = sY + LT;                                // L x 128: B H (Y / max(B H, eps) for KL)
  float* sP = sA + LT;                                // 8 x kWideLC x 128 (L > 0)
  float* sC = sP + (L > 0 ? kWarps * kWideLC * kWideT : 0);  // 2 x 128: c_cur, c_next
  float* sRed = sC + (kCounts ? 2 * kWideT : 0);      // kThreads
  float* sPred = sRed + kThreads;                     // L
  float* sBg = sPred + (L + 3) / 4 * 4;               // L x Kg
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool bg_smem = stage_bg != 0;
  auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = n % 4 == 0 && a16(H) && a16(WtX) && a16(D) && a16(Hn) && (!kCounts || a16(Hs));
  if (bg_smem)
    for (int e = tid; e < L * Kg; e += kThreads) sBg[e] = Bg[e];
  for (int l = tid; l < L; l += kThreads) sPred[l] = 0.f;
  float ld = 0.f;
  const int tile_begin = blockIdx.x * tiles_per_block;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_block);
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int c0 = tile * kWideT, cb = c0 + kWideV * lane;
    __syncthreads();  // the previous tile is done with shared memory
    for (int e = tid; e < LT; e += kThreads) {
      const int l = e / kWideT, cell = c0 + e % kWideT;
      sY[e] = cell < n ? to_f(Y[(size_t)l * n + cell]) : 0.f;
    }
    if constexpr (kCounts) {
      for (int e = tid; e < 2 * kWideT; e += kThreads) {
        const int r = e / kWideT, cell = c0 + e % kWideT;
        sC[e] = cell < n ? C[(size_t)r * n + cell] : 0.f;
      }
    }
    __syncthreads();
    // B H, then A = Y / max(B H, eps) (KL) or B H (Frobenius)
    for (int l0 = 0; l0 < L; l0 += kWideLC) {
      const int nl = min(kWideLC, L - l0);
      wide_label_sums(H, sBg, Bg, bg_smem, n, Kg, l0, nl, cb, vec, sP);
      __syncthreads();
      for (int e = tid; e < nl * kWideT; e += kThreads) {
        const int l = e / kWideT, t = e % kWideT;
        float s = sP[e];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += sP[(w * kWideLC + l) * kWideT + t];
        const float y = sY[(l0 + l) * kWideT + t];
        sA[(l0 + l) * kWideT + t] = loss_kl ? y / fmaxf(s, eps) : s;
      }
      __syncthreads();
    }
    // the multiplicative update, one row of K a warp pass
    for (int k = warp; k < K; k += kWarps) {
      const size_t o = (size_t)k * n;
      float h[kWideV], w4[kWideV], d[kWideV], num[kWideV], den[kWideV];
      wide_ld4(H + o, cb, n, vec, h);
      wide_ld4(WtX + o, cb, n, vec, w4);
      wide_ld4(D + o, cb, n, vec, d);
#pragma unroll
      for (int q = 0; q < kWideV; ++q) num[q] = 2.f * w4[q], den[q] = 2.f * d[q];
      if (k < Kg) {
        const float lam = __ldg(lam_rows + k);
        float s1[kWideV] = {0.f, 0.f, 0.f, 0.f}, s2[kWideV] = {0.f, 0.f, 0.f, 0.f};
        float col = 0.f;
        for (int l = 0; l < L; ++l) {
          const size_t ob = (size_t)l * Kg + k;
          const float b = bg_smem ? sBg[ob] : __ldg(Bg + ob);
          const float4 a = *reinterpret_cast<const float4*>(sA + l * kWideT + kWideV * lane);
          const float av[kWideV] = {a.x, a.y, a.z, a.w};
          if (loss_kl) {
#pragma unroll
            for (int q = 0; q < kWideV; ++q) s1[q] = fmaf(b, av[q], s1[q]);
            col += b;
          } else {
            const float4 y = *reinterpret_cast<const float4*>(sY + l * kWideT + kWideV * lane);
            const float yv[kWideV] = {y.x, y.y, y.z, y.w};
#pragma unroll
            for (int q = 0; q < kWideV; ++q) {
              s1[q] = fmaf(b, yv[q], s1[q]);
              s2[q] = fmaf(b, av[q], s2[q]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kWideV; ++q) {
          if (loss_kl) {
            num[q] += lam * s1[q];
            den[q] += lam * col;
          } else {
            const float l2 = 2.f * lam;
            num[q] += l2 * s1[q];
            den[q] += l2 * s2[q];
          }
        }
      }
      float hn[kWideV];
#pragma unroll
      for (int q = 0; q < kWideV; ++q) {
        hn[q] = cb + q < n ? h[q] * (num[q] / fmaxf(den[q], eps)) : 0.f;
        if constexpr (kCounts) {
          if (!(sC[kWideV * lane + q] > 0.f)) hn[q] = h[q];  // undrawn (and past n): keep H
        }
        ld = fmaf(w4[q], hn[q], ld);
      }
      wide_st4(Hn + o, cb, n, vec, hn);
      if constexpr (kCounts) {  // Hs = c_next ⊙ Hn
#pragma unroll
        for (int q = 0; q < kWideV; ++q) hn[q] *= sC[kWideT + kWideV * lane + q];
        wide_st4(Hs + o, cb, n, vec, hn);
      }
    }
    if (L == 0) continue;
    __syncthreads();  // the tile's Hn, from every warp, visible to the block
    // ŷ = Bg Hn, the prediction-loss terms and Q
    for (int l0 = 0; l0 < L; l0 += kWideLC) {
      const int nl = min(kWideLC, L - l0);
      wide_label_sums(Hn, sBg, Bg, bg_smem, n, Kg, l0, nl, cb, vec, sP);
      __syncthreads();
      for (int e = tid; e < nl * kWideT; e += kThreads) {
        const int l = e / kWideT, t = e % kWideT, cell = c0 + t;
        float yh = sP[e];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) yh += sP[(w * kWideLC + l) * kWideT + t];
        const float y = sY[(l0 + l) * kWideT + t];
        float q, err;
        if (loss_kl) {
          const float yc = fmaxf(yh, eps);
          q = y / yc;
          err = y * logf(fmaxf(q, eps)) - y + yc;
        } else {
          const float dd = y - yh;
          q = y;
          err = dd * dd;
        }
        if (cell < n) Q[(size_t)(l0 + l) * n + cell] = q;
        sP[e] = cell < n ? err : 0.f;  // over warp 0's partial, read above by this thread
      }
      __syncthreads();
      for (int l = warp; l < nl; l += kWarps) {
        const float4 v = *reinterpret_cast<const float4*>(sP + l * kWideT + kWideV * lane);
        const float s = warp_sum(((v.x + v.y) + v.z) + v.w);
        if (lane == 0) sPred[l0 + l] += s;
      }
      __syncthreads();  // before sP is written again
    }
  }
  // the loss dot, a tree over the block's threads
  sRed[tid] = ld;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) sRed[tid] += sRed[tid + s];
    __syncthreads();
  }
  float* mypart = part + (size_t)blockIdx.x * (L + 1);
  for (int l = tid; l < L; l += kThreads) mypart[l] = sPred[l];
  if (tid == 0) mypart[L] = sRed[0];
}

// The launch parameters of the chain (ops/kernels.py:WideIterationGrid, in
// its order).  P2 and P1 on int8/bf16 X: wtx_wide (wWR its cluster size) and
// hxt_wide (GB its cluster size); on float32/int16 X wtx_fma_wide and
// hxt_fma_wide (their tiles, chunk and stages are fma_wide.cuh's: P1 takes
// n_split and cells_per_split).  gram_wide's splits.
struct WideGrid {
  int T, n_part, tiles_per_block;
  int wT, wWR, wGC, wS, w_ranges, w_range_genes;  // P2 for WᵀX
  int GB, n_split, cells_per_split, S, CW;        // P1 for X Hsᵀ
  int g_split, g_cells_per_split;                 // gram_wide
};

// WᵀX → D = WᵀW H → iter_wide (Hn, Hs, Q) → X Hsᵀ partials → gram_wide (H Hᵀ,
// HHtU, rowsum, Bnum into stats) → reduce_partials: the prediction rows and
// the loss dot into stats, and XHt.  The X products take P1/P2's path by
// X's dtype (bf16 tensor cores for int8/bf16 X, FP32 units for
// float32/int16), as the K <= 512 kernel does.
template <typename XT, bool kBf16, bool kCounts>
static int launch_iteration_wide(const void* X, const float* W, const float* H,
                                 const float* WtW, const void* Y, const float* Bg,
                                 const float* lam_rows, const float* C, int g, int n, int K,
                                 int L, int Kg, int loss_kl, int stage_bg, float eps,
                                 const WideGrid& p,
                                 float* Hn, float* XHt, float* stats, float* WtX, float* D,
                                 float* Hs, float* Q, float* part, float* part_x,
                                 float* part_hh, void* hb, void* wb, float* wpart,
                                 float* WtWt, cudaStream_t stream) {
  if (p.T != kWideT || K < 1 || L < 0 || (kCounts && (C == nullptr || Hs == nullptr)) ||
      (L > 0 && (Y == nullptr || Bg == nullptr || lam_rows == nullptr || Q == nullptr)))
    return (int)cudaErrorInvalidValue;
  int rc;
  if constexpr (kBf16) {
    rc = launch_wtx_wide<XT>(X, W, g, n, K, p.wWR, p.w_ranges, p.w_range_genes, p.wS,
                             static_cast<__nv_bfloat16*>(wb), wpart, WtX, stream);
  } else {
    rc = launch_wtx_fma_wide<XT>(X, W, g, n, K, WtX, stream);
  }
  if (rc != 0) return rc;
  cudaError_t err = launch_wtw_transpose(WtW, K, WtWt, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_wtw_gemm<kGemmStore>(WtWt, H, K, n, nullptr, 0.f, D, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = wide_smem_floats(L, Kg, kCounts, stage_bg != 0) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  err = allow_smem(reinterpret_cast<const void*>(iter_wide<XT, kCounts>), smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n + kWideT - 1) / kWideT;
  iter_wide<XT, kCounts><<<p.n_part, kThreads, smem, stream>>>(
      H, WtX, D, static_cast<const XT*>(Y), Bg, lam_rows, C, n, K, L, Kg, loss_kl, eps,
      stage_bg, p.tiles_per_block, n_tiles, Hn, Hs, Q, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* Hx = kCounts ? Hs : Hn;  // X Hsᵀ
  if constexpr (kBf16) {  // the splits' partials, summed by reduce_partials
    rc = launch_hxt_wide<XT>(X, Hx, g, n, K, p.GB, p.n_split, p.cells_per_split, p.S,
                             static_cast<__nv_bfloat16*>(hb), part_x, nullptr, stream);
  } else {
    rc = launch_hxt_fma_wide<XT>(X, Hx, g, n, K, p.n_split, p.cells_per_split, part_x,
                                 stream);
  }
  if (rc != 0) return rc;
  // stats: HHt (K K), rowsum (K), Bnum (L K), the prediction rows (L), the
  // loss dot (1) and, in counts mode, HHtU (ops/kernels.py:_stats_len)
  const size_t kk = (size_t)K * K;
  const size_t S_small = (size_t)K + (size_t)L * K + L + 1;
  rc = launch_gram_wide(Hn, kCounts ? C + n : nullptr, Q, K, n, L, p.g_split,
                        p.g_cells_per_split, part_hh, stats,
                        kCounts ? stats + kk + S_small : nullptr, stats + kk, stats + kk + K,
                        stream);
  if (rc != 0) return rc;
  const size_t total = (size_t)(L + 1) + (size_t)g * K;
  reduce_partials<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, p.n_part, L + 1, stats + kk + K + (size_t)L * K, part_x, p.n_split, K, g, XHt);
  return (int)cudaGetLastError();
}

}  // namespace alpine

// Plain C entry points (ctypes).  Each returns 0 or a cudaError_t code.
// hxt and wtx take K <= 512 (above: alpine_hxt_wide / alpine_wtx_wide on
// int8/bf16 X, alpine_hxt_fma_wide / alpine_wtx_fma_wide on float32/int16).
// hxt: `stages` and `chunk` (cells a ring stage holds) serve both paths,
// the scratch `hb` (K x n rounded up to the chunk, bf16) only the bf16 path
// (int8, bf16 X).  wtx: `T` (cells a tile), `chunk` (genes a ring stage) and
// `stages` serve both paths; `WR` is the bf16 path's warp rows and the fp32
// path's lanes along K (LK); `ranges`, `range_genes`, the scratch `wb` (Kp
// x g rounded up to the chunk, bf16), `part` (ranges x K x n) and
// `arrivals` (a zeroed counter a tile) serve the bf16 path only.
extern "C" int alpine_hxt(const void* X, int xtype, const float* H, int g, int n,
                          int K, int GB, int n_split, int cells_per_split, int stages,
                          int chunk, void* hb, float* part, float* out, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* Hb = static_cast<__nv_bfloat16*>(hb);
  switch (xtype) {
    case kF32:
      return launch_hxt<float, false>(X, H, g, n, K, GB, n_split, cells_per_split,
                                      stages, chunk, Hb, part, out, s);
    case kBF16:
      return launch_hxt<__nv_bfloat16, true>(X, H, g, n, K, GB, n_split, cells_per_split,
                                             stages, chunk, Hb, part, out, s);
    case kI8:
      return launch_hxt<int8_t, true>(X, H, g, n, K, GB, n_split, cells_per_split,
                                      stages, chunk, Hb, part, out, s);
    case kI16:
      return launch_hxt<int16_t, false>(X, H, g, n, K, GB, n_split, cells_per_split,
                                        stages, chunk, Hb, part, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int alpine_wtx(const void* X, int xtype, const float* W, int g, int n,
                          int K, int T, int WR, int chunk, int stages, int ranges,
                          int range_genes, void* wb, float* part, void* arrivals, float* out,
                          void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* Wb = static_cast<__nv_bfloat16*>(wb);
  unsigned* arr = static_cast<unsigned*>(arrivals);
  switch (xtype) {
    case kF32: return launch_wtx_fma<float>(X, W, g, n, K, T, WR, chunk, stages, out, s);
    case kBF16:
      return launch_wtx_mma<__nv_bfloat16>(X, W, g, n, K, T, WR, chunk, stages, ranges,
                                           range_genes, Wb, part, arr, out, s);
    case kI8:
      return launch_wtx_mma<int8_t>(X, W, g, n, K, T, WR, chunk, stages, ranges,
                                    range_genes, Wb, part, arr, out, s);
    case kI16:
      return launch_wtx_fma<int16_t>(X, W, g, n, K, T, WR, chunk, stages, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// P1 and P2 above K = 512 on float32/int16 X (fma_wide.cuh), all of K in
// one launch.  hxt: n_split splits of cells_per_split cells into `part`
// (n_split x K x g), added in split order into `out` (K x g) by
// reduce_splits; with one split the kernel writes `out` itself (part may be
// nullptr).  wtx: out (K x n).
extern "C" int alpine_hxt_fma_wide(const void* X, int xtype, const float* H, int g, int n,
                                   int K, int n_split, int cells_per_split, float* part,
                                   float* out, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = n_split > 1 ? part : out;
  if (dst == nullptr) return (int)cudaErrorInvalidValue;
  int rc;
  switch (xtype) {
    case kF32:
      rc = launch_hxt_fma_wide<float>(X, H, g, n, K, n_split, cells_per_split, dst, s);
      break;
    case kI16:
      rc = launch_hxt_fma_wide<int16_t>(X, H, g, n, K, n_split, cells_per_split, dst, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0 || n_split == 1) return rc;
  const size_t total = (size_t)K * g;
  reduce_splits<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, n_split, K, g, out);
  return (int)cudaGetLastError();
}

extern "C" int alpine_wtx_fma_wide(const void* X, int xtype, const float* W, int g, int n,
                                   int K, float* out, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (xtype) {
    case kF32: return launch_wtx_fma_wide<float>(X, W, g, n, K, out, s);
    case kI16: return launch_wtx_fma_wide<int16_t>(X, W, g, n, K, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The large-K route of fused_iteration (ops/kernels.py:_launch_iteration_wide):
// the K1 entry's inputs and outputs (stats in its layout), whether iter_wide
// stages Bg in shared memory (kernels.wide_stages_bg), the 16 ints of
// WideIterationGrid, and scratch: wtx, d (K x n each), hs (K x n, counts mode),
// q (L x n), part (n_part x (L + 1)), part_x (n_split x K x g), part_hh
// (gram_split x gram_split_floats), and on the bf16 path hb (H rounded,
// K x n padded to 64), wb (W rounded, pad16(K) x g padded to 64) and wpart
// (P2's gene ranges' partials, where it splits the genes).
extern "C" int alpine_fused_iteration_wide(
    const void* X, int xtype, const float* W, const float* H, const float* WtW,
    const void* Y, const float* Bg, const float* lam_rows, const float* counts,
    int g, int n, int K, int L, int Kg, int loss_kl, int stage_bg, float eps, int T,
    int n_part,
    int tiles_per_block, int wtx_T, int wtx_WR, int wtx_GC, int wtx_S,
    int wtx_ranges, int wtx_range_genes, int GB, int n_split, int cells_per_split,
    int stages, int chunk, int gram_split, int gram_cells_per_split, float* Hn, float* XHt,
    float* stats, float* wtx, float* d, float* hs, float* q, float* part, float* part_x,
    float* part_hh, void* hb, void* wb, float* wpart, float* wtwt, void* stream) {
  using namespace alpine;
  const WideGrid p{T,       n_part,          tiles_per_block, wtx_T,      wtx_WR,
                   wtx_GC,  wtx_S,           wtx_ranges,      wtx_range_genes, GB,
                   n_split, cells_per_split, stages,          chunk,      gram_split,
                   gram_cells_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ALPINE_WIDE_ARGS                                                                 \
  X, W, H, WtW, Y, Bg, lam_rows, counts, g, n, K, L, Kg, loss_kl, stage_bg, eps, p, Hn, XHt, \
      stats, wtx, d, hs, q, part, part_x, part_hh, hb, wb, wpart, wtwt, s
  const bool c = counts != nullptr;
  switch (xtype) {
    case kF32:
      return c ? launch_iteration_wide<float, false, true>(ALPINE_WIDE_ARGS)
               : launch_iteration_wide<float, false, false>(ALPINE_WIDE_ARGS);
    case kBF16:
      return c ? launch_iteration_wide<__nv_bfloat16, true, true>(ALPINE_WIDE_ARGS)
               : launch_iteration_wide<__nv_bfloat16, true, false>(ALPINE_WIDE_ARGS);
    case kI8:
      return c ? launch_iteration_wide<int8_t, true, true>(ALPINE_WIDE_ARGS)
               : launch_iteration_wide<int8_t, true, false>(ALPINE_WIDE_ARGS);
    case kI16:
      return c ? launch_iteration_wide<int16_t, false, true>(ALPINE_WIDE_ARGS)
               : launch_iteration_wide<int16_t, false, false>(ALPINE_WIDE_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ALPINE_WIDE_ARGS
}

// wtw_gemm's store alone (ops/kernels.py:wtw_gemm): out = A B for A K x K
// and B K x n, A transposed first into At (a K x K scratch).
extern "C" int alpine_wtw_gemm(const float* A, const float* B, int K, int n, float* At,
                               float* out, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_wtw_transpose(A, K, At, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wtw_gemm<kGemmStore>(At, B, K, n, nullptr, 0.f, out, s);
}

// gram_wide alone (ops/kernels.py:gram_wide): HHt = Hn diag(c) Hnᵀ (c: a
// row of n, or nullptr for all ones), HHtU = Hn Hnᵀ (only with c), rowsum =
// Hn c and Bnum = Q diag(c) Hnᵀ (Q: L x n) over gram_split splits of
// gram_cells_per_split cells; part: gram_split x gram_split_floats scratch.
extern "C" int alpine_gram_wide(const float* Hn, const float* c, const float* Q, int K, int n,
                                int L, int gram_split, int gram_cells_per_split, float* part,
                                float* hht, float* hhtu, float* rowsum, float* bnum,
                                void* stream) {
  return alpine::launch_gram_wide(Hn, c, Q, K, n, L, gram_split, gram_cells_per_split, part,
                                  hht, hhtu, rowsum, bnum, static_cast<cudaStream_t>(stream));
}

// The fp32 X passes above K = 512 (float32 and int16 X), one launch each
// for all of K:
//   hxt_fma_wide: part[split][k][gi] = sum over the split's cells c of
//                 H[k][c] X[gi][c] (P1; reduce_splits, or the chain's
//                 reduce_partials, adds the splits in order);
//   wtx_fma_wide: out[k][c] = sum over genes gi of W[gi][k] X[gi][c] (P2).
// x_passes.cu runs them as ALS's hxt / wtx and inside the large-K chain of
// K1/K2/K4 (WᵀX and X Hsᵀ); grids: ops/kernels.py:hxt_fma_wide_grid,
// wtx_fma_wide_grid.
//
// Bound on the H100: operations.  A pass at K = 768, 100k cells x 2,000
// genes is 307 GFLOP of true fp32 (no TF32: matmul_precision "highest"),
// 4.59 ms at 67 TFLOP/s, against 0.46 ms for float32 X's 816 MB and H or
// W.  So both take wtw_gemm's design (wtw_gemm.cuh), which keeps the FP32
// units fed: a block of 256 threads owns a 128 x 128 output tile, chunks
// of kGemmBK = 16 reduction values of both operands come by cp.async
// straight into a ring of kFwStages = 2 stages in shared memory, and
// each thread's 8 x 8 outputs take 64 FMAs for every four 16-byte shared
// loads (gemm_chunk).  Two blocks an SM; shared memory does not grow with
// K (ops/kernels.py:fma_wide_smem_bytes).  The outputs are stored a value
// at a time: 16-byte stores of them made both passes 2-5 % slower on an
// H100 (scripts/torch_fma_wide_variants.py, ``vector_stores``).
//
//  * wtx_fma_wide: A = Wᵀ and B = X, summed over the genes: W [gene][k]
//    is already the [j][row] layout gemm_chunk reads and X's rows its
//    [j][cell] one, so a stage is 16 rows of W's tile and 16 of X's.  The
//    K / 128 row tiles of a cell tile run back to back, so blocks resident
//    together read the same 128-cell columns of X, and X comes from device
//    memory about once.
//  * hxt_fma_wide: the sum runs over cells, the contiguous axis of both H
//    and X, so a stage holds 16 cells of H's 128 rows and of X's 128 gene
//    rows as [row][cell].  The block turns each stage into the [cell][row]
//    tiles gemm_chunk reads: thread (r, p) = (tid / 2, tid mod 2) copies
//    cells 4 p .. 4 p + 3 and 8 + 4 p .. of row r of both operands and
//    turns just those, so it turns a chunk as soon as its own copies land,
//    into one of two sets of turned tiles, and the chunk takes one
//    barrier, as wtw_gemm's does.  The two lanes of a row read the two
//    halves of a 32-byte sector in one instruction (a lane a row asked
//    for each sector twice: P1 11-13 % slower).  Staged rows are padded
//    to kFwRow = 24 floats (a turn's 16-byte reads of 4 rows x 2 halves
//    touch 8 different bank groups) and turned tiles to kFwTurn = 132
//    (the two lanes of a row write cells 4 apart into banks 16 apart).
//    The tile is 128 rows of K x 128 genes, so a split's partial is
//    written along the genes.  The cells are cut into splits of at most
//    _WIDE_SPLIT_CELLS, enough of them to fill at least two waves of two
//    blocks an SM; the blocks of a split run together (the K / 128 row
//    tiles of a gene tile back to back, then the gene tiles), so X's and
//    H's columns come from device memory about once.
//  * int16 X is widened exactly (widen_i16x4, fma_passes.cuh) once a
//    stage, on its way out of the ring, by the thread that copied it: by
//    P2 into one of two fp32 tiles, by P1 in its turn.
//  * Rows off 16-byte alignment (n not a multiple of 4 values, 8 for
//    int16, or an operand off a 16-byte boundary) take an instantiation of
//    their own: fp32 rows by 4-byte cp.async into the same slots (as
//    wtw_gemm's), int16 rows as the 4-byte words that cover a thread's 8
//    (P2) or 4 (P1) cells at any 2-byte offset, read at that offset when
//    they are widened.  Every staged value is the aligned copy's, zero past g,
//    n and K, so the bits do not depend on alignment.
//  * Every output is one thread's fmaf chain over its sum's terms in
//    order (P1: a split's cells; P2: the genes) from 0.f, so two launches
//    give the same bits.
#pragma once

#include "fma_passes.cuh"
#include "wtw_gemm.cuh"

namespace alpine {

// the ring's stages: 2 (3 and 4 within 1 % for P2, 2-4 % slower for P1 on
// an H100; scripts/torch_fma_wide_variants.py)
constexpr int kFwStages = 2;
// P1's staged rows (kGemmBK cells and a pad) and turned tiles' pitch
constexpr int kFwRow = kGemmBK + 8, kFwTurn = kGemmBM + 4;
// int16 rows of a stage: each thread's cells in a slot of its own, as the
// words that cover them at any 2-byte offset (P2: 16 threads of 8 cells,
// 5 words each; P1: 2 threads of 2 x 4 cells, 3 words each)
constexpr int kFwWtxWords = 80, kFwHxtWords = 12;
// floats of a ring stage: wtx (W's 16 x 128 tile, then X's 16 rows) and
// hxt (H's 128 rows, then X's 128), by X's storage
constexpr int kFwWtxStage32 = 2 * kGemmBK * kGemmBN;
constexpr int kFwWtxStage16 = kGemmBK * kGemmBN + kGemmBK * kFwWtxWords;
constexpr int kFwHxtStage32 = 2 * kGemmBM * kFwRow;
constexpr int kFwHxtStage16 = kGemmBM * kFwRow + kGemmBN * kFwHxtWords;
// after the ring, two buffers of: wtx's widened X tile (int16), hxt's
// turned tiles of H and X (both)
constexpr int kFwWtxTail16 = 2 * kGemmBK * kGemmBN;
constexpr int kFwHxtTurned = 2 * kGemmBK * kFwTurn;
constexpr int kFwHxtTail = 2 * kFwHxtTurned;

// bytes of shared memory; ops/kernels.py:fma_wide_smem_bytes holds the
// same formula
__host__ __device__ constexpr size_t fma_wide_smem(bool hxt, bool int16) {
  return sizeof(float) *
         (hxt ? (size_t)kFwStages * (int16 ? kFwHxtStage16 : kFwHxtStage32) + kFwHxtTail
              : (size_t)kFwStages * (int16 ? kFwWtxStage16 : kFwWtxStage32) +
                    (int16 ? kFwWtxTail16 : 0));
}
static_assert(2 * (fma_wide_smem(true, false) + 1024) <= 233472 &&
                  2 * (fma_wide_smem(false, true) + 1024) <= 233472,
              "two blocks of each pass must share an SM");

// cp.async of 8 bytes (or 8 zero bytes when !full): P1's int16 groups
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 8 : 0)
               : "memory");
}

// The 2-byte offset of element e of X within its 4-byte word.
__device__ __forceinline__ int int16_shift(const int16_t* X, size_t e) {
  return (int)((reinterpret_cast<uintptr_t>(X) / 2 + e) & 1);
}

// A thread's kCells int16 cells from element e of X (cells `first` .. of
// their row) as the kCells / 2 + 1 words from the one that holds e, into
// its slot dst; a word whose lower cell (first - shift + 2 w) is `valid` or
// past it is zero (cp.async reads nothing).  A copied word holds a cell of
// the row or the element just before its first, which shares the word.
template <int kCells>
__device__ __forceinline__ void copy_int16_words(float* dst, const int16_t* __restrict__ X,
                                                 size_t e, bool row_ok, int first, int valid) {
  const int shift = int16_shift(X, e);
  const uintptr_t base = reinterpret_cast<uintptr_t>(X + e) & ~(uintptr_t)3;
#pragma unroll
  for (int w = 0; w < kCells / 2 + 1; ++w) {
    const bool full = row_ok && first - shift + 2 * w < valid;
    cp_async4(dst + w, full ? reinterpret_cast<const void*>(base + 4 * w) : X, full);
  }
}

// The thread's kCells (4 or 8) int16 values widened exactly: its slot as
// copied whole (kVec), or its words read at the cells' 2-byte offset, zero
// where !row_ok or from cell `valid` on.
template <int kCells, bool kVec>
__device__ __forceinline__ void widen_int16(float (&v)[kCells], const float* slot,
                                            const int16_t* X, size_t e, bool row_ok, int first,
                                            int valid) {
  if constexpr (kVec) {
#pragma unroll
    for (int q = 0; q < kCells / 4; ++q) {
      const float4 w = widen_i16x4(reinterpret_cast<const uint2*>(slot)[q]);
      v[4 * q] = w.x, v[4 * q + 1] = w.y, v[4 * q + 2] = w.z, v[4 * q + 3] = w.w;
    }
  } else {
    const int16_t* cells = reinterpret_cast<const int16_t*>(slot) + int16_shift(X, e);
#pragma unroll
    for (int u = 0; u < kCells; ++u)
      v[u] = row_ok && first + u < valid ? static_cast<float>(cells[u]) : 0.f;
  }
}

// Thread (ty, tx)'s 8 x 8 outputs into out (rows x cols, row pitch cols) at
// rows r0 + 4 ty + i and + 64, columns c0 + 4 tx + u and + 64, a value at a
// time, none past rows or cols.
__device__ __forceinline__ void store_acc(const float (&acc)[8][8], float* __restrict__ out,
                                          int rows, int cols, int r0, int c0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= rows) continue;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + (u < 4 ? 4 * tx + u : 64 + 4 * tx + u - 4);
      if (c < cols) out[(size_t)r * cols + c] = acc[i][u];
    }
  }
}

// ---- P2 -------------------------------------------------------------------

// out[k][c] = sum over genes of W[gene][k] X[gene][c] for the 128 x 128
// tile of blocks in K / 128 row tiles x n / 128 cell tiles (row tiles
// inner).  kVec: W's and X's rows on 16-byte boundaries (16-byte copies),
// else 4-byte copies (int16: the words that cover each thread's cells).
// float32 X: wtw_gemm's loop, one barrier a chunk.  int16 X: thread (r, c)
// copies the raw cells c .. c + 7 of row r it widens, so it widens chunk t
// as soon as its own copies land, into one of two fp32 tiles, before the
// chunk's one barrier.
template <typename XT, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
wtx_fma_wide(const XT* __restrict__ X, const float* __restrict__ W, int g, int n, int K,
             float* __restrict__ out) {
  constexpr bool kI16 = sizeof(XT) == 2;
  constexpr int kStage = kI16 ? kFwWtxStage16 : kFwWtxStage32;
  extern __shared__ __align__(16) float ring[];
  float* wide = ring + kFwStages * kStage;  // int16: two widened X tiles
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int KT = (K + kGemmBM - 1) / kGemmBM;
  const int k0 = blockIdx.x % KT * kGemmBM, c0 = blockIdx.x / KT * kGemmBN;
  const int n_chunks = (g + kGemmBK - 1) / kGemmBK;
  // int16: this thread's row of a chunk and its 8 cells
  const int xr = tid / 16, xc = tid % 16 * 8;
  const int16_t* X16 = reinterpret_cast<const int16_t*>(X);

  // chunk q (genes q kGemmBK ..) into stage q mod kFwStages; one group
  // committed, empty past the last chunk
  auto issue = [&](int q) {
    if (q < n_chunks) {
      float* sw = ring + (q % kFwStages) * kStage;
      float* sx = sw + kGemmBK * kGemmBM;
      const int j0 = q * kGemmBK;
      wtw_copy_tile<kVec>(sw, W, g, K, j0, k0, tid);
      if constexpr (!kI16) {
        wtw_copy_tile<kVec>(sx, X, g, n, j0, c0, tid);
      } else if constexpr (kVec) {
        const bool full = j0 + xr < g && c0 + xc < n;
        cp_async16(sx + xr * kFwWtxWords + xc / 8 * 4,
                   full ? X + (size_t)(j0 + xr) * n + c0 + xc : X, full);
      } else {
        copy_int16_words<8>(sx + xr * kFwWtxWords + xc / 8 * 5, X16,
                            (size_t)min(j0 + xr, g - 1) * n + c0 + xc, j0 + xr < g, c0 + xc, n);
      }
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.f;
#pragma unroll
  for (int q = 0; q < kFwStages - 1; ++q) issue(q);
  for (int t = 0; t < n_chunks; ++t) {
    cp_async_wait(kFwStages - 2);  // this thread's copies of chunk t
    const float* sw = ring + (t % kFwStages) * kStage;
    const float* sx = sw + kGemmBK * kGemmBM;
    if constexpr (kI16) {
      // its own raw cells of chunk t into widened tile t mod 2, which every
      // thread finished reading (chunk t - 2) before the last barrier
      const int j = t * kGemmBK + xr;
      float v[8];
      widen_int16<8, kVec>(v, sx + xr * kFwWtxWords + xc / 8 * (kVec ? 4 : 5), X16,
                           (size_t)min(j, g - 1) * n + c0 + xc, j < g, c0 + xc, n);
      float* wt = wide + (t % 2) * kGemmBK * kGemmBN + xr * kGemmBN + xc;
      *reinterpret_cast<float4*>(wt) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(wt + 4) = make_float4(v[4], v[5], v[6], v[7]);
      sx = wide + (t % 2) * kGemmBK * kGemmBN;
    }
    // chunk t has landed and is widened; every warp is done with chunk
    // t - 1, whose stage the next copies refill
    __syncthreads();
    issue(t + kFwStages - 1);
    gemm_chunk<>(acc, sw + 4 * ty, sx + 4 * tx);
  }
  store_acc(acc, out, K, n, k0, c0, ty, tx);
}

// ---- P1 -------------------------------------------------------------------

// part[split][k][gi] for the 128 rows of K x 128 genes of this block, over
// the cells of its split; blocks in splits x (g / 128 gene tiles x K / 128
// row tiles, row tiles inner).  cells_per_split: a multiple of kGemmBK.
// Thread (r, p) = (tid / 2, tid mod 2) copies cells 4 p .. and 8 + 4 p ..
// of row r of H's tile and of X's, and turns just those: so it turns
// chunk t as soon as its own copies land, into one of two sets of turned
// tiles, before the chunk's one barrier.
template <typename XT, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
hxt_fma_wide(const XT* __restrict__ X, const float* __restrict__ H, int g, int n, int K,
             int cells_per_split, float* __restrict__ part) {
  constexpr bool kI16 = sizeof(XT) == 2;
  constexpr int kStage = kI16 ? kFwHxtStage16 : kFwHxtStage32;
  constexpr int kXRow = kI16 ? kFwHxtWords : kFwRow;  // floats of a staged X row
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int KT = (K + kGemmBM - 1) / kGemmBM, GT = (g + kGemmBN - 1) / kGemmBN;
  const int k0 = blockIdx.x % KT * kGemmBM, g0 = blockIdx.x / KT % GT * kGemmBN;
  const int split = blockIdx.x / (KT * GT), cbeg = split * cells_per_split;
  const int n_chunks = (min(n, cbeg + cells_per_split) - cbeg + kGemmBK - 1) / kGemmBK;
  const int tr = tid / 2, tp = tid % 2;
  const bool h_ok = k0 + tr < K, x_ok = g0 + tr < g;
  // this thread's rows of H and X (row 0 where past K or g: never read)
  const float* hrow = H + (size_t)(h_ok ? k0 + tr : 0) * n;
  const XT* xrow = X + (size_t)(x_ok ? g0 + tr : 0) * n;
  const int16_t* X16 = reinterpret_cast<const int16_t*>(X);
  const size_t xe = (size_t)(x_ok ? g0 + tr : 0) * n;  // element of xrow's first cell

  // chunk q (cells cbeg + q kGemmBK ..) into stage q mod kFwStages; one
  // group committed, empty past the split
  auto issue = [&](int q) {
    if (q < n_chunks) {
      float* sh = ring + (q % kFwStages) * kStage + tr * kFwRow;
      float* sx = ring + (q % kFwStages) * kStage + kGemmBM * kFwRow + tr * kXRow;
      const int c0 = cbeg + q * kGemmBK;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 8 * h + 4 * tp, c = c0 + o;  // the group's first cell
        if constexpr (kVec) {
          cp_async16(sh + o, h_ok && c < n ? hrow + c : H, h_ok && c < n);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            cp_async4(sh + o + u, h_ok && c + u < n ? hrow + c + u : H, h_ok && c + u < n);
        }
        if constexpr (kI16 && kVec) {
          cp_async8(sx + o / 2, x_ok && c < n ? xrow + c : X, x_ok && c < n);
        } else if constexpr (kI16) {
          copy_int16_words<4>(sx + 6 * tp + 3 * h, X16, xe + c, x_ok, c, n);
        } else if constexpr (kVec) {
          cp_async16(sx + o, x_ok && c < n ? xrow + c : X, x_ok && c < n);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            cp_async4(sx + o + u, x_ok && c + u < n ? xrow + c + u : X, x_ok && c + u < n);
        }
      }
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.f;
#pragma unroll
  for (int q = 0; q < kFwStages - 1; ++q) issue(q);
  for (int t = 0; t < n_chunks; ++t) {
    cp_async_wait(kFwStages - 2);  // this thread's copies of chunk t
    // its own cells of chunk t into turned tiles t mod 2, which every
    // thread finished reading (chunk t - 2) before the last barrier
    const float* sh = ring + (t % kFwStages) * kStage + tr * kFwRow;
    const float* sx = ring + (t % kFwStages) * kStage + kGemmBM * kFwRow + tr * kXRow;
    float* th = ring + kFwStages * kStage + (t % 2) * kFwHxtTurned;
    float* tg = th + kGemmBK * kFwTurn;
    const int c0 = cbeg + t * kGemmBK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = 8 * h + 4 * tp;
      const float4 a = *reinterpret_cast<const float4*>(sh + o);
      th[(o + 0) * kFwTurn + tr] = a.x;
      th[(o + 1) * kFwTurn + tr] = a.y;
      th[(o + 2) * kFwTurn + tr] = a.z;
      th[(o + 3) * kFwTurn + tr] = a.w;
      float v[4];
      if constexpr (kI16) {
        widen_int16<4, kVec>(v, sx + (kVec ? o / 2 : 6 * tp + 3 * h), X16, xe + c0 + o, x_ok,
                             c0 + o, n);
      } else {
        const float4 b = *reinterpret_cast<const float4*>(sx + o);
        v[0] = b.x, v[1] = b.y, v[2] = b.z, v[3] = b.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) tg[(o + u) * kFwTurn + tr] = v[u];
    }
    // the turned tiles are whole; every warp is done with chunk t - 1,
    // whose stage the next copies refill
    __syncthreads();
    issue(t + kFwStages - 1);
    gemm_chunk<kFwTurn, kFwTurn>(acc, th + 4 * ty, tg + 4 * tx);
  }
  store_acc(acc, part + (size_t)split * K * g, K, g, k0, g0, ty, tx);
}

// P2 over all of K in one launch: (K / 128) x (n / 128) blocks.
template <typename XT>
static int launch_wtx_fma_wide(const void* X, const float* W, int g, int n, int K, float* out,
                               cudaStream_t stream) {
  if (K < 1 || n < 1 || g < 1) return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)((K + kGemmBM - 1) / kGemmBM) * ((n + kGemmBN - 1) / kGemmBN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = rows_aligned16(static_cast<const XT*>(X), n) && rows_aligned16(W, K);
  auto kernel = vec ? wtx_fma_wide<XT, true> : wtx_fma_wide<XT, false>;
  const size_t smem = fma_wide_smem(false, sizeof(XT) == 2);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(static_cast<const XT*>(X), W, g, n, K,
                                                      out);
  return (int)cudaGetLastError();
}

// P1 over all of K in one launch: n_split splits of cells_per_split cells
// (a multiple of kGemmBK) x (g / 128) x (K / 128) blocks, writing the
// splits' K x g partials.
template <typename XT>
static int launch_hxt_fma_wide(const void* X, const float* H, int g, int n, int K, int n_split,
                               int cells_per_split, float* part, cudaStream_t stream) {
  if (K < 1 || n < 1 || g < 1 || n_split < 1 || cells_per_split % kGemmBK != 0 ||
      (long long)(n_split - 1) * cells_per_split >= n ||
      (long long)n_split * cells_per_split < n)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((K + kGemmBM - 1) / kGemmBM) *
                           ((g + kGemmBN - 1) / kGemmBN) * n_split;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = rows_aligned16(static_cast<const XT*>(X), n) && rows_aligned16(H, n);
  auto kernel = vec ? hxt_fma_wide<XT, true> : hxt_fma_wide<XT, false>;
  const size_t smem = fma_wide_smem(true, sizeof(XT) == 2);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(static_cast<const XT*>(X), H, g, n, K,
                                                      cells_per_split, part);
  return (int)cudaGetLastError();
}

}  // namespace alpine

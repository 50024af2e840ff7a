// gram_wide: K1/K2/K4's statistics over cells against Hn (every K),
// from one read of Hn (K x n fp32) and the counts row c (c_next in counts
// mode; all ones otherwise, then not read):
//   HHt    = Hn diag(c) Hnᵀ  (K x K; H_stat Hnᵀ, H_stat = Hs = c ⊙ Hn)
//   HHtU   = Hn Hnᵀ          (K x K, counts mode only)
//   rowsum = Hn c            (K; rowsum(H_stat))
//   Bnum   = Q diag(c) Hnᵀ   (L x K; Q from iter_wide)
// Replaces the H_stat contractions of alpine_tpu/ops/pallas_kernels.py:
// fused_iteration (:584-620: HHt_ref, HHtU_ref, rowsum_Hn, bnum_all).
//
// Bound on the H100: the FP32 units (true fp32, no TF32: matmul_precision
// "highest").  At 100k cells and K = 768 the 21 tile pairs of the upper
// triangle are 69 GFLOP (counts mode twice that), 1.0 ms at 67 TFLOP/s; Hn
// is 307 MB, 0.09 ms at 3.35 TB/s.
//
// Design:
//  * Only the upper triangle of 128 x 128 tiles of K x K: block (pair p,
//    split s) owns tile pair (ti <= tj) over the split's cells, so the
//    symmetric product costs half the full one.  gram_reduce sums the
//    splits' partials in split order (no atomics: a second launch gives the
//    same bits) and mirrors them: out[r][s] = out[s][r] = the pair's entry
//    at (min, max), so HHt and HHtU come out exactly symmetric.
//  * A pair's block is wtw_gemm's product (wtw_gemm.cuh) with both operands
//    rows of Hn: chunks of kGramBK cells pass through two shared-memory
//    buffers as [cell][row], the next chunk loaded into registers (one
//    16-byte load of 4 cells of a row a thread and tile where rows are
//    16-byte aligned, element loads elsewhere: the same values, so the
//    same bits) while the current one is multiplied, one barrier a chunk;
//    a diagonal pair loads its rows once.  Thread (ty, tx) owns rows
//    4 ty + i and 64 + 4 ty + i by columns 4 tx + u and 64 + 4 tx + u, and
//    each cell's two 16-byte loads of its rows and two of its columns feed
//    64 FMAs; in counts mode 128, HHtU from a and HHt from fl(a c), the
//    value iter_wide writes to Hs, from the same registers.  Two blocks an
//    SM without counts (at most 128 registers), one with.  Not a cp.async
//    ring: it copies Hn as it lies, [row][cell], so the product must then
//    turn each stage in shared memory or read [row][cell] into 64 operand
//    registers a thread; both were 8-25 % slower on an H100 at this grid
//    (scripts/gram_wide_variants.cu), while the register prefetch turns the
//    chunk in the shared stores it makes anyway.
//  * rowsum and Bnum are L + 1 extra columns on the B side (the rows of Q
//    and a row of ones), kGramXC of them in a block of their own over the
//    A tile alone (a row of it a thread, half the columns), so the pairs'
//    blocks keep no extra accumulator.
//  * The splits are the grid's fast axis, so every pair's block is
//    dispatched before the extra columns' short ones.  Splits of at most
//    _WIDE_SPLIT_CELLS cells (fp32 sums over at most 16,384 terms), about
//    eight tile-pair blocks an SM in all (ops/kernels.py:gram_wide_grid):
//    finer blocks even out the SMs' loads and let the extra columns'
//    blocks share the last waves.
#pragma once

#include "common.cuh"

namespace alpine {

constexpr int kGramBM = 128;             // rows of K a tile (ops/kernels.py:_GRAM_BM)
constexpr int kGramBK = 8;               // cells a chunk (_GRAM_BK)
constexpr int kGramLDT = kGramBM + 4;    // a cell's stride in a chunk's tile (floats)
constexpr int kGramXC = 8;               // extra columns (Q rows, ones) a block (_GRAM_XC)
constexpr int kGramTile = kGramBM * kGramBM;

// Tile pairs of the upper triangle of T x T tiles, row by row:
// p(ti, tj) = ti T - ti (ti - 1) / 2 + tj - ti.
__host__ __device__ inline int gram_pairs(int T) { return T * (T + 1) / 2; }
__host__ __device__ inline int gram_pair_index(int ti, int tj, int T) {
  return ti * T - ti * (ti - 1) / 2 + (tj - ti);
}

// Floats of one split's partials: nmat 128 x 128 tiles a pair, each in
// thread order (acc[i][u] of thread t at (i * 8 + u) * 256 + t), and
// T x (L + 1) x 128 extra columns (Q rows, then the ones row).
__host__ __device__ inline size_t gram_split_floats(int K, int L, int nmat) {
  const int T = (K + kGramBM - 1) / kGramBM;
  return (size_t)gram_pairs(T) * nmat * kGramTile + (size_t)T * (L + 1) * kGramBM;
}

// Blocks a split: the tile pairs, then for every row tile a block a chunk
// of kGramXC extra columns.
__host__ __device__ inline int gram_items(int K, int L) {
  const int T = (K + kGramBM - 1) / kGramBM;
  return gram_pairs(T) + T * ((L + 1 + kGramXC - 1) / kGramXC);
}

// 4 cells cell .. cell + 3 of row p (nullptr: a row past K) into r, zeros
// past cell_end: one 16-byte load where vec (then the 4 cells are all in
// or all past cell_end), else element loads.
__device__ __forceinline__ void gram_ld4(const float* p, int cell, int cell_end, bool vec,
                                         float* r) {
  if (vec && p != nullptr && cell < cell_end) {
    const float4 v = *reinterpret_cast<const float4*>(p + cell);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) r[u] = p != nullptr && cell + u < cell_end ? p[cell + u] : 0.f;
  }
}

template <bool kCounts>
__global__ void __launch_bounds__(kThreads, kCounts ? 1 : 2)
gram_wide(const float* __restrict__ Hn, const float* __restrict__ c,
          const float* __restrict__ Q, int K, int n, int L, int cells_per_split,
          float* __restrict__ part) {
  __shared__ __align__(16) float As[2][kGramBK][kGramLDT];
  __shared__ __align__(16) float Bs[2][kGramBK][kGramLDT];
  __shared__ __align__(16) float Cs[2][kGramBK];
  __shared__ __align__(16) float Xs[2][kGramXC][kGramBK];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int T = (K + kGramBM - 1) / kGramBM, n_pairs = gram_pairs(T);
  const int split = blockIdx.x, item = blockIdx.y;
  const int cell_begin = split * cells_per_split;
  const int cell_end = min(n, cell_begin + cells_per_split);
  const int n_chunks = (cell_end - cell_begin + kGramBK - 1) / kGramBK;
  const bool vec = (n % 4) == 0 && (reinterpret_cast<uintptr_t>(Hn) & 15) == 0 &&
                   (!kCounts || (reinterpret_cast<uintptr_t>(c) & 15) == 0) &&
                   (L == 0 || (reinterpret_cast<uintptr_t>(Q) & 15) == 0);
  float* base = part + (size_t)split * gram_split_floats(K, L, kCounts ? 2 : 1);
  // a thread's loads of a chunk: row lr of a tile, cells lc .. lc + 3
  const int lr = tid / 2, lc = (tid % 2) * 4;
  // this block's item: a tile pair, or kGramXC extra columns of row tile ti
  int ti, tj = 0;
  if (item < n_pairs) {
    int p = item;
    ti = 0;
    while (p >= T - ti) p -= T - ti, ++ti;
    tj = ti + p;
  } else {
    ti = (item - n_pairs) % T;
  }
  const float* pA = ti * kGramBM + lr < K ? Hn + (size_t)(ti * kGramBM + lr) * n : nullptr;
  const float* pc = kCounts && tid < kGramBK / 4 ? c : nullptr;  // c's 8 cells: 2 threads

  if (item >= n_pairs) {
    // extra columns x0 .. x0 + xn - 1 of row tile ti: thread row xr,
    // columns xg, xg + 2, ... (the ones row for column L)
    const int x0 = kGramXC * ((item - n_pairs) / T);
    const int xn = min(kGramXC, L + 1 - x0), xq = max(0, min(xn, L - x0));
    const int xr = tid % kGramBM, xg = tid / kGramBM;
    const int xe = tid / 2;  // Q row a thread loads (tid < 2 kGramXC)
    const float* pX = tid < 2 * kGramXC && xe < xq ? Q + (size_t)(x0 + xe) * n : nullptr;
    float ra[4], rc[4], rx[4], xacc[kGramXC / 2] = {0.f, 0.f, 0.f, 0.f};
    auto load = [&](int t) {
      const int cell = cell_begin + t * kGramBK + lc;
      gram_ld4(pA, cell, cell_end, vec, ra);
      if (kCounts && pc != nullptr) gram_ld4(pc, cell_begin + t * kGramBK + 4 * tid, cell_end, vec, rc);
      if (tid < 2 * kGramXC) gram_ld4(pX, cell, cell_end, vec, rx);
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int u = 0; u < 4; ++u) As[buf][lc + u][lr] = ra[u];
      if (kCounts && pc != nullptr)
        *reinterpret_cast<float4*>(&Cs[buf][4 * tid]) = make_float4(rc[0], rc[1], rc[2], rc[3]);
      if (tid < 2 * kGramXC)
        *reinterpret_cast<float4*>(&Xs[buf][xe][lc]) = make_float4(rx[0], rx[1], rx[2], rx[3]);
    };
    load(0);
    store(0);
    __syncthreads();
    for (int t = 0; t < n_chunks; ++t) {
      const int cur = t & 1;
      if (t + 1 < n_chunks) load(t + 1);
#pragma unroll
      for (int j = 0; j < kGramBK; ++j) {
        float av = As[cur][j][xr];
        if constexpr (kCounts) av = __fmul_rn(av, Cs[cur][j]);  // Hs's value
#pragma unroll
        for (int m = 0; m < kGramXC / 2; ++m) {
          const int e = xg + 2 * m;
          if (e < xn) xacc[m] = fmaf(av, e < xq ? Xs[cur][e][j] : 1.f, xacc[m]);
        }
      }
      if (t + 1 < n_chunks) store(cur ^ 1);
      __syncthreads();
    }
    float* px = base + (size_t)n_pairs * (kCounts ? 2 : 1) * kGramTile +
                ((size_t)ti * (L + 1) + x0) * kGramBM;
#pragma unroll
    for (int m = 0; m < kGramXC / 2; ++m) {
      const int e = xg + 2 * m;
      if (e < xn) px[(size_t)e * kGramBM + xr] = xacc[m];
    }
    return;
  }

  const bool diag = ti == tj;
  const float* pB = tj * kGramBM + lr < K ? Hn + (size_t)(tj * kGramBM + lr) * n : nullptr;
  float ra[4], rb[4], rc[4];
  auto load = [&](int t) {
    const int cell = cell_begin + t * kGramBK + lc;
    gram_ld4(pA, cell, cell_end, vec, ra);
    if (!diag) gram_ld4(pB, cell, cell_end, vec, rb);
    if (kCounts && pc != nullptr) gram_ld4(pc, cell_begin + t * kGramBK + 4 * tid, cell_end, vec, rc);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < 4; ++u) As[buf][lc + u][lr] = ra[u];
    if (!diag) {
#pragma unroll
      for (int u = 0; u < 4; ++u) Bs[buf][lc + u][lr] = rb[u];
    }
    if (kCounts && pc != nullptr)
      *reinterpret_cast<float4*>(&Cs[buf][4 * tid]) = make_float4(rc[0], rc[1], rc[2], rc[3]);
  };

  float acc[8][8], accU[kCounts ? 8 : 1][kCounts ? 8 : 1];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      acc[i][u] = 0.f;
      if constexpr (kCounts) accU[i][u] = 0.f;
    }
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < n_chunks; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_chunks) load(t + 1);
    const float(*sB)[kGramLDT] = diag ? As[cur] : Bs[cur];
#pragma unroll
    for (int j = 0; j < kGramBK; ++j) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][j][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][j][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sB[j][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sB[j][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      if constexpr (kCounts) {
        const float cj = Cs[cur][j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float as = __fmul_rn(a[i], cj);  // Hs's value
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            acc[i][u] = fmaf(as, b[u], acc[i][u]);
            accU[i][u] = fmaf(a[i], b[u], accU[i][u]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int u = 0; u < 8; ++u) acc[i][u] = fmaf(a[i], b[u], acc[i][u]);
      }
    }
    // the other buffer was last read before the previous chunk's barrier
    if (t + 1 < n_chunks) store(cur ^ 1);
    __syncthreads();
  }
  // the pair's partial of this split, in thread order
  float* pt = base + (size_t)gram_pair_index(ti, tj, T) * (kCounts ? 2 : 1) * kGramTile;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      pt[(i * 8 + u) * kThreads + tid] = acc[i][u];
      if constexpr (kCounts) pt[kGramTile + (i * 8 + u) * kThreads + tid] = accU[i][u];
    }
}

// Sum the splits' partials in split order and lay them out: HHt (and HHtU)
// mirrored from the upper triangle, rowsum (the ones column) and Bnum (the
// Q columns, L x K).  One thread a slot of a split's partial, so each
// split's reads are contiguous across a warp: a tile pair's slot (i, u,
// ty, tx) is entry (ia, ib) = (rows 4 ty + i / 64 + 4 ty + i - 4, columns
// likewise) and, below the diagonal of a diagonal tile, no output.
__global__ void __launch_bounds__(kThreads)
gram_reduce(const float* __restrict__ part, int n_split, int K, int L, int nmat,
            float* __restrict__ hht, float* __restrict__ hhtu, float* __restrict__ rowsum,
            float* __restrict__ bnum) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int T = (K + kGramBM - 1) / kGramBM;
  const size_t stride = gram_split_floats(K, L, nmat);
  const size_t n_tiles = (size_t)gram_pairs(T) * nmat * kGramTile;
  if (idx >= stride) return;
  float v = 0.f;
  for (int sp = 0; sp < n_split; ++sp) v += part[(size_t)sp * stride + idx];
  if (idx < n_tiles) {
    int p = (int)(idx / kGramTile);
    const int mat = p % nmat, slot = (int)(idx % kGramTile);
    p /= nmat;
    int ta = 0;
    while (p >= T - ta) p -= T - ta, ++ta;
    const int tb = ta + p;
    const int i = slot / (8 * kThreads), u = (slot / kThreads) % 8, t = slot % kThreads;
    const int ia = (i / 4) * 64 + 4 * (t / 16) + i % 4, ib = (u / 4) * 64 + 4 * (t % 16) + u % 4;
    const int a = ta * kGramBM + ia, b = tb * kGramBM + ib;
    if (a >= K || b >= K || (ta == tb && ia > ib)) return;
    float* out = mat == 0 ? hht : hhtu;
    out[(size_t)a * K + b] = v;
    out[(size_t)b * K + a] = v;
    return;
  }
  const size_t x = idx - n_tiles;  // [row tile][column e][row]: e < L Bnum row e, e == L rowsum
  const int k = (int)(x / ((size_t)(L + 1) * kGramBM)) * kGramBM + (int)(x % kGramBM);
  const int e = (int)(x / kGramBM % (L + 1));
  if (k >= K) return;
  if (e < L) bnum[(size_t)e * K + k] = v;
  else rowsum[k] = v;
}

// gram_wide over n_split splits of cells_per_split cells, then gram_reduce.
// c: the counts row (counts mode) or nullptr; Q: L x n (nullptr at L = 0);
// part: n_split x gram_split_floats(K, L, 1 or 2) scratch; hhtu only in
// counts mode.
static int launch_gram_wide(const float* Hn, const float* c, const float* Q, int K, int n,
                            int L, int n_split, int cells_per_split, float* part, float* hht,
                            float* hhtu, float* rowsum, float* bnum, cudaStream_t stream) {
  const bool counts = c != nullptr;
  if (K < 1 || n < 1 || L < 0 || (L > 0 && Q == nullptr) || n_split < 1 ||
      cells_per_split < 1 || cells_per_split % kGramBK != 0 ||
      (long long)n_split * cells_per_split < n ||
      (long long)(n_split - 1) * cells_per_split >= n || gram_items(K, L) > 65535 ||
      (counts && hhtu == nullptr))
    return (int)cudaErrorInvalidValue;
  // the splits fastest: every pair's blocks are dispatched before the
  // extra columns' short ones, which fill the slots the pairs leave
  const dim3 grid(n_split, gram_items(K, L));
  if (counts)
    gram_wide<true><<<grid, kThreads, 0, stream>>>(Hn, c, Q, K, n, L, cells_per_split, part);
  else
    gram_wide<false><<<grid, kThreads, 0, stream>>>(Hn, c, Q, K, n, L, cells_per_split, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nmat = counts ? 2 : 1;
  const size_t total = gram_split_floats(K, L, nmat);
  gram_reduce<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, n_split, K, L, nmat, hht, hhtu, rowsum, bnum);
  return (int)cudaGetLastError();
}

}  // namespace alpine

// Design variants of gram_wide (alpine_tpu_torch/csrc/gram_wide.cuh), built
// and timed by scripts/torch_gram_variants.py.  Every variant writes the
// kernel's partials in its layout and ends in its gram_reduce, and every
// accumulator sums its cells in the same order, so on the same splits a
// variant gives the kernel's bits.  The variants feed the products through
// a ring of stages filled by 16-byte cp.async (4-byte copies where rows are
// not 16-byte aligned), in Hn's own [row][cell] layout:
//   ring16_turn (variant 1): 4 stages of 16 cells; each stage's row tiles
//     are turned to [cell][row] in a second buffer and multiplied by the
//     kernel's loop (thread (ty, tx): rows 4 ty + i and 64 + 4 ty + i by
//     the same columns); two blocks an SM without counts.
//   ring32_direct (variant 2): 4 stages of 32 cells, multiplied straight
//     from the ring: thread (ty, tx) owns rows ty + 16 i by columns
//     tx + 16 u and reads 4 cells of each (2 in counts mode) in one
//     16-byte (8-byte) load; one block an SM.
// Variant 0 is the kernel as it is.  The extra columns (rows of Q and the
// ones row) take blocks of their own in every variant, as in the kernel.

#include "gram_wide.cuh"

namespace alpine {
namespace variants {

// cp.async of 4 bytes (an fp32 value), or 4 zero bytes when !full.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

// The slot of tile entry (r, c) in a pair's partial: thread
// ((r % 64) / 4) * 16 + (c % 64) / 4 of the kernel holds it as acc[i][u],
// i = 4 (r / 64) + r % 4, u = 4 (c / 64) + c % 4.
__device__ __forceinline__ int gram_slot(int r, int c) {
  const int i = 4 * (r / 64) + r % 4, u = 4 * (c / 64) + c % 4;
  return (i * 8 + u) * kThreads + ((r % 64) / 4) * 16 + (c % 64) / 4;
}

template <int BK>
__host__ __device__ constexpr int ring_stage_floats() {  // the A and B row tiles, c, the Q rows
  return 2 * kGramBM * (BK + 4) + BK + kGramXC * (BK + 4);
}

template <int BK, int S, bool kTurn>
constexpr size_t ring_smem() {
  return ((size_t)S * ring_stage_floats<BK>() + (kTurn ? 2 * BK * kGramLDT : 0)) *
         sizeof(float);
}

template <int BK, int S, bool kTurn, bool kCounts>
__global__ void __launch_bounds__(kThreads, kTurn && !kCounts ? 2 : 1)
gram_ring(const float* __restrict__ Hn, const float* __restrict__ c,
          const float* __restrict__ Q, int K, int n, int L, int cells_per_split,
          float* __restrict__ part) {
  constexpr int LD = BK + 4, kStage = ring_stage_floats<BK>();
  extern __shared__ __align__(16) float ring[];
  float* turned = ring + (size_t)S * kStage;  // [2][BK][kGramLDT] (kTurn)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int T = (K + kGramBM - 1) / kGramBM, n_pairs = gram_pairs(T);
  const int split = blockIdx.x, item = blockIdx.y;
  const int cell_begin = split * cells_per_split;
  const int cell_end = min(n, cell_begin + cells_per_split);
  const int n_steps = (cell_end - cell_begin + BK - 1) / BK;
  const bool vec = (n % 4) == 0 && (reinterpret_cast<uintptr_t>(Hn) & 15) == 0 &&
                   (!kCounts || (reinterpret_cast<uintptr_t>(c) & 15) == 0) &&
                   (L == 0 || (reinterpret_cast<uintptr_t>(Q) & 15) == 0);
  float* base = part + (size_t)split * gram_split_floats(K, L, kCounts ? 2 : 1);
  int ti, tj = -1, x0 = 0;
  if (item < n_pairs) {
    int p = item;
    ti = 0;
    while (p >= T - ti) p -= T - ti, ++ti;
    tj = ti + p;
  } else {
    ti = (item - n_pairs) % T, x0 = kGramXC * ((item - n_pairs) / T);
  }
  const bool gram = tj >= 0, diag = ti == tj;
  const int xn = gram ? 0 : min(kGramXC, L + 1 - x0);
  const int xq = max(0, min(xn, L - x0));
  const int rA = ti * kGramBM, rB = (gram ? tj : ti) * kGramBM;

  auto load = [&](int slot, int step) {
    float* st = ring + (size_t)slot * kStage;
    float* sc = st + 2 * kGramBM * LD;
    float* sX = sc + BK;
    const int cell0 = cell_begin + step * BK;
    const int tiles = gram && !diag ? 2 : 1;
    if (vec) {
      for (int t = 0; t < tiles; ++t) {
        float* dst = st + t * kGramBM * LD;
        const int r0 = t == 0 ? rA : rB;
#pragma unroll
        for (int v = tid; v < kGramBM * BK / 4; v += kThreads) {
          const int r = v / (BK / 4), cc = (v % (BK / 4)) * 4;
          const int row = r0 + r, cell = cell0 + cc;
          const bool full = row < K && cell < cell_end;
          cp_async16(dst + r * LD + cc, Hn + (full ? (size_t)row * n + cell : 0), full);
        }
      }
      if (kCounts && tid < BK / 4) {
        const int cell = cell0 + 4 * tid;
        const bool full = cell < cell_end;
        cp_async16(sc + 4 * tid, c + (full ? cell : 0), full);
      }
      for (int v = tid; v < xq * (BK / 4); v += kThreads) {
        const int e = v / (BK / 4), cc = (v % (BK / 4)) * 4;
        const int cell = cell0 + cc;
        const bool full = cell < cell_end;
        cp_async16(sX + e * LD + cc, Q + (full ? (size_t)(x0 + e) * n + cell : 0), full);
      }
    } else {
      for (int t = 0; t < tiles; ++t) {
        float* dst = st + t * kGramBM * LD;
        const int r0 = t == 0 ? rA : rB;
        for (int v = tid; v < kGramBM * BK; v += kThreads) {
          const int r = v / BK, cc = v % BK;
          const int row = r0 + r, cell = cell0 + cc;
          const bool full = row < K && cell < cell_end;
          cp_async4(dst + r * LD + cc, Hn + (full ? (size_t)row * n + cell : 0), full);
        }
      }
      if (kCounts && tid < BK) {
        const int cell = cell0 + tid;
        const bool full = cell < cell_end;
        cp_async4(sc + tid, c + (full ? cell : 0), full);
      }
      for (int v = tid; v < xq * BK; v += kThreads) {
        const int e = v / BK, cc = v % BK;
        const int cell = cell0 + cc;
        const bool full = cell < cell_end;
        cp_async4(sX + e * LD + cc, Q + (full ? (size_t)(x0 + e) * n + cell : 0), full);
      }
    }
  };
  // stage `step` has landed and every thread is past step - 1, whose slot
  // the next load then refills
  auto next = [&](int step) {
    cp_async_wait(S - 2);
    __syncthreads();
    if (step + S - 1 < n_steps) load((step + S - 1) % S, step + S - 1);
    cp_async_commit();
    return ring + (size_t)(step % S) * kStage;
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_steps) load(s, s);
    cp_async_commit();
  }

  if (!gram) {  // extra columns x0 + xg, x0 + xg + 2, ... of row xr
    const int xr = tid % kGramBM, xg = tid / kGramBM;
    float xacc[kGramXC / 2] = {0.f, 0.f, 0.f, 0.f};
    for (int step = 0; step < n_steps; ++step) {
      const float* st = next(step);
      const float* sc = st + 2 * kGramBM * LD;
      const float* sX = sc + BK;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        float av = st[xr * LD + j];
        if constexpr (kCounts) av = __fmul_rn(av, sc[j]);  // Hs's value
#pragma unroll
        for (int m = 0; m < kGramXC / 2; ++m) {
          const int e = xg + 2 * m;
          if (e < xn) xacc[m] = fmaf(av, e < xq ? sX[e * LD + j] : 1.f, xacc[m]);
        }
      }
    }
    cp_async_wait(0);
    float* px = base + (size_t)n_pairs * (kCounts ? 2 : 1) * kGramTile +
                ((size_t)ti * (L + 1) + x0) * kGramBM;
#pragma unroll
    for (int m = 0; m < kGramXC / 2; ++m) {
      const int e = xg + 2 * m;
      if (e < xn) px[(size_t)e * kGramBM + xr] = xacc[m];
    }
    return;
  }

  float acc[8][8], accU[kCounts ? 8 : 1][kCounts ? 8 : 1];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      acc[i][u] = 0.f;
      if constexpr (kCounts) accU[i][u] = 0.f;
    }
  // one cell: a thread's 8 row values by its 8 column values
  auto fma_cell = [&](const float(&a)[8], const float(&b)[8], float cj) {
    if constexpr (kCounts) {
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
  };
  for (int step = 0; step < n_steps; ++step) {
    const float* st = next(step);
    const float* sc = st + 2 * kGramBM * LD;
    if constexpr (kTurn) {
      const float* tA = turned;
      const float* tB = diag ? turned : turned + BK * kGramLDT;
      for (int t = 0; t < (diag ? 1 : 2); ++t) {
#pragma unroll
        for (int v = tid; v < kGramBM * BK / 4; v += kThreads) {
          const int r = v / (BK / 4), cc = (v % (BK / 4)) * 4;
          const float4 x = *reinterpret_cast<const float4*>(st + t * kGramBM * LD + r * LD + cc);
          float* dst = turned + t * BK * kGramLDT + r;
          dst[(cc + 0) * kGramLDT] = x.x;
          dst[(cc + 1) * kGramLDT] = x.y;
          dst[(cc + 2) * kGramLDT] = x.z;
          dst[(cc + 3) * kGramLDT] = x.w;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float4 a0 = *reinterpret_cast<const float4*>(tA + j * kGramLDT + 4 * ty);
        const float4 a1 = *reinterpret_cast<const float4*>(tA + j * kGramLDT + 64 + 4 * ty);
        const float4 b0 = *reinterpret_cast<const float4*>(tB + j * kGramLDT + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(tB + j * kGramLDT + 64 + 4 * tx);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        fma_cell(a, b, kCounts ? sc[j] : 1.f);
      }
    } else {
      const float* sA = st;
      const float* sB = diag ? st : st + kGramBM * LD;
      constexpr int CW = kCounts ? 2 : 4;  // cells a read
#pragma unroll
      for (int j = 0; j < BK; j += CW) {
        float ra[8][CW], rb[8][CW];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float* pa = sA + (ty + 16 * i) * LD + j;
          const float* pb = sB + (tx + 16 * i) * LD + j;
          if constexpr (CW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(pa);
            const float4 y = *reinterpret_cast<const float4*>(pb);
            ra[i][0] = x.x, ra[i][1] = x.y, ra[i][2] = x.z, ra[i][3] = x.w;
            rb[i][0] = y.x, rb[i][1] = y.y, rb[i][2] = y.z, rb[i][3] = y.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(pa);
            const float2 y = *reinterpret_cast<const float2*>(pb);
            ra[i][0] = x.x, ra[i][1] = x.y;
            rb[i][0] = y.x, rb[i][1] = y.y;
          }
        }
#pragma unroll
        for (int q = 0; q < CW; ++q) {
          float a[8], b[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = ra[i][q], b[i] = rb[i][q];
          fma_cell(a, b, kCounts ? sc[j + q] : 1.f);
        }
      }
    }
  }
  cp_async_wait(0);
  float* pt = base + (size_t)gram_pair_index(ti, tj, T) * (kCounts ? 2 : 1) * kGramTile;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int slot = kTurn ? (i * 8 + u) * kThreads + tid : gram_slot(ty + 16 * i, tx + 16 * u);
      pt[slot] = acc[i][u];
      if constexpr (kCounts) pt[kGramTile + slot] = accU[i][u];
    }
}

template <int BK, int S, bool kTurn>
static int launch_ring(const float* Hn, const float* c, const float* Q, int K, int n, int L,
                       int n_split, int cells_per_split, float* part, float* hht, float* hhtu,
                       float* rowsum, float* bnum, cudaStream_t stream) {
  const bool counts = c != nullptr;
  if (K < 1 || n < 1 || L < 0 || (L > 0 && Q == nullptr) || n_split < 1 ||
      cells_per_split < 1 || cells_per_split % BK != 0 ||
      (long long)n_split * cells_per_split < n ||
      (long long)(n_split - 1) * cells_per_split >= n || gram_items(K, L) > 65535 ||
      (counts && hhtu == nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = ring_smem<BK, S, kTurn>();
  const void* kernel = counts ? reinterpret_cast<const void*>(gram_ring<BK, S, kTurn, true>)
                              : reinterpret_cast<const void*>(gram_ring<BK, S, kTurn, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_split, gram_items(K, L));
  if (counts)
    gram_ring<BK, S, kTurn, true><<<grid, kThreads, smem, stream>>>(Hn, c, Q, K, n, L,
                                                                     cells_per_split, part);
  else
    gram_ring<BK, S, kTurn, false><<<grid, kThreads, smem, stream>>>(Hn, c, Q, K, n, L,
                                                                      cells_per_split, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nmat = counts ? 2 : 1;
  const size_t total = gram_split_floats(K, L, nmat);
  gram_reduce<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, n_split, K, L, nmat, hht, hhtu, rowsum, bnum);
  return (int)cudaGetLastError();
}

}  // namespace variants
}  // namespace alpine

// alpine_gram_wide's arguments (csrc/x_passes.cu) after the variant's number
// (0: the kernel, 1: ring16_turn, 2: ring32_direct); cells_per_split must be
// a multiple of the variant's stage (8, 16, 32 cells).
extern "C" int gram_variant(int variant, const float* Hn, const float* c, const float* Q, int K,
                            int n, int L, int n_split, int cells_per_split, float* part,
                            float* hht, float* hhtu, float* rowsum, float* bnum, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return alpine::launch_gram_wide(Hn, c, Q, K, n, L, n_split, cells_per_split, part, hht,
                                      hhtu, rowsum, bnum, s);
    case 1:
      return alpine::variants::launch_ring<16, 4, true>(Hn, c, Q, K, n, L, n_split,
                                                        cells_per_split, part, hht, hhtu,
                                                        rowsum, bnum, s);
    case 2:
      return alpine::variants::launch_ring<32, 4, false>(Hn, c, Q, K, n, L, n_split,
                                                         cells_per_split, part, hht, hhtu,
                                                         rowsum, bnum, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The whole out-of-sample projection loop: all n_iter steps of
// H <- H * num2 / max(WtW2 H, eps) on chip, for every cell at once.
//
// Replaces: alpine_tpu/ops/pallas_kernels.py:fused_transform
// (_transform_kernel).  num2 = 2 W^T X and WtW2 = 2 W^T W are loop-invariant
// and computed outside the kernel, as the JAX package leaves them to XLA.
//
// Bound on the H100: operations.  The loop reads num2 and H0 and writes H
// once (12 bytes per cell and component) but does 2 K^2 + 3 K fp32
// operations per cell and step: at K = 40 and 50 steps that is about 270
// flop per byte, at K = 300 about 2,100.
//
// Why the CUDA cores and not the tensor cores: the transform runs at
// matmul_precision "highest", which is true fp32.  TF32 would drop mantissa
// bits, and a 3xTF32 split would change every bit of the result for a K x K
// operand this small.  So both paths aim at the fp32 FMA rate, and both
// form every sum the same way: d from 0.f by fmaf over j in order, zeros
// past K (fmaf(0, 0, d) = d), IEEE division (no fast-math).  So the two
// paths give the same bits, and a rule by K picks one
// (ops/kernels.py:transform_bucket).
//
// Register path (transform_columns, K up to the largest bucket): the columns of H
// are independent, so no step needs a block barrier or H in shared memory.
// Two lanes of a warp, l and l ^ 16, own the same two cells and keep both
// cells' K values of H in registers for all n_iter steps.  In a step each of
// the two forms half of the K sums d_k = sum_j WtW2[k][j] h_j for both cells
// (j outer, so the K chains are independent and fill the FMA pipe), updates
// its rows h_k <- h_k * (num2_k / max(d_k, eps)) in place, and the two swap
// their updated halves with one shuffle per row and cell.  K is a template
// parameter (loops fully unrolled, so h and d stay in registers), rounded up
// to a bucket; WtW2 and H are padded with zeros after j = K - 1 and the
// padded rows stay 0.  num2 sits in shared memory, each thread reading its
// own rows.
//
// WtW2 is uniform across each half-warp: it sits transposed in shared memory,
// and one 16-byte broadcast load feeds eight FMAs (four rows, two cells).
// With one cell a thread it fed four, and on an H100 that kernel ran at the
// rate of those loads, slower than this one (PERF.md).  Constant memory was
// tried first: ptxas (CUDA 12.9, sm_90a) does not fold a constant-bank
// operand into FFMA here but loads each entry into a uniform register with a
// ULDC of its own, and on an H100 that kernel ran slower than the tiled one.
// An empty asm with a "memory" clobber at the top
// of each step keeps ptxas from hoisting the K^2 loop-invariant loads out of
// the step loop, which would need K^2 registers and spill.
//
// Tiled path (transform_tiles<T, G>, above the largest bucket, where a
// cell's column no longer fits in registers): one block owns a tile of T
// cells for all n_iter steps.  H's tile (KP x T, K padded to KP) stays in
// shared memory; WtW2, transposed and zero-padded to KP x KP once a call
// (pad_transpose), streams from L2 through a cp.async ring of S stages of J
// rows [j][k] each, one barrier a chunk.  The 256 threads are TR = 2048 / T
// along K by T / 8 along the cells; each holds a register micro-tile of G
// pairs of rows (2 (TR i + tr) + u) by 8 cells (4 tc + v and T / 2 + 4 tc +
// v), and its outputs' num2, loaded once: for every j one 8-byte load of
// the ring a pair and two 16-byte loads of H's tile feed 16 G FMAs.  A
// warp's lanes are 4 (8 at T = 32) along K by 8 (4) along the cells, so its
// loads touch contiguous bytes.  num2 in registers leaves room beside H's
// tile for chunks of 32 rows, and fewer chunks a step cost less.  After a
// step's last chunk each thread forms its ratios num2 / max(d, eps) in
// registers; one barrier; then it multiplies its outputs in the H tile in
// place (the next chunk's barrier orders them before any read).  Padded
// rows (k >= K) stay 0: they are never updated, and their ratio is 1 / 1
// (no 0 / 0 at eps = 0); cells past n are never written and no other
// cell's sum reads them.  ops/kernels.py:transform_tiles_grid picks T = 64
// (KP = 64 G up to 384) or T = 32 (KP = 512), with J = 32 and S = 2.  WtW2
// then crosses from L2 n / T * n_iter * 4 KP^2 bytes a call: 32 GB at
// K = 300 (KP = 320), 100k cells and 50 steps, a seventh of the 225 GB
// that the earlier kernel (8 cells a block, WtW2 read once an output) read.
//
// Per-step path (K > 512): WtW2 transposed once a call into a K x K
// scratch (wtw_gemm.cuh: wtw_transpose), then one launch a step of
// wtw_gemm.cuh's fp32 product WtW2 H with the update in its epilogue, both
// operands through its cp.async ring, H ping-ponged between `out` and a
// K x n scratch, so the last step lands in `out`.  Its sums and update are
// formed as above: the same bits as the tiled path.
#include "common.cuh"
#include "wtw_gemm.cuh"

namespace alpine {

// threads of a transform_columns block: four warps, 32 cells each
constexpr int kColThreads = 128;

// Blocks an SM should hold: three up to bucket 40 (at most 170 registers a
// thread), as many as fit above.
constexpr int columns_min_blocks(int KB) { return KB <= 40 ? 3 : 1; }

template <int KB>
__global__ void __launch_bounds__(kColThreads, columns_min_blocks(KB))
transform_columns(const float* __restrict__ num2, const float* __restrict__ H0,
                  const float* __restrict__ WtW2, int K, int n, int n_iter,
                  float eps, float* __restrict__ out) {
  constexpr int HK = KB / 2;    // rows of the sums a thread forms
  extern __shared__ __align__(16) float sm[];
  float* sWt = sm;              // [j][k]: WtW2 transposed, zero-padded to KB
  float* sStart = sWt + KB * KB;  // [k]: where row k's sum starts
  float* sNum = sStart + KB;    // [row][cell][thread]: this thread's rows
  const int tid = threadIdx.x;
  for (int o = tid; o < KB * KB; o += kColThreads) {
    const int j = o / KB, k = o - j * KB;
    sWt[o] = (j < K && k < K) ? WtW2[k * K + j] : 0.f;
  }
  for (int k = tid; k < KB; k += kColThreads) sStart[k] = k < K ? 0.f : 1.f;
  __syncthreads();
  // lanes l and l ^ 16 of a warp own the same two cells, c0 and c1
  const int warp_c = blockIdx.x * kColThreads + (tid & ~31);
  if (warp_c >= n) return;  // whole warps only: the step ends in a shuffle
  const int half = (tid >> 4) & 1;
  const int c0 = warp_c + (tid & 15), c1 = c0 + 16;
  const bool ok0 = c0 < n, ok1 = c1 < n;
  float h0[KB], h1[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    h0[k] = (k < K && ok0) ? H0[(size_t)k * n + c0] : 0.f;
    h1[k] = (k < K && ok1) ? H0[(size_t)k * n + c1] : 0.f;
  }
  // Padded rows (and cells past n) take num2 = 1 and start their sums at
  // 1: their h stays 0 = 0 * (1 / max(1, eps)) without a 0 / eps, which
  // would take the IEEE division's slow path, and without a 0 / 0 at eps = 0.
#pragma unroll
  for (int r = 0; r < HK; ++r) {
    const int k = half * HK + r;
    sNum[2 * r * kColThreads + tid] = (k < K && ok0) ? num2[(size_t)k * n + c0] : 1.f;
    sNum[(2 * r + 1) * kColThreads + tid] = (k < K && ok1) ? num2[(size_t)k * n + c1] : 1.f;
  }
  const float* wrows = sWt + half * HK;
  const float4* start = reinterpret_cast<const float4*>(sStart + half * HK);
  for (int it = 0; it < n_iter; ++it) {
    asm volatile("" ::: "memory");
    float d0[HK], d1[HK];
    if (K == KB) {  // no padded rows: every sum starts at 0, without loads
#pragma unroll
      for (int r = 0; r < HK; ++r) d0[r] = d1[r] = 0.f;
    } else {
#pragma unroll
      for (int q = 0; q < HK / 4; ++q) {
        const float4 v = start[q];
        d0[4 * q] = d1[4 * q] = v.x;
        d0[4 * q + 1] = d1[4 * q + 1] = v.y;
        d0[4 * q + 2] = d1[4 * q + 2] = v.z;
        d0[4 * q + 3] = d1[4 * q + 3] = v.w;
      }
    }
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const float4* col = reinterpret_cast<const float4*>(wrows + j * KB);
#pragma unroll
      for (int q = 0; q < HK / 4; ++q) {
        const float4 w = col[q];
        d0[4 * q] = fmaf(w.x, h0[j], d0[4 * q]);
        d0[4 * q + 1] = fmaf(w.y, h0[j], d0[4 * q + 1]);
        d0[4 * q + 2] = fmaf(w.z, h0[j], d0[4 * q + 2]);
        d0[4 * q + 3] = fmaf(w.w, h0[j], d0[4 * q + 3]);
        d1[4 * q] = fmaf(w.x, h1[j], d1[4 * q]);
        d1[4 * q + 1] = fmaf(w.y, h1[j], d1[4 * q + 1]);
        d1[4 * q + 2] = fmaf(w.z, h1[j], d1[4 * q + 2]);
        d1[4 * q + 3] = fmaf(w.w, h1[j], d1[4 * q + 3]);
      }
    }
    // update this thread's rows, then swap halves with lane ^ 16
#pragma unroll
    for (int r = 0; r < HK; ++r) {
      const float m0 = (half ? h0[HK + r] : h0[r]) *
                       (sNum[2 * r * kColThreads + tid] / fmaxf(d0[r], eps));
      const float m1 = (half ? h1[HK + r] : h1[r]) *
                       (sNum[(2 * r + 1) * kColThreads + tid] / fmaxf(d1[r], eps));
      const float o0 = __shfl_xor_sync(0xffffffffu, m0, 16);
      const float o1 = __shfl_xor_sync(0xffffffffu, m1, 16);
      h0[r] = half ? o0 : m0;
      h0[HK + r] = half ? m0 : o0;
      h1[r] = half ? o1 : m1;
      h1[HK + r] = half ? m1 : o1;
    }
  }
#pragma unroll
  for (int r = 0; r < HK; ++r) {
    const int k = half * HK + r;
    if (k < K) {
      if (ok0) out[(size_t)k * n + c0] = half ? h0[HK + r] : h0[r];
      if (ok1) out[(size_t)k * n + c1] = half ? h1[HK + r] : h1[r];
    }
  }
}

// Threads of a transform_tiles block along K for T cells a tile (8 cells a
// thread), and the K it pads to with G pairs of rows a thread.
__host__ __device__ constexpr int tiles_rows(int T) { return kThreads / (T / 8); }
__host__ __device__ constexpr int tiles_kp(int T, int G) { return 2 * tiles_rows(T) * G; }

// Blocks an SM should hold: two up to 2 pairs of a 64-cell tile (32
// accumulators and 32 num2, at most 128 registers a thread), one above.
// ops/kernels.py:transform_blocks_per_sm holds the same rule.
constexpr int tiles_min_blocks(int T, int G) { return T == 64 && G <= 2 ? 2 : 1; }

// Shared memory of transform_tiles: H's tile (KP x T) and S stages of J
// rows of the padded WtW2^T (KP each).
// ops/kernels.py:transform_tiles_smem_bytes holds the same formula.
__host__ __device__ inline size_t tiles_smem_bytes(int KP, int T, int J, int S) {
  return ((size_t)KP * T + (size_t)S * J * KP) * sizeof(float);
}

// Wt[j][k] = WtW2[k][j] for j, k < K, else 0: an exact copy, once a call.
__global__ void pad_transpose(const float* __restrict__ WtW2, int K, int KP,
                              float* __restrict__ Wt) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o < KP * KP) {
    const int j = o / KP, k = o - j * KP;
    Wt[o] = (j < K && k < K) ? WtW2[k * K + j] : 0.f;
  }
}

template <int T, int G>
__global__ void __launch_bounds__(kThreads, tiles_min_blocks(T, G))
transform_tiles(const float* __restrict__ num2, const float* __restrict__ H0,
                const float* __restrict__ Wt, int K, int n, int n_iter, int J,
                int S, float eps, float* __restrict__ out) {
  constexpr int TR = tiles_rows(T), KP = tiles_kp(T, G);
  constexpr int LC = T / 8 < 8 ? T / 8 : 8;  // a warp's lanes along the cells
  static_assert(KP * T % (8 * kThreads) == 0, "the tile loads eight values a thread");
  extern __shared__ __align__(16) float sm[];
  float* sH = sm;             // [k][T]: H's tile, updated in place
  float* ring = sH + KP * T;  // S stages of [j][KP], J rows each
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tr = warp * (32 / LC) + lane / LC, tc = lane % LC;
  const int c0 = blockIdx.x * T, nv = min(T, n - c0);
  const int stage = J * KP, steps_chunks = KP / J, n_chunks = n_iter * steps_chunks;

  // chunk q (rows (q mod KP / J) J .. + J - 1 of Wt) into stage st; one group
  // committed, empty past the last chunk
  auto issue = [&](int q, int st) {
    if (q < n_chunks) {
      const float* src = Wt + (size_t)(q % steps_chunks) * stage;
      float* dst = ring + st * stage;
      for (int o = 4 * tid; o < stage; o += 4 * kThreads) cp_async16(dst + o, src + o, true);
    }
    cp_async_commit();
  };
  for (int q = 0; q < S - 1; ++q) issue(q, q);
  // rows past K and cells past n: H 0 (never written); eight loads in flight
  // a thread (KP T is a multiple of 8 x 256), as one block holds an SM
  for (int o0 = tid; o0 < KP * T; o0 += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int o = o0 + q * kThreads, k = o / T, t = o % T;
      v[q] = k < K && t < nv ? H0[(size_t)k * n + c0 + t] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) sH[o0 + q * kThreads] = v[q];
  }
  // this thread's outputs: rows 2 (TR i + tr) + u, cells v / 4 * T / 2 + 4 tc
  // + v % 4; num2 1 past K and n
  float num[G][2][8], acc[G][2][8];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int k = 2 * (TR * i + tr) + u, t = v / 4 * (T / 2) + 4 * tc + v % 4;
        num[i][u][v] = k < K && t < nv ? num2[(size_t)k * n + c0 + t] : 1.f;
      }

  int st = 0;  // stage of the next chunk
  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[i][u][v] = 0.f;
    for (int c = 0; c < steps_chunks; ++c) {
      cp_async_wait(S - 2);  // this thread's copies of the chunk
      // the chunk has landed; every warp is done with the last one, whose
      // stage the next copies refill (and, at a step's first chunk, has
      // updated its outputs in the H tile)
      __syncthreads();
      issue(it * steps_chunks + c + S - 1, st == 0 ? S - 1 : st - 1);
      const float* w = ring + st * stage + 2 * tr;
      const float* h = sH + c * J * T + 4 * tc;
      for (int j0 = 0; j0 < J; j0 += 8) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = j0 + jj;
          const float4 ha = *reinterpret_cast<const float4*>(h + j * T);
          const float4 hb = *reinterpret_cast<const float4*>(h + j * T + T / 2);
#pragma unroll
          for (int i = 0; i < G; ++i) {
            const float2 wv = *reinterpret_cast<const float2*>(w + j * KP + 2 * TR * i);
            const float wu[2] = {wv.x, wv.y};
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              acc[i][u][0] = fmaf(wu[u], ha.x, acc[i][u][0]);
              acc[i][u][1] = fmaf(wu[u], ha.y, acc[i][u][1]);
              acc[i][u][2] = fmaf(wu[u], ha.z, acc[i][u][2]);
              acc[i][u][3] = fmaf(wu[u], ha.w, acc[i][u][3]);
              acc[i][u][4] = fmaf(wu[u], hb.x, acc[i][u][4]);
              acc[i][u][5] = fmaf(wu[u], hb.y, acc[i][u][5]);
              acc[i][u][6] = fmaf(wu[u], hb.z, acc[i][u][6]);
              acc[i][u][7] = fmaf(wu[u], hb.w, acc[i][u][7]);
            }
          }
        }
      }
      st = st + 1 == S ? 0 : st + 1;
    }
    // the ratios, in registers, before the barrier; a padded row divides its
    // num2 of 1 by 1 (no 0 / 0 at eps = 0, no slow path) and is never written
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const bool real = 2 * (TR * i + tr) + u < K;
#pragma unroll
        for (int v = 0; v < 8; ++v)
          acc[i][u][v] = num[i][u][v] / (real ? fmaxf(acc[i][u][v], eps) : 1.f);
      }
    __syncthreads();  // every warp has read this step's H tile
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = 2 * (TR * i + tr) + u;
        if (k < K) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float4* hp = reinterpret_cast<float4*>(sH + k * T + half * (T / 2) + 4 * tc);
            float4 hv = *hp;
            hv.x = hv.x * acc[i][u][4 * half];
            hv.y = hv.y * acc[i][u][4 * half + 1];
            hv.z = hv.z * acc[i][u][4 * half + 2];
            hv.w = hv.w * acc[i][u][4 * half + 3];
            *hp = hv;
          }
        }
      }
  }
  cp_async_wait(0);
  __syncthreads();  // the last step's outputs (or, at n_iter = 0, H0)
  for (int o = tid; o < K * T; o += kThreads) {
    const int k = o / T, t = o % T;
    if (t < nv) out[(size_t)k * n + c0 + t] = sH[o];
  }
}

template <int T, int G>
cudaError_t launch_tiles(const float* num2, const float* H0, const float* WtW2, int K,
                         int n, int J, int S, int n_iter, float eps, float* Wt,
                         float* out, cudaStream_t stream) {
  constexpr int KP = tiles_kp(T, G);
  const size_t smem = tiles_smem_bytes(KP, T, J, S);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      transform_tiles<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  pad_transpose<<<(KP * KP + kThreads - 1) / kThreads, kThreads, 0, stream>>>(WtW2, K, KP, Wt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  transform_tiles<T, G><<<(n + T - 1) / T, kThreads, smem, stream>>>(
      num2, H0, Wt, K, n, n_iter, J, S, eps, out);
  return cudaGetLastError();
}

// WtW2's transpose into At (K x K), then n_iter launches of wtw_gemm's
// update: step i reads the previous step's H (H0 first) and writes the
// buffer that makes the last step write `out`.
static cudaError_t launch_steps(const float* num2, const float* H0, const float* WtW2, int K,
                                int n, int n_iter, float eps, float* scratch, float* At,
                                float* out, cudaStream_t stream) {
  if (n_iter == 0)
    return cudaMemcpyAsync(out, H0, (size_t)K * n * sizeof(float), cudaMemcpyDeviceToDevice,
                           stream);
  cudaError_t err = launch_wtw_transpose(WtW2, K, At, stream);
  if (err != cudaSuccess) return err;
  const float* src = H0;
  for (int it = 0; it < n_iter; ++it) {
    float* dst = (n_iter - 1 - it) % 2 == 0 ? out : scratch;
    err = launch_wtw_gemm<kGemmUpdate>(At, src, K, n, num2, eps, dst, stream);
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

template <int KB>
cudaError_t launch_columns(const float* num2, const float* H0,
                           const float* WtW2, int K, int n, int n_iter,
                           float eps, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)(KB * KB + KB + KB * kColThreads) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      transform_columns<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kColThreads - 1) / kColThreads;
  transform_columns<KB><<<blocks, kColThreads, smem, stream>>>(
      num2, H0, WtW2, K, n, n_iter, eps, out);
  return cudaGetLastError();
}

}  // namespace alpine

// Plain C entry point (ctypes).  Returns 0 or a cudaError_t code.  WtW2 is
// K x K.  KB is the bucket of transform_columns, or 0 for transform_tiles
// with T cells a tile, K padded to KP, S ring stages of J rows and Wt, a
// KP x KP scratch for WtW2 transposed and zero-padded
// (ops/kernels.py:transform_tiles_grid); T, KP, J, S and Wt are not read
// when KB > 0.  KB = 0 and T = 0: the per-step path, Wt a K x n scratch
// and At a K x K one (WtW2 transposed; ops/kernels.py:transform_path); At
// is read by that path alone.
extern "C" int alpine_fused_transform(const float* num2, const float* H0,
                                      const float* WtW2, int K, int KB, int n,
                                      int T, int KP, int J, int S, int n_iter,
                                      float eps, float* Wt, float* At, float* out,
                                      void* stream) {
  using namespace alpine;
  if (n <= 0 || K <= 0 || n_iter < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KB > 0) {
    if (K > KB) return (int)cudaErrorInvalidValue;
    switch (KB) {  // ops/kernels.py:_TRANSFORM_BUCKETS
#define ALPINE_BUCKET(B) \
  case B:                \
    return (int)launch_columns<B>(num2, H0, WtW2, K, n, n_iter, eps, out, s);
      ALPINE_BUCKET(8)
      ALPINE_BUCKET(16)
      ALPINE_BUCKET(24)
      ALPINE_BUCKET(32)
      ALPINE_BUCKET(40)
      ALPINE_BUCKET(48)
      ALPINE_BUCKET(56)
      ALPINE_BUCKET(64)
#undef ALPINE_BUCKET
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (T == 0) {
    if (Wt == nullptr || At == nullptr) return (int)cudaErrorInvalidValue;
    return (int)launch_steps(num2, H0, WtW2, K, n, n_iter, eps, Wt, At, out, s);
  }
  // J: a multiple of the 8 rows the kernel unrolls, dividing KP
  if (Wt == nullptr || KP < K || J <= 0 || J % 8 != 0 || KP % J != 0 || S < 2 || S > 8)
    return (int)cudaErrorInvalidValue;
  // ops/kernels.py:_TRANSFORM_TILES: the (T, KP) instantiated
#define ALPINE_TILES(TT, G)                                                      \
  if (T == TT && KP == tiles_kp(TT, G))                                          \
    return (int)launch_tiles<TT, G>(num2, H0, WtW2, K, n, J, S, n_iter, eps, Wt, \
                                    out, s);
  ALPINE_TILES(64, 1)
  ALPINE_TILES(64, 2)
  ALPINE_TILES(64, 3)
  ALPINE_TILES(64, 4)
  ALPINE_TILES(64, 5)
  ALPINE_TILES(64, 6)
  ALPINE_TILES(32, 4)
#undef ALPINE_TILES
  return (int)cudaErrorInvalidValue;
}

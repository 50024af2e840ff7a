// The bf16 X passes above K = 512 (int8 and bf16 X), on Hopper's warpgroup
// MMA fed by the Tensor Memory Accelerator:
//   hxt_wide: part[split][k][gi] = sum over a split's cells c of Hb[k][c] X[gi][c];
//   wtx_wide: out[k][c] = sum over genes gi of Wb[k][gi] X[gi][c].
// Included by x_passes.cu after the staging helpers of mma_passes.cuh
// (row_offset, window_src, keep_bytes, lds16_at, the int8 widening,
// ldsm_x4_trans, round_w, allow_smem), which these kernels share with
// hxt_mma and wtx_mma, and after its reduce_splits; x_passes.cu's K1/K2/K4
// chain runs them above K = 512 for its WᵀX and X Hsᵀ.
//
// Replaces, above K = 512: benchmarks/als_probe.py:_pallas_dots, its
// hxt_kernel (call :172) and wtx_kernel (call :180), as hxt_mma and wtx_mma
// do below it.
//
// Bound on the H100: the tensor cores.  At 100k cells x 2,000 genes and
// K = 768 each pass is 307 GFLOP of bf16 products (0.31 ms at 989 TFLOP/s)
// for 0.35-0.5 GB of device memory (0.15 ms at 3.35 TB/s).  The ranged
// route that ran here before (hxt_mma / wtx_mma over ranges of 384 rows of
// K) re-read Hb for every 16-gene block and Wb for every 32-cell tile from
// L2: 19.2 and 9.6 GB, 4.89 and 2.50 ms.
//
// Design: a block is two consumer warpgroups and a producer warpgroup, of
// which one warp issues the copies (setmaxnreg moves the producers'
// registers to the consumers, 232 a thread).  Each consumer warpgroup owns
// 64 rows of a 128 x 256 output tile (genes x rows
// of K for hxt_wide, cells x rows of K for wtx_wide: the products are taken
// transposed, (X Hbᵀ)ᵀ and (Xᵀ Wbᵀ)ᵀ, so that K is wgmma's N) and keeps its
// 64 x 256 fp32 accumulators in registers (128 a thread).  The reduction
// (cells for hxt, genes for wtx) flows in stages of 64 values through a ring
// of S shared-memory stages, filled by the producer warp and handed over by
// mbarriers (full: the stage's bytes have landed; empty: every consumer
// warp of the cluster is done with it):
//  * B, the rounded operand, is a 256-row tile of Hb (Hb') or Wb loaded by
//    TMA in the 128-byte swizzle wgmma reads from shared memory (K-major);
//  * A, X, is loaded by TMA where X's rows lie on 16-byte boundaries, else as
//    the aligned 16-byte windows that cover them by cp.async (arriving on
//    the same mbarrier), and each consumer thread builds its wgmma A
//    fragments in registers from it: int8 widened exactly to bf16 in
//    registers (widen_i8x8, widen_cell_pairs), bf16 as stored.  Misaligned
//    rows are read at their byte offsets (lds16_at, byte loads), so every
//    value meets the k slot it takes on the aligned path: the same bits.
//  * hxt_wide: two blocks of a cluster (CL = 2) work on neighbouring gene
//    tiles with the same tile of Hb: each loads half of it and multicasts
//    it to both, so each stage of Hb is read from L2 once for every 256
//    genes.  (wtx_wide can take the same multicast of Wb along the cells,
//    but ran 7-12 % slower with it: each block runs alone.)
// L2 traffic at the bench shape, K = 768: hxt reads X once a 256-row tile
// of K (3 x 200 MB) and Hb once a cluster's 256 genes (8 x 154 MB): 1.8 GB;
// wtx reads X 3 times and Wb once a 128-cell tile (782 x 3 MB): 3.0 GB.
// The ranged route moved 19.2 and 9.6 GB.
//
// hxt_wide: the wgmma's 16 k slots of a k16 step take, on both sides, the
// cells that let a lane read its A fragments as 16 contiguous bytes of a
// row (int8; 32 for bf16): lane t of a quad feeds cells 16t + 4j .. 16t + 4j
// + 3 of a 64-cell stage to k step j, in slots {2t, 2t + 1, 2t + 8, 2t + 9}.
// round_h_wide writes Hb in that order (Hb'), so the sum runs over every
// cell once.  The cells are split so that tiles x splits fill waves of 132
// SMs (at most 16,384 cells a split: the fp32 sums' length); each block
// writes its split's partial and reduce_splits adds them in split order (no
// atomics): two launches give the same bits.
// wtx_wide: a warp's 16 rows of A are 16 cells; int8 X pairs cells in
// ldmatrix.trans (widen_cell_pairs: rows 0-7 the even cells, 8-15 the odd),
// which the epilogue puts back in order.  The 128 x 256 accumulators go
// through shared memory (the ring, free by then) so that each row of K of
// the output is stored along its cells, 16 bytes a lane.  Where the tiles
// fill less than four waves, the genes are split into ranges whose partials
// reduce_splits adds in range order.
// ops/kernels.py: hxt_wide_grid, wtx_wide_grid, x_wide_smem_bytes.
#pragma once

#include <cuda.h>

#include <cstring>

namespace alpine {

constexpr int kWideBM = 128;                       // tile rows: two warpgroups of 64
constexpr int kWideBN = 256;                       // tile columns (rows of K): wgmma's widest N
constexpr int kWideBK = 64;                        // reduction values a stage: 128 bytes of bf16
constexpr int kWideTile = kWideBN * kWideBK * 2;   // bytes of a stage's tile of Hb or Wb
constexpr int kWideConsumers = 2 * 128;            // two consumer warpgroups
constexpr int kWideThreads = kWideConsumers + 128; // and the producer's warpgroup
// registers a thread after setmaxnreg: the producer's warpgroup gives its
// share to the consumers' 128 accumulators (40 x 128 + 232 x 256 <= 65,536)
constexpr int kWideProducerRegs = 40, kWideConsumerRegs = 232;
constexpr int kWideOutRow = kWideBM + 4;           // floats of a staged output row (wtx_wide)
// blocks a cluster: hxt_wide shares each stage of Hb between two gene tiles
// (TMA multicast); wtx_wide runs alone (a cluster of two was 7-12 % slower
// at K = 768-2048 on the H100: scripts/torch_wide_variants.py, PERF.md).
// ops/kernels.py:_WIDE_CL.
constexpr int kHxtWideCL = 2, kWtxWideCL = 1;

// Bytes of a staged X row of a stage where X's rows are off 16-byte
// alignment: the stage's values as stored, the aligned window's 16 bytes
// more, and room for lds16_at's last word (hxt) or padding (wtx).
template <typename XT>
__host__ __device__ constexpr int hxt_wide_xrow() { return sizeof(XT) == 1 ? 96 : 160; }
template <typename XT>
__host__ __device__ constexpr int wtx_wide_xrow() { return sizeof(XT) == 1 ? 144 : 272; }

// Bytes of a ring stage: the tile of Hb (Wb), then X's rows, rounded up to
// 1,024 (the 128-byte swizzle's period).  ops/kernels.py:x_wide_stage_bytes.
template <typename XT, bool kAligned>
__host__ __device__ constexpr int hxt_wide_stage() {
  return (kWideTile + kWideBM * (kAligned ? kWideBK * (int)sizeof(XT) : hxt_wide_xrow<XT>()) +
          1023) / 1024 * 1024;
}
template <typename XT, bool kAligned>
__host__ __device__ constexpr int wtx_wide_stage() {
  return (kWideTile + kWideBK * (kAligned ? kWideBM * (int)sizeof(XT) : wtx_wide_xrow<XT>()) +
          1023) / 1024 * 1024;
}

// The block's dynamic shared memory: 1,024 bytes to align the ring, S
// stages and a full and an empty mbarrier a stage.
__host__ __device__ constexpr size_t x_wide_smem(int stage, int S) {
  return 1024 + (size_t)S * (stage + 16);
}

// ---- PTX of the Hopper pipeline -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Wait for the phase of parity `parity` of the barrier to complete.  (No
// trap after a bound on the spins: a trap in the consumers' loop makes
// ptxas serialize their wgmmas.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Arrive on the barrier at the same offset in block `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar), "r"(cta)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// The thread's cp.async copies so far arrive on the barrier when they have
// landed (the pending count is raised first: no net change).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// A 2-D box of the tensor map at (x, y) (elements: x within a row, y the row) into
// shared memory at dst, completing `bar`'s transaction bytes; with CL > 1
// into the same offset of every block of the cluster.
template <int CL>
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int x, int y) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if constexpr (CL == 1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"(m), "r"(bar), "r"(x), "r"(y)
        : "memory");
  } else {
    const uint16_t mask = (1u << CL) - 1;
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
        "l"(m), "r"(bar), "r"(x), "r"(y), "h"(mask)
        : "memory");
  }
}

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1,024 bytes apart.  A k16 step
// further along the rows adds 32 bytes (2 in the address field).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 of the warpgroup, fp32) += a (64 x 16 bf16, registers) b (16 x
// 256 bf16, shared memory at desc, K-major).
__device__ __forceinline__ void wgmma_256(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The 1,024-byte-aligned start of the dynamic shared memory's ring.
__device__ __forceinline__ unsigned char* ring_base(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// Release ring stage `bar` (an empty barrier) to the producers of every
// block of the cluster: one arrival a warp, after its products are done.
// The producer's last waits (producer_tail) see every such arrival, so no
// block leaves while a block of its cluster may still arrive on its
// barriers; a block's consumers have waited for every byte multicast into
// it.
template <int CL>
__device__ __forceinline__ void release_stage(uint32_t bar) {
  if constexpr (CL == 1) {
    mbar_arrive(bar);
  } else {
#pragma unroll
    for (int r = 0; r < CL; ++r) mbar_arrive_cluster(bar, r);
  }
}

// The producer's tail: wait until the consumers of every block of the
// cluster have released the last use of each of the S stages.
__device__ __forceinline__ void producer_tail(uint32_t empty, int n_chunks, int S) {
  for (int c = n_chunks; c < n_chunks + S; ++c)
    mbar_wait(empty + 8 * (c % S), ((c / S) & 1) ^ 1);
}

template <int kRegs>
__device__ __forceinline__ void set_max_registers() {
  if constexpr (kRegs < 168) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
  }
}

// The rows of X a warp of the producer copies as aligned 16-byte windows
// (X's rows off 16-byte alignment; window_src's copies): `rows` rows from
// row gi0, a lane a row at a time, the cells from c0, NV copies a row, XR
// bytes apart; zero past g and once a copy starts past its row.
template <typename XT>
__device__ __forceinline__ void copy_windows(unsigned char* x, const XT* X, int gi0, int g, int n,
                                             int c0, int rows, int NV, int XR, int lane) {
  for (int r = lane; r < rows; r += 32) {
    const unsigned char* row =
        reinterpret_cast<const unsigned char*>(X) + (size_t)(gi0 + r) * n * sizeof(XT);
    const unsigned char* end = row + (size_t)n * sizeof(XT);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        reinterpret_cast<uintptr_t>(row + (size_t)c0 * sizeof(XT)) & ~uintptr_t(15));
    const bool in = gi0 + r < g;
    for (int jv = 0; jv < NV; ++jv, src += 16) {
      const bool ok = in && src < end;
      cp_async16(x + r * XR + 16 * jv, ok ? static_cast<const void*>(src) : X, ok);
    }
  }
}

// The consumers' loop over the n_chunks ring stages: wait for stage c,
// build its A fragments, issue its four k16 products, wait for them and
// release the stage.  (Building stage c + 1's fragments while stage c's
// products run, in a second register set, gained under 1 % and spilled
// hxt_wide: scripts/torch_wide_variants.py, PERF.md.)  build(st, c, a)
// waits for nothing: it fills a from stage c, at st, which has landed.
template <int CL, int kStage, typename Build>
__device__ __forceinline__ void wide_mainloop(float* acc, int n_chunks, int S, uint32_t bars,
                                              const unsigned char* smem, int lane, Build build) {
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % S;
    const unsigned char* st = smem + (size_t)s * kStage;
    mbar_wait(bars + 8 * s, (c / S) & 1);
    uint32_t a[4][4];  // [k16 step][fragment register]
    build(st, c, a);
    const uint64_t desc = desc_sw128(smem_u32(st));
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_256(acc, a[j], desc + 2 * j);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    if (lane == 0) release_stage<CL>(bars + 8 * (S + s));
  }
}

// ---- hxt_wide ---------------------------------------------------------------

// Hb'[k][c0 + 16 j + s] = bf16(H[k][c0 + cell]) for each 64-cell chunk c0,
// k16 step j and slot s (0 past n, up to n_pad): H rounded once a call, in
// hxt_wide's slot order, where lane t = (s % 8) / 2 of a quad feeds cells
// 16t + 4j + {0, 1} to slots 2t, 2t + 1 and 16t + 4j + {2, 3} to slots
// 2t + 8, 2t + 9.  One thread a k16 step (16 slots: four 4-cell runs of H).
__global__ void __launch_bounds__(kThreads)
round_h_wide(const float* __restrict__ H, int K, int n, int n_pad,
             __nv_bfloat16* __restrict__ Hb) {
  const int steps = n_pad / 16;
  const size_t q = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (q >= (size_t)K * steps) return;
  const int k = (int)(q / steps), step = (int)(q - (size_t)k * steps);
  const int base = (step >> 2) * kWideBK + 4 * (step & 3);  // cell of lane 0's run
  const float* src = H + (size_t)k * n;
  const bool vec = rows_aligned16(H, n);
  float v[4][4];  // [lane t][cell of its run]
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int c = base + 16 * t;
    if (vec && c + 4 <= n) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(src + c));
      v[t][0] = f.x, v[t][1] = f.y, v[t][2] = f.z, v[t][3] = f.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) v[t][u] = c + u < n ? src[c + u] : 0.f;
    }
  }
  __nv_bfloat16 r[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) r[s] = __float2bfloat16_rn(v[(s & 7) >> 1][2 * (s >> 3) + (s & 1)]);
  uint4* dst = reinterpret_cast<uint4*>(Hb + (size_t)k * n_pad + 16 * step);
  dst[0] = reinterpret_cast<const uint4*>(r)[0];
  dst[1] = reinterpret_cast<const uint4*>(r)[1];
}

// part[split][k][gi] for this block's 128 genes (g0 ..) and 256 rows of K
// (k0 ..) over its split's cells; see the note at the top.
template <typename XT, bool kAligned, int CL>
__global__ void __launch_bounds__(kWideThreads, 1)
hxt_wide(__grid_constant__ const CUtensorMap tmX, __grid_constant__ const CUtensorMap tmH,
         const XT* __restrict__ X, int g, int n, int K, int cells_per_split, int S,
         float* __restrict__ part) {
  constexpr bool kInt8 = sizeof(XT) == 1;
  constexpr int kStage = hxt_wide_stage<XT, kAligned>();
  constexpr int XR = kAligned ? kWideBK * (int)sizeof(XT) : hxt_wide_xrow<XT>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = ring_base(smem_raw);
  const uint32_t bars = smem_u32(smem + (size_t)S * kStage);  // full[s], then empty[s]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g0 = blockIdx.x * kWideBM, k0 = blockIdx.y * kWideBN, split = blockIdx.z;
  const int cbeg = split * cells_per_split;
  const int n_chunks = (min(n, cbeg + cells_per_split) - cbeg + kWideBK - 1) / kWideBK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kWideConsumers / 32 * CL);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (CL > 1) cluster_sync();
  // the warpgroup, uniform in each warp as setmaxnreg needs it
  const int wgroup = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgroup == kWideConsumers / 128) {  // the producer's warpgroup: its first warp copies
    set_max_registers<kWideProducerRegs>();
    if (warp > kWideConsumers / 32) return;
    const int rank = CL > 1 ? (int)cluster_rank() : 0;
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % S;
      const uint32_t full = bars + 8 * s;
      mbar_wait(bars + 8 * (S + s), ((c / S) & 1) ^ 1);
      unsigned char* st = smem + (size_t)s * kStage;
      const int c0 = cbeg + c * kWideBK;
      if constexpr (!kAligned) {
        copy_windows(st + kWideTile, X, g0, g, n, c0, kWideBM, kWideBK * sizeof(XT) / 16 + 1, XR,
                     lane);
        cp_async_mbar_arrive(full);
        __syncwarp();
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full, kWideTile + (kAligned ? kWideBM * XR : 0));
        tma_load<CL>(smem_u32(st) + rank * (kWideTile / CL), &tmH, full, c0,
                     k0 + rank * (kWideBN / CL));
        if constexpr (kAligned) tma_load<1>(smem_u32(st + kWideTile), &tmX, full, c0, g0);
      }
    }
    producer_tail(bars + 8 * S, n_chunks, S);
  } else {  // the consumers: warpgroup wg holds genes g0 + 64 wg ..
    set_max_registers<kWideConsumerRegs>();
    const int wg = wgroup, gq = lane / 4, t = lane % 4;
    const int row = 64 * wg + 16 * (warp % 4) + gq;  // the lane's tile rows: row, row + 8
    int xoff[2] = {0, 0};
    if constexpr (!kAligned) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gi = g0 + row + 8 * h;
        xoff[h] = gi < g ? row_offset(X, gi, n) : 0;
      }
    }
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    auto build = [&](const unsigned char* st, int c, uint32_t(&a)[4][4]) {
      const unsigned char* x = st + kWideTile;
      const int left = n - (cbeg + c * kWideBK);  // cells of the stage before n
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        uint4 v[sizeof(XT)];  // the lane's 16 cells 16t .. 16t + 15: 16 or 32 bytes
#pragma unroll
        for (int u = 0; u < (int)sizeof(XT); ++u) {
          if constexpr (kAligned) {
            // int8: 64-byte rows as stored; bf16: 128-byte rows in the swizzle
            const int q = kInt8 ? t : (2 * t + u) ^ (r & 7);
            v[u] = *reinterpret_cast<const uint4*>(x + r * XR + 16 * q);
          } else {
            const int keep = (left - 16 * t) * (int)sizeof(XT) - 16 * u;  // bytes before n
            v[u] = lds16_at(x + r * XR, xoff[h] + 16 * ((int)sizeof(XT) * t + u));
            v[u].x = keep_bytes(v[u].x, keep), v[u].y = keep_bytes(v[u].y, keep - 4);
            v[u].z = keep_bytes(v[u].z, keep - 8), v[u].w = keep_bytes(v[u].w, keep - 12);
          }
        }
        // k16 step j: the lane's cells 4j, 4j + 1 (register h) and 4j + 2,
        // 4j + 3 (register 2 + h) of rows r = gq (h = 0) and gq + 8 (h = 1)
        if constexpr (kInt8) {
          unsigned w[4];
          widen_i8x8(make_uint2(v[0].x, v[0].y), w);
          a[0][h] = w[0], a[0][2 + h] = w[1], a[1][h] = w[2], a[1][2 + h] = w[3];
          widen_i8x8(make_uint2(v[0].z, v[0].w), w);
          a[2][h] = w[0], a[2][2 + h] = w[1], a[3][h] = w[2], a[3][2 + h] = w[3];
        } else {
          const unsigned w[8] = {v[0].x, v[0].y, v[0].z, v[0].w,
                                 v[sizeof(XT) - 1].x, v[sizeof(XT) - 1].y,
                                 v[sizeof(XT) - 1].z, v[sizeof(XT) - 1].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j][h] = w[2 * j], a[j][2 + h] = w[2 * j + 1];
        }
      }
    };
    wide_mainloop<CL, kStage>(acc, n_chunks, S, bars, smem, lane, build);
    // acc[4i + 2h + e]: tile row row + 8h, row of K k0 + 8i + 2t + e
    float* dst = part + (size_t)split * K * g;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int k = k0 + 8 * i + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gi = g0 + row + 8 * h;
        if (gi < g && k < K) dst[(size_t)k * g + gi] = acc[4 * i + 2 * h];
        if (gi < g && k + 1 < K) dst[(size_t)(k + 1) * g + gi] = acc[4 * i + 2 * h + 1];
      }
    }
  }
}

// ---- wtx_wide ---------------------------------------------------------------

// dst[k][c] (out, or the gene range's partial) for this block's 128 cells
// (c0 ..) and 256 rows of K (k0 ..) over its range's genes; see the note at
// the top.
template <typename XT, bool kAligned, int CL>
__global__ void __launch_bounds__(kWideThreads, 1)
wtx_wide(__grid_constant__ const CUtensorMap tmX, __grid_constant__ const CUtensorMap tmW,
         const XT* __restrict__ X, int g, int n, int K, int range_genes, int S,
         float* __restrict__ dst) {
  constexpr bool kInt8 = sizeof(XT) == 1;
  constexpr int kStage = wtx_wide_stage<XT, kAligned>();
  constexpr int XR = kAligned ? kWideBM * (int)sizeof(XT) : wtx_wide_xrow<XT>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = ring_base(smem_raw);
  const uint32_t bars = smem_u32(smem + (size_t)S * kStage);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * kWideBM, k0 = blockIdx.y * kWideBN;
  const int gbeg = blockIdx.z * range_genes;
  const int n_chunks = (min(g, gbeg + range_genes) - gbeg + kWideBK - 1) / kWideBK;
  dst += (size_t)blockIdx.z * K * n;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kWideConsumers / 32 * CL);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (CL > 1) cluster_sync();
  // the warpgroup, uniform in each warp as setmaxnreg needs it
  const int wgroup = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgroup == kWideConsumers / 128) {  // the producer's warpgroup: its first warp copies
    set_max_registers<kWideProducerRegs>();
    if (warp > kWideConsumers / 32) return;
    const int rank = CL > 1 ? (int)cluster_rank() : 0;
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % S;
      const uint32_t full = bars + 8 * s;
      mbar_wait(bars + 8 * (S + s), ((c / S) & 1) ^ 1);
      unsigned char* st = smem + (size_t)s * kStage;
      const int gx = gbeg + c * kWideBK;
      if constexpr (!kAligned) {
        copy_windows(st + kWideTile, X, gx, g, n, c0, kWideBK, kWideBM * sizeof(XT) / 16 + 1, XR,
                     lane);
        cp_async_mbar_arrive(full);
        __syncwarp();
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full, kWideTile + (kAligned ? kWideBK * XR : 0));
        tma_load<CL>(smem_u32(st) + rank * (kWideTile / CL), &tmW, full, gx,
                     k0 + rank * (kWideBN / CL));
        if constexpr (kAligned) {
          // int8: one box of 128 cells; bf16: two of 64 (128-byte rows)
#pragma unroll
          for (int b = 0; b < (int)sizeof(XT); ++b)
            tma_load<1>(smem_u32(st + kWideTile + b * kWideBK * 128), &tmX, full, c0 + 64 * b, gx);
        }
      }
    }
    producer_tail(bars + 8 * S, n_chunks, S);
  } else {  // the consumers: warp w's 16 tile rows are cells cw ..
    set_max_registers<kWideConsumerRegs>();
    const int wg = wgroup, gq = lane / 4, t = lane % 4;
    const int cw = 64 * wg + 16 * (warp % 4);
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    auto build = [&](const unsigned char* st, int c, uint32_t(&a)[4][4]) {
      const unsigned char* x = st + kWideTile;
      const int gx = gbeg + c * kWideBK;
#pragma unroll
      for (int g32 = 0; g32 < kWideBK; g32 += 32) {
        if constexpr (kInt8) {
          unsigned r[4];  // genes g32 + 8m .. of pairs of cells (ldmatrix.trans)
          if constexpr (kAligned) {
            const int gr = g32 + lane;
            ldsm_x4_trans(r, x + gr * XR + (((cw >> 4) ^ (gr & 7)) << 4));
          } else {  // what ldmatrix.trans gives, from the rows at their offsets
            const int cc = cw + 2 * (lane >> 2);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int ga = g32 + 8 * m + 2 * (lane & 3);
              const unsigned char* pa = x + ga * XR + row_offset(X, gx + ga, n) + cc;
              const unsigned char* pb = x + (ga + 1) * XR + row_offset(X, gx + ga + 1, n) + cc;
              r[m] = (unsigned)pa[0] | (unsigned)pa[1] << 8 | (unsigned)pb[0] << 16 |
                     (unsigned)pb[1] << 24;
            }
          }
          // rows gq: the even cell cw + 2 gq; rows gq + 8: the odd one
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int j = g32 / 16 + ks;
            widen_cell_pairs(r[2 * ks], a[j][0], a[j][1]);
            widen_cell_pairs(r[2 * ks + 1], a[j][2], a[j][3]);
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            unsigned r[4];  // (genes 0-7, 8-15) x (cells 0-7), then cells 8-15
            if constexpr (kAligned) {
              const int gr = g32 + 16 * ks + (lane & 15);
              const int q = ((cw & 63) >> 3) + (lane >> 4);
              ldsm_x4_trans(r, x + (cw >> 6) * (kWideBK * 128) + gr * 128 + ((q ^ (gr & 7)) << 4));
            } else {
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                const int ga = g32 + 16 * ks + 8 * (m & 1) + 2 * (lane & 3);
                const int cc = cw + 8 * (m >> 1) + (lane >> 2);
                const unsigned lo = *reinterpret_cast<const unsigned short*>(
                    x + ga * XR + row_offset(X, gx + ga, n) + 2 * cc);
                const unsigned hi = *reinterpret_cast<const unsigned short*>(
                    x + (ga + 1) * XR + row_offset(X, gx + ga + 1, n) + 2 * cc);
                r[m] = lo | hi << 16;
              }
            }
            const int j = g32 / 16 + ks;
            a[j][0] = r[0], a[j][1] = r[2], a[j][2] = r[1], a[j][3] = r[3];
          }
        }
      }
    };
    wide_mainloop<CL, kStage>(acc, n_chunks, S, bars, smem, lane, build);
    // the ring is free once both warpgroups are done: the tile's outputs go
    // through it, rows of K along cells (kWideOutRow floats apart)
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWideConsumers) : "memory");
    float* sOut = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      // acc[4i + 2h + e]: tile row gq + 8h, row of K 8i + 2t + e
      float* o = sOut + (8 * i + 2 * t) * kWideOutRow;
      if constexpr (kInt8) {  // rows gq and gq + 8: cells cw + 2 gq and cw + 2 gq + 1
        *reinterpret_cast<float2*>(o + cw + 2 * gq) = make_float2(acc[4 * i], acc[4 * i + 2]);
        *reinterpret_cast<float2*>(o + kWideOutRow + cw + 2 * gq) =
            make_float2(acc[4 * i + 1], acc[4 * i + 3]);
      } else {
        o[cw + gq] = acc[4 * i], o[kWideOutRow + cw + gq] = acc[4 * i + 1];
        o[cw + gq + 8] = acc[4 * i + 2], o[kWideOutRow + cw + gq + 8] = acc[4 * i + 3];
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWideConsumers) : "memory");
    const int cells = min(kWideBM, n - c0);
    const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
    for (int kk = warp; kk < kWideBN && k0 + kk < K; kk += kWideConsumers / 32) {
      float* o = dst + (size_t)(k0 + kk) * n + c0;
      const float* srow = sOut + kk * kWideOutRow;
      if (vec && 4 * lane + 4 <= cells) {
        *reinterpret_cast<float4*>(o + 4 * lane) = *reinterpret_cast<const float4*>(srow + 4 * lane);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * lane + u < cells) o[4 * lane + u] = srow[4 * lane + u];
      }
    }
  }
}

// ---- the launches -----------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no link to
// libcuda at build time).
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// Code of a tensor map the driver refused (CUresult + 1000), distinct from
// the runtime's error codes.
constexpr int kTensorMapError = 1000;

// A 2-D tensor map of rows x cols elements (cols contiguous, rows row_bytes
// apart) with boxes of box_rows x box_cols; reads past the edges give zeros.
static int tensor_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                         uint64_t cols, uint64_t rows, uint64_t row_bytes, int box_cols,
                         int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kTensorMapError;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

template <typename XT>
static cudaError_t launch_wide(void (*kernel)(CUtensorMap, CUtensorMap, const XT*, int, int, int,
                                              int, int, float*),
                               dim3 grid, size_t smem, int CL, cudaStream_t stream,
                               const CUtensorMap& tmX, const CUtensorMap& tmB, const void* X,
                               int g, int n, int K, int span, int S, float* dst) {
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tmX, tmB, static_cast<const XT*>(X), g, n, K,
                           span, S, dst);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename XT>
static bool x_rows_aligned(const void* X, int n) {
  return (reinterpret_cast<uintptr_t>(X) & 15) == 0 && (size_t)n * sizeof(XT) % 16 == 0;
}

// TMA's view of X: boxes of box_rows rows x box_cols values.
template <typename XT>
static int x_tensor_map(CUtensorMap* map, const void* X, int g, int n, int box_cols,
                        int box_rows) {
  constexpr bool kInt8 = sizeof(XT) == 1;
  return tensor_map_2d(map, X, kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       n, g, (uint64_t)n * sizeof(XT), box_cols, box_rows,
                       box_cols * sizeof(XT) == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                    : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// P1 above K = 512: H rounded into Hb' (K x n_pad, n_pad a multiple of 64,
// hxt_wide's slot order), then hxt_wide over (gene tiles, padded to whole
// clusters of CL) x (tiles of 256 rows of K) x (cell splits) with S ring
// stages.  The splits' partials go to `part` (n_split x K x g); with `out`,
// reduce_splits adds them into it in split order (one split: hxt_wide
// writes out itself).  ops/kernels.py:hxt_wide_grid.
template <typename XT>
static int launch_hxt_wide(const void* X, const float* H, int g, int n, int K, int CL,
                           int n_split, int cells_per_split, int S, __nv_bfloat16* Hb,
                           float* part, float* out, cudaStream_t stream) {
  const bool aligned = x_rows_aligned<XT>(X, n);
  const int stage = aligned ? hxt_wide_stage<XT, true>() : hxt_wide_stage<XT, false>();
  const size_t smem = x_wide_smem(stage, S);
  const bool ok = g >= 1 && n >= 1 && K >= 1 && CL == kHxtWideCL && n_split >= 1 &&
                  cells_per_split >= kWideBK && cells_per_split % kWideBK == 0 &&
                  (size_t)(n_split - 1) * cells_per_split < (size_t)n &&
                  (size_t)n_split * cells_per_split >= (size_t)n && S >= 2 && S <= 8 &&
                  Hb != nullptr && (out != nullptr || part != nullptr) &&
                  (n_split == 1 || part != nullptr);
  if (!ok || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int n_pad = (n + kWideBK - 1) / kWideBK * kWideBK;
  const size_t steps = (size_t)K * (n_pad / 16);
  round_h_wide<<<(unsigned)((steps + kThreads - 1) / kThreads), kThreads, 0, stream>>>(H, K, n,
                                                                                      n_pad, Hb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmH, tmX;
  memset(&tmX, 0, sizeof(tmX));
  int rc = tensor_map_2d(&tmH, Hb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, n_pad, K, (uint64_t)n_pad * 2,
                         kWideBK, kWideBN / CL, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0 && aligned) rc = x_tensor_map<XT>(&tmX, X, g, n, kWideBK, kWideBM);
  if (rc != 0) return rc;
  const int tiles = (g + kWideBM - 1) / kWideBM;
  dim3 grid((tiles + CL - 1) / CL * CL, (K + kWideBN - 1) / kWideBN, n_split);
  float* dst = out != nullptr && n_split == 1 ? out : part;
  err = launch_wide(aligned ? hxt_wide<XT, true, kHxtWideCL> : hxt_wide<XT, false, kHxtWideCL>,
                    grid, smem, CL, stream, tmX, tmH, X, g, n, K, cells_per_split, S, dst);
  if (err != cudaSuccess) return (int)err;
  if (out == nullptr || n_split == 1) return 0;
  const size_t total = (size_t)K * g;
  reduce_splits<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, n_split, K, g, out);
  return (int)cudaGetLastError();
}

// P2 above K = 512: W rounded and transposed into Wb (pad16(K) x g_pad,
// g_pad a multiple of 64), then wtx_wide over (cell tiles, padded to whole
// clusters of CL) x (tiles of 256 rows of K) x (gene ranges of range_genes,
// a multiple of 64) with S ring stages; with more than one range their
// partials (ranges x K x n in `part`) are added in range order by
// reduce_splits.  ops/kernels.py:wtx_wide_grid.
template <typename XT>
static int launch_wtx_wide(const void* X, const float* W, int g, int n, int K, int CL, int ranges,
                           int range_genes, int S, __nv_bfloat16* Wb, float* part, float* out,
                           cudaStream_t stream) {
  const bool aligned = x_rows_aligned<XT>(X, n);
  const int stage = aligned ? wtx_wide_stage<XT, true>() : wtx_wide_stage<XT, false>();
  const size_t smem = x_wide_smem(stage, S);
  const bool ok = g >= 1 && n >= 1 && K >= 1 && CL == kWtxWideCL && ranges >= 1 &&
                  range_genes >= kWideBK && range_genes % kWideBK == 0 &&
                  (size_t)(ranges - 1) * range_genes < (size_t)g &&
                  (size_t)ranges * range_genes >= (size_t)g && S >= 2 && S <= 8 &&
                  (size_t)S * stage >= (size_t)kWideBN * kWideOutRow * 4 && Wb != nullptr &&
                  out != nullptr && (ranges == 1 || part != nullptr);
  if (!ok || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int g_pad = (g + kWideBK - 1) / kWideBK * kWideBK, Kp = pad16(K);
  const size_t vecs = (size_t)Kp * (g_pad / 8);
  round_w<<<(unsigned)((vecs + kThreads - 1) / kThreads), kThreads, 0, stream>>>(W, g, K, Kp,
                                                                                g_pad, Wb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmW, tmX;
  memset(&tmX, 0, sizeof(tmX));
  int rc = tensor_map_2d(&tmW, Wb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, g_pad, K, (uint64_t)g_pad * 2,
                         kWideBK, kWideBN / CL, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0 && aligned) rc = x_tensor_map<XT>(&tmX, X, g, n, 128 / (int)sizeof(XT), kWideBK);
  if (rc != 0) return rc;
  const int tiles = (n + kWideBM - 1) / kWideBM;
  dim3 grid((tiles + CL - 1) / CL * CL, (K + kWideBN - 1) / kWideBN, ranges);
  float* dst = ranges == 1 ? out : part;
  err = launch_wide(aligned ? wtx_wide<XT, true, kWtxWideCL> : wtx_wide<XT, false, kWtxWideCL>,
                    grid, smem, CL, stream, tmX, tmW, X, g, n, K, range_genes, S, dst);
  if (err != cudaSuccess) return (int)err;
  if (ranges == 1) return 0;
  const size_t total = (size_t)K * n;
  reduce_splits<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part, ranges, K, n, out);
  return (int)cudaGetLastError();
}

}  // namespace alpine

// Plain C entry points (ctypes) of P1 and P2 above K = 512 on int8/bf16 X.
// hxt_wide: the scratch hb (K x n rounded up to 64, bf16) and part (n_split
// x K x g, where n_split > 1).  wtx_wide: wb (pad16(K) x g rounded up to 64,
// bf16) and part (ranges x K x n, where ranges > 1).
extern "C" int alpine_hxt_wide(const void* X, int xtype, const float* H, int g, int n, int K,
                               int cluster, int n_split, int cells_per_split, int stages,
                               void* hb, float* part, float* out, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* Hb = static_cast<__nv_bfloat16*>(hb);
  switch (xtype) {
    case kBF16:
      return launch_hxt_wide<__nv_bfloat16>(X, H, g, n, K, cluster, n_split, cells_per_split,
                                            stages, Hb, part, out, s);
    case kI8:
      return launch_hxt_wide<int8_t>(X, H, g, n, K, cluster, n_split, cells_per_split, stages,
                                     Hb, part, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int alpine_wtx_wide(const void* X, int xtype, const float* W, int g, int n, int K,
                               int cluster, int ranges, int range_genes, int stages, void* wb,
                               float* part, float* out, void* stream) {
  using namespace alpine;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* Wb = static_cast<__nv_bfloat16*>(wb);
  switch (xtype) {
    case kBF16:
      return launch_wtx_wide<__nv_bfloat16>(X, W, g, n, K, cluster, ranges, range_genes, stages,
                                            Wb, part, out, s);
    case kI8:
      return launch_wtx_wide<int8_t>(X, W, g, n, K, cluster, ranges, range_genes, stages, Wb,
                                     part, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

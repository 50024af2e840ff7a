#!/usr/bin/env python3
"""Time diagnostic variants of P2 ``wtx_mma`` against the kernel as it is.

    python3 scripts/torch_wtx_variants.py         # from the repository root

Each variant is a copy of ``alpine_tpu_torch`` in a temporary directory with
textual edits of ``csrc/mma_passes.cuh`` (and, where the wrapper must
follow, of ``ops/kernels.py``), built there and timed in a process of its own:

- ``as_is``: the kernel as it is;
- ``stagger``: block b walks the gene chunks from chunk b (mod their
  count), so that the blocks read different rows of X and of Wb at a time
  (another summation order a cell: its bits differ);
- ``wb_replicas``: ``round_w`` writes 8 copies of Wb and block b reads copy
  b % 8 (the same bits): tests whether the blocks' reads of the same Wb
  lines at the same moment wait on one L2 slice;
- ``wb_once``: Wb is copied only for the first S chunks, later chunks
  reuse stale stages (wrong results): the kernel without Wb's traffic;
- ``copies_only``: the ring's copies and barriers without the products
  (zero results): the kernel's streaming alone;
- ``realign``: X rows off 16-byte alignment copied into place in shared
  memory one chunk ahead (two more chunks of X rows, at least 3 stages)
  and read by ldmatrix.trans, instead of B fragments built from byte
  loads at each row's offset (the same bits);
- ``gene_chunk_32``: 32 genes a ring stage where ``wtx_grid`` takes 64
  (twice the barriers and stages; the same bits);
- ``realign_gc32``, ``realign_4stages``: ``realign`` with 32 genes a ring
  stage for X off 16-byte alignment, or at least 4 stages (32 genes, or
  one block an SM, where 4 do not fit beside the realigned chunks);
- ``ranges_x2``: where ``wtx_gene_split`` splits the genes, twice the
  ranges (two waves at 8,192 cells; other bits there).

Names on the command line pick variants (default: all).

All variants build at once (one nvcc each).  Per variant, int8 and bf16 X
at the bench shape (100k cells x 2,000 genes), k = 5 and 30, and at
k = 40 on 66,667 cells (rows 11 bytes off 16-byte alignment), its aligned
twin 66,672, the bench X at a 1-byte offset and 8,192 cells: ms a call of
``kernels.wtx`` over 20 calls back to back (median of 3), device ms of
``wtx_mma`` a call (torch.profiler), and the largest error over the plain
version's tolerance (rtol 1e-4 + 1e-6 max|plain|; the diagnostic variants
fail it by design).  One JSON line per variant and the card's name and
power limit.  Needs one NVIDIA GPU.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, N = 2000, 100_000

# variant -> [(file, anchor, replacement)]; each anchor occurs once
COPY_W = "        cp_async16(w + k * WB + j * 2, Wb + (size_t)k * g_pad + g0 + j, true);"
# the realign route for X rows off 16-byte alignment (this kernel's route
# before the byte-load fragments won): the staged windows are copied into
# place in shared memory one chunk ahead, into two more chunks of X rows
# (16-byte loads, the five words from the row's offset on, funnel-shifted),
# and ldmatrix.trans reads them; 3 ring stages at least
REALIGN_FN = """// Copy the X rows of a landed stage (aligned windows) to `dst`, each
// shifted left by its row's byte offset.
template <typename XT>
__device__ __forceinline__ void realign_rows(const unsigned char* src, unsigned char* dst,
                                             int rows, int XR, int B, const XT* X, int n,
                                             int g0, int g) {
  for (CopyWalk e(threadIdx.x, B / 16); e.row < rows; e.next()) {
    const int off = g0 + e.row < g ? row_offset(X, g0 + e.row, n) : 0;
    const uint4* p = reinterpret_cast<const uint4*>(src + e.row * XR) + e.copy;
    const uint4 a = p[0], b = p[1];
    const int sh = (off & 3) * 8;
    auto shifted = [sh](unsigned w0, unsigned w1, unsigned w2, unsigned w3, unsigned w4) {
      return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                        __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
    };
    uint4 o;
    switch (off >> 2) {
      case 0: o = shifted(a.x, a.y, a.z, a.w, b.x); break;
      case 1: o = shifted(a.y, a.z, a.w, b.x, b.y); break;
      case 2: o = shifted(a.z, a.w, b.x, b.y, b.z); break;
      default: o = shifted(a.w, b.x, b.y, b.z, b.w); break;
    }
    *reinterpret_cast<uint4*>(dst + e.row * XR + 16 * e.copy) = o;
  }
}

"""
LOOP = """  for (int c = 0; c < S - 1; ++c) issue(c, c);
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
"""
REALIGN_LOOP = """  for (int c = 0; c < S - 1; ++c) issue(c, c);
  unsigned char* xplaced = smem + S * stage_bytes;
  const int B = T * (int)sizeof(XT), x_chunk = GC * XR;
  if constexpr (!kAligned) {
    cp_async_wait(S - 2);  // chunk 0
    __syncthreads();
    realign_rows(smem + w_bytes, xplaced, GC, XR, B, X, n, chunk0 * GC, g);
  }
  int st = 0;  // stage of chunk c
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait(kAligned ? S - 2 : S - 3);
    __syncthreads();
    issue(c + S - 1, st == 0 ? S - 1 : st - 1);
    const unsigned char* w = smem + st * stage_bytes;
    const unsigned char* x = w + w_bytes;
    const int gx = (chunk0 + c) * GC;  // the byte-load branches' (unused here)
    if constexpr (!kAligned) {
      if (c + 1 < n_chunks)
        realign_rows(smem + (st + 1 == S ? 0 : st + 1) * stage_bytes + w_bytes,
                     xplaced + ((c + 1) & 1) * x_chunk, GC, XR, B, X, n,
                     (chunk0 + c + 1) * GC, g);
      x = xplaced + (c & 1) * x_chunk;
    }
"""
SMEM_C = """__host__ __device__ inline size_t wtx_mma_smem_bytes(int K, int T, int S, int GC, bool int8) {
  return (size_t)S * ((size_t)pad16(K) * ldsm_row_bytes(2 * GC) +
                      (size_t)GC * wtx_x_row_bytes(T, int8));
}"""
SMEM_C_REALIGN = """__host__ __device__ inline size_t wtx_mma_smem_bytes(int K, int T, int S, int GC, bool int8,
                                                     bool realign) {
  const size_t x = (size_t)GC * wtx_x_row_bytes(T, int8);
  return (size_t)S * ((size_t)pad16(K) * ldsm_row_bytes(2 * GC) + x) + (realign ? 2 * x : 0);
}"""
SMEM_PY = """    x_row = _ldsm_row_bytes(T * (1 if x_dtype == torch.int8 else 2) + 16)
    return S * (_pad16(K) * _ldsm_row_bytes(2 * chunk) + chunk * x_row)"""
SMEM_PY_REALIGN = """    x_row = _ldsm_row_bytes(T * (1 if x_dtype == torch.int8 else 2) + 16)
    return S * (_pad16(K) * _ldsm_row_bytes(2 * chunk) + chunk * x_row) + (
        2 * chunk * x_row if realign else 0)"""
GRID_PY = """    budget = min(_MAX_SMEM, _SM_SMEM // 2 - _BLOCK_SMEM_RESERVED)
    for GC in _WTX_GENE_CHUNKS:
        S = max((s for s in _WTX_STAGES
                 if wtx_smem_bytes(K, T, s, x_dtype, GC) <= budget), default=0)
        if S:
            break
    return T, WR, GC, S, -(-n // T)"""
GRID_PY_REALIGN = """    least = 2 if aligned else 3  # stages
    for per_sm in (2, 1):
        budget = min(_MAX_SMEM, _SM_SMEM // per_sm - _BLOCK_SMEM_RESERVED)
        for GC in _WTX_GENE_CHUNKS:
            S = max((s for s in _WTX_STAGES
                     if wtx_smem_bytes(K, T, s, x_dtype, GC, not aligned) <= budget), default=0)
            if S >= least:
                return T, WR, GC, S, -(-n // T)
    raise ValueError("no ring fits")"""
REALIGN = [
    ("csrc/mma_passes.cuh", "// Wb[k][gi] = bf16(W[gi][k]) for k < K",
     REALIGN_FN + "// Wb[k][gi] = bf16(W[gi][k]) for k < K"),
    ("csrc/mma_passes.cuh", LOOP, REALIGN_LOOP),
    ("csrc/mma_passes.cuh", "          if constexpr (kAligned) {\n"
     "            ldsm_x4_trans(r, x + (g32 + lane) * XR + cw + nt * 16);",
     "          if constexpr (true) {\n"
     "            ldsm_x4_trans(r, x + (g32 + lane) * XR + cw + nt * 16);"),
    ("csrc/mma_passes.cuh", "            if constexpr (kAligned) {\n"
     "              ldsm_x4_trans(r, x + (g32 + ks * 16 + (lane & 15)) * XR +",
     "            if constexpr (true) {\n"
     "              ldsm_x4_trans(r, x + (g32 + ks * 16 + (lane & 15)) * XR +"),
    ("csrc/mma_passes.cuh", SMEM_C, SMEM_C_REALIGN),
    ("csrc/mma_passes.cuh", "wtx_mma_smem_bytes(K, T, S, GC, sizeof(XT) == 1);",
     "wtx_mma_smem_bytes(K, T, S, GC, sizeof(XT) == 1, !aligned);"),
    ("csrc/mma_passes.cuh", "S >= 2 && S <= 8 && (GC == 32 || GC == 64) && Wb != nullptr",
     "S >= (aligned ? 2 : 3) && S <= 8 && (GC == 32 || GC == 64) && Wb != nullptr"),
    ("ops/kernels.py", "                   chunk: int) -> int:\n    \"\"\"csrc/mma_passes.cuh:wtx_mma_smem_bytes",
     "                   chunk: int, realign: bool = False) -> int:\n    \"\"\"csrc/mma_passes.cuh:wtx_mma_smem_bytes"),
    ("ops/kernels.py", SMEM_PY, SMEM_PY_REALIGN),
    ("ops/kernels.py", "def wtx_grid(g: int, n: int, K: int, x_dtype: torch.dtype\n",
     "def wtx_grid(g: int, n: int, K: int, x_dtype: torch.dtype, aligned: bool = True\n"),
    ("ops/kernels.py", GRID_PY, GRID_PY_REALIGN),
    ("ops/kernels.py", "        T, WR, GC, S, blocks = wtx_grid(g, n, K, X.dtype)\n",
     "        T, WR, GC, S, blocks = wtx_grid(g, n, K, X.dtype, X.data_ptr() % 16 == 0 and"
     " n * X.element_size() % 16 == 0)\n"),
]


VARIANTS = {
    "as_is": [],
    "realign": REALIGN,
    "stagger": [("csrc/mma_passes.cuh", "      const int g0 = (chunk0 + c) * GC;",
                 "      const int g0 = (chunk0 + (c + (int)blockIdx.x) % n_chunks) * GC;")],
    "wb_replicas": [
        ("csrc/mma_passes.cuh", COPY_W,
         "        cp_async16(w + k * WB + j * 2, Wb + ((size_t)(blockIdx.x % 8) * Kp + k)"
         " * g_pad + g0 + j, true);"),
        ("csrc/mma_passes.cuh",
         "  *reinterpret_cast<uint4*>(Wb + (size_t)k * g_pad + g0) = "
         "*reinterpret_cast<const uint4*>(r);",
         "  for (int cpy = 0; cpy < 8; ++cpy)\n"
         "    *reinterpret_cast<uint4*>(Wb + ((size_t)cpy * Kp + k) * g_pad + g0) =\n"
         "        *reinterpret_cast<const uint4*>(r);"),
        ("ops/kernels.py", "        wb_bytes = -(-2 * _pad16(K) * ",
         "        wb_bytes = -(-16 * _pad16(K) * ")],
    "wb_once": [("csrc/mma_passes.cuh",
                 "      for (int q = tid; q < Kp << wv_shift; q += kThreads) {",
                 "      for (int q = tid; c < S && q < Kp << wv_shift; q += kThreads) {")],
    "gene_chunk_32": [("ops/kernels.py", "_WTX_GENE_CHUNKS = (64, 32)",
                       "_WTX_GENE_CHUNKS = (32,)")],
    "realign_gc32": REALIGN + [(
        "ops/kernels.py", "        for GC in _WTX_GENE_CHUNKS:\n            S = max((s for s in _WTX_STAGES\n                     if wtx_smem_bytes(K, T, s, x_dtype, GC, not aligned)",
        "        for GC in (_WTX_GENE_CHUNKS if aligned else (32,)):\n            S = max((s for s in _WTX_STAGES\n                     if wtx_smem_bytes(K, T, s, x_dtype, GC, not aligned)")],
    "realign_4stages": REALIGN + [("ops/kernels.py", "least = 2 if aligned else 3  # stages",
                                   "least = 2 if aligned else 4")],
    "ranges_x2": [("ops/kernels.py", "_WTX_RANGE_CHUNKS = 4", "_WTX_RANGE_CHUNKS = 2"),
                  ("ops/kernels.py", "min(2 * _SMS // blocks,", "min(4 * _SMS // blocks,")],
    "copies_only": [
        ("csrc/mma_passes.cuh",
         "#pragma unroll 1\n    for (int g32 = 0; g32 < GC; g32 += 32) {",
         "    if (K > (1 << 30)) {\n#pragma unroll 1\n    for (int g32 = 0; g32 < GC; g32 += 32) {"),
        ("csrc/mma_passes.cuh",
         "    st = st + 1 == S ? 0 : st + 1;\n  }\n  cp_async_wait(0);\n  // each lane",
         "    }\n    st = st + 1 == S ? 0 : st + 1;\n  }\n  cp_async_wait(0);\n  // each lane")],
}
# (label, cells, byte offset of X, k values): the bench shape, the
# optimizer's fold (rows 11 bytes off alignment) and its aligned twin, the
# bench X at a 1-byte offset, the minibatch steps' batch
SHAPES = (("bench", N, 0, (5, 30)), ("n66667", 66_667, 0, (40,)),
          ("n66672", 66_672, 0, (40,)), ("offset1", N, 1, (40,)),
          ("n8192", 8192, 0, (40,)))


def make_tree(tmp, name):
    root = os.path.join(tmp, name)
    shutil.copytree(os.path.join(ROOT, "alpine_tpu_torch"),
                    os.path.join(root, "alpine_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for rel, anchor, repl in VARIANTS[name]:
        path = os.path.join(root, "alpine_tpu_torch", rel)
        src = open(path).read()
        if src.count(anchor) != 1:
            raise SystemExit(f"{name}: anchor not found once in {rel}: {anchor!r}")
        open(path, "w").write(src.replace(anchor, repl))
    return root


def child(root, name):
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from alpine_tpu_torch.ops import _build, kernels

    if name == "--build":
        _build.entry("wtx")
        return
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    X8 = torch.poisson(torch.full((G, N), 1.5, device=dev),
                       generator=gen).clamp_(max=127).to(torch.int8)
    W = torch.rand((G, 40), generator=gen, device=dev) + 0.05
    row = {"variant": name}
    for Xd in (X8, X8.to(torch.bfloat16)):
        for label, n, off, ks in SHAPES:
            X = Xd[:, :n].contiguous()
            if off:  # the same values at a byte offset (bf16: whole elements)
                off = max(off, X.element_size())
                buf = torch.empty(X.numel() * X.element_size() + 16, dtype=torch.uint8,
                                  device=dev)
                X = buf[off:off + X.numel() * X.element_size()].view(X.dtype).view(X.shape)
                X.copy_(Xd[:, :n])
            for k in ks:
                Wk = W[:, 40 - k:].contiguous()
                tag = f"{str(X.dtype)[6:]}_{label}_k{k}"
                want = kernels.wtx_plain(X, Wk)
                got = kernels.wtx(X, Wk)
                atol = 1e-6 * float(want.abs().max())
                row[f"{tag}_err_over_tolerance"] = float(
                    ((got - want).abs() / (atol + 1e-4 * want.abs())).max())
                runs = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    for _ in range(20):
                        kernels.wtx(X, Wk)
                    b.record()
                    b.synchronize()
                    runs.append(a.elapsed_time(b) / 20)
                row[f"{tag}_ms_back_to_back"] = float(np.median(runs))
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        kernels.wtx(X, Wk)
                    torch.cuda.synchronize()
                row[f"{tag}_kernel_ms"] = sum(
                    e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and "wtx_mma" in e.key) * 1e-3 / 10
    print(json.dumps(row), flush=True)


def main(argv):
    if len(argv) == 4 and argv[1] == "--child":
        child(argv[2], argv[3])
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    me = os.path.abspath(__file__)
    names = argv[1:] or list(VARIANTS)
    with tempfile.TemporaryDirectory() as tmp:
        roots = {name: make_tree(tmp, name) for name in names}
        builds = [subprocess.Popen([sys.executable, me, "--child", r, "--build"])
                  for r in roots.values()]
        if any(p.wait() != 0 for p in builds):
            return 1
        for name, root in roots.items():
            out = subprocess.run([sys.executable, me, "--child", root, name],
                                 capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                return out.returncode
            print(out.stdout.strip().splitlines()[-1], flush=True)
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

#!/usr/bin/env python3
"""Time variants of the fp32 X passes (P1 ``hxt_fma``, P2 ``wtx_fma``)
against the kernels as they are.

    python3 scripts/torch_fma_variants.py [NAME ...]   # from the repository root

Each variant is a copy of ``alpine_tpu_torch`` in a temporary directory with
textual edits of ``csrc/x_passes.cu`` (and, where the wrapper must follow,
of ``ops/kernels.py``), built there and timed in a process of its own:

- ``as_is``: the kernels as they are;
- ``x_first``: hxt loads a step's 8 float4 of X first, then one float4 of
  H a row (more live registers; the same bits);
- ``three_per_sm``: hxt at three blocks an SM (85 registers a thread, 32
  cells a stage, the grid's splits and stages for a third of an SM);
- ``chunk_32``: hxt stages 32 cells a ring stage where it takes 64 (twice
  the barriers, more stages);
- ``genes_256``: hxt takes 256 genes a block at K <= 56 (8 warp columns,
  one cell group: half the blocks re-read H);
- ``wtx_genes_16``: wtx stages 16 genes a ring stage (twice the barriers);
- ``wtx_lanes_2``: wtx puts 2 lanes of a warp along K at every K (tiles
  of 192 cells);
- ``copies_only``: the rings' copies and barriers without the products
  (wrong results): the kernels' streaming alone.

Variants that change a summation order (``chunk_32``, ``genes_256``,
``wtx_genes_16``, ``wtx_lanes_2``, ``three_per_sm``) give other bits within
the tolerance.
Names on the command line pick variants (default: all).

All variants build at once (one nvcc each).  Per variant, float32 and int16
X (counts above 127) at the bench shape (100k cells x 2,000 genes): hxt at
K = 40, wtx at k = 5 and 30: ms a call over 20 calls back to back (median
of 3), device ms of the fp32 kernel a call (torch.profiler), and the
largest error over the plain version's tolerance (rtol 1e-4 + 1e-6
max|plain|; ``copies_only`` fails it by design).  One JSON line per variant
and the card's name and power limit.  Needs one NVIDIA GPU.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, N = 2000, 100_000

HXT_STEP = """      float4 xv[kFmaMG];
#pragma unroll
      for (int j = 0; j < kFmaMG; ++j)
        xv[j] = *reinterpret_cast<const float4*>(xr + 4 * j * RW + c4);
#pragma unroll
      for (int i = 0; i < MK; ++i) {
        const float4 hv = *reinterpret_cast<const float4*>(hr + 8 * i * RW + c4);
#pragma unroll
        for (int j = 0; j < kFmaMG; ++j) {
          float a = acc[i][j];
          a = fmaf(hv.x, xv[j].x, a);
          a = fmaf(hv.y, xv[j].y, a);
          a = fmaf(hv.z, xv[j].z, a);
          acc[i][j] = fmaf(hv.w, xv[j].w, a);
        }
      }"""
HXT_HOISTED = """      float4 hv[MK];
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
      }"""
THIRD = ("    S, chunk, per_sm = _fma_ring(\n"
         "        lambda s, c: hxt_fma_smem_bytes(K, GB, s, x_dtype, c), _FMA_CHUNKS)\n",
         "    per_sm, chunk = 3, 32\n"
         "    S = max(s for s in _FMA_STAGES if hxt_fma_smem_bytes(K, GB, s, x_dtype, chunk)\n"
         "            <= _SM_SMEM // 3 - _BLOCK_SMEM_RESERVED)\n")
VARIANTS = {
    "as_is": [],
    "x_first": [("csrc/x_passes.cu", HXT_HOISTED, HXT_STEP)],
    "three_per_sm": [
        ("csrc/x_passes.cu", "__launch_bounds__(kThreads, MK > kFmaMaxMK ? 1 : 2)\nhxt_fma(",
         "__launch_bounds__(kThreads, MK > kFmaMaxMK ? 1 : 3)\nhxt_fma("),
        ("ops/kernels.py",) + THIRD],
    "chunk_32": [("ops/kernels.py", "_FMA_CHUNKS = (64, 32)\n", "_FMA_CHUNKS = (32,)\n")],
    "genes_256": [("ops/kernels.py", "    GB = 32 * min(4, 8 // WK)\n",
                   "    GB = 32 * (8 if K <= 56 else min(4, 8 // WK))\n")],
    "wtx_genes_16": [("csrc/x_passes.cu", "constexpr int kWtxGC = 32;", "constexpr int kWtxGC = 16;"),
                     ("ops/kernels.py", "_WTX_FMA_GC = 32\n", "_WTX_FMA_GC = 16\n")],
    "wtx_lanes_2": [("ops/kernels.py", "for lk in (1, 2, 4, 8, 16) if",
                     "for lk in (2, 4, 8, 16) if")],
    "copies_only": [
        ("csrc/x_passes.cu", "c4 < (q + 1) * CQ; c4 += 4) {",
         "c4 < (K > (1 << 30) ? (q + 1) * CQ : 0); c4 += 4) {"),
        ("csrc/x_passes.cu", "gg < (q + 1) * GQ; ++gg) {",
         "gg < (K > (1 << 30) ? (q + 1) * GQ : 0); ++gg) {")],
}


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
        _build.entry("hxt")
        fn = None
        for line in _build.build_log("x_passes").splitlines():
            if "Function properties for " in line:
                fn = line.split("for ", 1)[1].strip()
            elif fn and "_fma" in fn and "spill stores" in line and " 0 bytes spill stores" not in line:
                print(json.dumps({"tree": root, "spill": fn, "ptxas": line.strip()}), flush=True)
        return
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    counts = torch.poisson(torch.full((G, N), 1.5, device=dev), generator=gen)
    H = torch.rand((40, N), generator=gen, device=dev) + 0.05
    W = torch.rand((G, 40), generator=gen, device=dev) + 0.05
    row = {"variant": name}
    for xdt in (torch.float32, torch.int16):
        X = ((counts + torch.rand((G, N), generator=gen, device=dev)) if xdt == torch.float32
             else counts * 3).to(xdt)
        for kind, P, tag in (("hxt", H, "hxt_k40"), ("wtx", W[:, :5].contiguous(), "wtx_k5"),
                             ("wtx", W[:, 10:].contiguous(), "wtx_k30")):
            tag = f"{str(xdt)[6:]}_{tag}"
            fn = getattr(kernels, kind)
            want = getattr(kernels, f"{kind}_plain")(X, P)
            got = fn(X, P)
            atol = 1e-6 * float(want.abs().max())
            row[f"{tag}_err_over_tolerance"] = float(
                ((got - want).abs() / (atol + 1e-4 * want.abs())).max())
            del want, got
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(20):
                    fn(X, P)
                b.record()
                b.synchronize()
                runs.append(a.elapsed_time(b) / 20)
            row[f"{tag}_ms_back_to_back"] = float(np.median(runs))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn(X, P)
                torch.cuda.synchronize()
            row[f"{tag}_kernel_ms"] = sum(
                e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and f"{kind}_fma" in e.key) * 1e-3 / 10
        del X
        torch.cuda.empty_cache()
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

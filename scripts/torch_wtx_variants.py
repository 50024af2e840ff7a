#!/usr/bin/env python3
"""Time diagnostic variants of P2 ``wtx_mma`` against the kernel as it is.

    python3 scripts/torch_wtx_variants.py         # from the repository root

Each variant is a copy of ``alpine_tpu_torch`` in a temporary directory with
textual edits of ``csrc/x_passes.cu`` (and, where the wrapper must
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
- ``gene_chunk_32``: 32 genes a ring stage where ``wtx_grid`` takes 64
  (twice the barriers and stages; the same bits).

Names on the command line pick variants (default: all).

All variants build at once (one nvcc each).  Per variant, int8 and bf16 X
at the bench shape (100k cells x 2,000 genes), k = 5 and 30: ms a call of
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
VARIANTS = {
    "as_is": [],
    "stagger": [("csrc/x_passes.cu", "      const int g0 = c * GC;",
                 "      const int g0 = (c + (int)blockIdx.x) % n_chunks * GC;")],
    "wb_replicas": [
        ("csrc/x_passes.cu", COPY_W,
         "        cp_async16(w + k * WB + j * 2, Wb + ((size_t)(blockIdx.x % 8) * Kp + k)"
         " * g_pad + g0 + j, true);"),
        ("csrc/x_passes.cu",
         "  *reinterpret_cast<uint4*>(Wb + (size_t)k * g_pad + g0) = "
         "*reinterpret_cast<const uint4*>(r);",
         "  for (int cpy = 0; cpy < 8; ++cpy)\n"
         "    *reinterpret_cast<uint4*>(Wb + ((size_t)cpy * Kp + k) * g_pad + g0) =\n"
         "        *reinterpret_cast<const uint4*>(r);"),
        ("ops/kernels.py", "        wb = torch.empty((_pad16(K), ",
         "        wb = torch.empty((8 * _pad16(K), ")],
    "wb_once": [("csrc/x_passes.cu",
                 "      for (int q = tid; q < Kp << wv_shift; q += kThreads) {",
                 "      for (int q = tid; c < S && q < Kp << wv_shift; q += kThreads) {")],
    "gene_chunk_32": [("ops/kernels.py", "_WTX_GENE_CHUNKS = (64, 32)",
                       "_WTX_GENE_CHUNKS = (32,)")],
    "copies_only": [
        ("csrc/x_passes.cu",
         "    const unsigned char* x = w + w_bytes;\n#pragma unroll 1\n    for (int g32",
         "    const unsigned char* x = w + w_bytes;\n    if (K > (1 << 30)) {\n"
         "#pragma unroll 1\n    for (int g32"),
        ("csrc/x_passes.cu",
         "    st = st + 1 == S ? 0 : st + 1;\n  }\n  cp_async_wait(0);\n  // each lane",
         "    }\n    st = st + 1 == S ? 0 : st + 1;\n  }\n  cp_async_wait(0);\n  // each lane")],
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
        _build.entry("wtx")
        return
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    X8 = torch.poisson(torch.full((G, N), 1.5, device=dev),
                       generator=gen).clamp_(max=127).to(torch.int8)
    W = torch.rand((G, 40), generator=gen, device=dev) + 0.05
    row = {"variant": name}
    for X in (X8, X8.to(torch.bfloat16)):
        for k, Wk in ((5, W[:, :5].contiguous()), (30, W[:, 10:].contiguous())):
            tag = f"{str(X.dtype)[6:]}_k{k}"
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

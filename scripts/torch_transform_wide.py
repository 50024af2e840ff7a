#!/usr/bin/env python3
"""K3 ``fused_transform`` above K = 512 at the bench shape, for one or more
checkouts on one GPU.

    python3 scripts/torch_transform_wide.py [ROOT ...] [--ks 768,1024,2048]

Each ROOT (default: this checkout) runs in a process of its own, in the
order given (for an A/B: ``PARENT CHANGE CHANGE PARENT``), builds its
kernels from its own ``alpine_tpu_torch/csrc`` and, at 100k cells and 50
steps for each K:

- times ``kernels.fused_transform``, the path its rule by K takes
  (``kernels.transform_path``), and the per-step path called through the
  C entry (T = 0: one ``wtw_gemm`` update launch a step), CUDA events, the
  median of 3 warm calls;
- checks that both give the same bits, and holds them against the plain
  version (rtol 2e-4, atol 1e-6 · max|plain|);
- times the plain version and 50 fp32 ``torch.matmul(WtW2, H)`` (the
  library yardstick) and gives the bound (the fp32 operations over the
  card's 67 TFLOP/s, or the bytes over 3.35 TB/s, whichever is larger).

One JSON line a K and ROOT, and first the card's name and power limit.
Needs one NVIDIA GPU.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, G, STEPS, EPS = 100_000, 2_000, 50, 1e-10
FP32_PEAK, HBM = 67e12, 3.35e12  # an H100 SXM's fp32 FLOP/s and HBM3 bytes/s


def child(root, ks):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from alpine_tpu_torch.ops import _build, kernels

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    _build.build_all()

    def time_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[len(times) // 2]

    def steps_direct(num2, H0, WtW2):
        K, n = H0.shape
        out, scratch = torch.empty_like(H0), torch.empty_like(H0)
        # trees since wtw_gemm's ring take WtW2's K x K transpose scratch too
        At = torch.empty((K, K), dtype=torch.float32, device=H0.device)
        at = [At.data_ptr()] if len(_build.SIGNATURES["fused_transform"][2]) == 16 else []
        rc = _build.entry("fused_transform")(
            num2.data_ptr(), H0.data_ptr(), WtW2.data_ptr(), K, 0, n, 0, 0, 0, 0, STEPS, EPS,
            scratch.data_ptr(), *at, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the per-step path failed to launch: CUDA error {rc}")
        return out

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for K in ks:
        W = torch.rand((G, K), generator=gen, device=dev)
        X = torch.poisson(torch.full((G, N), 1.5, device=dev), generator=gen)
        num2, WtW2 = 2.0 * (W.T @ X), 2.0 * (W.T @ W)
        del X
        H0 = torch.rand((K, N), generator=gen, device=dev) + 0.05
        rule = lambda: kernels.fused_transform(num2, H0, WtW2, EPS, n_iter=STEPS)
        steps = lambda: steps_direct(num2, H0, WtW2)
        plain = lambda: kernels.fused_transform_plain(num2, H0, WtW2, EPS, n_iter=STEPS)
        got, step_out, want = rule(), steps(), plain()
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs()
        worst = float((err / (1e-6 * float(want.abs().max()) + 2e-4 * want.double().abs()))
                      .max())
        ops = STEPS * (2.0 * K * K + 3.0 * K) * N
        nbytes = 3 * 4 * K * N + 4 * K * K
        row = {"root": root, "K": K, "cells": N, "steps": STEPS,
               "path": kernels.transform_path(K),
               "rule_ms": time_ms(rule), "steps_ms": time_ms(steps),
               "plain_ms": time_ms(plain), "library_ms": time_ms(
                   lambda: [torch.matmul(WtW2, H0) for _ in range(STEPS)]),
               "bound_ms": max(ops / FP32_PEAK, nbytes / HBM) * 1e3,
               "steps_bit_equal_rule": bool(torch.equal(got, step_out)),
               "worst_err_over_tolerance": worst}
        print(json.dumps(row), flush=True)
        del num2, WtW2, H0, got, step_out, want
        torch.cuda.empty_cache()


def main(argv):
    args = argv[1:]
    if len(args) >= 2 and args[0] == "--child":
        child(args[1], [int(k) for k in args[2].split(",")])
        return 0
    ks = "768,1024,2048"
    if "--ks" in args:
        i = args.index("--ks")
        ks = args[i + 1]
        del args[i:i + 2]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    for root in args or [HERE]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root, ks],
                             timeout=1500)
        if res.returncode != 0:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

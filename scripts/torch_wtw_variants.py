#!/usr/bin/env python3
"""Check and time design variants of wtw_gemm, the large-K fp32 product of
the chain's D = WᵀW H (store epilogue) and of K3's per-step path (update
epilogue), against the design before them.

    python3 scripts/torch_wtw_variants.py [--out FILE]   # from the repository root

``scripts/wtw_gemm_variants.cu`` puts the parent design (variant 0,
``parent``: A staged through registers, chunks of 8 j in two buffers, the
cells on x of the grid), the kernel itself (variant 2, ``ring16x4``: its
launch, A transposed once a call, both operands by cp.async into a ring
of 4 stages of 16 values of j, the row tiles of a cell tile back to back,
256 threads of 8 x 8 outputs, two blocks an SM) and nine other points of
that design (``ring_gemm`` there: "ringBKxS", S stages of BK values of
j; "t16" 128-thread blocks of 8 x 16 outputs a thread, two an SM; "n256"
256-thread blocks of 8 x 16 outputs a thread over 128 x 256 tiles, one
an SM; "t12" 128-thread blocks of 8 x 12 outputs over 128 x 96 tiles,
three an SM; else 256 threads of 8 x 8, two an SM) behind one C entry,
built beside the package's kernels: 1 ``ring16x4 cells outer`` (the
parent's block order: the ring alone), 3 ``ring16x4 t16``, 4
``ring32x3``, 5 ``ring8x4``, 6 ``ring16x2``, 7 ``ring16x4 n256``, 8
``ring32x3 n256``, 9 ``ring16x4 t12`` and 10 ``ring32x3 t12``.

Prints, one JSON line each (and writes them to FILE, by default
TMPDIR/wtw_variants.jsonl): the card's name and power limit; ptxas's
registers and spill stores of every instantiation; the bit checks,
where every variant and ``kernels.wtw_gemm`` must give the parent's bits
(and a second launch its own) in both epilogues at K = 513, 768, 1024 and
2048 on 17, 1,001, 5,040 and 100,000 cells; then at K = 768, 1024 and 2048
x 100,000 cells the ms a call (CUDA events, median of 10, the transpose
included) of every variant in both epilogues, in two passes (variants in
order, then reversed), beside fp32 ``torch.matmul(A, B)`` with TF32 off,
with the SM clock and power draw that nvidia-smi sampled meanwhile.
Needs one NVIDIA GPU.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

VARIANTS = ("parent", "ring16x4 cells outer", "ring16x4", "ring16x4 t16", "ring32x3",
            "ring8x4", "ring16x2", "ring16x4 n256", "ring32x3 n256", "ring16x4 t12",
            "ring32x3 t12")
BIT_KS = (513, 768, 1024, 2048)
BIT_NS = (17, 1001, 5040, 100_000)
TIME_KS = (768, 1024, 2048)
EPILOGUES = ("store", "update")
OUT = (sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv
       else os.path.join(tempfile.gettempdir(), "wtw_variants.jsonl"))


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def sample_stats(values):
    """Min, median and max of nvidia-smi's samples (None where it gave none)."""
    if not values:
        return None
    values = sorted(values)
    return [values[0], values[len(values) // 2], values[-1]]


def main():
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from alpine_tpu_torch.ops import _build, kernels

    os.makedirs(os.path.dirname(os.path.abspath(OUT)), exist_ok=True)
    open(OUT, "w").close()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit({"card": smi.stdout.strip(), "torch": torch.__version__})
    tmp = tempfile.mkdtemp(prefix="wtw_variants_")
    try:
        out = os.path.join(tmp, "libwtw_variants.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", out,
               os.path.join(ROOT, "scripts", "wtw_gemm_variants.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        _build.entry("wtw_gemm")
        _build.entry("fused_transform")
        logs = {"x_passes": _build.build_log("x_passes"),
                "fused_transform": _build.build_log("fused_transform"),
                "variants": proc.communicate()[0]}
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for the variants:\n{logs['variants']}")
        usage = {f"{name} {fn}": u for name, log in logs.items()
                 for fn, u in cs.ptxas_usage(log).items()
                 if "wtw" in fn or "parent_gemm" in fn or "ring_gemm" in fn}
        emit({"ptxas": usage})
        lib = ctypes.CDLL(out)
        var_fn = lib.alpine_wtw_variant
        P, I = ctypes.c_void_p, ctypes.c_int
        var_fn.argtypes = [I, I, P, P, I, I, P, ctypes.c_float, P, P, P]
        var_fn.restype = ctypes.c_int
        run(torch, kernels, var_fn)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def run(torch, kernels, var_fn):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def variant(v, epi, A, B, num2):
        """Variant v's output and its call."""
        K, n = B.shape
        At = torch.empty((K, K), device=dev)
        out = torch.empty((K, n), device=dev)
        call = lambda: var_fn(v, epi, A.data_ptr(), B.data_ptr(), K, n,
                              None if epi == 0 else num2.data_ptr(), cs.EPS, At.data_ptr(),
                              out.data_ptr(), stream)
        rc = call()
        if rc != 0:
            raise SystemExit(f"{VARIANTS[v]} {EPILOGUES[epi]}: launch returned {rc}")
        return out, call

    def problem(K, n):
        A = torch.rand((K, K), generator=gen, device=dev)
        B = torch.rand((K, n), generator=gen, device=dev) + 0.05
        num2 = torch.rand((K, n), generator=gen, device=dev) * K
        return A, B, num2

    # every variant, and the kernel through its wrapper, the parent's bits
    checked = 0
    for K in BIT_KS:
        for n in BIT_NS:
            A, B, num2 = problem(K, n)
            for epi in (0, 1):
                base, _ = variant(0, epi, A, B, num2)
                base = base.clone()
                outs = {}
                for v in range(1, len(VARIANTS)):
                    got, call = variant(v, epi, A, B, num2)
                    first = got.clone()
                    call()
                    torch.cuda.synchronize()
                    outs[VARIANTS[v]] = (torch.equal(first, base), torch.equal(got, first))
                if epi == 0:
                    got = kernels.wtw_gemm(A, B)
                    outs["kernels.wtw_gemm"] = (torch.equal(got, base),
                                                torch.equal(kernels.wtw_gemm(A, B), got))
                bad = {k: v for k, v in outs.items() if not all(v)}
                if bad:
                    emit({"failed": bad, "K": K, "n": n, "epilogue": EPILOGUES[epi]})
                    raise SystemExit(1)
                checked += len(outs)
            del A, B, num2
            torch.cuda.empty_cache()
    emit({"bits": "every variant and kernels.wtw_gemm the parent's bits, a second launch "
                  "its own", "ks": list(BIT_KS), "cells": list(BIT_NS), "checks": checked})

    # the bench shape's cells: each variant in both epilogues, two passes
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    n = cs.N
    for K in TIME_KS:
        A, B, num2 = problem(K, n)
        rows = {}
        smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader,nounits", "-lms", "250"],
                               stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        for order in (range(len(VARIANTS)), reversed(range(len(VARIANTS)))):
            for v in order:
                for epi in (0, 1):
                    _, call = variant(v, epi, A, B, num2)
                    rows.setdefault(f"{VARIANTS[v]} {EPILOGUES[epi]}", []).append(
                        cs.time_ms(call, 10))
            rows.setdefault("fp32 torch.matmul(A, B), TF32 off", []).append(
                cs.time_ms(lambda: torch.matmul(A, B), 10))
        smi.terminate()
        samples = [[float(v) for v in line.split(",")]
                   for line in smi.communicate()[0].splitlines() if line.count(",") == 1]
        flop = 2.0 * K * K * n
        emit({"row": f"wtw_gemm variants K={K} n={n}", "ms_pass1_pass2": rows,
              "sm_clock_mhz_min_median_max": sample_stats([v[0] for v in samples]),
              "power_w_min_median_max": sample_stats([v[1] for v in samples]),
              "bound_ms": max(flop / 67e12, 4.0 * (K * K + 2 * K * n) / 3.35e12) * 1e3,
              "gflop": flop * 1e-9})
        del A, B, num2
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    return 0


if __name__ == "__main__":
    sys.exit(main())

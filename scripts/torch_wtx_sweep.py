#!/usr/bin/env python3
"""Time P2 ``wtx``'s bf16 path over grids beside ``kernels.wtx_grid``'s.

    python3 scripts/torch_wtx_sweep.py            # from the repository root

At the bench shape (100k cells x 2,000 genes, int8 and bf16 X) and k = 5
and 30 (ALS's blocks), the script calls the C entry ``alpine_wtx`` directly
with every warp layout the kernel takes at that k (WR rows of warps, 1-3
groups of 16 cells a warp: tiles of 64..384 cells), gene chunk (64, 32) and
ring depth S (2..8, within half an SM's shared memory), checks each result
against the plain
version (rtol 1e-4 + 1e-6 max|plain|), and prints one JSON line per grid:
median CUDA-event ms of 20 warm launches (round_w included), ms a call over
20 calls back to back, and the GB/s of X read.  Then, for each k and X
type, the device time of each kernel of ``kernels.wtx`` (round_w, wtx_mma;
torch.profiler) and bf16 ``torch.matmul`` over a pre-cast copy of X, single
and back to back; ptxas's registers and spill stores of each ``wtx_mma``
instantiation; ``stream_probe`` on the int8 X as the card's streaming rate;
and the card's name and power limit.  Needs one NVIDIA GPU.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np

G, N = 2000, 100_000
REPS = 20


def main():
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from alpine_tpu_torch.ops import _build, kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    X8 = torch.poisson(torch.full((G, N), 1.5, device=dev),
                       generator=gen).clamp_(max=127).to(torch.int8)
    W = torch.rand((G, 40), generator=gen, device=dev) + 0.05
    fn = _build.entry("wtx")
    log = _build.build_log("x_passes")
    fn_name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            fn_name = m.group(1)
        elif fn_name and "wtx_mma" in fn_name and ("registers" in line or "spill" in line):
            print(json.dumps({"ptxas": fn_name, "line": line.strip()}), flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def time_ms(f):
        f()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            f()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def back_to_back_ms(f, calls=20):
        f()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            f()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / calls

    budget = min(kernels._MAX_SMEM, kernels._SM_SMEM // 2 - kernels._BLOCK_SMEM_RESERVED)
    for X in (X8, X8.to(torch.bfloat16)):
        xname = str(X.dtype)[6:]
        for k, Wk in ((5, W[:, :5].contiguous()), (30, W[:, 10:].contiguous())):
            want = kernels.wtx_plain(X, Wk)
            atol = 1e-6 * float(want.abs().max())
            out = torch.empty((k, N), dtype=torch.float32, device=dev)
            default = kernels.wtx_grid(G, N, k, X.dtype)
            Kp = kernels._pad16(k)
            wb = torch.empty((Kp, -(-G // 64) * 64), dtype=torch.bfloat16, device=dev)
            rows = Kp // 16
            for WR in (1, 2):  # at k = 5, WR = 2 leaves a warp row idle
                frags = -(-rows // WR)
                for NT in kernels._WTX_GROUPS:
                    if frags * NT * 8 > kernels._WTX_ACC:
                        continue
                    T = 8 // WR * 16 * NT
                    for GC, S in ((gc, s) for gc in kernels._WTX_GENE_CHUNKS
                                  for s in range(2, 9)):
                        smem = kernels.wtx_smem_bytes(k, T, S, X.dtype, GC)
                        if smem > budget:
                            continue

                        def run():
                            rc = fn(X.data_ptr(), kernels._XTYPE[X.dtype], Wk.data_ptr(),
                                    G, N, k, T, WR, GC, S, 1, -(-G // GC) * GC,
                                    wb.data_ptr(), None, None, out.data_ptr(), stream)
                            if rc:
                                raise RuntimeError(f"wtx failed: CUDA error {rc}")

                        ms = time_ms(run)
                        err = float(((out - want).abs() / (atol + 1e-4 * want.abs())).max())
                        print(json.dumps({
                            "x": xname, "k": k, "T": T, "WR": WR, "GC": GC, "S": S,
                            "blocks": -(-N // T), "smem": smem,
                            "wtx_grid": (T, WR, GC, S) == default[:4],
                            "ms": ms, "ms_back_to_back": back_to_back_ms(run),
                            "GBps_x": X.numel() * X.element_size() / ms * 1e-6,
                            "err_over_tolerance": err}), flush=True)
                        if err > 1.0:
                            raise RuntimeError("wtx disagrees with its plain version")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    kernels.wtx(X, Wk)
                torch.cuda.synchronize()
            Xb, Wbt = X.to(torch.bfloat16), Wk.bfloat16().T
            lib = lambda: torch.matmul(Wbt, Xb)
            print(json.dumps({
                "x": xname, "k": k, "grid": default,
                "wtx_ms": time_ms(lambda: kernels.wtx(X, Wk)),
                "wtx_ms_back_to_back": back_to_back_ms(lambda: kernels.wtx(X, Wk)),
                "library_ms": time_ms(lib),
                "library_ms_back_to_back": back_to_back_ms(lib),
                "device_ms_per_call": {
                    e.key[:40]: e.self_device_time_total * 1e-3 / 10
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}}),
                flush=True)
            del Xb
    ms = time_ms(lambda: kernels.stream_probe(X8))
    print(json.dumps({"stream_probe_int8_ms": ms,
                      "GBps": X8.numel() / ms * 1e-6, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

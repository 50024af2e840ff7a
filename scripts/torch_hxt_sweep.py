#!/usr/bin/env python3
"""Time P1 ``hxt``'s bf16 path over grids beside ``kernels.hxt_grid``'s.

    python3 scripts/torch_hxt_sweep.py            # from the repository root

At the bench shape (100k cells x 2,000 genes, K = 40, int8 and bf16 X) the
script calls the C entry ``alpine_hxt`` directly with every ring chunk
(128 and 64 cells a stage), gene block GB (128, 64: at most 4 fragments
a warp) and ring depth S (2..6, within a block's shared memory), splits
for one wave of 2 blocks an SM, checks each result against the plain
version (rtol 1e-4), and prints one JSON line per grid: median CUDA-event
ms of 20 warm launches and the GB/s of X read.  Then the device time of each kernel of one ``kernels.hxt``
call at hxt_grid's grid (round_h, hxt_mma, reduce_splits; torch.profiler),
``stream_probe`` on the same X as the card's streaming rate, and the
card's name and power limit.  Needs one NVIDIA GPU.
"""

import json
import os
import subprocess
import sys

import numpy as np

G, N, K = 2000, 100_000, 40
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
    H = torch.rand((K, N), generator=gen, device=dev) + 0.05
    fn = _build.entry("hxt")
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

    for X in (X8, X8.to(torch.bfloat16)):
        want = kernels.hxt_plain(X, H)
        out = torch.empty((K, G), dtype=torch.float32, device=dev)
        default = kernels.hxt_grid(G, N, K, X.dtype)
        for chunk in kernels._HXT_CHUNKS:
            hb = torch.empty((K, -(-N // chunk) * chunk), dtype=torch.bfloat16,
                             device=dev)
            for GB in (128, 64):
                gene_blocks = -(-G // GB)
                for S in (2, 3, 4, 5, 6):
                    smem = kernels.hxt_smem_bytes(K, GB, S, X.dtype, chunk)
                    if smem > kernels._MAX_SMEM:
                        continue
                    for waves in (1,):
                        n_chunks = -(-N // chunk)
                        want_split = max(1, min(n_chunks, 264 * waves // gene_blocks))
                        cps = -(-n_chunks // want_split) * chunk
                        n_split = -(-N // cps)
                        part = torch.empty((n_split, K, G), dtype=torch.float32,
                                           device=dev)

                        def run():
                            rc = fn(X.data_ptr(), kernels._XTYPE[X.dtype], H.data_ptr(),
                                    G, N, K, GB, n_split, cps, S, chunk, hb.data_ptr(),
                                    part.data_ptr(), out.data_ptr(), stream)
                            if rc:
                                raise RuntimeError(f"hxt failed: CUDA error {rc}")

                        ms = time_ms(run)
                        err = float(((out - want).abs() / (want.abs() + 1e-6)).max())
                        print(json.dumps({
                            "x": str(X.dtype)[6:], "chunk": chunk, "GB": GB, "S": S,
                            "n_split": n_split, "blocks": gene_blocks * n_split,
                            "smem": smem,
                            "hxt_grid": (GB, n_split, cps, S, chunk) == default,
                            "ms": ms,
                            "GBps_x": X.numel() * X.element_size() / ms * 1e-6,
                            "max_rel_err": err}), flush=True)
                        if err > 1e-4:
                            raise RuntimeError("hxt disagrees with its plain version")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                kernels.hxt(X, H)
            torch.cuda.synchronize()
        print(json.dumps({"x": str(X.dtype)[6:], "device_ms_per_call": {
            e.key[:40]: e.self_device_time_total * 1e-3 / 10
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}}),
            flush=True)
    ms = time_ms(lambda: kernels.stream_probe(X8))
    print(json.dumps({"stream_probe_int8_ms": ms,
                      "GBps": X8.numel() / ms * 1e-6, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

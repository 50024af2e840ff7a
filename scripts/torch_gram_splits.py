#!/usr/bin/env python3
"""Time gram_wide (K1/K2/K4's H Hᵀ, HHtU, rowsum and Bnum) alone at K <= 512
over several split counts, on one NVIDIA GPU.

    python3 scripts/torch_gram_splits.py

For K = 16, 40, 56, 112, 144, 224 and 512 on 66,667 and 100,000 cells, 5
label rows, with and without counts, the kernel (csrc/gram_wide.cuh,
through its C entry ``gram_wide``) runs at every split count of 8, 16, 33,
66, 132, 264, 528 and 1,056 that keeps a split at or under 16,384 cells
(``kernels._WIDE_SPLIT_CELLS``), and at ``kernels.gram_wide_grid``'s: median
CUDA-event ms of 20 warm launches (``gram_reduce`` included), the device ms
of ``gram_wide`` and of ``gram_reduce`` in one profiled call, and the
partials' bytes.  Prints one JSON line a shape and the card's name and
power limit first.  Needs one NVIDIA GPU; exits non-zero without one.
"""

import json
import subprocess
import sys

import numpy as np

KS = (16, 40, 56, 112, 144, 224, 512)
NS = (66_667, 100_000)
SPLITS = (8, 16, 33, 66, 132, 264, 528, 1056)
L = 5


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    from alpine_tpu_torch.ops import _build, kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip(), "torch": torch.__version__}), flush=True)
    fn = _build.entry("gram_wide")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def time_ms(call, reps=20):
        call()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    for n in NS:
        c = torch.randint(0, 4, (n,), generator=gen, device=dev).float()
        Q = torch.rand((L, n), generator=gen, device=dev)
        for K in KS:
            Hn = torch.rand((K, n), generator=gen, device=dev)
            for counts in (False, True):
                cc = c if counts else None
                rule = kernels.gram_wide_grid(n, K)
                least = -(-n // kernels._WIDE_SPLIT_CELLS)
                rows = {}
                for want in sorted({s for s in SPLITS if s >= least} | {rule[0]}):
                    cps = -(-(-(-n // want)) // kernels._GRAM_BK) * kernels._GRAM_BK
                    n_split = -(-n // cps)
                    floats = kernels.gram_split_floats(K, L, counts)
                    part = torch.empty((n_split, floats), device=dev)
                    out = (torch.empty((K, K), device=dev),
                           torch.empty((K, K), device=dev) if counts else None,
                           torch.empty(K, device=dev), torch.empty((L, K), device=dev))
                    ptr = lambda t: None if t is None else t.data_ptr()
                    call = lambda: fn(Hn.data_ptr(), ptr(cc), Q.data_ptr(), K, n, L, n_split,
                                      cps, part.data_ptr(), *[ptr(t) for t in out], stream)
                    assert call() == 0
                    ms = time_ms(call)
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        call()
                        torch.cuda.synchronize()
                    dev_ms = {e.key.split("<")[0].split("(")[0].replace("void alpine::", ""):
                              e.self_device_time_total * 1e-3 for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA}
                    rows[n_split] = {"cells_per_split": cps, "ms": ms, "device_ms": dev_ms,
                                     "partial_mb": n_split * floats * 4 / 1e6}
                    del part, out
                print(json.dumps({"K": K, "n": n, "counts": counts, "labels": L,
                                  "rule": rule, "by_splits": rows}), flush=True)
            del Hn
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Check and time design variants of the fp32 X passes above K = 512
(csrc/fma_wide.cuh: P1 hxt_fma_wide, P2 wtx_fma_wide) on float32 and int16
X.

    python3 scripts/torch_fma_wide_variants.py [--out FILE]   # from the repository root

``scripts/fma_wide_variants.cu`` holds the kernel's launch (variant 0: a
ring of 2 stages, 8 x 8 outputs a thread, one barrier a chunk, outputs
stored a value at a time, P1 copying and turning cells in lane pairs of a
row) and the other points of its design behind one C entry, built beside
the package's kernels (its header says what each variant changes): both
passes ``stages3``, ``stages4`` (P1: int16 X only), ``tile8x4`` (float32
X) and ``vector_stores`` (16-byte stores of the outputs); P2
``widen_on_load`` (int16 X whose rows lie on 16-byte boundaries); P1
``rows16`` (staged rows not padded) and ``lane_a_row`` (a lane copies and
turns 8 consecutive cells of one row); and P1 at other split counts (the
kernel's own launch).

Prints, one JSON line each (and writes them to FILE, by default
TMPDIR/fma_wide_variants.jsonl): the card's name and power limit; ptxas's
registers and spill stores of every instantiation; the bit checks, where
every variant must give the kernel's bits (P1 at the rule's splits) and a
second launch its own, at K = 513, 768 and 2048 on 17, 1,001, 5,040 and
100,000 cells (300 genes; float32 and int16 X); then at the bench shape
(2,000 genes x 100,000 cells) and K = 768, 1024 and 2048 the ms a call
(CUDA events, median of 10; P1 with its reduce_splits) of every variant,
in two passes (variants in order, then reversed), beside fp32
``torch.matmul`` of the same product with TF32 off (int16 X through a
float32 copy made outside the timed region) and the bound (2 K g n flop
at 67 TFLOP/s); P1 at 7, 22 and 44 splits beside the rule's at K = 768;
and, for the record only (no route changes), the kernel at K = 384 and
512 on float32 X beside the K <= 512 kernels' wrappers and the library.
The SM clock and power draw nvidia-smi read before and after each timed
pass are printed beside it.  Needs one NVIDIA GPU.
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

VARIANTS = {"wtx": ("kernel", "stages3", "stages4", "tile8x4", "widen_on_load",
                    "vector_stores"),
            "hxt": ("kernel", "stages3", "stages4", "tile8x4", "rows16", "lane_a_row",
                    "vector_stores")}
# variants a storage type does not take (the C entry returns an error)
SKIP = {("wtx", "int16", "tile8x4"), ("wtx", "float32", "widen_on_load"),
        ("hxt", "int16", "tile8x4"), ("hxt", "float32", "stages4")}
BIT_KS = (513, 768, 2048)
BIT_NS = (17, 1001, 5040, 100_000)
TIME_KS = (768, 1024, 2048)
RECORD_KS = (384, 512)
SPLITS = (7, 22, 44)
OUT = (sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv
       else os.path.join(tempfile.gettempdir(), "fma_wide_variants.jsonl"))


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip()


def main():
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from alpine_tpu_torch.ops import _build, kernels

    os.makedirs(os.path.dirname(os.path.abspath(OUT)), exist_ok=True)
    open(OUT, "w").close()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    emit({"card": card.stdout.strip(), "torch": torch.__version__})
    tmp = tempfile.mkdtemp(prefix="fma_wide_variants_")
    try:
        out = os.path.join(tmp, "libfma_wide_variants.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", out,
               os.path.join(ROOT, "scripts", "fma_wide_variants.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        _build.entry("hxt_fma_wide")
        logs = {"x_passes": _build.build_log("x_passes"), "variants": proc.communicate()[0]}
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for the variants:\n{logs['variants']}")
        emit({"ptxas": {f"{name} {fn}": u for name, log in logs.items()
                        for fn, u in cs.ptxas_usage(log).items()
                        if "fma_wide" in fn or "var_" in fn}})
        lib = ctypes.CDLL(out)
        fn = lib.fw_variant
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, I, I, P, P, I, I, I, I, I, P, P, P]
        fn.restype = ctypes.c_int
        run(torch, kernels, fn)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def run(torch, kernels, fn):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    torch.backends.cuda.matmul.allow_tf32 = False
    xname = lambda X: str(X.dtype)[6:]

    def call(kind, v, X, P, K, splits=None):
        """Variant v's output and a call that launches it again."""
        g, n = X.shape
        if kind == "wtx":
            out = torch.empty((K, n), device=dev)
            part, n_split, cps = None, 0, 0
        else:
            out = torch.empty((K, g), device=dev)
            if K > 512:
                n_split, cps = kernels.hxt_fma_wide_grid(g, n, K, X.dtype)
            else:  # the record's K: the rule's fewest splits for two waves
                splits = splits or max(-(-n // 16384), -(-528 // (-(-K // 128) * -(-g // 128))))
            if splits is not None:
                cps = -(-(-(-n // 16)) // splits) * 16
                n_split = -(-n // cps)
            part = torch.empty((n_split, K, g), device=dev) if n_split > 1 else None
        args = (int(kind == "hxt"), v, kernels._XTYPE[X.dtype], X.data_ptr(), P.data_ptr(),
                g, n, K, n_split, cps, None if part is None else part.data_ptr(),
                out.data_ptr(), stream)
        launch = lambda: fn(*args)
        rc = launch()
        if rc != 0:
            raise SystemExit(f"{kind} {VARIANTS[kind][v]} {xname(X)} K={K} n={n}: rc {rc}")
        return out, launch

    def problem(g, n, K, xdt):
        X, W, H = cs.make_x_pass_problem(torch, gen, dev, g, n, K, xdt)
        return X, W, H

    def variants(kind, X, K):
        """The variants that take X (widen_on_load: rows on 16-byte
        boundaries only)."""
        aligned = X.shape[1] % 8 == 0 and K % 4 == 0
        return [(v, name) for v, name in enumerate(VARIANTS[kind])
                if (kind, xname(X), name) not in SKIP
                and (aligned or name != "widen_on_load")]

    # bits: every variant the kernel's, a second launch its own
    checks = 0
    for xdt in (torch.float32, torch.int16):
        for K in BIT_KS:
            for n in BIT_NS:
                X, W, H = problem(300, n, K, xdt)
                for kind, P in (("wtx", W), ("hxt", H)):
                    ref, _ = call(kind, 0, X, P, K)
                    plain = getattr(kernels, f"{kind}_plain")(X, P)
                    _, worst = cs.compare(ref, plain, 1e-4, 1e-6)
                    for v, name in variants(kind, X, K):
                        got, launch = call(kind, v, X, P, K)
                        again, _ = call(kind, v, X, P, K)
                        same = torch.equal(got, ref) and torch.equal(again, got)
                        checks += 1
                        if not same or worst > 1.0:
                            emit({"bits": False, "kind": kind, "variant": name,
                                  "x": xname(X), "K": K, "n": n, "worst": worst})
                            raise SystemExit(f"{kind} {name} {xname(X)} K={K} n={n}: other "
                                             f"bits than the kernel's (or plain {worst})")
                del X, W, H
        torch.cuda.empty_cache()
    emit({"bits": True, "checks": checks, "ks": list(BIT_KS), "cells": list(BIT_NS),
          "genes": 300})

    def time_ms(f, reps=10):
        f()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            f()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return sorted(ts)[len(ts) // 2]

    G, N = cs.G, cs.N
    for xdt in (torch.float32, torch.int16):
        for K in TIME_KS:
            X, W, H = problem(G, N, K, xdt)
            Xf = X.float()
            bound = 2.0 * K * G * N / cs.PEAKS["H100"][2] * 1e3
            for kind, P in (("wtx", W), ("hxt", H)):
                lib = ((lambda: torch.matmul(W.T, Xf)) if kind == "wtx"
                       else (lambda: torch.matmul(H, Xf.T)))
                launches = [(name, call(kind, v, X, P, K)[1]) for v, name in variants(kind, X, K)]
                if kind == "hxt" and K == 768:
                    launches += [(f"splits{s}", call(kind, 0, X, P, K, s)[1]) for s in SPLITS]
                launches.append(("library", lib))
                ms = {name: [] for name, _ in launches}
                clocks = [smi()]
                for order in (launches, launches[::-1]):
                    for name, f in order:
                        ms[name].append(time_ms(f))
                    clocks.append(smi())
                row = {"kind": kind, "x": xname(X), "K": K, "cells": N, "genes": G,
                       "bound_ms": bound, "ms_two_passes": ms, "smi_sm_mhz_power": clocks,
                       "library": "fp32 torch.matmul, TF32 off"
                                  + (" (over a float32 copy)" if xdt == torch.int16 else "")}
                if kind == "hxt":
                    row["rule_splits"] = kernels.hxt_fma_wide_grid(G, N, K, xdt)
                emit(row)
            del X, W, H, Xf
            torch.cuda.empty_cache()
    # for the record: the kernel at K <= 512 (float32) beside the K <= 512
    # route's wrappers and the library; no route changes
    for K in RECORD_KS:
        X, W, H = problem(G, N, K, torch.float32)
        for kind, P in (("wtx", W), ("hxt", H)):
            _, launch = call(kind, 0, X, P, K)
            lib = ((lambda: torch.matmul(W.T, X)) if kind == "wtx"
                   else (lambda: torch.matmul(H, X.T)))
            wrapper = lambda: getattr(kernels, kind)(X, P)
            emit({"record": True, "kind": kind, "x": "float32", "K": K,
                  "fma_wide_ms": time_ms(launch), "k512_route_ms": time_ms(wrapper),
                  "library_ms": time_ms(lib),
                  "bound_ms": 2.0 * K * G * N / cs.PEAKS["H100"][2] * 1e3})
        del X, W, H
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())

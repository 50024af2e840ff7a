#!/usr/bin/env python3
"""Time design variants of the large-K chain's gram_wide and iter_wide
against the kernels as they are, and gram_wide's split counts.

    python3 scripts/torch_gram_variants.py   # from the repository root

gram_wide: ``scripts/gram_wide_variants.cu`` puts the kernel (variant 0,
``as_is``) and two designs that feed its products through a ring of
16-byte ``cp.async`` stages (1, ``ring16_turn``; 2, ``ring32_direct``;
described there) behind one C entry, built beside the package's kernels.
iter_wide: Bg staged in shared memory where it fits (``staged``, as
``kernels.wide_stages_bg`` chooses) against read through the cache at every
label count (``ldg``, that choice forced off).

Prints, one JSON line each: the card's name and power limit; ptxas's
registers and spill stores of every gram kernel and of iter_wide on int8
X, and any performance note (C75xx); the small cases (K = 513 and 1,030; 17, 1,001 and 5,040 cells;
0, 5 and 9 labels; with and without counts), where the kernel must agree
with the plain version (rtol 1e-4, atol 1e-6 max|plain|) and every variant,
on the same splits, must give its bits; then at 768 x 100k cells the ms a
call (CUDA events, median of 10; gram_reduce included) of every variant at
12, 24, 48 and 50 splits (``gram_wide_grid``'s), each variant's splits of
a multiple of its stage, with 0 and 5 labels, with and without counts, in
two passes (variants in order, then reversed); last K1 and K4 (int8, bench
shape, blocks (192, 192, 384), 5 labels) with iter_wide ``staged``,
``ldg``, ``ldg``, ``staged``: ms a call and iter_wide's device ms
(torch.profiler), and whether the two give the same bits.  Needs one
NVIDIA GPU.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

VARIANTS = ("as_is", "ring16_turn", "ring32_direct")
STAGE_CELLS = (8, 16, 32)  # cells_per_split must be a multiple of these
K768, BLOCKS = 768, (192, 192, 384)


def emit(obj):
    print(json.dumps(obj), flush=True)


def cdiv(a, b):
    return -(-a // b)


def main():
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from alpine_tpu_torch.ops import _build, kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit({"card": smi.stdout.strip(), "torch": torch.__version__})
    tmp = tempfile.mkdtemp(prefix="gram_variants_")
    try:
        out = os.path.join(tmp, "libgram_variants.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", out,
               os.path.join(ROOT, "scripts", "gram_wide_variants.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        _build.entry("fused_iteration")
        logs = {"x_passes": _build.build_log("x_passes"), "variants": proc.communicate()[0]}
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for the variants:\n{logs['variants']}")
        usage = {f"{name} {fn}": u for name, log in logs.items()
                 for fn, u in cs.ptxas_usage(log).items()
                 if "gram" in fn or ("iter_wide" in fn and "IaLb" in fn)}
        notes = sorted(set(re.findall(r"\((C75\d\d)\)", logs["variants"] + logs["x_passes"])))
        emit({"ptxas": usage, "notes": notes})
        lib = ctypes.CDLL(out)
        var_fn = lib.gram_variant
        var_fn.argtypes = [ctypes.c_int] + list(_build.SIGNATURES["gram_wide"][2])
        var_fn.restype = ctypes.c_int
        run(torch, kernels, var_fn)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def run(torch, kernels, var_fn):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def gram(v, Hn, c, Q, n_split, cps):
        """Variant v's (HHt, HHtU, rowsum, Bnum) and its call."""
        K, n = Hn.shape
        L = 0 if Q is None else Q.shape[0]
        part = torch.empty(n_split * kernels.gram_split_floats(K, L, c is not None), device=dev)
        out = (torch.empty((K, K), device=dev),
               torch.empty((K, K), device=dev) if c is not None else None,
               torch.empty(K, device=dev), torch.empty((max(L, 1), K), device=dev))
        ptr = lambda t: None if t is None else t.data_ptr()
        call = lambda: var_fn(v, Hn.data_ptr(), ptr(c), ptr(Q), K, n, L, n_split, cps,
                              part.data_ptr(), *[ptr(t) for t in out], stream)
        rc = call()
        if rc != 0:
            raise SystemExit(f"{VARIANTS[v]}: launch returned {rc}")
        return [t for t in out[:3] if t is not None] + [out[3][:L]], call

    # small cases: the kernel against the plain version; every variant its bits
    worst = 0.0
    for K in (513, 1030):
        for n in (17, 1001, 5040):
            Hn = torch.rand((K, n), generator=gen, device=dev) + 0.05
            cn = torch.randint(0, 4, (n,), generator=gen, device=dev).float()
            cps = 32 * cdiv(cdiv(n, cdiv(n, 1024)), 32)
            n_split = cdiv(n, cps)
            for L in (0, 5, 9):
                Q = torch.rand((L, n), generator=gen, device=dev) if L else None
                for c in (None, cn):
                    want = [t for t in kernels.gram_wide_plain(Hn, c, Q) if t is not None]
                    base, _ = gram(0, Hn, c, Q, n_split, cps)
                    worst = max(worst, max(cs.compare(a, b, 1e-4, 1e-6)[1]
                                           for a, b in zip(base, want, strict=True)
                                           if b.numel()))
                    for v in range(len(VARIANTS)):
                        got, call = gram(v, Hn, c, Q, n_split, cps)
                        torch.cuda.synchronize()
                        first = [t.clone() for t in got]
                        call()
                        torch.cuda.synchronize()
                        if not all(torch.equal(a, b) for a, b in zip(got, base)) or \
                                not all(torch.equal(a, b) for a, b in zip(got, first)):
                            emit({"failed": VARIANTS[v], "K": K, "n": n, "L": L,
                                  "counts": c is not None})
                            raise SystemExit(1)
    emit({"small_cases": "every variant the kernel's bits, second launches too",
          "kernel_worst_err_over_tolerance": worst})

    # the bench shape: variants by splits, labels and counts, two passes
    n = cs.N
    Hn = torch.rand((K768, n), generator=gen, device=dev) + 0.05
    Q5 = torch.rand((5, n), generator=gen, device=dev)
    cn = torch.randint(0, 3, (n,), generator=gen, device=dev).float()
    rule = kernels.gram_wide_grid(n, K768)
    rows = {}
    for order in ((0, 1, 2), (2, 1, 0)):
        for want in (12, 24, 48, rule[0]):
            for L in (0, 5):
                for c in (None, cn):
                    for v in order:
                        cps = STAGE_CELLS[v] * cdiv(cdiv(n, want), STAGE_CELLS[v])
                        n_split = cdiv(n, cps)
                        _, call = gram(v, Hn, c, Q5 if L else None, n_split, cps)
                        key = f"{VARIANTS[v]} splits={n_split} L={L} counts={c is not None}"
                        rows.setdefault(key, []).append(cs.time_ms(call, 10))
    emit({"row": "gram_wide variants K=768", "rule": rule, "ms_pass1_pass2": rows})
    # each variant on the rule's splits against the plain version
    errs = {}
    for v in range(len(VARIANTS)):
        cps = STAGE_CELLS[v] * cdiv(cdiv(n, rule[0]), STAGE_CELLS[v])
        for c in (None, cn):
            got, _ = gram(v, Hn, c, Q5, cdiv(n, cps), cps)
            want = [t for t in kernels.gram_wide_plain(Hn, c, Q5) if t is not None]
            errs[f"{VARIANTS[v]} counts={c is not None}"] = max(
                cs.compare(a, b, 1e-4, 1e-6)[1] for a, b in zip(got, want, strict=True))
    emit({"row": "gram_wide variants K=768 worst_err_over_tolerance", "errors": errs})
    del Hn, Q5, cn

    # iter_wide: Bg staged in shared memory against read through the cache
    X, W, H, WtW, Ys, Bs, lam = cs.iteration_problem(torch, gen, dev, cs.G, n, BLOCKS, (2, 3),
                                                     torch.int8)
    C = torch.randint(0, 3, (2, n), generator=gen, device=dev).float()
    stages_bg = kernels.wide_stages_bg
    for name, C_ in (("K1", None), ("K4", C)):
        kern = lambda: kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, cs.EPS, C_,
                                               blocks=BLOCKS, loss_kl=True)
        row, outs = {}, {}
        for which in ("staged", "ldg", "ldg", "staged"):
            kernels.wide_stages_bg = stages_bg if which == "staged" else lambda *a: False
            ms = cs.time_ms(kern, 10)
            by_kernel = cs.device_ms_by_kernel(torch, kern)
            iter_ms = sum(v for k, v in by_kernel.items() if "iter_wide" in k)
            row.setdefault(which, []).append({"ms": ms, "iter_wide_device_ms": iter_ms})
            out = kern()
            outs[which] = [t.clone() for v in out for t in (v if isinstance(v, tuple) else (v,))
                           if isinstance(t, torch.Tensor)]
        kernels.wide_stages_bg = stages_bg
        same = all(torch.equal(a, b) for a, b in zip(outs["staged"], outs["ldg"]))
        emit({"row": f"iter_wide {name} int8 K={K768}", "runs": row,
              "staged_and_ldg_same_bits": same})
    return 0


if __name__ == "__main__":
    sys.exit(main())

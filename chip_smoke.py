#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (alpine_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printing one JSON line:
  device  the card's name, count and power limit (nvidia-smi);
  build   nvcc builds every kernel of alpine_tpu_torch/csrc for sm_90a;
  sass    cuobjdump of the fused_iteration library: tensor-core (HMMA)
          instructions in both passes of the int8 and bf16 instantiations
          and in none of float32/int16, and no spill stores on the bf16 path
          (ptxas -v); for fused_transform, registers, spill stores (none
          allowed) and FFMA count of each bucket of the register path; for
          x_passes (ALS's hxt and wtx), HMMA in the bf16 kernels and none in
          the fp32 ones, registers and spill stores;
  kernel  each kernel against its plain PyTorch version on the card, at the
          bench shape (100k cells x 2,000 genes, K = 40, labels (2, 3), int8)
          and at small shapes over the other storage types, blocks and
          losses (K not a multiple of 16, ragged genes and cells, K = 300
          and 512 where the bf16 path takes its own tile), with its time
          beside the plain version's and its bound; beside K1 the two bf16
          cuBLAS products over a bf16 copy of X as a yardstick;
          fused_iteration's counts mode (weighted_fast) with counts from the
          port's own balanced sampler, undrawn columns checked bit for bit;
          fused_transform at K = 40 (the register path) and K = 300 (the
          tiled path), each row naming its path; ALS's X passes hxt (P1,
          K = 40) and wtx (P2, k = 5 and 30) on int8 and once on float32 X
          at the bench shape, timed beside a bf16 (float32) torch.matmul
          over a pre-cast copy of X, and at small edge shapes on every
          storage type (1,001 cells, K = 1, 13 and 300);
  stream_probe  the streaming probe's entry point (alpine_tpu_torch/
          probe.py) on int8 and float32 X at the bench shape: ms and GB/s
          read, the fold and column sums checked exactly against the plain
          version, torch.sum beside it;
  fit_loop  the fused fit loop alone on device-resident bench data: ms
          per iteration, device busy share and device time per kernel
          (profiler); then the same for the weighted_fast loop
          (fit_loop_weighted_fast, the sampler's draws included) and for
          the ALS loop (fit_loop_als, 50 iterations);
  small   a small fit on the card against the same fit on the CPU (plain
          kernel versions, same seed); small_als the same with
          use_als=True;
  slice   ALPINE(n_components=30, n_covariate_components=[5, 5]).fit(...,
          max_iter=50) and .transform() (through the fit's device X) on
          100k x 2,000 Poisson counts (int8), with the launch counts read
          around it, then an unguided fit (no covariates) for
          fused_h_update's path;
  slice_weighted_fast  the same fit with sampling_method="weighted_fast",
          a transform through the fit's group-sorted device X, then
          free_device_cache() and the uncached transform;
  slice_als  the same fit with use_als=True (hxt once and wtx three times
          an iteration, fused_iteration never) and a cached transform.
Then one JSON line with every kernel's numbers and, last, the result line.
Any failed check raises: the script exits non-zero and prints no result.
Without a GPU it exits with code 2 before doing anything.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

G, N = 2000, 100_000
BLOCKS, N_LABELS = (5, 5, 30), (2, 3)
TRANSFORM_ITERS = 50
FIT_ITERS = 50
LOOP_ITERS = 10
ALS_LOOP_ITERS = 50
EPS = 1e-6
# published dense peaks (NVIDIA data sheets): bytes/s, bf16 flop/s, fp32
# flop/s outside the tensor cores
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 51e12),
         "H100 NVL": (3.9e12, 835e12, 60e12),
         "H100": (3.35e12, 989e12, 67e12)}
REPLACES = {
    "fused_iteration": "alpine_tpu/ops/pallas_kernels.py:637",
    "fused_iteration_counts": "alpine_tpu/ops/pallas_kernels.py:637 (counts)",
    "fused_h_update": "alpine_tpu/ops/pallas_kernels.py:361",
    "fused_transform": "alpine_tpu/ops/pallas_kernels.py:806",
    "hxt": "benchmarks/als_probe.py:172",
    "wtx": "benchmarks/als_probe.py:180",
    "stream_probe": "benchmarks/envelope_probe.py:129",
}
SOURCES = {
    "fused_iteration": "alpine_tpu_torch/csrc/fused_iteration.cu",
    "fused_iteration_counts": "alpine_tpu_torch/csrc/fused_iteration.cu",
    "fused_h_update": "alpine_tpu_torch/csrc/fused_iteration.cu",
    "fused_transform": "alpine_tpu_torch/csrc/fused_transform.cu",
    "hxt": "alpine_tpu_torch/csrc/x_passes.cu",
    "wtx": "alpine_tpu_torch/csrc/x_passes.cu",
    "stream_probe": "alpine_tpu_torch/csrc/stream_probe.cu",
}
# mangled names of fused_iteration.cu's passes: <X type>, kBf16, kCounts
PASS_NAME = re.compile(r"(iter_tiles|hxt_partial)I(\w+?)Lb([01])ELb([01])E")
X_CODES = {"f": "float32", "13__nv_bfloat16": "bfloat16", "a": "int8", "s": "int16"}
# mangled name of fused_transform.cu's register path: transform_columns<KB>
COLUMNS_NAME = re.compile(r"transform_columnsILi(\d+)E")

def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def peaks(name):
    for key, val in PEAKS.items():
        if key in name:
            return val
    return PEAKS["H100"]


def time_ms(fn, reps):
    """Median CUDA-event time of `reps` warm calls (ms)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(got, want, rtol, atol_scale):
    """Max abs error, and the worst error over its allowance
    (atol_scale * max|want| + rtol * |want|): passes when <= 1."""
    got, want = got.double(), want.double()
    atol = atol_scale * float(want.abs().max()) + 1e-30
    err = (got - want).abs()
    return float(err.max()), float((err / (atol + rtol * want.abs())).max())


def ptxas_usage(log):
    """{mangled kernel: {"registers", "spill_stores"}} from nvcc's ptxas -v
    report."""
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )"
                      r"([\w$]+)", line)
        if m:
            fn = m.group(1)
            usage.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            usage[fn]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn]["registers"] = int(m.group(1))
    return usage


def sass_counts(_build, name, opcodes):
    """{mangled kernel: {opcode: number of its instructions}} in the SASS of
    the built library of csrc/<name>.cu (cuobjdump)."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(_build._lib_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn is not None:
            for op in opcodes:
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    return counts


def sass_check(_build, kernels):
    """Which instantiations of fused_iteration's two passes run on tensor
    cores: HMMA instructions in the SASS of the built library (cuobjdump)
    for int8/bf16 X and none for float32/int16, and no spill stores on the
    tensor-core path (ptxas -v).  For fused_transform's register path, one
    instantiation per bucket with no spill stores, and at least K² FFMA in
    the K = 40 bucket (its step's sums, each a FFMA of its own); the counts
    of shared loads, shuffles and MUFU (the division's reciprocal) beside
    them give the instruction mix of a step."""
    usage = ptxas_usage(_build.build_log("fused_iteration"))
    rows = []
    for fn, count in sorted(sass_counts(_build, "fused_iteration", ("HMMA",)).items()):
        m = PASS_NAME.search(fn)
        if m:
            kernel, x, bf16, counts = m.groups()
            u = usage.get(fn, {})
            rows.append({"kernel": kernel, "x": X_CODES.get(x, x),
                         "counts": counts == "1", "tensor_core_path": bf16 == "1",
                         "hmma": count["HMMA"], "registers": u.get("registers"),
                         "spill_stores": u.get("spill_stores")})
    usage = ptxas_usage(_build.build_log("fused_transform"))
    trows = []
    ops = ("FFMA", "LDS", "SHFL", "MUFU")
    for fn, count in sorted(sass_counts(_build, "fused_transform", ops).items()):
        m = COLUMNS_NAME.search(fn)
        u = usage.get(fn, {})
        trows.append({"kernel": "transform_columns" if m else "transform_tiles",
                      "bucket": int(m.group(1)) if m else None,
                      **{op.lower(): count[op] for op in ops},
                      "registers": u.get("registers"),
                      "spill_stores": u.get("spill_stores")})
    emit({"phase": "sass", "functions": rows, "fused_transform": trows})
    check(len(rows) == 16, f"expected 16 pass instantiations, found {len(rows)}")
    for r in rows:
        tag = f"{r['kernel']} {r['x']} counts={r['counts']}"
        check((r["hmma"] > 0) == r["tensor_core_path"],
              f"{tag}: HMMA count {r['hmma']} does not fit its path")
        if r["tensor_core_path"]:
            check(r["spill_stores"] == 0, f"{tag}: spill stores {r['spill_stores']}")
    xrows = []
    usage = ptxas_usage(_build.build_log("x_passes"))
    for fn, count in sorted(sass_counts(_build, "x_passes", ("HMMA",)).items()):
        m = re.search(r"(hxt_mma|hxt_fma|wtx_mma|wtx_fma)I(\w+?)E", fn)
        if m:
            u = usage.get(fn, {})
            xrows.append({"kernel": m.group(1), "x": X_CODES.get(m.group(2), m.group(2)),
                          "hmma": count["HMMA"], "registers": u.get("registers"),
                          "spill_stores": u.get("spill_stores")})
    emit({"phase": "sass", "x_passes": xrows})
    check(len(xrows) == 8, f"expected 8 x_passes kernels, found {len(xrows)}")
    for r in xrows:
        check((r["hmma"] > 0) == r["kernel"].endswith("_mma"),
              f"x_passes {r['kernel']} {r['x']}: HMMA count {r['hmma']}")
    buckets = sorted(r["bucket"] for r in trows if r["bucket"])
    check(buckets == sorted(kernels._TRANSFORM_BUCKETS),
          f"fused_transform buckets {buckets} differ from the wrapper's")
    for r in trows:
        if r["bucket"]:
            check(r["spill_stores"] == 0,
                  f"transform_columns<{r['bucket']}>: spill stores {r['spill_stores']}")
        if r["bucket"] == 40:
            check(r["ffma"] >= 40 * 40, f"transform_columns<40>: {r['ffma']} FFMA")


def iteration_problem(torch, gen, dev, g, n, blocks, n_labels, xdtype):
    K = sum(blocks)
    rate = torch.full((g, n), 1.5, device=dev)
    X = torch.poisson(rate, generator=gen).clamp_(max=127)
    X = (X if xdtype in (torch.int8, torch.int16)
         else X + torch.rand((g, n), generator=gen, device=dev)).to(xdtype)
    del rate
    W = torch.rand((g, K), generator=gen, device=dev) + 0.05
    H = torch.rand((K, n), generator=gen, device=dev) + 0.05
    Ys, Bs = [], []
    for c, nl in enumerate(n_labels):
        lab = torch.randint(0, nl, (n,), generator=gen, device=dev)
        Ys.append(torch.nn.functional.one_hot(lab, nl).T.contiguous().to(xdtype))
        Bs.append(torch.rand((nl, blocks[c]), generator=gen, device=dev) + 0.05)
    lam = torch.full((len(n_labels),), 1e3, device=dev)
    return X, W, H, W.T @ W, Ys, Bs, lam


def iteration_cost(g, n, blocks, n_labels, xbytes, bf16, counts=False):
    """(bytes, bf16 flop, fp32 flop) one fused iteration must move/do; the
    counts mode also reads the (2, n) f32 counts and forms HHtU (K x K)."""
    K, L, Kg = sum(blocks), sum(n_labels), sum(blocks[:-1])
    nbytes = (xbytes * g * n + xbytes * L * n + 4 * 2 * K * n + 4 * 2 * g * K
              + 4 * K * K * 2 + 4 * L * Kg)
    x_ops = 4.0 * g * n * K
    f32_ops = 4.0 * K * K * n + (8.0 * L * Kg + 2.0 * L * K) * n + 12.0 * K * n
    if counts:
        nbytes += 4 * 2 * n + 4 * K * K
        f32_ops += 2.0 * K * K * n
    return nbytes, (x_ops if bf16 else 0.0), f32_ops + (0.0 if bf16 else x_ops)


def bound(nbytes, bf16_ops, f32_ops, card):
    bw, p16, p32 = card
    t_bytes = nbytes / bw * 1e3
    t_ops = (bf16_ops / p16 + f32_ops / p32) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from alpine_tpu_torch import ALPINE, AnnData, probe
    from alpine_tpu_torch.ops import _build, kernels, mu
    from alpine_tpu_torch.utils.sampling import (
        balanced_group_tables, joint_label_ids)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: true fp32
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit({"phase": "device", "kind": name, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    card = peaks(name)

    t0 = time.perf_counter()
    build_s = _build.build_all()
    for src, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "properties" in line:
                print(f"ptxas {src}: {line.strip()}", file=sys.stderr)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": build_s})
    sass_check(_build, kernels)

    results = {}
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- kernels against their plain versions ------------------------------
    def group_tables(Ys):
        """The balanced sampler's (start, sizes) over the joint labels of Ys."""
        _, start, sizes = balanced_group_tables(
            joint_label_ids([y.cpu().numpy() for y in Ys]))
        return torch.from_numpy(start).to(dev), torch.from_numpy(sizes).to(dev)

    def sampler_counts(Ys, n):
        """Two epochs of the port's balanced sampler (this draw, the next),
        as fused_iteration's (2, n) counts."""
        tables = group_tables(Ys)
        return torch.stack([mu.grouped_balanced_counts(gen, n, tables)
                            for _ in range(2)])

    def run_iteration_case(tag, g, n, blocks, n_labels, xdtype, loss_kl, timed,
                           counts=None):
        X, W, H, WtW, Ys, Bs, lam = iteration_problem(
            torch, gen, dev, g, n, blocks, n_labels, xdtype)
        C = None if counts is None else counts(Ys, n)
        if n_labels:
            kern = lambda: kernels.fused_iteration(
                X, W, H, WtW, Ys, Bs, lam, EPS, C, blocks=blocks,
                loss_kl=loss_kl)
            plain = lambda: kernels.fused_iteration_plain(
                X, W, H, WtW, Ys, Bs, lam, EPS, C, blocks=blocks,
                loss_kl=loss_kl)
        else:
            kern = lambda: kernels.fused_h_update(X, W, H, WtW, EPS)
            plain = lambda: kernels.fused_h_update_plain(X, W, H, WtW, EPS)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        flat = lambda o: [t for v in o for t in (v if isinstance(v, tuple) else (v,))]
        errs = [compare(a, b, 1e-4, 1e-6) for a, b in zip(flat(got), flat(want))]
        worst = max(e[1] for e in errs)
        row = {"phase": "kernel", "case": tag, "max_abs_err_Hn": errs[0][0],
               "worst_err_over_tolerance": worst,
               "tolerance": "rtol 1e-4, atol 1e-6*max|plain| per output"}
        if C is not None:
            undrawn = C[0] == 0
            row["counts"] = {"undrawn": int(undrawn.sum()),
                             "max": float(C.max()), "sum_row0": float(C[0].sum())}
            row["undrawn_columns_bit_equal"] = bool(
                torch.equal(got[0][:, undrawn], H[:, undrawn]))
        if timed:
            row["ms"] = time_ms(kern, 5)
            row["plain_ms"] = time_ms(plain, 3)
            xb = torch.empty((), dtype=xdtype).element_size()
            bf16 = xdtype in (torch.int8, torch.bfloat16)
            cost = iteration_cost(g, n, blocks, n_labels, xb, bf16,
                                  counts=C is not None)
            row["bytes"], row["bf16_flop"], row["fp32_flop"] = cost
            row["bound_ms"], row["bound_by"] = bound(*cost, card)
        if timed and n_labels and C is None:
            # yardstick, used nowhere in the port: the two X products alone
            # as bf16 cuBLAS calls over a bf16 copy of X
            Xb, Wb, Hb = X.to(torch.bfloat16), W.bfloat16(), H.bfloat16()
            row["x_products_cublas_bf16_ms"] = time_ms(
                lambda: (Wb.T @ Xb, Hb @ Xb.T), 5)
            del Xb
        emit(row)
        check(worst <= 1.0, f"{tag}: kernel disagrees with its plain version")
        if C is not None:
            check(row["undrawn_columns_bit_equal"] and row["counts"]["undrawn"] > 0,
                  f"{tag}: undrawn columns must keep H bit for bit")
        return row

    results["fused_iteration"] = run_iteration_case(
        "fused_iteration bench int8 kl", G, N, BLOCKS, N_LABELS, torch.int8,
        True, True)
    # small cases: 300 genes (not a multiple of either gene chunk) and 5000
    # or 5003 cells (not a multiple of any tile or of the cell chunk); K not
    # a multiple of 16 on the tensor-core path (int8, bf16), and K = 300 and
    # 512, where that path takes 16-cell tiles and float32 8-cell ones
    edge_cases = [
        (torch.int8, (7, 14), (3,), True),
        (torch.bfloat16, (5, 5, 30), (2, 3), False),
        (torch.bfloat16, (150, 150), (3,), False),
        (torch.int8, (200, 312), (4,), True),
        (torch.float32, (200, 312), (4,), True)]
    for xdt, blocks, labels, kl in [
            (torch.float32, (3, 4, 6), (2, 3), False),
            (torch.bfloat16, (3, 9), (2,), True),
            (torch.int16, (2, 3, 4, 5), (2, 5, 3), False),
            (torch.float32, (1, 1), (1,), True),
            (torch.int8, (2, 1), (17,), True)] + edge_cases:
        run_iteration_case(f"fused_iteration small {str(xdt)[6:]} "
                           f"{blocks}/{labels} {'kl' if kl else 'frob'}",
                           300, 5000, blocks, labels, xdt, kl, False)
    results["fused_iteration_counts"] = run_iteration_case(
        "fused_iteration counts bench int8 kl", G, N, BLOCKS, N_LABELS,
        torch.int8, True, True, counts=sampler_counts)
    mixed_counts = lambda Ys, n: torch.randint(
        0, 4, (2, n), generator=gen, device=dev).float()  # 0, 1 and above 1
    for xdt, blocks, labels, kl in [
            (torch.float32, (3, 4, 6), (2, 3), False),
            (torch.bfloat16, (3, 9), (2,), True),
            (torch.int16, (2, 3, 4, 5), (2, 5, 3), False),
            (torch.float32, (1, 1), (1,), True),
            (torch.int8, (2, 1), (17,), True),
            (torch.int8, (5, 5, 30), (2, 3), False)] + edge_cases:
        run_iteration_case(f"fused_iteration counts small {str(xdt)[6:]} "
                           f"{blocks}/{labels} {'kl' if kl else 'frob'}",
                           300, 5003, blocks, labels, xdt, kl, False,
                           counts=mixed_counts)
    # 5040 cells: a multiple of 16, so the tensor-core path stages X, W and
    # Hn in 16-byte loads (5000 and 5003 take its element-by-element
    # staging), but not of the 64-cell tile or chunk
    for xdt, blocks, labels, kl in edge_cases[:4]:
        for C in (None, mixed_counts):
            run_iteration_case(f"fused_iteration {'counts ' if C else ''}small "
                               f"{str(xdt)[6:]} {blocks}/{labels} "
                               f"{'kl' if kl else 'frob'} n=5040",
                               300, 5040, blocks, labels, xdt, kl, False, counts=C)
    results["fused_h_update"] = run_iteration_case(
        "fused_h_update bench int8", G, N, (sum(BLOCKS),), (), torch.int8,
        True, True)
    run_iteration_case("fused_h_update small float32", 300, 5001, (13,), (),
                       torch.float32, True, False)
    run_iteration_case("fused_h_update small int8", 300, 5001, (21,), (),
                       torch.int8, True, False)

    def run_transform_case(K):
        """fused_transform at 100k cells and K components against its plain
        version, timed, with the path the rule by K takes."""
        Wt = torch.rand((G, K), generator=gen, device=dev)
        Xt = torch.poisson(torch.full((G, N), 1.5, device=dev), generator=gen)
        num2 = 2.0 * (Wt.T @ Xt)
        del Xt
        WtW2 = 2.0 * (Wt.T @ Wt)
        H0 = torch.rand((K, N), generator=gen, device=dev) + 0.05
        kern = lambda: kernels.fused_transform(num2, H0, WtW2, EPS,
                                               n_iter=TRANSFORM_ITERS)
        plain = lambda: kernels.fused_transform_plain(num2, H0, WtW2, EPS,
                                                      n_iter=TRANSFORM_ITERS)
        abs_err, worst = compare(kern(), plain(), 2e-4, 1e-6)
        bucket = kernels.transform_bucket(K)
        path = (f"registers, bucket {bucket}" if bucket
                else f"tiled, {kernels.tile_width(K)} cells a tile")
        t_bytes = 3 * 4 * K * N + 4 * K * K
        t_ops = TRANSFORM_ITERS * (2.0 * K * K + 3.0 * K) * N
        bms, bby = bound(t_bytes, 0.0, t_ops, card)
        row = {"phase": "kernel",
               "case": f"fused_transform K={K} n_iter={TRANSFORM_ITERS}",
               "path": path, "max_abs_err_Hn": abs_err,
               "worst_err_over_tolerance": worst,
               "tolerance": "rtol 2e-4, atol 1e-6*max|plain|",
               "ms": time_ms(kern, 5), "plain_ms": time_ms(plain, 3),
               # loads and stores alone: what the steps' time sits on
               "ms_n_iter_0": time_ms(lambda: kernels.fused_transform(
                   num2, H0, WtW2, EPS, n_iter=0), 5),
               "bytes": t_bytes, "bf16_flop": 0.0, "fp32_flop": t_ops,
               "bound_ms": bms, "bound_by": bby}
        emit(row)
        check(worst <= 1.0, f"fused_transform at K={K} disagrees with its plain version")
        return row

    results["fused_transform"] = run_transform_case(sum(BLOCKS))
    run_transform_case(300)
    torch.cuda.empty_cache()

    # -- ALS's X passes: hxt (P1) and wtx (P2) -------------------------------
    def x_pass_problem(g, n, K, xdtype):
        X = torch.poisson(torch.full((g, n), 1.5, device=dev), generator=gen)
        X = X.clamp_(max=127)
        if xdtype not in (torch.int8, torch.int16):
            X += torch.rand((g, n), generator=gen, device=dev)
        X = X.to(xdtype)
        H = torch.rand((K, n), generator=gen, device=dev) + 0.05
        W = torch.rand((g, K), generator=gen, device=dev) + 0.05
        return X, W, H

    def run_x_pass_case(kind, X, P, timed):
        """hxt(X, H = P) or wtx(X, W = P) against its plain version; timed
        at the bench shape beside one torch.matmul over a copy of X cast to
        its compute dtype outside the timed region (bf16 for int8/bf16 X)."""
        g, n = X.shape
        K = P.shape[0] if kind == "hxt" else P.shape[1]
        kern = lambda: getattr(kernels, kind)(X, P)
        plain = lambda: getattr(kernels, f"{kind}_plain")(X, P)
        abs_err, worst = compare(kern(), plain(), 1e-4, 1e-6)
        tag = f"{kind} {'bench' if timed else 'small'} {str(X.dtype)[6:]} K={K} n={n}"
        row = {"phase": "kernel", "case": tag, "max_abs_err": abs_err,
               "worst_err_over_tolerance": worst,
               "tolerance": "rtol 1e-4, atol 1e-6*max|plain|"}
        if timed:
            row["ms"] = time_ms(kern, 5)
            row["plain_ms"] = time_ms(plain, 3)
            bf16 = X.dtype in (torch.int8, torch.bfloat16)
            cdt = torch.bfloat16 if bf16 else torch.float32
            Xc, Pc = X.to(cdt), mu.round_partner(P, X.dtype).to(cdt)
            lib = ((lambda: torch.matmul(Pc, Xc.T)) if kind == "hxt"
                   else (lambda: torch.matmul(Pc.T, Xc)))
            row["library_ms"] = time_ms(lib, 5)
            row["library"] = f"torch.matmul, {str(cdt)[6:]} operands"
            del Xc, Pc
            side = 4 * K * n if kind == "hxt" else 4 * g * K  # H or W
            out = 4 * K * g if kind == "hxt" else 4 * K * n
            row["bytes"] = X.element_size() * g * n + side + out
            ops = 2.0 * K * g * n
            row["bf16_flop"], row["fp32_flop"] = (ops, 0.0) if bf16 else (0.0, ops)
            row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["bf16_flop"],
                                                     row["fp32_flop"], card)
        emit(row)
        check(worst <= 1.0, f"{tag}: kernel disagrees with its plain version")
        return row

    X, W, H = x_pass_problem(G, N, sum(BLOCKS), torch.int8)
    results["hxt"] = run_x_pass_case("hxt", X, H, True)
    run_x_pass_case("wtx", X, W[:, :5].contiguous(), True)
    results["wtx"] = run_x_pass_case("wtx", X, W[:, 10:].contiguous(), True)
    del X, W, H  # the int8 X goes before the float32 one is made
    torch.cuda.empty_cache()
    X, W, H = x_pass_problem(G, N, sum(BLOCKS), torch.float32)
    run_x_pass_case("hxt", X, H, True)
    run_x_pass_case("wtx", X, W[:, 10:].contiguous(), True)
    del X, W, H
    torch.cuda.empty_cache()
    for xdt in (torch.int8, torch.bfloat16, torch.float32, torch.int16):
        for K, n in ((1, 1001), (13, 1001), (300, 1001), (40, 5040)):
            X, W, H = x_pass_problem(300, n, K, xdt)
            run_x_pass_case("hxt", X, H, False)
            run_x_pass_case("wtx", X, W, False)

    # -- the streaming probe's entry point (P3) -------------------------------
    kernels.reset_launches()
    rates = probe.streaming_GBps(("int8", "float32"))
    torch.cuda.synchronize()
    probe_launches = kernels.launches["stream_probe"]
    check(probe_launches > 0, "the streaming probe must launch stream_probe")
    for xname, rate in rates.items():
        X = probe.stream_input(xname)
        fold, colsum = kernels.stream_probe(X)
        want_fold, want_colsum = kernels.stream_probe_plain(X)
        exact = bool(torch.equal(fold, want_fold) and torch.equal(colsum, want_colsum))
        g, n = X.shape
        nbytes = X.element_size() * g * n + 4 * n + 4 * 8 * 128
        bms, bby = bound(nbytes, 0.0, float(g) * n, card)
        row = {"phase": "stream_probe", "x_dtype": xname, "shape": [g, n],
               "tile": rate["tile"], "reps": rate["reps"], "ms": rate["ms"],
               "GBps_read": rate["GBps"], "bytes_read": rate["bytes_read"],
               "fold_and_colsum_exact": exact,
               "max_abs_err": float((fold - want_fold).abs().max()),
               "plain_ms": time_ms(lambda: kernels.stream_probe_plain(X), 3),
               "library_ms": time_ms(lambda: torch.sum(X, dim=0, dtype=torch.float32), 5),
               "library": "torch.sum(X, dim=0, dtype=float32)",
               "bytes": nbytes, "bound_ms": bms, "bound_by": bby,
               "launches": probe_launches}
        emit(row)
        check(exact, f"stream_probe {xname}: fold or column sums differ from the plain version")
        results.setdefault("stream_probe", row)
        del X

    # -- where the fit's device time goes: the fused fit loop alone ----------
    X, W, H, _, Ys, Bs, lam = iteration_problem(
        torch, gen, dev, G, N, BLOCKS, N_LABELS, torch.int8)
    hyper = (lam, 0.0, 0.0, 0.0, EPS)
    tables = group_tables(Ys)
    loop_gen = torch.Generator(device=dev)

    def draw_counts(t):
        loop_gen.manual_seed(t)
        return mu.grouped_balanced_counts(loop_gen, N, tables)

    for phase, weighted, als, iters in (
            ("fit_loop", False, False, LOOP_ITERS),
            ("fit_loop_weighted_fast", True, False, LOOP_ITERS),
            ("fit_loop_als", False, True, ALS_LOOP_ITERS)):
        cfg = mu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=N,
                          max_iter=iters, x_dtype="int8",
                          weighted_counts=weighted, use_als=als)
        drive = lambda: mu.fit_scan(cfg, W, H, Bs, X, Ys, hyper,
                                    draw_counts=draw_counts)
        drive()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drive()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            drive()
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        events.sort(key=lambda e: -e.self_device_time_total)
        busy_us = sum(e.self_device_time_total for e in events)
        emit({"phase": phase, "iterations": iters,
              "ms_per_iteration": wall * 1e3 / iters,
              # kernel time over wall time, both of the traced run
              "device_busy_share": busy_us * 1e-6 / traced_wall,
              "device_ms_per_iteration": busy_us * 1e-3 / iters,
              "top_device_kernels_ms_per_iteration": [
                  [e.key[:60], e.self_device_time_total * 1e-3 / iters]
                  for e in events[:10]]})
    del X, W, H, Ys, Bs, tables
    torch.cuda.empty_cache()

    # -- a small fit on the card against the same fit on the CPU ------------
    r = np.random.default_rng(1)
    Xs = (r.gamma(2.0, 1.0, (400, 6)) @ r.gamma(2.0, 1.0, (6, 60))
          + r.random((400, 60))).astype(np.float32)
    obs_s = {"batch": np.array([f"b{i % 2}" for i in range(400)], dtype=object)}
    for phase, als in (("small", False), ("small_als", True)):
        fits = {}
        for where in ("cuda", "cpu"):
            ad = AnnData(Xs, obs=obs_s)
            m = ALPINE(n_components=6, n_covariate_components=[2], lam=[10.0],
                       device=where, random_state=7, use_als=als)
            m.fit(ad, ["batch"], max_iter=20)
            m.transform(ad)
            fits[where] = (m.loss_history_, ad.obsm["ALPINE_embedding"])
        floor = 2e-6 * float(np.sum(np.square(Xs.astype(np.float64))))
        loss_gap = float(np.max(np.abs(fits["cuda"][0] - fits["cpu"][0])
                                - 5e-4 * np.abs(fits["cpu"][0]) - floor))
        emb_ok = np.allclose(fits["cuda"][1], fits["cpu"][1], rtol=5e-3, atol=1e-5)
        emit({"phase": phase, "loss_excess_over_tolerance": loss_gap,
              "embedding_allclose": bool(emb_ok),
              "tolerance": "loss rtol 5e-4 + 2e-6*|X|^2, embedding rtol 5e-3 atol 1e-5"})
        check(loss_gap <= 0 and emb_ok, f"{phase}: card fit disagrees with the CPU fit")

    # -- the slice at full width ---------------------------------------------
    r = np.random.default_rng(0)
    t0 = time.perf_counter()
    rates = (r.gamma(2.0, 0.5, (N, 8)) @ r.gamma(2.0, 0.25, (8, G))).astype(np.float32)
    counts = np.minimum(r.poisson(rates), 127).astype(np.float32)
    del rates
    obs = {"batch": np.array(["b0", "b1"], dtype=object)[r.integers(0, 2, N)],
           "condition": np.array(["c0", "c1", "c2"], dtype=object)[r.integers(0, 3, N)]}
    adata = AnnData(counts, obs=obs)
    data_s = time.perf_counter() - t0

    model = ALPINE(n_components=30, n_covariate_components=[5, 5],
                   lam=[1e3, 1e3], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    model.fit(adata, ["batch", "condition"], max_iter=FIT_ITERS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(model._x_cache is not None, "the fit must keep its device X")
    t0 = time.perf_counter()
    model.transform(adata)  # through the fit's device X
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    main_launches = dict(kernels.launches)
    L = model.loss_history_
    emit({"phase": "slice", "cells": N, "genes": G, "data_seconds": data_s,
          "fit_seconds": fit_s, "fit_iterations": FIT_ITERS,
          "seconds_per_iteration_incl_setup": fit_s / FIT_ITERS,
          "timings": model.timings_, "transform_seconds_cached": transform_s,
          "transform_iterations": model.max_iter, "data_dtype": model.data_dtype_,
          "launches": main_launches, "loss_first": L[0].tolist(),
          "loss_last": L[-1].tolist(),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    model.free_device_cache()
    check(model.data_dtype_ == "int8", "auto must resolve to int8")
    check(main_launches["fused_iteration"] == FIT_ITERS,
          "fused_iteration must launch once per fit iteration")
    check(main_launches["fused_transform"] == 1, "transform must launch fused_transform")
    check(np.isfinite(L).all(), "loss history must be finite")
    check(L[-1, 0] < L[0, 0], "total loss must fall")
    check(adata.obsm["ALPINE_embedding"].shape == (N, 30), "embedding shape")
    for key in ("batch", "condition"):
        check(adata.obsm[key].shape == (N, 5), f"{key} block shape")
        check(np.isfinite(adata.obsm[key]).all(), f"{key} block finite")
    check(np.isfinite(adata.obsm["ALPINE_embedding"]).all(), "embedding finite")

    # -- the unguided path (no covariates): fused_h_update -------------------
    unguided = ALPINE(n_components=40, n_covariate_components=[], lam=[],
                      device="cuda")
    kernels.reset_launches()
    t0 = time.perf_counter()
    unguided.fit(adata, [], max_iter=10)
    torch.cuda.synchronize()
    unguided_s = time.perf_counter() - t0
    unguided_launches = dict(kernels.launches)
    Lu = unguided.loss_history_
    emit({"phase": "slice_unguided", "fit_seconds": unguided_s,
          "fit_iterations": 10, "launches": unguided_launches,
          "loss_first": Lu[0].tolist(), "loss_last": Lu[-1].tolist()})
    check(unguided_launches["fused_h_update"] == 10,
          "fused_h_update must launch once per unguided fit iteration")
    check(np.isfinite(Lu).all() and Lu[-1, 0] < Lu[0, 0], "unguided loss")
    unguided.free_device_cache()
    del model, unguided
    torch.cuda.empty_cache()

    # -- weighted_fast: balanced sampling as per-cell counts (K4) -------------
    wf = ALPINE(n_components=30, n_covariate_components=[5, 5],
                lam=[1e3, 1e3], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    wf.fit(adata, ["batch", "condition"], max_iter=FIT_ITERS,
           sampling_method="weighted_fast")
    torch.cuda.synchronize()
    wf_fit_s = time.perf_counter() - t0
    check(wf._x_cache is not None and wf._x_cache[3] is not None,
          "the weighted_fast fit must keep its group-sorted device X")
    t0 = time.perf_counter()
    wf.transform(adata)  # through the group-sorted device X
    torch.cuda.synchronize()
    cached_s = time.perf_counter() - t0
    emb_cached = {k: adata.obsm[k].copy()
                  for k in ("ALPINE_embedding", "batch", "condition")}
    wf.free_device_cache()
    t0 = time.perf_counter()
    wf.transform(adata)  # uploads X again
    torch.cuda.synchronize()
    uncached_s = time.perf_counter() - t0
    wf_launches = dict(kernels.launches)
    Lw = wf.loss_history_
    cache_ok = all(np.allclose(emb_cached[k], adata.obsm[k], rtol=1e-5)
                   for k in emb_cached)
    emit({"phase": "slice_weighted_fast", "fit_seconds": wf_fit_s,
          "fit_iterations": FIT_ITERS, "timings": wf.timings_,
          "transform_seconds_cached": cached_s,
          "transform_seconds_uncached": uncached_s,
          "cached_matches_uncached": bool(cache_ok),
          "launches": wf_launches, "loss_first": Lw[0].tolist(),
          "loss_last": Lw[-1].tolist(),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    check(wf_launches["fused_iteration_counts"] == FIT_ITERS,
          "fused_iteration's counts mode must launch once per fit iteration")
    check(wf_launches["fused_iteration"] == 0,
          "a weighted_fast fit must not launch the plain fused_iteration")
    check(wf_launches["fused_transform"] >= 1, "transform must launch fused_transform")
    check(np.isfinite(Lw).all(), "weighted_fast loss history must be finite")
    check(Lw[-1, 0] < Lw[0, 0], "weighted_fast total loss must fall")
    check(adata.obsm["ALPINE_embedding"].shape == (N, 30), "embedding shape")
    for key in ("batch", "condition"):
        check(adata.obsm[key].shape == (N, 5), f"{key} block shape")
    check(all(np.isfinite(v).all() for v in emb_cached.values()),
          "weighted_fast embeddings finite")
    check(cache_ok, "cached and uncached transforms must agree (rtol 1e-5)")
    wf.free_device_cache()
    del wf
    torch.cuda.empty_cache()

    # -- ALS mode: hxt once and wtx once a block each iteration ---------------
    als = ALPINE(n_components=30, n_covariate_components=[5, 5],
                 lam=[1e3, 1e3], use_als=True, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    als.fit(adata, ["batch", "condition"], max_iter=FIT_ITERS)
    torch.cuda.synchronize()
    als_fit_s = time.perf_counter() - t0
    check(als._x_cache is not None, "the ALS fit must keep its device X")
    t0 = time.perf_counter()
    als.transform(adata)  # through the fit's device X
    torch.cuda.synchronize()
    als_transform_s = time.perf_counter() - t0
    als_launches = dict(kernels.launches)
    La = als.loss_history_
    emit({"phase": "slice_als", "fit_seconds": als_fit_s,
          "fit_iterations": FIT_ITERS, "timings": als.timings_,
          "transform_seconds_cached": als_transform_s,
          "launches": als_launches, "loss_first": La[0].tolist(),
          "loss_last": La[-1].tolist(),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    check(als_launches["hxt"] == FIT_ITERS, "hxt must launch once per ALS iteration")
    check(als_launches["wtx"] == 3 * FIT_ITERS,
          "wtx must launch once per block per ALS iteration")
    check(als_launches["fused_iteration"] == 0, "an ALS fit must not launch fused_iteration")
    check(als_launches["fused_transform"] == 1, "transform must launch fused_transform")
    check(np.isfinite(La).all(), "ALS loss history must be finite")
    check(La[-1, 0] < La[0, 0], "ALS total loss must fall")
    check(adata.obsm["ALPINE_embedding"].shape == (N, 30), "embedding shape")
    for key in ("batch", "condition"):
        check(adata.obsm[key].shape == (N, 5), f"{key} block shape")
        check(np.isfinite(adata.obsm[key]).all(), f"{key} block finite")
    check(np.isfinite(adata.obsm["ALPINE_embedding"]).all(), "embedding finite")
    als.free_device_cache()

    launches = {"fused_iteration": main_launches["fused_iteration"],
                "fused_iteration_counts": wf_launches["fused_iteration_counts"],
                "fused_transform": main_launches["fused_transform"],
                "fused_h_update": unguided_launches["fused_h_update"],
                "hxt": als_launches["hxt"], "wtx": als_launches["wtx"],
                "stream_probe": probe_launches}
    rows = []
    for kname in ("fused_iteration", "fused_iteration_counts", "fused_h_update",
                  "fused_transform", "hxt", "wtx", "stream_probe"):
        res = results[kname]
        rows.append({"name": kname, "route": "cuda", "source": SOURCES[kname],
                     "replaces": REPLACES[kname], "launches": launches[kname],
                     "max_abs_err": res.get("max_abs_err_Hn", res.get("max_abs_err")),
                     "ms": res["ms"], "plain_ms": res["plain_ms"],
                     "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                     "library_ms": res.get("library_ms")})
    emit({"kernels": rows})

    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

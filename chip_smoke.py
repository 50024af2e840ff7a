#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (alpine_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printing one JSON line:
  device  the card's name, count and power limit (nvidia-smi);
  build   nvcc builds every kernel of alpine_tpu_torch/csrc for sm_90a;
  kernel  each kernel against its plain PyTorch version on the card, at the
          bench shape (100k cells x 2,000 genes, K = 40, labels (2, 3), int8)
          and at small shapes over the other storage types, blocks and
          losses, with its time beside the plain version's and its bound;
  fit_loop  the fused fit loop alone on device-resident bench data: ms
          per iteration, device busy share and device time per kernel (profiler);
  small   a small fit on the card against the same fit on the CPU (plain
          kernel versions, same seed);
  slice   ALPINE(n_components=30, n_covariate_components=[5, 5]).fit(...,
          max_iter=50) and .transform() on 100k x 2,000 Poisson counts
          (int8), with the launch counts read around it, then an unguided
          fit (no covariates) for fused_h_update's path.
Then one JSON line with every kernel's numbers and, last, the result line.
Any failed check raises: the script exits non-zero and prints no result.
Without a GPU it exits with code 2 before doing anything.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

G, N = 2000, 100_000
BLOCKS, N_LABELS = (5, 5, 30), (2, 3)
TRANSFORM_ITERS = 50
FIT_ITERS = 50
LOOP_ITERS = 10
EPS = 1e-6
# published dense peaks (NVIDIA data sheets): bytes/s, bf16 flop/s, fp32
# flop/s outside the tensor cores
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 51e12),
         "H100 NVL": (3.9e12, 835e12, 60e12),
         "H100": (3.35e12, 989e12, 67e12)}
REPLACES = {
    "fused_iteration": "alpine_tpu/ops/pallas_kernels.py:637",
    "fused_h_update": "alpine_tpu/ops/pallas_kernels.py:361",
    "fused_transform": "alpine_tpu/ops/pallas_kernels.py:806",
}
SOURCES = {
    "fused_iteration": "alpine_tpu_torch/csrc/fused_iteration.cu",
    "fused_h_update": "alpine_tpu_torch/csrc/fused_iteration.cu",
    "fused_transform": "alpine_tpu_torch/csrc/fused_transform.cu",
}

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


def iteration_cost(g, n, blocks, n_labels, xbytes, bf16):
    """(bytes, bf16 flop, fp32 flop) one fused iteration must move/do."""
    K, L, Kg = sum(blocks), sum(n_labels), sum(blocks[:-1])
    nbytes = (xbytes * g * n + xbytes * L * n + 4 * 2 * K * n + 4 * 2 * g * K
              + 4 * K * K * 2 + 4 * L * Kg)
    x_ops = 4.0 * g * n * K
    f32_ops = 4.0 * K * K * n + (8.0 * L * Kg + 2.0 * L * K) * n + 12.0 * K * n
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

    from alpine_tpu_torch import ALPINE, AnnData
    from alpine_tpu_torch.ops import _build, kernels, mu

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
            if "registers" in line or "spill" in line:
                print(f"ptxas {src}: {line.strip()}", file=sys.stderr)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": build_s})

    results = {}
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- kernels against their plain versions ------------------------------
    def run_iteration_case(tag, g, n, blocks, n_labels, xdtype, loss_kl, timed):
        X, W, H, WtW, Ys, Bs, lam = iteration_problem(
            torch, gen, dev, g, n, blocks, n_labels, xdtype)
        if n_labels:
            kern = lambda: kernels.fused_iteration(
                X, W, H, WtW, Ys, Bs, lam, EPS, blocks=blocks, loss_kl=loss_kl)
            plain = lambda: kernels.fused_iteration_plain(
                X, W, H, WtW, Ys, Bs, lam, EPS, blocks=blocks, loss_kl=loss_kl)
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
        if timed:
            row["ms"] = time_ms(kern, 5)
            row["plain_ms"] = time_ms(plain, 3)
            xb = torch.empty((), dtype=xdtype).element_size()
            bf16 = xdtype in (torch.int8, torch.bfloat16)
            cost = iteration_cost(g, n, blocks, n_labels, xb, bf16)
            row["bytes"], row["bf16_flop"], row["fp32_flop"] = cost
            row["bound_ms"], row["bound_by"] = bound(*cost, card)
        emit(row)
        check(worst <= 1.0, f"{tag}: kernel disagrees with its plain version")
        return row

    results["fused_iteration"] = run_iteration_case(
        "fused_iteration bench int8 kl", G, N, BLOCKS, N_LABELS, torch.int8,
        True, True)
    for xdt, blocks, labels, kl in [
            (torch.float32, (3, 4, 6), (2, 3), False),
            (torch.bfloat16, (3, 9), (2,), True),
            (torch.int16, (2, 3, 4, 5), (2, 5, 3), False),
            (torch.float32, (1, 1), (1,), True),
            (torch.int8, (2, 1), (17,), True)]:
        run_iteration_case(f"fused_iteration small {str(xdt)[6:]} "
                           f"{blocks}/{labels} {'kl' if kl else 'frob'}",
                           300, 5000, blocks, labels, xdt, kl, False)
    results["fused_h_update"] = run_iteration_case(
        "fused_h_update bench int8", G, N, (sum(BLOCKS),), (), torch.int8,
        True, True)
    run_iteration_case("fused_h_update small float32", 300, 5001, (13,), (),
                       torch.float32, True, False)

    K = sum(BLOCKS)
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
    t_bytes = 3 * 4 * K * N + 4 * K * K
    t_ops = TRANSFORM_ITERS * (2.0 * K * K + 3.0 * K) * N
    bms, bby = bound(t_bytes, 0.0, t_ops, card)
    row = {"phase": "kernel", "case": f"fused_transform bench n_iter={TRANSFORM_ITERS}",
           "max_abs_err_Hn": abs_err, "worst_err_over_tolerance": worst,
           "tolerance": "rtol 2e-4, atol 1e-6*max|plain|",
           "ms": time_ms(kern, 5), "plain_ms": time_ms(plain, 3),
           "bytes": t_bytes, "bf16_flop": 0.0, "fp32_flop": t_ops,
           "bound_ms": bms, "bound_by": bby}
    emit(row)
    check(worst <= 1.0, "fused_transform disagrees with its plain version")
    results["fused_transform"] = row
    del num2, WtW2, H0, Wt
    torch.cuda.empty_cache()

    # -- where the fit's device time goes: the fused fit loop alone ----------
    X, W, H, _, Ys, Bs, lam = iteration_problem(
        torch, gen, dev, G, N, BLOCKS, N_LABELS, torch.int8)
    cfg = mu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=N,
                      max_iter=LOOP_ITERS, x_dtype="int8")
    hyper = (lam, 0.0, 0.0, 0.0, EPS)
    drive = lambda: mu.fit_scan(cfg, W, H, Bs, X, Ys, hyper)
    drive()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in events)
    emit({"phase": "fit_loop", "iterations": LOOP_ITERS,
          "ms_per_iteration": wall * 1e3 / LOOP_ITERS,
          # kernel time over wall time, both of the traced run
          "device_busy_share": busy_us * 1e-6 / traced_wall,
          "device_ms_per_iteration": busy_us * 1e-3 / LOOP_ITERS,
          "top_device_kernels_ms_per_iteration": [
              [e.key[:60], e.self_device_time_total * 1e-3 / LOOP_ITERS]
              for e in events[:8]]})
    del X, W, H, Ys, Bs
    torch.cuda.empty_cache()

    # -- a small fit on the card against the same fit on the CPU ------------
    r = np.random.default_rng(1)
    Xs = (r.gamma(2.0, 1.0, (400, 6)) @ r.gamma(2.0, 1.0, (6, 60))
          + r.random((400, 60))).astype(np.float32)
    obs_s = {"batch": np.array([f"b{i % 2}" for i in range(400)], dtype=object)}
    fits = {}
    for where in ("cuda", "cpu"):
        ad = AnnData(Xs, obs=obs_s)
        m = ALPINE(n_components=6, n_covariate_components=[2], lam=[10.0],
                   device=where, random_state=7)
        m.fit(ad, ["batch"], max_iter=20)
        m.transform(ad)
        fits[where] = (m.loss_history_, ad.obsm["ALPINE_embedding"])
    floor = 2e-6 * float(np.sum(np.square(Xs.astype(np.float64))))
    loss_gap = float(np.max(np.abs(fits["cuda"][0] - fits["cpu"][0])
                            - 5e-4 * np.abs(fits["cpu"][0]) - floor))
    emb_ok = np.allclose(fits["cuda"][1], fits["cpu"][1], rtol=5e-3, atol=1e-5)
    emit({"phase": "small", "loss_excess_over_tolerance": loss_gap,
          "embedding_allclose": bool(emb_ok),
          "tolerance": "loss rtol 5e-4 + 2e-6*|X|^2, embedding rtol 5e-3 atol 1e-5"})
    check(loss_gap <= 0 and emb_ok, "card fit disagrees with the CPU fit")

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
    kernels.reset_launches()
    t0 = time.perf_counter()
    model.fit(adata, ["batch", "condition"], max_iter=FIT_ITERS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.transform(adata)
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    main_launches = dict(kernels.launches)
    L = model.loss_history_
    emit({"phase": "slice", "cells": N, "genes": G, "data_seconds": data_s,
          "fit_seconds": fit_s, "fit_iterations": FIT_ITERS,
          "seconds_per_iteration_incl_setup": fit_s / FIT_ITERS,
          "timings": model.timings_, "transform_seconds": transform_s,
          "transform_iterations": model.max_iter, "data_dtype": model.data_dtype_,
          "launches": main_launches, "loss_first": L[0].tolist(),
          "loss_last": L[-1].tolist(),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
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

    launches = {"fused_iteration": main_launches["fused_iteration"],
                "fused_transform": main_launches["fused_transform"],
                "fused_h_update": unguided_launches["fused_h_update"]}
    rows = []
    for kname in ("fused_iteration", "fused_h_update", "fused_transform"):
        res = results[kname]
        rows.append({"name": kname, "route": "cuda", "source": SOURCES[kname],
                     "replaces": REPLACES[kname], "launches": launches[kname],
                     "max_abs_err": res["max_abs_err_Hn"], "ms": res["ms"],
                     "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"], "library_ms": None})
    emit({"kernels": rows})

    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

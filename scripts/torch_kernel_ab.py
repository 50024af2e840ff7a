#!/usr/bin/env python3
"""Time the port's kernels and fit loops of two checkouts on one GPU, in turns.

    python3 scripts/torch_kernel_ab.py PARENT_DIR CHANGE_DIR

Each checkout runs in a process of its own, in the order parent, change,
change, parent, and builds its kernels from its own ``alpine_tpu_torch/csrc``.
A run times, at the bench shape (100k cells x 2,000 genes, K = 40, labels
(2, 3), int8 X, KL loss) on inputs made from one seed:

- ``fused_iteration`` (K1), ``fused_h_update`` (K2) and ``fused_iteration``
  with a fixed (2, n) counts tensor drawn from the seed (K4): median
  CUDA-event ms of 20 warm launches, on the int8 X and again on its fp32
  path: on float32 X (``fused_iteration_float32_ms``, ...) and on int16 X
  holding the counts times 3 (``..._int16_ms``);
- the full-batch and the weighted_fast fused fit loops (``mu.fit_scan``,
  the latter with the port's balanced sampler): ms per iteration over 10
  iterations, host clock around work that ends in a synchronize, the
  median of three runs;
- ``fused_transform`` (K3), 50 steps at the bench shape (num2 = 2WᵀX,
  WtW2 = 2WᵀW, H0 = H): median CUDA-event ms of 20 warm launches, and over
  20 launches in a row (``fused_transform_back_to_back_ms``: the host's
  time per call hidden); at K = 100 and K = 300 (the tiled path;
  ``fused_transform_k100_ms``, ``fused_transform_k300_ms``), 5 warm
  launches each;
- ALS's X passes: P1 ``hxt`` (K = 40) and P2 ``wtx`` (k = 5 and 30) on the
  int8 X, and on float32 X (the counts plus a uniform fraction) and int16
  X (the counts times 3: above 127), median CUDA-event ms of 20 warm
  launches (each also over 20 launches in a row: ``hxt_back_to_back_ms``,
  ``wtx_k5_back_to_back_ms``, ``..._float32_...``, ``..._int16_...``), and
  the ALS fit loop (``mu.fit_scan`` with ``use_als``) on the int8 and on
  the int16 X, ms per iteration over 20 iterations, the median of three
  runs, and its device ms per iteration (torch.profiler, one more run);
  the full-batch loop on the int16 and on the float32 X
  (``fit_loop_int16_...``, ``fit_loop_float32_...``: K1's fp32 path), ms
  and device ms per iteration over 10 iterations, likewise;
- a digest of every output of K1, K4 and K2 with the same inputs held as
  float32 and as int16 X (the fp32 path) and as int8 and bf16 X (the
  tensor-core path), of K3's output at the bench shape, K = 100 and 300, of
  ``hxt`` and ``wtx`` (k = 5 and 30) on float32 and int16 X, and of ``hxt``
  and ``wtx`` on int8 and bf16 X (the tensor-core path), and of K3's
  per-step path at K = 768 (``k3_bits["K768"]``); the fp32-path
  outputs of K1/K4/K2 and the X passes' outputs are also saved beside
  their plain versions';
- K = 768 (the large-K routes; blocks (192, 192, 384)) on the int8 X: P1
  ``hxt``, P2 ``wtx``, K1, K4 and K2, median CUDA-event ms of 10 warm
  launches (``hxt_k768_ms``, ...) and of one bf16 ``torch.matmul`` that
  computes P1's or P2's product over bf16 copies made outside the timed
  region (``hxt_k768_library_ms``, ``wtx_k768_library_ms``), a digest of
  their outputs
  (``wide_bf16_bits``) and their worst error over the plain versions'
  tolerance (``wide_k768_worst_err_over_tolerance``: rtol 1e-4 + 1e-6
  max|plain|; XHt against the plain product over the kernel's own Hs);
  the summary says for each of them whether all four runs agree bit for
  bit (``wide_bits_equal_by_kernel``); K3's per-step path at K = 768, 50
  steps, median CUDA-event ms of 3 warm launches
  (``fused_transform_k768_ms``) beside 50 fp32 ``torch.matmul(WtW2, H)``
  with TF32 off (``fused_transform_k768_library_ms``); on float32 X (the
  counts plus a uniform fraction) and int16 X (the counts times 3) P1, P2
  and K1 at K = 768 (``hxt_k768_float32_ms``, ...), median CUDA-event ms of
  5 warm launches, beside fp32 ``torch.matmul`` of P1's and P2's products
  with TF32 off (``hxt_k768_float32_library_ms``, ...), and their worst
  error over the plain versions' tolerance
  (``fp32_wide_k768_worst_err_over_tolerance``).

Prints one JSON line per run, then one summary line with the mean of each
checkout's two runs, whether all four runs agree bit for bit on the
float32/int16 outputs of K1/K2/K4 (``fp32_path_bits_equal``), on their
int8/bf16 outputs (``k1_bf16_path_bits_equal``), on K3's
(``k3_bits_equal``), on ``hxt``'s float32/int16 outputs
(``x_pass_fp32_bits_equal``) and int8/bf16 ones
(``x_pass_bf16_path_bits_equal``), on ``wtx``'s (``wtx_fp32_bits_equal``)
and on ``wtx``'s tensor-core path (``wtx_bf16_path_bits_equal``), and on
the K = 768 outputs (``wide_bf16_path_bits_equal``; whether each
checkout's two runs agree: ``wide_bf16_path_runs_repeat``); for
``fp32_path``, ``x_pass_fp32``, ``wtx_fp32`` and ``wtx_bf16_path``, whether
each checkout's two runs agree (``..._runs_repeat``)
and the largest difference between the two checkouts' outputs, absolute
and over the plain version's tolerance (rtol 1e-4 + 1e-6 max|plain|: at
most 1 when both trees hold it; ``..._max_abs_diff``,
``..._diff_over_tolerance``), for a change that alters a kernel's
summation order; and the card's name and power limit.  Needs one NVIDIA
GPU; exits non-zero without one.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

G, N = 2000, 100_000
BLOCKS, N_LABELS = (5, 5, 30), (2, 3)
EPS = 1e-6
REPS = 20
TRANSFORM_ITERS = 50
LOOP_ITERS = 10
ALS_LOOP_ITERS = 20
LOOP_REPEATS = 3  # timed runs of each loop; their median is reported


def child(root, save_path):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from alpine_tpu_torch.ops import kernels, mu
    from alpine_tpu_torch.utils.sampling import balanced_group_tables, joint_label_ids

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    K = sum(BLOCKS)
    X = torch.poisson(torch.full((G, N), 1.5, device=dev),
                      generator=gen).clamp_(max=127).to(torch.int8)
    W = torch.rand((G, K), generator=gen, device=dev) + 0.05
    H = torch.rand((K, N), generator=gen, device=dev) + 0.05
    Ys, Bs = [], []
    for c, nl in enumerate(N_LABELS):
        lab = torch.randint(0, nl, (N,), generator=gen, device=dev)
        Ys.append(torch.nn.functional.one_hot(lab, nl).T.contiguous().to(torch.int8))
        Bs.append(torch.rand((nl, BLOCKS[c]), generator=gen, device=dev) + 0.05)
    lam = torch.full((len(N_LABELS),), 1e3, device=dev)
    WtW = W.T @ W

    def time_ms(fn, reps=REPS):
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

    def back_to_back_ms(fn, calls=20):
        """CUDA-event ms a call over `calls` calls in a row, which hides the
        host's own time per call where it is shorter than the card's."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    C = torch.randint(0, 4, (2, N), generator=gen, device=dev).float()
    k1_k4_k2 = lambda X, Ys: (
        kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS, blocks=BLOCKS,
                                loss_kl=True),
        kernels.fused_iteration(X, W, H, WtW, Ys, Bs, lam, EPS, C,
                                blocks=BLOCKS, loss_kl=True),
        kernels.fused_h_update(X, W, H, WtW, EPS))

    def digest(outs):
        h = hashlib.sha256()
        for out in outs:
            for v in out:
                for t in (v if isinstance(v, tuple) else (v,)):
                    h.update(t.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    bits, k1_bf16_bits, saved = {}, {}, {}
    for dt in (torch.float32, torch.int16, torch.int8, torch.bfloat16):
        name = str(dt)[6:]
        Xd, Yd = X.to(dt), [y.to(dt) for y in Ys]
        outs = k1_k4_k2(Xd, Yd)
        if dt in (torch.int8, torch.bfloat16):
            k1_bf16_bits[name] = digest(outs)
        else:
            bits[name] = digest(outs)
            plains = (
                kernels.fused_iteration_plain(Xd, W, H, WtW, Yd, Bs, lam, EPS,
                                              blocks=BLOCKS, loss_kl=True),
                kernels.fused_iteration_plain(Xd, W, H, WtW, Yd, Bs, lam, EPS, C,
                                              blocks=BLOCKS, loss_kl=True),
                kernels.fused_h_update_plain(Xd, W, H, WtW, EPS))
            flat = lambda o: [t for v in o for t in (v if isinstance(v, tuple) else (v,))]
            for m, (out, plain) in enumerate(zip(outs, plains)):
                for i, (a, b) in enumerate(zip(flat(out), flat(plain))):
                    saved[f"fp32_path/{name}_{m}_{i}"] = a.cpu()
                    saved[f"fp32_path/{name}_{m}_{i}_plain"] = b.cpu()
        del Xd, Yd, outs
        torch.cuda.empty_cache()

    def k3(W, H0):
        """K3 on 2WᵀX and 2WᵀW, as the transform calls it."""
        num2, WtW2 = 2.0 * (W.T @ X.float()), 2.0 * (W.T @ W)
        return lambda: kernels.fused_transform(num2, H0, WtW2, EPS,
                                               n_iter=TRANSFORM_ITERS)

    k3_bench = k3(W, H)
    k3_bits, k3_tiled_ms = {"K40": digest([[k3_bench()]])}, {}
    for K in (100, 300):
        k3_tiled = k3(torch.rand((G, K), generator=gen, device=dev),
                      torch.rand((K, N), generator=gen, device=dev) + 0.05)
        k3_bits[f"K{K}"] = digest([[k3_tiled()]])
        k3_tiled_ms[f"fused_transform_k{K}_ms"] = time_ms(k3_tiled, reps=5)
        del k3_tiled
    torch.cuda.empty_cache()
    W5, W30 = W[:, :5].contiguous(), W[:, 10:].contiguous()
    x_pass_bits, wtx_fp32_bits, wtx_bf16_bits, hxt_bf16_bits = {}, {}, {}, {}
    x_pass_ms = {}
    for dt in (torch.float32, torch.int16, torch.bfloat16, torch.int8):
        name = str(dt)[6:]
        Xd = ((X + torch.rand(X.shape, generator=gen, device=dev)) if dt == torch.float32
              else X.to(dt) * 3 if dt == torch.int16 else X).to(dt)
        outs = [kernels.wtx(Xd, W5), kernels.wtx(Xd, W30)]
        group = "wtx_bf16" if dt in (torch.bfloat16, torch.int8) else "wtx_fp32"
        (wtx_bf16_bits if group == "wtx_bf16" else wtx_fp32_bits)[name] = digest([outs])
        if group == "wtx_bf16":
            hxt_bf16_bits[name] = digest([[kernels.hxt(Xd, H)]])
        for k, Wk, out in ((5, W5, outs[0]), (30, W30, outs[1])):
            saved[f"{group}/{name}_k{k}"] = out.cpu()
            saved[f"{group}/{name}_k{k}_plain"] = kernels.wtx_plain(Xd, Wk).cpu()
        if group == "wtx_fp32":
            out = kernels.hxt(Xd, H)
            x_pass_bits[name] = digest([[out]])
            saved[f"x_pass_fp32/{name}"] = out.cpu()
            saved[f"x_pass_fp32/{name}_plain"] = kernels.hxt_plain(Xd, H).cpu()
            for tag, fn in (("hxt", lambda: kernels.hxt(Xd, H)),
                            ("wtx_k5", lambda: kernels.wtx(Xd, W5)),
                            ("wtx_k30", lambda: kernels.wtx(Xd, W30))):
                x_pass_ms[f"{tag}_{name}_ms"] = time_ms(fn)
                x_pass_ms[f"{tag}_{name}_back_to_back_ms"] = back_to_back_ms(fn)
        del Xd, outs
        torch.cuda.empty_cache()
    torch.save(saved, save_path)
    del saved
    torch.cuda.empty_cache()
    hxt_ms = time_ms(lambda: kernels.hxt(X, H))
    hxt_b2b_ms = back_to_back_ms(lambda: kernels.hxt(X, H))
    wtx5_ms = time_ms(lambda: kernels.wtx(X, W5))
    wtx5_b2b_ms = back_to_back_ms(lambda: kernels.wtx(X, W5))
    wtx30_ms = time_ms(lambda: kernels.wtx(X, W30))
    wtx30_b2b_ms = back_to_back_ms(lambda: kernels.wtx(X, W30))
    k1 = time_ms(lambda: kernels.fused_iteration(
        X, W, H, WtW, Ys, Bs, lam, EPS, blocks=BLOCKS, loss_kl=True))
    k2 = time_ms(lambda: kernels.fused_h_update(X, W, H, WtW, EPS))
    k4 = time_ms(lambda: kernels.fused_iteration(
        X, W, H, WtW, Ys, Bs, lam, EPS, C, blocks=BLOCKS, loss_kl=True))
    k3_ms = time_ms(k3_bench)
    k3_b2b_ms = back_to_back_ms(k3_bench)
    fp32_k_ms = {}  # K1/K4/K2 on the fp32 path
    for dt in (torch.float32, torch.int16):
        name = str(dt)[6:]
        Xd = ((X + torch.rand(X.shape, generator=gen, device=dev)) if dt == torch.float32
              else X.to(dt) * 3).to(dt)
        Yd = [y.to(dt) for y in Ys]
        fp32_k_ms[f"fused_iteration_{name}_ms"] = time_ms(lambda: kernels.fused_iteration(
            Xd, W, H, WtW, Yd, Bs, lam, EPS, blocks=BLOCKS, loss_kl=True))
        fp32_k_ms[f"fused_iteration_counts_{name}_ms"] = time_ms(
            lambda: kernels.fused_iteration(Xd, W, H, WtW, Yd, Bs, lam, EPS, C,
                                            blocks=BLOCKS, loss_kl=True))
        fp32_k_ms[f"fused_h_update_{name}_ms"] = time_ms(
            lambda: kernels.fused_h_update(Xd, W, H, WtW, EPS))
        del Xd, Yd
        torch.cuda.empty_cache()
    hyper = (lam, 0.0, 0.0, 0.0, EPS)
    _, start, sizes = balanced_group_tables(joint_label_ids([y.cpu().numpy() for y in Ys]))
    tables = (torch.from_numpy(start).to(dev), torch.from_numpy(sizes).to(dev))
    loop_gen = torch.Generator(device=dev)

    def draw_counts(t):
        loop_gen.manual_seed(t)
        return mu.grouped_balanced_counts(loop_gen, N, tables)

    def loop_ms(weighted, als=False, Xl=X, Yl=Ys, device=False):
        """Host ms an iteration (median of LOOP_REPEATS runs) and, with
        ``device``, the device ms an iteration of one more run (profiler)."""
        iters = ALS_LOOP_ITERS if als else LOOP_ITERS
        cfg = mu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=N,
                          max_iter=iters, x_dtype=str(Xl.dtype)[6:],
                          weighted_counts=weighted, use_als=als)
        run = lambda: mu.fit_scan(cfg, W, H, Bs, Xl, Yl, hyper, draw_counts=draw_counts)
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(LOOP_REPEATS):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / iters)
        if not device:
            return float(np.median(times))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        return float(np.median(times)), busy_us * 1e-3 / iters

    als_loops = {}
    X16, Ys16 = X.to(torch.int16) * 3, [y.to(torch.int16) for y in Ys]
    for tag, Xl, Yl in (("", X, Ys), ("_int16", X16, Ys16)):
        host, dev_ms = loop_ms(False, als=True, Xl=Xl, Yl=Yl, device=True)
        als_loops[f"fit_loop_als{tag}_ms_per_iteration"] = host
        als_loops[f"fit_loop_als{tag}_device_ms_per_iteration"] = dev_ms
    host, dev_ms = loop_ms(False, Xl=X16, Yl=Ys16, device=True)
    als_loops["fit_loop_int16_ms_per_iteration"] = host
    als_loops["fit_loop_int16_device_ms_per_iteration"] = dev_ms
    del X16, Ys16
    X32 = X.float() + torch.rand(X.shape, generator=gen, device=dev)
    host, dev_ms = loop_ms(False, Xl=X32, Yl=[y.float() for y in Ys], device=True)
    als_loops["fit_loop_float32_ms_per_iteration"] = host
    als_loops["fit_loop_float32_device_ms_per_iteration"] = dev_ms
    del X32
    torch.cuda.empty_cache()
    # K = 768 on the int8 X: the large-K routes of P1, P2, K1, K4 and K2
    KW, BW = 768, (192, 192, 384)
    Ww = torch.rand((G, KW), generator=gen, device=dev) + 0.05
    Hw = torch.rand((KW, N), generator=gen, device=dev) + 0.05
    WtWw = Ww.T @ Ww
    Bw = [torch.rand((nl, BW[c]), generator=gen, device=dev) + 0.05
          for c, nl in enumerate(N_LABELS)]
    wide = {
        "hxt": (lambda: kernels.hxt(X, Hw), lambda: kernels.hxt_plain(X, Hw), None),
        "wtx": (lambda: kernels.wtx(X, Ww), lambda: kernels.wtx_plain(X, Ww), None),
        "fused_iteration": (
            lambda: kernels.fused_iteration(X, Ww, Hw, WtWw, Ys, Bw, lam, EPS, blocks=BW,
                                            loss_kl=True),
            lambda: kernels.fused_iteration_plain(X, Ww, Hw, WtWw, Ys, Bw, lam, EPS,
                                                  blocks=BW, loss_kl=True), None),
        "fused_iteration_counts": (
            lambda: kernels.fused_iteration(X, Ww, Hw, WtWw, Ys, Bw, lam, EPS, C, blocks=BW,
                                            loss_kl=True),
            lambda: kernels.fused_iteration_plain(X, Ww, Hw, WtWw, Ys, Bw, lam, EPS, C,
                                                  blocks=BW, loss_kl=True), C[1]),
        "fused_h_update": (lambda: kernels.fused_h_update(X, Ww, Hw, WtWw, EPS),
                           lambda: kernels.fused_h_update_plain(X, Ww, Hw, WtWw, EPS),
                           None)}
    flat = lambda o: [t for v in (o if isinstance(o, tuple) else (o,))
                      for t in (v if isinstance(v, tuple) else (v,))]
    wide_ms, wide_bits, wide_worst = {}, {}, 0.0
    for name, (fn, plain, scale) in wide.items():
        got, want = flat(fn()), flat(plain())
        if len(got) > 1:  # XHt against the plain product over the kernel's own Hs
            want[1] = kernels.hxt_plain(X, got[0] if scale is None else got[0] * scale).T
        for a, b in zip(got, want):
            allowed = 1e-6 * float(b.abs().max()) + 1e-4 * b.abs()
            wide_worst = max(wide_worst, float(((a - b).abs() / allowed).max()))
        wide_bits[name] = digest([got])
        del got, want
        wide_ms[f"{name}_k768_ms"] = time_ms(fn, reps=10)
    Xb, Hb, Wb = X.to(torch.bfloat16), Hw.bfloat16(), Ww.bfloat16()
    wide_ms["hxt_k768_library_ms"] = time_ms(lambda: torch.matmul(Hb, Xb.T), reps=10)
    wide_ms["wtx_k768_library_ms"] = time_ms(lambda: torch.matmul(Wb.T, Xb), reps=10)
    del Xb, Hb, Wb
    k3w = k3(Ww, Hw)  # the per-step path (wtw_gemm's update a step)
    k3_bits["K768"] = digest([[k3w()]])
    wide_ms["fused_transform_k768_ms"] = time_ms(k3w, reps=3)
    num2w, WtW2w = 2.0 * (Ww.T @ X.float()), 2.0 * (Ww.T @ Ww)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    wide_ms["fused_transform_k768_library_ms"] = time_ms(
        lambda: [torch.matmul(WtW2w, Hw) for _ in range(TRANSFORM_ITERS)], reps=3)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    del k3w, num2w, WtW2w
    # K = 768 on float32 and int16 X (counts x 3): P1, P2 and K1 on the fp32
    # large-K passes, beside fp32 torch.matmul (TF32 off) of P1's and P2's
    # products; their bits follow the passes' design, so only the times and
    # the worst error over the plain versions' tolerance are kept
    fp32_wide_worst = 0.0
    torch.backends.cuda.matmul.allow_tf32 = False
    for xname, Xw in (("float32", X.float() + torch.rand(X.shape, generator=gen, device=dev)),
                      ("int16", X.to(torch.int16) * 3)):
        Yw = [y.to(Xw.dtype) for y in Ys]
        fp32_wide = {
            "hxt": (lambda: kernels.hxt(Xw, Hw), lambda: kernels.hxt_plain(Xw, Hw)),
            "wtx": (lambda: kernels.wtx(Xw, Ww), lambda: kernels.wtx_plain(Xw, Ww)),
            "fused_iteration": (
                lambda: kernels.fused_iteration(Xw, Ww, Hw, WtWw, Yw, Bw, lam, EPS, blocks=BW,
                                                loss_kl=True),
                lambda: kernels.fused_iteration_plain(Xw, Ww, Hw, WtWw, Yw, Bw, lam, EPS,
                                                      blocks=BW, loss_kl=True))}
        for name, (fn, plain) in fp32_wide.items():
            for a, b in zip(flat(fn()), flat(plain())):
                allowed = 1e-6 * float(b.abs().max()) + 1e-4 * b.abs()
                fp32_wide_worst = max(fp32_wide_worst, float(((a - b).abs() / allowed).max()))
            wide_ms[f"{name}_k768_{xname}_ms"] = time_ms(fn, reps=5)
        Xf = Xw.float()
        wide_ms[f"hxt_k768_{xname}_library_ms"] = time_ms(lambda: torch.matmul(Hw, Xf.T), reps=5)
        wide_ms[f"wtx_k768_{xname}_library_ms"] = time_ms(lambda: torch.matmul(Ww.T, Xf), reps=5)
        del Xw, Xf, Yw, fp32_wide
    torch.backends.cuda.matmul.allow_tf32 = tf32
    wide_ms["fp32_wide_k768_worst_err_over_tolerance"] = fp32_wide_worst
    del Ww, Hw, WtWw, Bw, wide
    torch.cuda.empty_cache()
    print(json.dumps({"root": root, "fused_iteration_ms": k1,
                      "fused_h_update_ms": k2,
                      "fused_iteration_counts_ms": k4,
                      "fused_transform_ms": k3_ms,
                      "fused_transform_back_to_back_ms": k3_b2b_ms, **k3_tiled_ms,
                      "hxt_ms": hxt_ms, "hxt_back_to_back_ms": hxt_b2b_ms,
                      "wtx_k5_ms": wtx5_ms, "wtx_k5_back_to_back_ms": wtx5_b2b_ms,
                      "wtx_k30_ms": wtx30_ms, "wtx_k30_back_to_back_ms": wtx30_b2b_ms,
                      "fit_loop_ms_per_iteration": loop_ms(False),
                      "fit_loop_weighted_fast_ms_per_iteration": loop_ms(True),
                      **fp32_k_ms, **x_pass_ms, **als_loops, **wide_ms,
                      "wide_k768_worst_err_over_tolerance": wide_worst,
                      "fp32_path_bits": bits, "k1_bf16_path_bits": k1_bf16_bits,
                      "k3_bits": k3_bits,
                      "x_pass_fp32_bits": x_pass_bits, "x_pass_bf16_bits": hxt_bf16_bits,
                      "wtx_fp32_bits": wtx_fp32_bits,
                      "wtx_bf16_bits": wtx_bf16_bits,
                      "wide_bf16_bits": wide_bits}), flush=True)


def path_difference(parent_path, change_path, group):
    """The largest difference between two trees' saved outputs of one group
    (``fp32_path``, ``wtx_bf16``, ``wtx_fp32``, ``x_pass_fp32``): (max abs,
    max over the plain version's tolerance)."""
    import torch

    a, b = torch.load(parent_path), torch.load(change_path)
    worst_abs = worst_tol = 0.0
    for key in a:
        if not key.startswith(f"{group}/") or key.endswith("_plain"):
            continue
        plain = a[f"{key}_plain"].double()
        diff = (a[key].double() - b[key].double()).abs()
        allowed = 1e-6 * float(plain.abs().max()) + 1e-4 * plain.abs()
        worst_abs = max(worst_abs, float(diff.max()))
        worst_tol = max(worst_tol, float((diff / allowed).max()))
    return worst_abs, worst_tol


def main(argv):
    if len(argv) == 4 and argv[1] == "--child":
        child(argv[2], argv[3])
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = argv[1], argv[2]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    runs = {parent: [], change: []}
    tmp = tempfile.TemporaryDirectory()
    saves = {parent: [], change: []}
    for i, root in enumerate((parent, change, change, parent)):
        save = os.path.join(tmp.name, f"run{i}.pt")
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root, save], capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[root].append(json.loads(line))
        saves[root].append(save)
    summary = {"card": smi.splitlines()[0], "order": "parent, change, change, parent"}
    digests = (("fp32_path_bits", "fp32_path_bits_equal"),
               ("k1_bf16_path_bits", "k1_bf16_path_bits_equal"),
               ("k3_bits", "k3_bits_equal"),
               ("x_pass_fp32_bits", "x_pass_fp32_bits_equal"),
               ("x_pass_bf16_bits", "x_pass_bf16_path_bits_equal"),
               ("wtx_fp32_bits", "wtx_fp32_bits_equal"),
               ("wtx_bf16_bits", "wtx_bf16_path_bits_equal"),
               ("wide_bf16_bits", "wide_bf16_path_bits_equal"))
    for label, root in (("parent", parent), ("change", change)):
        summary[label] = {k: sum(r[k] for r in runs[root]) / 2
                          for k in runs[root][0]
                          if k != "root" and k not in dict(digests)}
    for key, out in digests:
        seen = {json.dumps(r.get(key), sort_keys=True)
                for rs in runs.values() for r in rs}
        summary[out] = len(seen) == 1
    summary["wide_bf16_path_runs_repeat"] = all(
        rs[0].get("wide_bf16_bits") == rs[1].get("wide_bf16_bits") for rs in runs.values())
    summary["wide_bits_equal_by_kernel"] = {
        name: len({r["wide_bf16_bits"].get(name) for rs in runs.values() for r in rs}) == 1
        for name in runs[change][0]["wide_bf16_bits"]}
    for key, group, out in (("fp32_path_bits", "fp32_path", "fp32_path"),
                            ("wtx_bf16_bits", "wtx_bf16", "wtx_bf16_path"),
                            ("wtx_fp32_bits", "wtx_fp32", "wtx_fp32"),
                            ("x_pass_fp32_bits", "x_pass_fp32", "x_pass_fp32")):
        summary[f"{out}_runs_repeat"] = all(
            rs[0].get(key) == rs[1].get(key) for rs in runs.values())
        summary[f"{out}_max_abs_diff"], summary[f"{out}_diff_over_tolerance"] = (
            path_difference(saves[parent][0], saves[change][0], group))
    tmp.cleanup()
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

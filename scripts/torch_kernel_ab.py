#!/usr/bin/env python3
"""Time the port's fused-iteration kernels of two checkouts on one GPU, in turns.

    python3 scripts/torch_kernel_ab.py PARENT_DIR CHANGE_DIR

Each checkout runs in a process of its own, in the order parent, change,
change, parent, and builds its kernels from its own ``alpine_tpu_torch/csrc``.
A run times, at the bench shape (100k cells x 2,000 genes, K = 40, labels
(2, 3), int8 X, KL loss) on inputs made from one seed:

- ``fused_iteration`` (K1), ``fused_h_update`` (K2) and ``fused_iteration``
  with a fixed (2, n) counts tensor drawn from the seed (K4): median
  CUDA-event ms of 20 warm launches;
- the full-batch and the weighted_fast fused fit loops (``mu.fit_scan``,
  the latter with the port's balanced sampler): ms per iteration over 10
  iterations, host clock around work that ends in a synchronize;
- ``fused_transform`` (K3), 50 steps at the bench shape (num2 = 2WᵀX,
  WtW2 = 2WᵀW, H0 = H): median CUDA-event ms of 20 warm launches;
- a digest of every output of K1, K4 and K2 with the same inputs held as
  float32 and as int16 X (the fp32 FMA path), and of K3's output at the
  bench shape and at K = 300, so the summary can say whether the two
  checkouts give those paths the same bits.

Prints one JSON line per run, then one summary line with the mean of each
checkout's two runs, whether all four runs agree bit for bit on the
float32/int16 outputs (``fp32_path_bits_equal``) and on K3's
(``k3_bits_equal``), and the card's name and power limit.  Needs one
NVIDIA GPU; exits non-zero without one.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

G, N = 2000, 100_000
BLOCKS, N_LABELS = (5, 5, 30), (2, 3)
EPS = 1e-6
REPS = 20
TRANSFORM_ITERS = 50
LOOP_ITERS = 10


def child(root):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

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

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

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

    bits = {str(dt)[6:]: digest(k1_k4_k2(X.to(dt), [y.to(dt) for y in Ys]))
            for dt in (torch.float32, torch.int16)}
    torch.cuda.empty_cache()

    def k3(W, H0):
        """K3 on 2WᵀX and 2WᵀW, as the transform calls it."""
        num2, WtW2 = 2.0 * (W.T @ X.float()), 2.0 * (W.T @ W)
        return lambda: kernels.fused_transform(num2, H0, WtW2, EPS,
                                               n_iter=TRANSFORM_ITERS)

    k3_bench = k3(W, H)
    k3_300 = k3(torch.rand((G, 300), generator=gen, device=dev),
                torch.rand((300, N), generator=gen, device=dev) + 0.05)
    k3_bits = {"K40": digest([[k3_bench()]]), "K300": digest([[k3_300()]])}
    del k3_300
    torch.cuda.empty_cache()
    k1 = time_ms(lambda: kernels.fused_iteration(
        X, W, H, WtW, Ys, Bs, lam, EPS, blocks=BLOCKS, loss_kl=True))
    k2 = time_ms(lambda: kernels.fused_h_update(X, W, H, WtW, EPS))
    k4 = time_ms(lambda: kernels.fused_iteration(
        X, W, H, WtW, Ys, Bs, lam, EPS, C, blocks=BLOCKS, loss_kl=True))
    k3_ms = time_ms(k3_bench)
    hyper = (lam, 0.0, 0.0, 0.0, EPS)
    _, start, sizes = balanced_group_tables(joint_label_ids([y.cpu().numpy() for y in Ys]))
    tables = (torch.from_numpy(start).to(dev), torch.from_numpy(sizes).to(dev))
    loop_gen = torch.Generator(device=dev)

    def draw_counts(t):
        loop_gen.manual_seed(t)
        return mu.grouped_balanced_counts(loop_gen, N, tables)

    def loop_ms(weighted):
        cfg = mu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=N,
                          max_iter=LOOP_ITERS, x_dtype="int8",
                          weighted_counts=weighted)
        run = lambda: mu.fit_scan(cfg, W, H, Bs, X, Ys, hyper, draw_counts=draw_counts)
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / LOOP_ITERS

    print(json.dumps({"root": root, "fused_iteration_ms": k1,
                      "fused_h_update_ms": k2,
                      "fused_iteration_counts_ms": k4,
                      "fused_transform_ms": k3_ms,
                      "fit_loop_ms_per_iteration": loop_ms(False),
                      "fit_loop_weighted_fast_ms_per_iteration": loop_ms(True),
                      "fp32_path_bits": bits, "k3_bits": k3_bits}), flush=True)


def main(argv):
    if len(argv) == 3 and argv[1] == "--child":
        child(argv[2])
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = argv[1], argv[2]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    runs = {parent: [], change: []}
    for root in (parent, change, change, parent):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root], capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[root].append(json.loads(line))
    summary = {"card": smi.splitlines()[0], "order": "parent, change, change, parent"}
    for label, root in (("parent", parent), ("change", change)):
        summary[label] = {k: sum(r[k] for r in runs[root]) / 2
                          for k in runs[root][0]
                          if k not in ("root", "fp32_path_bits", "k3_bits")}
    for key, out in (("fp32_path_bits", "fp32_path_bits_equal"),
                     ("k3_bits", "k3_bits_equal")):
        digests = {json.dumps(r[key], sort_keys=True)
                   for rs in runs.values() for r in rs}
        summary[out] = len(digests) == 1
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

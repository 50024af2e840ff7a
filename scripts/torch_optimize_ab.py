#!/usr/bin/env python3
"""Time ComponentOptimizer's search of two checkouts on one GPU, in turns.

    python3 scripts/torch_optimize_ab.py PARENT_DIR CHANGE_DIR

Each checkout runs in a process of its own, in the order parent, change,
change, parent, and builds its kernels from its own ``alpine_tpu_torch/csrc``.
A run makes ``chip_smoke.py``'s bench data (100k cells x 2,000 genes,
Poisson counts of a rank-8 gamma rate from seed 0, covariates "batch" and
"condition") and calls that checkout's ``chip_smoke.run_optimize_phase``:
the default search (4 trials of 3 folds, 50 iterations a fold fit, K1 on
int8 X), one trial again through the sequential route, and
``fit_the_best_param``.  It prints that phase's JSON line; the summary line
gives, for each checkout's two runs, the seconds of each trial's fold fits
(``fits``), of the whole search and of the refit, and the card's name and
power limit.  Needs one NVIDIA GPU; exits non-zero without one.
"""

import json
import os
import subprocess
import sys

G, N = 2000, 100_000


def child(root):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import chip_smoke
    from alpine_tpu_torch import AnnData
    from alpine_tpu_torch.ops import _build, kernels

    _build.build_all()
    r = np.random.default_rng(0)
    rates = (r.gamma(2.0, 0.5, (N, 8)) @ r.gamma(2.0, 0.25, (8, G))).astype(np.float32)
    counts = np.minimum(r.poisson(rates), 127).astype(np.float32)
    del rates
    obs = {"batch": np.array(["b0", "b1"], dtype=object)[r.integers(0, 2, N)],
           "condition": np.array(["c0", "c1", "c2"], dtype=object)[r.integers(0, 3, N)]}
    adata = AnnData(counts, obs=obs)
    skip = lambda *args, **kw: None  # the phase's kernel rows: not timed here
    chip_smoke.run_optimize_phase(torch, kernels, adata,
                                  {"iteration": skip, "transform": skip, "x_pass": skip,
                                   "grid_x_pass": skip})


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
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        line = next(ln for ln in out.stdout.splitlines()
                    if ln.startswith("{") and '"phase": "slice_optimize"' in ln)
        print(line, flush=True)
        row = json.loads(line)
        runs[root].append({"fits": [t["fits"] for t in row["trials"]],
                           "search_seconds": row["search_seconds"],
                           "fit_the_best_param_seconds": row["fit_the_best_param_seconds"]})
    print(json.dumps({"card": smi.splitlines()[0], "order": "parent, change, change, parent",
                      "parent": runs[parent], "change": runs[change]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

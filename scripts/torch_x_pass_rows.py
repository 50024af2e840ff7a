#!/usr/bin/env python3
"""P1 ``hxt`` and P2 ``wtx`` on int8 X away from the bench shape, and K1/K4
at the optimizer's fold widths, for one or more checkouts on one GPU.

    python3 scripts/torch_x_pass_rows.py ROOT [ROOT ...] [--out FILE]

Each ROOT runs in a process of its own, in the order given (for an A/B:
``PARENT CHANGE CHANGE PARENT``), builds its kernels from its own
``alpine_tpu_torch/csrc`` and times them with this checkout's
``chip_smoke.py`` (``x_pass_twin_rows``, ``iteration_twin_rows``):

- P1 and P2 at K = 40 on 100k cells, on the same X at a base offset of
  1 byte, on 66,667 cells (rows 11 bytes off 16-byte alignment) and its
  aligned twin 66,672, on 33,334 and 33,344, on 8,192 cells and the same X
  at an offset of 1 byte, and on a tiled batch's slab (64 tiles of 128
  cells); and at the optimizer's ALS folds (P1 K = 44, P2 k = 32) on 66,667
  and 66,672 cells.  Each row: one call and 20 back to back (CUDA events),
  ``device_us`` (the summed kernel durations of a call, torch.profiler,
  median of 20), ``host_us`` (200 calls enqueued behind a sleeping card),
  the same for one bf16 ``torch.matmul`` over a pre-cast X, the plain
  version's time, the bound, the grid, and a digest of the output; a copy
  of X at a byte offset must give its aligned copy's bits;
- K1 at K = 144 and K4 at K = 44 on 66,667 and 66,672 cells: one call and
  ``device_us``;
- the host's µs a call of each step of P1's and P2's wrappers at 8,192
  cells (``host_breakdown``), beside bf16 ``torch.matmul``.

Every row goes to FILE (default ``x_pass_rows.jsonl`` in TMPDIR) with the
root it ran on; stdout gets one summary line a ROOT (its rows' times and
digests, the mean over its runs) and, with more than one ROOT, whether each
row's digest and grid agree across them.  Needs one NVIDIA GPU.
"""

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMES = ("ms", "ms_back_to_back", "device_us", "host_us", "library_ms",
         "library_ms_back_to_back", "library_device_us", "library_host_us", "plain_ms")
GRID = ("gene_block", "n_split", "cells_per_split", "stages", "chunk", "tile",
        "warp_rows", "gene_chunk", "blocks", "gene_ranges", "genes_a_range")


def child(root):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    spec = importlib.util.spec_from_file_location("smoke_rows",
                                                  os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from alpine_tpu_torch.ops import _build, kernels, mu

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    smoke.emit({"phase": "build", "per_source_seconds": _build.build_all()})
    gen = torch.Generator(device=dev).manual_seed(0)
    card = smoke.peaks(torch.cuda.get_device_name(0))
    smoke.x_pass_twin_rows(torch, kernels, mu, gen, dev, card)
    smoke.iteration_twin_rows(torch, kernels, gen, dev, card)
    smoke.emit(host_breakdown(torch, kernels, _build, smoke, gen, dev))


def on_device(torch, dev):
    with torch.cuda.device(dev):
        pass


def host_breakdown(torch, kernels, _build, smoke, gen, dev, n=8192, K=40):
    """µs of host time a call of each step of P1's and P2's wrappers at
    2,000 × 8,192 cells, K = 40, int8 X (the median of 5 runs of 200 calls
    enqueued behind a sleeping card, smoke.host_us), beside a whole call, a
    bare ctypes call of the C entry with its arguments ready (its launches
    included) and bf16 torch.matmul."""
    X, W, H = smoke.make_x_pass_problem(torch, gen, dev, smoke.G, n, K, torch.int8)
    g = smoke.G
    out = torch.empty((K, n), device=dev)
    Xb, Hb, Wb = X.to(torch.bfloat16), H.bfloat16(), W.bfloat16()
    steps = {
        "hxt": lambda: kernels.hxt(X, H),
        "wtx": lambda: kernels.wtx(X, W),
        "torch.matmul bf16 (hxt's product)": lambda: torch.matmul(Hb, Xb.T),
        "torch.empty (K, n) f32": lambda: torch.empty((K, n), device=dev),
        "check X and H": lambda: (kernels._check_x(X), kernels._check(
            "H", H, (K, n), torch.float32, dev)),
        "hxt_grid (cached)": lambda: kernels.hxt_grid(g, n, K, torch.int8),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "with torch.cuda.device(dev)": lambda: on_device(torch, dev),
        "X.data_ptr() x 4": lambda: (X.data_ptr(), H.data_ptr(), out.data_ptr(),
                                     W.data_ptr()),
    }
    if hasattr(kernels, "wtx_gene_split"):
        T, WR, GC, S, blocks = kernels.wtx_grid(g, n, K, torch.int8)
        ranges, per = kernels.wtx_gene_split(g, n, K, torch.int8)
        stream = kernels._stream(dev)
        arr, wb = kernels._workspace(dev, stream, blocks, 2 * 48 * 2048 + 4 * ranges * K * n)
        part = wb + 2 * 48 * 2048
        fn = _build.entry("wtx")
        args = (X.data_ptr(), 2, W.data_ptr(), g, n, K, T, WR, GC, S, ranges, per, wb, part,
                arr, out.data_ptr(), stream)
        steps.update({
            "wtx C entry alone (round_w + wtx_mma launches)": lambda: fn(*args),
            "kernels._stream(dev)": lambda: kernels._stream(dev),
            "kernels._workspace (kept buffers)": lambda: kernels._workspace(dev, stream, 1, 100),
            "wtx_grid + wtx_gene_split (cached)": lambda: (
                kernels.wtx_grid(g, n, K, torch.int8),
                kernels.wtx_gene_split(g, n, K, torch.int8)),
        })
    res = {}
    for name, fn_ in steps.items():
        res[name] = float(smoke.np.median([smoke.host_us(torch, fn_)[0] for _ in range(5)]))
    torch.cuda.synchronize()
    return {"phase": "host_breakdown", "shape": [g, n, K], "host_us": res}


def summarize(rows):
    """{row: {time: value}} of one run's kernel_twin rows."""
    out = {}
    for r in rows:
        if r.get("phase") == "host_breakdown":
            out["host_breakdown"] = r["host_us"]
        if r.get("phase") != "kernel_twin":
            continue
        key = f"{r['kind']} {r['label']}" if "kind" in r else r["case"]
        out[key] = {k: r[k] for k in TIMES + ("digest",) if k in r}
        out[key]["grid"] = {k: r[k] for k in GRID if k in r} or r.get("grid")
    return out


def main(argv):
    if len(argv) == 3 and argv[1] == "--child":
        child(argv[2])
        return 0
    args = argv[1:]
    out_path = os.path.join(tempfile.gettempdir(), "x_pass_rows.jsonl")
    if "--out" in args:
        i = args.index("--out")
        out_path = args[i + 1]
        del args[i:i + 2]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    runs = {}
    with open(out_path, "w") as f:
        f.write(json.dumps({"card": smi, "roots": args}) + "\n")
        for i, root in enumerate(args):
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                                 capture_output=True, text=True, timeout=1500)
            rows = [json.loads(line) for line in res.stdout.splitlines()
                    if line.startswith("{")]
            for r in rows:
                f.write(json.dumps({"root": root, "run": i, **r}) + "\n")
            f.flush()
            if res.returncode != 0:
                print(res.stderr[-4000:], file=sys.stderr)
                return res.returncode
            runs.setdefault(root, []).append(summarize(rows))
    summary = {"card": smi.splitlines()[0], "order": args}
    for root, rs in runs.items():
        mean = {}
        for key in rs[0]:
            if key == "host_breakdown":
                mean[key] = {k: sum(r[key][k] for r in rs) / len(rs) for k in rs[0][key]}
                continue
            mean[key] = {k: sum(r[key][k] for r in rs) / len(rs) for k in TIMES
                         if all(r[key].get(k) is not None for r in rs)}
            mean[key]["digest"] = rs[0][key].get("digest")
            mean[key]["grid"] = rs[0][key]["grid"]
        summary[root] = mean
    if len(runs) > 1:
        first = [k for k in next(iter(runs.values()))[0] if k != "host_breakdown"]
        summary["digest_equal"] = {
            key: len({r[key].get("digest") for rs in runs.values() for r in rs}) == 1
            for key in first}
        summary["grid_equal"] = {
            key: len({json.dumps(r[key]["grid"], sort_keys=True)
                      for rs in runs.values() for r in rs}) == 1
            for key in first}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

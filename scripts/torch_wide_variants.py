#!/usr/bin/env python3
"""Time design variants of P1/P2 above K = 512 (hxt_wide, wtx_wide) against
the kernels as they are.

    python3 scripts/torch_wide_variants.py [NAME ...]   # from the repository root

Each variant is a copy of ``alpine_tpu_torch`` in a temporary directory with
textual edits of ``csrc/x_passes_wide.cuh`` (and, where the grid rule must
follow, of ``ops/kernels.py``), built there (all at once, one nvcc each) and
timed in a process of its own:

- ``as_is``: the kernels as they are;
- ``trap``: the mbarrier wait traps after 2^26 spins (a guard against a
  hang); ptxas then serializes the wgmmas (C7512);
- ``overlap``: both kernels build stage c + 1's A fragments while stage
  c's products run (two register sets in turns, one group of products in
  flight) instead of waiting for each stage's products first;
- ``hxt_cluster_1``: hxt_wide's blocks alone (no multicast of Hb);
- ``wtx_cluster_2``: wtx_wide's blocks in clusters of two cell tiles
  sharing each stage of Wb (TMA multicast).

Per variant: ptxas's registers and spill stores of each wide kernel and its
performance notes (C75xx), then on int8 X at the bench shape (100k cells x
2,000 genes) and K = 768, 1024, 2048: ms a call of ``kernels.hxt`` and
``kernels.wtx`` (CUDA events, median of 10), the card's ms of each kernel
of a call (torch.profiler), and the worst error over the plain version's
tolerance (rtol 1e-4 + 1e-6 max|plain|).  One JSON line per variant and the
card's name and power limit.  Needs one NVIDIA GPU.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HDR = "csrc/x_passes_wide.cuh"
KERNELS = "ops/kernels.py"
G, N = 2000, 100_000
KS = (768, 1024, 2048)

WAIT = """  uint32_t done = 0;
  while (!done) {"""
# wide_mainloop's loop, and the same with stage c + 1's fragments built
# while stage c's products run
LOOP = """  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % S;
    const unsigned char* st = smem + (size_t)s * kStage;
    mbar_wait(bars + 8 * s, (c / S) & 1);
    uint32_t a[4][4];  // [k16 step][fragment register]
    build(st, c, a);
    const uint64_t desc = desc_sw128(smem_u32(st));
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_256(acc, a[j], desc + 2 * j);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    if (lane == 0) release_stage<CL>(bars + 8 * (S + s));
  }"""
OVERLAP = """  uint32_t a[2][4][4];
  auto stage = [&](int c) { return smem + (size_t)(c % S) * kStage; };
  auto wait_build = [&](int c, uint32_t(&f)[4][4]) {
    mbar_wait(bars + 8 * (c % S), (c / S) & 1);
    build(stage(c), c, f);
  };
  auto issue = [&](int c, uint32_t(&f)[4][4]) {
    const uint64_t desc = desc_sw128(smem_u32(stage(c)));
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_256(acc, f[j], desc + 2 * j);
    wgmma_commit();
  };
  auto release = [&](int c) {
    if (lane == 0) release_stage<CL>(bars + 8 * (S + c % S));
  };
  if (n_chunks == 0) return;
  wait_build(0, a[0]);
  for (int c = 0; c < n_chunks; c += 2) {
    issue(c, a[0]);
    if (c > 0) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
      release(c - 1);
    }
    if (c + 1 < n_chunks) {
      wait_build(c + 1, a[1]);
      issue(c + 1, a[1]);
      asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
      release(c);
      if (c + 2 < n_chunks) wait_build(c + 2, a[0]);
    }
  }
  wgmma_wait_all();
  fence_acc(acc);
  release(n_chunks - 1);"""
VARIANTS = {
    "as_is": [],
    "overlap": [(HDR, LOOP, OVERLAP)],
    "trap": [(HDR, WAIT, """  uint32_t done = 0;
  for (unsigned spin = 0; !done; ++spin) {
    if (spin > (1u << 26)) __trap();""")],
    "hxt_cluster_1": [(HDR, "constexpr int kHxtWideCL = 2,", "constexpr int kHxtWideCL = 1,"),
                      (KERNELS, '_WIDE_CL = {"hxt": 2,', '_WIDE_CL = {"hxt": 1,')],
    "wtx_cluster_2": [(HDR, "kWtxWideCL = 1;", "kWtxWideCL = 2;"),
                      (KERNELS, '"wtx": 1}', '"wtx": 2}')],
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def make(name):
    """A copy of the package with the variant's edits; its directory."""
    d = tempfile.mkdtemp(prefix=f"wide_{name}_")
    shutil.copytree(os.path.join(ROOT, "alpine_tpu_torch"), os.path.join(d, "alpine_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for path, old, new in VARIANTS[name]:
        full = os.path.join(d, "alpine_tpu_torch", path)
        src = open(full).read()
        if src.count(old) < 1:
            raise SystemExit(f"{name}: anchor not found in {path}: {old!r}")
        open(full, "w").write(src.replace(old, new))
    return d


def build(name):
    """Build the copy's x_passes library; ptxas's report of the wide kernels."""
    from alpine_tpu_torch.ops import _build
    _build.entry("hxt_wide")
    log = _build.build_log("x_passes")
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            fn = m.group(1)
            continue
        w = re.search(r"(hxt_wide|wtx_wide)I(\w+?)Lb([01])ELi(\d+)EE", fn or "")
        if not w:
            continue
        key = f"{w.group(1)} {'int8' if w.group(2) == 'a' else 'bf16'} aligned={w.group(3)}"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            usage.setdefault(key, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage.setdefault(key, {})["registers"] = int(m.group(1))
    notes = sorted({m.group(1) for m in re.finditer(r"\((C75\d\d)\)", log)})
    emit({"variant": name, "ptxas": usage, "ptxas_notes": notes})


def timed(name):
    """The variant's times and errors at the bench shape."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from alpine_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    X = torch.poisson(torch.full((G, N), 1.5, device=dev), generator=gen).clamp_(max=127)
    X = X.to(torch.int8)

    def ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[reps // 2]

    row = {"variant": name}
    for K in KS:
        H = torch.rand((K, N), generator=gen, device=dev)
        W = torch.rand((G, K), generator=gen, device=dev)
        for kind, P in (("hxt", H), ("wtx", W)):
            fn = lambda: getattr(kernels, kind)(X, P)
            got, want = fn(), getattr(kernels, f"{kind}_plain")(X, P)
            allowed = 1e-6 * float(want.abs().max()) + 1e-4 * want.abs()
            row[f"{kind}_K{K}_worst_err_over_tolerance"] = float(
                ((got - want).abs() / allowed).max())
            del got, want
            row[f"{kind}_K{K}_ms"] = ms(fn)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            row[f"{kind}_K{K}_device_ms"] = {
                e.key.split("(")[0][-32:]: e.self_device_time_total * 1e-3
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
        del H, W
        torch.cuda.empty_cache()
    emit(row)


def main(argv):
    if len(argv) == 4 and argv[1] == "--child":
        sys.path.insert(0, os.environ["WIDE_VARIANT_ROOT"])
        (build if argv[3] == "build" else timed)(argv[2])
        return 0
    names = argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit({"card": smi.splitlines()[0]})
    roots = {n: make(n) for n in names}
    env = lambda n: dict(os.environ, WIDE_VARIANT_ROOT=roots[n])
    builds = {n: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", n,
                                   "build"], env=env(n)) for n in names}
    failed = [n for n, p in builds.items() if p.wait() != 0]
    for n in names:
        if n not in failed:
            subprocess.run([sys.executable, os.path.abspath(__file__), "--child", n, "time"],
                           env=env(n), timeout=600, check=False)
    for d in roots.values():
        shutil.rmtree(d, ignore_errors=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

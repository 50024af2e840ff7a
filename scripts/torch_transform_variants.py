#!/usr/bin/env python3
"""Time variants of K3's tiled path (``transform_tiles`` in
``csrc/fused_transform.cu``) against the kernel as it is.

    python3 scripts/torch_transform_variants.py [NAME ...]   # from the repository root

Each variant is a copy of ``alpine_tpu_torch`` in a temporary directory with
textual edits of ``csrc/fused_transform.cu`` (and, where the rule must
follow, of ``ops/kernels.py``), built there and timed in a process of its
own:

- ``as_is``: the kernel as it is (G pairs of rows x 8 cells a thread, num2
  in registers, the ratios formed before the step's barrier);
- ``rows_of_4``: the first design: G groups of 4 rows x 4 cells a thread
  (one 16-byte load of the ring a group and one of the H tile a j: 4G + 4
  floats for 16 G FMAs), num2 in a shared-memory tile (so three stages of
  16 rows at K = 300 and 512), the divisions after the step's barrier;
- ``num2_shared``: the pairs layout (2G + 8 floats a j), num2 in a
  shared-memory tile and the divisions after the barrier, as in
  ``rows_of_4``;
- ``unguarded``: padded rows divide like real ones (1 / max(0, eps):
  1 / 0 at eps = 0, never written back), no select;
- ``no_division`` (wrong results): the ratios multiply by max(d, eps)
  instead of dividing, the IEEE division's cost;
- ``copies_only`` (wrong results): the ring's copies, the barriers and the
  update without the products;
- ``no_refill`` (wrong results): the ring is filled once and never
  refilled, the copies' cost to the threads that issue them;
- ``no_chunk_barrier`` (wrong results, racy): no barrier a chunk (the
  step's barrier stays), the barriers' cost.

The diagnostics fail the plain version's tolerance by design; the layout
variants keep the bits (the same sums in the same order).  ``SWEEP`` lists
the ring parameters (chunk rows J, stages S: runtime parameters of the C
entry) each variant is also timed at, with a check of its bits; ``as_is``
also times K = 56 and 64 on both paths (the wrapper's register path, the
tiled path through the C entry) and checks that their bits agree.  Names
on the command line pick variants (default: all).

All variants build at once (one nvcc each).  Per variant, K = 100, 300 and
512 at 100k cells and 50 steps (num2 = 2WᵀX, WtW2 = 2WᵀW from one seed):
median CUDA-event ms of 5 calls, the largest error over the plain
version's tolerance (rtol 2e-4, atol 1e-6 max|plain|), a digest of the
output, and ptxas's registers and spill stores of each instantiation.  One
JSON line per variant and the card's name and power limit.  Needs one
NVIDIA GPU.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, N, ITERS = 2000, 100_000, 50
CASES = (100, 300, 512)
BUCKETS = (56, 64)  # as_is: the register path's largest buckets, both paths
# (K, J, S) of the ring swept through the C entry, per variant
SWEEP = {"as_is": ((100, 16, 4), (100, 32, 2), (300, 8, 3), (300, 16, 3), (300, 32, 2),
                   (300, 32, 3), (512, 16, 3), (512, 32, 2))}

KERNEL_START = "template <int T, int G>\n__global__ void __launch_bounds__(kThreads, tiles_min_blocks(T, G))"
KERNEL_END = "template <int T, int G>\ncudaError_t launch_tiles("
RATIO = "acc[i][u][v] = num[i][u][v] / (real ? fmaxf(acc[i][u][v], eps) : 1.f);"
UNGUARDED = "acc[i][u][v] = num[i][u][v] / fmaxf(acc[i][u][v], eps);"
REFILL = "      issue(it * steps_chunks + c + S - 1, st == 0 ? S - 1 : st - 1);\n"
CHUNK_BARRIER = "      __syncthreads();\n      issue("
SMEM_CU = "return ((size_t)KP * T + (size_t)S * J * KP) * sizeof(float);"
SMEM_CU_NUM2 = "return ((size_t)2 * KP * T + (size_t)S * J * KP) * sizeof(float);"
SMEM_PY = "return 4 * (KP * T + S * J * KP)"
SMEM_PY_NUM2 = "return 4 * (2 * KP * T + S * J * KP)"
RING_PY = "J, S = _TRANSFORM_J, _TRANSFORM_STAGES"
# with num2's tile beside H's, two 32-row stages do not fit at K = 300 or 512
RING_PY_NUM2 = ("J, S = (32, 2) if transform_tiles_smem_bytes(KP, T, 32, 2) <= _MAX_SMEM "
                "else (16, 3)")
# the head of both earlier kernels: H's and num2's tiles in shared memory
HEAD_NUM2 = r"""template <int T, int G>
__global__ void __launch_bounds__(kThreads, tiles_min_blocks(T, G))
transform_tiles(const float* __restrict__ num2, const float* __restrict__ H0,
                const float* __restrict__ Wt, int K, int n, int n_iter, int J,
                int S, float eps, float* __restrict__ out) {
  constexpr int KP = tiles_kp(T, G);
  extern __shared__ __align__(16) float sm[];
  float* sH = sm;
  float* sNum = sH + KP * T;
  float* ring = sNum + KP * T;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * T, nv = min(T, n - c0);
  const int stage = J * KP, steps_chunks = KP / J, n_chunks = n_iter * steps_chunks;
  auto issue = [&](int q, int st) {
    if (q < n_chunks) {
      const float* src = Wt + (size_t)(q % steps_chunks) * stage;
      float* dst = ring + st * stage;
      for (int o = 4 * tid; o < stage; o += 4 * kThreads) cp_async16(dst + o, src + o, true);
    }
    cp_async_commit();
  };
  for (int q = 0; q < S - 1; ++q) issue(q, q);
  for (int o = tid; o < KP * T; o += kThreads) {
    const int k = o / T, t = o % T;
    const bool ok = k < K && t < nv;
    sH[o] = ok ? H0[(size_t)k * n + c0 + t] : 0.f;
    sNum[o] = ok ? num2[(size_t)k * n + c0 + t] : 1.f;
  }
"""
TAIL = r"""  cp_async_wait(0);
  __syncthreads();
  for (int o = tid; o < K * T; o += kThreads) {
    const int k = o / T, t = o % T;
    if (t < nv) out[(size_t)k * n + c0 + t] = sH[o];
  }
}

"""
ROWS_OF_4 = HEAD_NUM2 + r"""  // 1024 / T threads along K, G groups of 4 rows x 4 cells a thread
  constexpr int TR = 4 * kThreads / T, WC = kThreads / TR / 8;
  const int tr = warp / WC * 4 + lane / 8, tc = warp % WC * 8 + lane % 8;
  float acc[G][4][4];
  int st = 0;
  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][u][v] = 0.f;
    for (int c = 0; c < steps_chunks; ++c) {
      cp_async_wait(S - 2);
      __syncthreads();
      issue(it * steps_chunks + c + S - 1, st == 0 ? S - 1 : st - 1);
      const float* w = ring + st * stage + 4 * tr;
      const float* h = sH + c * J * T + 4 * tc;
      for (int j0 = 0; j0 < J; j0 += 8) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = j0 + jj;
          const float4 hv = *reinterpret_cast<const float4*>(h + j * T);
#pragma unroll
          for (int i = 0; i < G; ++i) {
            const float4 wv = *reinterpret_cast<const float4*>(w + j * KP + 4 * TR * i);
            const float wu[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[i][u][0] = fmaf(wu[u], hv.x, acc[i][u][0]);
              acc[i][u][1] = fmaf(wu[u], hv.y, acc[i][u][1]);
              acc[i][u][2] = fmaf(wu[u], hv.z, acc[i][u][2]);
              acc[i][u][3] = fmaf(wu[u], hv.w, acc[i][u][3]);
            }
          }
        }
      }
      st = st + 1 == S ? 0 : st + 1;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = 4 * (TR * i + tr) + u;
        if (k < K) {
          float4* hp = reinterpret_cast<float4*>(sH + k * T + 4 * tc);
          const float4 m = *reinterpret_cast<const float4*>(sNum + k * T + 4 * tc);
          float4 hv = *hp;
          hv.x = hv.x * (m.x / fmaxf(acc[i][u][0], eps));
          hv.y = hv.y * (m.y / fmaxf(acc[i][u][1], eps));
          hv.z = hv.z * (m.z / fmaxf(acc[i][u][2], eps));
          hv.w = hv.w * (m.w / fmaxf(acc[i][u][3], eps));
          *hp = hv;
        }
      }
  }
""" + TAIL
NUM2_SHARED = HEAD_NUM2 + r"""  // 2048 / T threads along K, G pairs of rows x 8 cells a thread
  constexpr int TR = tiles_rows(T), LC = T / 8 < 8 ? T / 8 : 8;
  const int tr = warp * (32 / LC) + lane / LC, tc = lane % LC;
  float acc[G][2][8];
  int st = 0;
  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[i][u][v] = 0.f;
    for (int c = 0; c < steps_chunks; ++c) {
      cp_async_wait(S - 2);
      __syncthreads();
      issue(it * steps_chunks + c + S - 1, st == 0 ? S - 1 : st - 1);
      const float* w = ring + st * stage + 2 * tr;
      const float* h = sH + c * J * T + 4 * tc;
      for (int j0 = 0; j0 < J; j0 += 8) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = j0 + jj;
          const float4 ha = *reinterpret_cast<const float4*>(h + j * T);
          const float4 hb = *reinterpret_cast<const float4*>(h + j * T + T / 2);
#pragma unroll
          for (int i = 0; i < G; ++i) {
            const float2 wv = *reinterpret_cast<const float2*>(w + j * KP + 2 * TR * i);
            const float wu[2] = {wv.x, wv.y};
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              acc[i][u][0] = fmaf(wu[u], ha.x, acc[i][u][0]);
              acc[i][u][1] = fmaf(wu[u], ha.y, acc[i][u][1]);
              acc[i][u][2] = fmaf(wu[u], ha.z, acc[i][u][2]);
              acc[i][u][3] = fmaf(wu[u], ha.w, acc[i][u][3]);
              acc[i][u][4] = fmaf(wu[u], hb.x, acc[i][u][4]);
              acc[i][u][5] = fmaf(wu[u], hb.y, acc[i][u][5]);
              acc[i][u][6] = fmaf(wu[u], hb.z, acc[i][u][6]);
              acc[i][u][7] = fmaf(wu[u], hb.w, acc[i][u][7]);
            }
          }
        }
      }
      st = st + 1 == S ? 0 : st + 1;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = 2 * (TR * i + tr) + u;
        if (k < K) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float4* hp = reinterpret_cast<float4*>(sH + k * T + half * (T / 2) + 4 * tc);
            const float4 m = *reinterpret_cast<const float4*>(sNum + k * T + half * (T / 2) + 4 * tc);
            float4 hv = *hp;
            hv.x = hv.x * (m.x / fmaxf(acc[i][u][4 * half], eps));
            hv.y = hv.y * (m.y / fmaxf(acc[i][u][4 * half + 1], eps));
            hv.z = hv.z * (m.z / fmaxf(acc[i][u][4 * half + 2], eps));
            hv.w = hv.w * (m.w / fmaxf(acc[i][u][4 * half + 3], eps));
            *hp = hv;
          }
        }
      }
  }
""" + TAIL


def _kernel(text):
    """Replace transform_tiles with ``text`` and give both the .cu and the
    rule a num2 tile in shared memory."""
    def edit(cu, py):
        start, end = cu.index(KERNEL_START), cu.index(KERNEL_END)
        return (cu[:start] + text + cu[end:]).replace(SMEM_CU, SMEM_CU_NUM2), \
            py.replace(SMEM_PY, SMEM_PY_NUM2).replace(RING_PY, RING_PY_NUM2)
    return edit


def _copies_only(cu, py):
    start = cu.index("      for (int j0 = 0; j0 < J; j0 += 8) {")
    end = cu.index("      st = st + 1 == S ? 0 : st + 1;", start)
    return cu[:start] + cu[end:], py


VARIANTS = {
    "as_is": lambda cu, py: (cu, py),
    "rows_of_4": _kernel(ROWS_OF_4),
    "num2_shared": _kernel(NUM2_SHARED),
    "unguarded": lambda cu, py: (cu.replace(RATIO, UNGUARDED), py),
    "no_division": lambda cu, py: (cu.replace(RATIO, RATIO.replace(" / ", " * ")), py),
    "copies_only": _copies_only,
    "no_refill": lambda cu, py: (cu.replace(REFILL, "      cp_async_commit();\n"), py),
    "no_chunk_barrier": lambda cu, py: (cu.replace(CHUNK_BARRIER, "      issue("), py),
}


def child(copy_root, name):
    import hashlib

    import numpy as np
    import torch

    sys.path.insert(0, copy_root)
    from alpine_tpu_torch.ops import _build, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def time_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    row = {"variant": name}
    fn = _build.entry("fused_transform")
    kern_name = None  # ptxas: registers and spill stores of each transform_tiles<TR, G>
    for line in _build.build_log("fused_transform").splitlines():
        m = re.search(r"Function properties for \w*transform_tilesILi(\d+)ELi(\d+)E", line)
        if m:  # <T, G>
            kern_name = f"tiles_T{m.group(1)}_G{m.group(2)}"
        elif "Function properties for" in line:
            kern_name = None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and kern_name:
            row[f"{kern_name}_spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kern_name:
            row[f"{kern_name}_registers"] = int(m.group(1))
    for K in CASES:
        W = torch.rand((G, K), generator=gen, device=dev)
        X = torch.poisson(torch.full((G, N), 1.5, device=dev), generator=gen)
        num2, WtW2 = 2.0 * (W.T @ X), 2.0 * (W.T @ W)
        del X
        H0 = torch.rand((K, N), generator=gen, device=dev) + 0.05
        kern = lambda: kernels.fused_transform(num2, H0, WtW2, 1e-6, n_iter=ITERS)
        got = kern().double()
        want = kernels.fused_transform_plain(num2, H0, WtW2, 1e-6, n_iter=ITERS).double()
        err = (got - want).abs()
        row[f"K{K}_ms"] = time_ms(kern)
        row[f"K{K}_worst_err_over_tolerance"] = float(
            (err / (1e-6 * float(want.abs().max()) + 2e-4 * want.abs())).max())
        row[f"K{K}_digest"] = hashlib.sha256(
            got.float().cpu().numpy().tobytes()).hexdigest()[:16]
        T, KP, _, _, _ = kernels.transform_tiles_grid(K)
        Wt = torch.empty((KP, KP), device=dev)
        out = torch.empty_like(H0)
        for J, S in [(j, s) for k, j, s in SWEEP.get(name, ()) if k == K]:
            call = lambda: fn(num2.data_ptr(), H0.data_ptr(), WtW2.data_ptr(), K, 0, N,
                              T, KP, J, S, ITERS, 1e-6, Wt.data_ptr(), None, out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
            rc = call()
            row[f"K{K}_J{J}_S{S}_ms"] = time_ms(call) if rc == 0 else f"rc {rc}"
            if rc == 0:
                row[f"K{K}_J{J}_S{S}_same_bits"] = bool(torch.equal(out, got.float()))
        del Wt, out
        del num2, WtW2, H0, got, want, err
        torch.cuda.empty_cache()
    if name == "as_is":  # the largest buckets: the register path against the tiled one
        for K in BUCKETS:
            W = torch.rand((G, K), generator=gen, device=dev)
            X = torch.poisson(torch.full((G, N), 1.5, device=dev), generator=gen)
            num2, WtW2 = 2.0 * (W.T @ X), 2.0 * (W.T @ W)
            del X
            H0 = torch.rand((K, N), generator=gen, device=dev) + 0.05
            T, KP, J, S, _ = kernels.transform_tiles_grid(K)
            Wt = torch.empty((KP, KP), device=dev)
            out = torch.empty_like(H0)
            tiled = lambda: fn(num2.data_ptr(), H0.data_ptr(), WtW2.data_ptr(), K, 0, N,
                               T, KP, J, S, ITERS, 1e-6, Wt.data_ptr(), None, out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
            register = lambda: kernels.fused_transform(num2, H0, WtW2, 1e-6, n_iter=ITERS)
            row[f"K{K}_register_path_ms"] = time_ms(register)
            row[f"K{K}_tiled_path_ms"] = time_ms(tiled)
            row[f"K{K}_paths_same_bits"] = bool(torch.equal(register(), out))
            del num2, WtW2, H0, Wt, out
            torch.cuda.empty_cache()
    print(json.dumps(row), flush=True)


def main(argv):
    if len(argv) == 4 and argv[1] == "--child":
        child(argv[2], argv[3])
        return 0
    names = argv[1:] or list(VARIANTS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    tmp = tempfile.mkdtemp()
    builds = {}
    for name in names:
        copy = os.path.join(tmp, name)
        shutil.copytree(os.path.join(ROOT, "alpine_tpu_torch"),
                        os.path.join(copy, "alpine_tpu_torch"),
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        paths = [os.path.join(copy, "alpine_tpu_torch", *parts)
                 for parts in (("csrc", "fused_transform.cu"), ("ops", "kernels.py"))]
        srcs = []
        for path in paths:
            with open(path) as f:
                srcs.append(f.read())
        edited = VARIANTS[name](*srcs)
        if name != "as_is" and edited[0] == srcs[0]:
            raise RuntimeError(f"variant {name} changed nothing")
        for path, text in zip(paths, edited):
            with open(path, "w") as f:
                f.write(text)
        builds[name] = subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
             "from alpine_tpu_torch.ops import _build; _build.entry('fused_transform')",
             copy], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(json.dumps({"variant": name, "build_failed": out[-3000:]}), flush=True)
            names.remove(name)
    for name in names:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                              os.path.join(tmp, name), name],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(json.dumps({"variant": name, "failed": out.stderr[-3000:]}), flush=True)
            continue
        print(out.stdout.strip().splitlines()[-1], flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

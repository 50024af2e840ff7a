#!/usr/bin/env python3
"""Time the port's kernel builds on a GPU machine.

    python3 scripts/torch_build_times.py   # from the repository root

Runs ``nvcc`` with ``_build.NVCC_FLAGS`` on each ``csrc/<name>.cu`` alone,
one after another; then ``fused_transform.cu`` without the instantiations
of its tiled path (``ALPINE_TILES``), the share of the build those add;
then ``_build.build_all()`` into an empty directory (every source at once,
as ``chip_smoke.py`` builds).  Everything is built in a temporary
directory; the repository's build directory is not touched.  Prints one
JSON line of seconds, the machine's CPU count and the card's name and power
limit.  Needs ``nvcc``.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    sys.path.insert(0, str(ROOT))
    from alpine_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    tmp = Path(tempfile.mkdtemp())

    def seconds(src):
        t0 = time.perf_counter()
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                        str(tmp / f"{src.stem}.so"), str(src)],
                       check=True, capture_output=True, text=True)
        return time.perf_counter() - t0

    row = {name: seconds(_build.CSRC / f"{name}.cu") for name in _build.SOURCES}
    text = (_build.CSRC / "fused_transform.cu").read_text()
    copy = tmp / "fused_transform_no_tiles.cu"
    copy.write_text(re.sub(r"  ALPINE_TILES\(\d+, \d+\)\n", "", text))
    row["fused_transform_without_tiled_path"] = seconds(copy)
    _build.BUILD_DIR = tmp / "build"  # an empty build directory: every source builds
    t0 = time.perf_counter()
    _build.build_all()
    row["build_all"] = time.perf_counter() - t0
    shutil.rmtree(tmp, ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"seconds": row, "cpus": os.cpu_count(), "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

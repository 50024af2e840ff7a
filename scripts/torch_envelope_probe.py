#!/usr/bin/env python3
"""The port's streaming read-rate probe on one NVIDIA GPU.

    python3 scripts/torch_envelope_probe.py [REPS]

Counterpart of the ``streaming_GBps`` part of benchmarks/envelope_probe.py:
streams bench-shaped X (2,000 genes x 100,000 cells, integers 0..99 drawn
from seed 0) through the port's ``stream_probe`` kernel, which reads and
widens every element to float32 and sums over the genes, and reports the
read rate of X in GB/s for int8 and float32 storage (the mean of REPS
launches, default 32, timed with CUDA events; ``alpine_tpu_torch/probe.py``).
Prints one JSON line, with the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them.

The JAX probe's other two parts are questions about the TPU and have no
kernel here: ``s8_dot`` (whether the TPU's matrix unit takes int8 operands
directly) and ``tile_ab`` (the Pallas X tile budget).  They are not ported.

Needs one NVIDIA GPU; exits non-zero without one.
"""

import json
import os
import subprocess
import sys


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("torch_envelope_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from alpine_tpu_torch import probe

    reps = int(argv[1]) if len(argv) > 1 else probe.REPS
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    rates = probe.streaming_GBps(("int8", "float32"), reps=reps)
    print(json.dumps({
        "metric": "torch_envelope_probe",
        "card": smi.splitlines()[0],
        "kind": torch.cuda.get_device_name(0),
        "shape": {"genes": probe.GENES, "cells": probe.CELLS},
        "streaming_GBps": {k: v["GBps"] for k, v in rates.items()},
        "ms": {k: v["ms"] for k, v in rates.items()},
        "tile": {k: v["tile"] for k, v in rates.items()},
        "reps": reps,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

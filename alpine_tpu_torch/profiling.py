"""Tracing, phase timing and numerical checks of the port.

Counterpart of ``alpine_tpu/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` trace of everything inside (host
  ops and, on a card, its kernels), written to ``logdir`` as a Chrome /
  Perfetto JSON file when the block ends;
- ``annotate(name)``: a named range (``torch.profiler.record_function``)
  that shows in such a trace;
- ``StepTimer``: wall-clock seconds per named phase into a dict;
  ``ALPINE.fit`` fills ``model.timings_`` with it ("warmup", "fit");
- ``enable_debug_checks()``: the fit loops check every iteration's loss
  row for NaN or ±inf and raise ``FloatingPointError`` at the first one.
  Each check reads the row to the host, so it syncs the card once an
  iteration: a debugging aid, off by default.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch

_debug_checks = False


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Profile the block and write its trace into ``logdir``
    (``trace_<pid>_<ns>.json``; open it in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named range that appears in profiler traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates wall-clock seconds per named phase into a dict."""

    def __init__(self, sink: Dict[str, float]):
        self.sink = sink

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with annotate(f"alpine:{name}"):
                yield
        finally:
            self.sink[name] = self.sink.get(name, 0.0) + time.perf_counter() - t0


def enable_debug_checks() -> None:
    """Check each fit iteration's loss row for non-finite values."""
    global _debug_checks
    _debug_checks = True


def disable_debug_checks() -> None:
    global _debug_checks
    _debug_checks = False


def check_loss_row(losses: torch.Tensor, it: int) -> None:
    """Raise ``FloatingPointError`` if debug checks are on and row ``it``
    of ``losses`` holds NaN or ±inf (reads the row to the host).  With the
    checks off it does nothing else."""
    if not _debug_checks:
        return
    row = losses[it]
    if not bool(torch.isfinite(row).all()):
        raise FloatingPointError(
            f"non-finite loss at iteration {it}: {row.tolist()}")

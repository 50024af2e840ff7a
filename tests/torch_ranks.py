"""Runs the gloo ranks of a multi-process test of the port once and returns
what each wrote.

    results = run_ranks(WORKER, workdir, world, timeout)

The parent hosts the rendezvous store itself, on a port the system picks
when the store binds (port 0), and every rank joins it as a client
(torchelastic's agent store, ``TORCHELASTIC_USE_AGENT_STORE``): no process
can take the port between its choice and the bind, as it could when a
free port was picked, closed and bound again by rank 0.  Each rank runs
``python WORKER PORT RANK WORLD WORKDIR`` and writes ``rank<i>.pkl``; a
rank that exits with another code than 0 fails the caller with its
errors.  ``group_threads`` names the threads of a gloo process group
still running in the calling process.
"""

import datetime
import os
import pickle
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def run_ranks(worker, workdir, world: int, timeout: float) -> list:
    from torch.distributed import TCPStore

    store = TCPStore("localhost", 0, world, is_master=True, wait_for_workers=False,
                     timeout=datetime.timedelta(seconds=timeout))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               TORCHELASTIC_USE_AGENT_STORE="True")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(store.port), str(r), str(world), str(workdir)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        del store
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
    results = []
    for r in range(world):
        with open(Path(workdir) / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def group_threads() -> list:
    """Names of this process's threads that belong to a gloo process group
    or its store (Linux names them in /proc: pt_gloo_runloop,
    gloo_tcp_loop, pt_tcpstore_uv)."""
    names = []
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as f:
                names.append(f.read().strip())
        except OSError:  # the thread ended meanwhile
            pass
    return sorted(n for n in names if "gloo" in n or "tcpstore" in n)

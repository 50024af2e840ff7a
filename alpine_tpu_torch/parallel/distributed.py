"""Multi-process bootstrap and collectives of the port: one process per
device, each holding one contiguous run of the cells.

Counterpart of ``alpine_tpu/parallel/distributed.py``.  Each process runs
the same program on its own cells:

    from alpine_tpu_torch.parallel import distributed as dist
    dist.initialize()                      # torchrun's environment
    lo, hi = dist.process_cell_range(n_obs)
    model = ALPINE(..., device=dist.global_cell_mesh())
    model.fit(adata_local, ["batch"])      # this process's cells only
    model.transform(adata_local)           # obsm holds this process's rows

- ``initialize`` wraps ``torch.distributed.init_process_group`` with a
  finite timeout: without arguments it reads torchrun's environment
  (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``); the explicit form takes the coordinator's address, the
  process count and index, the card of this process and the backend
  ("nccl" for CUDA ranks, "gloo" for CPU ranks by default).
- ``global_cell_mesh`` is the 1-D ``DeviceMesh`` named "cells" over every
  rank, which ``ALPINE(device=...)`` takes; ``global_gene_cell_mesh(n_g,
  n_c)`` is the 2-D ("genes", "cells") grid over every rank, on which the
  process at (gi, ci) passes the cells of run ci with every gene
  (``mesh_cell_range``) and computes on the gene rows of block gi:

      mesh = dist.global_gene_cell_mesh(2, 2)   # 4 processes
      lo, hi = dist.mesh_cell_range(mesh, n_obs)
      model = ALPINE(..., device=mesh)
      model.fit(adata[lo:hi], ["batch"])      # every gene of its cells
- The host-side helpers (``process_allgather_rows``,
  ``chunk_cell_sizes``, ``assert_same_across_processes``,
  ``assert_same_along_genes``, ``allgather_group_layout``,
  ``allgather_cell_codes``, ``allgather_gene_blocks``,
  ``allgather_cell_rows``, ``counted_allgather_rows``) check that the
  processes' inputs agree before a fit, build the tables a fit shares and
  gather a search's validation embeddings and fold scores; they exchange
  host rows over a gloo group, since NCCL moves only device tensors.
- ``all_reduce_sum`` is the sharded fit's one collective on device
  tensors, counted (and, on request, timed) in ``collectives``.

Every collective runs on every rank in the same order: a check that can
fail on one rank only gathers first and then raises on all of them.
"""

from __future__ import annotations

import datetime
import os
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

# the gloo group of the host rows: the default group when it is gloo, else
# a gloo group over the same ranks, made at the first host collective
_host_group = None

# the meshes built here (global_cell_mesh, global_gene_cell_mesh, and
# mesh.restore_device through _device_mesh): a DeviceMesh holds the process
# groups of its axes, which shutdown() takes from it
_meshes: List[weakref.ref] = []

# the sharded fit's all-reduces since reset_collectives(), by tag ("setup":
# the statistics before the loop, "iteration": one an iteration): calls and
# bytes; with timing on, the CUDA events around each call.  The host gather
# of a gathered weighted fit's label codes counts under "labels gather",
# a search's gathers of validation embeddings under "embedding gather" and
# its fold-score exchanges under "fold scores", each with its bytes
# received and its host milliseconds ("host_ms")
collectives: Dict[str, Dict[str, int]] = {}
_events: Optional[Dict[str, List]] = None


def _dist():
    import torch.distributed as tdist

    return tdist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    backend: Optional[str] = None,
    timeout: float = 600.0,
) -> None:
    """Join (or start) the process group.  Call it once in every process,
    before any fit.

    The zero-argument form reads torchrun's environment.  Otherwise pass
    ``coordinator_address`` ("host:port" of rank 0), ``num_processes`` and
    ``process_id``; whatever is not passed is read from the environment.
    ``local_device_ids`` is the card this process computes on (an int or
    a one-element sequence: one process per card); by default
    ``LOCAL_RANK``, else the process index modulo the cards present.  On a
    machine with a CUDA card the ranks are CUDA ranks and ``backend``
    defaults to "nccl"; otherwise they are CPU ranks and it defaults to
    "gloo" (the JAX package's ``cpu_collectives``).  CUDA ranks may ask
    for "gloo" (it all-reduces device tensors through host memory, and
    lets several ranks share one card), but it is never taken as a
    fallback for NCCL.
    ``timeout`` (seconds) bounds every collective."""
    tdist = _dist()
    if tdist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize needs the coordinator's address, the number of "
            "processes and this process's index: pass coordinator_address, "
            "num_processes and process_id, or run under torchrun "
            "(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process_id {process_id} out of range for "
                         f"{num_processes} processes")
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if backend == "nccl" and not cuda:
        raise RuntimeError("backend='nccl' needs a CUDA card; CPU ranks use "
                           "backend='gloo'")
    if cuda:
        if local_device_ids is None:
            local = int(env.get("LOCAL_RANK", int(process_id) % torch.cuda.device_count()))
        elif isinstance(local_device_ids, int):
            local = local_device_ids
        else:
            ids = list(local_device_ids)
            if len(ids) != 1:
                raise ValueError("one process computes on one card: pass a "
                                 "single local device id")
            local = int(ids[0])
        torch.cuda.set_device(local)
    global _host_group
    _host_group = None
    # NCCL binds the group to this process's card, which sets up its
    # communicator here rather than in the first fit's first all-reduce
    device_id = torch.device("cuda", local) if backend == "nccl" else None
    tdist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout)), device_id=device_id)


def shutdown() -> None:
    """Leave the process group (the counterpart of
    ``jax.distributed.shutdown``).

    Every mesh built by this module gives up its process groups first, so
    that destroying them frees them here and a gloo group's worker threads
    end now.  A mesh still referenced (by a model, or by the traceback of
    a search that raised) would otherwise keep them running until the
    interpreter's exit, and a thread that was still releasing the tensors
    of the last collective then aborts the process ("terminate called
    without an active exception").  Such a mesh runs no collective after
    this call."""
    global _host_group
    tdist = _dist()
    _host_group = None
    for ref in _meshes:
        mesh = ref()
        registry = getattr(mesh, "_pg_registry", None)
        if isinstance(registry, dict):
            registry.clear()
    _meshes.clear()
    if tdist.is_initialized():
        tdist.destroy_process_group()


def _device_mesh(device_type: str, shape, names):
    """``init_device_mesh`` over the process group, recorded for
    ``shutdown``."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))
    _meshes.append(weakref.ref(mesh))
    return mesh


def _initialized() -> bool:
    tdist = _dist()
    return tdist.is_available() and tdist.is_initialized()


def process_count() -> int:
    return _dist().get_world_size() if _initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if _initialized() else 0


def is_coordinator() -> bool:
    """True on process 0 (use it to gate one-copy side effects: files, log
    lines)."""
    return process_index() == 0


def global_cell_mesh():
    """The 1-D mesh "cells" over every rank of the process group, rank i at
    position i (so process i holds the i-th run of cells), on this rank's
    device."""
    if not _initialized():
        raise RuntimeError("call distributed.initialize() before "
                           "global_cell_mesh()")
    from alpine_tpu_torch.parallel.mesh import CELL_AXIS

    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return _device_mesh(device_type, (process_count(),), (CELL_AXIS,))


def global_gene_cell_mesh(n_genes_axis: int, n_cells_axis: int):
    """The 2-D ("genes", "cells") grid over every rank of the process
    group (the counterpart of ``make_gene_cell_mesh``): rank r at
    (r // n_cells_axis, r % n_cells_axis), the JAX package's row-major
    layout, on this rank's device.  The grid must span every process: a
    process outside it would wait forever in the fit's collectives."""
    if not _initialized():
        raise RuntimeError("call distributed.initialize() before "
                           "global_gene_cell_mesh()")
    for v in (n_genes_axis, n_cells_axis):
        if not isinstance(v, (int, np.integer)) or v <= 0:
            raise ValueError("the grid's axis sizes must be positive integers")
    need, n = int(n_genes_axis) * int(n_cells_axis), process_count()
    if n < need:
        raise ValueError(f"need {need} devices, have {n}")
    if n > need:
        raise ValueError(
            f"a {n_genes_axis} x {n_cells_axis} ('genes', 'cells') grid "
            f"holds {need} processes, but the process group has {n}: the "
            "grid must span every process")
    from alpine_tpu_torch.parallel.mesh import CELL_AXIS, GENE_AXIS

    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return _device_mesh(device_type, (int(n_genes_axis), int(n_cells_axis)),
                        (GENE_AXIS, CELL_AXIS))


def mesh_cell_range(mesh, n_cells: int) -> tuple:
    """This process's cells ``(lo, hi)`` on ``mesh`` (a cell mesh or a
    grid): the near-equal run of ``n_cells`` at its position along the
    cell axis (``process_cell_range`` over the cell axis's processes).  On
    a grid every process of a cell column passes these cells, with all
    their genes."""
    from alpine_tpu_torch.parallel.mesh import Placement

    p = Placement(mesh)
    return process_cell_range(n_cells, p.cell_shards, p.process_chunk_index)


def process_cell_range(n_cells: int, n_processes: Optional[int] = None,
                       process_index_: Optional[int] = None) -> tuple:
    """This process's contiguous cell (obs-row) range ``(lo, hi)`` of a
    globally ``n_cells``-cell dataset, split near-equally across processes
    (the first ``n_cells % n_processes`` processes take one extra cell).
    The ingestion partner of ``io.h5ad.read_h5ad(path, obs_range=...)``.
    Shards may differ by one cell: the kernels take any cell count, so no
    cell is dropped or padded."""
    if not isinstance(n_cells, (int, np.integer)) or n_cells <= 0:
        raise ValueError("n_cells must be a positive integer")
    n_cells = int(n_cells)
    p = process_count() if n_processes is None else int(n_processes)
    i = process_index() if process_index_ is None else int(process_index_)
    if not 0 <= i < p:
        raise ValueError(f"process index {i} out of range for {p} processes")
    if n_cells < p:
        raise ValueError(
            f"cannot split {n_cells} cells across {p} processes "
            "(every process needs at least one cell)"
        )
    base, rem = divmod(n_cells, p)
    lo = i * base + min(i, rem)
    hi = lo + base + (1 if i < rem else 0)
    return lo, hi


def _rows_group():
    """The gloo group that carries host rows."""
    global _host_group
    tdist = _dist()
    if tdist.get_backend() == "gloo":
        return None  # the default group
    if _host_group is None:
        _host_group = tdist.new_group(backend="gloo")
    return _host_group


def process_allgather_rows(local_row) -> np.ndarray:
    """All-gather a small host array across processes: returns
    (n_processes, *shape) with row p from process p.  For pre-fit
    consistency checks, not bulk data.  Every process passes an array of
    one shape and kind (integer or float); where they differ, every
    process raises."""
    arr = np.asarray(local_row)
    arr = arr.astype(np.float64 if arr.dtype.kind in "fc" else np.int64)
    if arr.ndim > 4:
        raise ValueError("process_allgather_rows takes arrays of at most 4 "
                         "dimensions")
    if not _initialized():
        return arr[None]
    tdist = _dist()
    group = _rows_group()
    world = process_count()
    # the shapes first, so that mismatched rows raise everywhere instead of
    # failing (or hanging) inside the gather
    head = torch.tensor([arr.ndim, arr.size, int(arr.dtype.kind == "f")]
                        + list(arr.shape) + [-1] * (4 - arr.ndim),
                        dtype=torch.int64)
    heads = [torch.empty_like(head) for _ in range(world)]
    tdist.all_gather(heads, head, group=group)
    if any(not torch.equal(h, heads[0]) for h in heads):
        raise ValueError(
            "process_allgather_rows: the processes passed rows of different "
            f"shapes or kinds ({[h.tolist() for h in heads]})")
    t = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1))
    out = [torch.empty_like(t) for _ in range(world)]
    tdist.all_gather(out, t, group=group)
    return np.stack([o.numpy() for o in out]).reshape((world,) + arr.shape)


def chunk_cell_sizes(placement, n_local: int) -> np.ndarray:
    """Allgather every process's local cell count, returned ordered by
    position along the mesh's cell axis (chunk index).  The sum is the
    global cell count and the prefix sums are the chunks' H0 column
    offsets.  On a grid every process of a cell column holds the same
    cells: the count is read once a column, and a column whose processes
    hold different counts raises on every process."""
    # gather BEFORE validating: a process raising alone would leave its
    # peers blocked in this collective.  That includes
    # process_chunk_index itself, which raises for a process outside the
    # mesh: ship a -1 sentinel through the gather instead
    try:
        chunk, gene = int(placement.process_chunk_index), int(placement.gene_index)
        chunk_err = ""
    except ValueError as exc:
        chunk, gene, chunk_err = -1, -1, str(exc)
    rows = process_allgather_rows(np.asarray(
        [chunk, int(n_local), process_index(), gene], np.int64,
    ))
    if (rows[:, 0] < 0).any():
        bad = rows[rows[:, 0] < 0, 2].tolist()
        raise ValueError(
            f"process(es) {bad} could not place their devices on the mesh "
            "cell axis"
            + (f": {chunk_err}" if chunk_err else
               " (see the failing process's log for the placement error).")
        )
    if (rows[:, 1] <= 0).any():
        raise ValueError(
            "every process of a multi-process fit must hold at least one "
            f"cell (per-process (chunk, cells) pairs: {rows[:, :2].tolist()})"
        )
    n_chunks = placement.cell_shards
    for g in range(placement.gene_shards):
        chunks = rows[rows[:, 3] == g, 0]
        if sorted(chunks.tolist()) != list(range(n_chunks)):
            raise ValueError(
                "multi-process mesh chunk indices are not a permutation of "
                f"0..{n_chunks - 1} (got {chunks.tolist()}); every "
                "process must own one contiguous run of the mesh cell axis "
                "(use distributed.global_cell_mesh)."
            )
    sizes = np.zeros(n_chunks, dtype=np.int64)
    sizes[rows[rows[:, 3] == 0, 0]] = rows[rows[:, 3] == 0, 1]
    if (rows[:, 1] != sizes[rows[:, 0]]).any():
        raise ValueError(
            "the processes of a cell column must pass the same cells (every "
            "gene of one run of cells); per-process (cell run, gene block, "
            f"cells): {rows[:, [0, 3, 1]].tolist()}"
        )
    if (rows[:, 0] != rows[:, 2] % n_chunks).any():
        import warnings

        warnings.warn(
            "multi-process mesh chunk order differs from process order "
            f"((chunk, process) pairs: {rows[:, [0, 2]].tolist()}); if "
            "per-process shards were ingested with process_cell_range "
            "(keyed by process index), pass its process_index_ argument "
            "as Placement.process_chunk_index so file rows land at their "
            "chunk positions.",
            stacklevel=2,
        )
    return sizes


def assert_same_along_genes(placement, values, what: str) -> None:
    """On a grid, raise on every process unless the processes of each
    cell column passed the same small host value (a digest of their
    cells); nothing off a grid.  Collective on a grid."""
    if not placement.is_grid:
        return
    arr = np.asarray(values, dtype=np.float64).reshape(-1)
    rows = process_allgather_rows(np.concatenate(
        [[float(placement.process_chunk_index)], arr]))
    bad = sorted({int(r[0]) for r in rows
                  if not np.array_equal(r[1:], rows[rows[:, 0] == r[0]][0, 1:])})
    if bad:
        raise ValueError(
            f"{what} differs within cell column(s) {bad}: the processes of a "
            "cell column must pass the same cells, with every gene.")


def allgather_group_layout(placement, local_codes: np.ndarray):
    """The global joint-label group layout of a weighted_fast fit over
    processes, agreed without exchanging cells: every process passes its
    cells' codes (``utils.sampling.joint_label_codes``) and gets

        g_codes (J,) int64: the codes present anywhere, sorted (the
                single-process group order), and
        m_gp (n_chunks, J) int64: each chunk's cell count of each group,
                chunks in mesh order (the cell axis's; on a grid, a
                cell column's).

    From these a process derives the global group sizes, its own offsets
    within each group and the global group-sorted position of each of its
    cells.  The (code, count) pairs travel as float64 (exact below 2^53,
    which ``joint_label_codes`` guards).  Collective: every process calls
    it with its own cells' codes."""
    uniq, counts = np.unique(np.asarray(local_codes, np.int64),
                             return_counts=True)
    j_max = int(process_allgather_rows(
        np.asarray([len(uniq)], np.int64)).max())
    row = np.full(2 + 2 * j_max, -1.0, np.float64)
    row[0] = float(placement.process_chunk_index)
    row[1] = float(placement.gene_index)
    row[2:2 + len(uniq)] = uniq
    row[2 + j_max:2 + j_max + len(counts)] = counts
    # on a grid the processes of a cell column hold the same cells: the
    # column's row is read once, from gene block 0
    rows = process_allgather_rows(row)
    rows = rows[rows[:, 1] == 0]
    codes_all = rows[:, 2:2 + j_max]
    g_codes = np.unique(codes_all[codes_all >= 0].astype(np.int64))
    m_gp = np.zeros((placement.cell_shards, len(g_codes)), np.int64)
    for r in rows:
        codes = r[2:2 + j_max]
        cnts = r[2 + j_max:2 + 2 * j_max]
        mask = codes >= 0
        m_gp[int(r[0]), np.searchsorted(g_codes, codes[mask].astype(np.int64))] \
            = cnts[mask].astype(np.int64)
    return g_codes, m_gp


def allgather_cell_codes(placement, local_codes: np.ndarray,
                         chunk_sizes: np.ndarray) -> np.ndarray:
    """Every cell's joint-label code (``utils.sampling.joint_label_codes``)
    in the global cell order: the runs of the cell axis in order (on a
    grid, the cell columns'), each of ``chunk_sizes[c]`` cells.  A
    gathered weighted fit over processes derives the global balanced
    probabilities from them, so every process draws the single-device
    draw.  One host allgather of the rows padded to the widest run (int64:
    8 · processes · widest bytes received, 8 · n_cells on equal runs of a
    cell mesh), counted under "labels gather" in ``collectives``.
    Collective: every process calls it with its own cells' codes."""
    widest = int(np.max(chunk_sizes))
    row = np.full(2 + widest, -1, np.int64)
    row[0], row[1] = placement.process_chunk_index, placement.gene_index
    row[2:2 + len(local_codes)] = local_codes
    rows = counted_allgather_rows(row, "labels gather")
    # on a grid a cell column's processes hold the same cells: gene block 0's
    rows = rows[rows[:, 1] == 0]
    rows = rows[np.argsort(rows[:, 0])]
    return np.concatenate([r[2:2 + int(m)] for r, m in zip(rows, chunk_sizes)])


def allgather_cell_rows(placement, local_rows: np.ndarray, n_cells: int) -> np.ndarray:
    """The rows of all ``n_cells`` cells (one row a cell, such as a
    validation fold's embedding), in the global cell order, on every
    process of a mesh: each process passes the rows of its run of the
    cells (``mesh_cell_range``; on a grid, its cell column's, of which
    every gene block holds an equal copy, so gene block 0's are read).
    One host allgather of float64 rows padded to the widest run, counted
    under "embedding gather" (calls, bytes received, ``host_ms``).
    Collective: every process calls it with its own rows."""
    local = np.asarray(local_rows)
    runs = [process_cell_range(n_cells, placement.cell_shards, c)
            for c in range(placement.cell_shards)]
    widest = max(hi - lo for lo, hi in runs)
    width = local.shape[1]
    row = np.zeros(2 + widest * width, np.float64)
    row[0], row[1] = placement.process_chunk_index, placement.gene_index
    row[2:2 + local.size] = local.reshape(-1)
    rows = counted_allgather_rows(row, "embedding gather")
    rows = rows[rows[:, 1] == 0]
    rows = rows[np.argsort(rows[:, 0])]
    return np.concatenate([
        r[2:2 + (hi - lo) * width].reshape(hi - lo, width)
        for r, (lo, hi) in zip(rows, runs)]).astype(local.dtype)


def counted_allgather_rows(row, tag: str) -> np.ndarray:
    """``process_allgather_rows``, counted under ``tag`` in
    ``collectives``: its calls, the bytes received and its host
    milliseconds (``host_ms``)."""
    t0 = time.perf_counter()
    rows = process_allgather_rows(row)
    c = collectives.setdefault(tag, {"calls": 0, "bytes": 0, "host_ms": 0.0})
    c["calls"] += 1
    c["bytes"] += rows.nbytes
    c["host_ms"] += (time.perf_counter() - t0) * 1e3
    return rows


def allgather_gene_blocks(placement, block: np.ndarray) -> np.ndarray:
    """On a grid, the whole matrix of which each process holds a block of
    rows (its gene block of W): the blocks of this process's cell column,
    in gene order; off a grid, ``block`` itself.  Collective on a grid
    (one host allgather over every process)."""
    if not placement.is_grid:
        return block
    block = np.asarray(block)
    rows = process_allgather_rows(np.concatenate(
        [[float(placement.process_chunk_index), float(placement.gene_index)],
         block.reshape(-1).astype(np.float64)]))
    mine = rows[rows[:, 0] == placement.process_chunk_index]
    mine = mine[np.argsort(mine[:, 1])]
    return np.concatenate([r[2:].reshape(block.shape) for r in mine]).astype(block.dtype)


def assert_same_across_processes(values, what: str) -> None:
    """Raise on every process if a small per-process host value differs
    between processes, catching inconsistent preprocessing before an
    expensive fit."""
    if process_count() == 1:
        return
    arr = np.asarray(values, dtype=np.float64).reshape(-1)
    rows = process_allgather_rows(arr)
    # exact comparison: every caller passes exact integers (shapes, label
    # hashes); a tolerance would let distinct 48-bit hashes pass as equal
    if not all(np.array_equal(rows[p], rows[0], equal_nan=True)
               for p in range(rows.shape[0])):
        raise ValueError(
            f"{what} differs across processes: {rows.tolist()} — every "
            "process must run identical preprocessing on consistent inputs."
        )


def reset_collectives(timed: bool = False) -> None:
    """Zero the all-reduce counts; with ``timed``, record CUDA events
    around each later call on device tensors (``collective_summary``
    reads them)."""
    global _events
    collectives.clear()
    _events = {} if timed else None


def all_reduce_sum(buf: torch.Tensor, group=None, tag: str = "iteration") -> None:
    """Sum ``buf`` in place over the ranks of ``group``, counted under
    ``tag``."""
    _all_reduce(buf, group, tag, _dist().ReduceOp.SUM)


def all_reduce_max(value: int, group, device, tag: str = "setup") -> int:
    """The largest of the ranks' ``value`` over ``group`` (one all-reduce
    of an int64 on ``device``, counted under ``tag``); it reads the result
    back to the host."""
    buf = torch.tensor([int(value)], dtype=torch.int64, device=device)
    _all_reduce(buf, group, tag, _dist().ReduceOp.MAX)
    return int(buf.item())


def _all_reduce(buf: torch.Tensor, group, tag: str, op) -> None:
    timed = _events is not None and buf.is_cuda
    if timed:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    _dist().all_reduce(buf, op=op, group=group)
    if timed:
        end.record()
        _events.setdefault(tag, []).append((start, end))
    c = collectives.setdefault(tag, {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += buf.numel() * buf.element_size()


def collective_summary() -> Dict[str, Dict[str, float]]:
    """Calls and bytes per tag since ``reset_collectives``, and the summed
    milliseconds between the CUDA events around the calls where they were
    timed (this waits for the card)."""
    out = {tag: dict(c) for tag, c in collectives.items()}
    for tag, pairs in (_events or {}).items():
        pairs[-1][1].synchronize()
        out[tag]["ms"] = sum(s.elapsed_time(e) for s, e in pairs)
    return out

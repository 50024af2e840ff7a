"""Device resolution and cell- and gene-axis placement for the port.

Counterpart of ``alpine_tpu/parallel/mesh.py``.  ``resolve_device`` maps
the estimator's ``device`` argument to a ``torch.device`` or to a
``torch.distributed.device_mesh.DeviceMesh`` over the processes: the 1-D
cell mesh of ``distributed.global_cell_mesh`` or the 2-D ("genes",
"cells") grid of ``distributed.global_gene_cell_mesh``, with one
deliberate difference from the JAX package: there is no silent CPU
fallback.  The estimator runs on the card unless the caller asks for the
CPU.

On a cell mesh each process computes on one device and holds one
contiguous run of the cells: its columns of X, H and the Ys.  W and the Bs
are replicated, and each fit iteration sums the small per-process
statistics with all-reduces (``ops/mu.py:fit_scan_sharded``: one an
iteration of a full-batch joint or weighted_fast fit).  Any cell
mesh takes that path, whatever its size: a mesh of one process is the
degenerate case, whose all-reduce changes nothing.  The JAX package's
single-process multi-device mesh (``make_cell_mesh``) has no counterpart:
in PyTorch's idiom a process drives one card, so several cards are several
processes.

On a grid of n_g × n_c processes (the JAX package's ``make_gene_cell_mesh``
layout, rank r at (r // n_c, r % n_c)) the process at (gi, ci) holds the
block of X at gene rows gi and cell run ci, the W rows of its gene block
and the H and Ys columns of its cells; the Bs are replicated.  The ranks
of a cell column hold the same cells, those of a gene row the same W
rows.  Each fit iteration sums its statistics along both axes
(``ops/mu.py``: ``r`` over the cells group, ``rg`` over the genes group).
"""

from __future__ import annotations

import torch

CELL_AXIS = "cells"
GENE_AXIS = "genes"


def is_mesh(obj) -> bool:
    """Whether ``obj`` is a ``torch.distributed`` DeviceMesh."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(obj, DeviceMesh)


def _resolve_mesh(mesh):
    names = tuple(mesh.mesh_dim_names or ())
    if mesh.ndim == 1 or (mesh.ndim == 2 and names == (GENE_AXIS, CELL_AXIS)):
        return mesh
    raise ValueError(
        "ALPINE expects a 1-D mesh (cell-axis sharding) or a 2-D mesh "
        f"with axes ('genes', 'cells'); got axes {names}"
    )


def resolve_device(device="cuda"):
    """Map the user-facing ``device`` argument to a ``torch.device``, or to
    the 1-D cell mesh or ("genes", "cells") grid it is.

    ``"cuda"`` (the default) and ``"auto"`` mean the current CUDA device;
    ``"cpu"`` is accepted (the tests use it).  Asking for the card where
    there is none raises instead of falling back to the CPU."""
    if device is None or (isinstance(device, str) and device == "auto"):
        device = "cuda"
    if is_mesh(device):
        return _resolve_mesh(device)
    if isinstance(device, str):
        try:
            dev = torch.device(device)
        except RuntimeError as e:
            raise ValueError(f"Unknown device {device!r}: {e}") from e
    elif isinstance(device, torch.device):
        dev = device
    else:
        raise TypeError(
            f"device must be a string, torch.device or DeviceMesh, got "
            f"{type(device)}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ALPINE(device='cuda') needs an NVIDIA GPU, but "
                "torch.cuda.is_available() is False. Pass device='cpu' to "
                "run the plain PyTorch path on the CPU.")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(
        f"device must be 'cuda', 'auto' or 'cpu', got {device!r}")


def describe_device(dev):
    """A picklable descriptor of a resolved device: a mesh becomes
    ``("__mesh__", axis names, shape, device type)``, anything else stays
    as it is (a ``torch.device`` pickles)."""
    if is_mesh(dev):
        return ("__mesh__", tuple(dev.mesh_dim_names or ()),
                tuple(dev.mesh.shape), dev.device_type)
    return dev


def restore_device(desc):
    """Inverse of ``describe_device`` in the loading process: a mesh is
    rebuilt over the process group when one of the same size is
    initialized, else the model loads onto the card (with a warning:
    later fits run unsharded), and with no card it raises as
    ``resolve_device("cuda")`` does."""
    if not (isinstance(desc, tuple) and desc and desc[0] == "__mesh__"):
        return desc
    _, axes, shape, device_type = desc
    from alpine_tpu_torch.parallel import distributed as dist

    n = 1
    for s in shape:
        n *= s
    if dist._initialized() and dist.process_count() == n:
        return dist._device_mesh(device_type, shape, axes)
    dev = resolve_device("cuda")
    import warnings

    warnings.warn(
        f"Could not restore pickled device {desc!r} in this process (no "
        f"process group of {n} ranks); loading onto {dev} — subsequent "
        "fits run unsharded."
    )
    return dev


class Placement:
    """Where fit-time tensors live: one device, this process's run of cells
    on a cell mesh, or its block of genes × cells on a ("genes", "cells")
    grid (one device a process).

    On a mesh the tensors a process passes and receives are its own: X,
    H and the Ys hold its cells' columns (X on a grid only its gene
    block's rows, and W those rows), W (on a grid, each gene block of it)
    and the Bs are replicated and kept bit-identical by computing them
    from identical all-reduced statistics.  Nothing is assembled into a
    global tensor.  A process drives one device, so the JAX class's
    per-process device counts (``is_multiprocess``, ``local_cell_shards``)
    have no counterpart: the processes are the shards."""

    def __init__(self, target):
        self.target = target
        self.mesh = target if is_mesh(target) else None

    @property
    def is_sharded(self) -> bool:
        return self.mesh is not None

    @property
    def is_grid(self) -> bool:
        """A ("genes", "cells") grid: the gene axis is sharded too."""
        return self.mesh is not None and self.mesh.ndim == 2

    @property
    def n_processes(self) -> int:
        """The mesh's processes (1 when unsharded)."""
        return 1 if self.mesh is None else int(self.mesh.size())

    @property
    def cell_shards(self) -> int:
        """Processes along the cell axis: runs of cells (1 when
        unsharded)."""
        return 1 if self.mesh is None else int(self.mesh.shape[-1])

    @property
    def gene_shards(self) -> int:
        """Processes along the gene axis: gene blocks (1 off a grid)."""
        return int(self.mesh.shape[0]) if self.is_grid else 1

    def _coordinate(self):
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise ValueError("this process owns no devices of the mesh")
        return coord

    @property
    def process_chunk_index(self) -> int:
        """This process's position along the mesh's cell axis, i.e. which
        run of cells it holds (0 when unsharded)."""
        return 0 if self.mesh is None else int(self._coordinate()[-1])

    @property
    def gene_index(self) -> int:
        """This process's position along the gene axis, i.e. which block
        of genes it holds (0 off a grid)."""
        return int(self._coordinate()[0]) if self.is_grid else 0

    @property
    def group(self):
        """The process group of the cell axis (None when unsharded): on a
        grid, the ranks of this process's gene row."""
        if self.mesh is None:
            return None
        return self.mesh.get_group(CELL_AXIS if self.is_grid else None)

    @property
    def gene_group(self):
        """The process group of the gene axis on a grid (the ranks of this
        process's cell column), None otherwise."""
        return self.mesh.get_group(GENE_AXIS) if self.is_grid else None

    def check_gene_axis(self, n_genes: int) -> None:
        """A grid shards the gene axis in equal blocks, which must divide
        the gene count (the JAX package's check and message)."""
        if self.is_grid:
            gs = self.gene_shards
            if n_genes % gs:
                raise ValueError(
                    f"n_genes={n_genes} is not divisible by the mesh's "
                    f"'{GENE_AXIS}' axis ({gs} devices); choose a gene-axis "
                    "size that divides the gene count."
                )

    def gene_range(self, n_genes: int) -> tuple:
        """This process's gene rows ``(lo, hi)``: an equal block of
        ``n_genes`` on a grid, every gene otherwise."""
        self.check_gene_axis(n_genes)
        size = n_genes // self.gene_shards
        lo = self.gene_index * size
        return lo, lo + size

    @property
    def device(self) -> torch.device:
        """The device this process computes on."""
        if self.mesh is None:
            return self.target
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

"""The port's ("genes", "cells") grid of processes, on the CPU: four gloo
ranks (tests/torch_dist_grid_worker.py, spawned once for the module) form
a 2 × 2 grid, each holding one block of X (its gene rows of its cells),
and the parent holds what they wrote against the JAX package's 2-D mesh
and the single-process port.

- The grid and its placement: rank r at (r // 2, r % 2), the cells group
  a gene row, the genes group a cell column, the ranges; grids that do
  not span the group raise (the JAX package's ``need … devices`` message
  where there are too few processes).
- The step loop ``mu._fit_scan_steps`` in float64 (joint KL and
  Frobenius, ALS, weighted_fast with given counts, random minibatches of
  20 cells from a given permutation, among them one whose first batch
  holds no cell of column 1) on ragged columns (31 / 30 cells) against
  the single-process float64 loop at rtol 1e-11, W's rows and H's
  columns concatenated; the all-reduces an iteration (a minibatch epoch:
  nb + 1 over each axis, bytes from each column's share of every batch);
  the kernel wrappers' calls of a fused minibatch fit (none for a
  column's empty share).
- ``mu.fit_scan`` on the grid against the JAX package's ``mu.fit_scan``
  on ``make_gene_cell_mesh(2, 2)`` from ``alpine_tpu.ops.mu.
  init_matrices``' draws: loss rtol 1e-4, factors 5e-3
  (tests/test_sharding.py:74-75); weighted_fast from the JAX package's
  count stream at H rtol 2e-4 atol 1e-6 and loss rtol 5e-5
  (tests/test_weighted_counts.py:494-495); random minibatches (KL,
  Frobenius, int8 at loss 5e-4) from the JAX package's own epoch
  permutations.  The grid's transform against the JAX package's and the
  single-process port's.
- The joint step's all-reduces: one over genes an iteration of K ×
  (local cells + K) values, which grows with the cells, and two over
  cells (the step's and the loss's), which do not.
- The estimator (96 and 95 cells × 32 genes; KL, Frobenius, ALS,
  weighted_fast, random minibatches of 24 cells; int8 over 5 iterations)
  against the port's single-process fit: loss rtol 1e-4 (int8 5e-4), embedding rtol 5e-3
  atol 1e-5; W, the Bs and the losses bit-equal on all four ranks, H
  within each cell column.  Its transforms (through the fit's device X,
  the weighted_fast fit's group-sorted X, 61 fresh cells, a pickled grid
  model) against the single-process transform with the same W, rtol
  1e-5.
- Refusals raise on every rank: an indivisible gene count (the JAX
  package's message), columns holding different cells, and the JAX
  package's other refusals; the groups still work after.  Gathered
  weighted and ALS minibatch fits and the optimizer, which the JAX
  package refuses on a multi-process mesh, run on every rank.
- The global-draw fits beyond random minibatches: ALS minibatch (the
  float64 step loop with column 1's first share empty; fit_scan from the
  JAX package's permutations against its 2-D mesh; the estimator) and
  gathered "weighted" joint and ALS fits (draws with replacement that
  repeat cells; fit_scan from the JAX package's ``jax.random.choice``
  epochs; the estimator), nb · n_blocks + 1 (ALS) or nb + 1 all-reduces
  over each axis an epoch; a weighted fit resumed from a snapshot bit for
  bit.
- Snapshots (``checkpoint_dir``): a file a rank, its key holding the
  grid's shape, the rank's place and its gene rows; joint and minibatch
  fits interrupted and resumed are the uninterrupted ones bit for bit on
  every rank; snapshots of different iterations restart every rank with
  one warning; a 1-D mesh's or a 2 × 1 grid's snapshots in the same
  directory are not resumed.
- A ``max_iter=None`` fit whose last rank computes another elbow ends
  with the coordinator's ``max_iter`` on every rank, with one warning.
- A 1 × 1 grid in this process is the step loop on one device bit for
  bit, through ``mu.fit_scan`` and through the estimator, and its
  minibatch and checkpointed fits are the single-device ones.
"""

import functools
import os
import pickle
import socket
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpine_tpu.ops import mu as jmu
from alpine_tpu.parallel.mesh import make_gene_cell_mesh
from alpine_tpu.utils import sampling as jsmp
from alpine_tpu_torch import ALPINE, AnnData
from alpine_tpu_torch.ops import mu as tmu
from alpine_tpu_torch.parallel import distributed as tdist
from alpine_tpu_torch.parallel import mesh as tmesh
from alpine_tpu_torch.utils import sampling as tsmp

from .conftest import make_synthetic_adata
from .torch_ranks import run_ranks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_dist_grid_worker.py"
KEYS = ["batch", "condition"]
KW = dict(n_components=6, n_covariate_components=[2, 3], lam=[1.0, 2.0],
          random_state=0)
EPS = 1e-6
BLOCKS, N_LABELS = (3, 4, 6), (2, 3)
WORLD, GRID = 4, (2, 2)
COORDS = [(r // GRID[1], r % GRID[1]) for r in range(WORLD)]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _source(*parts):
    """A JAX package source with its adjacent string literals joined."""
    text = (REPO / "alpine_tpu").joinpath(*parts).read_text()
    return " ".join(text.split()).replace('" "', "")


def _labels(r, n, n_labels):
    Ys = []
    for nl in n_labels:
        y = np.zeros((nl, n), np.float32)
        y[r.integers(0, nl, n), np.arange(n)] = 1.0
        Ys.append(y)
    return Ys


def _counts(r, n, draws):
    """``draws`` balanced draws over random groups of n cells, as counts."""
    ids = r.integers(0, 4, n)
    order = np.argsort(ids, kind="stable")
    _, sizes = np.unique(ids, return_counts=True)
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    tables = (torch.from_numpy(start.astype(np.int32)),
              torch.from_numpy(sizes.astype(np.int32)))
    gen = torch.Generator()
    counts = np.stack([tmu.grouped_balanced_counts(gen.manual_seed(t), n, tables).numpy()
                       for t in range(draws)])
    return counts[:, np.argsort(order)]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


_MB_BATCH = 20  # of the f64 minibatch cases' 61 cells: batches 20, 20, 20, 1


def _first_batch_in_column_0(r, n, iters):
    """Permutations of n cells whose first batch holds only cells of
    column 0 (the first 31), so column 1's share of it is empty."""
    perms = []
    for _ in range(iters):
        first = r.permutation(31)[:_MB_BATCH]
        perms.append(np.concatenate([first, r.permutation(np.setdiff1d(np.arange(n), first))]))
    return np.stack(perms)


def _weighted_draws(r, Ys, n, iters):
    """Balanced draws with replacement (the port's probabilities) whose
    first batch holds only cells of column 0, so column 1's share of it
    is empty; draws repeat cells within a batch."""
    p = tsmp.balanced_sample_probabilities(tsmp.joint_label_ids(Ys)).astype(np.float64)
    return np.stack([np.concatenate([r.choice(31, _MB_BATCH), r.choice(n, n - _MB_BATCH,
                                                                       p=p / p.sum())])
                     for _ in range(iters)])


def _f64_cases():
    out = {}
    for name, kl, als, wf, mb in (
            ("kl", True, False, False, None), ("fro", False, False, False, None),
            ("als", True, True, False, None), ("wf", True, False, True, None),
            ("mb", True, False, False, "random"), ("mb_empty", False, False, False, "column 0"),
            ("als_mb", True, True, False, "column 0"), ("wt", True, False, False, "weighted")):
        r = np.random.default_rng(len(out))
        g, n, iters = 20, 61, 20  # 10 genes a block; 31 / 30 cells a column
        if mb:
            iters = 6
        K = sum(BLOCKS)
        case = dict(
            cfg=dict(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n, loss_kl=kl,
                     max_iter=iters, backend="plain", use_als=als, weighted_counts=wf,
                     batch_size=_MB_BATCH if mb else None, weighted=mb == "weighted"),
            X=r.random((g, n)) * 2,
            Ys=[y.astype(np.float64) for y in _labels(r, n, N_LABELS)],
            W0=r.random((g, K)) + 0.1, H0=r.random((K, n)) + 0.1,
            Bs0=[r.random((nl, k)) + 0.1 for nl, k in zip(N_LABELS, BLOCKS)],
            lam=np.asarray([2.0, 0.5]), hyper=(0.3, 0.7, 0.4, EPS))
        if wf:
            case["counts"] = _counts(r, n, iters).astype(np.float64)
        if mb == "random":
            case["perms"] = np.stack([r.permutation(n) for _ in range(iters)])
        elif mb == "weighted":
            case["perms"] = _weighted_draws(r, case["Ys"], n, iters)
        elif mb:
            case["perms"] = _first_batch_in_column_0(r, n, iters)
        out[name] = case
    return out


_JAX_ITERS = 8


def _jax_fit_cases():
    """fit_scan cases at 32 genes × 128 cells, the JAX package's initial
    state from its ``init_matrices``; weighted_fast on a group-sorted cell
    axis with the JAX package's count stream; random and ALS minibatches
    of 48 cells (batches 48, 48, 32) with the JAX package's epoch
    permutations (``jax.random.permutation`` over ``jax.random.split(key,
    max_iter)``, as its fit_scan draws them), and gathered weighted fits
    (joint: batches of 48; ALS: one batch of 128) with its balanced draws
    with replacement (``jax.random.choice`` over its probabilities)."""
    cases = {}
    for name, seed, dtype, kl, als, wf, bs in (
            ("joint", 3, "float32", True, False, False, None),
            ("fro", 4, "float32", False, False, False, None),
            ("als", 5, "float32", True, True, False, None),
            ("wf", 6, "float32", True, False, True, None),
            ("int8", 9, "int8", True, False, False, None),
            ("mb", 10, "float32", True, False, False, 48),
            ("mb_fro", 11, "float32", False, False, False, 48),
            ("mb_int8", 12, "int8", True, False, False, 48),
            ("als_mb", 13, "float32", True, True, False, 48),
            ("wt", 14, "float32", True, False, "gathered", 48),
            ("wt_als", 15, "float32", True, True, "gathered", None)):
        gathered = wf == "gathered"
        wf = wf is True
        g, n = 32, 128
        iters = 5 if dtype == "int8" else _JAX_ITERS
        r = np.random.default_rng(seed)
        if dtype == "int8":
            X = r.poisson(2.0, (g, n)).clip(0, 127).astype(np.float32)
        else:
            X = r.random((g, n), dtype=np.float32)
        Ys = _labels(r, n, N_LABELS)
        key = jax.random.PRNGKey(seed)
        tables = None
        if wf:
            order, start, sizes = jsmp.balanced_group_tables(jsmp.joint_label_ids(Ys))
            X = np.ascontiguousarray(X[:, order])
            Ys = [np.ascontiguousarray(y[:, order]) for y in Ys]
            tables = (jnp.asarray(start), jnp.asarray(sizes))
        jcfg = jmu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n, loss_kl=kl,
                            max_iter=iters, x_dtype=dtype, use_als=als,
                            weighted=wf or gathered, weighted_counts=wf, batch_size=bs)
        W0, H0, Bs0 = jmu.init_matrices(jcfg, g, jax.random.PRNGKey(seed + 100), EPS)
        hyper = ([2.0, 1.0], 0.1, 0.2, 0.3)
        case = dict(
            cfg=dict(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n, loss_kl=kl,
                     max_iter=iters, x_dtype=dtype, use_als=als, weighted_counts=wf,
                     batch_size=bs, weighted=gathered),
            X=X, Ys=Ys, W0=np.asarray(W0), H0=np.asarray(H0),
            Bs0=[np.asarray(b) for b in Bs0],
            lam=np.asarray(hyper[0], np.float32),
            hyper=tuple(float(np.float32(v)) for v in hyper[1:]) + (EPS,),
            jcfg=jcfg, key=key, tables=tables)
        if wf:
            keys = jax.random.split(key, iters)
            case["counts"] = np.stack([np.asarray(jmu.grouped_balanced_counts(
                keys[t], n, tables, n)) for t in range(iters)]).astype(np.float32)
        elif gathered:
            probs = jnp.asarray(jsmp.balanced_sample_probabilities(jsmp.joint_label_ids(Ys)))
            case["tables"] = probs  # fit_scan's weights
            case["perms"] = np.stack([np.asarray(jax.random.choice(
                k, n, shape=(n,), replace=True, p=probs))
                for k in jax.random.split(key, iters)]).astype(np.int64)
        elif bs:
            case["perms"] = np.stack([np.asarray(jax.random.permutation(k, n))
                                      for k in jax.random.split(key, iters)]).astype(np.int64)
        cases[name] = case
    return cases


def _jax_transform_cases():
    r = np.random.default_rng(7)
    g, K, n = 24, 9, 1000
    return {"transform": dict(W=r.random((g, K), dtype=np.float32),
                              X=r.random((g, n), dtype=np.float32),
                              H0=r.random((K, n), dtype=np.float32) + 0.1,
                              eps=EPS, n_iter=15)}


def _payload_cases():
    out = {}
    g, blocks, n_labels = 20, (2, 3, 4), (2, 3)
    for n in (256, 1024):
        r = np.random.default_rng(n)
        K = sum(blocks)
        out[str(n)] = dict(
            cfg=dict(blocks=blocks, n_labels=n_labels, n_cells=n, max_iter=3),
            X=r.random((g, n), dtype=np.float32), Ys=_labels(r, n, n_labels),
            W0=r.random((g, K), dtype=np.float32) + 0.1,
            H0=r.random((K, n), dtype=np.float32) + 0.1,
            Bs0=[r.random((nl, k), dtype=np.float32) + 0.1
                 for nl, k in zip(n_labels, blocks)],
            lam=np.asarray([1.0, 2.0], np.float32), hyper=(0.0, 0.0, 0.0, EPS))
    return out


def _adata_case(n_cells, seed, data_dtype="float32", max_iter=12, integer=False,
                model_kw=None, fit_kw=None):
    ad = make_synthetic_adata(n_cells=n_cells, n_genes=32, seed=seed)
    X = np.asarray(ad.X, np.float32)
    if integer:
        X = np.round(X)
    return dict(X=X, obs={k: np.asarray(ad.obs[k].to_numpy(), dtype=object) for k in KEYS},
                data_dtype=data_dtype, max_iter=max_iter, model_kw=model_kw or {},
                fit_kw=fit_kw or {})


def _port_adata(case):
    return AnnData(np.array(case["X"]), obs={k: v.copy() for k, v in case["obs"].items()})


_ESTIMATOR = {
    "96": _adata_case(96, 2),
    "95": _adata_case(95, 4),
    "fro": _adata_case(96, 6, model_kw={"loss_type": "frobenius"}),
    "als": _adata_case(96, 3, model_kw={"use_als": True}),
    "wf": _adata_case(96, 8, fit_kw={"sampling_method": "weighted_fast"}),
    "int8": _adata_case(96, 5, "int8", 5, integer=True),
    "mb": _adata_case(95, 12, fit_kw={"batch_size": 24}),
    "als_mb": _adata_case(95, 13, max_iter=6, model_kw={"use_als": True},
                          fit_kw={"batch_size": 24}),
    "wt": _adata_case(95, 14, fit_kw={"batch_size": 24, "sampling_method": "weighted"}),
    "wt_als": _adata_case(96, 15, max_iter=6, model_kw={"use_als": True},
                          fit_kw={"sampling_method": "weighted"}),
}
# int8 computes in bf16; the global-draw fits take the tolerance of
# tests/test_torch_minibatch.py's port-vs-JAX minibatch fits
_LOSS_RTOL = {"int8": 5e-4, "als_mb": 5e-4, "wt": 5e-4, "wt_als": 5e-4}


def _build_inputs():
    drop = ("jcfg", "key", "tables")
    return {
        "f64": _f64_cases(),
        "jax_fit": {k: {kk: vv for kk, vv in v.items() if kk not in drop}
                    for k, v in _jax_fit_cases().items()},
        "jax_transform": _jax_transform_cases(),
        "payload": _payload_cases(),
        "estimator": _ESTIMATOR,
        "fresh": _adata_case(61, 7),
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the worker on four gloo ranks once; returns (inputs, the ranks'
    outputs in rank order)."""
    workdir = tmp_path_factory.mktemp("torch_grid")
    inputs = _build_inputs()
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    return inputs, run_ranks(WORKER, workdir, WORLD, timeout=150)


def _whole(results, key, field="H"):
    """W's rows (gene blocks, from cell column 0) or H's columns (cell
    runs, from gene block 0) of a grid's outputs, concatenated."""
    if field == "W":
        return np.concatenate([results[r][key]["W"] for r in range(WORLD)
                               if COORDS[r][1] == 0])
    return np.concatenate([results[r][key][field] for r in range(WORLD)
                           if COORDS[r][0] == 0], axis=0 if field == "emb" else 1)


def _equal(a, b):
    if isinstance(a, list):
        return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


def _replicas_bit_equal(results, key, w_whole=False):
    """W along each gene row (every rank, once gathered whole), the Bs
    and the losses on every rank, H within each cell column."""
    loss = "L" if "L" in results[0][key] else "loss"
    for r in range(WORLD):
        for field in (loss, "Bs"):
            assert _equal(results[r][key][field], results[0][key][field]), (key, field, r)
        row_mate = r - r % GRID[1] if not w_whole else 0
        assert _equal(results[r][key]["W"], results[row_mate][key]["W"]), (key, "W", r)
        column_mate = r % GRID[1]
        assert _equal(results[r][key]["H"], results[column_mate][key]["H"]), (key, "H", r)


# ---------------------------------------------------------------------------
# the grid and its placement
# ---------------------------------------------------------------------------


def test_grid_refuses_what_it_cannot_span(ranks):
    _, results = ranks
    with pytest.raises(ValueError) as e:
        make_gene_cell_mesh(2, 3, devices=jax.devices()[:WORLD])
    for res in results:
        kind, msg = res["failures"]["grid_too_big"]
        assert (kind, msg) == ("ValueError", str(e.value)) == ("ValueError",
                                                                "need 6 devices, have 4")
        kind, msg = res["failures"]["grid_too_small"]
        assert kind == "ValueError" and "must span every process" in msg


def test_placement_on_the_grid(ranks):
    _, results = ranks
    for r, res in enumerate(results):
        gi, ci = COORDS[r]
        place = res["place"]
        assert place["coord"] == (gi, ci)
        assert place["shards"] == (2, 2, 4)
        assert place["group_ranks"] == [2 * gi, 2 * gi + 1]  # its gene row
        assert place["gene_group_ranks"] == [ci, 2 + ci]  # its cell column
        assert place["gene_range"] == (16 * gi, 16 * gi + 16)
        assert place["cell_range"] == tdist.process_cell_range(61, 2, ci)


def test_global_gene_cell_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        tdist.global_gene_cell_mesh(2, 2)


def test_gene_axis_check_matches_jax():
    """Placement.check_gene_axis raises the JAX package's message."""
    from alpine_tpu.parallel.mesh import Placement as JPlacement

    jplace = JPlacement(make_gene_cell_mesh(2, 2, devices=jax.devices()[:WORLD]))
    with pytest.raises(ValueError) as want:
        jplace.check_gene_axis(31)
    with pytest.raises(ValueError) as got:
        _grid_placement().check_gene_axis(31)
    assert str(got.value) == str(want.value)
    _grid_placement().check_gene_axis(32)


class _FakeGrid:
    """The fields of a 2 × 2 DeviceMesh that ``Placement`` reads, at
    (1, 0)."""
    ndim = 2
    shape = (2, 2)

    def get_coordinate(self):
        return [1, 0]


def _grid_placement():
    place = tmesh.Placement(torch.device("cpu"))
    place.mesh = _FakeGrid()  # is_mesh takes only a DeviceMesh
    return place


def test_placement_fields_off_and_on_a_grid():
    cpu = tmesh.Placement(torch.device("cpu"))
    assert (cpu.is_grid, cpu.cell_shards, cpu.gene_shards, cpu.gene_index,
            cpu.gene_range(31), cpu.gene_group) == (False, 1, 1, 0, (0, 31), None)
    grid = _grid_placement()
    assert (grid.is_grid, grid.cell_shards, grid.gene_shards, grid.gene_index,
            grid.process_chunk_index, grid.gene_range(32)) == (True, 2, 2, 1, 0, (16, 32))


# ---------------------------------------------------------------------------
# the step loop on the grid
# ---------------------------------------------------------------------------


def _single_steps(case):
    t = torch.from_numpy
    cfg = tmu.MUConfig(**case["cfg"])
    draw = (lambda it: t(case["counts"][it])) if "counts" in case else None
    cells = (lambda it: t(case["perms"][it])) if "perms" in case else None
    return tmu._fit_scan_steps(
        cfg, t(case["W0"]), t(case["H0"]), tuple(t(b) for b in case["Bs0"]),
        t(case["X"]), [t(y) for y in case["Ys"]], (t(case["lam"]), *case["hyper"]),
        draw, cells, None)


@pytest.mark.parametrize("name", ["kl", "fro", "als", "wf", "mb", "mb_empty", "als_mb", "wt"])
def test_grid_loop_f64_matches_single_process(ranks, name):
    inputs, results = ranks
    W, H, Bs, L = _single_steps(inputs["f64"][name])
    key = f"f64_{name}"
    _replicas_bit_equal(results, key)
    got = results[0][key]
    assert got["W"].dtype == np.float64 and got["W"].shape == (10, sum(BLOCKS))
    np.testing.assert_allclose(_whole(results, key, "W"), W.numpy(), rtol=1e-11)
    np.testing.assert_allclose(_whole(results, key), H.numpy(), rtol=1e-11)
    np.testing.assert_allclose(got["L"], L.numpy(), rtol=1e-11)
    for b, want in zip(got["Bs"], Bs):
        np.testing.assert_allclose(b, want.numpy(), rtol=1e-11)


@pytest.mark.parametrize("name", ["kl", "fro", "als", "wf"])
def test_grid_loop_all_reduces_an_iteration(ranks, name):
    """Over cells: the step (ALS: one a block) and the loss; over genes:
    the step's WᵀX and WᵀW (ALS: one a block) and, for ALS, the loss's
    WᵀW; ‖X‖² once over each axis before the loop."""
    inputs, results = ranks
    iters = inputs["f64"][name]["cfg"]["max_iter"]
    cells, genes = {"als": (len(BLOCKS) + 1, len(BLOCKS) + 1)}.get(name, (2, 1))
    for res in results:
        c = res[f"f64_{name}"]["collectives"]
        assert c["setup"]["calls"] == c["genes setup"]["calls"] == 1
        assert c["iteration"]["calls"] == cells * iters
        assert c["genes iteration"]["calls"] == genes * iters


def _column_shares(perm, lo, hi, batch=_MB_BATCH):
    """The sizes of a column's share of each batch of a permutation."""
    return [int(((b >= lo) & (b < hi)).sum())
            for b in np.array_split(perm, range(batch, len(perm), batch))]


@pytest.mark.parametrize("name", ["mb", "mb_empty"])
def test_grid_minibatch_all_reduces_an_epoch(ranks, name):
    """A minibatch epoch of nb = 4 batches: nb + 1 all-reduces over each
    axis (a batch's step, the loss).  Over genes a batch carries WᵀX_b of
    the column's share and WᵀW, K × (share + K) float64 values, and the
    loss K × (column cells + K); over cells a batch carries X Hᵀ of the
    rank's 10 genes, H Hᵀ and the B statistics, the loss its dot, H Hᵀ and
    the prediction terms, whatever the shares."""
    inputs, results = ranks
    case = inputs["f64"][name]
    iters, K = case["cfg"]["max_iter"], sum(BLOCKS)
    step = 10 * K + K * K + sum(nl * k for nl, k in zip(N_LABELS, BLOCKS)) + sum(BLOCKS[:-1])
    loss = 1 + K * K + len(N_LABELS)
    for r, res in enumerate(results):
        c = res[f"f64_{name}"]["collectives"]
        lo, hi = tdist.process_cell_range(61, 2, COORDS[r][1])
        shares = [_column_shares(p, lo, hi) for p in case["perms"]]
        assert all(len(s) == 4 for s in shares)
        assert c["iteration"]["calls"] == c["genes iteration"]["calls"] == 5 * iters
        assert c["setup"]["calls"] == c["genes setup"]["calls"] == 1
        assert c["iteration"]["bytes"] == 8 * (4 * step + loss) * iters
        assert c["genes iteration"]["bytes"] == 8 * K * sum(
            sum(w + K for w in s) + (hi - lo + K) for s in shares)
        if name == "mb_empty" and COORDS[r][1] == 1:
            assert all(s[0] == 0 for s in shares)


@pytest.mark.parametrize("name", ["als_mb", "wt"])
def test_grid_global_draw_all_reduces_an_epoch(ranks, name):
    """An ALS minibatch epoch of nb = 4 batches makes nb · n_blocks + 1
    all-reduces over each axis (n_blocks a batch, the loss), a weighted
    one nb + 1, whatever the shares (column 1's first share is empty, and
    a weighted share may repeat a cell); ‖X‖² once over each axis."""
    inputs, results = ranks
    case = inputs["f64"][name]
    iters = case["cfg"]["max_iter"]
    per_epoch = 4 * (len(BLOCKS) if case["cfg"]["use_als"] else 1) + 1
    for r, res in enumerate(results):
        c = res[f"f64_{name}"]["collectives"]
        assert c["iteration"]["calls"] == c["genes iteration"]["calls"] == per_epoch * iters
        assert c["setup"]["calls"] == c["genes setup"]["calls"] == 1
        lo, hi = tdist.process_cell_range(61, 2, COORDS[r][1])
        shares = [_column_shares(p, lo, hi) for p in case["perms"]]
        assert all(len(ws) == 4 and sum(ws) == int(((p >= lo) & (p < hi)).sum())
                   for ws, p in zip(shares, case["perms"]))
        if COORDS[r][1] == 1:
            assert all(ws[0] == 0 for ws in shares)
    if name == "wt":
        assert any(len(np.unique(p[:_MB_BATCH])) < _MB_BATCH for p in case["perms"])


def test_empty_share_launches_nothing_and_stays_in_step(ranks):
    """The fused float32 fit of the case whose first batch holds no cell
    of column 1: column 1's ranks call neither kernel wrapper for it (nor
    for any other empty share), every rank makes nb + 1 all-reduces over
    each axis an epoch, and the losses agree across the ranks and with
    the single-process fused fit on the same permutations."""
    inputs, results = ranks
    case = inputs["f64"]["mb_empty"]
    iters = case["cfg"]["max_iter"]
    t = torch.from_numpy
    f32 = lambda a: t(np.asarray(a, np.float32))  # noqa: E731
    cfg = tmu.MUConfig(**{**case["cfg"], "backend": "fused"})
    want = tmu.fit_scan(cfg, f32(case["W0"]), f32(case["H0"]),
                        tuple(f32(b) for b in case["Bs0"]), f32(case["X"]),
                        [f32(y) for y in case["Ys"]],
                        (f32(case["lam"]), *case["hyper"]),
                        draw_cells=lambda it: t(case["perms"][it]))[3]
    for r, res in enumerate(results):
        got = res["mb_empty_fused"]
        lo, hi = tdist.process_cell_range(61, 2, COORDS[r][1])
        widths = [w for p in case["perms"] for w in _column_shares(p, lo, hi) if w]
        assert [w for k, w in got["calls"] if k == "hxt"] == widths
        assert [w for k, w in got["calls"] if k == "wtx"] == sum(
            ([w for w in _column_shares(p, lo, hi) if w] + [hi - lo]
             for p in case["perms"]), [])
        c = got["collectives"]
        assert c["iteration"]["calls"] == c["genes iteration"]["calls"] == 5 * iters
        assert np.array_equal(got["L"], results[0]["mb_empty_fused"]["L"])
        np.testing.assert_allclose(got["L"], want.numpy(), rtol=1e-5)
    assert all(_column_shares(p, 31, 61)[0] == 0 for p in case["perms"])


def _jax_grid_fit(case):
    """The JAX package's fit_scan on make_gene_cell_mesh(2, 2): X
    (genes@genes, cells@cells), W (genes@genes), H and the Ys cell-sharded,
    the Bs replicated, as its estimator places them."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_gene_cell_mesh(*GRID, devices=jax.devices()[:WORLD])
    put = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))  # noqa: E731
    jcfg = case["jcfg"]
    hyper = (jnp.asarray(case["lam"]),) + tuple(jnp.float32(v) for v in case["hyper"])
    fit = jax.jit(functools.partial(jmu.fit_scan, jcfg))
    W, H, _, L = fit(put(jnp.asarray(case["W0"]), P("genes", None)),
                     put(jnp.asarray(case["H0"]), P(None, "cells")),
                     tuple(put(jnp.asarray(b), P()) for b in case["Bs0"]),
                     put(jnp.asarray(case["X"]).astype(jcfg.xdt), P("genes", "cells")),
                     tuple(put(jnp.asarray(y), P(None, "cells")) for y in case["Ys"]),
                     hyper, case["key"], case["tables"])
    return np.asarray(W), np.asarray(H), np.asarray(L)


# (loss rtol, (W rtol, atol), (H rtol, atol)): tests/test_sharding.py:74-75
# for the full-batch fits, tests/test_weighted_counts.py:494-495 for
# weighted_fast; int8 computes in bf16, held over 5 iterations at the
# loss tolerance of the int8 sharded fit (tests/test_pallas.py:409)
_JAX_TOL = {"joint": (1e-4, (5e-3, 1e-6), (5e-3, 1e-6)),
            "fro": (1e-4, (5e-3, 1e-6), (5e-3, 1e-6)),
            "als": (1e-4, (5e-3, 1e-6), (5e-3, 1e-6)),
            "wf": (5e-5, (5e-3, 1e-6), (2e-4, 1e-6)),
            "int8": (5e-4, (5e-3, 1e-6), None),
            "mb": (1e-4, (5e-3, 1e-6), (5e-3, 1e-6)),
            "mb_fro": (1e-4, (5e-3, 1e-6), (5e-3, 1e-6)),
            "mb_int8": (5e-4, (5e-3, 1e-6), None),
            "als_mb": (5e-4, (5e-3, 1e-6), (5e-3, 1e-6)),
            "wt": (5e-4, (5e-3, 1e-6), (5e-3, 1e-6)),
            "wt_als": (5e-4, (5e-3, 1e-6), (5e-3, 1e-6))}


@pytest.mark.parametrize("name", list(_JAX_TOL))
def test_grid_fit_scan_matches_jax_grid(ranks, name):
    if len(jax.devices()) < WORLD:
        pytest.skip("needs 4 virtual devices")
    _, results = ranks
    W, H, L = _jax_grid_fit(_jax_fit_cases()[name])
    key = f"jax_{name}"
    _replicas_bit_equal(results, key)
    loss_rtol, w_tol, h_tol = _JAX_TOL[name]
    np.testing.assert_allclose(results[0][key]["L"], L, rtol=loss_rtol)
    np.testing.assert_allclose(_whole(results, key, "W"), W, rtol=w_tol[0], atol=w_tol[1])
    if h_tol:
        np.testing.assert_allclose(_whole(results, key), H, rtol=h_tol[0], atol=h_tol[1])


def test_grid_transform_matches_jax_and_one_process(ranks):
    """K3's plain version on each rank's columns, after one all-reduce of
    2WᵀX and 2WᵀW over its column, against the JAX package's projection
    and the single-process port's (which differ from it by 2WᵀX's
    summation order only)."""
    inputs, results = ranks
    case = inputs["jax_transform"]["transform"]
    got = _whole(results, "jax_transform")
    want_jax = jmu.transform_scan(jnp.asarray(case["W"]), jnp.asarray(case["X"]),
                                  jnp.asarray(case["H0"]), jnp.float32(EPS),
                                  n_iter=case["n_iter"])
    np.testing.assert_allclose(got, np.asarray(want_jax), rtol=2e-3, atol=1e-5)
    t = torch.from_numpy
    want = tmu.run_transform(t(case["W"]), t(case["X"]), t(case["H0"]), EPS,
                             n_iter=case["n_iter"])
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5)
    for r, res in enumerate(results):
        c = res["jax_transform"]["collectives"]["genes transform"]
        n_loc = tdist.process_cell_range(1000, 2, COORDS[r][1])
        assert c["calls"] == 1
        assert c["bytes"] == 4 * 9 * (n_loc[1] - n_loc[0] + 9)
        assert _equal(res["jax_transform"]["H"], results[COORDS[r][1]]["jax_transform"]["H"])


def test_joint_all_reduces_follow_the_axes(ranks):
    """The joint step's genes all-reduce carries K × (local cells + K)
    values an iteration (WᵀX and WᵀW), so it grows with the cells; its
    cells all-reduces (the step's X Hᵀ of the rank's genes, H Hᵀ and the B
    statistics, then the loss's sums) do not."""
    inputs, results = ranks
    case = inputs["payload"]["256"]
    g, blocks, n_labels = case["X"].shape[0], case["cfg"]["blocks"], case["cfg"]["n_labels"]
    K, iters = sum(blocks), case["cfg"]["max_iter"]
    step = (g // 2) * K + K * K + sum(nl * k for nl, k in zip(n_labels, blocks)) \
        + sum(blocks[:-1])
    loss = 1 + K * K + len(n_labels)
    for r, res in enumerate(results):
        for n in (256, 1024):
            c = res[f"payload_{n}"]
            n_loc = n // 2
            assert c["genes iteration"]["calls"] == iters
            assert c["genes iteration"]["bytes"] == 4 * K * (n_loc + K) * iters
            assert c["iteration"]["calls"] == 2 * iters
            assert c["iteration"]["bytes"] == 4 * (step + loss) * iters
            assert c["setup"]["calls"] == c["genes setup"]["calls"] == 1


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------


def _single_process_fit(case):
    model = ALPINE(device="cpu", data_dtype=case["data_dtype"], **{**KW, **case["model_kw"]})
    ad = _port_adata(case)
    model.fit(ad, KEYS, max_iter=case["max_iter"], **case["fit_kw"])
    return model, ad


@pytest.mark.parametrize("name", list(_ESTIMATOR))
def test_estimator_matches_single_process(ranks, name):
    inputs, results = ranks
    case = inputs["estimator"][name]
    model, ad = _single_process_fit(case)
    got = results[0][f"est_{name}"]
    assert got["data_dtype"] == model.data_dtype_ == case["data_dtype"]
    np.testing.assert_allclose(got["loss"], model.loss_history_,
                               rtol=_LOSS_RTOL.get(name, 1e-4))
    if name != "int8":
        emb = _whole(results, f"est_{name}", "emb")
        np.testing.assert_allclose(emb, ad.obsm["ALPINE_embedding"], rtol=5e-3, atol=1e-5)


@pytest.mark.parametrize("name", list(_ESTIMATOR))
def test_estimator_replicas_bit_equal(ranks, name):
    """Every rank gathers the whole W, so W is equal on all four ranks
    exactly where each gene row's ranks hold bit-equal rows."""
    inputs, results = ranks
    key = f"est_{name}"
    _replicas_bit_equal(results, key, w_whole=True)
    case = inputs["estimator"][name]
    n = case["X"].shape[0]
    for r, res in enumerate(results):
        lo, hi = tdist.process_cell_range(n, 2, COORDS[r][1])
        assert res[key]["emb"].shape[0] == hi - lo
        assert res[key]["W"].shape == (32, 11)
        c = res[key]["collectives"]
        # ALS: n_blocks + 1 over each axis; minibatch and weighted: nb + 1
        # (4 batches of 95 cells, the loss); ALS minibatch nb · n_blocks + 1,
        # ALS weighted (one batch of 96 draws) n_blocks + 1
        cells, genes = {"als": (len(BLOCKS) + 1,) * 2, "mb": (5, 5), "wt": (5, 5),
                        "als_mb": (4 * len(BLOCKS) + 1,) * 2,
                        "wt_als": (len(BLOCKS) + 1,) * 2}.get(name, (2, 1))
        assert c["iteration"]["calls"] == cells * case["max_iter"]
        assert c["genes iteration"]["calls"] == genes * case["max_iter"]
        assert res[key]["timings"]["fit"] > 0


def _pickled_model(results, name="96"):
    """Rank 0's fitted model ``name``, moved to one process on the CPU."""
    model = pickle.loads(results[0]["cpu_model"][name])
    assert model.device == torch.device("cpu")
    return model


@pytest.mark.parametrize("name", ["96", "wf", "61"])
def test_grid_transform_matches_single_process(ranks, name):
    inputs, results = ranks
    model = _pickled_model(results, "wf" if name == "wf" else "96")
    case = inputs["fresh"] if name == "61" else inputs["estimator"][name]
    ad = _port_adata(case)
    model.transform(ad, n_iter=7)
    want = np.concatenate([ad.obsm[k] for k in KEYS] + [ad.obsm["ALPINE_embedding"]], axis=1)
    got = np.concatenate([results[r][f"tr_{name}"]["H"] for r in range(WORLD)
                          if COORDS[r][0] == 0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    for r in range(WORLD):  # within a column, the same projection
        assert np.array_equal(results[r][f"tr_{name}"]["H"],
                              results[COORDS[r][1]][f"tr_{name}"]["H"])
    if name == "96":
        for res in results:
            assert res["tr_96"]["cache"]
            assert res["tr_96"]["collectives"]["genes transform"]["calls"] == 1


def test_grid_model_pickle_round_trip(ranks):
    """In the ranks a pickled grid model rebuilds its grid and transforms
    as the original."""
    _, results = ranks
    for res in results:
        assert res["pickle"]["device"] == "DeviceMesh"
        assert res["pickle"]["dims"] == ("genes", "cells")
        assert res["pickle"]["shape"] == GRID
        assert np.array_equal(res["pickle"]["H"], res["tr_61"]["H"])


# (exception type, message, JAX source file holding it or None)
_REFUSALS = {
    # test_gene_axis_check_matches_jax holds this message against the JAX
    # package's
    "genes_indivisible": ("ValueError", "n_genes=31 is not divisible by the mesh's "
                          "'genes' axis (2 devices); choose a gene-axis size that divides "
                          "the gene count.", None),
    "column_differs": ("ValueError", "differs within cell column(s) [0, 1]", None),
    "tiled": ("ValueError", "tiled sampling requires joint mode on a 1-D cell mesh "
              "(or one device); use sampling_method='random'.", ("models", "alpine.py")),
    "n_restarts": ("ValueError", "n_restarts > 1 is not supported with a sharded "
                   "(Mesh) device.", ("models", "alpine.py")),
    "transform_column_differs": ("ValueError", "differs within cell column(s) [0, 1]", None),
}


# the JAX package's refusals on a multi-process mesh that the grid now
# runs: the global-draw fits (each fits on every rank) and the optimizer
# (built on every rank; tests/test_torch_optimizer_grid.py searches)
_NOW_RUN = ("weighted", "als_minibatch", "optimizer")


@pytest.mark.parametrize("name", list(_REFUSALS) + list(_NOW_RUN))
def test_refusals_raise_on_every_rank(ranks, name):
    _, results = ranks
    got = [r["failures"][name] for r in results]
    if name in _NOW_RUN:
        assert got == [None] * WORLD, got
        assert [r["failures"]["after"] for r in results] == [4.0] * WORLD
        return
    kind, message, source = _REFUSALS[name]
    assert all(g is not None for g in got), got
    assert [g[0] for g in got] == [kind] * WORLD, got
    for _, msg in got:
        assert message in msg
    if source is not None:
        assert message in _source(*source)
    # both groups outlived every refusal
    assert [r["failures"]["after"] for r in results] == [4.0] * WORLD


# ---------------------------------------------------------------------------
# snapshots and the agreed max_iter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["joint", "mb", "wt"])
def test_resumed_grid_fit_is_the_uninterrupted_one(ranks, name):
    """Joint (12 iterations, a snapshot every 4), minibatch and gathered
    weighted (6 epochs of 24-cell batches, every 2) fits interrupted after
    their first snapshot and resumed by fresh models: every rank resumes
    from that snapshot and ends bit for bit where the uninterrupted
    checkpointed fit ends (chunk c's cell draws are keyed on c), with no
    snapshot left."""
    _, results = ranks
    every = {"joint": 4, "mb": 2, "wt": 2}[name]
    for res in results:
        ck = res["checkpoint"]
        assert ck[f"{name}_first"] == "interrupted"
        assert ck[f"{name}_resumed_from"] == [every]
        for field in ("loss", "W", "H", "Bs", "emb"):
            assert _equal(ck[f"{name}_resumed"][field], ck[f"{name}_whole"][field]), field
    assert results[0]["checkpoint"]["files_left"] == []
    grid = [{"whole": r["checkpoint"][f"{name}_whole"]} for r in results]
    _replicas_bit_equal(grid, "whole", w_whole=True)
    L = grid[0]["whole"]["loss"][:, 0]
    assert np.isfinite(L).all() and L[-1] < L[0]


def test_chunked_grid_fit_is_the_plain_one(ranks):
    """The step loop carries nothing across iterations but W, H and the
    Bs, so the joint fit in chunks of 4 is the 12-iteration fit of the
    same data (est_96) bit for bit."""
    _, results = ranks
    for res in results:
        ck, plain = res["checkpoint"]["joint_whole"], res["est_96"]
        for field in ("loss", "W", "H", "Bs", "emb"):
            assert _equal(ck[field], plain[field]), field


def test_snapshot_a_rank_keyed_on_the_grid(ranks):
    """Each rank writes its own file; its key holds the grid's shape, the
    rank's place and its gene rows (and, as on a cell mesh, the process
    count, the cell layout of the columns and the column index)."""
    _, results = ranks
    paths = set()
    for r, res in enumerate(results):
        gi, ci = COORDS[r]
        for key, path in res["checkpoint"]["keys"]:
            if f"{os.sep}ck_joint{os.sep}" not in path:
                continue
            paths.add(path)
            assert tuple(key["grid"]) == GRID and tuple(key["grid_place"]) == (gi, ci)
            assert tuple(key["gene_range"]) == (16 * gi, 16 * gi + 16)
            assert key["n_processes"] == WORLD and key["cell_shards"] == GRID[1]
            assert key["process_index"] == ci and tuple(key["cell_layout"]) == (48, 48)
    assert len(paths) == WORLD


def test_other_topologies_snapshots_are_not_resumed(ranks):
    """A directory holding a 1-D cell mesh's snapshots of the same fit (4
    ranks, interrupted at iteration 4) and those a 2 × 1 grid's ranks
    would write (same gene rows as the 2 × 2 ranks): the grid loads
    nothing, runs the whole fit, and leaves the others' files."""
    _, results = ranks
    for r, res in enumerate(results):
        ck = res["checkpoint"]
        assert ck["shared_loaded"] == [None]
        for field in ("loss", "W", "H", "Bs"):
            assert _equal(ck["shared"][field], ck["joint_whole"][field]), field
        assert len(ck["shared_files"]) == WORLD + GRID[0]
        shared = {k.get("grid") and tuple(k["grid"]) for k, p in ck["keys"]
                  if f"{os.sep}ck_shared{os.sep}" in p}
        # the 2 × 1 snapshots: one a gene block, from column 0's ranks
        assert shared == {None, (2, 2)} | ({(2, 1)} if COORDS[r][1] == 0 else set())


def test_disagreeing_grid_snapshots_restart_every_rank(ranks):
    """Ranks 0-2 hold the snapshot of iteration 8, rank 3 that of 4: every
    rank restarts from scratch, only the coordinator warns, and the fit
    ends bit for bit as the uninterrupted one."""
    _, results = ranks
    assert [r["checkpoint"]["disagree_loaded"] for r in results] == [[8], [8], [8], [4]]
    assert [len(r["checkpoint"]["disagree_warnings"]) for r in results] == [1, 0, 0, 0]
    assert "iterations [4, 8]" in results[0]["checkpoint"]["disagree_warnings"][0]
    for res in results:
        for field in ("loss", "W", "H", "Bs"):
            assert _equal(res["checkpoint"]["disagree"][field],
                          res["checkpoint"]["joint_whole"][field]), field


def test_max_iter_none_takes_the_coordinators_elbow(ranks):
    """max_iter=None with the last rank's elbow moved by 3: every rank fits
    the coordinator's max_iter (so the fit ends, in step), the loss
    histories are bit-equal, and the coordinator alone warns, naming both
    elbows."""
    _, results = ranks
    first = results[0]["agreed"]
    own = [r["agreed"]["own"][0] for r in results]
    assert own[:3] == [first["own"][0]] * 3 and own[3] == own[0] + 3
    for res in results:
        got = res["agreed"]
        assert got["max_iter"] == own[0]
        assert got["loss"].shape == (own[0], 2 + len(KEYS))
        assert np.array_equal(got["loss"], first["loss"])
    assert [len(r["agreed"]["warnings"]) for r in results] == [1, 0, 0, 0]
    assert f"[{own[0]}, {own[3]}]" in first["warnings"][0]


# ---------------------------------------------------------------------------
# a 1 × 1 grid in this process
# ---------------------------------------------------------------------------


@pytest.fixture
def grid_of_one():
    tdist.initialize(f"localhost:{_free_port()}", num_processes=1, process_id=0,
                     timeout=30.0)
    try:
        yield tdist.global_gene_cell_mesh(1, 1)
    finally:
        tdist.shutdown()


@pytest.mark.parametrize("name", ["joint", "als", "wf", "mb", "als_mb", "wt"])
def test_grid_of_one_is_the_step_loop(grid_of_one, name):
    """A 1 × 1 grid runs the steps with all-reduces over groups of one,
    which change nothing: fit_scan on it is the single-device step loop
    (the kernels' plain versions here) bit for bit."""
    case = _jax_fit_cases()[name]
    t = torch.from_numpy
    cfg = tmu.MUConfig(**case["cfg"])
    draw = (lambda it: t(case["counts"][it])) if "counts" in case else None
    cells = (lambda it: t(case["perms"][it])) if "perms" in case else None
    args = (cfg, t(case["W0"]), t(case["H0"]), tuple(t(b) for b in case["Bs0"]),
            t(case["X"]), [t(y) for y in case["Ys"]],
            (t(case["lam"]), *case["hyper"]))
    place = tmesh.Placement(grid_of_one)
    tdist.reset_collectives()
    got = tmu.fit_scan(*args, draw_counts=draw, draw_cells=cells, group=place.group,
                       gene_group=place.gene_group, cell_range=(0, cfg.n_cells))
    # ALS n_blocks + 1 an iteration, minibatch and weighted 3 batches + the
    # loss an epoch, ALS minibatch 3 · n_blocks + 1
    assert tdist.collectives["genes iteration"]["calls"] == cfg.max_iter * {
        "als": len(BLOCKS) + 1, "mb": 4, "wt": 4, "als_mb": 3 * len(BLOCKS) + 1}.get(name, 1)
    want = tmu._fit_scan_steps(*args, draw, cells, None)
    for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


def test_grid_of_one_estimator_is_the_step_loop(grid_of_one, monkeypatch):
    """The estimator on a 1 × 1 grid: the fit it runs through mu.fit_scan
    is a direct step-loop call on its inputs bit for bit, and its model
    holds that fit's scaled factors."""
    seen = {}
    real = tmu.fit_scan

    def recording(cfg, W0, H0, Bs0, X, Ys, hyper, **kw):
        seen["args"] = (cfg, W0, H0, Bs0, X, Ys, hyper)
        seen["out"] = real(cfg, W0, H0, Bs0, X, Ys, hyper, **kw)
        return seen["out"]

    monkeypatch.setattr(tmu, "fit_scan", recording)
    case = _ESTIMATOR["96"]
    model = ALPINE(device=grid_of_one, **KW)
    ad = _port_adata(case)
    model.fit(ad, KEYS, max_iter=6)
    cfg, W0, H0, Bs0, X, Ys, hyper = seen["args"]
    want = tmu._fit_scan_steps(cfg, W0, H0, Bs0, X.to(cfg.xdt),
                               [y.to(cfg.xdt) for y in Ys], hyper, None, None, None)
    W, H, Bs, L = seen["out"]
    assert torch.equal(W, want[0]) and torch.equal(H, want[1]) and torch.equal(L, want[3])
    assert np.array_equal(model.loss_history_, want[3].numpy())
    Ws, Hs, _ = tmu.scale_matrices(cfg.blocks, *want[:3])
    assert np.array_equal(np.concatenate(model.matrices["Ws"], axis=1), Ws.numpy())
    assert np.array_equal(ad.obsm["ALPINE_embedding"], Hs[5:].numpy().T)


@pytest.mark.parametrize("model_kw,fit_kw", [
    ({}, {"batch_size": 24}), ({"use_als": True}, {"checkpoint_every": 4}),
    ({}, {"batch_size": 24, "checkpoint_every": 2}),
    ({"use_als": True}, {"batch_size": 24}),
    ({}, {"batch_size": 24, "sampling_method": "weighted"}),
    ({"use_als": True}, {"sampling_method": "weighted", "checkpoint_every": 3})],
    ids=["minibatch", "als_checkpoint", "minibatch_checkpoint", "als_minibatch", "weighted",
         "weighted_als_checkpoint"])
def test_grid_of_one_fits_are_single_device(grid_of_one, tmp_path, model_kw, fit_kw):
    """The estimator's minibatch (random, ALS, gathered weighted) and
    checkpointed fits on a 1 × 1 grid are the single-device fits bit for
    bit where one device runs the step loop too: the grid's global cell
    draw (and a weighted fit's probabilities, from the gathered label
    codes) is the single-device stream, the chunks draw alike, and the
    all-reduces over groups of one change nothing."""
    case = _ESTIMATOR["95"]
    out = []
    for device in ("cpu", grid_of_one):
        kw = dict(fit_kw)
        if "checkpoint_every" in kw:
            kw["checkpoint_dir"] = str(tmp_path / str(len(out)))
        model = ALPINE(device=device, **{**KW, **model_kw})
        ad = _port_adata(case)
        model.fit(ad, KEYS, max_iter=8, **kw)
        out.append((model, ad))
    (one, ad1), (grid, adg) = out
    assert np.array_equal(one.loss_history_, grid.loss_history_)
    for name in ("Ws", "Hs", "Bs"):
        assert _equal(one.matrices[name], grid.matrices[name]), name
    assert np.array_equal(ad1.obsm["ALPINE_embedding"], adg.obsm["ALPINE_embedding"])
    assert not any(os.listdir(tmp_path / d) for d in os.listdir(tmp_path))


def test_grid_of_one_resumed_joint_fit_is_the_plain_one(grid_of_one, tmp_path):
    """A joint fit on a 1 × 1 grid with a snapshot every 3 iterations of 9,
    interrupted after its first and resumed by a fresh model, is the
    uninterrupted fit of the grid without snapshots bit for bit."""
    from alpine_tpu_torch.io.checkpoint import FitCheckpointer

    case = _ESTIMATOR["96"]

    def fit(**kw):
        model = ALPINE(device=grid_of_one, **KW)
        ad = _port_adata(case)
        model.fit(ad, KEYS, max_iter=9, **kw)
        return model, ad

    plain, ad_plain = fit()
    orig_save, loaded = FitCheckpointer.save, []

    def interrupting_save(self, *args):
        orig_save(self, *args)
        raise KeyboardInterrupt

    ck = dict(checkpoint_dir=str(tmp_path), checkpoint_every=3)
    FitCheckpointer.save = interrupting_save
    try:
        with pytest.raises(KeyboardInterrupt):
            fit(**ck)
    finally:
        FitCheckpointer.save = orig_save
    orig_load = FitCheckpointer.load
    FitCheckpointer.load = lambda self: loaded.append(orig_load(self)[0]) or orig_load(self)
    try:
        resumed, ad_resumed = fit(**ck)
    finally:
        FitCheckpointer.load = orig_load
    assert loaded == [3]
    assert np.array_equal(plain.loss_history_, resumed.loss_history_)
    for name in ("Ws", "Hs", "Bs"):
        assert _equal(plain.matrices[name], resumed.matrices[name]), name
    assert np.array_equal(ad_plain.obsm["ALPINE_embedding"],
                          ad_resumed.obsm["ALPINE_embedding"])
    assert os.listdir(tmp_path) == []

"""The port's fit modes over processes beyond full-batch joint, on the
CPU: two gloo ranks (tests/torch_dist_modes_worker.py, spawned once for
the module) fit their own cells, and the parent holds what they wrote
against the single-process port and the JAX package.

- ``joint_label_codes`` (its 2^53 guard too), ``window_group_tables`` and
  ``allgather_group_layout`` against the JAX package's functions, the
  last on equal, ragged and skewed layouts (one joint group absent from
  chunk 0, as in tests/test_multiprocess.py:409-432).
- The window form of ``grouped_balanced_counts``: for 1, 2 and 3 windows
  the windows' counts, concatenated, are the full draw (in-process).
- weighted_fast: the fused loop over the group in float64 (rtol 1e-11)
  against the single process fed the same counts; the estimator on 96,
  95 and the skewed cells against the port's single-process
  weighted_fast fit (loss rtol 1e-4, embedding rtol 5e-3 atol 1e-5,
  tests/test_multiprocess.py:379-407), its first draw exactly the
  single-process draw.
- ALS: the step loop over the group in float64 (rtol 1e-11, KL and
  Frobenius), ``mu.fit_scan`` against the JAX package's ``fit_scan`` from
  the same ``jmu.init_matrices`` state (loss rtol 5e-4, factors 5e-3),
  the estimator against the single process (loss rtol 1e-4).
- Random minibatch and tiled fits at the ops level on equal shards,
  driven by the JAX package's per-shard streams, against
  ``jmu.fit_scan_minibatch_sharded`` on a 2-device CPU mesh (loss rtol
  5e-4, factors 5e-3); through the estimator every cell trained (all H
  columns differ between 3 and 6 epochs), the marked cell of a tiled fit
  back in caller order, ragged 48/47 shards, and a rank whose last batch
  is empty (12 / 9 cells, 4 batches); ``mu.fit_scan`` called directly on
  ragged minibatch and tiled shards runs the widest rank's batches.
- The all-reduces: one an iteration for weighted_fast, n_blocks + 1 for
  ALS, nb + 1 an epoch for minibatch and tiled fits, the same bytes at
  two cell counts.
- Checkpoints: the chunked fit against the plain one (rtol 1e-4), an
  interrupted fit resumed from iteration 8, a deleted rank-1 snapshot
  restarting both ranks with one warning, weighted_fast resumed bit for
  bit, tiled, ALS and minibatch checkpointed fits, the key's topology
  fields; W, the Bs and the losses bit-equal across the ranks in every
  case.
- Transforms after sharded weighted_fast, tiled and gathered weighted
  fits: through the fit's device X as without it (rtol 1e-5).
- A sampling_method that differs across the ranks raises on both.
- The global-draw fits (ALS minibatch, gathered "weighted" joint and ALS:
  every rank draws the single-device epoch and runs its share of every
  batch): the step loop in float64 on ragged shards (31 / 30 cells) with
  rank 1's share of the first batch empty and weighted draws repeating
  cells, against the single process at rtol 1e-11, with nb · n_blocks + 1
  (ALS) or nb + 1 (joint) all-reduces an epoch; a fused float32 ALS fit
  of that draw calls no kernel wrapper for the empty share; ``mu.fit_scan``
  on 51 / 50 cells fed the JAX package's own epoch draws
  (``jax.random.permutation``, or ``jax.random.choice`` over its balanced
  probabilities) from ``jmu.init_matrices``' state against its
  single-device ``fit_scan`` (loss rtol 5e-4, factors 5e-3); the
  estimator on 48 / 47 cells against the port's single-process fit (loss
  rtol 5e-4, embedding 5e-3), the label codes gathered once; snapshots
  resumed bit for bit; a world of one bit for bit the single process; a
  "weighted" fit of cells sorted by batch on each rank back in the
  caller's order (``compute_loss`` of the gathered embeddings within rtol
  2e-2 of the final loss, tests/test_sharding.py:201-233).
"""

import pickle
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpine_tpu.ops import mu as jmu
from alpine_tpu.parallel import distributed as jdist
from alpine_tpu.utils import sampling as jsampling
from alpine_tpu_torch import ALPINE, AnnData
from alpine_tpu_torch.models import alpine as talpine
from alpine_tpu_torch.ops import mu as tmu
from alpine_tpu_torch.parallel import distributed as tdist
from alpine_tpu_torch.utils import sampling as tsampling

from .test_torch_distributed import _adata_case, _free_port, _labels
from .torch_ranks import run_ranks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_dist_modes_worker.py"
KEYS = ["batch", "condition"]
KW = dict(n_components=6, n_covariate_components=[2, 3], lam=[1.0, 2.0],
          random_state=0, data_dtype="float32")
EPS = 1e-6
BLOCKS, N_LABELS = (3, 4, 6), (2, 3)
WORLD = 2
TILE = 8


class _Place:
    """The placement fields ``allgather_group_layout`` reads."""

    def __init__(self, rank, world):
        self.process_chunk_index, self.n_processes = rank, world


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _layout_codes():
    """Each rank's joint-label codes: equal, ragged, and skewed (code 3 is
    absent from chunk 0)."""
    r = np.random.default_rng(3)
    skew0 = r.choice([0, 1, 2], 48)
    skew1 = r.integers(0, 4, 48)
    skew1[:3] = 3
    return {"equal": [r.integers(0, 6, 48), r.integers(0, 6, 48)],
            "ragged": [r.integers(0, 5, 48), r.integers(1, 6, 47)],
            "skew": [skew0, skew1]}


def _state(r, g, n, blocks, n_labels, dtype):
    K = sum(blocks)
    return dict(W0=(r.random((g, K)) + 0.1).astype(dtype),
                H0=(r.random((K, n)) + 0.1).astype(dtype),
                Bs0=[(r.random((nl, k)) + 0.1).astype(dtype)
                     for nl, k in zip(n_labels, blocks)])


def _counts(r, n, draws):
    """``draws`` balanced draws over random groups, as counts."""
    ids = r.integers(0, 4, n)
    _, start, sizes = tsampling.balanced_group_tables(ids)
    tables = (torch.from_numpy(start), torch.from_numpy(sizes))
    gen = torch.Generator()
    return np.stack([tmu.grouped_balanced_counts(gen.manual_seed(t), n, tables).numpy()
                     for t in range(draws)])


def _f64_cases():
    out = {}
    for name, mode, kl in (("wf_f64", "wf", True), ("als_f64_kl", "als", True),
                           ("als_f64_fro", "als", False)):
        r = np.random.default_rng(len(out) + 20)
        g, n, iters = 20, 61, 10  # 31 / 30 cells
        case = dict(cfg=dict(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n, loss_kl=kl,
                             max_iter=iters, backend="plain", use_als=mode == "als",
                             weighted_counts=mode == "wf"),
                    X=r.random((g, n)) * 2,
                    Ys=[y.astype(np.float64) for y in _labels(r, n, N_LABELS)],
                    lam=np.asarray([2.0, 0.5]), hyper=(0.3, 0.7, 0.4, EPS), f64=True,
                    **_state(r, g, n, BLOCKS, N_LABELS, np.float64))
        if mode == "wf":
            case["counts"] = _counts(r, n, iters + 1).astype(np.float64)
        out[name] = case
    return out


_GB = 20  # of the global-draw float64 cases' 61 cells: batches 20, 20, 20, 1


def _global_f64_cases():
    """Float64 global-draw cases on 31 / 30 cells: an ALS minibatch fit
    whose epochs' first batch holds only rank 0's cells, and gathered
    weighted joint (batches of 20 draws, the first of rank 0's cells) and
    ALS (one batch of 61 draws) fits, whose draws repeat cells.  Every
    rank gets the same single-device epochs."""
    out = {}
    for name, als, weighted, bs in (("als_mb_empty_f64", True, False, _GB),
                                    ("wt_f64", False, True, _GB),
                                    ("wt_als_f64", True, True, None)):
        r = np.random.default_rng(len(out) + 40)
        g, n, iters = 20, 61, 6
        Ys = _labels(r, n, N_LABELS)
        draws = []
        for _ in range(iters):
            if weighted:
                p = tsampling.balanced_sample_probabilities(
                    tsampling.joint_label_ids(Ys)).astype(np.float64)
                d = r.choice(n, n, p=p / p.sum())
            else:
                d = r.permutation(n)
            if bs:  # the first batch from rank 0's cells alone
                first = r.choice(31, bs, replace=weighted)
                rest = d[bs:] if weighted else r.permutation(np.setdiff1d(np.arange(n), first))
                d = np.concatenate([first, rest])
            draws.append(d.astype(np.int64))
        out[name] = dict(cfg=dict(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n, max_iter=iters,
                                  backend="plain", use_als=als, weighted=weighted,
                                  batch_size=bs),
                         X=r.random((g, n)) * 2, Ys=[y.astype(np.float64) for y in Ys],
                         lam=np.asarray([2.0, 0.5]), hyper=(0.3, 0.7, 0.4, EPS), f64=True,
                         draws=[np.stack(draws)] * WORLD, **{"global": True},
                         **_state(r, g, n, BLOCKS, N_LABELS, np.float64))
    return out


def _jax_cases():
    """float32 cases from the JAX package's initial state: full-batch ALS,
    and random minibatch and tiled epochs on equal shards driven by the
    JAX package's per-shard streams (alpine_tpu/ops/mu.py:1225-1242)."""
    out = {}
    for name, n, iters, extra in (("als_jax", 96, 8, dict(use_als=True)),
                                  ("mb_jax", 128, 4, dict(batch_size=32)),
                                  ("tiled_jax", 128, 4, dict(batch_size=32, tile=TILE)),
                                  ("als_mb_jax", 101, 6, dict(use_als=True, batch_size=32)),
                                  ("wt_jax", 101, 8, dict(weighted=True, batch_size=32)),
                                  ("wt_als_jax", 101, 6, dict(weighted=True, use_als=True))):
        r = np.random.default_rng(n + iters)
        g = 24
        X = (r.gamma(2.0, 1.0, (g, 6)) @ r.gamma(2.0, 1.0, (6, n))
             + r.random((g, n))).astype(np.float32)
        Ys = _labels(r, n, N_LABELS)
        jcfg = jmu.MUConfig(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n, loss_kl=True,
                            max_iter=iters, x_dtype="float32", **extra)
        W0, H0, Bs0 = jmu.init_matrices(jcfg, g, jax.random.PRNGKey(n), EPS)
        case = dict(cfg=dict(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n, max_iter=iters,
                             **extra),
                    X=X, Ys=Ys, W0=np.asarray(W0), H0=np.asarray(H0),
                    Bs0=[np.asarray(b) for b in Bs0],
                    lam=np.asarray([2.0, 1.0], np.float32), hyper=(0.1, 0.2, 0.3, EPS),
                    jcfg=jcfg, key=jax.random.PRNGKey(7))
        if name in _GLOBAL_JAX:
            # the JAX package's single-device epochs (alpine_tpu/ops/mu.py:
            # 900-905), the same on every rank
            probs = None
            if extra.get("weighted"):
                probs = jsampling.balanced_sample_probabilities(jsampling.joint_label_ids(Ys))
                case["probs"] = probs
            keys = jax.random.split(case["key"], iters)
            epochs = np.stack([np.asarray(
                jax.random.permutation(k, n) if probs is None else
                jax.random.choice(k, n, shape=(n,), replace=True, p=jnp.asarray(probs)))
                for k in keys]).astype(np.int64)
            case["draws"], case["global"] = [epochs] * WORLD, True
        elif "batch_size" in extra:
            n_loc = n // WORLD
            units = n_loc // TILE if "tile" in extra else n_loc
            draws = []
            for s in range(WORLD):
                keys = jax.random.split(jax.random.fold_in(case["key"], s), iters)
                draws.append(np.stack([np.asarray(jax.random.permutation(k, units))
                                       for k in keys]).astype(np.int64))
            case["draws"] = draws
        out[name] = case
    return out


_GLOBAL_JAX = ("als_mb_jax", "wt_jax", "wt_als_jax")


def _payload_cases():
    """Each mode at two cell counts with the same batch count."""
    out = {}
    g, blocks, n_labels = 20, (2, 3, 4), (2, 3)
    for n in (512, 2048):
        r = np.random.default_rng(n)
        base = dict(X=r.random((g, n), dtype=np.float32), Ys=_labels(r, n, n_labels),
                    lam=np.asarray([1.0, 2.0], np.float32), hyper=(0.0, 0.0, 0.0, EPS),
                    **_state(r, g, n, blocks, n_labels, np.float32))
        cfg = dict(blocks=blocks, n_labels=n_labels, n_cells=n, max_iter=2)
        n_loc = n // WORLD
        out[f"wf_{n}"] = dict(base, cfg=dict(cfg, weighted_counts=True),
                              counts=_counts(r, n, 3).astype(np.float32))
        out[f"als_{n}"] = dict(base, cfg=dict(cfg, use_als=True))
        out[f"mb_{n}"] = dict(base, cfg=dict(cfg, batch_size=n // 4),
                              draws=[np.stack([r.permutation(n_loc) for _ in range(2)])
                                     for _ in range(WORLD)])
        out[f"tiled_{n}"] = dict(base, cfg=dict(cfg, batch_size=n // 4, tile=TILE),
                                 draws=[np.stack([r.permutation(n_loc // TILE)
                                                  for _ in range(2)])
                                        for _ in range(WORLD)])
    return out


def _ragged_cases():
    """``mu.fit_scan`` called directly on ragged shards: a random minibatch
    fit of 12 / 9 cells (nb = 4 batches of 3 draws, rank 1's last batch
    empty) and a tiled fit of 3 / 2 unpadded tiles (batches of one tile,
    rank 1's last empty)."""
    out = {}
    g, iters = 16, 6
    for name, sizes, extra in (("mb_ragged", (12, 9), dict(batch_size=6)),
                               ("tiled_ragged", (3 * TILE, 2 * TILE),
                                dict(batch_size=10, tile=TILE))):
        r = np.random.default_rng(sum(sizes))
        n = sum(sizes)
        X = (r.gamma(2.0, 1.0, (g, 4)) @ r.gamma(2.0, 1.0, (4, n))
             + r.random((g, n))).astype(np.float32)
        units = [s // TILE if "tile" in extra else s for s in sizes]
        out[name] = dict(cfg=dict(blocks=BLOCKS, n_labels=N_LABELS, n_cells=n,
                                  max_iter=iters, **extra),
                         X=X, Ys=_labels(r, n, N_LABELS),
                         lam=np.asarray([1.0, 2.0], np.float32), hyper=(0.0, 0.0, 0.0, EPS),
                         ranges=[(0, sizes[0]), (sizes[0], n)],
                         draws=[np.stack([r.permutation(u) for _ in range(iters)])
                                for u in units],
                         **_state(r, g, n, BLOCKS, N_LABELS, np.float32))
    return out


def _skew_case():
    """96 cells, two batches and two conditions; the joint group (b1, c1)
    is absent from the first 48 cells (chunk 0), while each chunk holds
    both levels of each covariate."""
    r = np.random.default_rng(11)
    n, g = 96, 32
    X = (r.gamma(2.0, 1.0, (n, 5)) @ r.gamma(2.0, 1.0, (5, g))
         + r.random((n, g))).astype(np.float32)
    pairs0 = np.array([(0, 0), (0, 1), (1, 0)])[r.integers(0, 3, 48)]
    pairs1 = np.array([(0, 0), (0, 1), (1, 0), (1, 1)])[r.integers(0, 4, 48)]
    pairs = np.concatenate([pairs0, pairs1])
    return dict(X=X, obs={"batch": np.array(["b0", "b1"], dtype=object)[pairs[:, 0]],
                          "condition": np.array(["c0", "c1"], dtype=object)[pairs[:, 1]]})


def _small_case():
    """21 cells whose rows 0:12 and 12:21 each hold every label."""
    case = _adata_case(21, 6)
    i = np.arange(21)
    case["obs"] = {"batch": np.array(["batch_0", "batch_1"], dtype=object)[i % 2],
                   "condition": np.array(["condition_0", "condition_1", "condition_2"],
                                         dtype=object)[i % 3]}
    return case


def _sorted_case():
    """160 cells × 24 genes as tests/test_sharding.py:201-233 makes them
    (120 of batch b0, 40 of b1), stored sorted by batch within each
    rank's 80 cells (70 b0 then 10 b1, 50 b0 then 30 b1): every rank
    must hold every label, so the whole axis cannot be sorted."""
    r = np.random.default_rng(3)
    n, g, k = 160, 24, 4
    X = (r.gamma(2.0, 1.0, (g, k)) @ r.gamma(2.0, 1.0, (k, n))
         + r.random((g, n))).astype(np.float32).T
    batch = np.array(["b0"] * 70 + ["b1"] * 10 + ["b0"] * 50 + ["b1"] * 30, dtype=object)
    condition = np.array(["c0", "c1", "c2"], dtype=object)[np.arange(n) % 3]
    return dict(X=X, obs={"batch": batch, "condition": condition})


SKEW_MODEL = {"n_covariate_components": [2, 2], "lam": [1.0, 1.0]}

_ESTIMATOR = {
    "wf_96": dict(data="96", fit=dict(max_iter=10, sampling_method="weighted_fast"),
                  transform=True, record_draw=True),
    "wf_95": dict(data="95", fit=dict(max_iter=10, sampling_method="weighted_fast")),
    "wf_skew": dict(data="skew", model=SKEW_MODEL,
                    fit=dict(max_iter=8, sampling_method="weighted_fast")),
    "als_96": dict(data="96", model={"use_als": True}, fit=dict(max_iter=8)),
    "als_95": dict(data="95", model={"use_als": True}, fit=dict(max_iter=8)),
    "mb_3": dict(data="96", fit=dict(max_iter=3, batch_size=24)),
    "mb_6": dict(data="96", fit=dict(max_iter=6, batch_size=24)),
    "tiled_3": dict(data="96", fit=dict(max_iter=3, batch_size=24, sampling_method="tiled")),
    "tiled_6": dict(data="96", fit=dict(max_iter=6, batch_size=24, sampling_method="tiled")),
    "mb_95": dict(data="95", fit=dict(max_iter=6, batch_size=24)),
    "tiled_95": dict(data="95", fit=dict(max_iter=6, batch_size=24, sampling_method="tiled"),
                     transform=True),
    "tiled_marked": dict(data="96", mark=5,
                         fit=dict(max_iter=6, batch_size=24, sampling_method="tiled")),
    # 12 and 9 cells, 4 batches of 3 draws: rank 1's last batch is empty
    "empty_batch": dict(data="21", ranges=[(0, 12), (12, 21)],
                        fit=dict(max_iter=3, batch_size=6)),
    # 9 and 9 cells, nb = 4 but 3 draws a batch: a fourth batch would be
    # empty on both ranks (and zero W), so the epoch runs 3
    "short_epoch": dict(data="21", ranges=[(0, 9), (9, 18)],
                        fit=dict(max_iter=3, batch_size=5)),
    # the global-draw fits on 48 / 47 cells
    "als_mb_95": dict(data="95", model={"use_als": True}, fit=dict(max_iter=6, batch_size=24)),
    "wt_95": dict(data="95", fit=dict(max_iter=6, batch_size=24, sampling_method="weighted"),
                  transform=True),
    "wt_als_95": dict(data="95", model={"use_als": True},
                      fit=dict(max_iter=6, sampling_method="weighted")),
    "wt_sorted": dict(data="sorted", cpu_model=True,
                      fit=dict(max_iter=15, batch_size=40, sampling_method="weighted")),
}
_GLOBAL_EST = ("als_mb_95", "wt_95", "wt_als_95")


def _build_inputs():
    ops = {**_f64_cases(), **_global_f64_cases(),
           **{k: {kk: vv for kk, vv in v.items() if kk not in ("jcfg", "key")}
              for k, v in _jax_cases().items()}, **_ragged_cases()}
    return {
        "layout": _layout_codes(),
        "ops": ops,
        "payload": _payload_cases(),
        "data": {"96": _adata_case(96, 2), "95": _adata_case(95, 4),
                 "21": _small_case(), "skew": _skew_case(), "sorted": _sorted_case()},
        "estimator": _ESTIMATOR,
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the worker on two gloo ranks once; returns (inputs, [rank 0's
    outputs, rank 1's])."""
    workdir = tmp_path_factory.mktemp("torch_dist_modes")
    inputs = _build_inputs()
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    return inputs, run_ranks(WORKER, workdir, WORLD, timeout=100)


def _cat(results, key, field="H", axis=1):
    return np.concatenate([res[key][field] for res in results], axis=axis)


def _same_across_ranks(results, key, fields):
    for field in fields:
        a = results[0][key][field]
        for res in results[1:]:
            b = res[key][field]
            if isinstance(a, list):
                assert all(np.array_equal(x, y) for x, y in zip(a, b)), (key, field)
            else:
                assert np.array_equal(a, b), (key, field)


# ---------------------------------------------------------------------------
# the sampler's tables and layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("radices", [(2,), (2, 3), (4, 1, 5), (7, 3)])
def test_joint_label_codes_match_jax(radices):
    r = np.random.default_rng(sum(radices))
    Ys = _labels(r, 57, radices)
    Ys[0][:, :2] = 0.0  # all-zero columns take argmax 0
    got = tsampling.joint_label_codes(Ys)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jsampling.joint_label_codes(Ys))
    # sorting by code is the group order of joint_label_ids
    order = np.argsort(got, kind="stable")
    np.testing.assert_array_equal(
        np.argsort(tsampling.joint_label_ids(Ys), kind="stable"), order)


def test_joint_label_codes_refuse_past_2_53():
    Ys = [np.zeros((2 ** 27, 0), np.float32), np.zeros((2 ** 26, 0), np.float32)]
    with pytest.raises(ValueError) as want:
        jsampling.joint_label_codes(Ys)
    with pytest.raises(ValueError) as got:
        tsampling.joint_label_codes(Ys)
    assert str(got.value) == str(want.value)
    assert "exceeds 2^53" in str(got.value)
    with pytest.raises(ValueError, match="at least one"):
        tsampling.joint_label_codes([])


@pytest.mark.parametrize("n_windows", [1, 2, 3])
@pytest.mark.parametrize("seed", range(4))
def test_window_group_tables_match_jax(n_windows, seed):
    r = np.random.default_rng(seed)
    sizes = r.integers(0, 9, 6)
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    base = r.integers(0, 20, 6)
    width = -(-int(sizes.sum()) // n_windows) + seed
    got = tsampling.window_group_tables(start, sizes, base, n_windows, width)
    want = jsampling.window_group_tables(start, sizes, base, n_windows, width)
    assert got.dtype == np.int32 and got.shape == (n_windows, 3, 6)
    np.testing.assert_array_equal(got, want)


def _jax_layout(codes, monkeypatch):
    """The JAX package's allgather_group_layout, each rank a thread whose
    host allgather is a barrier over the threads."""
    world = len(codes)
    barrier = threading.Barrier(world)
    slots, local, out = {}, threading.local(), [None] * world

    def allgather(row):
        i = local.calls
        local.calls += 1
        slots[(i, local.rank)] = np.asarray(row)
        barrier.wait()
        return np.stack([slots[(i, r)] for r in range(world)])

    def run(rank):
        local.rank, local.calls = rank, 0
        out[rank] = jdist.allgather_group_layout(_Place(rank, world), codes[rank])

    monkeypatch.setattr(jdist, "process_allgather_rows", allgather)
    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    return out


@pytest.mark.parametrize("name", ["equal", "ragged", "skew"])
def test_group_layout_matches_jax(ranks, name, monkeypatch):
    inputs, results = ranks
    codes = inputs["layout"][name]
    want = _jax_layout(codes, monkeypatch)
    for rank, res in enumerate(results):
        g_codes, m_gp = res[f"layout_{name}"]
        np.testing.assert_array_equal(g_codes, want[rank][0])
        np.testing.assert_array_equal(m_gp, want[rank][1])
        assert g_codes.dtype == np.int64 and m_gp.dtype == np.int64
    if name == "skew":
        g_codes, m_gp = results[0]["layout_skew"]
        assert m_gp[0, list(g_codes).index(3)] == 0


@pytest.mark.parametrize("n_windows", [1, 2, 3])
@pytest.mark.parametrize("seed", range(6))
def test_window_counts_concatenate_to_the_full_draw(n_windows, seed):
    """Every window draws the same n uniforms from the same seed and keeps
    its own cells' draws: the windows' counts, concatenated, are the full
    form's counts integer for integer."""
    r = np.random.default_rng(seed)
    n = 40 + 23 * seed
    ids = r.integers(0, 2 + seed, n)
    _, start, sizes = tsampling.balanced_group_tables(ids)
    gen = torch.Generator()
    full = tmu.grouped_balanced_counts(
        gen.manual_seed(seed), n, (torch.from_numpy(start), torch.from_numpy(sizes)))
    assert full.sum() == n
    width = -(-n // n_windows)
    tabs = tsampling.window_group_tables(start, sizes, np.zeros_like(sizes),
                                         n_windows, width)
    parts = []
    for w, (start_loc, off, m_loc) in enumerate(tabs):
        tables = tuple(torch.from_numpy(np.asarray(a, np.int32))
                       for a in (start_loc, sizes, off, m_loc))
        parts.append(tmu.grouped_balanced_counts(
            gen.manual_seed(seed), n, tables, n_out=min(width, n - w * width)))
    assert torch.equal(torch.cat(parts), full)


# ---------------------------------------------------------------------------
# the fit loops over the group
# ---------------------------------------------------------------------------


def _single_f64(case):
    t = torch.from_numpy
    cfg = tmu.MUConfig(**case["cfg"])
    args = (cfg, t(case["W0"]), t(case["H0"]), tuple(t(b) for b in case["Bs0"]),
            t(case["X"]), [t(y) for y in case["Ys"]], (t(case["lam"]), *case["hyper"]))
    if cfg.weighted_counts:
        return tmu._fit_scan_fused(*args, lambda it: t(case["counts"][it]), None)
    return tmu._fit_scan_steps(*args, None, None, None)


@pytest.mark.parametrize("name", ["wf_f64", "als_f64_kl", "als_f64_fro"])
def test_sharded_f64_matches_single_process(ranks, name):
    inputs, results = ranks
    W, H, Bs, L = _single_f64(inputs["ops"][name])
    key = f"ops_{name}"
    _same_across_ranks(results, key, ("W", "Bs", "L"))
    got = results[0][key]
    assert got["W"].dtype == np.float64
    np.testing.assert_allclose(got["W"], W.numpy(), rtol=1e-11)
    np.testing.assert_allclose(_cat(results, key), H.numpy(), rtol=1e-11)
    np.testing.assert_allclose(got["L"], L.numpy(), rtol=1e-11)
    for b, want in zip(got["Bs"], Bs):
        np.testing.assert_allclose(b, want.numpy(), rtol=1e-11)


def _single_global(case, backend=None):
    """The single-process step loop (or, with ``backend``, ``fit_scan`` in
    float32) fed a global-draw case's epochs."""
    t = torch.from_numpy
    cfg = tmu.MUConfig(**{**case["cfg"], **({"backend": backend} if backend else {})})
    cells = lambda it: t(case["draws"][0][it])  # noqa: E731
    if backend:
        f32 = lambda a: t(np.asarray(a, np.float32))  # noqa: E731
        return tmu.fit_scan(cfg, f32(case["W0"]), f32(case["H0"]),
                            tuple(f32(b) for b in case["Bs0"]), f32(case["X"]),
                            [f32(y) for y in case["Ys"]], (f32(case["lam"]), *case["hyper"]),
                            draw_cells=cells)
    return tmu._fit_scan_steps(
        cfg, t(case["W0"]), t(case["H0"]), tuple(t(b) for b in case["Bs0"]), t(case["X"]),
        [t(y) for y in case["Ys"]], (t(case["lam"]), *case["hyper"]), None, cells, None)


def _shares(draw, batch, lo, hi):
    """The cells of [lo, hi) in each ``batch``-draw batch of an epoch."""
    return [int(((b >= lo) & (b < hi)).sum())
            for b in np.array_split(draw, range(batch, len(draw), batch))]


@pytest.mark.parametrize("name", ["als_mb_empty_f64", "wt_f64", "wt_als_f64"])
def test_global_draw_f64_matches_single_process(ranks, name):
    """Each rank runs its share of every batch of the single-device epoch
    (rank 1's share of the first batch empty, weighted draws repeating
    cells within a batch): W, the Bs and the losses bit-equal across the
    ranks and, with H, the single process's at rtol 1e-11; nb · n_blocks +
    1 (ALS) or nb + 1 all-reduces an epoch, and one before the loop (the
    global draw needs no widest rank)."""
    inputs, results = ranks
    case = inputs["ops"][name]
    W, H, Bs, L = _single_global(case)
    key = f"ops_{name}"
    _same_across_ranks(results, key, ("W", "Bs", "L"))
    got = results[0][key]
    assert got["W"].dtype == np.float64
    np.testing.assert_allclose(got["W"], W.numpy(), rtol=1e-11)
    np.testing.assert_allclose(_cat(results, key), H.numpy(), rtol=1e-11)
    np.testing.assert_allclose(got["L"], L.numpy(), rtol=1e-11)
    for b, want in zip(got["Bs"], Bs):
        np.testing.assert_allclose(b, want.numpy(), rtol=1e-11)
    cfg = case["cfg"]
    nb = -(-cfg["n_cells"] // (cfg["batch_size"] or cfg["n_cells"]))
    per_epoch = nb * (len(BLOCKS) if cfg["use_als"] else 1) + 1
    for res in results:
        c = res[key]["collectives"]
        assert c["iteration"]["calls"] == per_epoch * cfg["max_iter"]
        assert c["setup"]["calls"] == 1
    if cfg["batch_size"]:
        assert all(_shares(d, _GB, 31, 61)[0] == 0 for d in case["draws"][0])
    if cfg["weighted"]:  # a cell drawn twice into one batch
        assert any(len(np.unique(d[:_GB])) < _GB for d in case["draws"][0])


def test_empty_share_launches_nothing_and_stays_in_step(ranks):
    """A fused float32 ALS minibatch fit of the case whose first batch
    holds no cell of rank 1: rank 1 calls neither kernel wrapper for that
    share (nor for any other empty one), every rank makes nb · n_blocks + 1
    all-reduces an epoch, and the losses agree across the ranks and with
    the single-process fused fit of the same epochs."""
    inputs, results = ranks
    case = inputs["ops"]["als_mb_empty_f64"]
    iters = case["cfg"]["max_iter"]
    want = _single_global(case, backend="fused")[3]
    for rank, res in enumerate(results):
        got = res["als_mb_empty_fused"]
        lo, hi = tdist.process_cell_range(61, WORLD, rank)
        shares = [[w for w in _shares(d, _GB, lo, hi) if w] for d in case["draws"][0]]
        assert [w for k, w in got["calls"] if k == "hxt"] == sum(shares, [])
        assert [w for k, w in got["calls"] if k == "wtx"] == sum(
            ([w for w in ws for _ in BLOCKS] + [hi - lo] for ws in shares), [])
        assert got["collectives"]["iteration"]["calls"] == (4 * len(BLOCKS) + 1) * iters
        assert np.array_equal(got["L"], results[0]["als_mb_empty_fused"]["L"])
        np.testing.assert_allclose(got["L"], want.numpy(), rtol=1e-5)
    assert all(len(_shares(d, _GB, 31, 61)) == 4 for d in case["draws"][0])


def _jax_reference(case):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    jcfg = case["jcfg"]
    hyper = (jnp.asarray(case["lam"]),) + tuple(jnp.float32(v) for v in case["hyper"])
    W0, H0 = jnp.asarray(case["W0"]), jnp.asarray(case["H0"])
    Bs0 = tuple(jnp.asarray(b) for b in case["Bs0"])
    X, Ys = jnp.asarray(case["X"]), tuple(jnp.asarray(y) for y in case["Ys"])
    if jcfg.batch_size is None or case.get("global"):
        probs = case.get("probs")
        W, H, _, L = jmu.fit_scan(jcfg, W0, H0, Bs0, X, Ys, hyper, case["key"],
                                  None if probs is None else jnp.asarray(probs))
    else:
        mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("cells",))
        sh = lambda a: jax.device_put(a, NamedSharding(mesh, P(None, "cells")))  # noqa: E731
        rp = lambda a: jax.device_put(a, NamedSharding(mesh, P()))  # noqa: E731
        W, H, _, L = jmu.fit_scan_minibatch_sharded(
            jcfg, mesh, rp(W0), sh(H0), tuple(rp(b) for b in Bs0), sh(X),
            tuple(sh(y) for y in Ys), hyper, case["key"])
    return np.asarray(W), np.asarray(H), np.asarray(L)


@pytest.mark.parametrize("name", ["als_jax", "mb_jax", "tiled_jax", *_GLOBAL_JAX])
def test_sharded_modes_match_jax(ranks, name):
    """ALS against the JAX package's fit_scan, random minibatch and tiled
    epochs against its shard-local fit_scan_minibatch_sharded driven by
    the same per-shard permutations, and the global-draw fits (ALS
    minibatch, gathered weighted joint and ALS on 51 / 50 cells) against
    its single-device fit_scan, each rank fed the epochs that fit draws
    from its key: loss rtol 5e-4, W and H 5e-3."""
    if len(jax.devices()) < WORLD:
        pytest.skip("needs 2 virtual devices")
    _, results = ranks
    case = _jax_cases()[name]
    W, H, L = _jax_reference(case)
    key = f"ops_{name}"
    _same_across_ranks(results, key, ("W", "Bs", "L"))
    got = results[0][key]
    np.testing.assert_allclose(got["L"], L, rtol=5e-4)
    np.testing.assert_allclose(got["W"], W, rtol=5e-3, atol=1e-6)
    np.testing.assert_allclose(_cat(results, key), H, rtol=5e-3, atol=1e-6)


@pytest.mark.parametrize("mode", ["wf", "als", "mb", "tiled"])
def test_all_reduces_an_iteration_independent_of_cells(ranks, mode):
    """weighted_fast: one all-reduce an iteration; ALS: n_blocks + 1 (the
    step's n_blocks and the loss's); minibatch and tiled: nb + 1 an epoch.
    ‖X‖² goes once before the loop (with the fused loop's other setup
    sums; a minibatch or tiled fit also takes the widest rank's units
    there, in a MAX of its own), and the bytes do not depend on the cell
    count."""
    inputs, results = ranks
    case = inputs["payload"][f"{mode}_512"]
    iters, n_blocks = case["cfg"]["max_iter"], len(case["cfg"]["blocks"])
    calls = {"wf": 1, "als": n_blocks + 1, "mb": 4 + 1, "tiled": 4 + 1}[mode] * iters
    for res in results:
        small, big = res[f"payload_{mode}_512"], res[f"payload_{mode}_2048"]
        for summary in (small, big):
            assert summary["iteration"]["calls"] == calls
            assert summary["setup"]["calls"] == (2 if mode in ("mb", "tiled") else 1)
        for tag in ("setup", "iteration"):
            assert small[tag]["bytes"] == big[tag]["bytes"], tag
    assert results[0][f"payload_{mode}_512"] == results[1][f"payload_{mode}_512"]


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------


def _port_adata(case, X=None):
    return AnnData(np.array(case["X"] if X is None else X),
                   obs={k: np.asarray(v).copy() for k, v in case["obs"].items()})


def _single_process_fit(inputs, name):
    spec = _ESTIMATOR[name]
    model = ALPINE(device="cpu", **{**KW, **spec.get("model", {})})
    ad = _port_adata(inputs["data"][spec["data"]])
    model.fit(ad, KEYS, **spec["fit"])
    return model, ad


@pytest.mark.parametrize("name", list(_ESTIMATOR))
def test_estimator_replicas_bit_equal(ranks, name):
    """W, the Bs and the losses are computed from the same all-reduced
    sums on every rank, so they are bit-equal; each rank's embedding holds
    its own cells."""
    inputs, results = ranks
    key = f"est_{name}"
    _same_across_ranks(results, key, ("W", "loss", "Bs"))
    spec = _ESTIMATOR[name]
    n = len(inputs["data"][spec["data"]]["X"])
    ranges = spec.get("ranges") or [tdist.process_cell_range(n, WORLD, i)
                                    for i in range(WORLD)]
    assert [r[key]["emb"].shape[0] for r in results] == [hi - lo for lo, hi in ranges]
    assert all(np.isfinite(r[key]["loss"]).all() for r in results)


@pytest.mark.parametrize("name", ["wf_96", "wf_95", "wf_skew", "als_96", "als_95"])
def test_estimator_matches_single_process(ranks, name):
    inputs, results = ranks
    model, ad = _single_process_fit(inputs, name)
    key = f"est_{name}"
    _same_across_ranks(results, key, ("W", "loss", "Bs"))
    np.testing.assert_allclose(results[0][key]["loss"], model.loss_history_, rtol=1e-4)
    emb = _cat(results, key, "emb", axis=0)
    np.testing.assert_allclose(emb, ad.obsm["ALPINE_embedding"], rtol=5e-3, atol=1e-5)
    iters = _ESTIMATOR[name]["fit"]["max_iter"]
    per_iteration = 4 if name.startswith("als") else 1  # ALS: 3 blocks + the loss
    for res in results:
        c = res[key]["collectives"]
        assert c["iteration"]["calls"] == per_iteration * iters
        assert c["setup"]["calls"] == 1


@pytest.mark.parametrize("name", _GLOBAL_EST)
def test_global_draw_estimator_matches_single_process(ranks, name):
    """ALS minibatch and gathered weighted (joint: batches of 24; ALS: one
    batch of 95 draws) fits on 48 / 47 cells: the single-process
    trajectory up to summation order (loss rtol 5e-4, embedding 5e-3);
    nb · n_blocks + 1 (ALS) or nb + 1 all-reduces an epoch and one before
    the loop; a weighted fit gathers the cells' label codes once (8 bytes a
    cell of the widest rank, from every rank)."""
    inputs, results = ranks
    model, ad = _single_process_fit(inputs, name)
    key = f"est_{name}"
    _same_across_ranks(results, key, ("W", "loss", "Bs"))
    np.testing.assert_allclose(results[0][key]["loss"], model.loss_history_, rtol=5e-4)
    emb = _cat(results, key, "emb", axis=0)
    np.testing.assert_allclose(emb, ad.obsm["ALPINE_embedding"], rtol=5e-3, atol=1e-5)
    spec = _ESTIMATOR[name]
    als = spec.get("model", {}).get("use_als", False)
    weighted = spec["fit"].get("sampling_method") == "weighted"
    nb = -(-95 // spec["fit"].get("batch_size", 95))
    per_epoch = nb * (len(BLOCKS) if als else 1) + 1
    for res in results:
        c = res[key]["collectives"]
        assert c["iteration"]["calls"] == per_epoch * spec["fit"]["max_iter"]
        assert c["setup"]["calls"] == 1
        if weighted:
            assert c["labels gather"]["calls"] == 1
            assert c["labels gather"]["bytes"] == 8 * WORLD * (2 + 48)
        else:
            assert "labels gather" not in c


def test_weighted_fit_of_sorted_cells_comes_back_in_caller_order(ranks):
    """tests/test_sharding.py:201-233 on a 2-rank cell mesh: a weighted fit
    (15 epochs of 40 draws) of cells stored sorted by batch; the loss
    recomputed on the host from the ranks' embeddings, concatenated in the
    caller's order, agrees with the fit's final loss within rtol 2e-2."""
    inputs, results = ranks
    key = "est_wt_sorted"
    L = results[0][key]["loss"][:, 0]
    assert np.isfinite(L).all() and L[-1] < L[0]
    model = pickle.loads(results[0][key]["cpu_model"])
    ad = _port_adata(inputs["data"]["sorted"])
    blocks = np.concatenate([res[key]["blocks"] for res in results])
    edges = np.cumsum([0] + KW["n_covariate_components"] + [KW["n_components"]])
    for i, k in enumerate(KEYS + ["ALPINE_embedding"]):
        ad.obsm[k] = blocks[:, edges[i]:edges[i + 1]]
        ad.varm[k if i < len(KEYS) else "ALPINE_weights"] = model.matrices["Ws"][i]
    recomputed = float(model.compute_loss(ad))
    assert np.isclose(recomputed, L[-1], rtol=2e-2), (recomputed, L[-1])


def test_weighted_fast_first_draw_is_the_single_process_draw(ranks):
    """The ranks' first draws, in caller order and concatenated, are the
    single-process first draw integer for integer."""
    inputs, results = ranks
    case = inputs["data"]["96"]
    Ys = [y.T for y in talpine.FeatureEncoders(KEYS).fit_transform(_port_adata(case).obs)]
    order, start, sizes = tsampling.balanced_group_tables(tsampling.joint_label_ids(Ys))
    tables = (torch.from_numpy(start), torch.from_numpy(sizes))
    want = talpine.draw_counts_stream(tables, 96, 0, torch.device("cpu"))(0).numpy()
    got = np.concatenate([res["est_wf_96"]["first_draw"] for res in results])
    np.testing.assert_array_equal(got, want[np.argsort(order)])
    assert got.sum() == 96


@pytest.mark.parametrize("mode", ["mb", "tiled"])
def test_every_cell_is_trained(ranks, mode):
    """An untrained cell would keep its H column between a 3- and a
    6-epoch fit (tests/test_multiprocess.py:350-366)."""
    _, results = ranks
    for res in results:
        h3, h6 = res[f"est_{mode}_3"]["H"], res[f"est_{mode}_6"]["H"]
        assert h3.shape == h6.shape == (11, 48)
        assert (h3 != h6).any(axis=0).all()
        L = res[f"est_{mode}_6"]["loss"][:, 0]
        assert np.isfinite(L).all() and L[-1] < L[0]


def test_tiled_marked_cell_comes_back_in_caller_order(ranks):
    _, results = ranks
    for res in results:
        emb = res["est_tiled_marked"]["blocks"]
        assert emb.shape == (48, 11)
        assert np.linalg.norm(emb, axis=1).argmax() == 5


# all-reduces an epoch: a random minibatch epoch's nb = 4 batches and the
# loss's; a tiled epoch of 48 or 47 cells has one tile of 128 a rank, so
# one batch and the loss's; the short epoch's 3 batches and the loss's
@pytest.mark.parametrize("name,calls", [("mb_95", 5), ("tiled_95", 2), ("empty_batch", 5),
                                        ("short_epoch", 4)])
def test_ragged_shards_and_empty_batches(ranks, name, calls):
    """48 / 47 cells, and 12 / 9 cells in 4 batches of 3 draws (rank 1's
    last batch empty): the ranks stay in step, W and the losses
    bit-equal."""
    _, results = ranks
    key = f"est_{name}"
    _same_across_ranks(results, key, ("W", "loss", "Bs"))
    spec = _ESTIMATOR[name]["fit"]
    L = results[0][key]["loss"][:, 0]
    assert np.isfinite(L).all() and L[-1] < L[0]
    for res in results:
        assert res[key]["collectives"]["iteration"]["calls"] == calls * spec["max_iter"]
    if name == "empty_batch":
        assert [r[key]["emb"].shape[0] for r in results] == [12, 9]


@pytest.mark.parametrize("name,batches", [("mb_ragged", 4), ("tiled_ragged", 3)])
def test_fit_scan_on_ragged_shards_runs_the_widest_ranks_batches(ranks, name, batches):
    """``mu.fit_scan`` given a group and ragged shards, and nothing of the
    other ranks' widths: the ranks agree on the widest rank's units before
    the loop and run its batches (rank 1's last one empty), so their
    collectives stay in step, W and the losses bit-equal, and every cell
    is trained."""
    inputs, results = ranks
    case = inputs["ops"][name]
    key = f"ops_{name}"
    _same_across_ranks(results, key, ("W", "Bs", "L"))
    iters = case["cfg"]["max_iter"]
    for (lo, hi), res in zip(case["ranges"], results):
        c = res[key]["collectives"]
        assert c["setup"]["calls"] == 2  # ‖X‖² and the widest rank's units
        assert c["iteration"]["calls"] == (batches + 1) * iters
        assert (res[key]["H"] != case["H0"][:, lo:hi]).any(axis=0).all()
    L = results[0][key]["L"][:, 0]
    assert np.isfinite(L).all() and L[-1] < L[0]


@pytest.mark.parametrize("name", ["wf_96", "tiled_95", "wt_95"])
def test_cached_transform_after_sharded_fit(ranks, name):
    _, results = ranks
    for res in results:
        hit, cached = res[f"est_{name}"]["cached"]
        assert hit
        np.testing.assert_allclose(cached, res[f"est_{name}"]["uncached"],
                                   rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _plain_joint(inputs, iters):
    model = ALPINE(device="cpu", **KW)
    ad = _port_adata(inputs["data"]["96"])
    model.fit(ad, KEYS, max_iter=iters)
    return model, ad


def test_chunked_and_resumed_fits(ranks):
    """Snapshots every 4 iterations of 12: the chunked fit against the
    plain one (rtol 1e-4, tests/test_multiprocess.py:132-160); a fit
    interrupted after iteration 8 resumes from 8 on both ranks."""
    inputs, results = ranks
    model, ad = _plain_joint(inputs, 12)
    for res in results:
        ck = res["checkpoint"]
        assert ck["first"] == "interrupted"
        assert ck["resumed_from"] == [8]
        assert ck["files_left"] == []
    for name in ("chunked", "resumed"):
        np.testing.assert_allclose(results[0]["checkpoint"][name]["loss"],
                                   model.loss_history_, rtol=1e-4)
        emb = np.concatenate([r["checkpoint"][name]["emb"] for r in results])
        np.testing.assert_allclose(emb, ad.obsm["ALPINE_embedding"], rtol=5e-3, atol=1e-5)
        assert np.array_equal(results[0]["checkpoint"][name]["W"],
                              results[1]["checkpoint"][name]["W"])


def test_disagreeing_snapshots_restart_every_rank(ranks):
    """Rank 1's snapshot deleted: both ranks restart from scratch, the
    coordinator alone warns, and the fit ends without a deadlock."""
    inputs, results = ranks
    model, _ = _plain_joint(inputs, 12)
    assert [r["checkpoint"]["disagree_loaded"] for r in results] == [[8], [None]]
    assert [len(r["checkpoint"]["disagree_warnings"]) for r in results] == [1, 0]
    assert "restarting the fit from scratch on every rank" in \
        results[0]["checkpoint"]["disagree_warnings"][0]
    np.testing.assert_allclose(results[0]["checkpoint"]["disagree"]["loss"],
                               model.loss_history_, rtol=1e-4)


def test_sampled_checkpointed_fits(ranks):
    """weighted_fast interrupted after its first snapshot and resumed is
    the uninterrupted checkpointed fit bit for bit (chunk c's streams are
    keyed on c); checkpointed tiled, ALS and minibatch fits run, their
    replicas bit-equal."""
    _, results = ranks
    for res in results:
        ck = res["checkpoint"]
        assert ck["wf_first"] == "interrupted" and ck["wf_resumed_from"] == [4]
        assert np.array_equal(ck["wf_resumed"]["loss"], ck["wf_plain"]["loss"])
        assert np.array_equal(ck["wf_resumed"]["emb"], ck["wf_plain"]["emb"])
        for name in ("tiled", "als", "minibatch"):
            L = ck[name]["loss"][:, 0]
            assert L.shape == (4,) and np.isfinite(L).all() and L[-1] < L[0]
            assert np.array_equal(ck[name]["W"], results[0]["checkpoint"][name]["W"])


@pytest.mark.parametrize("name", ["wt", "als_mb"])
def test_global_draw_fits_resume_bit_for_bit(ranks, name):
    """Gathered weighted and ALS minibatch fits (6 epochs, a snapshot every
    2) interrupted after their first snapshot and resumed by fresh models
    on both ranks are the uninterrupted checkpointed fits bit for bit
    (chunk c's draws are keyed on c on every rank)."""
    _, results = ranks
    for res in results:
        ck = res["checkpoint"]
        assert ck[f"{name}_first"] == "interrupted" and ck[f"{name}_resumed_from"] == [2]
        for field in ("loss", "W", "H", "emb"):
            assert np.array_equal(ck[f"{name}_resumed"][field], ck[f"{name}_plain"][field])
        assert all(np.array_equal(a, b) for a, b in zip(ck[f"{name}_resumed"]["Bs"],
                                                        ck[f"{name}_plain"]["Bs"]))
        assert np.array_equal(ck[f"{name}_plain"]["W"],
                              results[0]["checkpoint"][f"{name}_plain"]["W"])


def test_checkpoint_key_holds_the_topology(ranks):
    _, results = ranks
    for rank, res in enumerate(results):
        keys = [k for k, _ in res["checkpoint"]["keys"]]
        assert keys
        for key in keys:
            assert key["cell_shards"] == WORLD and key["n_processes"] == WORLD
            assert key["process_index"] == rank
            assert tuple(key["cell_layout"]) == (48, 48)
    paths = {p for res in results for _, p in res["checkpoint"]["keys"]
             if "ck_plain" in p}
    assert len(paths) == WORLD  # a file a rank in the shared directory


def test_mixed_sampling_method_raises_on_every_rank(ranks):
    _, results = ranks
    got = [r["mixed_sampling"] for r in results]
    assert [g[0] for g in got] == ["ValueError"] * WORLD, got
    assert all("sampling_method" in g[1] and "differs across processes" in g[1]
               for g in got)
    assert [r["after"] for r in results] == [float(WORLD)] * WORLD


def test_world_of_one_weighted_fast_and_als_are_single_device():
    """A mesh of one process: weighted_fast and ALS fits equal the
    single-device ones bit for bit (the all-reduces change nothing)."""
    tdist.initialize(f"localhost:{_free_port()}", num_processes=1, process_id=0,
                     timeout=30.0)
    try:
        mesh = tdist.global_cell_mesh()
        case = _adata_case(96, 2)
        for model_kw, fit_kw in (({}, dict(sampling_method="weighted_fast")),
                                 ({"use_als": True}, {})):
            out = []
            for device in ("cpu", mesh):
                model = ALPINE(device=device, **{**KW, **model_kw})
                ad = _port_adata(case)
                model.fit(ad, KEYS, max_iter=6, **fit_kw)
                out.append((model.loss_history_, ad.obsm["ALPINE_embedding"]))
            assert np.array_equal(out[0][0], out[1][0])
            assert np.array_equal(out[0][1], out[1][1])
    finally:
        tdist.shutdown()


@pytest.mark.parametrize("model_kw,fit_kw", [
    ({"use_als": True}, dict(batch_size=24)),
    ({}, dict(sampling_method="weighted", batch_size=24)),
    ({"use_als": True}, dict(sampling_method="weighted"))],
    ids=["als_minibatch", "weighted", "weighted_als"])
def test_world_of_one_global_draw_fits_are_single_device(model_kw, fit_kw):
    """A mesh of one process: the ALS minibatch and gathered weighted fits
    draw the single-device epochs and their all-reduces change nothing, so
    they equal the single-device fits bit for bit."""
    tdist.initialize(f"localhost:{_free_port()}", num_processes=1, process_id=0,
                     timeout=30.0)
    try:
        mesh = tdist.global_cell_mesh()
        case = _adata_case(95, 4)
        out = []
        for device in ("cpu", mesh):
            model = ALPINE(device=device, **{**KW, **model_kw})
            ad = _port_adata(case)
            model.fit(ad, KEYS, max_iter=5, **fit_kw)
            out.append((model, ad))
        (one, ad1), (meshed, adm) = out
        assert np.array_equal(one.loss_history_, meshed.loss_history_)
        for field in ("Ws", "Bs"):
            assert all(np.array_equal(a, b) for a, b in zip(one.matrices[field],
                                                            meshed.matrices[field]))
        assert np.array_equal(ad1.obsm["ALPINE_embedding"], adm.obsm["ALPINE_embedding"])
    finally:
        tdist.shutdown()

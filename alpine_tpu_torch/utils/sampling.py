"""Class-balanced sampling tables of the port (host-side numpy).

The port's own copy of the parts of ``alpine_tpu/utils/sampling.py`` that
the balanced samplers need: the joint covariate label of each cell, the
balanced per-cell probabilities of the reference sampler (sklearn
``compute_sample_weight("balanced")`` normalized as torch's
``WeightedRandomSampler`` does; ``sampling_method="weighted"``), and the
group-sort tables of the grouped sampler
(``alpine_tpu_torch.ops.mu.grouped_balanced_counts``; "weighted_fast"),
with the canonical joint-label codes from which a fit over processes
builds the global draw (weighted_fast's window tables; the gathered
weighted fit's global probabilities, from every cell's code).  The draws
themselves happen on the device.  The reference sampler's host helpers
(string joint labels, an epoch's indices, its batches and their count)
are kept with the same bits for the same ``np.random.Generator``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def joint_label_ids(Ys: Sequence[np.ndarray]) -> np.ndarray:
    """Joint label id of each cell.  ``Ys[i]`` is (labels_i, cells); a
    cell's id identifies its tuple of per-covariate argmaxes (all-zero
    columns take argmax 0).  Ids are the ranks of the tuples in
    lexicographic order (``np.unique`` over rows), so they are
    collision-free for any number of covariates and labels."""
    if not Ys:
        raise ValueError("joint_label_ids requires at least one dummy matrix")
    codes = np.stack([np.argmax(Y, axis=0) for Y in Ys], axis=1)
    _, ids = np.unique(codes, axis=0, return_inverse=True)
    return ids.astype(np.int64).reshape(-1)


def create_joint_labels_from_dummy_matrices(Ys: Sequence[np.ndarray]) -> List[str]:
    """String joint labels of the reference helper: 'cov{i}_label{j}'
    parts joined with '+', one a cell."""
    argmaxes = [np.argmax(np.asarray(Y), axis=0) for Y in Ys]
    n = argmaxes[0].shape[0] if argmaxes else 0
    return [
        "+".join(f"cov{t}_label{argmaxes[t][s]}" for t in range(len(Ys)))
        for s in range(n)
    ]


def balanced_sample_probabilities(joint_ids: np.ndarray) -> np.ndarray:
    """Per-cell probabilities of the balanced sampler:
    w_i = n / (n_groups · count[group_i]), normalized to sum 1.  Any
    integer naming each cell's joint group will do: ``joint_label_ids``
    and ``joint_label_codes`` of the same cells give the same bits."""
    _, inv, counts = np.unique(joint_ids, return_inverse=True, return_counts=True)
    w = len(joint_ids) / (len(counts) * counts[inv].astype(np.float64))
    w /= w.sum()
    return w.astype(np.float32)


def joint_label_codes(Ys: Sequence[np.ndarray]) -> np.ndarray:
    """Joint label code of each cell, the same on every process: a
    mixed-radix integer over the per-covariate argmaxes, first covariate
    most significant, which is the lexicographic order
    ``joint_label_ids`` ranks by.  A fit over processes agrees on the
    global group enumeration from these codes without exchanging cells;
    they travel between processes as float64, so the radix product must
    stay below 2^53."""
    if not Ys:
        raise ValueError("joint_label_codes requires at least one dummy matrix")
    radices = [int(Y.shape[0]) for Y in Ys]
    prod = 1
    for r in radices:
        prod *= max(r, 1)
    if prod >= 2 ** 53:
        raise ValueError(
            "multi-process weighted_fast needs a canonical joint-label code, "
            f"but the joint label space ({'x'.join(map(str, radices))} = "
            f"{prod}) exceeds 2^53; use sampling_method='random' or fewer/"
            "coarser covariates."
        )
    code = np.zeros(Ys[0].shape[1], dtype=np.int64)
    for Y in Ys:
        code = code * int(Y.shape[0]) + np.argmax(Y, axis=0).astype(np.int64)
    return code


def window_group_tables(start_span: np.ndarray, sizes_span: np.ndarray,
                        base_off: np.ndarray, n_windows: int,
                        width: int) -> np.ndarray:
    """Per-window [start_loc, off, m_loc] tables of the grouped sampler's
    window form (``grouped_balanced_counts`` with 4-tuple tables): one
    contiguous group-sorted span of cells (a process's cells) cut into
    ``n_windows`` windows of ``width`` columns.

    ``start_span[g]``/``sizes_span[g]`` are group g's start column and
    cell count within the span; ``base_off[g]`` is the span's own offset
    within the group (the group's cells in earlier processes).  Returns
    int32 (n_windows, 3, J): window w covers span columns [w·width,
    (w+1)·width) and holds group g's global within-group positions [off,
    off + m_loc) at local columns [start_loc, start_loc + m_loc)."""
    start = np.asarray(start_span, np.int64)[None, :]
    size = np.asarray(sizes_span, np.int64)[None, :]
    base = np.asarray(base_off, np.int64)[None, :]
    w = np.arange(int(n_windows), dtype=np.int64)[:, None] * int(width)
    lo = np.clip(w, start, start + size)
    hi = np.clip(w + int(width), start, start + size)
    return np.stack([lo - w, base + (lo - start), hi - lo],
                    axis=1).astype(np.int32)


def check_group_sizes(sizes: np.ndarray) -> None:
    """The grouped sampler draws a within-group position as
    floor(float32 uniform · m_g); at 2^24 cells per group float32
    granularity would leave some positions unreachable."""
    if len(sizes) and int(np.max(sizes)) >= 2 ** 24:
        raise ValueError(
            f"weighted_fast supports joint-label groups up to 2^24 cells "
            f"(largest group here: {int(np.max(sizes))}); use "
            "sampling_method='weighted' for larger groups."
        )


def balanced_group_tables(joint_ids: np.ndarray):
    """(order, start, sizes) of the grouped sampler: ``order`` sorts cells
    by joint group (stable, so within-group caller order is kept), after
    which group g occupies columns [start[g], start[g] + sizes[g])."""
    ids = np.asarray(joint_ids)
    order = np.argsort(ids, kind="stable")
    _, sizes = np.unique(ids, return_counts=True)
    check_group_sizes(sizes)
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return (order.astype(np.int64), start.astype(np.int32),
            sizes.astype(np.int32))


def generate_epoch_indices(
    joint_labels, sampling_method: str, rng: np.random.Generator
) -> np.ndarray:
    """One epoch's cell indices on the host, as the reference sampler draws
    them: a permutation ("random"), or n balanced draws with replacement
    over the joint labels ("weighted"; the probabilities renormalized in
    float64, which ``rng.choice`` needs to sum to 1 within its
    tolerance)."""
    n = len(joint_labels)
    if sampling_method == "random":
        return rng.permutation(n)
    if sampling_method == "weighted":
        _, ids = np.unique(np.asarray(joint_labels), return_inverse=True)
        p64 = balanced_sample_probabilities(ids).astype(np.float64)
        return rng.choice(n, size=n, replace=True, p=p64 / p64.sum())
    raise ValueError(
        f"Unknown sampling method: {sampling_method}. Only 'weighted', and 'random' are supported."
    )


def get_batch_indices(epoch_indices: np.ndarray, batch_num: int, batch_size: int) -> np.ndarray:
    """Batch ``batch_num`` of an epoch: a contiguous chunk of its indices
    (empty past the end)."""
    start = batch_num * batch_size
    end = min(start + batch_size, len(epoch_indices))
    if start >= len(epoch_indices):
        return np.empty(0, dtype=np.int64)
    return epoch_indices[start:end]


def get_num_batches(total_samples: int, batch_size: int) -> int:
    """The batches of an epoch: ceil(total_samples / batch_size)."""
    return (total_samples + batch_size - 1) // batch_size

"""Class-balanced sampling tables of the port (host-side numpy).

The port's own copy of the parts of ``alpine_tpu/utils/sampling.py`` that
``sampling_method="weighted_fast"`` needs: the joint covariate label of
each cell, the balanced per-cell probabilities of the reference sampler
(sklearn ``compute_sample_weight("balanced")`` normalized as torch's
``WeightedRandomSampler`` does), and the group-sort tables of the grouped
sampler (``alpine_tpu_torch.ops.mu.grouped_balanced_counts``).  The draws
themselves happen on the device.
"""

from __future__ import annotations

from typing import Sequence

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


def balanced_sample_probabilities(joint_ids: np.ndarray) -> np.ndarray:
    """Per-cell probabilities of the balanced sampler:
    w_i = n / (n_groups · count[group_i]), normalized to sum 1."""
    _, inv, counts = np.unique(joint_ids, return_inverse=True, return_counts=True)
    w = len(joint_ids) / (len(counts) * counts[inv].astype(np.float64))
    w /= w.sum()
    return w.astype(np.float32)


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

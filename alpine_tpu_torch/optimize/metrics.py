"""The port's own copies of the three scikit-learn functions the
ComponentOptimizer calls (scikit-learn 1.x), in numpy, so the search runs
where scikit-learn is not installed:

- ``stratified_kfold``: ``StratifiedKFold(n_splits, shuffle,
  random_state).split(X, y)`` (``_make_test_folds``): classes numbered in
  order of first appearance, each class's fold labels dealt round robin
  over the sorted classes and shuffled with
  ``np.random.RandomState(random_state)``, with sklearn's warning and
  ``ValueError``s;
- ``adjusted_rand_score`` (the pair confusion matrix) and
  ``homogeneity_score`` (mutual information over the contingency table,
  natural logarithms), with sklearn's special cases.
"""

from __future__ import annotations

import warnings
from math import log
from typing import List, Optional, Tuple

import numpy as np


def stratified_kfold(labels, n_splits: int, shuffle: bool = False,
                     random_state: Optional[int] = None
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(train, test) index pairs of sklearn's ``StratifiedKFold`` over the
    class ``labels`` (1-D, binary or multiclass)."""
    if not isinstance(n_splits, (int, np.integer)):
        raise ValueError(
            "The number of folds must be of Integral type. "
            "%s of type %s was passed." % (n_splits, type(n_splits)))
    n_splits = int(n_splits)
    if n_splits <= 1:
        raise ValueError(
            "k-fold cross-validation requires at least one train/test split "
            "by setting n_splits=2 or more, got n_splits={0}.".format(n_splits))
    if not isinstance(shuffle, bool):
        raise TypeError("shuffle must be True or False; got {0}".format(shuffle))
    if not shuffle and random_state is not None:
        raise ValueError(
            "Setting a random_state has no effect since shuffle is False. "
            "You should leave random_state to its default (None), or set "
            "shuffle=True.")
    y = np.asarray(labels)
    if y.ndim != 1:
        raise ValueError("labels must be 1-D")
    n = len(y)
    if n_splits > n:
        raise ValueError(
            "Cannot have number of splits n_splits={0} greater than the "
            "number of samples: n_samples={1}.".format(n_splits, n))
    # classes in order of first appearance
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv.reshape(-1)]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    min_groups = np.min(y_counts)
    if np.all(n_splits > y_counts):
        raise ValueError(
            "n_splits=%d cannot be greater than the number of members in "
            "each class." % n_splits)
    if n_splits > min_groups:
        warnings.warn(
            "The least populated class in y has only %d members, which is "
            "less than n_splits=%d." % (min_groups, n_splits), UserWarning)
    # each fold's share of each class: round robin over the sorted classes
    y_order = np.sort(y_encoded)
    allocation = np.asarray([
        np.bincount(y_order[i::n_splits], minlength=n_classes)
        for i in range(n_splits)])
    rng = np.random.RandomState(random_state)
    test_folds = np.empty(n, dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        if shuffle:
            rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    indices = np.arange(n)
    return [(indices[test_folds != i], indices[test_folds == i])
            for i in range(n_splits)]


def _contingency(labels_true, labels_pred) -> np.ndarray:
    """Dense (classes × clusters) int64 count table."""
    a, b = np.asarray(labels_true), np.asarray(labels_pred)
    if a.ndim != 1 or b.ndim != 1:
        raise ValueError("labels must be 1-D")
    if len(a) != len(b):
        raise ValueError(
            "Found input variables with inconsistent numbers of samples: "
            f"[{len(a)}, {len(b)}]")
    classes, ci = np.unique(a, return_inverse=True)
    clusters, ki = np.unique(b, return_inverse=True)
    table = np.zeros((len(classes), len(clusters)), np.int64)
    np.add.at(table, (ci.reshape(-1), ki.reshape(-1)), 1)
    return table


def adjusted_rand_score(labels_true, labels_pred) -> float:
    """Rand index adjusted for chance (sklearn's pair-confusion form)."""
    table = _contingency(labels_true, labels_pred)
    n = int(table.sum())
    n_c, n_k = table.sum(axis=1), table.sum(axis=0)
    sum_squares = int((table.astype(np.int64) ** 2).sum())
    tp = sum_squares - n
    fp = int((table @ n_k).sum()) - sum_squares
    fn = int((table.T @ n_c).sum()) - sum_squares
    tn = n * n - fp - fn - sum_squares
    if fn == 0 and fp == 0:  # empty data or full agreement
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def _entropy(labels) -> float:
    """Entropy of a labeling, natural logarithm."""
    if len(labels) == 0:
        return 1.0
    pi = np.unique(labels, return_counts=True)[1].astype(np.float64)
    if pi.size == 1:  # a single cluster has zero entropy
        return 0.0
    pi_sum = np.sum(pi)
    return float(-np.sum((pi / pi_sum) * (np.log(pi) - log(pi_sum))))


def _mutual_info(table: np.ndarray) -> float:
    """Mutual information of a contingency table (sklearn's formula over
    the non-zero cells, row-major)."""
    nzx, nzy = np.nonzero(table)
    nz_val = table[nzx, nzy]
    total = table.sum()
    pi, pj = table.sum(axis=1), table.sum(axis=0)
    if pi.size == 1 or pj.size == 1:
        return 0.0
    log_contingency_nm = np.log(nz_val)
    contingency_nm = nz_val / total
    outer = pi.take(nzx).astype(np.int64) * pj.take(nzy).astype(np.int64)
    log_outer = -np.log(outer) + log(pi.sum()) + log(pj.sum())
    mi = (contingency_nm * (log_contingency_nm - log(total))
          + contingency_nm * log_outer)
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def homogeneity_score(labels_true, labels_pred) -> float:
    """How far each cluster holds members of a single class: MI / H(C),
    1.0 when the classes have zero entropy or there are no samples."""
    table = _contingency(labels_true, labels_pred)
    if len(np.asarray(labels_true)) == 0:
        return 1.0
    entropy_c = _entropy(np.asarray(labels_true))
    mi = _mutual_info(table)
    return float(mi / entropy_c if entropy_c else 1.0)

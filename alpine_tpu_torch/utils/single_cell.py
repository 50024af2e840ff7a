"""Per-cell total-count normalization (the port's own copy of
``alpine_tpu/utils/single_cell.py:normalize_total``, the scanpy
``sc.pp.normalize_total`` rule that ``get_normalized_expression`` applies).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def library_size_factors(counts: np.ndarray,
                         target_sum: Optional[float] = None) -> np.ndarray:
    """float32 factors scaling each cell's total ``counts`` to
    ``target_sum``: the median of the non-zero totals when None (scanpy's
    default, 1.0 when every total is zero); all-zero cells keep factor
    ``target_sum``, as they divide by 1."""
    counts = np.asarray(counts, dtype=np.float32)
    if target_sum is None:
        nz = counts[counts > 0]
        target_sum = float(np.median(nz)) if nz.size else 1.0
    safe = np.where(counts == 0, np.float32(1.0), counts)
    return (target_sum / safe).astype(np.float32)


def normalize_total(X: np.ndarray, target_sum: Optional[float] = None) -> np.ndarray:
    """Per-cell total-count normalization of (cells x genes) X."""
    X = np.asarray(X, dtype=np.float32)
    return (X * library_size_factors(X.sum(axis=1), target_sum)[:, None]).astype(
        np.float32)

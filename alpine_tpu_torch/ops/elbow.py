"""Kneedle elbow detection (the port's own copy of ``alpine_tpu/ops/elbow.py``).

``fit(max_iter=None)`` picks the iteration count at the elbow of the
log10 reconstruction-loss curve of a 200-iteration warm-up fit, as
``KneeLocator(curve="convex", direction="decreasing",
interp_method="polynomial", polynomial_degree=2)`` would: polynomial
smoothing, min-max normalization, transformation to a concave-increasing
curve, and the first threshold-surviving local maximum of the difference
curve (Satopaa et al., 2011).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _normalize(v: np.ndarray) -> np.ndarray:
    vmin, vmax = float(v.min()), float(v.max())
    if vmax == vmin:
        return np.zeros_like(v)
    return (v - vmin) / (vmax - vmin)


def find_elbow(
    y: np.ndarray,
    curve: str = "convex",
    direction: str = "decreasing",
    polynomial_degree: int = 2,
    S: float = 1.0,
) -> Optional[int]:
    """Return the x-index of the knee/elbow of ``y`` (x = 0..len(y)-1),
    or None if no elbow is found."""
    y = np.asarray(y, dtype=np.float64)
    n = len(y)
    if n < 3:
        return None
    x = np.arange(n, dtype=np.float64)

    coeffs = np.polyfit(x, y, polynomial_degree)
    y_s = np.polyval(coeffs, x)

    x_n = _normalize(x)
    y_n = _normalize(y_s)

    if curve == "convex" and direction == "decreasing":
        y_t = 1.0 - y_n
        flip_x = False
    elif curve == "concave" and direction == "increasing":
        y_t = y_n
        flip_x = False
    elif curve == "concave" and direction == "decreasing":
        y_t = y_n[::-1]
        flip_x = True
    elif curve == "convex" and direction == "increasing":
        y_t = (1.0 - y_n)[::-1]
        flip_x = True
    else:
        raise ValueError(f"unknown curve/direction: {curve}/{direction}")

    d = y_t - x_n  # difference curve
    # on a straight line d is 0 up to rounding; snap the noise so no knee is
    # invented where kneed (exact zeros) reports none
    d[np.abs(d) < 1e-12] = 0.0

    interior = np.arange(1, n - 1)
    is_max = (d[interior] >= d[interior - 1]) & (d[interior] >= d[interior + 1])
    maxima = interior[is_max]
    is_min = (d[interior] <= d[interior - 1]) & (d[interior] <= d[interior + 1])
    minima = set(interior[is_min].tolist())
    if maxima.size == 0:
        return None

    # kneed's offline traversal: each local max resets the threshold to
    # d_max - S*mean(dx), each local min zeroes it, and the first point
    # below the active threshold declares the last thresholded max the knee
    threshold_drop = S * np.mean(np.diff(x_n))
    maxima_set = set(maxima.tolist())
    threshold = 0.0
    threshold_index = int(maxima[0])
    for i in range(int(maxima[0]), n - 1):
        if i in maxima_set:
            threshold = d[i] - threshold_drop
            threshold_index = i
        if i in minima:
            threshold = 0.0
        if d[i + 1] < threshold:
            idx = threshold_index
            return (n - 1 - idx) if flip_x else idx
    return None

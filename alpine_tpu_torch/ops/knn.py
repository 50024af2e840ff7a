"""Exact k-nearest-neighbours of every row of an embedding.

Counterpart of ``alpine_tpu/ops/knn.py``, which the ComponentOptimizer's
CV scoring uses for the 15-NN graph of each validation fold.  That module
is XLA in JAX (no Pallas), so the port's search is plain PyTorch on the
given device: one (n × n) blocked distance computation, ``2·n²·d``
multiply-adds streamed a block of columns at a time with a running
top-(2k+8) merge, so the full distance matrix never materialises.

Semantics match ``sklearn.neighbors.NearestNeighbors(n_neighbors=k)`` on
the fit data: euclidean distances, self included (pinned first), ascending
order, ties broken by lower index.  Candidate SELECTION uses the
``|x|² + |y|² − 2·x·y`` expansion in true float32 (``torch.matmul`` with
TF32 off) on MEAN-CENTRED coordinates: distances are translation-invariant,
and centring shrinks the expansion's cancellation error from
``~d·2⁻²⁴·‖x‖²`` (NMF embeddings are non-negative, far from the origin) to
the same bound at the data's own radius.  The selected candidates are then
REFINED by direct subtraction of the raw rows, which is exactly zero for
duplicate rows (UMAP's rho downstream depends on it) and accurate at the
difference's own scale for near neighbours.  A true neighbour is lost only
if more than the 2k+8 candidates crowd within the expansion's noise of the
k-th distance.

With ``device=None`` the search runs on the host in numpy float64 (the
same selection and refinement, float64 throughout), in place of the JAX
package's scikit-learn host search.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from alpine_tpu_torch.ops.mu import matmul_precision


def _candidates(k: int, n_pad: int) -> int:
    """Candidates kept per row: the expansion ranks 2k+8, the refinement
    re-measures them exactly."""
    return min(2 * k + 8, n_pad)


def _host_knn(emb: np.ndarray, k: int, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """The float64 host search: selection on centred coordinates a block of
    rows at a time, refinement by direct subtraction, order by (distance,
    index) with self first."""
    X = np.asarray(emb, np.float64)
    n = X.shape[0]
    ks = _candidates(k, n)
    Xc = X - X.mean(axis=0)
    sq = np.einsum("ij,ij->i", Xc, Xc)
    Xt2 = -2.0 * Xc.T
    dist = np.empty((n, k), np.float64)
    idx = np.empty((n, k), np.int64)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        rows = np.arange(lo, hi)
        # |y|² − 2x·y ranks a row's candidates as the squared distance does
        # (|x|² is the same along the row), in two passes over the block
        d2 = Xc[lo:hi] @ Xt2
        d2 += sq[None, :]
        d2[rows - lo, rows] = -np.inf  # self ranks first
        cand = (np.argpartition(d2, ks - 1, axis=1)[:, :ks] if ks < n
                else np.broadcast_to(np.arange(n), (hi - lo, n)))
        diff = X[lo:hi, None, :] - X[cand]
        exact = np.einsum("ijk,ijk->ij", diff, diff)
        key = np.where(cand == rows[:, None], -1.0, exact)
        order = np.lexsort((cand, key), axis=1)[:, :k]
        idx[lo:hi] = np.take_along_axis(cand, order, axis=1)
        dist[lo:hi] = np.sqrt(np.take_along_axis(exact, order, axis=1))
    return dist, idx


def _device_knn(X: torch.Tensor, mean: torch.Tensor, n: int, k: int,
                block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocked float32 search on X's device (X is (n_pad, d), rows past
    n are padding)."""
    n_pad = X.shape[0]
    dev = X.device
    ks = _candidates(k, n_pad)
    Xc = X - mean[None, :]
    sq = (Xc * Xc).sum(dim=1)
    row_ids = torch.arange(n_pad, device=dev)
    best_s = torch.full((n_pad, ks), -math.inf, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n_pad, ks), dtype=torch.int64, device=dev)
    with matmul_precision("highest"):
        for base in range(0, n_pad, block):
            cols = torch.arange(base, base + block, device=dev)
            s = 2.0 * (Xc @ Xc[base:base + block].T) - sq[:, None] - sq[None, base:base + block]
            s = torch.where(cols[None, :] < n, s, -math.inf)
            # self always ranks first (the expansion can leave dust there)
            s = torch.where(cols[None, :] == row_ids[:, None], math.inf, s)
            bs, bpos = torch.topk(s, min(ks, block), dim=1)
            cat_s = torch.cat([best_s, bs], dim=1)
            cat_i = torch.cat([best_i, cols[bpos]], dim=1)
            best_s, mpos = torch.topk(cat_s, ks, dim=1)
            best_i = torch.gather(cat_i, 1, mpos)
        # refine by direct subtraction of the raw rows, a block of rows at
        # a time (the (rows, ks, d) gather never spans all n)
        d2 = torch.empty((n_pad, ks), dtype=torch.float32, device=dev)
        for lo in range(0, n_pad, block):
            diff = X[lo:lo + block, None, :] - X[best_i[lo:lo + block]]
            d2[lo:lo + block] = (diff * diff).sum(dim=-1)
    unfilled = best_s == -math.inf
    d2 = torch.where(unfilled, math.inf, d2)
    # ascending refined distance, lower index first on ties, self pinned
    # first (unfilled slots carry index 0 and must not take row 0's pin)
    key = torch.where((best_i == row_ids[:, None]) & ~unfilled, -1.0, d2)
    o1 = torch.sort(best_i, dim=1, stable=True).indices
    o2 = torch.sort(torch.gather(key, 1, o1), dim=1, stable=True).indices
    order = torch.gather(o1, 1, o2)[:, :k]
    d2 = torch.gather(d2, 1, order)
    return torch.sqrt(torch.clamp(d2, min=0.0))[:n], torch.gather(best_i, 1, order)[:n]


def exact_knn(emb: np.ndarray, k: int, device=None,
              block: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """Exact euclidean kNN of every row of ``emb`` against all rows (self
    included).  Returns (distances float64, indices int64), each (n,
    min(k, n)), ascending.  Runs on ``device`` (a ``torch.device``); None
    runs the float64 host search."""
    emb = np.ascontiguousarray(np.asarray(emb, dtype=np.float32))
    n, d = emb.shape
    k = min(k, n)
    if k <= 0 or n == 0:
        return np.zeros((n, 0), np.float64), np.zeros((n, 0), np.int64)
    block = max(min(block, 1 << (max(n - 1, 1)).bit_length()), 8)
    if device is None:
        return _host_knn(emb, k, min(block, 512))
    n_pad = int(math.ceil(n / block)) * block
    X = torch.zeros((n_pad, d), dtype=torch.float32)
    X[:n] = torch.from_numpy(emb)
    # the mean over the real rows (float64 accumulation), used only to
    # centre the selection's coordinates
    mean = torch.from_numpy(emb.mean(axis=0, dtype=np.float64).astype(np.float32))
    dist, idx = _device_knn(X.to(device), mean.to(device), n, k, block)
    return dist.cpu().numpy().astype(np.float64), idx.cpu().numpy()

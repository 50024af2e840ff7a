"""Embedding scoring for the ComponentOptimizer CV objective.

The port's own copy of ``alpine_tpu/optimize/scoring.py`` (numpy and scipy,
no scikit-learn or pandas).  The reference scores a validation fold by
clustering the unguided embedding (``sc.pp.neighbors(use_rep=
'ALPINE_embedding')`` + ``sc.tl.leiden(flavor="igraph", resolution=1)``)
and summing ARI + homogeneity between the clusters and each covariate's
labels (the reference's ``alpine/optimization.py:271-278``).  This module
provides:

- `knn_graph`: 15-NN graph on the embedding weighted with UMAP
  fuzzy-simplicial-set connectivities (smooth-kNN bandwidth search per
  point, fuzzy union symmetrization W + Wᵀ − W∘Wᵀ) — the same construction
  scanpy's default `sc.pp.neighbors` uses.  The kNN search is
  ``alpine_tpu_torch/ops/knn.py``: on the card when a device is given,
  else the float64 host search.
- `leiden`: Leiden clustering via the native C++ library
  (``alpine_tpu_torch/native/leiden.cpp``) with a pure-Python Louvain
  fallback where it cannot be built (``native.leiden_backend()``).
- `embedding_score`: the ARI + homogeneity sum, NA rows masked
  (optimization.py:275), with the port's copies of scikit-learn's two
  scores (``optimize/metrics.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from alpine_tpu_torch.native import leiden_native
from alpine_tpu_torch.ops.knn import exact_knn
from alpine_tpu_torch.optimize.metrics import adjusted_rand_score, homogeneity_score
from alpine_tpu_torch.utils.adata import is_na


def _smooth_knn_bandwidths(dist: np.ndarray, n_iter: int = 64):
    """UMAP smooth-kNN distances (McInnes et al.): per point, rho = distance
    to the nearest *distinct* neighbor (local_connectivity=1 — duplicate
    points contribute zero distances and are skipped) and sigma solving
    sum_j exp(-max(0, d_ij - rho)/sigma) = log2(n_neighbors), where
    n_neighbors counts the point itself (umap/scanpy convention).
    `dist` is (n, k) sorted ascending, self excluded — so the target is
    log2(k + 1).  Sigma is floored at MIN_K_DIST_SCALE=1e-3 times the
    point's mean kNN distance (self's zero included in the mean), falling
    back to the global mean when every neighbor is a duplicate (rho = 0)."""
    n, k = dist.shape
    target = np.log2(k + 1)
    pos = dist > 0.0
    any_pos = pos.any(axis=1)
    rho = np.where(any_pos, dist[np.arange(n), np.argmax(pos, axis=1)], 0.0)
    lo = np.zeros(n)
    hi = np.full(n, np.inf)
    mid = np.ones(n)
    for _ in range(n_iter):
        psum = np.exp(-np.maximum(dist - rho[:, None], 0.0) / mid[:, None]).sum(axis=1)
        too_high = psum > target
        hi = np.where(too_high, mid, hi)
        lo = np.where(too_high, lo, mid)
        mid = np.where(too_high, (lo + hi) / 2.0,
                       np.where(np.isinf(hi), mid * 2.0, (lo + hi) / 2.0))
    mean_i = dist.sum(axis=1) / (k + 1)  # self's zero distance included
    mean_all = dist.sum() / max(n * (k + 1), 1)
    floor = 1e-3 * np.where(rho > 0.0, mean_i, mean_all)
    return rho, np.maximum(mid, np.maximum(floor, 1e-12))


def knn_graph(
    emb: np.ndarray, n_neighbors: int = 15, device=None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetric weighted kNN graph on the (cells x dims) embedding using
    UMAP fuzzy-simplicial-set connectivities (scanpy's default neighbors
    weighting).  Returns (src, dst, weight), each undirected edge once.
    Fully deterministic (exact search) — no seed.

    With `device=None` the kNN search runs on the host (float64
    distances).  An explicit `device` (a torch.device) routes it through
    the blockwise search (`ops/knn.py`) there — exact, float32 distances;
    at atlas-scale folds this turns the minutes-per-fold host search into
    matmul work on the card."""
    from scipy import sparse

    n = emb.shape[0]
    # scanpy/umap count the query point itself among n_neighbors: the graph
    # has n_neighbors - 1 directed non-self edges per point
    k = min(n_neighbors - 1, n - 1)
    if k <= 0:
        return (np.empty(0, np.int64),) * 2 + (np.empty(0, np.float64),)
    dist, idx = exact_knn(emb, k + 1, device=device)
    # drop the self entry BY INDEX, not by position: with duplicate points
    # a zero-distance twin may come first (the JAX package's host search
    # orders ties as scikit-learn does); if self is absent entirely
    # (crowded out by duplicates), drop the farthest column instead
    rows = np.arange(n)
    is_self = idx == rows[:, None]
    drop = np.where(is_self.any(axis=1), is_self.argmax(axis=1), k)
    m = np.ones((n, k + 1), dtype=bool)
    m[rows, drop] = False
    dist = dist[m].reshape(n, k)
    idx = idx[m].reshape(n, k)

    rho, sigma = _smooth_knn_bandwidths(dist.astype(np.float64))
    w = np.exp(-np.maximum(dist - rho[:, None], 0.0) / sigma[:, None])

    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = idx.astype(np.int64).ravel()
    W = sparse.coo_matrix((w.ravel(), (rows, cols)), shape=(n, n)).tocsr()
    Wt = W.T.tocsr()
    conn = (W + Wt - W.multiply(Wt)).tocoo()  # fuzzy union

    mask = conn.row < conn.col  # each undirected edge once
    return (conn.row[mask].astype(np.int64), conn.col[mask].astype(np.int64),
            conn.data[mask].astype(np.float64))


def _python_louvain(
    n: int, src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
    resolution: float = 1.0, seed: int = 0, max_passes: int = 10,
) -> np.ndarray:
    """Pure-Python Louvain (local move + aggregation, no refinement) —
    fallback when the native Leiden library cannot be built."""
    rng = np.random.default_rng(seed)
    cur_src, cur_dst, cur_w = src.astype(np.int64), dst.astype(np.int64), weight.astype(np.float64)
    node_map = np.arange(n, dtype=np.int64)
    n_cur = n

    for _ in range(max_passes):
        # adjacency
        adj = [[] for _ in range(n_cur)]
        strength = np.zeros(n_cur)
        for s, d, w in zip(cur_src, cur_dst, cur_w):
            if s == d:
                strength[s] += 2 * w
                continue
            adj[s].append((d, w))
            adj[d].append((s, w))
            strength[s] += w
            strength[d] += w
        two_m = strength.sum()
        if two_m <= 0:
            break
        comm = np.arange(n_cur, dtype=np.int64)
        K = strength.copy()
        moved_any = False
        for _ in range(10):
            moved = False
            for v in rng.permutation(n_cur):
                c_old = comm[v]
                kv = strength[v]
                k_to = {}
                for u, w in adj[v]:
                    k_to[comm[u]] = k_to.get(comm[u], 0.0) + w
                base = k_to.get(c_old, 0.0) - resolution * kv * (K[c_old] - kv) / two_m
                best_c, best_gain = c_old, 0.0
                for c, kc in k_to.items():
                    if c == c_old:
                        continue
                    gain = (kc - resolution * kv * K[c] / two_m) - base
                    if gain > best_gain + 1e-12:
                        best_gain, best_c = gain, c
                if best_c != c_old:
                    K[c_old] -= kv
                    K[best_c] += kv
                    comm[v] = best_c
                    moved = moved_any = True
            if not moved:
                break
        if not moved_any:
            break
        # compact + aggregate (new_ids[v] = compact community id of node v)
        uniq, new_ids = np.unique(comm, return_inverse=True)
        node_map = new_ids[node_map]
        n_new = len(uniq)
        if n_new == n_cur:
            break
        agg = {}
        for s, d, w in zip(cur_src, cur_dst, cur_w):
            a, b = new_ids[s], new_ids[d]
            if a > b:
                a, b = b, a
            agg[(a, b)] = agg.get((a, b), 0.0) + w
        cur_src = np.array([k[0] for k in agg], dtype=np.int64)
        cur_dst = np.array([k[1] for k in agg], dtype=np.int64)
        cur_w = np.array(list(agg.values()), dtype=np.float64)
        n_cur = n_new

    _, out = np.unique(node_map, return_inverse=True)
    return out.astype(np.int64)


def leiden(
    emb: np.ndarray,
    n_neighbors: int = 15,
    resolution: float = 1.0,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """Cluster an embedding: kNN graph + Leiden (native C++; Louvain
    fallback).  Returns integer labels (cells,).  `device` routes the kNN
    search to an accelerator (see `knn_graph`)."""
    n = emb.shape[0]
    src, dst, w = knn_graph(emb, n_neighbors=n_neighbors, device=device)
    labels = leiden_native(n, src, dst, w, resolution=resolution, seed=seed)
    if labels is None:
        labels = _python_louvain(n, src, dst, w, resolution=resolution, seed=seed)
    return labels


def embedding_score(
    clusters: np.ndarray, covariate_values: np.ndarray
) -> float:
    """ARI + homogeneity of covariate labels vs clusters, NA rows masked
    (reference optimization.py:273-278).  A label is NA as pandas' isna
    reads it (None, NaN, pandas' NA objects); the rest compare as str."""
    values = np.asarray(covariate_values, dtype=object).reshape(-1)
    mask = ~np.fromiter((is_na(v) for v in values), bool, len(values))
    labels = np.array([str(v) for v in values[mask]], dtype=object)
    cl = np.asarray(clusters)[mask].astype(str)
    return float(adjusted_rand_score(labels, cl) + homogeneity_score(labels, cl))

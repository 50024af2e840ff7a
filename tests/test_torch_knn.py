"""The port's exact kNN (alpine_tpu_torch/ops/knn.py) against scikit-learn
and against the JAX package's search, on the cases of tests/test_knn.py.

- The host search (``device=None``, numpy float64) against
  ``NearestNeighbors``, which the JAX package's host scoring calls on the
  float32 embedding: the same indices, and the distances to the accuracy
  scikit-learn itself has.  Its tree paths (at most 15 dimensions, k below
  n/2) are float64-exact, held at 1e-12.  Its brute path ranks by a GEMM
  expansion over float32 input and reports distances to about 1e-7
  (self at the square root of the expansion's noise, not at 0), held at
  rtol 1e-6 with self not compared.  It orders exactly tied duplicate rows
  arbitrarily, so rows with a tie are held as sorted sets.
- The torch search run on CPU tensors against ``alpine_tpu.ops.knn.
  exact_knn`` on the JAX CPU device: the same indices, distances to 1e-5.
"""

import jax
import numpy as np
import pytest
import torch
from sklearn.neighbors import NearestNeighbors

from alpine_tpu.ops.knn import exact_knn as jax_knn
from alpine_tpu_torch.ops.knn import exact_knn

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _sk(emb, k):
    return NearestNeighbors(n_neighbors=k).fit(emb).kneighbors(emb)


def _jax(emb, k, block):
    return jax_knn(emb, k, device=jax.devices("cpu")[0], block=block)


def _check_host_vs_sklearn(emb, k):
    dist, idx = exact_knn(emb, k)
    n = len(emb)
    k = min(k, n)
    nn = NearestNeighbors(n_neighbors=min(k + 1, n)).fit(emb)
    sdx, six = nn.kneighbors(emb)
    sd, si = sdx[:, :k], six[:, :k]
    tol = 1e-6 if nn._fit_method == "brute" else 1e-12
    atol = tol * float(sdx.max())
    assert dist.shape == sd.shape == (n, k)
    assert idx[:, 0].tolist() == list(range(n))  # self first, at exactly 0
    np.testing.assert_array_equal(dist[:, 0], 0.0)
    for i in range(n):  # non-self distances, ascending
        np.testing.assert_allclose(dist[i][idx[i] != i], np.sort(sd[i][si[i] != i]),
                                   rtol=tol, atol=atol)
    gaps = np.diff(np.where(six == np.arange(n)[:, None], 0.0, sdx), axis=1)
    tied = (np.abs(gaps[:, :k - 1]) <= atol).any(axis=1)
    edge = (np.abs(gaps[:, k - 1]) <= atol) if k < n else np.zeros(n, bool)
    np.testing.assert_array_equal(idx[~tied & ~edge], si[~tied & ~edge])
    np.testing.assert_array_equal(np.sort(idx[tied & ~edge], axis=1),
                                  np.sort(si[tied & ~edge], axis=1))
    for i in np.flatnonzero(edge):  # a tie across the k-th place: the
        # neighbours closer than the k-th distance are the same
        inner = sd[i, k - 1] - atol
        assert set(idx[i][dist[i] < inner]) == set(si[i][sd[i] < inner])
    return dist, idx


@pytest.mark.parametrize("n,d,k,block", [
    (500, 16, 16, 128),   # several blocks + row padding (scikit-learn: brute)
    (130, 7, 15, 2048),   # one padded block (scikit-learn: kd-tree)
    (64, 3, 64, 16),      # k == n, k > block
])
def test_knn_matches_sklearn_and_jax(n, d, k, block):
    r = np.random.default_rng(n + d)
    emb = r.normal(0, 1, (n, d)).astype(np.float32)
    _check_host_vs_sklearn(emb, k)
    dist, idx = exact_knn(emb, k, device=CPU, block=block)
    jd, ji = _jax(emb, k, block)
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_allclose(dist, jd, rtol=1e-5, atol=1e-5)


def test_knn_tiny_and_k_clamp():
    emb = np.random.default_rng(9).normal(0, 1, (5, 2)).astype(np.float32)
    dist, idx = _check_host_vs_sklearn(emb, 15)  # k clamped to n
    assert dist.shape == (5, 5)
    td, ti = exact_knn(emb, 15, device=CPU)
    jd, ji = _jax(emb, 15, 2048)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    assert exact_knn(emb, 0)[0].shape == (5, 0)


def test_knn_duplicate_rows():
    """Duplicate rows are at exactly zero distance on both searches (UMAP's
    rho depends on it); self stays first; ties order by lower index, as in
    the JAX search."""
    r = np.random.default_rng(0)
    emb = r.normal(0, 1, (40, 6)).astype(np.float32)
    emb = np.concatenate([emb, emb[:8]])
    _check_host_vs_sklearn(emb, 10)
    for dist, idx in (exact_knn(emb, 10), exact_knn(emb, 10, device=CPU, block=16)):
        assert idx[:, 0].tolist() == list(range(len(emb)))
        for i in range(8):
            row = dist[i][idx[i] == 40 + i]
            assert row.size == 1 and row[0] == 0.0
    td, ti = exact_knn(emb, 10, device=CPU, block=16)
    jd, ji = _jax(emb, 10, 16)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)


def test_knn_near_neighbors_large_norms():
    """Near neighbours of large-norm points: the refinement reports them
    at their true distances, never as spurious zeros."""
    r = np.random.default_rng(7)
    base = r.uniform(0, 100, 50).astype(np.float32)
    emb = np.stack([base + i * 0.01 for i in range(32)]).astype(np.float32)
    sd, si = _sk(emb, 8)
    for dist, idx in (exact_knn(emb, 8), exact_knn(emb, 8, device=CPU, block=16)):
        assert idx[:, 0].tolist() == list(range(32))
        np.testing.assert_allclose(dist, sd, rtol=5e-3, atol=1e-4)
        assert (dist[:, 1:] > 0.0).all()
        np.testing.assert_array_equal(np.sort(idx, axis=1), np.sort(si, axis=1))
    td, ti = exact_knn(emb, 8, device=CPU, block=16)
    jd, ji = _jax(emb, 8, 16)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)


def test_knn_far_from_origin_cluster():
    """Selection on mean-centred coordinates: a cluster far from the
    origin (‖x‖² ≈ 4.8e7) keeps its true neighbour sets."""
    r = np.random.default_rng(11)
    n, d, k = 256, 48, 15
    emb = (np.full(d, 1000.0) + r.normal(0, 1.0, (n, d))).astype(np.float32)
    dist, idx = _check_host_vs_sklearn(emb, k)
    sdx, six = _sk(emb, k + 1)
    td, ti = exact_knn(emb, k, device=CPU, block=64)
    gap_ok = (sdx[:, k] - sdx[:, k - 1]) > 2e-3
    assert gap_ok.sum() > n // 2
    np.testing.assert_array_equal(np.sort(ti, axis=1)[gap_ok],
                                  np.sort(six[:, :k], axis=1)[gap_ok])
    jd, ji = _jax(emb, k, 64)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)

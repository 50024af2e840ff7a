"""The port's copies of the reference sampler's host helpers
(alpine_tpu_torch/utils/sampling.py: ``create_joint_labels_from_dummy_
matrices``, ``generate_epoch_indices``, ``get_batch_indices``,
``get_num_batches``) against the JAX package's
(alpine_tpu/utils/sampling.py), bit for bit, on the cases of
tests/test_utils.py and a few more: the same labels, the same indices
from the same ``np.random.Generator``, the same errors."""

import numpy as np
import pytest

from alpine_tpu.utils import sampling as jsmp
from alpine_tpu_torch.utils import sampling as tsmp


def _dummies(seed, n, n_labels):
    r = np.random.default_rng(seed)
    Ys = []
    for nl in n_labels:
        y = np.zeros((nl, n), np.float32)
        y[r.integers(0, nl, n), np.arange(n)] = 1
        Ys.append(y)
    return Ys


@pytest.mark.parametrize("n_labels", [(2, 3), (4,), (3, 2, 5)])
def test_joint_labels_match_jax(n_labels):
    Ys = _dummies(0, 20, n_labels)
    Ys[0][:, 3] = 0  # a missing covariate: argmax 0
    got = tsmp.create_joint_labels_from_dummy_matrices(Ys)
    assert got == jsmp.create_joint_labels_from_dummy_matrices(Ys)
    ids = tsmp.joint_label_ids(Ys)
    # two cells share an id iff they share the joint string label
    for i in range(20):
        for j in range(20):
            assert (ids[i] == ids[j]) == (got[i] == got[j])


def test_joint_labels_of_no_covariate():
    assert tsmp.create_joint_labels_from_dummy_matrices([]) == \
        jsmp.create_joint_labels_from_dummy_matrices([]) == []


@pytest.mark.parametrize("method", ["random", "weighted"])
@pytest.mark.parametrize("n_classes", [2, 91])
def test_epoch_indices_match_jax(method, n_classes):
    """The same Generator state gives the same indices (91 joint classes:
    the float64 renormalization that np.random.Generator.choice needs)."""
    labels = [f"class_{i % n_classes}" for i in range(1000)]
    got = tsmp.generate_epoch_indices(labels, method, np.random.default_rng(0))
    want = jsmp.generate_epoch_indices(labels, method, np.random.default_rng(0))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape == (1000,) and got.min() >= 0 and got.max() < 1000


def test_epoch_indices_unknown_method_matches_jax():
    with pytest.raises(ValueError) as want:
        jsmp.generate_epoch_indices(["a"], "tiled", np.random.default_rng(0))
    with pytest.raises(ValueError) as got:
        tsmp.generate_epoch_indices(["a"], "tiled", np.random.default_rng(0))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("total,batch", [(10, 3), (9, 3), (1, 5), (0, 4), (100, 1)])
def test_batch_helpers_match_jax(total, batch):
    idx = np.random.default_rng(1).permutation(total)
    n = tsmp.get_num_batches(total, batch)
    assert n == jsmp.get_num_batches(total, batch)
    for b in range(n + 2):  # and past the end
        got = tsmp.get_batch_indices(idx, b, batch)
        want = jsmp.get_batch_indices(idx, b, batch)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert sum(len(tsmp.get_batch_indices(idx, b, batch)) for b in range(n)) == total

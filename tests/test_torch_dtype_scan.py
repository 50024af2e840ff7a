"""The port's ``suggest_data_dtype`` and ``dtype_can_store``
(alpine_tpu_torch/utils/adata.py), whose integer check compares floating
data with its floor in slabs, against the JAX package's (``np.mod``) on
whole numbers of each range, fractions, negatives, NaN, ±inf, -0.0,
integer and boolean dtypes, sparse data and empty arrays; and the slab
loop itself on a fraction in its first, a middle and its last slab."""

import numpy as np
import pytest
import scipy.sparse as sp

from alpine_tpu.utils import adata as jadata
from alpine_tpu_torch.utils import adata as tadata


def _cases():
    r = np.random.default_rng(0)
    counts = r.poisson(3.0, (40, 30)).astype(np.float32)
    out = {"int8": counts, "int16": counts * 200, "float32_large": counts * 2000,
           "fraction": counts + 0.5 * (counts == 3), "negative": counts - 1,
           "float64": counts.astype(np.float64), "float16": counts.astype(np.float16),
           "int64": counts.astype(np.int64), "uint8": counts.astype(np.uint8),
           "bool": counts > 2, "empty": np.zeros((0, 3), np.float32),
           "csr": sp.csr_matrix(counts), "csr_fraction": sp.csr_matrix(counts / 7)}
    for name, v in (("nan", np.nan), ("inf", np.inf), ("minus_inf", -np.inf),
                    ("minus_zero", -0.0), ("tiny_fraction", 1e-3)):
        x = counts.copy()
        x[17, 5] = v
        out[name] = x
    return out


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_suggest_data_dtype_matches_jax(name):
    X = CASES[name]
    with np.errstate(invalid="ignore"):
        want = jadata.suggest_data_dtype(X)
    assert tadata.suggest_data_dtype(X) == want
    for dt in ("int8", "int16", "float32", "bfloat16"):
        with np.errstate(invalid="ignore"):
            want = jadata.dtype_can_store(dt, X)
        assert tadata.dtype_can_store(dt, X) == want


@pytest.mark.parametrize("where", [0, 599, 1199])
def test_fraction_found_in_any_slab(where):
    x = np.arange(1200, dtype=np.float32).reshape(40, 30)
    assert not tadata._has_fraction(x, step=7)
    x.reshape(-1)[where] += 0.25
    assert tadata._has_fraction(x, step=7)
    assert tadata._has_fraction(x.T, step=7)  # a view that is not contiguous

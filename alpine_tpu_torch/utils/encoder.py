"""Covariate one-hot encoding with NA -> all-zero rows, in numpy.

The port's own copy of ``alpine_tpu/utils/encoder.py``, without
scikit-learn: it reproduces ``OneHotEncoder(sparse_output=False,
handle_unknown="ignore")`` fitted on the non-NA rows of each covariate.
Categories are sorted, feature names are ``f"{key}_{value}"``, NA rows
(None / NaN / pandas.NA) encode to all-zero rows, and labels unseen at fit
encode to all-zero rows at transform.  ``obs`` is a pandas DataFrame or a
dict of equal-length 1-D arrays (see utils/adata.py).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from alpine_tpu_torch.utils.adata import is_na, obs_column


class FeatureEncoders:
    def __init__(self, covariate_keys: List[str]):
        self.covariate_keys: List[str] = covariate_keys
        self.categories: Dict[str, np.ndarray] = {}
        self.encoded_labels: Dict[str, List[str]] = {}

    def _encode_column(self, obs: Any, key: str, fit: bool) -> np.ndarray:
        col = obs_column(obs, key)
        na_mask = np.fromiter((is_na(v) for v in col), bool, len(col))
        values = col[~na_mask]
        if fit:
            cats = np.unique(values)
            self.categories[key] = cats
            self.encoded_labels[key] = [f"{key}_{c}" for c in cats]
        cats = self.categories[key]
        out = np.zeros((len(col), len(cats)), dtype=np.float32)
        if len(cats) and len(values):
            pos = np.searchsorted(cats, values)
            pos_c = np.minimum(pos, len(cats) - 1)
            known = cats[pos_c] == values
            rows = np.flatnonzero(~na_mask)[known]
            out[rows, pos_c[known]] = 1.0
        return out

    def fit_transform(self, obs: Any) -> List[np.ndarray]:
        return [self._encode_column(obs, key, fit=True)
                for key in self.covariate_keys]

    def transform(self, obs: Any) -> List[np.ndarray]:
        return [self._encode_column(obs, key, fit=False)
                for key in self.covariate_keys if key in self.categories]

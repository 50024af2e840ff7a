"""Trained-state containers (the port's own copy of
``alpine_tpu/models/state.py``).

The fit path stores W and H concatenated across blocks (covariate blocks
first, unguided last); ``split_w`` / ``split_h`` give the per-block list
layout the estimator exposes."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Union

import numpy as np

Float32Array = np.ndarray


def split_w(W, blocks: Sequence[int]) -> List:
    """(genes, K_total) -> per-block [(genes, k_i)]."""
    out, o = [], 0
    for k in blocks:
        out.append(W[:, o:o + k])
        o += k
    return out


def split_h(H, blocks: Sequence[int]) -> List:
    """(K_total, cells) -> per-block [(k_i, cells)]."""
    out, o = [], 0
    for k in blocks:
        out.append(H[o:o + k])
        o += k
    return out


@dataclass
class AlpineMatrices:
    X: np.ndarray
    Ys: List[np.ndarray]
    Ws: List[np.ndarray]
    Hs: List[np.ndarray]
    Bs: List[np.ndarray]

    def to_numpy(self) -> Dict[str, Union[Float32Array, List[Float32Array]]]:
        return {
            "X": np.asarray(self.X, dtype=np.float32),
            "Ys": [np.asarray(y, dtype=np.float32) for y in self.Ys],
            "Ws": [np.asarray(w, dtype=np.float32) for w in self.Ws],
            "Hs": [np.asarray(h, dtype=np.float32) for h in self.Hs],
            "Bs": [np.asarray(b, dtype=np.float32) for b in self.Bs],
        }

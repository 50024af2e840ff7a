"""The port's ``AnnData`` constructor against the JAX package's.

The same positional and keyword calls go to ``alpine_tpu.AnnData`` and to
``alpine_tpu_torch.AnnData``: the reference's positional order ``(X, obs,
var, obsm, varm, layers, uns)``, ``uns`` kept and carried by
``__getitem__`` and ``copy``, the same axis names and the same errors for
lengths that do not match.  ``var_names`` is the port's own keyword (for a
dict ``var``) and cannot be given by position.
"""

import numpy as np
import pandas as pd
import pytest

from alpine_tpu import AnnData as JaxAnnData
from alpine_tpu_torch import AnnData as PortAnnData

CLASSES = {"jax": JaxAnnData, "port": PortAnnData}


def _inputs():
    r = np.random.default_rng(0)
    X = r.random((4, 3)).astype(np.float32)
    obs = pd.DataFrame({"batch": ["a", "b", "a", "b"]},
                       index=[f"c{i}" for i in range(4)])
    var = pd.DataFrame({"kind": ["x", "y", "z"]}, index=["g0", "g1", "g2"])
    return X, obs, var


def _columns(table):
    return list(table.columns) if hasattr(table, "columns") else list(table)


def _calls():
    """(name, args, kwargs) of constructor calls both classes take."""
    X, obs, var = _inputs()
    obsm = {"emb": np.arange(8.0).reshape(4, 2)}
    varm = {"load": np.arange(6.0).reshape(3, 2)}
    layers = {"raw": np.ones((4, 3))}
    uns = {"k": 1, "nested": {"a": [1, 2]}}
    return [
        ("X", (X,), {}),
        ("X obs", (X, obs), {}),
        ("X obs var", (X, obs, var), {}),
        ("all positional", (X, obs, var, obsm, varm, layers, uns), {}),
        ("obs and uns by keyword", (X,), {"obs": obs, "uns": uns}),
        ("all by keyword", (X,), {"obs": obs, "var": var, "obsm": obsm,
                                  "varm": varm, "layers": layers, "uns": uns}),
        ("var by keyword", (X,), {"var": var}),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _calls()])
def test_same_calls_give_the_same_object(case):
    _, args, kwargs = next(c for c in _calls() if c[0] == case)
    ref, port = (cls(*args, **kwargs) for cls in CLASSES.values())
    assert port.shape == ref.shape
    np.testing.assert_array_equal(port.X, ref.X)
    assert list(port.obs_names) == list(ref.obs_names)
    assert list(port.var_names) == list(ref.var_names)
    for axis in ("obs", "var"):  # the port keeps a dict where none was given
        assert _columns(getattr(port, axis)) == _columns(getattr(ref, axis))
    for name in ("obsm", "varm", "layers"):
        a, b = getattr(port, name), getattr(ref, name)
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    assert port.uns == ref.uns


@pytest.mark.parametrize("which", list(CLASSES))
def test_uns_is_a_dict_of_its_own(which):
    uns = {"k": 1}
    ad = CLASSES[which](np.ones((2, 2), np.float32), uns=uns)
    assert ad.uns == {"k": 1} and ad.uns is not uns
    assert CLASSES[which](np.ones((2, 2), np.float32)).uns == {}


@pytest.mark.parametrize("how", ["getitem", "slice", "copy"])
def test_uns_is_carried_by_subsets_and_copies(how):
    X, obs, var = _inputs()
    uns = {"k": 1, "nested": {"a": [1, 2]}}
    outs = {}
    for which, cls in CLASSES.items():
        ad = cls(X, obs, var, uns=uns)
        out = {"getitem": lambda: ad[np.array([0, 2])],
               "slice": lambda: ad[1:3], "copy": ad.copy}[how]()
        assert out.uns == uns
        out.uns["nested"]["a"].append(3)  # a deep copy: the source keeps its own
        assert ad.uns == uns
        outs[which] = out
    ref, port = outs["jax"], outs["port"]
    assert list(port.obs_names) == list(ref.obs_names)
    assert list(port.var_names) == list(ref.var_names)
    np.testing.assert_array_equal(port.X, ref.X)


@pytest.mark.parametrize("bad,message", [
    ("obs", "obs length does not match X rows"),
    ("var", "var length does not match X columns"),
])
@pytest.mark.parametrize("which", list(CLASSES))
def test_lengths_that_do_not_match_raise_as_the_reference(which, bad, message):
    X, obs, var = _inputs()
    if bad == "obs":
        obs = obs.iloc[:3]
    else:
        var = var.iloc[:2]
    with pytest.raises(ValueError, match=message):
        CLASSES[which](X, obs, var)
    with pytest.raises(ValueError, match=message):
        CLASSES[which](X, obs=obs, var=var, uns={"k": 1})


def test_var_names_is_keyword_only():
    X = np.ones((2, 3), np.float32)
    ad = PortAnnData(X, {"batch": ["a", "b"]}, None, var_names=["a", "b", "c"])
    assert list(ad.var_names) == ["a", "b", "c"]
    with pytest.raises(TypeError):
        PortAnnData(X, None, None, None, None, None, None, ["a", "b", "c"])

"""The port's TPE copy (alpine_tpu_torch/optimize/tpe.py) against the JAX
package's (alpine_tpu/optimize/tpe.py): on a quadratic, on a space with a
failure region and on the ComponentOptimizer's own space, ``fmin`` and
``fmin_parallel`` (two workers in lockstep threads, the barrier exchange
of tests/test_tpe_parallel.py) produce the same trials — tids, values,
losses and statuses — and Trials pickles load across the two packages."""

import pickle
import threading

import numpy as np
import pytest

from alpine_tpu.optimize import tpe as jtpe
from alpine_tpu.optimize.optimizer import SearchSpace as JaxSpace
from alpine_tpu_torch.optimize import tpe
from alpine_tpu_torch.optimize.optimizer import SearchSpace


def _quadratic(hp):
    space = {"x": hp.uniform("x", -10.0, 10.0), "y": hp.uniform("y", -10.0, 10.0)}
    return space, lambda s: {"loss": (s["x"] - 3.0) ** 2 + (s["y"] + 2.0) ** 2,
                             "status": "ok"}


def _failing(hp):
    space = {"x": hp.uniform("x", -4.0, 4.0), "y": hp.quniform("y", 2, 30, 1),
             "lam": hp.qloguniform("lam", np.log(1.0), np.log(1e4), 1)}

    def obj(p):
        if p["y"] > 24:
            return {"loss": np.inf, "status": "fail"}
        return {"loss": float((p["x"] - 1.0) ** 2 + 0.1 * (p["y"] - 10) ** 2
                              + 1e-4 * p["lam"]), "status": "ok"}
    return space, obj


def _optimizer_space(hp_module):
    cls = SearchSpace if hp_module is tpe else JaxSpace
    space = cls((10, 100), (1.0, 1e4), (0.0, 1.0), (0.0, 100.0), (0.0, 1.0),
                n_covariates=2).to_tpe()

    def obj(p):
        return {"loss": float(abs(p["n_total_components"] - 40) + p["orth_W"]
                              + np.log(p["lam_0"]) * p["splits"][0]), "status": "ok"}
    return space, obj


def _same_trials(a, b):
    assert len(a.trials) == len(b.trials)
    for ta, tb in zip(a.trials, b.trials):
        assert ta["tid"] == tb["tid"]
        assert ta["misc"]["vals"] == tb["misc"]["vals"]
        assert ta["result"]["loss"] == tb["result"]["loss"]
        assert ta["result"]["status"] == tb["result"]["status"]


@pytest.mark.parametrize("make", [_quadratic, _failing, _optimizer_space],
                         ids=["quadratic", "failing", "optimizer_space"])
@pytest.mark.parametrize("algo", ["tpe", "rand"])
def test_fmin_trials_match_jax(make, algo):
    runs = []
    for mod in (tpe, jtpe):
        space, obj = make(mod.hp if make is not _optimizer_space else mod)
        trials = mod.Trials()
        best = mod.fmin(obj, space, algo=getattr(mod, algo).suggest, max_evals=30,
                        trials=trials, rstate=np.random.default_rng(5))
        runs.append((best, trials))
    assert runs[0][0] == runs[1][0]
    _same_trials(runs[0][1], runs[1][1])


def _lockstep(mod, make, n_workers=2, max_evals=26, seed=3):
    """fmin_parallel on threads whose exchange is a barrier-synchronized
    shared row (the in-process model of the multi-process allgather)."""
    barrier = threading.Barrier(n_workers)
    shared = np.full(n_workers, np.nan)
    trials = [mod.Trials() for _ in range(n_workers)]
    errors = []
    space, obj = make(mod.hp)

    def remote(point, loss):
        return {"loss": loss, "status": "ok" if np.isfinite(loss) else "fail"}

    def run(w):
        def exchange(v):
            shared[w] = v
            barrier.wait()
            row = shared.copy()
            barrier.wait()
            return row
        try:
            mod.fmin_parallel(obj, space, fn_remote=remote, exchange_losses=exchange,
                              n_workers=n_workers, worker_index=w, algo=mod.tpe.suggest,
                              max_evals=max_evals, trials=trials[w],
                              rstate=np.random.default_rng(seed))
        except BaseException as exc:
            errors.append(exc)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(w,)) for w in range(n_workers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    _same_trials(trials[0], trials[1])
    return trials[0]


@pytest.mark.parametrize("make", [_quadratic, _failing], ids=["quadratic", "failing"])
def test_fmin_parallel_trials_match_jax(make):
    _same_trials(_lockstep(tpe, make), _lockstep(jtpe, make))


def test_single_worker_parallel_is_fmin():
    space, obj = _failing(tpe.hp)
    a, b = tpe.Trials(), tpe.Trials()
    tpe.fmin(obj, space, max_evals=25, trials=a, rstate=np.random.default_rng(7))
    tpe.fmin_parallel(obj, space, fn_remote=None, exchange_losses=lambda v: np.asarray([v]),
                      n_workers=1, worker_index=0, max_evals=25, trials=b,
                      rstate=np.random.default_rng(7))
    _same_trials(a, b)


def test_trials_pickles_cross_packages(tmp_path):
    space, obj = _quadratic(tpe.hp)
    mine = tpe.Trials()
    tpe.fmin(obj, space, max_evals=6, trials=mine, rstate=np.random.default_rng(1))
    jspace, jobj = _quadratic(jtpe.hp)
    theirs = jtpe.Trials()
    jtpe.fmin(jobj, jspace, max_evals=6, trials=theirs, rstate=np.random.default_rng(1))
    p_jax, p_port = tmp_path / "jax.pkl", tmp_path / "port.pkl"
    p_jax.write_bytes(pickle.dumps(theirs))
    p_port.write_bytes(pickle.dumps(mine))
    # the JAX package's pickle names alpine_tpu.optimize.tpe.Trials, read
    # here as the port's class
    loaded = tpe.load_foreign_pickle(str(p_jax))
    assert type(loaded) is tpe.Trials
    _same_trials(loaded, mine)
    back = jtpe.import_hyperopt_trials(jtpe.load_foreign_pickle(str(p_port)))
    _same_trials(back, theirs)
    # a loaded file resumes as the JAX package's would
    tpe.fmin(obj, space, max_evals=9, trials=loaded, rstate=np.random.default_rng(2))
    jtpe.fmin(jobj, jspace, max_evals=9, trials=back, rstate=np.random.default_rng(2))
    _same_trials(loaded, back)


def test_parzen_and_forgetting_match_jax():
    r = np.random.default_rng(0)
    mus = r.uniform(-3, 5, 17)
    w = tpe._forgetting_weights(40)
    np.testing.assert_array_equal(w, jtpe._forgetting_weights(40))
    a = tpe._Parzen(mus, -3.0, 5.0, weights=w[:17])
    b = jtpe._Parzen(mus, -3.0, 5.0, weights=w[:17])
    x = np.linspace(-3, 5, 41)
    np.testing.assert_array_equal(a.logpdf(x), b.logpdf(x))
    np.testing.assert_array_equal(a.sample(np.random.default_rng(4), 50),
                                  b.sample(np.random.default_rng(4), 50))

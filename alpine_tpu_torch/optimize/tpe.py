"""Tree-structured Parzen Estimator (TPE) Bayesian optimization.

The port's own copy of ``alpine_tpu/optimize/tpe.py`` (numpy and scipy
only).  The reference delegates hyperparameter search to ``hyperopt``
(the reference's ``alpine/optimization.py:10, :123-130``); this module is a
self-contained reimplementation of the subset of the hyperopt API ALPINE
uses, with a real TPE algorithm (Bergstra et al., NeurIPS 2011):

- `hp.uniform`, `hp.quniform`, `hp.qloguniform` — the three distributions
  the reference's search space uses (optimization.py:95-120)
- `Trials` — picklable trial store (save_trials/load_trials contract,
  optimization.py:335-357)
- `fmin(objective, space, algo=tpe.suggest, max_evals, trials, rstate)` —
  returns the best trial's raw parameter values keyed by hp label
- `STATUS_OK` / `STATUS_FAIL` — objective result statuses; failed trials
  (e.g. invalid component distributions, optimization.py:217-218) are kept
  in the trials list and modeled in the "above" (bad) Parzen group

TPE per dimension (independent factorization, as hyperopt does for flat
spaces): after `n_startup_trials` random draws, split observed trials into
the best-gamma fraction (l) and the rest (g), fit 1-D Parzen mixtures of
truncated normals over the *underlying* space (log-space for qloguniform,
pre-rounding for q-distributions), draw candidates from l and keep the
candidate maximizing l(x)/g(x).

A Trials pickle written by the JAX package loads here with
``load_foreign_pickle``: its class path ``alpine_tpu.optimize.tpe`` is
read as this module's, so loading it imports nothing of the JAX package.
"""

from __future__ import annotations

import math
import pickle
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

STATUS_OK = "ok"
STATUS_FAIL = "fail"

N_STARTUP_TRIALS = 20
N_EI_CANDIDATES = 24
GAMMA_CAP = 25
LINEAR_FORGETTING = 25  # hyperopt's LF: down-weight observations older than
                        # the most recent 25 with a linear ramp


# ---------------------------------------------------------------------------
# Search-space expressions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Expression:
    label: str
    kind: str  # "uniform" | "quniform" | "qloguniform"
    low: float  # underlying-space bounds (log-space for qloguniform)
    high: float
    q: float = 1.0

    # -- underlying <-> value transforms ----------------------------------
    def to_value(self, u: float) -> float:
        if self.kind == "uniform":
            return float(u)
        if self.kind == "quniform":
            return float(np.round(u / self.q) * self.q)
        if self.kind == "qloguniform":
            return float(np.round(math.exp(u) / self.q) * self.q)
        raise ValueError(self.kind)

    def to_underlying(self, v: float) -> float:
        if self.kind == "qloguniform":
            return math.log(max(v, 1e-300))
        return float(v)

    def sample_prior(self, rng: np.random.Generator) -> float:
        return self.to_value(rng.uniform(self.low, self.high))


class hp:
    """Namespace mirroring ``hyperopt.hp`` for the used distributions."""

    @staticmethod
    def uniform(label: str, low: float, high: float) -> Expression:
        return Expression(label, "uniform", float(low), float(high))

    @staticmethod
    def quniform(label: str, low: float, high: float, q: float) -> Expression:
        return Expression(label, "quniform", float(low), float(high), float(q))

    @staticmethod
    def qloguniform(label: str, low: float, high: float, q: float) -> Expression:
        """low/high are in LOG space, as in hyperopt
        (cf. optimization.py:118-120: np.log(lam_range))."""
        return Expression(label, "qloguniform", float(low), float(high), float(q))


def _flatten_space(space: Any) -> List[Expression]:
    """Collect Expression leaves from a dict/list space (the reference's
    space is a flat dict whose 'splits' entry is a list,
    optimization.py:95-114)."""
    out: List[Expression] = []
    if isinstance(space, Expression):
        out.append(space)
    elif isinstance(space, dict):
        for v in space.values():
            out.extend(_flatten_space(v))
    elif isinstance(space, (list, tuple)):
        for v in space:
            out.extend(_flatten_space(v))
    else:
        raise TypeError(f"unsupported space node: {type(space)}")
    labels = [e.label for e in out]
    if len(labels) != len(set(labels)):
        raise ValueError("duplicate labels in search space")
    return out


def _evaluate_space(space: Any, vals: Dict[str, float]) -> Any:
    """Substitute sampled values into the space structure."""
    if isinstance(space, Expression):
        return vals[space.label]
    if isinstance(space, dict):
        return {k: _evaluate_space(v, vals) for k, v in space.items()}
    if isinstance(space, (list, tuple)):
        return [_evaluate_space(v, vals) for v in space]
    raise TypeError(type(space))


# ---------------------------------------------------------------------------
# Trials store
# ---------------------------------------------------------------------------


class Trials:
    """Picklable trial store with the fields ALPINE reads:
    trial["tid"], trial["result"]["status"|"loss"|"params"],
    and (for TPE modeling) trial["misc"]["vals"][label] == [value]."""

    def __init__(self):
        self.trials: List[Dict[str, Any]] = []

    def __len__(self) -> int:
        return len(self.trials)

    def append(self, tid: int, vals: Dict[str, float], result: Dict[str, Any]) -> None:
        self.trials.append(
            {"tid": tid, "misc": {"vals": {k: [v] for k, v in vals.items()}},
             "result": result}
        )

    def best_trial(self) -> Optional[Dict[str, Any]]:
        ok = [t for t in self.trials
              if t.get("result", {}).get("status") == STATUS_OK
              and np.isfinite(t["result"].get("loss", np.inf))]
        if not ok:
            return None
        return min(ok, key=lambda t: t["result"]["loss"])

    @property
    def losses(self) -> List[float]:
        return [t["result"].get("loss", np.inf) for t in self.trials]


# ---------------------------------------------------------------------------
# Parzen estimator
# ---------------------------------------------------------------------------


def _forgetting_weights(n: int) -> np.ndarray:
    """hyperopt's linear_forgetting_weights(N, LF=25), applied PER below/
    above group in chronological order: all ones when N < LF, otherwise the
    oldest N-LF observations ramp linearly from 1/N to 1 and the newest LF
    get weight 1.  (The below group is capped at 25 = LF, so its weights are
    always flat — exactly as in hyperopt.)"""
    if n < LINEAR_FORGETTING:
        return np.ones(n)
    ramp = np.linspace(1.0 / n, 1.0, n - LINEAR_FORGETTING)
    return np.concatenate([ramp, np.ones(LINEAR_FORGETTING)])


class _Parzen:
    """1-D mixture of truncated normals over [low, high] with a flat prior
    component and optional per-observation mixture weights — hyperopt's
    adaptive_parzen_normal construction (verified term-for-term against an
    independent transcription in tests/test_tpe_fidelity.py): prior inserted
    at its sorted position, bandwidth = max neighbor distance (single real
    neighbor at the ends), clipped to [prior_sigma / min(100, 1+len),
    prior_sigma], prior kept at prior_sigma, prior_weight = 1."""

    def __init__(self, mus: np.ndarray, low: float, high: float,
                 weights: Optional[np.ndarray] = None):
        prior_mu = 0.5 * (low + high)
        prior_sigma = high - low
        mus = np.asarray(mus, dtype=np.float64)
        if weights is None:
            weights = np.ones(len(mus))
        weights = np.asarray(weights, dtype=np.float64)
        order = np.argsort(mus, kind="stable")
        obs_mu = mus[order]
        obs_w = weights[order]

        if len(obs_mu) == 0:
            prior_pos = 0
            sorted_mu = np.asarray([prior_mu])
            sigma = np.asarray([prior_sigma])
        elif len(obs_mu) == 1:
            # hyperopt special-cases one observation: half the prior width
            prior_pos = 0 if prior_mu < obs_mu[0] else 1
            sorted_mu = np.insert(obs_mu, prior_pos, prior_mu)
            sigma = np.empty(2)
            sigma[prior_pos] = prior_sigma
            sigma[1 - prior_pos] = prior_sigma * 0.5
        else:
            prior_pos = int(np.searchsorted(obs_mu, prior_mu))
            sorted_mu = np.insert(obs_mu, prior_pos, prior_mu)
            sigma = np.empty_like(sorted_mu)
            sigma[1:-1] = np.maximum(sorted_mu[1:-1] - sorted_mu[:-2],
                                     sorted_mu[2:] - sorted_mu[1:-1])
            sigma[0] = sorted_mu[1] - sorted_mu[0]
            sigma[-1] = sorted_mu[-1] - sorted_mu[-2]

        sigma_max = prior_sigma
        sigma_min = prior_sigma / min(100.0, 1.0 + float(len(sorted_mu)))
        sigma = np.clip(sigma, sigma_min, sigma_max)
        sigma[prior_pos] = prior_sigma  # the prior keeps its wide bandwidth
        sorted_w = np.insert(obs_w, prior_pos, 1.0)  # prior_weight = 1.0
        self.mu = sorted_mu
        self.sigma = sigma
        self.w = sorted_w / sorted_w.sum()
        self.low, self.high = low, high
        # normalization for truncation to [low, high]
        from scipy.stats import norm

        self._norm = norm
        a = (low - self.mu) / self.sigma
        b = (high - self.mu) / self.sigma
        self._z = np.maximum(self._norm.cdf(b) - self._norm.cdf(a), 1e-12)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        # rejection-sample the truncated mixture, as hyperopt's GMM1 does
        # (tpe.py GMM1: redraw until low <= x < high) — clipping instead
        # would pile probability mass into atoms at the exact bounds, a
        # different candidate distribution than the truncated density the
        # logpdf scores.  Acceptance is bounded below by max-component
        # truncation mass (_z >= 1e-12 floor); the round cap is a defensive
        # backstop for pathological priors, not an expected path.
        out = np.empty(n, dtype=np.float64)
        filled = 0
        for _ in range(1000):
            m = n - filled
            idx = rng.choice(len(self.mu), size=m, p=self.w)
            draw = rng.normal(self.mu[idx], self.sigma[idx])
            ok = (draw >= self.low) & (draw < self.high)
            took = int(ok.sum())
            out[filled:filled + took] = draw[ok]
            filled += took
            if filled == n:
                return out
        out[filled:] = np.clip(
            rng.uniform(self.low, self.high, n - filled),
            self.low, self.high)
        return out

    def logpdf(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)[:, None]
        comp = (
            self._norm.logpdf((x - self.mu[None, :]) / self.sigma[None, :])
            - np.log(self.sigma[None, :])
            - np.log(self._z[None, :])
            + np.log(self.w[None, :])
        )
        m = comp.max(axis=1, keepdims=True)
        return (m + np.log(np.exp(comp - m).sum(axis=1, keepdims=True))).ravel()


def _tpe_suggest_one(
    expr: Expression, trials: Trials, rng: np.random.Generator
) -> float:
    """Suggest a value for one dimension."""
    obs_u, obs_loss = [], []
    for t in trials.trials:
        vals = t.get("misc", {}).get("vals", {})
        if expr.label in vals:
            obs_u.append(expr.to_underlying(vals[expr.label][0]))
            loss = t["result"].get("loss", np.inf)
            if t["result"].get("status") != STATUS_OK or not np.isfinite(loss):
                loss = np.inf
            obs_loss.append(loss)

    if len(obs_u) < N_STARTUP_TRIALS:
        return expr.sample_prior(rng)

    obs_u = np.asarray(obs_u)
    obs_loss = np.asarray(obs_loss)
    n = len(obs_u)
    n_below = min(int(np.ceil(0.25 * np.sqrt(n))), GAMMA_CAP)
    n_below = max(n_below, 1)
    order = np.argsort(obs_loss, kind="stable")
    # hyperopt keeps each group in CHRONOLOGICAL order and applies the
    # linear-forgetting ramp per group (ap_filter_trials semantics)
    below_idx = np.sort(order[:n_below])
    above_idx = np.sort(order[n_below:])
    below, w_below = obs_u[below_idx], _forgetting_weights(len(below_idx))
    above, w_above = obs_u[above_idx], _forgetting_weights(len(above_idx))

    l_est = _Parzen(below, expr.low, expr.high, weights=w_below)
    g_est = _Parzen(above if len(above) else below, expr.low, expr.high,
                    weights=w_above if len(above) else w_below)

    cand = l_est.sample(rng, N_EI_CANDIDATES)
    score = l_est.logpdf(cand) - g_est.logpdf(cand)
    return expr.to_value(float(cand[int(np.argmax(score))]))


class tpe:
    """Namespace mirroring ``hyperopt.tpe``."""

    @staticmethod
    def suggest(exprs: List[Expression], trials: Trials,
                rng: np.random.Generator) -> Dict[str, float]:
        return {e.label: _tpe_suggest_one(e, trials, rng) for e in exprs}


class rand:
    """Namespace mirroring ``hyperopt.rand`` (pure random search)."""

    @staticmethod
    def suggest(exprs: List[Expression], trials: Trials,
                rng: np.random.Generator) -> Dict[str, float]:
        return {e.label: e.sample_prior(rng) for e in exprs}


# ---------------------------------------------------------------------------
# fmin
# ---------------------------------------------------------------------------


def _normalize_result(result) -> Dict[str, Any]:
    """Coerce an objective's return into the trial-result dict shape
    (bare floats become STATUS_OK records, as in hyperopt).  A dict
    missing 'status' is a contract violation — name it instead of
    letting float(dict) raise an unrelated TypeError."""
    if isinstance(result, dict):
        if "status" not in result:
            raise ValueError(
                "objective result dict must include a 'status' key "
                f"(hyperopt contract); got keys {sorted(result)}"
            )
        return result
    return {"loss": float(result), "status": STATUS_OK}


def _next_tid(trials: Trials) -> int:
    """Next free tid: imported hyperopt pickles may carry gapped/non-0-based
    tids, and a duplicate would make tid-keyed lookups resolve to the old
    imported trial instead of the new one."""
    return 1 + max((t["tid"] for t in trials.trials), default=-1)


def _best_point(trials: Trials) -> Optional[Dict[str, float]]:
    """Best trial's raw values keyed by hp label (hyperopt's fmin return
    contract; cf. reference usage optimization.py:135-148)."""
    best = trials.best_trial()
    if best is None:
        return None
    return {k: v[0] for k, v in best["misc"]["vals"].items()}


def _unreachable_remote(point, loss):  # pragma: no cover - guard only
    raise AssertionError("fn_remote is unreachable with n_workers=1")


def _unreachable_exchange(loss):  # pragma: no cover - guard only
    raise AssertionError("exchange_losses is unreachable with n_workers=1")


def fmin(
    fn: Callable[[Any], Dict[str, Any]],
    space: Any,
    algo=None,
    max_evals: int = 100,
    trials: Optional[Trials] = None,
    rstate: Optional[np.random.Generator] = None,
    verbose: bool = False,
) -> Optional[Dict[str, float]]:
    """Minimize ``fn`` over ``space``.  ``fn`` receives the evaluated space
    structure and returns {"loss": float, "status": STATUS_OK|STATUS_FAIL, ...};
    extra keys (e.g. "params") are stored on the trial.  Returns the best
    trial's raw values keyed by hp label (hyperopt contract; cf. reference
    usage optimization.py:135-148).

    Implemented as the n_workers=1 case of :func:`fmin_parallel` (every
    round is then replicated/width-1, so the exchange hooks are provably
    never called) — one loop owns the tid/normalization/append semantics
    for both the sequential and the multi-worker search."""
    return fmin_parallel(
        fn,
        space,
        fn_remote=_unreachable_remote,
        exchange_losses=_unreachable_exchange,
        n_workers=1,
        worker_index=0,
        algo=algo,
        max_evals=max_evals,
        trials=trials,
        rstate=rstate,
        verbose=verbose,
    )


def fmin_parallel(
    fn: Callable[[Any], Dict[str, Any]],
    space: Any,
    *,
    fn_remote: Callable[[Any, float], Dict[str, Any]],
    exchange_losses: Callable[[float], np.ndarray],
    n_workers: int,
    worker_index: int,
    algo=None,
    max_evals: int = 100,
    trials: Optional[Trials] = None,
    rstate: Optional[np.random.Generator] = None,
    round_size: Optional[Callable[[], int]] = None,
    verbose: bool = False,
) -> Optional[Dict[str, float]]:
    """Round-based synchronous-parallel :func:`fmin` for multi-worker
    searches (the reference's hyperopt offers the same trial-level
    parallelism through MongoTrials workers, optimization.py:123-130 being
    the sequential special case).

    Every worker calls this with IDENTICAL ``trials``/``rstate`` and the
    same deterministic ``algo``, so each round all workers compute the SAME
    k suggestions from their own rng; worker j evaluates only the round's
    j-th point with ``fn``, the round's losses are exchanged through
    ``exchange_losses`` (must return every worker's loss as a
    ``(n_workers,)`` array, row w = worker w's value), and each worker
    reconstructs the other workers' trial records locally with
    ``fn_remote(structured_point, loss)`` — keeping every worker's Trials
    bit-identical while shipping exactly one float per trial.

    ``round_size()`` (default: ``n_workers``) bounds a round's parallel
    width.  A size-1 round is evaluated REPLICATED by every worker (no
    loss exchange; with n_workers > 1 an ok/error flag is still exchanged
    so a raising worker fails the whole fleet instead of leaving peers in
    a later collective) — the hook for warm-up trials whose evaluation
    has side effects every worker must replay identically (e.g. max_iter
    elbow detection).  Workers whose index exceeds a round's width
    evaluate nothing but still join the exchange.  A round narrowed only by the
    remaining-eval budget (fewer than ``round_size()`` trials left) stays
    a PARALLEL round: worker 0 evaluates and the rest adopt the exchanged
    loss — never a silent fan-out to n_workers redundant evaluations,
    whose per-device float drift could fail the search after all its
    compute was spent.

    If a worker's ``fn`` raises during a parallel round, the worker still
    joins the loss exchange (shipping NaN, the sentinel idle workers
    already use) and re-raises AFTER the collective; its peers see the NaN
    and raise a RuntimeError naming the failed worker — every worker gets
    a clear error instead of hanging forever inside a gloo collective that
    has no timeout.

    Tradeoff (inherent to parallel TPE, exactly as in hyperopt's async
    modes): suggestion j of a k-wide round conditions on j-1 fewer
    completed trials than a sequential search would, so the trial stream
    differs from ``fmin``'s.  With ``n_workers=1`` this reduces to
    :func:`fmin` exactly (same rng consumption, same trials) — and
    :func:`fmin` is literally this function at n_workers=1.
    """
    if algo is None:
        algo = tpe.suggest
    if trials is None:
        trials = Trials()
    rng = rstate if rstate is not None else np.random.default_rng()
    exprs = _flatten_space(space)

    def _append(tid: int, vals: Dict[str, float], result: Dict[str, Any]) -> None:
        trials.append(tid, vals, result)
        if verbose:
            print(f"trial {tid}: loss={result.get('loss')} "
                  f"status={result.get('status')}")

    tid = _next_tid(trials)
    while len(trials.trials) < max_evals:
        want = n_workers if round_size is None else int(round_size())
        want = max(1, min(want, n_workers))
        if want == 1:
            # replicated round: every worker evaluates the same point and
            # appends the same result (no loss exchange, side effects
            # replayed).  Failure containment still needs one collective
            # when workers exist: a worker whose fn raises here would
            # otherwise die alone while its peers advance into the next
            # round's exchange and hang forever (the exact hang the
            # parallel-round NaN protocol below prevents) — so exchange an
            # ok/error FLAG, then raise together.
            vals = algo(exprs, trials, rng)
            result, my_error = None, None
            try:
                result = _normalize_result(fn(_evaluate_space(space, vals)))
            except Exception as exc:
                if n_workers == 1:
                    raise
                my_error = exc
            if n_workers > 1:
                flag = 0.0 if my_error is None else float("nan")
                flags = np.asarray(exchange_losses(flag), dtype=np.float64)
                if my_error is not None:
                    # the collective is complete — peers are unblocked
                    raise my_error
                bad = [j for j in range(n_workers) if np.isnan(flags[j])]
                if bad:
                    raise RuntimeError(
                        f"worker(s) {bad} failed during a replicated round "
                        "(their objective raised; see their logs) — "
                        "aborting this worker too so no process is left "
                        "waiting in a collective."
                    )
            _append(tid, vals, result)
            tid += 1
            continue
        k = min(want, max_evals - len(trials.trials))
        # all k suggestions are drawn BEFORE any evaluation, from the same
        # rng/trials state on every worker — identical points everywhere
        round_vals = [algo(exprs, trials, rng) for _ in range(k)]
        points = [_evaluate_space(space, v) for v in round_vals]
        mine = worker_index if worker_index < k else None
        my_result, my_error = None, None
        if mine is not None:
            try:
                my_result = _normalize_result(fn(points[mine]))
            except Exception as exc:
                my_error = exc
        if my_result is not None:
            my_loss = float(my_result.get("loss", np.inf))
            if math.isnan(my_loss):
                # NaN is the exchange's error/idle sentinel; a NaN loss is
                # an unusable trial anyway (best_trial filters non-finite)
                # — coerce BOTH the wire value and the local record so
                # every worker appends the same trial
                my_loss = float("inf")
                my_result["loss"] = float("inf")
        else:
            my_loss = float("nan")
        losses = np.asarray(exchange_losses(my_loss), dtype=np.float64)
        if losses.shape != (n_workers,):
            raise ValueError(
                f"exchange_losses must return shape ({n_workers},), got "
                f"{losses.shape}"
            )
        if my_error is not None:
            # the collective is complete — peers are unblocked and will
            # raise on the NaN below; surface the real failure here
            raise my_error
        failed = [j for j in range(k) if j != mine and np.isnan(losses[j])]
        if failed:
            raise RuntimeError(
                f"worker(s) {failed} failed during a parallel round (their "
                "objective raised; see their logs) — aborting this worker "
                "too so no process is left waiting in a collective."
            )
        for j in range(k):
            result = (my_result if j == mine
                      else _normalize_result(fn_remote(points[j], float(losses[j]))))
            _append(tid, round_vals[j], result)
            tid += 1

    return _best_point(trials)


# ---------------------------------------------------------------------------
# hyperopt interop (reference optimization.py:335-357 persistence contract)
# ---------------------------------------------------------------------------


class _ForeignStub:
    """Shape-only stand-in for classes from packages that are not installed
    here (used when reading real hyperopt Trials pickles)."""

    def __init__(self, *args, **kwargs):
        self._args, self._kwargs = args, kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


# the JAX package's copy of this module: its Trials pickles name these
# globals, which resolve here instead of importing that package
_JAX_TPE_MODULE = "alpine_tpu.optimize.tpe"


class _TolerantUnpickler(pickle.Unpickler):
    """Unpickler that substitutes _ForeignStub subclasses for any class whose
    module cannot be imported, so foreign pickles load structurally.  The
    JAX package's tpe globals resolve to this module's."""

    def find_class(self, module, name):
        if module == _JAX_TPE_MODULE and name in ("Trials", "Expression"):
            return globals()[name]
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_ForeignStub,), {"__module__": module})


def load_foreign_pickle(filename: str):
    """Load a pickle even when it references unavailable packages (e.g. a
    hyperopt Trials file written by the reference implementation, or a
    Trials file written by the JAX package)."""
    with open(filename, "rb") as f:
        return _TolerantUnpickler(f).load()


def import_hyperopt_trials(obj) -> Trials:
    """Best-effort conversion of a real hyperopt ``Trials`` (or its raw
    trial-document list) into this module's :class:`Trials`, so reference
    users can carry saved search state over.

    hyperopt trial documents share the core fields this module uses
    ("tid", "misc"->"vals", "result" with "ok"/"fail" statuses); exp_key,
    book-keeping timestamps and attachments are dropped.  Labels with empty
    value lists (hyperopt conditional-space leaves that were inactive) are
    skipped — this module's spaces are unconditional.
    """
    if isinstance(obj, Trials):
        return obj
    docs = None
    for attr in ("_dynamic_trials", "trials", "_trials"):
        docs = getattr(obj, attr, None)
        if docs is not None:
            break
    if docs is None and isinstance(obj, (list, tuple)):
        docs = list(obj)
    if docs is None:
        raise TypeError(
            f"Cannot interpret {type(obj).__name__!r} as a hyperopt Trials object"
        )
    out = Trials()
    for doc in docs:
        try:
            tid = doc["tid"]
            raw_vals = doc["misc"]["vals"]
            vals = {k: list(v) for k, v in raw_vals.items() if len(v)}
            result = dict(doc.get("result") or {})
        except (KeyError, TypeError) as exc:
            raise ValueError(f"Unrecognized hyperopt trial document: {exc!r}") from exc
        result.setdefault("status", STATUS_FAIL)
        out.trials.append({"tid": tid, "misc": {"vals": vals}, "result": result})
    return out

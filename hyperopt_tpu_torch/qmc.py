"""Quasi-Monte-Carlo suggest: scrambled Sobol or Halton sequences.

Counterpart of ``hyperopt_tpu/qmc.py``.  A low-discrepancy sequence covers
the space more evenly than random search at small budgets, where TPE's
``n_startup_jobs`` warm-start trials live.  Standalone::

    fmin(fn, space, algo=qmc.suggest, ...)

or as TPE's startup sampler::

    fmin(fn, space, algo=partial(tpe.suggest, startup="qmc"), ...)

Startup-sized work (tens of points, P columns) stays on the host: numpy
and ``scipy.stats.qmc``, one inverse-CDF map per distribution family over
the unit hypercube, then the compiled space's activity mask.

Successive calls continue the sequence: one engine per (trials object,
engine, dimension), scrambled with the first call's seed, moved past the
trials already there (resume), then advanced; later seeds are ignored
(a new scramble mid-experiment would break the joint low discrepancy).
The engines are held weakly by their trials, in the process that calls
the suggest (with ``PoolTrials(execution="process")``, the parent: the
children only evaluate).
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
from scipy import special
from scipy.stats import qmc as _qmc

from . import base
from .space import (
    CATEGORICAL,
    LOGNORMAL,
    LOGUNIFORM,
    QLOGNORMAL,
    QLOGUNIFORM,
    QUNIFORM,
    RANDINT,
    UNIFORM,
    UNIFORMINT,
)

_LOG_KINDS = (LOGUNIFORM, QLOGUNIFORM, LOGNORMAL, QLOGNORMAL)


def _transform_column(spec, u):
    """Inverse-CDF map of uniform [0, 1) draws ``u`` onto one parameter."""
    kind = spec.kind
    if kind == CATEGORICAL or (kind == RANDINT and spec.probs is not None):
        edges = np.cumsum(np.asarray(spec.probs, dtype=np.float64))
        edges[-1] = 1.0                      # guard a rounded-down total
        v = np.searchsorted(edges, u, side="right").astype(np.float64)
        if kind == RANDINT and spec.low:
            v += spec.low
        return v
    if kind in (UNIFORM, LOGUNIFORM, QUNIFORM, QLOGUNIFORM):
        z = spec.low + u * (spec.high - spec.low)
    elif kind == UNIFORMINT:
        return np.floor(spec.low + u * (spec.high - spec.low + 1)).clip(
            spec.low, spec.high)
    elif kind == RANDINT:
        return np.floor(spec.low + u * (spec.high - spec.low)).clip(
            spec.low, spec.high - 1)
    else:   # normal family: mu + sigma * Phi^-1(u)
        z = spec.mu + spec.sigma * special.ndtri(np.clip(u, 1e-12, 1 - 1e-12))
    if kind in _LOG_KINDS:
        z = np.exp(z)
    if spec.q:
        z = np.round(z / spec.q) * spec.q
        if kind in (QUNIFORM, QLOGUNIFORM):
            lo = np.exp(spec.low) if kind == QLOGUNIFORM else spec.low
            hi = np.exp(spec.high) if kind == QLOGUNIFORM else spec.high
            z = np.clip(z, np.round(lo / spec.q) * spec.q,
                        np.round(hi / spec.q) * spec.q)
    return z


# One engine per (trials, engine name, dim), dropped with the trials.
# Re-entered by suggest_batch around the draw: the draw advances the
# engine, so lookup and draw hold the lock together.
_engines: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_engines_lock = threading.RLock()


def _engine_for(trials, name, dim, seed):
    with _engines_lock:
        per_trials = _engines.setdefault(trials, {})
        eng = per_trials.get((name, dim))
        if eng is None:
            cls = {"sobol": _qmc.Sobol, "halton": _qmc.Halton}[name]
            eng = cls(d=dim, scramble=True, seed=int(seed) % (2 ** 32))
            # Resume: skip the points the experiment already used.
            if len(trials):
                eng.fast_forward(len(trials))
            per_trials[(name, dim)] = eng
        return eng


def suggest_batch(new_ids, domain, trials, seed, engine="sobol"):
    """Raw ``(vals[n, P], active[n, P])`` host arrays."""
    cs = domain.cs
    n = len(new_ids)
    if n == 0 or cs.n_params == 0:
        return (np.zeros((n, cs.n_params), np.float32),
                np.ones((n, cs.n_params), bool))
    with _engines_lock:
        u = _engine_for(trials, engine, cs.n_params, seed).random(n)
    vals = np.zeros((n, cs.n_params), np.float32)
    for j, spec in enumerate(cs.params):
        vals[:, j] = _transform_column(spec, u[:, j])
    return vals, cs.active_mask_host(vals)


def suggest(new_ids, domain, trials, seed, engine="sobol"):
    """QMC suggest (``suggest(new_ids, domain, trials, seed)``);
    ``engine`` is ``"sobol"`` (default) or ``"halton"``."""
    vals, active = suggest_batch(new_ids, domain, trials, seed, engine=engine)
    return base.docs_from_samples(domain.cs, new_ids, vals, active,
                                  exp_key=getattr(trials, "exp_key", None))


def suggest_halton(new_ids, domain, trials, seed):
    return suggest(new_ids, domain, trials, seed, engine="halton")


#: The names the backend registry (``backends/contract.py``) resolves
#: through.
BACKENDS = {"qmc": suggest, "sobol": suggest, "halton": suggest_halton}

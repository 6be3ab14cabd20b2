"""The suggest-backend contract: protocol, registry, conformance suite.

Counterpart of ``hyperopt_tpu/backends/contract.py``.

The protocol
------------

A *suggest backend* is a callable with the reference plugin signature::

    suggest(new_ids, domain, trials, seed, **kw) -> [trial docs]

A dispatch-capable backend also carries four attributes, the halves the
pipelined loop drives (``pipeline.PipelinedExecutor``):

``suggest.dispatch(new_ids, domain, trials, seed, **kw) -> handle``
    Start the proposal computation on the space's device and return a
    handle without waiting for it.  The history is read now.  TPE, GP and
    ES share one layout, ``(tag, cs, new_ids, rows, exp_key)``: ``"ready"``
    with host ``(vals, active)`` arrays, or ``"pending"`` with a
    ``tpe._PendingRows`` over device rows.
``suggest.materialize(handle) -> [trial docs]``
    Wait for the handle and package trial documents.  ``suggest(...)``
    equals dispatch + materialize for the same arguments.
``suggest.start_transfer(handle) -> handle``
    Start the device→host copy without waiting (a pinned ``non_blocking``
    copy and a CUDA event); a no-op on ready handles and on the CPU.
``suggest.handle_ready(handle) -> bool``
    True when materialize will not wait; never blocks.

A backend without them is sync-only (``rand``, ``qmc``, ``anneal``,
``atpe``): ``fmin`` runs its ordinary loop.  The four halves come together
or not at all.

Every model-based head reads ``trials.history(cs)`` through the resident
ring (``history.device_history``, bucketed by ``tpe._bucket``), enters
NEW/RUNNING trials as constant-liar rows at the mean observed loss
(``tpe._inflight_fantasy_rows``), and within one batched dispatch repeats
the liar idea on the device (propose, fantasize, refit).

The registry
------------

:func:`resolve` maps ``fmin``'s ``algo="..."`` strings to callables.
Builtin heads sit in per-module ``BACKENDS`` dicts, imported on their first
resolve; :func:`register_backend` adds heads at run time; an unknown name
raises :class:`UnknownBackend` (a ``ValueError``).

The conformance suite
---------------------

``check_sync_parity``, ``check_handle_protocol``, ``check_pipeline_depth2``
and ``check_transient_retry`` are plain functions raising
``AssertionError``, so a backend's author runs them without pytest
(:func:`run_conformance`).  Each takes ``device`` (default: CUDA, as every
entry point of the package; ``"cpu"`` runs the suite on the CPU).
"""

from __future__ import annotations

import functools
import importlib
import inspect
import json
import threading

import numpy as np

from ..obs.metrics import registry as _metrics_registry

#: name -> module holding a ``BACKENDS`` dict with that name.  Resolving a
#: name imports one module.
_BUILTIN_SPECS = {
    "tpe": "hyperopt_tpu_torch.tpe",
    "tpe_quantile": "hyperopt_tpu_torch.tpe",
    "tpe_sobol": "hyperopt_tpu_torch.tpe",
    "tpe_mv": "hyperopt_tpu_torch.tpe",
    "rand": "hyperopt_tpu_torch.rand",
    "random": "hyperopt_tpu_torch.rand",
    "qmc": "hyperopt_tpu_torch.qmc",
    "sobol": "hyperopt_tpu_torch.qmc",
    "halton": "hyperopt_tpu_torch.qmc",
    "anneal": "hyperopt_tpu_torch.anneal",
    "atpe": "hyperopt_tpu_torch.atpe",
    "gp": "hyperopt_tpu_torch.backends.gp",
    "es": "hyperopt_tpu_torch.backends.es",
}

_REGISTRY: dict = {}            # name -> suggest callable (resolved)
_REGISTRY_LOCK = threading.Lock()


class UnknownBackend(ValueError):
    """An ``algo`` name with no registered backend."""


def register_backend(name: str, fn, replace: bool = False) -> None:
    """Register ``fn`` as the suggest backend for ``algo=name``.

    ``fn`` follows the plugin signature; attach the four halves for the
    pipelined loop.  An existing name, builtin or registered, needs
    ``replace=True``."""
    if not callable(fn):
        raise TypeError(f"backend {name!r} must be callable, got "
                        f"{type(fn).__name__}")
    with _REGISTRY_LOCK:
        if not replace and (name in _REGISTRY or name in _BUILTIN_SPECS):
            raise ValueError(f"backend {name!r} already registered "
                             "(pass replace=True to override)")
        _REGISTRY[name] = fn


def _load_builtin(name: str):
    """Import the module owning ``name`` and cache every head of its
    ``BACKENDS`` dict (one import fills all its aliases)."""
    table = importlib.import_module(_BUILTIN_SPECS[name]).BACKENDS
    with _REGISTRY_LOCK:
        for alias, fn in table.items():
            _REGISTRY.setdefault(alias, fn)
    return table[name]


def resolve(name: str):
    """The suggest callable of an ``algo=`` string; :class:`UnknownBackend`
    for a name nobody registered."""
    fn = _REGISTRY.get(name)
    if fn is None:
        if name not in _BUILTIN_SPECS:
            raise UnknownBackend(
                f"unknown algo {name!r} (have {names()}) — register new "
                "heads with hyperopt_tpu_torch.backends.register_backend or "
                "pass a suggest callable")
        fn = _load_builtin(name)
    _metrics_registry().counter(f"backend.{name}.resolved").inc()
    return fn


def names() -> list:
    """Every resolvable name (builtins and registered), sorted.  Imports
    nothing."""
    with _REGISTRY_LOCK:
        dynamic = set(_REGISTRY)
    return sorted(dynamic | set(_BUILTIN_SPECS))


def server_table() -> dict:
    """``{name: callable}`` of every head, with ``verbose=False`` bound
    where the head takes it (a server does not chat for its callers)."""
    table = {}
    for name in names():
        fn = resolve(name)
        try:
            params = inspect.signature(fn).parameters
        except (TypeError, ValueError):  # pragma: no cover - exotic callables
            params = {}
        if "verbose" in params:
            fn = functools.partial(fn, verbose=False)
        table[name] = fn
    return table


# ---------------------------------------------------------------------------
# conformance suite
# ---------------------------------------------------------------------------

#: The checks every head must pass.
CONFORMANCE_CHECKS = ("sync_parity", "handle_protocol",
                      "pipeline_depth2", "transient_retry")

_HALVES = ("dispatch", "materialize", "start_transfer", "handle_ready")


def halves_of(fn):
    """``(dispatch, materialize, start_transfer, handle_ready)`` of a head,
    or ``(None,) * 4`` for a sync-only one.  A keyword-only
    ``functools.partial`` unwraps as in ``FMinIter``, its keywords bound
    onto the dispatch half, so ``tpe_sobol`` and ``tpe_mv`` keep their
    halves."""
    kw = {}
    if isinstance(fn, functools.partial) and not fn.args:
        kw = dict(fn.keywords or {})
        fn = fn.func
    halves = [getattr(fn, a, None) for a in _HALVES]
    if halves[0] is not None and kw:
        halves[0] = functools.partial(halves[0], **kw)
    return tuple(halves)


def introspect_of(fn):
    """The head's health hook ``suggest.introspect(domain, trials, seed=0)
    -> dict`` (host diagnostics for ``obs.health``), or None; partials
    unwrap to the callable that carries it."""
    while isinstance(fn, functools.partial):
        fn = fn.func
    return getattr(fn, "introspect", None)


def conformance_domain(device=None):
    """The small mixed space (one continuous, one categorical column)
    every check runs on, its suggests on ``device``."""
    from .. import base, hp
    from ..space import resolve_device

    space = {"x": hp.uniform("x", -2.0, 2.0),
             "c": hp.choice("c", [0, 1, 2])}
    domain = base.Domain(_conformance_objective, space)
    domain.cs.device = resolve_device(device)
    return domain


def _conformance_objective(p):
    return (p["x"] - 0.5) ** 2 + 0.1 * p["c"]


def seeded_trials(domain, n=24, seed=0, exp_key=None):
    """A Trials with ``n`` finished random trials, enough to put every
    model-based head past its startup phase; equal for equal ``seed``."""
    from .. import base, rand

    t = base.Trials(exp_key=exp_key)
    docs = rand.suggest(list(range(n)), domain, t, seed)
    for d in docs:
        vals = d["misc"]["vals"]
        x = vals["x"][0]
        c = vals["c"][0] if vals["c"] else 0
        d["state"] = base.JOB_STATE_DONE
        d["result"] = {"status": base.STATUS_OK,
                       "loss": float(_conformance_objective(
                           {"x": x, "c": c}))}
    t.insert_trial_docs(docs)
    t.refresh()
    return t


def check_sync_parity(fn, n=4, seed=1234, device=None):
    """``suggest(...)`` equals its own dispatch + materialize (when the
    halves exist) and a re-run on an equal history, through the JSON form
    of the docs."""
    domain = conformance_domain(device)
    ids = list(range(24, 24 + n))
    docs_sync = fn(ids, domain, seeded_trials(domain), seed)
    dispatch, materialize = halves_of(fn)[:2]
    if dispatch is not None:
        docs_async = materialize(dispatch(ids, domain, seeded_trials(domain),
                                          seed))
    else:
        docs_async = fn(ids, domain, seeded_trials(domain), seed)
    assert json.loads(json.dumps(docs_sync)) == \
        json.loads(json.dumps(docs_async)), \
        "sync suggest and dispatch+materialize (or a re-run on an " \
        "identical history) disagree"
    assert [d["tid"] for d in docs_sync] == ids


def check_handle_protocol(fn, n=3, seed=77, device=None):
    """The four halves come together or not at all; ``handle_ready``
    returns a bool, ``start_transfer`` does not raise, materialize gives
    ``len(new_ids)`` docs, a forced handle and a startup one are ready.
    Returns ``"sync-only"`` or ``"dispatch-capable"``."""
    halves = halves_of(fn)
    dispatch, materialize, start_transfer, handle_ready = halves
    if all(h is None for h in halves):
        return "sync-only"
    assert all(h is not None for h in halves), \
        f"partial protocol: need all of {_HALVES} or none"
    domain = conformance_domain(device)
    ids = list(range(24, 24 + n))
    handle = dispatch(ids, domain, seeded_trials(domain), seed)
    assert isinstance(handle_ready(handle), bool)
    start_transfer(handle)
    docs = materialize(handle)
    assert len(docs) == n
    assert bool(handle_ready(handle)) is True  # forced => ready
    from .. import base

    cold = dispatch([0, 1], domain, base.Trials(), seed)
    assert handle_ready(cold) is True
    return "dispatch-capable"


def check_pipeline_depth2(fn, max_evals=26, seed=5, device=None):
    """A depth-2 pipelined ``fmin`` records every trial DONE (a sync-only
    head runs the ordinary loop)."""
    from .. import base
    from ..fmin import fmin

    domain = conformance_domain(device)
    t = base.Trials()
    fmin(_conformance_objective, domain.expr, algo=fn,
         max_evals=max_evals, trials=t, device=domain.cs.device,
         rstate=np.random.default_rng(seed), overlap_depth=2,
         show_progressbar=False, verbose=False)
    t.refresh()
    assert len(t.trials) == max_evals
    states = [d["state"] for d in t.trials]
    assert all(s == base.JOB_STATE_DONE for s in states), states
    assert t.best_trial["result"]["loss"] is not None


def check_transient_retry(fn, max_evals=6, seed=9, device=None):
    """With an armed ``objective.call`` fault and a retry budget, the run
    still records every trial DONE, some after a retry."""
    from .. import base, faults
    from ..fmin import fmin

    domain = conformance_domain(device)
    t = base.Trials()
    with faults.injected("objective.call", prob=1.0, times=2, seed=3):
        fmin(_conformance_objective, domain.expr, algo=fn,
             max_evals=max_evals, trials=t, device=domain.cs.device,
             rstate=np.random.default_rng(seed), max_trial_retries=3,
             show_progressbar=False, verbose=False)
    t.refresh()
    assert len(t.trials) == max_evals
    assert all(d["state"] == base.JOB_STATE_DONE for d in t.trials)
    retried = [d for d in t.trials if d["misc"].get("fail_count")]
    assert retried, "no trial recorded a retried transient fault"


def run_conformance(fn, device=None) -> dict:
    """Run the whole suite against one head; ``{check: outcome}``.  Raising
    nothing means the head works with ``fmin``, the pipeline and the fault
    harness."""
    return {
        "sync_parity": check_sync_parity(fn, device=device) or "ok",
        "handle_protocol": check_handle_protocol(fn, device=device),
        "pipeline_depth2": check_pipeline_depth2(fn, device=device) or "ok",
        "transient_retry": check_transient_retry(fn, device=device) or "ok",
    }

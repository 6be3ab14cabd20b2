"""Per-experiment optimizer-health verdicts.

Counterpart of ``hyperopt_tpu/obs/health.py``, unchanged: one verdict per
experiment from its trial docs and, through the suggest algorithm's
``introspect`` hook (``tpe.introspect``), from the model's own state:

* ``healthy``      improving, non-degenerate, acquisition has signal;
* ``warn``         high candidate duplication or a degenerate TPE
                   good/bad split;
* ``stagnating``   the best loss has not improved (relative to its own
                   scale) over the last ``window`` completed trials;
* ``ei_collapse``  the introspected EI has collapsed to noise relative to
                   the observed loss scale.

:func:`publish` sets the ``health.verdict.<label>`` gauge (the numeric
``VERDICT_CODE``); device mode publishes ``device:<label>`` at the end of
each run (``obs/devtel.py``).
"""

from __future__ import annotations

import functools
import math

from . import metrics as _metrics

__all__ = ["VERDICTS", "VERDICT_CODE", "assess", "publish"]

#: Severity-ordered verdict names; index = gauge code.
VERDICTS = ("healthy", "warn", "stagnating", "ei_collapse")
VERDICT_CODE = {name: i for i, name in enumerate(VERDICTS)}

_DONE = 2                       # base.JOB_STATE_DONE (no import cycle)


def _finite_losses(docs):
    """(tid-ordered losses of completed trials, n_docs_seen)."""
    done = []
    for d in docs:
        if d.get("state") != _DONE:
            continue
        loss = (d.get("result") or {}).get("loss")
        if loss is None:
            continue
        loss = float(loss)
        if math.isfinite(loss):
            done.append((d.get("tid", 0), loss))
    done.sort()
    return [l for _, l in done]


def _dup_rate(docs, window):
    """Duplicate fraction among the last ``window`` suggested points
    (rounded param fingerprints from ``misc.vals``)."""
    tail = sorted(docs, key=lambda d: d.get("tid", 0))[-window:]
    if len(tail) < 2:
        return None
    prints = []
    for d in tail:
        vals = ((d.get("misc") or {}).get("vals") or {})
        fp = tuple(sorted(
            (k, round(float(v[0]), 9) if v else None)
            for k, v in vals.items()))
        prints.append(fp)
    return 1.0 - len(set(prints)) / len(prints)


def unwrap(fn):
    """Peel keyword-only ``functools.partial`` wrappers down to the
    callable that carries the hook attributes."""
    while isinstance(fn, functools.partial):
        fn = fn.func
    return fn


def assess(docs, domain=None, trials=None, suggest_fn=None, *,
           window: int = 20, min_trials: int = 8,
           stagnation_tol: float = 1e-3, dup_tol: float = 0.5,
           ei_tol: float = 1e-3, introspect: bool = True,
           seed: int = 0) -> dict:
    """Health report for one experiment.

    ``docs`` drive the history checks; ``domain``/``trials`` (plus the
    backend's ``suggest_fn``) enable the introspection checks when all
    three are present and ``introspect`` is True.  Thresholds:

    * stagnation — relative best-loss improvement over the trailing
      ``window`` completed trials below ``stagnation_tol`` (evaluated
      once ``len >= min_trials`` and there is pre-window history);
    * duplication — fraction of repeated candidate fingerprints in the
      trailing window above ``dup_tol``;
    * EI collapse — introspected ``ei_rel`` (best candidate EI in raw
      loss units over the observed loss scale) below ``ei_tol``.
    """
    losses = _finite_losses(docs)
    n_done = len(losses)
    report = {
        "n_trials": len(docs),
        "n_done": n_done,
        "best_loss": min(losses) if losses else None,
        "checks": {},
        "introspection": None,
    }
    checks = report["checks"]

    # -- best-loss plateau / stagnation --------------------------------------
    stagnating = None
    if n_done >= max(min_trials, window + 1):
        best_before = min(losses[:-window])
        best_now = min(losses)
        scale = max(abs(best_before), 1e-12)
        improvement = (best_before - best_now) / scale
        checks["improvement_rel"] = improvement
        stagnating = improvement < stagnation_tol
    checks["stagnating"] = stagnating

    # -- candidate-set duplication -------------------------------------------
    dup = _dup_rate(docs, window)
    checks["dup_rate"] = dup
    checks["dup_high"] = None if dup is None else dup > dup_tol

    # -- backend introspection -----------------------------------------------
    ei_collapse = None
    split_degenerate = None
    if introspect and suggest_fn is not None and domain is not None \
            and trials is not None:
        hook = getattr(unwrap(suggest_fn), "introspect", None)
        if hook is not None:
            try:
                info = dict(hook(domain, trials, seed=seed))
            except Exception as e:   # diagnostics must never break serving
                info = {"error": f"{type(e).__name__}: {e}"}
            report["introspection"] = info
            if not info.get("insufficient") and "error" not in info:
                ei_rel = info.get("ei_rel")
                if ei_rel is not None:
                    ei_collapse = ei_rel < ei_tol
                if info.get("split_degenerate") is not None:
                    split_degenerate = bool(info["split_degenerate"])
    checks["ei_collapse"] = ei_collapse
    checks["split_degenerate"] = split_degenerate

    if ei_collapse:
        verdict = "ei_collapse"
    elif stagnating:
        verdict = "stagnating"
    elif checks["dup_high"] or split_degenerate:
        verdict = "warn"
    else:
        verdict = "healthy"
    report["verdict"] = verdict
    report["code"] = VERDICT_CODE[verdict]
    return report


# Bounded live-label set: experiment churn would otherwise grow one
# ``health.verdict.<store>`` gauge per store ever assessed.  Evictions
# bump ``obs.series_evicted``.
_VERDICT_LABELS = _metrics.LabelLru()


def publish(label: str, report: dict, reg=None) -> None:
    """Publish one report as the ``health.verdict.<store>`` gauge
    (value: ``VERDICT_CODE``) and bump ``health.assessments``.  The
    live gauge set is LRU-bounded; the verdict for an evicted store is
    republished on its next assessment."""
    reg = reg if reg is not None else _metrics.registry()
    for old in _VERDICT_LABELS.touch(label):
        reg.remove(f"health.verdict.{old}")
    reg.gauge(f"health.verdict.{label}").set(report["code"])
    reg.counter("health.assessments").inc()

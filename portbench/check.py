"""The comparisons that decide ``correct``: what the timed path produced,
held against the plain reference (``reference/``).

Every number is a reading that must not exceed its limit
(``checks/<workload>.json``):

- ``ei_gap``: over a sample of the window's TPE proposals, drawn from the
  seed with the longest history among them, and over every column a
  proposal's document carries, the widest gap by which the reference's
  score of the proposed value lies below the reference's best candidate
  (nats).  It covers the split, both Parzen fits, the candidate draws,
  every score sheet and the argmax;
- ``loss_rel_err``: over every trial of the window, the widest relative
  gap between the recorded loss and the objective the reference computes
  from the recorded row;
- ``active_mismatch``: rows whose recorded active set differs from the one
  the space's conditions give for the recorded values;
- ``support_violations``: recorded values outside their prior's support.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from . import peaks
from .reference import space as rspace
from .reference import tpe as rtpe


def prefix(rows, k):
    """The history before row ``k`` of a plain history (``program.plain_rows``
    layout)."""
    return {"vals": {lab: v[:k] for lab, v in rows["vals"].items()},
            "active": {lab: v[:k] for lab, v in rows["active"].items()},
            "loss": rows["loss"][:k], "ok": rows["ok"][:k]}


def pick(rng, n, k, keep=()):
    """``k`` distinct indices of ``range(n)`` drawn by ``rng``, ``keep``
    among them."""
    keep = [int(i) for i in keep if 0 <= i < n][:k]
    rest = np.setdiff1d(np.arange(n), keep)
    take = rng.choice(rest, size=min(k - len(keep), len(rest)),
                      replace=False) if k > len(keep) else []
    return sorted(set(keep) | {int(i) for i in take})


def step_gap(ps, settings, h, seed, values, dev):
    """``(gap, label)``: the widest gap over the columns in ``values``
    (``{label: proposed value}``) between the reference's best score and
    its score of the proposed value."""
    cols = rtpe.step(ps, h, seed, settings, dev)
    worst, at = -math.inf, None
    for lab, v in values.items():
        col = cols[lab]
        gap = col.best - col.score(float(v))
        if not gap <= worst:
            worst, at = gap, (lab, float(v), col.value)
    return worst, at


def widest_gap(ps, settings, steps, dev):
    """The widest :func:`step_gap` over ``steps`` (``(history, seed,
    values)``); the step it came from is named on standard error."""
    worst, where = -math.inf, None
    for h, seed, values in steps:
        gap, at = step_gap(ps, settings, h, seed, values, dev)
        if not gap <= worst:
            worst, where = gap, (len(h["loss"]), seed, *at)
    if where is not None:
        print("ei_gap: widest at history %d, seed %d, column %s: program "
              "%r, reference %r" % where, file=sys.stderr)
    return float(worst)


def objective(fn, labels, vals):
    """The configuration's objective ``fn`` (its space module's
    ``objective``, on ``{label: float}``) row by row over the ``labels``
    columns of ``vals`` (``{label: array}``), as the user's function sees
    each trial: float64[n]."""
    cols = [np.asarray(vals[lab], np.float64) for lab in labels]
    n = len(cols[0]) if cols else 0
    return np.asarray([fn({lab: float(c[i]) for lab, c in zip(labels, cols)})
                       for i in range(n)], np.float64)


def loss_rel_err(fn, labels, vals, loss):
    want = objective(fn, labels, vals)
    got = np.asarray(loss, np.float64)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    err = np.where(np.isfinite(got), err, np.inf)
    return float(err.max()) if len(err) else 0.0


def active_mismatch(ps, vals, live):
    """Rows whose active set is not the one the conditions give."""
    n = len(next(iter(vals.values())))
    bad = np.zeros(n, bool)
    want = {}
    for p in ps:
        ok = np.ones(n, bool)
        for label, branch in p["conditions"]:
            ok &= want[label] & (np.round(vals[label]) == branch)
        want[p["label"]] = ok
        bad |= ok != np.asarray(live[p["label"]], bool)
    return int(bad.sum())


def support_violations(ps, vals, live):
    """Distinct recorded values outside their prior's support; the first
    few are named on standard error."""
    n = 0
    for p in ps:
        v = np.asarray(vals[p["label"]], np.float64)[
            np.asarray(live[p["label"]], bool)]
        bad = [x for x in np.unique(v) if not rspace.in_support(p, float(x))]
        for x in bad[:3]:
            print(f"support: {p['label']} ({p['kind']}) = {x!r}",
                  file=sys.stderr)
        n += len(bad)
    return n


def k1_bound_s(ps, settings, histories):
    """The least time of the K1 launches of TPE steps from ``histories``,
    one launch each (``peaks.k1_bound_s``)."""
    return sum(peaks.k1_bound_s(*rtpe.live_terms(ps, h, settings),
                                settings.n_cand)[0] for h in histories)


def rows_checks(readings, cell, rows, sel=slice(None)):
    """Add ``loss_rel_err``, ``active_mismatch`` and ``support_violations``
    of the recorded rows ``sel`` of ``rows`` to ``readings``."""
    ps = cell.ps
    vals = {lab: v[sel] for lab, v in rows["vals"].items()}
    live = {lab: v[sel] for lab, v in rows["active"].items()}
    readings["loss_rel_err"] = max(readings.get("loss_rel_err", 0.0),
                                   loss_rel_err(cell.builder.objective,
                                                cell.labels, vals,
                                                rows["raw_loss"][sel]))
    for name, f in (("active_mismatch", active_mismatch),
                    ("support_violations", support_violations)):
        readings[name] = readings.get(name, 0) + f(ps, vals, live)


def is_tpe_step(rows, k, settings):
    """Whether the proposal at row ``k`` came from a TPE step: its history
    holds at least ``n_startup_jobs`` finished trials (before that the
    program draws from the prior, and only the support is checked)."""
    return int(rows["ok"][:k].sum()) >= settings.n_startup


def sampled_step(rows, k, seed):
    """Row ``k`` as a step to hold against the reference: ``(history
    before it, seed, {label: proposed value}`` over its active columns)."""
    return (prefix(rows, k), seed, {lab: v[k] for lab, v in rows["vals"].items()
                                    if rows["active"][lab][k]})


def verdict(readings, limits):
    """``(correct, lines)``: each reading against its limit; a reading that
    is missing or not a number fails."""
    ok = True
    out = {}
    for name, lim in limits.items():
        v = readings.get(name)
        good = v is not None and not math.isnan(v) and v <= lim["limit"]
        ok &= good
        out[name] = {"value": v, "limit": lim["limit"]}
    return bool(ok), out

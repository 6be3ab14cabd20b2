"""A plain description of a search space, built by the same space builders
the program gets (``portbench/spaces/``), for the reference and for the
harness's own history generator.

``PLAIN_HP`` stands in for the program's ``hp`` module: each constructor
returns a plain node, and :func:`params` walks the nested structure depth
first, in the order the builder wrote it (a choice's index before its
branches), which is the order users see their parameters in.  Each
parameter is a dict with ``label``, ``kind``, its bounds, ``q``,
``n_options`` and ``conditions``: ``((index label, branch), ...)``, all of
which must hold for it to be active.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

UNIFORM_FAMILY = ("uniform", "loguniform", "quniform", "qloguniform",
                  "uniformint")
NORMAL_FAMILY = ("normal", "lognormal", "qnormal", "qlognormal")
LOG_KINDS = ("loguniform", "qloguniform", "lognormal", "qlognormal")
Q_KINDS = ("quniform", "qloguniform", "qnormal", "qlognormal", "uniformint")


def _param(kind, label, **kw):
    return ("param", dict(label=label, kind=kind, **kw))


PLAIN_HP = SimpleNamespace(
    uniform=lambda label, low, high: _param(
        "uniform", label, low=float(low), high=float(high)),
    loguniform=lambda label, low, high: _param(
        "loguniform", label, low=float(low), high=float(high)),
    quniform=lambda label, low, high, q: _param(
        "quniform", label, low=float(low), high=float(high), q=float(q)),
    qloguniform=lambda label, low, high, q: _param(
        "qloguniform", label, low=float(low), high=float(high), q=float(q)),
    normal=lambda label, mu, sigma: _param(
        "normal", label, mu=float(mu), sigma=float(sigma)),
    lognormal=lambda label, mu, sigma: _param(
        "lognormal", label, mu=float(mu), sigma=float(sigma)),
    qnormal=lambda label, mu, sigma, q: _param(
        "qnormal", label, mu=float(mu), sigma=float(sigma), q=float(q)),
    qlognormal=lambda label, mu, sigma, q: _param(
        "qlognormal", label, mu=float(mu), sigma=float(sigma), q=float(q)),
    uniformint=lambda label, low, high: _param(
        "uniformint", label, low=float(low), high=float(high), q=1.0),
    choice=lambda label, options: ("choice", label, list(options)),
)


def params(space):
    """The parameters of a plain space, depth first."""
    out = []

    def walk(node, conds):
        if isinstance(node, tuple) and node and node[0] == "param":
            out.append(dict(node[1], conditions=conds))
        elif isinstance(node, tuple) and node and node[0] == "choice":
            _, label, options = node
            out.append(dict(label=label, kind="choice",
                            n_options=len(options), conditions=conds))
            for b, opt in enumerate(options):
                walk(opt, conds + ((label, b),))
        elif isinstance(node, dict):
            for v in node.values():
                walk(v, conds)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, conds)

    walk(space, ())
    return out


def active(ps, values):
    """``{label: bool}``: which parameters are live under ``values``
    (``{label: value}``, where a choice's value is its branch index)."""
    live = {}
    for p in ps:
        ok = True
        for label, branch in p["conditions"]:
            v = values.get(label)
            if v is None or not live.get(label) or int(round(v)) != branch:
                ok = False
        live[p["label"]] = ok
    return live


def in_support(p, v):
    """Whether value ``v`` lies in parameter ``p``'s support."""
    if not np.isfinite(v):
        return False
    kind = p["kind"]
    if kind == "choice":
        return v == round(v) and 0 <= v < p["n_options"]
    if kind == "uniformint":
        return v == round(v) and p["low"] <= v <= p["high"]
    if kind in NORMAL_FAMILY:
        return kind not in LOG_KINDS or v >= 0
    lo, hi = p["low"], p["high"]
    if kind in LOG_KINDS:
        lo, hi = np.exp(lo), np.exp(hi)
    if kind in Q_KINDS:
        if abs(v / p["q"] - round(v / p["q"])) > 1e-5:
            return False
        lo, hi = round(lo / p["q"]) * p["q"], round(hi / p["q"]) * p["q"]
    return lo - 1e-6 * (abs(lo) + 1) <= v <= hi + 1e-6 * (abs(hi) + 1)


def sample(ps, n, rng):
    """``n`` prior draws as ``({label: f32[n]}, {label: bool[n]})``: the
    value of every parameter (0 where a branch leaves it out) and its
    activity, from ``rng`` (a numpy Generator)."""
    vals, live = {}, {}
    for p in ps:
        kind = p["kind"]
        if kind == "choice":
            v = rng.integers(0, p["n_options"], n).astype(np.float64)
        elif kind == "uniformint":
            v = rng.integers(int(p["low"]), int(p["high"]) + 1,
                             n).astype(np.float64)
        elif kind in UNIFORM_FAMILY:
            v = rng.uniform(p["low"], p["high"], n)
        else:
            v = rng.normal(p["mu"], p["sigma"], n)
        if kind in LOG_KINDS:
            v = np.exp(v)
        if kind in Q_KINDS and kind != "uniformint":
            v = np.round(v / p["q"]) * p["q"]
        ok = np.ones(n, bool)
        for label, branch in p["conditions"]:
            ok &= live[label] & (vals[label] == branch)
        live[p["label"]] = ok
        vals[p["label"]] = np.where(ok, v, 0.0).astype(np.float32)
    return vals, live

"""Loop utilities (progress reporting, early stopping), the reference's
trial-doc helpers and :func:`parameter_importance`.

Counterpart of ``hyperopt_tpu/utils/__init__.py``.
"""

from __future__ import annotations

import numpy as np


def fast_isin(X, X_all):
    """Boolean membership of ``X`` in ``X_all``."""
    return np.isin(X, X_all)


def get_most_recent_inds(obj):
    """Indices of the newest version of each ``tid`` in a list of trial
    docs (refreshed docs deduplicated by ``(tid, version)``)."""
    data = np.rec.fromarrays(
        [np.asarray([d["tid"] for d in obj]),
         np.asarray([d.get("version", 0) for d in obj])],
        names=["tid", "version"])
    order = np.argsort(data, order=["tid", "version"])
    sorted_data = data[order]
    keep = np.ones(len(obj), dtype=bool)
    keep[:-1] = sorted_data["tid"][1:] != sorted_data["tid"][:-1]
    return order[keep]


def parameter_importance(trials, space):
    """Per-parameter importance of a finished experiment, ``{label:
    score}``: the bias-adjusted between-group variance ratio (η²) of the
    loss across value groups (quantile bins for numeric parameters), the
    statistic ATPE's lockout arms use online
    (:func:`hyperopt_tpu_torch.atpe.parameter_importance`).  The reference
    has no such API."""
    from ..atpe import parameter_importance as _imp
    from ..space import compile_space

    cs = compile_space(space)
    imp = _imp(trials.history(cs), cs)
    return {p.label: float(imp[p.pid]) for p in cs.params}

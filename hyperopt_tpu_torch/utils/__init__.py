"""Loop utilities (progress reporting, early stopping) and the reference's
trial-doc helpers.

Counterpart of ``hyperopt_tpu/utils/__init__.py`` without
``parameter_importance``, which goes with ``atpe.py`` in the slice of the
other suggest heads.
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

"""State carried across from the JAX package.

Both packages keep trials as the same plain-dict documents and the same
dense history layout, so moving state over is a copy:

* :func:`history_from_numpy` turns a ``hyperopt_tpu`` ``Trials.history()``
  dict (numpy arrays) into tensors on a device;
* :func:`trials_from_jax_docs` builds a port ``Trials`` from the docs of a
  ``hyperopt_tpu`` ``Trials`` (or any iterable of trial docs).

Neither imports the JAX package: they read only numpy arrays and dicts.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .base import trials_from_docs

_HISTORY_DTYPES = {"vals": np.float32, "active": bool, "loss": np.float32,
                   "ok": bool, "tids": np.int64}


def history_from_numpy(h, device):
    """``{vals, active, loss, ok, tids}`` numpy arrays -> tensors on
    ``device`` with the history's dtypes (f32, bool, f32, bool, i64)."""
    return {k: torch.as_tensor(np.asarray(h[k], dtype=dt), device=device)
            for k, dt in _HISTORY_DTYPES.items()}


def trials_from_jax_docs(docs, **kwargs):
    """A port ``Trials`` holding deep copies of ``docs`` (a JAX ``Trials``
    iterates over its docs).  ``kwargs`` go to ``Trials`` (``exp_key``)."""
    return trials_from_docs(copy.deepcopy(list(docs)), **kwargs)

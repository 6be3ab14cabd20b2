"""Mixture suggest algorithm: each call goes to one sub-algorithm.

Counterpart of ``hyperopt_tpu/mix.py`` (reference: ``hyperopt/mix.py``):
``p_suggest=[(p, algo), ...]`` picks one algorithm per call with
probability ``p``, e.g. an ε-greedy blend of random search and TPE::

    fmin(fn, space, max_evals=100,
         algo=partial(mix.suggest,
                      p_suggest=[(0.1, rand.suggest), (0.9, tpe.suggest)]))

An algorithm may also be a backend-registry name (``"rand"``, ``"gp"``,
...), resolved by :func:`hyperopt_tpu_torch.backends.resolve`.
"""

from __future__ import annotations

import numpy as np


def suggest(new_ids, domain, trials, seed, p_suggest):
    """Call one of ``p_suggest``'s algorithms, chosen with its probability;
    the choice and the sub-algorithm's seed come from one numpy stream
    seeded with ``seed``.  A name the registry does not know raises its
    ``UnknownBackend``."""
    ps = [p for p, _ in p_suggest]
    if not np.isclose(sum(ps), 1.0, atol=1e-3):
        raise ValueError(f"p_suggest probabilities sum to {sum(ps)}, not 1")
    rng = np.random.default_rng(int(seed) % (2 ** 32))
    idx = rng.choice(len(ps), p=np.asarray(ps) / sum(ps))
    _, algo = p_suggest[idx]
    if isinstance(algo, str):
        from .backends import contract as _backends

        algo = _backends.resolve(algo)
    return algo(new_ids, domain, trials, seed=int(rng.integers(2 ** 31 - 1)))

"""Compatibility names over :mod:`hyperopt_tpu_torch.dispatch`.

Counterpart of ``hyperopt_tpu/parallel/sharded.py``: the mesh machinery
lives in ``dispatch.py``, where a registered mesh makes plain
``tpe.suggest`` the sharded path.  This module keeps the historical names
and the ``algo=`` callable :func:`sharded_suggest`, with its
4,096-candidate default.
"""

from __future__ import annotations

from .. import rand
from .. import tpe as _tpe
from ..dispatch import (  # noqa: F401  (compatibility re-exports)
    CAND_AXIS,
    START_AXIS,
    ShardedTpeKernel,
    _gamma_spread,
    _mesh_key,
    default_mesh,
    multi_start_suggest,
)
from ..tpe import (  # noqa: F401  (compatibility re-exports)
    _batch_size_for,
    _bucket,
    _default_gamma,
    _default_linear_forgetting,
    _default_n_EI_candidates,
    _default_n_startup_jobs,
    _default_prior_weight,
)


def _get_sharded_kernel(cs, n_cap, n_cand, lf, mesh, split="sqrt",
                        multivariate=False, cat_prior="sqrt", device="cuda",
                        **lowerings):
    """The sharded kernel of ``dispatch.get_kernel``, strict: a candidate
    count the mesh's ``sp`` axis does not divide raises ``ValueError``.
    ``lowerings``: ``tpe.get_kernel``'s EI and sampler keywords."""
    from .. import dispatch

    return dispatch.get_kernel(cs, n_cap, n_cand, lf, split, cat_prior,
                               device, multivariate=multivariate,
                               mesh=mesh, strict=True, **lowerings)


def sharded_suggest(new_ids, domain, trials, seed, mesh=None,
                    prior_weight=_default_prior_weight,
                    n_startup_jobs=_default_n_startup_jobs,
                    n_EI_candidates=4096,
                    gamma=_default_gamma,
                    linear_forgetting=_default_linear_forgetting,
                    split="sqrt", multivariate=False, startup=None,
                    cat_prior="sqrt", **lowerings):
    """``algo=`` callable: TPE with its candidates sharded over ``mesh``
    (default: the active mesh, else :func:`default_mesh` over the process
    group), strict about divisibility.  Defaults to 4,096 candidates;
    takes ``tpe.suggest``'s keywords (``lowerings``: ``ei_impl``,
    ``ei_precision``, ``ei_topm``, ``resident``, ``comp_sampler``,
    ``split_impl``, ``fused_step``, ``noise``)."""
    from .. import dispatch

    cs = domain.cs
    if cs.n_params == 0:
        return rand.suggest(new_ids, domain, trials, seed)
    if mesh is None:
        mesh = dispatch.active_mesh() or default_mesh()
    handle = dispatch.suggest_dispatch(
        new_ids, domain, trials, seed, mesh=mesh, strict=True,
        prior_weight=prior_weight, n_startup_jobs=n_startup_jobs,
        n_EI_candidates=n_EI_candidates, gamma=gamma,
        linear_forgetting=linear_forgetting, split=split,
        multivariate=multivariate, startup=startup, cat_prior=cat_prior,
        **lowerings)
    return _tpe.suggest_materialize(handle)

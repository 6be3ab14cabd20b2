"""Public search-space DSL (counterpart of ``hyperopt_tpu/hp.py``).

Every constructor returns a :class:`~hyperopt_tpu_torch.space.Expr` node;
nested dicts/lists/tuples of nodes form a space, compiled once by
:func:`hyperopt_tpu_torch.space.compile_space`.

Sampling semantics:

* ``uniform(label, low, high)`` — U[low, high]
* ``loguniform(label, low, high)`` — exp(U[low, high]) (bounds in log space)
* ``quniform`` / ``qloguniform`` — ``round(x / q) * q``
* ``normal(label, mu, sigma)`` / ``lognormal`` / ``qnormal`` / ``qlognormal``
* ``randint(label, upper)`` or ``randint(label, low, upper)`` — integer in
  [low, upper)
* ``uniformint(label, low, high)`` — integer in [low, high], inclusive
* ``choice(label, options)`` — one of the option sub-spaces
* ``pchoice(label, [(p, option), ...])`` — weighted choice
"""

from __future__ import annotations

from .space import (
    Choice,
    Expr,
    LOGNORMAL,
    LOGUNIFORM,
    NORMAL,
    Param,
    QLOGNORMAL,
    QLOGUNIFORM,
    QNORMAL,
    QUNIFORM,
    RANDINT,
    UNIFORM,
    UNIFORMINT,
)

__all__ = [
    "uniform", "loguniform", "quniform", "qloguniform",
    "normal", "lognormal", "qnormal", "qlognormal",
    "randint", "uniformint", "choice", "pchoice",
]


def uniform(label, low, high) -> Expr:
    """Uniform float in [low, high]."""
    return Param(label, UNIFORM, low=low, high=high)


def loguniform(label, low, high) -> Expr:
    """exp(U[low, high]) — i.e. log of the value is uniform; bounds in log space."""
    return Param(label, LOGUNIFORM, low=low, high=high)


def quniform(label, low, high, q) -> Expr:
    """round(U[low, high] / q) * q."""
    return Param(label, QUNIFORM, low=low, high=high, q=q)


def qloguniform(label, low, high, q) -> Expr:
    """round(exp(U[low, high]) / q) * q."""
    return Param(label, QLOGUNIFORM, low=low, high=high, q=q)


def normal(label, mu, sigma) -> Expr:
    """Normal(mu, sigma), unbounded."""
    return Param(label, NORMAL, mu=mu, sigma=sigma)


def lognormal(label, mu, sigma) -> Expr:
    """exp(Normal(mu, sigma)) — positive, log is normal."""
    return Param(label, LOGNORMAL, mu=mu, sigma=sigma)


def qnormal(label, mu, sigma, q) -> Expr:
    """round(Normal(mu, sigma) / q) * q."""
    return Param(label, QNORMAL, mu=mu, sigma=sigma, q=q)


def qlognormal(label, mu, sigma, q) -> Expr:
    """round(exp(Normal(mu, sigma)) / q) * q."""
    return Param(label, QLOGNORMAL, mu=mu, sigma=sigma, q=q)


def randint(label, *args) -> Expr:
    """``randint(label, upper)`` → int in [0, upper);
    ``randint(label, low, upper)`` → int in [low, upper)."""
    if len(args) == 1:
        low, high = 0, args[0]
    elif len(args) == 2:
        low, high = args
    else:
        raise TypeError("randint takes (label, upper) or (label, low, upper)")
    return Param(label, RANDINT, low=low, high=high)


def uniformint(label, low, high, q=1.0) -> Expr:
    """Integer uniform on [low, high], inclusive (reference: quniform q=1 → int)."""
    if float(q) != 1.0:
        raise ValueError("q must be 1.0 for uniformint (reference behavior)")
    return Param(label, UNIFORMINT, low=low, high=high)


def choice(label, options) -> Expr:
    """Select one of ``options`` (each may be any nested sub-space)."""
    return Choice(label, options)


def pchoice(label, p_options) -> Expr:
    """Weighted choice: ``p_options = [(prob, option), ...]``."""
    probs = [p for p, _ in p_options]
    options = [o for _, o in p_options]
    return Choice(label, options, probs=probs)

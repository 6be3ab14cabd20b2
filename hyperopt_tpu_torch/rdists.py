"""Scipy-style frozen distributions of the space's families.

Counterpart of ``hyperopt_tpu/rdists.py`` (a copy: numpy and scipy only):
``loguniform_gen``, ``lognorm_gen``, the quantized ``quniform_gen``,
``qloguniform_gen``, ``qnormal_gen``, ``qlognormal_gen`` and
``uniformint_gen``.  Host-side test oracles, not the port's sampling path:
plain numpy/scipy over the math the compiled samplers implement, so that
the two disagree only if one of them is wrong.
"""

from __future__ import annotations

import numpy as np
from scipy import stats


class loguniform_gen:
    """exp(U[low, high]) — reference: rdists.py::loguniform_gen (bounds in
    log space, like ``hp.loguniform``)."""

    def __init__(self, low, high):
        self.low = float(low)
        self.high = float(high)

    def rvs(self, size=(), random_state=None):
        rng = np.random.default_rng(random_state)
        return np.exp(rng.uniform(self.low, self.high, size))

    def pdf(self, x):
        x = np.asarray(x, dtype=float)
        inb = (x >= np.exp(self.low)) & (x <= np.exp(self.high))
        with np.errstate(divide="ignore", invalid="ignore"):
            p = 1.0 / (x * (self.high - self.low))
        return np.where(inb, p, 0.0)

    def cdf(self, x):
        x = np.asarray(x, dtype=float)
        with np.errstate(divide="ignore"):
            c = (np.log(np.maximum(x, 1e-300)) - self.low) \
                / (self.high - self.low)
        return np.clip(c, 0.0, 1.0)


class lognorm_gen:
    """exp(N(mu, sigma)) — reference: rdists.py::lognorm_gen."""

    def __init__(self, mu, sigma):
        self.mu = float(mu)
        self.sigma = float(sigma)
        self._dist = stats.lognorm(s=self.sigma, scale=np.exp(self.mu))

    def rvs(self, size=(), random_state=None):
        rng = np.random.default_rng(random_state)
        return np.exp(rng.normal(self.mu, self.sigma, size))

    def pdf(self, x):
        return self._dist.pdf(x)

    def cdf(self, x):
        return self._dist.cdf(x)


class _quantized_gen:
    """Base for q-distributions: v = round(draw / q) * q.

    ``pmf(v)`` is the mass of the continuous parent on
    ``[v - q/2, v + q/2]`` (the bin that rounds to v).
    """

    def __init__(self, q):
        self.q = float(q)
        if self.q <= 0:
            raise ValueError("q must be > 0")

    # subclasses define _parent_rvs(rng, size) and _parent_cdf(x)

    def rvs(self, size=(), random_state=None):
        rng = np.random.default_rng(random_state)
        return np.round(self._parent_rvs(rng, size) / self.q) * self.q

    def pmf(self, v):
        v = np.asarray(v, dtype=float)
        on_lattice = np.isclose(np.round(v / self.q) * self.q, v)
        lo = self._parent_cdf(v - self.q / 2.0)
        hi = self._parent_cdf(v + self.q / 2.0)
        return np.where(on_lattice, hi - lo, 0.0)

    def support_lattice(self, lo, hi):
        """All lattice points v=k·q intersecting [lo, hi] (test helper)."""
        k0 = int(np.floor(lo / self.q))
        k1 = int(np.ceil(hi / self.q))
        return np.arange(k0, k1 + 1) * self.q


class quniform_gen(_quantized_gen):
    """round(U[low, high] / q) * q — reference: rdists.py::quniform_gen."""

    def __init__(self, low, high, q):
        super().__init__(q)
        self.low = float(low)
        self.high = float(high)

    def _parent_rvs(self, rng, size):
        return rng.uniform(self.low, self.high, size)

    def _parent_cdf(self, x):
        return np.clip((np.asarray(x, dtype=float) - self.low)
                       / (self.high - self.low), 0.0, 1.0)


class qloguniform_gen(_quantized_gen):
    """round(exp(U[low, high]) / q) * q."""

    def __init__(self, low, high, q):
        super().__init__(q)
        self._parent = loguniform_gen(low, high)

    def _parent_rvs(self, rng, size):
        return np.exp(rng.uniform(self._parent.low, self._parent.high, size))

    def _parent_cdf(self, x):
        return self._parent.cdf(np.maximum(np.asarray(x, dtype=float), 0.0))


class qnormal_gen(_quantized_gen):
    """round(N(mu, sigma) / q) * q."""

    def __init__(self, mu, sigma, q):
        super().__init__(q)
        self.mu = float(mu)
        self.sigma = float(sigma)

    def _parent_rvs(self, rng, size):
        return rng.normal(self.mu, self.sigma, size)

    def _parent_cdf(self, x):
        return stats.norm.cdf(x, self.mu, self.sigma)


class qlognormal_gen(_quantized_gen):
    """round(exp(N(mu, sigma)) / q) * q."""

    def __init__(self, mu, sigma, q):
        super().__init__(q)
        self._parent = lognorm_gen(mu, sigma)

    def _parent_rvs(self, rng, size):
        return np.exp(rng.normal(self._parent.mu, self._parent.sigma, size))

    def _parent_cdf(self, x):
        x = np.asarray(x, dtype=float)
        return np.where(x <= 0, 0.0, self._parent.cdf(np.maximum(x, 1e-300)))


class uniformint_gen(quniform_gen):
    """hp.uniformint: quniform(low-0.5, high+0.5, q=1) clipped to ints."""

    def __init__(self, low, high):
        super().__init__(low - 0.5, high + 0.5, 1.0)
        self._lo, self._hi = int(low), int(high)

    def rvs(self, size=(), random_state=None):
        return np.clip(super().rvs(size, random_state), self._lo, self._hi)

"""Truncated 1-D Gaussian mixtures: log-pdf, quantized log-mass, sampling.

Counterpart of ``hyperopt_tpu/ops/gmm.py``.  Every function takes a batch
of mixtures along the leading axes: ``logw/mu/sigma`` are ``[..., K]``
(``-inf`` log-weights on dead components), points are ``[..., n]`` and
truncation bounds are ``[...]``.

Sampling is inverse-CDF: the component is picked by a CDF compare on one
uniform (or, ``gumbel=True``, by the Gumbel-argmax trick over ``K``
uniforms), then the truncated normal is drawn as ``ndtri(U[Φ(a), Φ(b)])``
and clipped into ``[a, b]`` (the JAX package does not clip, and near a
bound its float32 draw can land just outside).
The uniforms are arguments, so callers (and tests) can hand in the same
numbers the JAX version draws.

Every float sum runs in a fixed order (``fixed_order.py``), so a mixture
scores and samples the same bits whatever batch it sits in.

Log kinds are scored in fit (log) space; the ``1/x`` Jacobian cancels in
the EI difference and is omitted, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from .fixed_order import prefix_sum, tree_logsumexp

#: Functions that run under device mode's CUDA graph capture, called
#: from another module: the capture-purity analyzer starts there.
CAPTURED_ENTRY_POINTS = (
    "gmm_logpdf",
    "gmm_log_qmass",
    "gmm_sample",
    "icdf_pick",
    "gumbel_pick",
    "truncate_mixture",
)

_TINY = 1e-12
_U_MAX = 1.0 - 1e-7
# Smallest normal float32: the lower end of jax.random.gumbel's uniforms.
_F32_TINY = float(torch.finfo(torch.float32).tiny)
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def onehot_lookup(idx, table, fill=0.0):
    """``table[..., idx]`` along the last axis, as a gather.

    The contract of the JAX helper (which lowers to a one-hot matmul on
    the TPU): indices are clipped to ``[0, k-1]``, and non-finite table
    entries read as ``fill``.  ``idx``: int ``[..., n]``; ``table``: ``[K]``
    or ``[..., K]`` with the same leading shape as ``idx``."""
    k = table.shape[-1]
    idx = torch.clamp(idx.to(torch.int64), 0, k - 1)
    tab = torch.where(torch.isfinite(table), table,
                      torch.full_like(table, fill))
    if table.dim() == 1:
        return tab[idx]
    return torch.gather(tab, -1, idx)


def log_ndtr_diff(a, b):
    """``log(Φ(b) − Φ(a))`` computed stably, assuming ``a <= b``.

    Handles ±inf bounds; uses ``Φ(b) − Φ(a) = Φ(−a) − Φ(−b)`` when both
    bounds are positive to avoid cancellation."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    flip = a > 0.0
    lo = torch.where(flip, -b, a)
    hi = torch.where(flip, -a, b)
    llo = torch.special.log_ndtr(lo)
    lhi = torch.special.log_ndtr(hi)
    # d = log Φ(lo) − log Φ(hi) <= 0; equal −inf bounds mean zero mass.
    both_ninf = torch.isneginf(llo) & torch.isneginf(lhi)
    d = torch.where(both_ninf, torch.full_like(llo, -float("inf")), llo - lhi)
    d = torch.clamp_max(d, 0.0)
    return lhi + torch.log1p(-torch.exp(d))


def _bounds(x, like):
    return torch.as_tensor(x, dtype=torch.float32,
                           device=like.device).expand(like.shape[:-1])


def _log_trunc_mass(logw, mu, sigma, trunc_lo, trunc_hi):
    """Per-component ``log(w_k · mass_k)`` (``mass_k``: in-bounds
    probability of component k) and the normalizer ``log Σ_k w_k mass_k``.
    Dead components stay −inf."""
    lo = _bounds(trunc_lo, logw)[..., None]
    hi = _bounds(trunc_hi, logw)[..., None]
    log_wmass = logw + log_ndtr_diff((lo - mu) / sigma, (hi - mu) / sigma)
    return log_wmass, tree_logsumexp(log_wmass, dim=-1)


def gmm_logpdf(z, logw, mu, sigma, trunc_lo=-math.inf, trunc_hi=math.inf):
    """Log-density of truncated GMMs at fit-space points ``z [..., n]``.

    Truncation renormalizes globally: ``pdf(x) = Σ_k w_k N(x; k) /
    Σ_k w_k mass_k``.  Returns f32[..., n], −inf outside the bounds."""
    _, log_z = _log_trunc_mass(logw, mu, sigma, trunc_lo, trunc_hi)
    t = (z[..., :, None] - mu[..., None, :]) / sigma[..., None, :]
    lp = -0.5 * t * t - torch.log(sigma)[..., None, :] - _HALF_LOG_2PI
    out = tree_logsumexp(lp + logw[..., None, :], dim=-1) - log_z[..., None]
    lo = _bounds(trunc_lo, logw)[..., None]
    hi = _bounds(trunc_hi, logw)[..., None]
    in_bounds = (z >= lo) & (z <= hi)
    return torch.where(in_bounds, out, torch.full_like(out, -float("inf")))


def truncate_mixture(logw, mu, sigma, m):
    """The top-``m``-by-weight components of a batch of mixtures:
    ``[..., K]`` → ``[..., m]`` (unchanged when ``m >= K``).

    Counterpart of the JAX helper (``lax.top_k`` + ``take_along_axis``),
    the above-model prefilter of the EI block: a component whose weight
    is far below the dominant one adds less than float32 epsilon near the
    modes that decide the argmax.  A heuristic, not an identity.  Equal
    weights keep the lower index first, as ``lax.top_k`` does (a stable
    descending sort; ``torch.topk`` leaves the order of ties open), so
    the dead (``-inf``) slots kept when fewer than ``m`` are live are the
    same ones.  Component order is by weight, not by mu."""
    if m >= logw.shape[-1]:
        return logw, mu, sigma
    lw, idx = torch.sort(logw, dim=-1, descending=True, stable=True)
    idx = idx[..., :m]
    return (lw[..., :m].contiguous(), torch.gather(mu, -1, idx),
            torch.gather(sigma, -1, idx))


def gmm_log_qmass(zl, zh, logw, mu, sigma, trunc_lo=-math.inf,
                  trunc_hi=math.inf):
    """Log probability mass of truncated GMMs on fit-space bins
    ``[zl, zh]`` (``[..., n]``), renormalized by the truncation mass.
    A −inf lower edge encodes a bin reaching the support boundary."""
    _, log_z = _log_trunc_mass(logw, mu, sigma, trunc_lo, trunc_hi)
    lo = _bounds(trunc_lo, logw)[..., None]
    hi = _bounds(trunc_hi, logw)[..., None]
    a = (torch.maximum(zl, lo)[..., :, None] - mu[..., None, :]) \
        / sigma[..., None, :]
    b = (torch.minimum(zh, hi)[..., :, None] - mu[..., None, :]) \
        / sigma[..., None, :]
    log_mass = log_ndtr_diff(a, torch.maximum(a, b))             # [..., n, K]
    return (tree_logsumexp(log_mass + logw[..., None, :], dim=-1)
            - log_z[..., None])


def icdf_pick(u, cdf, last):
    """Inverse-CDF index pick over the last axis.

    ``u``: uniforms in [0, 1), ``[..., n]``; ``cdf``: inclusive cumsum of
    (possibly zero-padded) masses, ``[..., K]``; ``last``: highest pickable
    index (broadcastable to ``u``).  ``u`` is scaled by the total mass
    ``cdf[..., -1]`` so a cumsum that saturates below a near-1 uniform
    cannot pick a trailing pad; ``last`` covers the one-ULP case where
    ``u·total`` rounds up to the total."""
    u = (u * cdf[..., -1:]).contiguous()
    # Count of cdf[..., :-1] entries <= u: the JAX version's
    # sum(u >= cdf[:-1]), as a binary search over the sorted cumsum.
    idx = torch.searchsorted(cdf[..., :-1].contiguous(), u, right=True)
    return torch.minimum(idx, torch.as_tensor(last, device=idx.device))


def gumbel_pick(u, logits):
    """Gumbel-argmax index pick over the last axis: ``jax.random.
    categorical``'s lowering, from its uniforms.

    ``u``: uniforms in [0, 1), ``[..., n, K]`` (what ``jax.random.uniform``
    draws from the key ``gumbel`` gets); ``logits``: ``[..., K]``, ``-inf``
    on options never picked.  The uniforms map as ``gumbel(mode="low")``
    maps its own (``uniform(minval=tiny, maxval=1)``, then
    ``-log(-log(·))``); the first maximum wins.  Returns int64 ``[..., n]``."""
    g = -torch.log(-torch.log(torch.clamp_min(u + _F32_TINY, _F32_TINY)))
    return torch.argmax(g + logits[..., None, :], dim=-1)


def gmm_sample(logw, mu, sigma, trunc_lo, trunc_hi, uc, u, gumbel=False):
    """Fit-space draws from truncated GMMs, inverse-CDF style.

    ``logw/mu/sigma``: ``[..., K]``; ``trunc_lo/hi``: ``[...]``;
    ``uc``/``u``: uniforms ``[..., n]`` for the component pick and for the
    truncated normal (``gumbel=True``: ``uc`` is ``[..., n, K]``, the
    pick's Gumbel uniforms, :func:`gumbel_pick`).  The component is drawn
    ∝ ``w_k · mass_k`` (what a rejection sampler induces), then
    ``ndtri(U[Φ(a), Φ(b)])``."""
    log_wmass, log_z = _log_trunc_mass(logw, mu, sigma, trunc_lo, trunc_hi)
    if gumbel:
        comp = gumbel_pick(uc, log_wmass)
    else:
        cdf = prefix_sum(torch.exp(log_wmass - log_z[..., None]), dim=-1)
        # Clamp to the highest live index (components are mu-sorted; an
        # interior underflowed one must not take the top CDF segment).
        k_idx = torch.arange(log_wmass.shape[-1], device=logw.device)
        last_live = torch.amax(torch.where(log_wmass > -math.inf, k_idx,
                                           torch.full_like(k_idx, -1)),
                               dim=-1)
        comp = icdf_pick(uc, cdf, last_live[..., None])
    m = onehot_lookup(comp, mu, 0.0)
    s = onehot_lookup(comp, sigma, 1.0)
    lo = _bounds(trunc_lo, logw)[..., None]
    hi = _bounds(trunc_hi, logw)[..., None]
    pa = torch.special.ndtr((lo - m) / s)
    pb = torch.special.ndtr((hi - m) / s)
    u = pa + u * (pb - pa)
    # Away from {0, 1}: ndtri(0/1) = ∓inf would escape the bounds.
    u = torch.clamp(u, _TINY, _U_MAX)
    # Near a bound float32's ndtr reads the tail mass short (and the clamp
    # above lifts it), so ndtri can land a hair outside: clip into the
    # truncation, where the exact draw lies.
    x = torch.special.ndtri(u) * s + m
    return torch.minimum(torch.maximum(x, lo), hi)

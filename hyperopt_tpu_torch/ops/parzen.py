"""Adaptive-Parzen estimator fitting over padded, batched columns.

Counterpart of ``hyperopt_tpu/ops/parzen.py``.  The JAX version fits one
column and is ``vmap``-ed; here the column axis is an explicit leading
batch dimension.

Estimator:

* observations are sorted and the prior is inserted as one extra component
  at its sorted position;
* each component's bandwidth is the max distance to its sorted neighbors
  (one-sided at the edges; ``prior_sigma/2`` when there is a single
  observation), clipped to ``[prior_sigma/min(100, 1+m), prior_sigma]``;
* the prior component keeps ``sigma = prior_sigma`` and weight
  ``prior_weight``; observation weights come from linear forgetting;
* weights are normalized to sum to 1.
"""

from __future__ import annotations

import torch


def forgetting_weights(rank, n_obs, lf):
    """Linear-forgetting weight for observations by recency rank.

    ``rank`` — 0-based age order (0 = oldest); ``n_obs`` — live
    observations; ``lf`` — horizon.  The newest ``lf`` observations weigh
    1.0; older ones ramp linearly up from ``1/n_obs``.  Broadcasts; f32."""
    rank = torch.as_tensor(rank).to(torch.float32)
    n_obs = torch.as_tensor(n_obs, device=rank.device).to(torch.float32)
    n_ramp = torch.clamp_min(n_obs - lf, 0.0)
    a = 1.0 / torch.clamp_min(n_obs, 1.0)
    denom = torch.clamp_min(n_ramp - 1.0, 1.0)
    ramp = a + (1.0 - a) * rank / denom
    return torch.where(rank < n_ramp, ramp, torch.ones_like(ramp))


def fit_parzen(x, w, n_obs, prior_mu, prior_sigma, prior_weight, out_cap):
    """Fit 1-D adaptive-Parzen mixtures, one per row of a batch.

    Args:
      x: f32[B, N] fit-space observations, ``+inf`` beyond the live ones.
      w: f32[B, N] per-observation weights, 0 on padding.
      n_obs: int[B] live observations per row (``n_obs + 1 <= out_cap``).
      prior_mu, prior_sigma: f32[B] prior-component parameters.
      prior_weight: scalar prior-component weight.
      out_cap: component capacity of the result (``<= N + 1``).

    Returns ``(weights, mus, sigmas)``, each f32[B, out_cap], sorted
    ascending by ``mu``; padding slots have weight 0, mu 0 and sigma 1.
    """
    b, n = x.shape
    dev = x.device
    dt = torch.float32
    prior_mu = torch.as_tensor(prior_mu, dtype=dt, device=dev)
    prior_sigma = torch.as_tensor(prior_sigma, dtype=dt, device=dev)
    xs = torch.cat([x.to(dt), prior_mu[:, None]], dim=1)
    ws = torch.cat([w.to(dt), torch.full((b, 1), float(prior_weight),
                                         dtype=dt, device=dev)], dim=1)
    is_prior = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
    is_prior[:, n] = True

    # Stable ascending sort: +inf padding lands at the tail, the prior at
    # its sorted position among the live observations (ties keep the
    # observation first, as jnp.argsort does).
    order = torch.argsort(xs, dim=1, stable=True)[:, :out_cap]
    s = torch.gather(xs, 1, order)
    sw = torch.gather(ws, 1, order)
    sp = torch.gather(is_prior, 1, order)

    idx = torch.arange(out_cap, device=dev)[None, :]
    n_obs = torch.as_tensor(n_obs, device=dev).to(torch.int64)[:, None]
    m = n_obs + 1                                   # live incl. the prior
    valid = idx < m

    # Neighbor-gap bandwidths; edges one-sided.  The roll wrap-around
    # lanes are masked by the idx guards.
    left = s - torch.roll(s, 1, dims=1)
    right = torch.roll(s, -1, dims=1) - s
    ninf = torch.full_like(s, -float("inf"))
    sigma = torch.maximum(torch.where(idx >= 1, left, ninf),
                          torch.where(idx + 1 < m, right, ninf))
    psg = prior_sigma[:, None]
    sigma = torch.where((n_obs == 1) & ~sp, 0.5 * psg, sigma)

    minsigma = psg / torch.clamp_max(1.0 + m.to(dt), 100.0)
    sigma = torch.minimum(torch.maximum(sigma, minsigma), psg)
    sigma = torch.where(sp, psg, sigma)

    sw = torch.where(valid, sw, torch.zeros_like(sw))
    sw = sw / torch.sum(sw, dim=1, keepdim=True)
    mus = torch.where(valid, s, torch.zeros_like(s))
    sigma = torch.where(valid, sigma, torch.ones_like(sigma))
    return sw, mus, sigma

"""Fused Parzen fit and the per-row EI argmax of the TPE step.

Counterpart of ``hyperopt_tpu/ops/step_ei.py``.  The below and above fits
of a column group consume the same observation layout, so they run as one
batched ``fit_parzen`` over ``2·C`` rows at the above capacity, and the
below model is a slice of it: a below row has at most ``cap_b`` live
components, so its slots past ``cap_b`` are padding, and the slots before
it see the same sorted neighbors and the same weight normalizer.
"""

from __future__ import annotations

import torch

from .parzen import fit_parzen


def ei_argmax_stats(scores):
    """Per-row argmax of a score sheet ``[rows, n_cand]`` plus passengers.

    Returns ``(bi, best, ties)``: the winning index (the first on ties),
    the winning score, and how many other candidates tie the winner."""
    bi = torch.argmax(scores, dim=-1)
    best = torch.gather(scores, -1, bi[..., None])[..., 0]
    ties = (torch.sum(scores == best[..., None], dim=-1) - 1).to(torch.int32)
    return bi, best, ties


def fused_parzen_fit(x_b, w_b, n_b, x_a, w_a, n_a, prior_mu, prior_sigma,
                     prior_weight, cap_b, cap_a):
    """Fit below AND above Parzen mixtures in one batched sweep.

    Args:
      x_b, x_a: f32[N, C] fit-space observations per column, ``+inf`` on
        rows outside the respective split set.
      w_b, w_a: f32[N, C] linear-forgetting weights, 0 outside the set.
      n_b, n_a: int[C] live-observation counts per column.
      prior_mu, prior_sigma: f32[C]; prior_weight: scalar.
      cap_b, cap_a: component capacities, ``cap_b <= cap_a``.

    Returns ``(lwb[C, cap_b], mub, sgb, lwa[C, cap_a], mua, sga)``:
    log-weights, means, sigmas."""
    c = x_b.shape[1]
    xs = torch.cat([x_b, x_a], dim=1).T
    ws = torch.cat([w_b, w_a], dim=1).T
    ns = torch.cat([n_b, n_a])
    pmu = torch.cat([prior_mu, prior_mu])
    psg = torch.cat([prior_sigma, prior_sigma])
    w, mu, sg = fit_parzen(xs, ws, ns, pmu, psg, prior_weight, cap_a)
    wb, mub, sgb = w[:c, :cap_b], mu[:c, :cap_b], sg[:c, :cap_b]
    wa, mua, sga = w[c:], mu[c:], sg[c:]
    return (torch.log(wb), mub.contiguous(), sgb.contiguous(),
            torch.log(wa), mua, sga)

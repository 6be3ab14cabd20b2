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

#: Functions that run under device mode's CUDA graph capture, called
#: from another module: the capture-purity analyzer starts there.
CAPTURED_ENTRY_POINTS = (
    "ei_argmax_stats",
    "fused_parzen_fit",
)


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
      x_b, x_a: f32[..., N, C] fit-space observations per column, ``+inf``
        on rows outside the respective split set; ``...`` is an optional
        leading lane axis ``L`` (the fleet's experiments), folded into the
        rows of the one ``fit_parzen`` call.
      w_b, w_a: f32[..., N, C] linear-forgetting weights, 0 outside the set.
      n_b, n_a: int[..., C] live-observation counts per column.
      prior_mu, prior_sigma: f32[C]; prior_weight: a scalar, or f32[L]
        (one per lane).
      cap_b, cap_a: component capacities, ``cap_b <= cap_a``.

    Returns ``(lwb[..., C, cap_b], mub, sgb, lwa[..., C, cap_a], mua,
    sga)``: log-weights, means, sigmas."""
    lead = x_b.shape[:-2]
    n, c = x_b.shape[-2:]
    xs = torch.cat([x_b, x_a], dim=-1).transpose(-1, -2).reshape(-1, n)
    ws = torch.cat([w_b, w_a], dim=-1).transpose(-1, -2).reshape(-1, n)
    ns = torch.cat([n_b, n_a], dim=-1).reshape(-1)
    lanes = xs.shape[0] // (2 * c)
    pmu = torch.cat([prior_mu, prior_mu]).repeat(lanes)
    psg = torch.cat([prior_sigma, prior_sigma]).repeat(lanes)
    if isinstance(prior_weight, torch.Tensor):
        prior_weight = prior_weight.reshape(-1).repeat_interleave(2 * c)
    w, mu, sg = fit_parzen(xs, ws, ns, pmu, psg, prior_weight, cap_a)
    w, mu, sg = (t.reshape(*lead, 2 * c, cap_a) for t in (w, mu, sg))
    wb, mub, sgb = (t[..., :c, :cap_b] for t in (w, mu, sg))
    wa, mua, sga = (t[..., c:, :] for t in (w, mu, sg))
    return (torch.log(wb), mub.contiguous(), sgb.contiguous(),
            torch.log(wa), mua, sga)

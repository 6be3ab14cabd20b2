"""Acquisition criteria of Bayesian optimization, as torch functions.

Counterpart of ``hyperopt_tpu/criteria.py`` (the reference's Gaussian
EI, log EI and UCB; the TPE step does not use them).  Inputs that are not
tensors become float32 tensors, as ``jax.numpy`` makes them.
"""

from __future__ import annotations

import math

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, dtype=torch.float32)


def _norm_logpdf(s):
    return -0.5 * s * s - _HALF_LOG_2PI


def EI_empirical(samples, thresh):
    """Expected improvement over ``thresh`` from samples:
    ``mean(max(samples - thresh, 0))``."""
    return torch.clamp_min(_t(samples) - thresh, 0.0).mean()


def EI_gaussian(mean, var, thresh):
    """Analytic expected improvement of ``N(mean, var)`` over ``thresh``."""
    sigma = torch.sqrt(_t(var))
    score = (_t(mean) - thresh) / sigma
    return sigma * (score * torch.special.ndtr(score)
                    + torch.exp(_norm_logpdf(score)))


def logEI_gaussian(mean, var, thresh):
    """``log(EI_gaussian)``, stable deep into the negative-score tail: the
    two terms combine in log space, and below a score of -6 the Mills-ratio
    asymptote ``phi(s)/s^2 (1 - 3/s^2)`` takes over."""
    sigma = torch.sqrt(_t(var))
    score = (_t(mean) - thresh) / sigma
    log_phi = _norm_logpdf(score)
    log_Phi = torch.special.log_ndtr(score)
    pos = torch.log1p(torch.exp(log_Phi
                                + torch.log(torch.clamp_min(score, 1e-38))
                                - log_phi)) + log_phi
    neg = log_phi + torch.log1p(-torch.exp(torch.clamp_max(
        log_Phi + torch.log(torch.clamp_min(-score, 1e-38)) - log_phi,
        -1e-7)))
    s2 = torch.clamp_min(score * score, 1e-38)
    deep = log_phi - torch.log(s2) + torch.log1p(
        -torch.clamp_max(3.0 / s2, 0.5))
    out = torch.where(score >= 0, pos, torch.where(score > -6.0, neg, deep))
    return torch.log(sigma) + out


def UCB(mean, var, zscore):
    """Upper confidence bound: ``mean + zscore * sqrt(var)``."""
    return _t(mean) + torch.sqrt(_t(var)) * zscore

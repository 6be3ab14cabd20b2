"""The unit-cube codec shared by the model-based heads (GP, ES).

Counterpart of ``hyperopt_tpu/backends/_codec.py``.  GP and ES model the
space as ``[0, 1]^P``: history rows are *encoded* into the cube before the
fit, and proposals *decoded* back to raw values by the quantize/clip/exp
rules of :meth:`CompiledSpace.sample`, so a decoded row is one the prior
sampler could have drawn.

The per-pid constants are host numpy, built once per space
(:func:`unit_meta`); :func:`encode` and :func:`decode` are torch functions
of tensors, with the constants moved to the tensors' device
(:func:`meta_tensors`).

Columns by family:

* uniform family — affine in fit space (log space where ``is_log``):
  ``z = (t - a) / (b - a)``.
* normal family — affine over the ±3σ core, clipped to [0, 1].
* categorical / probabilistic randint — ``cat="index"`` keeps the option
  index (the GP's Hamming-style distance); ``cat="unit"`` maps index k of
  K to ``(k + 0.5) / K`` (the ES relaxation), decoded by ``floor(z·K)``.
* wide randint — affine over [low, high); decoded by ``floor``.
"""

from __future__ import annotations

import numpy as np
import torch

#: kind codes of the per-pid ``kind`` array
K_UF, K_NF, K_CAT, K_WIDE = 0, 1, 2, 3


def unit_meta(cs):
    """Per-pid codec constants of ``cs``, a dict of host numpy arrays:
    ``kind`` (family code), ``a``/``b`` (fit-space bounds), ``is_log``,
    ``q`` (0 = none), ``clip_lo``/``clip_hi`` (raw-space clip after
    decode), ``cat_k`` (option count, 1 for non-cat), ``cat_off``
    (randint low offset)."""
    P = cs.n_params
    kind = np.zeros(P, np.int32)
    a = np.zeros(P, np.float32)
    b = np.ones(P, np.float32)
    is_log = np.zeros(P, bool)
    q = np.zeros(P, np.float32)
    clip_lo = np.full(P, -np.inf, np.float32)
    clip_hi = np.full(P, np.inf, np.float32)
    cat_k = np.ones(P, np.float32)
    cat_off = np.zeros(P, np.float32)
    for i, p in enumerate(cs._uf):
        pid = p.pid
        kind[pid] = K_UF
        a[pid], b[pid] = cs._uf_a[i], cs._uf_b[i]
        is_log[pid] = cs._uf_log[i]
        q[pid] = cs._uf_q[i]
        clip_lo[pid], clip_hi[pid] = cs._uf_clip_lo[i], cs._uf_clip_hi[i]
    for i, p in enumerate(cs._nf):
        pid = p.pid
        kind[pid] = K_NF
        mu, sg = float(cs._nf_mu[i]), float(cs._nf_sigma[i])
        a[pid], b[pid] = mu - 3.0 * sg, mu + 3.0 * sg
        is_log[pid] = cs._nf_log[i]
        q[pid] = cs._nf_q[i]
        clip_lo[pid], clip_hi[pid] = -cs._nf_clip[i], cs._nf_clip[i]
    for i, p in enumerate(cs._cat):
        pid = p.pid
        kind[pid] = K_CAT
        cat_k[pid] = float(p.n_options)
        cat_off[pid] = cs._cat_offset[i]
    for i, p in enumerate(cs._wide):
        pid = p.pid
        kind[pid] = K_WIDE
        a[pid], b[pid] = float(cs._wide_low[i]), float(cs._wide_high[i])
    # A degenerate span (single-point uniform, K=1 randint) would divide by
    # zero in encode; a unit span keeps z constant all the same.
    span = b - a
    b = np.where(span > 0, b, a + 1.0).astype(np.float32)
    return dict(kind=kind, a=a, b=b, is_log=is_log, q=q,
                clip_lo=clip_lo, clip_hi=clip_hi,
                cat_k=cat_k, cat_off=cat_off)


def meta_tensors(meta, device):
    """:func:`unit_meta`'s arrays as tensors on ``device`` (upload once, at
    a program's build)."""
    return {k: torch.as_tensor(v, device=device) for k, v in meta.items()}


def encode(meta, vals, active, cat="index"):
    """Raw rows ``vals f32[N, P]`` → unit-cube rows.  ``meta``: tensors on
    the rows' device (:func:`meta_tensors`).

    An inactive numeric entry becomes 0.5 (the cube's centre); an inactive
    categorical one -1 under ``cat="index"`` (a level no real row has) and
    0.5 under ``cat="unit"``."""
    kind = meta["kind"]
    t = torch.where(meta["is_log"], torch.log(torch.clamp(vals, min=1e-12)),
                    vals)
    z_num = (t - meta["a"]) / (meta["b"] - meta["a"])
    z_num = torch.clamp(z_num, 0.0, 1.0)
    idx = vals - meta["cat_off"]
    if cat == "index":
        z_cat = idx
        fill = torch.where(kind == K_CAT, -1.0, 0.5)
    else:
        z_cat = (idx + 0.5) / meta["cat_k"]
        fill = torch.full((vals.shape[1],), 0.5, dtype=vals.dtype,
                          device=vals.device)
    z = torch.where(kind == K_CAT, z_cat, z_num)
    return torch.where(active, z, fill)


def decode(meta, z):
    """Unit-cube rows ``z f32[n, P]`` → raw rows: exp for log columns,
    rounding to the q-lattice (half to even, as ``jnp.round``), clip."""
    kind = meta["kind"]
    a, b = meta["a"], meta["b"]
    t = a + z * (b - a)
    x = torch.where(meta["is_log"], torch.exp(t), t)
    q = meta["q"]
    x = torch.where(q > 0, torch.round(x / torch.where(q > 0, q, 1.0)) * q,
                    x)
    x = torch.minimum(torch.maximum(x, meta["clip_lo"]), meta["clip_hi"])
    cat_k = meta["cat_k"]
    x_cat = meta["cat_off"] + torch.minimum(
        torch.clamp(torch.floor(z * cat_k), min=0.0), cat_k - 1.0)
    span = torch.clamp(b - a, min=1.0)
    x_wide = a + torch.minimum(torch.clamp(torch.floor(z * span), min=0.0),
                               span - 1.0)
    return torch.where(kind == K_CAT, x_cat,
                       torch.where(kind == K_WIDE, x_wide, x))

"""Simulated-annealing suggest algorithm.

Counterpart of ``hyperopt_tpu/anneal.py`` (reference:
``hyperopt/anneal.py::suggest``): pick a good past trial, biased toward the
best (a geometric draw over the loss ranking with mean ``avg_best_idx``),
then draw each hyperparameter from a neighbourhood of that incumbent whose
width shrinks as observations accumulate (``1 / (1 + T · shrink_coef)``);
a parameter the incumbent lacks (an unchosen branch) falls back to its
prior.

The incumbent picks are host numpy; the neighbourhood draws of all ``n``
proposals are one function over tensors on the space's device
(:class:`_AnnealKernel`, cached on the space), one fetch per call.
"""

from __future__ import annotations

import numpy as np
import torch

from . import base, rand
from .space import make_generator, resolve_device

_default_avg_best_idx = 2.0
_default_shrink_coef = 0.1

_TINY = 1e-12


class _AnnealKernel:
    """The incumbent-neighbourhood sampler of one space on one device:
    family constants uploaded once."""

    def __init__(self, cs, device):
        self.cs, self.device = cs, device

        def t(x, dtype=None):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        self.uf_pids = t([p.pid for p in cs._uf], torch.int64)
        self.nf_pids = t([p.pid for p in cs._nf], torch.int64)
        self.cat_pids = t([p.pid for p in cs._cat], torch.int64)
        self.wide_pids = t([p.pid for p in cs._wide], torch.int64)
        self.uf_log = t(cs._uf_log)
        self.nf_log = t(cs._nf_log)
        self.uf_a, self.uf_b = t(cs._uf_a), t(cs._uf_b)
        self.uf_q = t(cs._uf_q)
        self.uf_clip_lo, self.uf_clip_hi = t(cs._uf_clip_lo), t(cs._uf_clip_hi)
        self.nf_mu, self.nf_sigma, self.nf_q = (t(cs._nf_mu), t(cs._nf_sigma),
                                                t(cs._nf_q))
        # The categorical prior as the JAX package forms it: log p in
        # float32 (-inf past a column's options), exponentiated and
        # normalized in float32.
        kmax = cs.cat_kmax
        logits = np.full((len(cs._cat), kmax), -np.inf, np.float32)
        for i, p in enumerate(cs._cat):
            logits[i, :p.n_options] = np.log(np.asarray(p.probs))
        prior = torch.exp(t(logits))
        self.cat_prior = prior / torch.sum(prior, dim=1, keepdim=True)
        self.cat_offset = t(cs._cat_offset)
        self.kmax = kmax
        self.wide_low = t(cs._wide_low, torch.float32)
        self.wide_high = t(cs._wide_high, torch.float32)

    def noise_shapes(self, n):
        """Shapes of the draws :meth:`__call__` takes for ``n`` rows:
        uniforms ``uf``, normals ``nf``, Gumbels ``cat``, uniforms
        ``wide``."""
        return {"uf": (n, len(self.uf_pids)), "nf": (n, len(self.nf_pids)),
                "cat": (n, len(self.cat_pids), self.kmax),
                "wide": (n, len(self.wide_pids))}

    def draw_noise(self, n, generator=None):
        """The draws of ``n`` rows from ``generator``; the Gumbels as JAX
        forms them, ``-log(-log(u))`` with ``u`` at least the smallest
        normal float32."""
        dev, f32 = self.device, torch.float32
        shapes = self.noise_shapes(n)
        tiny = torch.finfo(f32).tiny
        u_cat = torch.rand(shapes["cat"], generator=generator, device=dev,
                           dtype=f32).clamp(min=tiny)
        return {
            "uf": torch.rand(shapes["uf"], generator=generator, device=dev,
                             dtype=f32),
            "nf": torch.randn(shapes["nf"], generator=generator, device=dev,
                              dtype=f32),
            "cat": -torch.log(-torch.log(u_cat)),
            "wide": torch.rand(shapes["wide"], generator=generator,
                               device=dev, dtype=f32),
        }

    def __call__(self, inc_vals, inc_active, shrink, generator=None,
                 noise=None):
        """Rows ``f32[n, P]`` around the incumbents ``inc_vals``/
        ``inc_active`` (``[n, P]``), with the per-parameter shrink factors
        ``shrink`` (``[P]``, in (0, 1]).  ``noise``: the draws of
        :meth:`noise_shapes` in place of draws from ``generator``."""
        dev = self.device
        inc_vals = torch.as_tensor(inc_vals, dtype=torch.float32, device=dev)
        inc_active = torch.as_tensor(inc_active, dtype=torch.bool, device=dev)
        shrink = torch.as_tensor(shrink, dtype=torch.float32, device=dev)
        n = inc_vals.shape[0]
        if noise is None:
            noise = self.draw_noise(n, generator)
        shapes = self.noise_shapes(n)

        def draw(name):
            x = torch.as_tensor(noise[name], dtype=torch.float32, device=dev)
            if tuple(x.shape) != shapes[name]:
                raise ValueError(f"noise[{name!r}] must have shape "
                                 f"{shapes[name]}, got {tuple(x.shape)}")
            return x

        out = torch.zeros((n, self.cs.n_params), dtype=torch.float32,
                          device=dev)

        if len(self.uf_pids):
            pids, a, b = self.uf_pids, self.uf_a, self.uf_b
            has = inc_active[:, pids]
            v = inc_vals[:, pids]
            mid = torch.where(self.uf_log,
                              torch.log(torch.clamp(v, min=_TINY)), v)
            mid = torch.where(has, mid, 0.5 * (a + b))
            width = (b - a) * torch.where(has, shrink[pids], 1.0)
            lo = torch.maximum(a, mid - 0.5 * width)
            hi = torch.minimum(b, mid + 0.5 * width)
            x = lo + (hi - lo) * draw("uf")
            x = torch.where(self.uf_log, torch.exp(x), x)
            q = self.uf_q
            x = torch.where(q > 0,
                            torch.round(x / torch.where(q > 0, q, 1.0)) * q, x)
            out[:, pids] = torch.minimum(torch.maximum(x, self.uf_clip_lo),
                                         self.uf_clip_hi)

        if len(self.nf_pids):
            pids = self.nf_pids
            has = inc_active[:, pids]
            v = inc_vals[:, pids]
            inc = torch.where(self.nf_log,
                              torch.log(torch.clamp(v, min=_TINY)), v)
            mu = torch.where(has, inc, self.nf_mu)
            sg = self.nf_sigma * torch.where(has, shrink[pids], 1.0)
            x = mu + sg * draw("nf")
            x = torch.where(self.nf_log, torch.exp(x), x)
            q = self.nf_q
            out[:, pids] = torch.where(
                q > 0, torch.round(x / torch.where(q > 0, q, 1.0)) * q, x)

        if len(self.cat_pids):
            pids, offs = self.cat_pids, self.cat_offset
            has = inc_active[:, pids]
            inc_idx = (inc_vals[:, pids] - offs).to(torch.int32)
            onehot = (torch.arange(self.kmax, device=dev)[None, None, :]
                      == inc_idx[:, :, None]).to(torch.float32)
            # Interpolate prior → incumbent as the neighbourhood shrinks.
            w = torch.where(has, 1.0 - shrink[pids], 0.0)[:, :, None]
            probs = (1.0 - w) * self.cat_prior + w * onehot
            idx = torch.argmax(torch.log(probs) + draw("cat"), dim=-1)
            out[:, pids] = offs + idx.to(torch.float32)

        if len(self.wide_pids):
            pids = self.wide_pids
            lo, hi = self.wide_low, self.wide_high - 1.0
            has = inc_active[:, pids]
            mid = torch.where(has, inc_vals[:, pids], 0.5 * (lo + hi))
            width = (hi - lo) * torch.where(has, shrink[pids], 1.0)
            a = torch.maximum(lo, mid - 0.5 * width)
            b = torch.minimum(hi, mid + 0.5 * width)
            x = torch.round(a + (b - a) * draw("wide"))
            out[:, pids] = torch.minimum(torch.maximum(x, lo), hi)

        return out


def _get_kernel(cs, device):
    """The space's :class:`_AnnealKernel` on ``device`` (cached)."""
    cache = cs.__dict__.setdefault("_anneal_kernels", {})
    key = str(device)
    if key not in cache:
        cache[key] = _AnnealKernel(cs, device)
    return cache[key]


def suggest(new_ids, domain, trials, seed,
            avg_best_idx=_default_avg_best_idx,
            shrink_coef=_default_shrink_coef, noise=None):
    """Annealing suggest (reference: ``hyperopt/anneal.py::suggest``).
    ``noise`` hands the neighbourhood draws in
    (:meth:`_AnnealKernel.noise_shapes`) in place of draws from the seed's
    generator."""
    cs = domain.cs
    n = len(new_ids)
    if n == 0:
        return []
    h = trials.history(cs)
    n_ok = int(h["ok"].sum())
    if n_ok == 0 or cs.n_params == 0:
        return rand.suggest(new_ids, domain, trials, seed)

    dev = resolve_device(cs.device)
    rng = np.random.default_rng(int(seed) % (2 ** 32))
    ok_rows = np.nonzero(h["ok"])[0]
    order = ok_rows[np.argsort(h["loss"][ok_rows], kind="stable")]
    # Per-parameter observation counts drive the shrink schedule.
    t_obs = h["active"][ok_rows].sum(axis=0).astype(np.float32)
    shrink = 1.0 / (1.0 + t_obs * shrink_coef)
    # Incumbent picks (geometric over the loss ranking) are host-side; the
    # neighbourhood draws of all n rows are one call and one fetch.
    gis = np.minimum(rng.geometric(1.0 / avg_best_idx, size=n) - 1,
                     n_ok - 1)
    incs = order[gis]
    rows = _get_kernel(cs, dev)(
        h["vals"][incs], h["active"][incs], shrink,
        generator=make_generator(dev, int(seed) % (2 ** 32)), noise=noise)
    rows = rows.cpu().numpy()
    return base.docs_from_samples(cs, new_ids, rows,
                                  cs.active_mask_host(rows),
                                  exp_key=getattr(trials, "exp_key", None))


#: The name the backend registry resolves through.
BACKENDS = {"anneal": suggest}

"""GP-EI suggest backend: a Gaussian-process surrogate on the card.

Counterpart of ``hyperopt_tpu/backends/gp.py``.  A Matérn-5/2 GP over the
unit-cube encoding of the space (``_codec.py``), fit by Cholesky, proposes
the argmax of analytic expected improvement over a sweep of prior draws
(Snoek et al., "Practical Bayesian Optimization of Machine Learning
Algorithms").  The whole dispatch, from the history feed to the proposal
rows, is torch ops on the space's device with no host round trip; its
program (:class:`_GpProgram`) is cached on ``cs._gp_kernels`` per
(bucket, sweep, batch, fit cap, device).

* The history arrives through TPE's feed: the resident ring
  (``history.device_history``) unless ``resident=False``, bucketed by
  ``tpe._bucket``.
* In-flight trials enter as constant-liar rows at the mean observed loss
  (``tpe._inflight_fantasy_rows``), so the head pipelines at any depth.
* Within one batched dispatch, ``m`` liar steps run on the stream: propose,
  fantasize the proposal at the lie (0 in standardized loss, since the lie
  is the mean), refit, propose again.
* The handle and its materialize/transfer/ready halves are ``tpe``'s.

The model: categorical columns use an index encoding with a Hamming-style
distance (0.25 per mismatch); inactive parameters impute neutrally.  The
(length-scale × noise) grid of 8 is scored by log marginal likelihood in
one batched Cholesky per dispatch.  ``max_n`` (default 256) caps the fit:
past it the lowest-loss rows are kept.

Device notes: ``cholesky_ex(check_errors=False)`` (``cholesky`` checks its
info on the host); a factor whose info is non-zero becomes NaN, as JAX's
Cholesky returns it, so the grid's argmax (NaN first in both) picks what
JAX picks; ``cho_solve`` is two triangular solves, as in JAX; rows are
picked with ``index_select``.
"""

from __future__ import annotations

import math
from time import perf_counter

import numpy as np
import torch

from .. import history as _rhist
from .. import tpe as _tpe
from ..history import _padded_history
from ..obs import costs as _costs
from ..obs.metrics import kernel_cache_event
from ..obs.metrics import registry as _metrics_registry
from ..space import make_generator, resolve_device
from . import _codec

_default_n_startup_jobs = 10
_default_n_EI_candidates = 64
_default_max_n = 256

#: (length-scale, noise) grid scored by log marginal likelihood each
#: dispatch.  Length-scales are in unit-cube units.
_LS_GRID = np.asarray([0.1, 0.2, 0.4, 0.8], np.float32)
_NOISE_GRID = np.asarray([1e-4, 1e-2], np.float32)

_SQ2PI = np.sqrt(2.0 * np.pi)


def _cho_solve(chol, b):
    """``K⁻¹ b`` from the lower factor of ``K``: two triangular solves."""
    w = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), w,
                                         upper=True)


def _cholesky(kmat):
    """Lower Cholesky factor without a host check; NaN where the matrix is
    not positive definite (JAX's result there)."""
    chol, info = torch.linalg.cholesky_ex(kmat, check_errors=False)
    return torch.where((info != 0)[..., None, None], math.nan, chol)


class _GpProgram:
    """The GP-EI dispatch for one (bucket, sweep, batch, fit cap) shape on
    one device: host constants uploaded once here."""

    def __init__(self, cs, n_cap, n_cand, m, max_n, device):
        self.cs, self.n_cap, self.n_cand, self.m = cs, n_cap, n_cand, m
        self.device = device
        meta = _codec.unit_meta(cs)
        self.meta = _codec.meta_tensors(meta, device)
        self.is_cat = torch.as_tensor(meta["kind"] == _codec.K_CAT,
                                      device=device)
        self.n_eff = min(n_cap, max_n)
        ls, noise = np.meshgrid(_LS_GRID, _NOISE_GRID)
        self.ls_grid = torch.as_tensor(np.ascontiguousarray(ls.ravel()),
                                       device=device)
        self.noise_grid = torch.as_tensor(
            np.ascontiguousarray(noise.ravel()), device=device)

    def _sqdist(self, zi, zj):
        d = zi[:, None, :] - zj[None, :, :]
        d2 = torch.where(self.is_cat, 0.25 * (d != 0.0).to(d.dtype), d * d)
        return torch.sum(d2, dim=-1)

    @staticmethod
    def _matern52(d2sum, ls):
        r2 = d2sum / (ls * ls)
        s = torch.sqrt(5.0 * r2 + 1e-12)
        return (1.0 + s + (5.0 / 3.0) * r2) * torch.exp(-s)

    def _draw(self, i, generator, cand):
        if cand is not None:
            cv, ca = cand[i]
            return (torch.as_tensor(cv, dtype=torch.float32,
                                    device=self.device),
                    torch.as_tensor(ca, dtype=torch.bool, device=self.device))
        return self.cs.sample(self.n_cand, generator=generator,
                              device=self.device)

    def __call__(self, hv, ha, hl, hok, generator=None, cand=None,
                 trace=None):
        """Proposal rows ``f32[m, P]`` from the padded history.  ``cand``:
        ``m`` pre-drawn ``(vals, active)`` sweeps in place of draws from
        ``generator``; ``trace``: a list that gets the grid's scores and
        each step's standardized ``mu``, ``sigma``, EI and pick (tests)."""
        m, n_eff = self.m, self.n_eff
        z_all = _codec.encode(self.meta, hv, ha, cat="index")
        mk = hok
        if self.n_cap > n_eff:
            # Subset of data: the n_eff lowest-loss rows (stable order).
            sel = torch.argsort(torch.where(mk, hl, math.inf),
                                stable=True)[:n_eff]
            z_all = z_all.index_select(0, sel)
            hl_eff = hl.index_select(0, sel)
            mk = mk.index_select(0, sel)
        else:
            hl_eff = hl
        mf = mk.to(torch.float32)
        cnt = torch.clamp(mf.sum(), min=1.0)
        y0 = torch.where(mk, hl_eff, 0.0)
        mu_y = y0.sum() / cnt
        sd_y = torch.sqrt((mf * (y0 - mu_y) ** 2).sum() / cnt) + 1e-6
        y = mf * (y0 - mu_y) / sd_y

        # Hyperparameters: one batched Cholesky over the grid.
        d2 = self._sqdist(z_all, z_all)
        ls_g = self.ls_grid[:, None, None]
        kf = self._matern52(d2[None], ls_g)
        mm = torch.outer(mf, mf)
        kmat = kf * mm + torch.diag_embed(
            (1.0 - mf) + 1e-6 + self.noise_grid[:, None] * mf)
        chol = _cholesky(kmat)
        yb = y[None, :, None].expand(chol.shape[0], -1, 1)
        alpha = _cho_solve(chol, yb)[..., 0]
        scores = -0.5 * torch.sum(y[None] * alpha, dim=-1) - torch.sum(
            torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
        bi = torch.argmax(scores).view(1)
        ls = self.ls_grid.index_select(0, bi)
        noise = self.noise_grid.index_select(0, bi)
        if trace is not None:
            trace.append({"scores": scores, "pick": bi})

        p = z_all.shape[1]
        z2 = torch.cat([z_all, z_all.new_zeros((m, p))])
        mf2 = torch.cat([mf, mf.new_zeros((m,))])
        y2 = torch.cat([y, y.new_zeros((m,))])
        rows = []
        for i in range(m):
            cv, ca = self._draw(i, generator, cand)
            zc = _codec.encode(self.meta, cv, ca, cat="index")
            kf = self._matern52(self._sqdist(z2, z2), ls)
            kmat = kf * torch.outer(mf2, mf2) + torch.diag(
                (1.0 - mf2) + 1e-6 + noise * mf2)
            chol = _cholesky(kmat)
            alpha = _cho_solve(chol, (y2 * mf2)[:, None])[:, 0]
            kstar = self._matern52(self._sqdist(zc, z2), ls) * mf2[None, :]
            mu = kstar @ alpha
            v = torch.linalg.solve_triangular(chol, kstar.T, upper=False)
            var = torch.clamp(1.0 + noise - torch.sum(v * v, dim=0),
                              min=1e-9)
            sigma = torch.sqrt(var)
            best = torch.min(torch.where(mf2 > 0, y2, math.inf))
            zs = (best - mu) / sigma
            cdf = 0.5 * (1.0 + torch.special.erf(zs / np.sqrt(2.0)))
            pdf = torch.exp(-0.5 * zs * zs) / _SQ2PI
            ei = (best - mu) * cdf + sigma * pdf
            pick = torch.argmax(ei).view(1)
            # Slices, not ``mf2[k] = 1.0``: a scalar written through an
            # index is a copy from the host, which waits for the stream.
            z2[n_eff + i:n_eff + i + 1] = zc.index_select(0, pick)
            mf2[n_eff + i:n_eff + i + 1].fill_(1.0)
            rows.append(cv.index_select(0, pick))
            if trace is not None:
                trace.append({"mu": mu, "sigma": sigma, "ei": ei,
                              "pick": pick})
        return torch.cat(rows)


def _get_program(cs, n_cap, n_cand, m, max_n, device):
    key = (n_cap, n_cand, m, max_n, str(device))
    cache = cs.__dict__.setdefault("_gp_kernels", {})
    prog = cache.get(key)
    hit = prog is not None
    if not hit:
        t0 = perf_counter()
        prog = cache[key] = _GpProgram(cs, n_cap, n_cand, m, max_n, device)
        prog.cost_key = ("gp",) + key
        _costs.record_compile("gp", prog.cost_key, n_cap=n_cap,
                              P=cs.n_params, m=m,
                              compile_s=perf_counter() - t0)
    kernel_cache_event(prog.cost_key, hit)
    return prog


def _ready(cs, new_ids, vals, active, exp_key):
    return ("ready", cs, list(new_ids), (vals, active), exp_key)


def _startup_handle(startup, new_ids, domain, trials, seed, exp_key):
    """The startup sampler's rows as a ready handle (host arrays)."""
    v, a = _tpe._startup_batch(startup, new_ids, domain, trials, seed)
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
        a = domain.cs.active_mask_host(v)
    return _ready(domain.cs, new_ids, np.asarray(v), np.asarray(a), exp_key)


def suggest_dispatch(new_ids, domain, trials, seed,
                     n_startup_jobs=_default_n_startup_jobs,
                     n_EI_candidates=_default_n_EI_candidates,
                     startup=None, max_n=_default_max_n, resident=True,
                     cand=None):
    """Start the GP-EI proposal on the space's device; returns a handle in
    ``tpe``'s layout for ``tpe.suggest_materialize`` and its siblings.

    ``max_n`` caps the rows the fit keeps (the lowest losses); ``startup``
    picks the sampler of the first ``n_startup_jobs`` trials as in
    ``tpe.suggest``; ``resident=False`` pads the history on the host;
    ``cand`` hands in the ``m`` candidate sweeps (``(vals[n_cand, P],
    active[n_cand, P])`` each, ``m`` = ``tpe._batch_size_for(n)``) in place
    of draws from the seed's generator."""
    cs = domain.cs
    dev = resolve_device(cs.device)
    n = len(new_ids)
    exp_key = getattr(trials, "exp_key", None)
    reg = _metrics_registry()
    reg.counter("backend.gp.suggest.calls").inc()
    if n == 0 or cs.n_params == 0:
        return _ready(cs, new_ids, np.zeros((n, cs.n_params), np.float32),
                      np.ones((n, cs.n_params), bool), exp_key)
    h = trials.history(cs)
    if int(h["ok"].sum()) < n_startup_jobs:
        return _startup_handle(startup, new_ids, domain, trials, seed,
                               exp_key)
    if resident:
        fant = _tpe._inflight_fantasy_rows(h, trials, cs)
        n_rows = h["vals"].shape[0] + (len(fant[0]) if fant else 0)
    else:
        h = _tpe._with_inflight_fantasies(h, trials, cs)
        n_rows = h["vals"].shape[0]
    n_cap = _tpe._bucket(n_rows)
    m = _tpe._batch_size_for(n)
    prog = _get_program(cs, n_cap, int(n_EI_candidates), m,
                        max(16, int(max_n)), dev)
    t_feed = perf_counter()
    if resident:
        hist = _rhist.device_history(trials, cs, h, n_cap, fantasies=fant,
                                     device=dev)
    else:
        hist = [torch.as_tensor(a, device=dev)
                for a in _padded_history(h, n_cap)]
    t_disp = perf_counter()
    _tpe._obs_ms(reg, "suggest.upload_ms", (t_disp - t_feed) * 1e3)
    gen = make_generator(dev, int(seed) % (2 ** 32))
    rows = prog(*hist, generator=gen, cand=cand)
    dms = (perf_counter() - t_disp) * 1e3
    _tpe._obs_ms(reg, "backend.gp.dispatch_ms", dms)
    _costs.observe_dispatch(prog.cost_key, dms)
    return ("pending", cs, list(new_ids), _tpe._PendingRows(rows), exp_key)


def suggest(new_ids, domain, trials, seed, **kwargs):
    """GP-EI proposals for ``new_ids``: dispatch, then wait for it, so the
    sync and pipelined paths are one implementation."""
    return _tpe.suggest_materialize(
        suggest_dispatch(new_ids, domain, trials, seed, **kwargs))


def introspect(domain, trials, seed=0, n_candidates=64,
               max_n=_default_max_n):
    """Health-hook diagnostics (``obs.health``): the same Matérn-5/2 grid
    refit on the host in numpy (float64), with log marginal likelihood and
    the candidate sweep's EI statistics.

    Touches no program cache and no accelerator: at most ``max_n`` rows,
    candidates drawn on the CPU.  ``ei_rel`` is the best candidate's EI in
    raw loss units over the observed loss scale (~0: a flat acquisition
    surface, EI collapse)."""
    cs = domain.cs
    h = trials.history(cs)
    ok = np.asarray(h["ok"], bool)
    n_ok = int(ok.sum())
    out = {"backend": "gp", "n_obs": n_ok}
    if n_ok < 4 or cs.n_params == 0:
        out["insufficient"] = True
        return out
    vals = np.asarray(h["vals"], np.float64)[ok]
    act = np.asarray(h["active"], bool)[ok]
    loss = np.asarray(h["loss"], np.float64)[ok]
    if n_ok > max_n:
        sel = np.argsort(loss)[:max_n]
        vals, act, loss = vals[sel], act[sel], loss[sel]
    meta = _codec.unit_meta(cs)
    tmeta = _codec.meta_tensors(meta, "cpu")
    is_cat = np.asarray(meta["kind"] == _codec.K_CAT)
    z = _codec.encode(tmeta, torch.as_tensor(vals, dtype=torch.float32),
                      torch.as_tensor(act), cat="index").double().numpy()
    n = z.shape[0]
    mu_y = loss.mean()
    sd_y = loss.std() + 1e-6
    y = (loss - mu_y) / sd_y

    def matk(zi, zj, ls):
        d = zi[:, None, :] - zj[None, :, :]
        d2 = np.where(is_cat, 0.25 * (d != 0.0), d * d)
        r2 = d2.sum(-1) / (ls * ls)
        s = np.sqrt(5.0 * r2 + 1e-12)
        return (1.0 + s + (5.0 / 3.0) * r2) * np.exp(-s)

    best = None
    for ls in _LS_GRID:
        for noise in _NOISE_GRID:
            km = matk(z, z, float(ls)) + (1e-6 + float(noise)) * np.eye(n)
            try:
                chol = np.linalg.cholesky(km)
            except np.linalg.LinAlgError:   # pragma: no cover - jittered
                continue
            alpha = np.linalg.solve(km, y)
            lml = float(-0.5 * y @ alpha - np.log(np.diag(chol)).sum())
            if best is None or lml > best[0]:
                best = (lml, float(ls), float(noise), alpha, km)
    if best is None:        # pragma: no cover - grid fully singular
        out["insufficient"] = True
        return out
    lml, ls, noise, alpha, km = best
    cv, ca = cs.sample(int(n_candidates),
                       generator=make_generator("cpu", int(seed) % (2 ** 32)),
                       device="cpu")
    zc = _codec.encode(tmeta, cv, ca, cat="index").double().numpy()
    kstar = matk(zc, z, ls)
    mu = kstar @ alpha
    w = np.linalg.solve(km, kstar.T)
    var = np.clip(1.0 + noise - np.einsum("ij,ji->i", kstar, w), 1e-12,
                  None)
    sigma = np.sqrt(var)
    best_y = y.min()
    zs = (best_y - mu) / sigma
    # erf in float32, as the JAX package computes it.
    cdf = 0.5 * (1.0 + torch.special.erf(
        torch.as_tensor(zs / np.sqrt(2.0), dtype=torch.float32)).numpy())
    pdf = np.exp(-0.5 * zs * zs) / np.sqrt(2.0 * np.pi)
    ei = (best_y - mu) * cdf + sigma * pdf          # standardized units
    ei_max = float(ei.max())
    ei_raw = float(ei_max * sd_y)
    scale = max(float(loss.max() - loss.min()),
                1e-3 * abs(float(loss.min())), 1e-9)
    out.update({
        "logml": lml, "ls": ls, "noise": noise, "sd_y": float(sd_y),
        "ei_max": ei_max, "ei_mean": float(ei.mean()), "ei_raw": ei_raw,
        "ei_rel": float(ei_raw / scale),
    })
    return out


suggest.dispatch = suggest_dispatch
suggest.materialize = _tpe.suggest_materialize
suggest.start_transfer = _tpe.suggest_start_transfer
suggest.handle_ready = _tpe.suggest_handle_ready
suggest.introspect = introspect

#: The name the backend registry resolves through.
BACKENDS = {"gp": suggest}

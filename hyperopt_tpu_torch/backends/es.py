"""Evolution-strategies suggest backend (OpenES, the population as one
tensor).

Counterpart of ``hyperopt_tpu/backends/es.py``.  The search distribution
is an isotropic Gaussian over the unit cube (``_codec.py``) whose mean
moves by the OpenES natural-gradient estimate; a *generation* is
``popsize`` trials.  Proposals are antithetic pairs ``mean ± σ·ε``,
decoded back to raw rows on the device.

The head keeps no state on the host: each dispatch replays the strategy
from the history feed.  Finished trials in insertion order are the
generations, and a loop on the stream replays every generation's mean
update (centred-rank shaped by default), so retries and restarts resume
the strategy exactly.  A partial generation (the last ``n_ok % popsize``
trials) does not move the mean, and in-flight trials are ignored (the
proposals of one generation are independent draws).  The replay keeps
the JAX package's order of operations within a generation; both argsorts
of the centred ranks are stable, as ``jnp.argsort`` is, and the standard
deviation of the unshaped update has ddof 0.

The handle and its materialize/transfer/ready halves are ``tpe``'s.
"""

from __future__ import annotations

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
from .gp import _ready, _startup_handle

_default_sigma0 = 0.25
_default_lr = 0.5
_default_popsize = 8
_SIGMA_DECAY = 0.97


class _EsProgram:
    """Replay + proposal for one (bucket, batch, strategy) shape on one
    device."""

    def __init__(self, cs, n_cap, m, popsize, sigma0, lr, rank_shaping,
                 device):
        self.cs, self.n_cap, self.m, self.popsize = cs, n_cap, m, popsize
        self.sigma0, self.lr, self.rank_shaping = sigma0, lr, rank_shaping
        self.device = device
        self.meta = _codec.meta_tensors(_codec.unit_meta(cs), device)
        self.n_gens = max(1, n_cap // popsize)
        self.n_take = self.n_gens * popsize
        self.half = (m + 1) // 2
        self.slots = torch.arange(n_cap, device=device)
        self.gens = torch.arange(self.n_gens, device=device)

    def _weights(self, lg):
        """Each generation's update weights, ``[n_gens, popsize]``: the
        same arithmetic per row as one generation at a time."""
        popsize = self.popsize
        if self.rank_shaping:
            # Centred ranks of fitness (-loss): best +0.5, worst -0.5.
            ranks = torch.argsort(torch.argsort(-lg, dim=1, stable=True),
                                  dim=1, stable=True)
            return ranks.to(torch.float32) / (popsize - 1) - 0.5
        f = -lg
        return (f - f.mean(dim=1, keepdim=True)) / (
            f.std(dim=1, correction=0, keepdim=True) + 1e-8) / 2.0

    def __call__(self, hv, ha, hl, hok, generator=None, noise=None,
                 trace=None):
        """Proposal rows ``f32[m, P]``.  ``noise``: the ``ε`` draws
        ``f32[ceil(m / 2), P]`` in place of normals from ``generator``;
        ``trace``: a list that gets the replayed mean, ``σ`` and the
        proposals in the cube (tests)."""
        popsize, n_gens, lr = self.popsize, self.n_gens, self.lr
        z = _codec.encode(self.meta, hv, ha, cat="unit")
        p = z.shape[1]
        # Finished trials in insertion order are the generations: a stable
        # argsort moves the ok rows to the front in their order.
        order = torch.argsort(torch.where(hok, self.slots, self.n_cap),
                              stable=True)
        take = order[:self.n_take]
        zg = z.index_select(0, take).reshape(n_gens, popsize, p)
        ag = ha.index_select(0, take).to(torch.float32).reshape(
            n_gens, popsize, p)
        lg = torch.where(hok, hl, 0.0).index_select(0, take).reshape(
            n_gens, popsize)
        full = torch.sum(hok.to(torch.int32)) // popsize
        # What does not depend on the mean is computed for all generations
        # at once (weights, weights x activity, live x lr); the loop keeps
        # the JAX package's per-generation order:
        # (2/popsize) * sum((w * a) * (z - mean)), mean + (live * lr) * upd.
        wa = self._weights(lg)[:, :, None] * ag
        live_lr = (self.gens < full).to(torch.float32) * lr
        mean = torch.full((p,), 0.5, dtype=z.dtype, device=z.device)
        for g in range(n_gens):
            upd = (2.0 / popsize) * torch.sum(wa[g] * (zg[g] - mean), dim=0)
            mean = torch.clamp(mean + live_lr[g] * upd, 0.0, 1.0)
        sigma = self.sigma0 * torch.pow(_SIGMA_DECAY,
                                        full.to(torch.float32))
        if noise is None:
            eps = torch.randn((self.half, p), generator=generator,
                              dtype=z.dtype, device=z.device)
        else:
            eps = torch.as_tensor(noise, dtype=z.dtype, device=z.device)
        eps = torch.cat([eps, -eps], dim=0)[:self.m]
        zprop = torch.clamp(mean[None, :] + sigma * eps, 0.0, 1.0)
        if trace is not None:
            trace.append({"mean": mean, "sigma": sigma, "z": zprop})
        return _codec.decode(self.meta, zprop)


def _get_program(cs, n_cap, m, popsize, sigma0, lr, rank_shaping, device):
    key = (n_cap, m, popsize, float(sigma0), float(lr), bool(rank_shaping),
           str(device))
    cache = cs.__dict__.setdefault("_es_kernels", {})
    prog = cache.get(key)
    hit = prog is not None
    if not hit:
        t0 = perf_counter()
        prog = cache[key] = _EsProgram(cs, n_cap, m, popsize, float(sigma0),
                                       float(lr), bool(rank_shaping), device)
        prog.cost_key = ("es",) + key
        _costs.record_compile("es", prog.cost_key, n_cap=n_cap,
                              P=cs.n_params, m=m,
                              compile_s=perf_counter() - t0)
    kernel_cache_event(prog.cost_key, hit)
    return prog


def suggest_dispatch(new_ids, domain, trials, seed, n_startup_jobs=None,
                     popsize=_default_popsize, sigma0=_default_sigma0,
                     lr=_default_lr, rank_shaping=True, startup=None,
                     resident=True, noise=None):
    """Start the ES replay and proposal on the space's device; a handle in
    ``tpe``'s layout.  ``popsize`` (at least 2) is the generation size and,
    unless ``n_startup_jobs`` says otherwise, the startup length;
    ``noise`` hands in ``ε`` (``f32[ceil(m / 2), P]``, ``m`` =
    ``tpe._batch_size_for(n)``)."""
    cs = domain.cs
    dev = resolve_device(cs.device)
    n = len(new_ids)
    exp_key = getattr(trials, "exp_key", None)
    reg = _metrics_registry()
    reg.counter("backend.es.suggest.calls").inc()
    popsize = max(2, int(popsize))
    if n_startup_jobs is None:
        n_startup_jobs = popsize
    if n == 0 or cs.n_params == 0:
        return _ready(cs, new_ids, np.zeros((n, cs.n_params), np.float32),
                      np.ones((n, cs.n_params), bool), exp_key)
    h = trials.history(cs)
    if int(h["ok"].sum()) < n_startup_jobs:
        return _startup_handle(startup, new_ids, domain, trials, seed,
                               exp_key)
    n_cap = _tpe._bucket(h["vals"].shape[0])
    m = _tpe._batch_size_for(n)
    prog = _get_program(cs, n_cap, m, popsize, sigma0, lr, rank_shaping, dev)
    t_feed = perf_counter()
    if resident:
        hist = _rhist.device_history(trials, cs, h, n_cap, device=dev)
    else:
        hist = [torch.as_tensor(a, device=dev)
                for a in _padded_history(h, n_cap)]
    t_disp = perf_counter()
    _tpe._obs_ms(reg, "suggest.upload_ms", (t_disp - t_feed) * 1e3)
    gen = make_generator(dev, int(seed) % (2 ** 32))
    rows = prog(*hist, generator=gen, noise=noise)
    dms = (perf_counter() - t_disp) * 1e3
    _tpe._obs_ms(reg, "backend.es.dispatch_ms", dms)
    _costs.observe_dispatch(prog.cost_key, dms)
    return ("pending", cs, list(new_ids), _tpe._PendingRows(rows), exp_key)


def suggest(new_ids, domain, trials, seed, **kwargs):
    """OpenES proposals for ``new_ids``: dispatch, then wait for it."""
    return _tpe.suggest_materialize(
        suggest_dispatch(new_ids, domain, trials, seed, **kwargs))


suggest.dispatch = suggest_dispatch
suggest.materialize = _tpe.suggest_materialize
suggest.start_transfer = _tpe.suggest_start_transfer
suggest.handle_ready = _tpe.suggest_handle_ready

#: The name the backend registry resolves through.
BACKENDS = {"es": suggest}

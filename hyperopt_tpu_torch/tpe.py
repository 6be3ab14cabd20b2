"""Tree-structured Parzen Estimator, in PyTorch.

Counterpart of ``hyperopt_tpu/tpe.py``, on its default lowering.  Defaults:
``prior_weight=1.0, n_startup_jobs=20, n_EI_candidates=24, gamma=0.25,
linear_forgetting=25``.

1. Until ``n_startup_jobs`` trials finish, propose by random search.
2. γ-split: the best ``n_below = min(ceil(gamma·sqrt(N)), LF)`` finished
   trials (``split='quantile'``: ``ceil(gamma·N)``) form the below set.
3. Per hyperparameter, fit adaptive-Parzen mixtures to the below and above
   observations (one batched fit for both, ``ops/step_ei.py``).
4. Draw ``n_EI_candidates`` per column from the below model and keep the
   one maximizing ``log p(x|below) − log p(x|above)``, independently per
   hyperparameter.

The step runs on the space's device over the history padded to a
power-of-two bucket, fed by the device-resident ring of ``history.py``
(``resident=False``: padded on the host and uploaded whole).  Continuous
columns come in up to three groups: density columns, scored by the CUDA
kernels of ``ops/ei_scores.py`` (the widest block of the step), on the
lowering the caller names (``ei_impl="vpu"`` with ``ei_precision="f32"``
or ``"bf16"``, or ``ei_impl="mxu"``), optionally against the top
``ei_topm`` above components only; quantized columns with a small bounded
lattice, scored once per lattice point and gathered; other quantized
columns, scored per candidate by their bin mass.  Categorical columns use
a weighted-count posterior.

``n > 1`` proposals past startup run the constant-liar scan
(:meth:`_TpeKernel._liar_scan`): propose, insert the proposal into the
history with the mean observed loss as a fantasy, refit, repeat; ``m``
steps (``n`` rounded up to a power of two) and one device→host fetch per
batch.

``multivariate=True`` scores whole candidate vectors instead (the JAX
package's ``_suggest_one_joint_tel``): the ``n_cand`` draws of every column
form ``n_cand`` vectors, the EI sheets of the columns active in a vector
add up (in a fixed order, ``ops/fixed_order.py``) and the best vector wins.

The JAX package's environment-switched component sampler is an argument
here: ``comp_sampler`` (``"icdf"``: one uniform per draw and a CDF
compare; ``"gumbel"``: the Gumbel-argmax trick over ``[n_cand, K]``
uniforms, for the mixture component and the categorical draw).  The
step's lowering (split, categorical prior, EI kernel, joint or factorized
winner, sampler) is checked and turned into the tuple that keys a kernel
in one place, :func:`_lowering`.

Randomness: each step's uniforms come from a ``torch.Generator`` seeded
from the suggest seed (one per batch, consumed in step order), or are
handed in as ``noise`` (tests give the port the uniforms the JAX step
draws).  Until ``n_startup_jobs`` trials finish, ``startup`` picks the
sampler: random search, or a low-discrepancy sequence (``qmc.py``).

Lanes (the fleet, ``fleet.py``): the step body takes a leading lane axis,
one experiment per lane with its own history, generator, ``gamma`` and
``prior_weight`` (:meth:`_TpeKernel._suggest_lanes`,
:meth:`_TpeKernel.suggest_fleet_seeded`); the solo step is its ``L = 1``
case, and lane ``j`` proposes bit for bit what a solo call proposes.

Hosted step graphs (:class:`_HostedStep`): on CUDA, a one-proposal step
without ``noise`` on a plain :class:`_TpeKernel` replays a CUDA graph of
that kernel's step instead of enqueueing its kernels one by one.  The
kernel's first hosted step runs eagerly (it builds or loads the EI
library); the second captures, and every later one replays, drawing the
bits the eager step draws from the same history and seed.  The liar
batch, ``noise=`` calls, ``dispatch.ShardedTpeKernel`` and the CPU run
eagerly.  Always-on counters: ``tpe.graph.captures``,
``tpe.graph.replays``, ``tpe.graph.capture_ms`` and
``tpe.graph.eager_steps`` (steps that would replay but ran eagerly after
a failed capture), and the gauge ``tpe.graph.pool_bytes`` (the memory
pool of the graph captured last, by :func:`_pool_bytes`, which device
mode's segments read too).
"""

from __future__ import annotations

import itertools
import logging
import math
import threading
from functools import partial
from time import perf_counter
from types import SimpleNamespace

import numpy as np
import torch

from . import base, history, rand
from .history import _padded_history
from .obs import costs as _costs
from .obs import trace as _trace
from .obs.metrics import kernel_cache_event
from .obs.metrics import registry as _metrics_registry
from .ops.ei_scores import MAX_COLUMNS, ei_scores
from .ops.ei_scores import build_seconds as ei_build_seconds
from .ops.fixed_order import prefix_sum, tree_sum
from .ops.gmm import (gmm_log_qmass, gmm_sample, gumbel_pick, icdf_pick,
                      onehot_lookup, truncate_mixture)
from .ops.parzen import forgetting_weights
from .ops.step_ei import ei_argmax_stats, fused_parzen_fit
from .space import (
    _MAX_RANDINT_RANGE,
    CATEGORICAL,
    LOGNORMAL,
    LOGUNIFORM,
    QLOGNORMAL,
    QLOGUNIFORM,
    QNORMAL,
    QUNIFORM,
    RANDINT,
    UNIFORM,
    UNIFORMINT,
    CompiledSpace,
    make_generator,
    resolve_device,
)

#: Functions that run under a CUDA graph capture (device mode's, the
#: hosted step's and ``graft_entry_torch.capture`` of ``entry()``'s step),
#: called from another module or another object: the capture-purity
#: analyzer starts there.
CAPTURED_ENTRY_POINTS = (
    "_TpeKernel._suggest_one_tel",
    "_TpeKernel._suggest_lanes",
    "_TpeKernel.draw_noise",
    "_HostedStep._step",
    "stack_noise",
    "_insert_row",
)

_default_prior_weight = 1.0
_default_n_startup_jobs = 20
_default_n_EI_candidates = 24
_default_gamma = 0.25
_default_linear_forgetting = 25
_EI_IMPLS = ("vpu", "mxu")
_EI_PRECISIONS = ("f32", "bf16")
_COMP_SAMPLERS = ("icdf", "gumbel")

_TINY = 1e-12
# Bucket bounds in MILLISECONDS of the suggest.*_ms histograms: 50 us to
# ~26 s, x2 per bucket (the registry's default buckets are seconds).
_MS_BUCKETS = tuple(0.05 * (2.0 ** i) for i in range(20))
_LOG_KINDS = (LOGUNIFORM, QLOGUNIFORM, LOGNORMAL, QLOGNORMAL)
# Finite stand-in for a -inf score: never wins an argmax, never NaNs.
_NEG = -3e38
# A bounded quantized column's support is a lattice of at most this many
# points; above it, candidates are scored one by one.
_LATTICE_CAP = 4096
# Largest [C, chunk, K] temporary of the per-candidate quantized scorer.
_Q_ELEMS = 1 << 24
# Hosted step graphs kept per space (LRU), as device mode's
# _RUN_CACHE_CAP: each pins its graph's memory pool.
_HOSTED_GRAPH_CAP = 8
# Stamps each hosted graph's last use, for the LRU.
_HOSTED_CLOCK = itertools.count()
# The hosted step graphs' always-on counters, made at import so that they
# read 0 where no graph runs.
_GRAPH_CAPTURES = _metrics_registry().counter("tpe.graph.captures")
_GRAPH_REPLAYS = _metrics_registry().counter("tpe.graph.replays")
_GRAPH_CAPTURE_MS = _metrics_registry().counter("tpe.graph.capture_ms")
_GRAPH_EAGER_STEPS = _metrics_registry().counter("tpe.graph.eager_steps")
_GRAPH_POOL_BYTES = _metrics_registry().gauge("tpe.graph.pool_bytes")


class _ContGroup:
    """Static arrays (numpy) for one group of continuous columns.

    ``is_q`` selects density or quantized-mass scoring.  Bounded q-columns
    carry lattice metadata (``lat_k0``, ``lat_len``: values ``k·q`` for
    ``k`` in ``[lat_k0, lat_k0 + lat_len)``)."""

    def __init__(self, specs, is_q):
        self.is_q = is_q
        self.use_lattice = False
        self.pids = np.asarray([s.pid for s in specs], np.int64)
        n = len(specs)
        self.is_log = np.zeros(n, bool)
        self.q = np.zeros(n, np.float32)
        self.fit_lo = np.full(n, -np.inf, np.float32)
        self.fit_hi = np.full(n, np.inf, np.float32)
        self.prior_mu = np.zeros(n, np.float32)
        self.prior_sigma = np.ones(n, np.float32)
        self.clip_lo = np.full(n, -np.inf, np.float32)
        self.clip_hi = np.full(n, np.inf, np.float32)
        self.lat_k0 = np.zeros(n, np.int64)
        self.lat_len = np.zeros(n, np.int64)
        for i, s in enumerate(specs):
            self.is_log[i] = s.kind in _LOG_KINDS
            if s.q:
                self.q[i] = s.q
            if s.kind in (UNIFORM, LOGUNIFORM, QUNIFORM, QLOGUNIFORM):
                lo, hi = s.low, s.high  # log kinds: bounds in log space
                if s.kind in (QUNIFORM, QLOGUNIFORM):
                    # Float math first: exp(high) or (high-low)/q may be
                    # huge (even inf) for legal spaces.
                    if s.kind == QUNIFORM:
                        k0f = np.floor(s.low / s.q + 0.5)
                        k1f = np.floor(s.high / s.q + 0.5)
                    else:
                        k0f = np.floor(np.exp(s.low) / s.q + 0.5)
                        k1f = np.floor(np.exp(s.high) / s.q + 0.5)
                    if np.isfinite(k1f) and np.isfinite(k0f) \
                            and k1f - k0f < _LATTICE_CAP:
                        self.lat_k0[i] = int(k0f)
                        self.lat_len[i] = int(k1f) - int(k0f) + 1
            elif s.kind == UNIFORMINT:
                lo, hi = s.low - 0.5, s.high + 0.5
                self.q[i] = 1.0
                self.clip_lo[i], self.clip_hi[i] = s.low, s.high
                self.lat_k0[i] = int(s.low)
                self.lat_len[i] = int(s.high - s.low) + 1
            elif s.kind == RANDINT:
                # Wide randint: a quantized uniform over [low, high).
                lo, hi = s.low - 0.5, s.high - 0.5
                self.q[i] = 1.0
                self.clip_lo[i], self.clip_hi[i] = s.low, s.high - 1
                self.lat_k0[i] = int(s.low)
                self.lat_len[i] = int(s.high - s.low)
            else:
                # Normal family: unbounded, prior (mu, sigma) in fit space.
                self.prior_mu[i] = s.mu
                self.prior_sigma[i] = s.sigma
                if s.q:
                    # Quantized normal tails saturate at the last f32-exact
                    # lattice point, as the sampler's do.
                    self.clip_hi[i] = _MAX_RANDINT_RANGE * s.q
                    self.clip_lo[i] = (0.0 if s.kind == QLOGNORMAL
                                       else -self.clip_hi[i])
                continue
            self.fit_lo[i], self.fit_hi[i] = lo, hi
            # Uniform prior: mid-point mean, full-width sigma.
            self.prior_mu[i] = 0.5 * (lo + hi)
            self.prior_sigma[i] = hi - lo

    def __len__(self):
        return len(self.pids)

    def tensors(self, device):
        """The group's arrays as tensors on ``device``."""
        names = ("pids", "is_log", "q", "fit_lo", "fit_hi", "prior_mu",
                 "prior_sigma", "clip_lo", "clip_hi", "lat_k0")
        out = {k: torch.as_tensor(getattr(self, k), device=device)
               for k in names}
        if self.use_lattice:
            out["lat_vals"] = torch.as_tensor(self.lat_vals, device=device)
        return SimpleNamespace(**out)


def _obs_ms(reg, name, ms):
    """Record a host phase's milliseconds both ways: the counter keeps the
    running total, the same-named histogram the distribution."""
    reg.counter(name).inc(ms)
    reg.histogram(name, buckets=_MS_BUCKETS).observe(ms)


def _lowering(split, cat_prior, ei_impl, ei_precision, ei_topm,
              multivariate, comp_sampler):
    """The TPE step's lowering, checked: ``(split, cat_prior, ei_impl,
    ei_precision, ei_topm, multivariate, comp_sampler)`` with ``ei_topm``
    an int and ``multivariate`` a bool, the tuple that keys a kernel
    (:func:`get_kernel`, ``dispatch.get_kernel``, ``device._segment_for``).
    Raises ``ValueError`` naming the first bad argument."""
    if ei_impl not in _EI_IMPLS:
        raise ValueError(f"ei_impl must be one of {_EI_IMPLS}, got "
                         f"{ei_impl!r}")
    if ei_precision not in _EI_PRECISIONS:
        raise ValueError(f"ei_precision must be one of {_EI_PRECISIONS}, "
                         f"got {ei_precision!r}")
    if isinstance(ei_topm, bool) or not isinstance(ei_topm, (int, np.integer)) \
            or ei_topm < 0:
        raise ValueError(f"ei_topm must be an int >= 0, got {ei_topm!r}")
    if comp_sampler not in _COMP_SAMPLERS:
        raise ValueError(f"comp_sampler must be one of {_COMP_SAMPLERS}, "
                         f"got {comp_sampler!r}")
    if split not in ("sqrt", "quantile"):
        raise ValueError(f"split must be 'sqrt' or 'quantile', got {split!r}")
    if cat_prior not in ("sqrt", "const"):
        raise ValueError(
            f"cat_prior must be 'sqrt' or 'const', got {cat_prior!r}")
    return (split, cat_prior, ei_impl, ei_precision, int(ei_topm),
            bool(multivariate), comp_sampler)


def _insert_row(hv, ha, hl, hok, idx, row, act, loss, ok=True):
    """Write trials into rows ``idx`` (an int64 ``[k]`` tensor on the
    history's device) of the padded history tensors, in place: the liar
    scan's fantasy rows, device mode's landed trials.  ``row``/``act``
    hold ``k`` rows (``[k, P]``, or ``[P]`` for one); ``loss`` is float32
    with one value or ``k``; ``ok`` True or a bool tensor like ``loss``.
    The fleet writes one row per lane into the lanes flattened to
    ``[L·N, ...]``.  The row index is a tensor so that a replayed CUDA
    graph writes where the index points now, not where it pointed at
    capture."""
    k = idx.shape[0]
    hv.index_copy_(0, idx, row.reshape(k, *hv.shape[1:]))
    ha.index_copy_(0, idx, act.reshape(k, *ha.shape[1:]))
    hl.index_copy_(0, idx, loss.reshape(-1).expand(k))
    if ok is True:
        hok.index_fill_(0, idx, True)
    else:
        hok.index_copy_(0, idx, ok.reshape(-1).expand(k))
    return hv, ha, hl, hok


class _TpeKernel:
    """The TPE suggest step for a fixed (space, history bucket, n_cand, LF,
    device, lowering).

    The lowering is :func:`_lowering`'s: ``split`` and ``cat_prior``;
    ``ei_impl``/``ei_precision`` pick the EI kernel (``ops/ei_scores.py``:
    ``"vpu"``/``"f32"`` K1, ``"vpu"``/``"bf16"`` K2, ``"mxu"`` K3, which
    ignores the precision); ``ei_topm > 0`` scores against the top
    ``ei_topm`` above components by weight only.  ``multivariate`` and
    ``comp_sampler``: see the module doc."""

    def __init__(self, cs: CompiledSpace, n_cap: int, n_cand: int, lf: int,
                 split: str = "sqrt", cat_prior: str = "sqrt", device="cuda",
                 ei_impl: str = "vpu", ei_precision: str = "f32",
                 ei_topm: int = 0, multivariate: bool = False,
                 comp_sampler: str = "icdf"):
        self.lowering = _lowering(split, cat_prior, ei_impl, ei_precision,
                                  ei_topm, multivariate, comp_sampler)
        (self.split, self.cat_prior, self.ei_impl, self.ei_precision,
         self.ei_topm, self.multivariate, self.comp_sampler) = self.lowering
        self.cs = cs
        self.n_cap = n_cap
        self.n_cand = n_cand
        self.lf = lf
        self.device = torch.device(device)
        # The cohort tiers (lanes, steps) this kernel has served, for the
        # kernel-cache and cost rows of suggest_fleet_seeded.
        self._fleet_tiers = set()
        self._tiers_lock = threading.Lock()
        # Whether a hosted step ran (tpe.cold_step_ms times the first).
        self.stepped = False
        # The hosted step's graphs (_HostedStep), by float32 (gamma,
        # prior_weight); uncapturable is set when a capture failed: later
        # hosted steps run eagerly.
        self.hosted = {}
        self.uncapturable = False

        cont_q, cont_n, cat = [], [], []
        for s in cs.params:
            if s.kind == CATEGORICAL or (s.kind == RANDINT
                                         and s.probs is not None):
                cat.append(s)
            elif s.kind in (QUNIFORM, QLOGUNIFORM, QNORMAL, QLOGNORMAL,
                            UNIFORMINT, RANDINT):
                cont_q.append(s)
            else:
                cont_n.append(s)
        probe = _ContGroup(cont_q, is_q=True)
        lattice_ok = (probe.lat_len > 0) & (probe.lat_len <= _LATTICE_CAP)
        q_lat = [s for s, okl in zip(cont_q, lattice_ok) if okl]
        q_full = [s for s, okl in zip(cont_q, lattice_ok) if not okl]
        lat_group = _ContGroup(q_lat, is_q=True)
        if len(lat_group):
            lat_group.use_lattice = True
            lmax = int(lat_group.lat_len.max())
            # Lattice values in f64, then one rounding to f32.
            lat_group.lat_vals = (
                (lat_group.lat_k0[:, None] + np.arange(lmax)[None, :])
                * lat_group.q[:, None].astype(np.float64)
            ).astype(np.float32)
        self.groups = [g for g in (_ContGroup(cont_n, is_q=False),
                                   _ContGroup(q_full, is_q=True),
                                   lat_group)
                       if len(g)]
        self._gt = [g.tensors(self.device) for g in self.groups]

        dev = self.device
        self.cat_pids = np.asarray([s.pid for s in cat], np.int64)
        self.cat_kmax = max([s.n_options for s in cat], default=1)
        priors = np.zeros((len(cat), self.cat_kmax), np.float32)
        offsets = np.zeros(len(cat), np.float32)
        for i, s in enumerate(cat):
            priors[i, : s.n_options] = s.probs
            if s.kind == RANDINT:
                offsets[i] = s.low
        nopts = np.asarray([s.n_options for s in cat], np.float32)
        self._cat = SimpleNamespace(
            pids=torch.as_tensor(self.cat_pids, device=dev),
            priors=torch.as_tensor(priors, device=dev),
            nopts=torch.as_tensor(nopts, device=dev),
            last=torch.as_tensor(nopts.astype(np.int64) - 1, device=dev),
            offsets=torch.as_tensor(offsets, device=dev),
            options=torch.arange(self.cat_kmax, dtype=torch.float32,
                                 device=dev))

    # -- shared helpers ------------------------------------------------------
    #
    # Every method below takes an optional leading lane axis ``L`` on the
    # history (``[..., N]``, ``[..., N, P]``): the fleet's experiments, one
    # per lane, in one call.  Lanes fold into the column axis of the ops
    # (``[L, C, ...]`` mixtures, ``[L·C, n]`` EI sheets), and every float
    # sum runs in a fixed order (``ops/fixed_order.py``), so lane ``j``
    # proposes the bits a solo call (no lane axis, or ``L = 1``) proposes
    # for that experiment.

    def _split(self, loss, ok, gamma):
        """γ-split by ranked loss: ``(below[..., N], above[..., N])`` bool
        masks.  ``gamma``: a float, or f32[L] (one per lane).

        Ties break by trial index; NaN losses rank with the +inf padding."""
        n_ok = torch.sum(ok, dim=-1)
        n_f = n_ok.to(torch.float32)
        # gamma rounded to float32; a float stays a scalar operand (no
        # host→device copy per call).
        g = _lane_value(gamma)
        if self.split == "sqrt":
            n_below = torch.ceil(g * torch.sqrt(n_f))
        else:
            n_below = torch.ceil(g * n_f)
        n_below = torch.minimum(n_below.to(torch.int64),
                                torch.clamp_max(n_ok, self.lf))
        loss = torch.where(torch.isnan(loss),
                           torch.full_like(loss, math.inf), loss)
        # Only the k = min(lf, N) smallest losses can enter the below set.
        # A stable sort keeps the lower index first on ties, the order
        # lax.top_k gives in the JAX step.
        k = min(self.lf, loss.shape[-1])
        idx = torch.argsort(loss, dim=-1, stable=True)[..., :k]
        below = torch.zeros_like(ok)
        below.scatter_(-1, idx, torch.arange(k, device=loss.device)
                       < n_below[..., None])
        below = below & ok
        return below, ok & ~below

    def _set_weights(self, set_mask, act):
        """Per-column observation weights for one split set:
        ``(mask[..., N, C], weights[..., N, C], n_set[..., C])``; linear
        forgetting by recency rank within the set, zero elsewhere."""
        m = set_mask[..., None] & act
        n_set = torch.sum(m, dim=-2)
        rank_in = torch.cumsum(m.to(torch.int64), dim=-2) - 1
        w = forgetting_weights(rank_in, n_set[..., None, :], self.lf)
        return m, torch.where(m, w, torch.zeros_like(w)), n_set

    # -- continuous columns --------------------------------------------------

    def _cont_fit(self, gt, vals, active, below, above, prior_weight):
        """Below/above fits for one group:
        ``(lwb, mub, sgb, lwa, mua, sga)`` (log-weights, means, sigmas),
        each ``[..., C, K]``."""
        z = vals[..., gt.pids]
        z = torch.where(gt.is_log, torch.log(torch.clamp_min(z, _TINY)), z)
        act = active[..., gt.pids]
        cap_b = min(self.lf, self.n_cap) + 1
        cap_a = self.n_cap + 1

        def set_obs(set_mask):
            m, w, n_set = self._set_weights(set_mask, act)
            return torch.where(m, z, torch.full_like(z, math.inf)), w, n_set

        return fused_parzen_fit(*set_obs(below), *set_obs(above),
                                gt.prior_mu, gt.prior_sigma, prior_weight,
                                cap_b, cap_a)

    def _cont_draw(self, gt, lwb, mub, sgb, uc, u):
        """Candidate draws ``zc [..., C, n_cand]`` (fit space) from the
        below model; ``uc`` is ``[..., C, n_cand]`` (icdf) or ``[..., C,
        n_cand, K_b]`` (gumbel)."""
        return gmm_sample(lwb, mub, sgb, gt.fit_lo, gt.fit_hi, uc, u,
                          gumbel=self.comp_sampler == "gumbel")

    def _cont_scores(self, g, gt, vals, active, below, above, prior_weight,
                     uc, u):
        """Candidate values + EI scores: ``([..., C, n_cand]`` twice)."""
        fits = self._cont_fit(gt, vals, active, below, above, prior_weight)
        zc = self._cont_draw(gt, *fits[:3], uc, u)
        return self._cont_ei(g, gt, zc, fits)

    def _cont_ei(self, g, gt, zc, fits):
        """Natural-space values + EI scores from fit-space draws ``zc``."""
        lwb, mub, sgb, lwa, mua, sga = fits
        x_nat = torch.where(gt.is_log[:, None], torch.exp(zc), zc)
        if not g.is_q:
            # Density columns: the CUDA kernel (plain twin on the CPU), lanes
            # folded into its column axis.  Only the above mixture is
            # truncated: the below one also feeds the draws.
            if 0 < self.ei_topm < lwa.shape[-1]:
                lwa, mua, sga = truncate_mixture(lwa, mua, sga, self.ei_topm)
            zs = self._cand_slice(zc)
            n = zs.shape[-1]
            rows = [t.reshape(-1, t.shape[-1]).contiguous()
                    for t in (zs, lwb, mub, sgb, lwa, mua, sga)]
            ei = ei_scores(*rows, mxu=self.ei_impl == "mxu",
                           bf16=self.ei_precision == "bf16")
            return x_nat, ei.reshape(*zs.shape[:-1], n)
        q = gt.q[:, None]
        v = torch.round(x_nat / q) * q
        v = torch.minimum(torch.maximum(v, gt.clip_lo[:, None]),
                          gt.clip_hi[:, None])
        is_log = gt.is_log[:, None]

        def q_edges(vals_nat):
            el, eh = vals_nat - 0.5 * q, vals_nat + 0.5 * q
            ninf = torch.full_like(el, -math.inf)
            zl = torch.where(is_log,
                             torch.where(el > 0,
                                         torch.log(torch.clamp_min(el, _TINY)),
                                         ninf),
                             el)
            zh = torch.where(is_log, torch.log(torch.clamp_min(eh, _TINY)), eh)
            return zl, zh

        def ei_q(zl, zh):
            return (gmm_log_qmass(zl, zh, lwb, mub, sgb, gt.fit_lo, gt.fit_hi)
                    - gmm_log_qmass(zl, zh, lwa, mua, sga, gt.fit_lo,
                                    gt.fit_hi))

        if g.use_lattice:
            # Score each lattice point once, gather per candidate.  ei_lat
            # may hold -inf at selectable far-tail points (zero below
            # mass); the finite fill keeps "never wins" exact.
            ei_lat = ei_q(*q_edges(gt.lat_vals))              # [..., C, Lat]
            idx = torch.round(v / q).to(torch.int64) - gt.lat_k0[:, None]
            idx = torch.clamp(idx, 0, gt.lat_vals.shape[1] - 1)
            return v, onehot_lookup(self._cand_slice(idx), ei_lat, _NEG)
        zl, zh = q_edges(self._cand_slice(v))
        n = zl.shape[-1]
        rows = zl.numel() // max(1, n)
        chunk = max(1, _Q_ELEMS // max(1, rows * lwa.shape[-1]))
        ei = torch.cat([ei_q(zl[..., i:i + chunk], zh[..., i:i + chunk])
                        for i in range(0, n, chunk)], dim=-1)
        return v, ei

    # -- categorical columns -------------------------------------------------

    def _cat_scores(self, u, vals, active, below, above, prior_weight):
        """Candidate values (offset applied) + scores: ``([..., D, n_cand]``
        twice), candidates drawn by inverse CDF from uniforms
        ``u [..., D, n_cand]``, or (gumbel) by the Gumbel-argmax trick from
        ``u [..., D, n_cand, kmax]``."""
        ct = self._cat
        idx = vals[..., ct.pids] - ct.offsets               # [..., N, D]
        act = active[..., ct.pids]
        onehot = (idx[..., None] == ct.options).to(torch.float32)
        pw = _lane_value(prior_weight, 1)

        def log_post(set_mask):
            # Weighted counts + prior pseudocounts; prior strength
            # 'const': n_options·prior_weight (decays as 1/N), 'sqrt':
            # prior_weight·sqrt(1+N) (decays as 1/sqrt(N)).
            _, w, n_set = self._set_weights(set_mask, act)
            counts = tree_sum(w[..., None] * onehot, dim=-3)  # [..., D, K]
            if self.cat_prior == "const":
                strength = pw * ct.nopts
            else:
                strength = pw * torch.sqrt(1.0 + n_set.to(torch.float32))
            pseudo = counts + ct.priors * strength[..., None]
            return torch.log(pseudo / tree_sum(pseudo, dim=-1, keepdim=True))

        lpb = log_post(below)
        lpa = log_post(above)
        if self.comp_sampler == "gumbel":
            cand = gumbel_pick(u, lpb)
        else:
            cdf = prefix_sum(torch.exp(lpb), dim=-1)        # [..., D, kmax]
            cand = icdf_pick(u, cdf, ct.last[:, None])
        # Padded options are -inf on both sides; clamping each side to a
        # finite value keeps a selectable option with zero above-mass on
        # top of the argmax (its true ratio is +inf).
        diff = torch.clamp_min(lpb, _NEG) - torch.clamp_min(lpa, _NEG)
        score = onehot_lookup(self._cand_slice(cand), diff)
        return cand.to(torch.float32) + ct.offsets[:, None], score

    # -- the candidate axis ----------------------------------------------------
    #
    # The local step scores every candidate and reduces its argmaxes on
    # the spot; dispatch.ShardedTpeKernel overrides these two hooks to
    # score one slice of the candidates per rank and to reduce the
    # argmaxes over its ranks.

    def _cand_slice(self, x, dim=-1):
        """The candidates this kernel scores, along ``dim`` of ``x``: all
        of them."""
        return x

    def _reduce_stats(self, stats):
        """Per-sheet ``(bi, best, ties)`` of :func:`ei_argmax_stats` over
        the scored candidates, as winners over all candidates: the same
        here."""
        return stats

    def _next_bucket(self):
        """This kernel's twin at the next history bucket (``2·n_cap``,
        the same arguments): what :func:`_prewarm_async` builds."""
        return _kernel(self.cs, self.n_cap * 2, self.n_cand, self.lf,
                       self.device, self.lowering)

    # -- the step ------------------------------------------------------------

    def noise_shapes(self):
        """Shapes of one lane's uniforms, in :meth:`draw_noise`'s layout
        and draw order: ``{"cont": [(uc, u) per group], "cat": shape}``."""
        n = self.n_cand
        if self.comp_sampler == "gumbel":
            k_b = min(self.lf, self.n_cap) + 1
            return {"cont": [((len(g), n, k_b), (len(g), n))
                             for g in self.groups],
                    "cat": (len(self.cat_pids), n, self.cat_kmax)}
        return {"cont": [((len(g), n), (len(g), n)) for g in self.groups],
                "cat": (len(self.cat_pids), n)}

    def draw_noise(self, generator=None):
        """One lane's uniforms: ``{"cont": [(uc, u) per group], "cat":
        u}`` with ``[C, n_cand]`` / ``[D, n_cand]`` shapes; with
        ``comp_sampler="gumbel"``, ``uc`` is ``[C, n_cand, K_b]`` (``K_b``
        the below mixture's components) and ``cat`` ``[D, n_cand, kmax]``:
        the uniforms of the Gumbel draws.  Drawn in the order of
        :meth:`noise_shapes`."""

        def r(shape):
            return torch.rand(shape, generator=generator, device=self.device,
                              dtype=torch.float32)

        shapes = self.noise_shapes()
        return {"cont": [(r(a), r(b)) for a, b in shapes["cont"]],
                "cat": r(shapes["cat"])}

    def max_lanes(self):
        """The most lanes one step takes: the EI kernel's column axis
        (``grid.y``) holds 65,535 columns, and a lane brings the widest
        density group's columns.  None when no group reaches the kernel."""
        widths = [len(g) for g in self.groups if not g.is_q]
        return MAX_COLUMNS // max(widths) if widths else None

    def check_lanes(self, n_lanes):
        """Raise ``ValueError`` unless one step can take ``n_lanes`` lanes
        (:meth:`max_lanes`)."""
        cap = self.max_lanes()
        if cap is not None and int(n_lanes) > cap:
            width = max(len(g) for g in self.groups if not g.is_q)
            raise ValueError(
                f"{n_lanes} lanes x {width} density columns exceed the EI "
                f"kernel's {MAX_COLUMNS} columns: this space takes at "
                f"most {cap} lanes")

    def _suggest_lanes(self, vals, active, loss, ok, gamma, prior_weight,
                       generators=None, noise=None):
        """One proposal per lane: ``(row[L, P], act[L, P], ei_best[L],
        ei_ties[L])``.

        ``vals/active`` are ``[L, N, P]`` and ``loss/ok`` ``[L, N]``, the
        padded histories on this kernel's device; ``gamma`` and
        ``prior_weight`` floats or f32[L].  Lane ``j`` draws its uniforms
        from ``generators[j]``, or takes them from ``noise`` (the
        :meth:`draw_noise` layout with a leading lane axis,
        :func:`stack_noise`).  ``ei_best`` is the winning EI score across
        the sheets and ``ei_ties`` counts candidates tying their sheet's
        winner; with ``multivariate``, the winning vector's joint score and
        the vectors tying it (:meth:`_joint_winner`)."""
        n_lanes = loss.shape[0]
        with _trace.span("tpe.step.draw"):
            if noise is None:
                gens = (generators if generators is not None
                        else [None] * n_lanes)
                noise = stack_noise([self.draw_noise(g) for g in gens])
        with _trace.span("tpe.step.split"):
            below, above = self._split(loss, ok, gamma)
        with _trace.span("tpe.step.groups"):
            cols = []
            for g, gt, (uc, u) in zip(self.groups, self._gt, noise["cont"]):
                v, ei = self._cont_scores(g, gt, vals, active, below, above,
                                          prior_weight, uc, u)
                cols.append((gt.pids, v, ei))
            if len(self.cat_pids):
                cv, score = self._cat_scores(noise["cat"], vals, active,
                                             below, above, prior_weight)
                cols.append((self._cat.pids, cv, score))
        with _trace.span("tpe.step.pick"):
            dev = self.device
            row = torch.zeros((n_lanes, self.cs.n_params),
                              dtype=torch.float32, device=dev)
            ei_best = torch.full((n_lanes,), -math.inf, dtype=torch.float32,
                                 device=dev)
            ei_ties = torch.zeros((n_lanes,), dtype=torch.int64, device=dev)
            if self.multivariate:
                return self._joint_winner(cols, n_lanes)
            stats = self._reduce_stats([ei_argmax_stats(ei)
                                        for _, _, ei in cols])
            for (pids, v, _), (bi, best, ties) in zip(cols, stats):
                row[:, pids] = torch.gather(v, -1, bi[..., None])[..., 0]
                ei_best = torch.maximum(ei_best, torch.amax(best, dim=-1))
                ei_ties = ei_ties + torch.sum(ties, dim=-1)
            act_row = self.cs.active_mask(row)
        return row, act_row, ei_best, ei_ties

    def _joint_winner(self, cols, n_lanes):
        """The multivariate winner of each lane from the column sheets
        ``[(pids, v[L, C, n_cand], ei[L, C, n_cand]), ...]``: ``(row[L, P],
        act[L, P], ei_best[L], ei_ties[L])``.

        Candidate ``i`` of every column forms vector ``i``; under the
        factorized Parzen model its joint EI surrogate is the sum of the
        per-column scores over the columns active in it.  The sum runs in
        a fixed order (``tree_sum``), so lane ``j`` equals its solo run.
        Two ``-3e38`` fills in one vector (a far-tail lattice point, a
        clamped categorical side) add up to ``-inf`` in float32, as in
        the JAX step."""
        n, p = self.n_cand, self.cs.n_params
        dev = self.device
        cand = torch.zeros((n_lanes, n, p), dtype=torch.float32, device=dev)
        # The score sheets cover this kernel's candidates (all of them on
        # the local path, a slice in dispatch.ShardedTpeKernel).
        n_sc = cols[0][2].shape[-1] if cols else n
        ei_cols = torch.zeros((n_lanes, n_sc, p), dtype=torch.float32,
                              device=dev)
        for pids, v, ei in cols:
            cand[:, :, pids] = v.transpose(-1, -2)
            ei_cols[:, :, pids] = ei.transpose(-1, -2)
        act = self.cs.active_mask(cand.view(n_lanes * n, p)).view(
            n_lanes, n, p)
        total = tree_sum(torch.where(self._cand_slice(act, dim=1), ei_cols,
                                     torch.zeros_like(ei_cols)),
                         dim=-1)                            # [L, n_cand]
        ((bi, best, ties),) = self._reduce_stats([ei_argmax_stats(total)])
        at = bi[:, None, None].expand(n_lanes, 1, p)
        return (torch.gather(cand, 1, at)[:, 0],
                torch.gather(act, 1, at)[:, 0], best, ties.to(torch.int64))

    def _suggest_one_tel(self, vals, active, loss, ok, gamma, prior_weight,
                         generator=None, noise=None):
        """One proposal: ``(row[P], act[P], ei_best, ei_ties)``, the
        ``L = 1`` case of :meth:`_suggest_lanes` (``vals/active/loss/ok``
        the padded history without a lane axis)."""
        out = self._suggest_lanes(
            vals[None], active[None], loss[None], ok[None], gamma,
            prior_weight, generators=[generator],
            noise=None if noise is None else stack_noise([noise]))
        return tuple(t[0] for t in out)

    def __call__(self, vals, active, loss, ok, gamma, prior_weight,
                 generator=None, noise=None):
        row, act_row, _, _ = self._suggest_one_tel(
            vals, active, loss, ok, gamma, prior_weight, generator, noise)
        return row, act_row

    def _liar_lanes(self, m, n_rows, vals, active, loss, ok, gamma,
                    prior_weight, generators=None, noises=None):
        """``m`` proposals per lane with constant-liar fantasy refits:
        ``(rows[L, m, P], acts[L, m, P])`` on the device.

        Independent EI-argmax draws from one posterior collapse onto the
        same peak.  Constant liar (Ginsbourger): after each proposal,
        insert it at row ``n_rows[j] + i`` of a copy of lane ``j``'s
        history with a fantasy loss, the mean of its observed ``ok``
        losses, which ranks it into the above set and repels the next
        proposal; refit and propose again.  ``n_rows``: int64[L] on the
        device.  Step ``i`` draws lane ``j``'s uniforms from
        ``generators[j]`` (in step order) or takes ``noises[i]`` (lane
        axis leading)."""
        if noises is not None and len(noises) != m:
            raise ValueError(f"{len(noises)} noise dicts for {m} steps")
        n_lanes, n = loss.shape
        n_ok = torch.clamp_min(torch.sum(ok, dim=-1), 1).to(torch.float32)
        lie = tree_sum(torch.where(ok, loss, torch.zeros_like(loss)),
                       dim=-1) / n_ok
        hist = [t.clone(memory_format=torch.contiguous_format)
                for t in (vals, active, loss, ok)]
        flat = [t.view(n_lanes * n, *t.shape[2:]) for t in hist]
        at = n_rows + torch.arange(n_lanes, device=loss.device) * n
        rows, acts = [], []
        for i in range(m):
            row, act, _, _ = self._suggest_lanes(
                *hist, gamma, prior_weight, generators,
                None if noises is None else noises[i])
            _insert_row(*flat, at, row, act, lie)
            at = at + 1
            rows.append(row)
            acts.append(act)
        return torch.stack(rows, dim=1), torch.stack(acts, dim=1)

    def _liar_scan(self, m, n_rows, vals, active, loss, ok, gamma,
                   prior_weight, generator=None, noises=None):
        """``m`` constant-liar proposals for one history: ``(rows[m, P],
        acts[m, P])``, the ``L = 1`` case of :meth:`_liar_lanes`; step
        ``i`` draws from ``generator`` or takes ``noises[i]``."""
        at = torch.full((1,), n_rows, dtype=torch.int64, device=loss.device)
        rows, acts = self._liar_lanes(
            m, at, vals[None], active[None], loss[None], ok[None], gamma,
            prior_weight, generators=[generator],
            noises=None if noises is None
            else [stack_noise([nz]) for nz in noises])
        return rows[0], acts[0]

    def suggest_many(self, m, n_rows, vals, active, loss, ok, gamma,
                     prior_weight, generator=None, noises=None):
        """``m`` constant-liar proposals (see :meth:`_liar_lanes`); the
        bucket must hold the ``n_rows`` history rows and ``m`` more."""
        if n_rows + m > self.n_cap:
            raise ValueError(f"{n_rows} rows + {m} fantasies do not fit the "
                             f"bucket of {self.n_cap}")
        return self._liar_scan(m, n_rows, vals, active, loss, ok, gamma,
                               prior_weight, generator, noises)

    def suggest_fleet_seeded(self, seeds, m, n_rows, hv, ha, hl, hok, gamma,
                             prior_weight, noises=None):
        """Cohort suggest: ``(rows[B, m, P], acts[B, m, P])`` on the device
        from stacked ``[B, n_cap, ...]`` history lanes, per-lane integer
        seeds and insertion cursors ``n_rows[B]``.  ``gamma`` and
        ``prior_weight`` are floats or one per lane.

        Lane ``j`` proposes what a solo call proposes for that history
        under ``seeds[j]``: one step (``m == 1``) as :meth:`__call__`, else
        the liar scan of :meth:`suggest_many`, its uniforms drawn from a
        generator seeded with ``seeds[j] % 2**32`` (as
        ``suggest_dispatch``), or taken from ``noises[j]`` (a list of
        ``m`` :meth:`draw_noise` dicts).  Each call feeds the
        kernel-cache and cost rows of its tier ``("fleet", n_cap, P, m,
        B)``."""
        b = len(seeds)
        self.check_lanes(b)
        tier = ("fleet", self.n_cap, self.cs.n_params, m, b)
        with self._tiers_lock:
            hit = tier in self._fleet_tiers
            self._fleet_tiers.add(tier)
        kernel_cache_event(tier, hit)
        if not hit:
            _costs.record_compile("fleet", tier, n_cap=self.n_cap,
                                  P=self.cs.n_params, m=m, tier=b)
        t0 = perf_counter()
        n_rows = [int(r) for r in n_rows]
        if len(n_rows) != b:
            raise ValueError(f"{len(n_rows)} cursors for {b} lanes")
        if m > 1 and max(n_rows) + m > self.n_cap:
            raise ValueError(f"{max(n_rows)} rows + {m} fantasies do not fit "
                             f"the bucket of {self.n_cap}")
        gamma = _lane_param(gamma, b, self.device)
        prior_weight = _lane_param(prior_weight, b, self.device)
        if noises is not None:
            if len(noises) != b or any(len(nz) != m for nz in noises):
                raise ValueError(f"noises must hold {m} dicts for each of "
                                 f"{b} lanes")
            steps = [stack_noise([nz[i] for nz in noises]) for i in range(m)]
            gens = None
        else:
            steps = None
            gens = [make_generator(self.device, int(s) % (2 ** 32))
                    for s in seeds]
        with _trace.span("tpe.step"):
            if m == 1:
                rows, acts, _, _ = self._suggest_lanes(
                    hv, ha, hl, hok, gamma, prior_weight, gens,
                    None if steps is None else steps[0])
                out = rows[:, None], acts[:, None]
            else:
                at = torch.as_tensor(n_rows, dtype=torch.int64,
                                     device=self.device)
                out = self._liar_lanes(m, at, hv, ha, hl, hok, gamma,
                                       prior_weight, gens, steps)
        _costs.observe_dispatch(tier, (perf_counter() - t0) * 1e3)
        return out


def stack_noise(noises):
    """Per-lane :meth:`_TpeKernel.draw_noise` dicts as one dict with a
    leading lane axis (a view for one lane)."""
    if len(noises) == 1:
        (nz,) = noises
        return {"cont": [(uc[None], u[None]) for uc, u in nz["cont"]],
                "cat": nz["cat"][None]}
    return {"cont": [(torch.stack([nz["cont"][k][0] for nz in noises]),
                      torch.stack([nz["cont"][k][1] for nz in noises]))
                     for k in range(len(noises[0]["cont"]))],
            "cat": torch.stack([nz["cat"] for nz in noises])}


def _lane_value(x, trailing=0):
    """A per-lane parameter as an operand: a float rounded to float32 (a
    scalar, no host→device copy), or an f32[L] tensor with ``trailing``
    axes of size 1 appended for broadcasting."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).reshape(x.shape + (1,) * trailing)
    return float(np.float32(x))


def _lane_param(x, n_lanes, device):
    """``gamma``/``prior_weight`` for ``n_lanes`` lanes: a float when every
    lane has the same value, else f32[L] on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    a = np.asarray(x, np.float32).reshape(-1)
    if a.size == 1 or (a == a[0]).all():
        return float(a[0])
    if a.size != n_lanes:
        raise ValueError(f"{a.size} values for {n_lanes} lanes")
    return torch.as_tensor(a, device=device)


def _bucket(n: int) -> int:
    """Power-of-two history capacity (min 32)."""
    return max(32, 1 << max(n - 1, 1).bit_length())


#: Guards the per-space kernel caches of :func:`get_kernel`: the bucket
#: prewarm thread (:func:`_prewarm_async`) and the suggest path may build
#: the same kernel at once, and one of the two builds would be wasted.
_KERNELS_LOCK = threading.Lock()
# Prewarm threads started by _prewarm_async (pruned of finished ones).
_PREWARMS: list = []


def get_kernel(cs: CompiledSpace, n_cap: int, n_cand: int, lf: int,
               split: str = "sqrt", cat_prior: str = "sqrt",
               device="cuda", ei_impl: str = "vpu", ei_precision: str = "f32",
               ei_topm: int = 0, multivariate: bool = False,
               comp_sampler: str = "icdf") -> _TpeKernel:
    """The cached :class:`_TpeKernel` for these shapes and arguments."""
    return _kernel(cs, n_cap, n_cand, lf, torch.device(device),
                   _lowering(split, cat_prior, ei_impl, ei_precision, ei_topm,
                             multivariate, comp_sampler))


def _kernel(cs, n_cap, n_cand, lf, device, lowering):
    """:func:`get_kernel` for a checked ``lowering`` (:func:`_lowering`):
    the suggest paths check their arguments once a call and look a kernel
    up once a bucket."""
    return _cached_kernel(
        "_tpe_kernels", "tpe", cs, (n_cap, n_cand, lf, str(device)) + lowering,
        lambda: _TpeKernel(cs, n_cap, n_cand, lf, *lowering[:2], device,
                           *lowering[2:]))


def _cached_kernel(cache_name, kind, cs, key, build):
    """The kernel under ``key`` in the space's cache ``cs.<cache_name>``,
    made by ``build()`` on a miss (:func:`get_kernel`, kind ``"tpe"``;
    ``dispatch.get_kernel``, kind ``"tpe_sharded"``).  Each lookup feeds
    ``kernel_cache_event``; a miss is a ``tpe.kernel_build`` span, adds its
    build time to the counter ``tpe.kernel_build_ms`` and records it in the
    cost ledger (when armed) under ``kind``."""
    with _KERNELS_LOCK:
        cache = cs.__dict__.setdefault(cache_name, {})
        hit = key in cache
        if not hit:
            t0 = perf_counter()
            with _trace.span("tpe.kernel_build"):
                cache[key] = build()
            build_s = perf_counter() - t0
            _metrics_registry().counter("tpe.kernel_build_ms").inc(
                build_s * 1e3)
            cache[key].cost_key = key
            _costs.record_compile(kind, key, n_cap=key[0], P=cs.n_params,
                                  m=1, compile_s=build_s)
        kern = cache[key]
    kernel_cache_event(key, hit)
    return kern


def _prewarm_async(kern: _TpeKernel, n: int = 1):
    """Build the next history bucket's kernel (``2·kern.n_cap``, the same
    arguments) in a daemon thread, and return the thread; None when it is
    built or being built already.

    The JAX package compiles that bucket's program ahead here; the port
    has no compile, and what the call that crosses the boundary would pay
    is the kernel's construction (its column groups, lattice tables and
    constants uploaded to the device).  ``n`` is the proposals per call
    the next bucket serves (JAX warms the n-proposal program); the port's
    kernel is the same for every ``n``, so one build serves them all.
    Best-effort: a failure leaves the suggest path to build the kernel
    itself."""
    del n
    with _KERNELS_LOCK:
        if getattr(kern, "_prewarmed", False):
            return None
        kern._prewarmed = True
    request = _trace.current_request()

    def go():
        _trace.set_request(request)
        try:
            kern._next_bucket()
        except Exception:
            logging.getLogger(__name__).debug("bucket prewarm failed",
                                              exc_info=True)

    t = threading.Thread(target=go, daemon=True,
                         name=f"tpe-prewarm-{kern.n_cap * 2}")
    with _KERNELS_LOCK:
        t.start()
        _PREWARMS[:] = [p for p in _PREWARMS if p.is_alive()] + [t]
    return t


def wait_prewarm():
    """Join the prewarm threads still running.  Device mode calls it before
    a capture: a thread uploading a kernel's constants while a graph is
    being captured would break the capture."""
    with _KERNELS_LOCK:
        threads = list(_PREWARMS)
    for t in threads:
        t.join()


def _pool_bytes(graph):
    """Bytes of the caching allocator's segments in ``graph``'s private
    memory pool (the hosted step's graphs and device mode's).
    (``torch.cuda.memory_reserved`` does not tell it: across a capture it
    can stay put, or drop when a cached graph is evicted.)"""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


class _HostedCaptureError(RuntimeError):
    """A capture of the hosted step failed."""


class _HostedStep:
    """One kernel's hosted TPE step (one proposal, uniforms from the seed's
    generator) as a CUDA graph, at fixed float32 ``gamma`` and
    ``prior_weight``, which the graph holds as scalars.

    The graph reads static history buffers ``hist`` (``[n_cap, P]`` and
    ``[n_cap]``: the ring that feeds a study is that study's own, so its
    addresses cannot be captured) and draws from ``gen``, registered with
    the graph and seeded before each replay, as device mode's generators
    are: a replay proposes the bits :meth:`_TpeKernel.__call__` proposes
    from the same history and seed.  :meth:`run` holds ``lock`` from the
    copy-in to the clone of the output row, and first makes the caller's
    stream wait for the event recorded after the previous clone, so no
    replay reads buffers that another caller, on another stream, is
    writing."""

    def __init__(self, kern, gamma, prior_weight):
        dev = kern.device
        n, p = kern.n_cap, kern.cs.n_params
        self.kern = kern
        self.gamma = gamma
        self.prior_weight = prior_weight
        self.hist = (torch.zeros((n, p), dtype=torch.float32, device=dev),
                     torch.zeros((n, p), dtype=torch.bool, device=dev),
                     torch.full((n,), math.inf, dtype=torch.float32,
                                device=dev),
                     torch.zeros((n,), dtype=torch.bool, device=dev))
        self.gen = torch.Generator(device=dev)
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()
        self.graph = None
        self.row = None
        self.used = next(_HOSTED_CLOCK)

    def _step(self):
        """The captured body: the kernel's step on the static buffers,
        drawing from ``gen``; the proposed row ``f32[P]``."""
        return self.kern._suggest_one_tel(*self.hist, self.gamma,
                                          self.prior_weight,
                                          generator=self.gen)[0]

    def _capture(self):
        """Run the step once on a side stream, then capture it; the caller
        holds ``lock`` and has filled the static buffers.  Raises
        :class:`_HostedCaptureError` when the capture fails."""
        t0 = perf_counter()
        dev = self.kern.device
        # A prewarm thread uploading a kernel's constants would break the
        # capture.
        wait_prewarm()
        try:
            with torch.cuda.device(dev):
                cur = torch.cuda.current_stream(dev)
                side = torch.cuda.Stream(dev)
                side.wait_stream(cur)
                graph = torch.cuda.CUDAGraph()
                graph.register_generator_state(self.gen)
                with torch.cuda.stream(side):
                    self._step()
                    # Not torch.cuda.graph, which syncs the whole device
                    # first; thread-local, since the service steps other
                    # tenants on other threads meanwhile.
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        row = self._step()
                    finally:
                        graph.capture_end()
                cur.wait_stream(side)
        except RuntimeError as e:
            raise _HostedCaptureError(str(e)) from e
        self.graph, self.row = graph, row
        ms = (perf_counter() - t0) * 1e3
        pool = _pool_bytes(graph)
        _GRAPH_CAPTURES.inc()
        _GRAPH_CAPTURE_MS.inc(ms)
        _GRAPH_POOL_BYTES.set(pool)
        logging.getLogger(__name__).info(
            "captured the hosted TPE step (n_cap=%d) in %.1f ms; its "
            "graph's memory pool holds %d bytes", self.kern.n_cap, ms, pool)

    def run(self, hist, seed):
        """The row ``f32[P]`` proposed for the padded history ``hist``
        (four tensors on the kernel's device) under ``seed``: a fresh
        tensor, queued on the caller's current stream.  The first call
        captures the graph."""
        with self.lock:
            stream = torch.cuda.current_stream(self.kern.device)
            stream.wait_event(self.done)
            for buf, t in zip(self.hist, hist):
                buf.copy_(t)
            if self.graph is None:
                self._capture()
            self.gen.manual_seed(int(seed) % (2 ** 32))
            self.graph.replay()
            row = self.row.clone()
            self.done.record(stream)
        return row

    def retire(self):
        """Wait for the last replay to finish, so that the graph's pool and
        buffers can be freed."""
        self.done.synchronize()


def _takes_graph(kern, dev, n, noise):
    """Whether a hosted step replays its kernel's graph: one proposal on
    CUDA, uniforms from the seed, on a plain :class:`_TpeKernel` (not a
    subclass such as ``dispatch.ShardedTpeKernel``, whose argmax reduces
    over its ranks)."""
    return (dev.type == "cuda" and n == 1 and noise is None
            and type(kern) is _TpeKernel)


def _replay_step(kern, hist, gamma, prior_weight, seed):
    """The hosted step's row from ``kern``'s graph at these ``gamma`` and
    ``prior_weight`` (held by the kernel; at most ``_HOSTED_GRAPH_CAP``
    per space, least recently used out), captured on first use; None when
    the kernel cannot be captured: the caller then runs the step eagerly.
    A failed capture is logged and marks the kernel uncapturable."""
    if kern.uncapturable:
        return None
    key = (float(np.float32(gamma)), float(np.float32(prior_weight)))
    step = kern.hosted.get(key)
    if step is None:
        old = []
        with _KERNELS_LOCK:
            step = kern.hosted.get(key)
            if step is None:
                old = _evict_hosted(kern.cs)
                step = kern.hosted[key] = _HostedStep(kern, *key)
        for evicted in old:
            evicted.retire()
    step.used = next(_HOSTED_CLOCK)
    try:
        with _trace.span("tpe.step.replay"):
            row = step.run(hist, seed)
    except _HostedCaptureError:
        logging.getLogger(__name__).warning(
            "could not capture the hosted TPE step (n_cap=%d); its steps "
            "run eagerly", kern.n_cap, exc_info=True)
        kern.uncapturable = True
        with _KERNELS_LOCK:
            kern.hosted.pop(key, None)
        return None
    _GRAPH_REPLAYS.inc()
    return row


def _evict_hosted(cs):
    """Take the least recently used hosted graphs off the space's kernels
    until one more fits in ``_HOSTED_GRAPH_CAP``, and return them (the
    caller retires them outside the lock).  The caller holds
    ``_KERNELS_LOCK``."""
    held = sorted(((step.used, kern.hosted, key)
                   for kern in cs.__dict__.get("_tpe_kernels", {}).values()
                   for key, step in kern.hosted.items()),
                  key=lambda t: t[0])
    n = len(held) - _HOSTED_GRAPH_CAP + 1
    return [hosted.pop(key) for _, hosted, key in held[:max(n, 0)]]


def _batch_size_for(n):
    """Liar-scan steps for ``n`` proposals: ``n`` rounded up to a power of
    two, so that every batch size in ``(m/2, m]`` runs the same number of
    steps and lands in the same bucket; the surplus proposals are sliced
    off in :func:`_force_rows` (the scan is sequential, so the first ``n``
    rows do not depend on them)."""
    if n <= 1:
        return n
    return 1 << (n - 1).bit_length()


def _inflight_fantasy_rows(h, trials, cs):
    """Constant-liar rows of NEW/RUNNING trials: ``(pv[M, P], pa[M, P],
    lie)`` with ``lie`` the mean observed loss, or None when nothing is in
    flight."""
    infl = getattr(trials, "inflight", None)
    if infl is None:
        return None
    pv, pa = infl(cs)
    if not len(pv):
        return None
    okl = h["loss"][h["ok"]]
    lie = np.float32(okl.mean()) if okl.size else np.float32(0.0)
    return pv, pa, lie


def _with_inflight_fantasies(h, trials, cs):
    """NEW/RUNNING trials enter the history as constant-liar rows at the
    mean observed loss, so a proposal is repelled from points already in
    flight.  No-op when nothing is in flight."""
    fant = _inflight_fantasy_rows(h, trials, cs)
    if fant is None:
        return h
    pv, pa, lie = fant
    return dict(
        vals=np.concatenate([h["vals"], pv]),
        active=np.concatenate([h["active"], pa]),
        loss=np.concatenate([h["loss"], np.full(len(pv), lie, np.float32)]),
        ok=np.concatenate([h["ok"], np.ones(len(pv), bool)]))


def _startup_batch(startup, new_ids, domain, trials, seed):
    """The startup sampler's ``(vals[n, P], active[n, P])``: ``None`` or
    ``"rand"`` random search (device tensors), ``"qmc"``/``"sobol"``/
    ``"halton"`` a low-discrepancy sequence (``qmc.py``, host arrays), a
    module with ``suggest_batch``, or a callable of the same contract."""
    if startup in (None, "rand"):
        return rand.suggest_batch(new_ids, domain, trials, seed)
    if startup in ("qmc", "sobol", "halton"):
        from . import qmc

        eng = "halton" if startup == "halton" else "sobol"
        return qmc.suggest_batch(new_ids, domain, trials, seed, engine=eng)
    if hasattr(startup, "suggest_batch"):
        return startup.suggest_batch(new_ids, domain, trials, seed)
    out = startup(new_ids, domain, trials, seed)
    if not (isinstance(out, tuple) and len(out) == 2):
        raise TypeError(
            "startup callable must return (vals[n, P], active[n, P]), got "
            f"{type(out).__name__}. Pass a module with .suggest_batch (e.g. "
            "startup=qmc) or the string 'qmc', not a doc-returning suggest "
            "function.")
    return out


def suggest(new_ids, domain, trials, seed,
            prior_weight=_default_prior_weight,
            n_startup_jobs=_default_n_startup_jobs,
            n_EI_candidates=_default_n_EI_candidates,
            gamma=_default_gamma,
            linear_forgetting=_default_linear_forgetting,
            split="sqrt", cat_prior="sqrt", ei_impl="vpu",
            ei_precision="f32", ei_topm=0, resident=True,
            multivariate=False, startup=None, comp_sampler="icdf",
            verbose=True):
    """TPE suggest: trial docs for ``new_ids``.  Bind hyperparameters with
    ``functools.partial(tpe.suggest, n_EI_candidates=...)``; the keywords
    are those of :func:`suggest_dispatch`.

    One ``tpe.suggest`` span whose request id is the first new id, over
    the spans of its parts (``obs/trace.py``): ``tpe.history`` (the
    history read from the trials), ``tpe.startup`` (a startup batch and
    its fetch) or ``tpe.acquire`` (the kernel's lookup; ``tpe.kernel_build``
    on a miss), ``tpe.feed`` (the device history), ``tpe.step`` (the
    step's enqueue: ``tpe.step.replay`` where the step replays its
    graph, else ``tpe.step.draw``, ``.split``, ``.groups``, ``.pick``)
    and ``tpe.fetch`` (the wait for the rows); then ``tpe.docs`` (the
    trial documents)."""
    with _trace.span("tpe.suggest", request=new_ids[0] if len(new_ids)
                     else None):
        return suggest_materialize(suggest_dispatch(
            new_ids, domain, trials, seed, prior_weight=prior_weight,
            n_startup_jobs=n_startup_jobs, n_EI_candidates=n_EI_candidates,
            gamma=gamma, linear_forgetting=linear_forgetting, split=split,
            cat_prior=cat_prior, ei_impl=ei_impl, ei_precision=ei_precision,
            ei_topm=ei_topm, resident=resident, multivariate=multivariate,
            startup=startup, comp_sampler=comp_sampler, verbose=verbose))


def suggest_batch(new_ids, domain, trials, seed,
                  prior_weight=_default_prior_weight,
                  n_startup_jobs=_default_n_startup_jobs,
                  n_EI_candidates=_default_n_EI_candidates,
                  gamma=_default_gamma,
                  linear_forgetting=_default_linear_forgetting,
                  split="sqrt", cat_prior="sqrt", ei_impl="vpu",
                  ei_precision="f32", ei_topm=0, resident=True,
                  multivariate=False, startup=None, comp_sampler="icdf",
                  verbose=True):
    """Raw ``(vals[n, P], active[n, P])`` host arrays, without docs."""
    return _force_rows(suggest_dispatch(
        new_ids, domain, trials, seed, prior_weight=prior_weight,
        n_startup_jobs=n_startup_jobs, n_EI_candidates=n_EI_candidates,
        gamma=gamma, linear_forgetting=linear_forgetting, split=split,
        cat_prior=cat_prior, ei_impl=ei_impl, ei_precision=ei_precision,
        ei_topm=ei_topm, resident=resident, multivariate=multivariate,
        startup=startup, comp_sampler=comp_sampler, verbose=verbose))


def suggest_dispatch(new_ids, domain, trials, seed,
                     prior_weight=_default_prior_weight,
                     n_startup_jobs=_default_n_startup_jobs,
                     n_EI_candidates=_default_n_EI_candidates,
                     gamma=_default_gamma,
                     linear_forgetting=_default_linear_forgetting,
                     split="sqrt", cat_prior="sqrt", ei_impl="vpu",
                     ei_precision="f32", ei_topm=0, resident=True,
                     multivariate=False, startup=None, comp_sampler="icdf",
                     verbose=True):
    """Start the suggest computation on the space's device; returns a
    handle for :func:`suggest_materialize`.  The history is read now.

    ``ei_impl`` (``"vpu"``/``"mxu"``), ``ei_precision`` (``"f32"``/
    ``"bf16"``) and ``ei_topm`` pick the EI lowering (:class:`_TpeKernel`);
    ``multivariate=True`` picks the joint winner, ``comp_sampler`` the
    lowering of the JAX package's environment switch (module doc); a bad
    lowering raises ``ValueError`` before anything runs
    (:func:`_lowering`).  ``startup`` picks the sampler of the first
    ``n_startup_jobs`` trials (:func:`_startup_batch`).
    ``resident=False`` pads the history on the host and uploads it whole
    instead of feeding from the resident ring (the same tensors either
    way).  ``n > 1`` new ids past startup run ``m = _batch_size_for(n)``
    constant-liar steps in a bucket with ``m`` rows of slack.  ``verbose``
    is accepted for the reference's signature and does nothing.

    Handle: ``(tag, cs, new_ids, rows, exp_key)`` with ``rows`` a host
    ``(vals, active)`` pair ("ready": empty space or startup) or a
    :class:`_PendingRows` over device rows not yet fetched ("pending":
    ``[P]`` for one proposal, ``[m, P]`` for a batch).

    With a mesh active (``dispatch.active_mesh()``: one registered by
    ``dispatch.set_default_mesh`` or ``parallel.multihost.initialize``, or
    built under ``dispatch.set_mode("sharded")``), the call goes to
    ``dispatch.suggest_dispatch``, whose kernel scores a slice of the
    candidates per rank; the proposals are the same bits."""
    from . import dispatch

    mesh = dispatch.active_mesh()
    if mesh is not None:
        return dispatch.suggest_dispatch(
            new_ids, domain, trials, seed, mesh=mesh,
            prior_weight=prior_weight, n_startup_jobs=n_startup_jobs,
            n_EI_candidates=n_EI_candidates, gamma=gamma,
            linear_forgetting=linear_forgetting, split=split,
            cat_prior=cat_prior, ei_impl=ei_impl, ei_precision=ei_precision,
            ei_topm=ei_topm, resident=resident, multivariate=multivariate,
            startup=startup, comp_sampler=comp_sampler, verbose=verbose)
    lowering = _lowering(split, cat_prior, ei_impl, ei_precision, ei_topm,
                         multivariate, comp_sampler)
    dev = resolve_device(domain.cs.device)
    n_cand, lf = int(n_EI_candidates), int(linear_forgetting)

    def acquire(n_cap):
        return _kernel(domain.cs, n_cap, n_cand, lf, dev, lowering)

    return _dispatch_with(acquire, new_ids, domain, trials, seed,
                          prior_weight, n_startup_jobs, gamma, resident,
                          startup)


def _dispatch_with(acquire, new_ids, domain, trials, seed, prior_weight,
                   n_startup_jobs, gamma, resident, startup, noise=None):
    """The body of :func:`suggest_dispatch` with the kernel from
    ``acquire(n_cap)`` (``dispatch.suggest_dispatch`` passes its own).
    ``noise``: the step's uniforms instead of the seed's generator, a
    :meth:`_TpeKernel.draw_noise` dict for one proposal or a list of one
    per liar step for a batch."""
    cs = domain.cs
    dev = resolve_device(cs.device)
    n = len(new_ids)
    exp_key = getattr(trials, "exp_key", None)
    if n == 0 or cs.n_params == 0:
        return ("ready", cs, list(new_ids),
                (np.zeros((n, cs.n_params), np.float32),
                 np.ones((n, cs.n_params), bool)), exp_key)
    with _trace.span("tpe.history"):
        h = trials.history(cs)
        startup_now = int(h["ok"].sum()) < n_startup_jobs
        if not startup_now:
            if resident:
                # In-flight rows become a copy's slack rows on the device:
                # a host concat would make the ring re-upload every
                # overlapped step.
                fant = _inflight_fantasy_rows(h, trials, cs)
                n_rows = h["vals"].shape[0] + (len(fant[0]) if fant else 0)
            else:
                h = _with_inflight_fantasies(h, trials, cs)
                n_rows = h["vals"].shape[0]
    if startup_now:
        with _trace.span("tpe.startup"):
            v, a = _startup_batch(startup, new_ids, domain, trials, seed)
            if isinstance(v, torch.Tensor):
                # Device draws: fetch the values only, the mask is a host
                # function of them.
                v = v.cpu().numpy()
                a = cs.active_mask_host(v)
        return ("ready", cs, list(new_ids), (np.asarray(v), np.asarray(a)),
                exp_key)
    m = _batch_size_for(n)
    with _trace.span("tpe.acquire"):
        kern = acquire(_bucket(n_rows + (m if n > 1 else 0)))
        # Near the bucket boundary: build the next bucket's kernel off this
        # thread, and (resident) pad-copy the ring to it, so that the call
        # that crosses the boundary pays neither.
        near_edge = n_rows >= 0.75 * kern.n_cap
        if near_edge:
            _prewarm_async(kern, n=m)
    with _trace.span("tpe.feed"):
        if near_edge and resident:
            history.pregrow(trials, cs, kern.n_cap * 2, dev)
        t_feed = perf_counter()
        if resident:
            hist = history.device_history(trials, cs, h, kern.n_cap,
                                          fantasies=fant, device=dev)
        else:
            hist = [torch.as_tensor(a, device=dev)
                    for a in _padded_history(h, kern.n_cap)]
    reg = _metrics_registry()
    t_disp = perf_counter()
    _obs_ms(reg, "suggest.upload_ms", (t_disp - t_feed) * 1e3)
    cold = not kern.stepped
    if cold:
        built_s = ei_build_seconds()
    with _trace.span("tpe.step"):
        rows = None
        # A kernel's first step runs eagerly: it builds or loads the EI
        # library, which must not happen inside a capture.
        if not cold and _takes_graph(kern, dev, n, noise):
            rows = _replay_step(kern, hist, gamma, prior_weight, seed)
            if rows is None:
                _GRAPH_EAGER_STEPS.inc()
        if rows is None:
            gen = (make_generator(dev, int(seed) % (2 ** 32))
                   if noise is None else None)
            if n == 1:
                rows, _ = kern(*hist, gamma, prior_weight, generator=gen,
                               noise=noise)
            else:
                rows, _ = kern.suggest_many(m, n_rows, *hist, gamma,
                                            prior_weight, generator=gen,
                                            noises=noise)
    # Host clocks only: on the card this is the enqueue, not the step.
    dms = (perf_counter() - t_disp) * 1e3
    _obs_ms(reg, "suggest.dispatch_ms", dms)
    _costs.observe_dispatch(kern.cost_key, dms)
    if cold:
        # A kernel's first step, less the EI library's build or load that
        # it may have set off (counted in tpe.kernel_build_ms).
        kern.stepped = True
        reg.counter("tpe.cold_step_ms").inc(
            dms - (ei_build_seconds() - built_s) * 1e3)
    return ("pending", cs, list(new_ids), _PendingRows(rows), exp_key)


class _PendingRows:
    """The device rows of a pending suggest handle and their way to the
    host.

    :meth:`start_transfer` copies them with ``non_blocking=True`` into a
    host buffer from torch's pinned allocator, on the current stream of
    their device (the stream that ran the step, queued after it), and
    records an event after the copy; :meth:`ready` asks that event;
    :meth:`fetch` waits on it and reads the buffer, and falls back to a
    plain ``.cpu()`` only when no transfer was started.  The pinned
    allocator keeps a block until the copies recorded on it have passed,
    so a handle dropped with its copy in flight frees nothing the copy
    still writes.  On the CPU there is nothing to start: the rows are
    always ready."""

    __slots__ = ("rows", "host", "event")

    def __init__(self, rows):
        self.rows = rows
        self.host = None
        self.event = None

    def start_transfer(self):
        if self.event is not None or self.rows.device.type != "cuda":
            return
        host = torch.empty(self.rows.shape, dtype=self.rows.dtype,
                           pin_memory=True)
        host.copy_(self.rows, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.rows.device))
        self.host, self.event = host, event

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def fetch(self):
        """The rows as a numpy array.  The wait (for the event, or for the
        ``.cpu()`` copy) is the suggest step's one device sync, timed into
        ``suggest.fetch_sync_ms``; a ``tpe.fetch`` span."""
        t0 = perf_counter()
        with _trace.span("tpe.fetch"):
            if self.event is not None:
                self.event.synchronize()
                vals = self.host.numpy()
            else:
                vals = self.rows.cpu().numpy()
        _obs_ms(_metrics_registry(), "suggest.fetch_sync_ms",
                (perf_counter() - t0) * 1e3)
        return vals


def _force_rows(handle):
    """A dispatch handle's proposals as host ``(vals[n, P], active[n, P])``;
    a pending handle fetches only the values (one device sync for the
    whole batch), keeps the first ``n`` rows (a batch rounded up to a
    power of two carries surplus ones) and rebuilds the mask on the
    host."""
    tag, cs, new_ids, rows = handle[:4]
    if tag == "pending":
        vals = rows.fetch()
        if vals.ndim == 1:
            vals = vals[None, :]
        vals = vals[:len(new_ids)]
        return vals, cs.active_mask_host(vals)
    return rows


def suggest_materialize(handle):
    """Block on a :func:`suggest_dispatch` handle and package trial docs
    (a ``tpe.docs`` span)."""
    _, cs, new_ids, _rows, exp_key = handle
    vals, active = _force_rows(handle)
    with _trace.span("tpe.docs"):
        return base.docs_from_samples(cs, new_ids, vals, active,
                                      exp_key=exp_key)


def suggest_start_transfer(handle):
    """Start the device→host copy of a pending handle's rows without
    waiting (:meth:`_PendingRows.start_transfer`): the pipelined loop calls
    it right after the dispatch, so that the copy runs behind the step
    while the host evaluates objectives.  A no-op for ready handles and
    on the CPU."""
    if handle[0] == "pending":
        handle[3].start_transfer()
    return handle


def suggest_handle_ready(handle) -> bool:
    """True when :func:`suggest_materialize` will not wait on the device:
    the event after the handle's copy has passed.  Ready handles, CPU
    rows and handles whose transfer was never started report True (their
    materialize may block)."""
    return handle[0] != "pending" or handle[3].ready()


def introspect(domain, trials, seed=0, gamma=_default_gamma,
               linear_forgetting=_default_linear_forgetting):
    """Health-hook diagnostics (``obs/health.py``): the good/bad γ-split
    TPE would compute on the current history, on the host.

    Follows :meth:`_TpeKernel._split`'s default ``'sqrt'`` schedule
    (``n_below = min(ceil(gamma·sqrt(N)), LF, N)``).  The split is
    *degenerate*, the surrogate pair carrying no ranking signal, when the
    below set has fewer than two members or the losses have no spread."""
    h = trials.history(domain.cs)
    ok = np.asarray(h["ok"], bool)
    loss = np.sort(np.asarray(h["loss"], np.float64)[ok])
    n_ok = int(loss.shape[0])
    out = {"backend": "tpe", "n_obs": n_ok, "gamma": float(gamma)}
    if n_ok == 0:
        out["insufficient"] = True
        return out
    n_below = int(np.ceil(gamma * np.sqrt(n_ok)))
    n_below = min(n_below, int(linear_forgetting), n_ok)
    spread = float(loss[-1] - loss[0])
    out.update({
        "n_below": n_below,
        "n_above": n_ok - n_below,
        "loss_spread": spread,
        "below_mean": float(loss[:n_below].mean()) if n_below else None,
        "above_mean": (float(loss[n_below:].mean())
                       if n_ok > n_below else None),
        "split_degenerate": n_below < 2 or spread <= _TINY,
    })
    return out


suggest.dispatch = suggest_dispatch
suggest.materialize = suggest_materialize
suggest.start_transfer = suggest_start_transfer
suggest.handle_ready = suggest_handle_ready
suggest.introspect = introspect


def suggest_quantile(new_ids, domain, trials, seed, **kwargs):
    """TPE with the TPE paper's γ-quantile split (``n_below = ceil(gamma·N)``,
    capped at ``linear_forgetting``) in place of ``gamma·sqrt(N)``; every
    other keyword as :func:`suggest`."""
    kwargs.setdefault("split", "quantile")
    return suggest(new_ids, domain, trials, seed, **kwargs)


def _quantile_dispatch(new_ids, domain, trials, seed, **kwargs):
    kwargs.setdefault("split", "quantile")
    return suggest_dispatch(new_ids, domain, trials, seed, **kwargs)


suggest_quantile.dispatch = _quantile_dispatch
suggest_quantile.materialize = suggest_materialize
suggest_quantile.start_transfer = suggest_start_transfer
suggest_quantile.handle_ready = suggest_handle_ready
suggest_quantile.introspect = introspect


#: The names the backend registry (``backends/contract.py``) resolves
#: through.  The configured variants are keyword-only partials: ``FMinIter``
#: and ``contract.halves_of`` bind their keywords onto the dispatch half,
#: so they keep the pipelined loop.
BACKENDS = {
    "tpe": suggest,
    "tpe_quantile": suggest_quantile,
    "tpe_sobol": partial(suggest, startup="qmc"),
    "tpe_mv": partial(suggest, split="quantile", multivariate=True,
                      n_EI_candidates=128),
}

"""The plain reference of one TPE proposal, in float64.

It follows the semantics the program documents for a factorized TPE step
(``split="sqrt"``, ``cat_prior="sqrt"``, ``comp_sampler="icdf"``, no
multivariate winner), written out here from those semantics with plain
PyTorch operations and no kernel:

1. the γ-split: the ``min(ceil(γ·sqrt(n_ok)), min(lf, n_ok))`` lowest
   losses (float32, ties by trial order) form the below set;
2. per column, linear-forgetting weights by recency rank within each set,
   and an adaptive-Parzen mixture per set: the observations plus a prior
   component, bandwidths from the sorted neighbours, clipped to
   ``[σ_prior / min(n + 2, 100), σ_prior]``;
3. per column, ``n_cand`` draws from the below mixture (truncated to the
   prior's support): the component by inverse CDF on one uniform, the
   value by ``ndtri`` on another;
4. scores: density columns ``log p_below(z) − log p_above(z)``; quantized
   columns the same ratio of bin masses at the lattice point a draw rounds
   to; choices ``log post_below − log post_above`` of the drawn option;
5. per column, the first candidate with the highest score wins.

The uniforms are the random input of a step.  The program draws them from
a ``torch.Generator`` seeded with the suggest seed modulo ``2**32``, on
the device that runs the step: for each column group in the order density,
quantized, then choices, a ``[C, n_cand]`` sheet for the component picks
and another for the values (one sheet for the choices).  The reference
draws the same sheets from its own generator with the same seed, so both
sides score the same candidates; everything after the draw is computed
here in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .space import LOG_KINDS, NORMAL_FAMILY, Q_KINDS

F64 = torch.float64
TINY = 1e-12
U_MAX = float(np.float32(1.0 - 1e-7))
LATTICE_CAP = 4096
# Candidates per block of the density scores: C x block x K float64
# temporaries stay under this many elements.
BLOCK_ELEMS = 1 << 25


class Settings:
    """The TPE settings of a configuration (``configs/<name>.json``)."""

    def __init__(self, tpe: dict, n_cand: int):
        self.gamma = float(tpe["gamma"])
        self.lf = int(tpe["linear_forgetting"])
        self.prior_weight = float(tpe["prior_weight"])
        self.n_startup = int(tpe["n_startup_jobs"])
        self.n_cand = int(n_cand)
        for key, want in (("split", "sqrt"), ("cat_prior", "sqrt"),
                          ("comp_sampler", "icdf")):
            if tpe.get(key, want) != want:
                raise ValueError(f"the reference follows {key}={want!r}, "
                                 f"not {tpe[key]!r}")


def groups(ps):
    """The column groups in the program's draw order: ``(density,
    quantized on a lattice, choices)``, each a list of parameters in
    space order."""
    dens, lat, cat = [], [], []
    for p in ps:
        if p["kind"] == "choice":
            cat.append(p)
        elif p["kind"] in Q_KINDS:
            if p["kind"] in NORMAL_FAMILY or _lattice(p)[1] > LATTICE_CAP:
                raise ValueError(f"{p['label']}: the reference scores "
                                 f"quantized columns on a bounded lattice")
            lat.append(p)
        elif p["kind"] in ("uniform", "loguniform", "normal", "lognormal"):
            dens.append(p)
        else:
            raise ValueError(f"{p['label']}: kind {p['kind']} is not covered")
    return dens, lat, cat


def _lattice(p):
    """``(k0, length)``: the lattice ``k·q``, ``k0 <= k < k0 + length``."""
    if p["kind"] == "uniformint":
        return int(p["low"]), int(p["high"] - p["low"]) + 1
    lo, hi = p["low"], p["high"]
    if p["kind"] == "qloguniform":
        lo, hi = math.exp(lo), math.exp(hi)
    k0 = math.floor(lo / p["q"] + 0.5)
    return k0, math.floor(hi / p["q"] + 0.5) - k0 + 1


def _fit_bounds(p):
    """``(lo, hi, prior_mu, prior_sigma)`` in fit space (log space for log
    kinds)."""
    if p["kind"] in NORMAL_FAMILY:
        return -math.inf, math.inf, p["mu"], p["sigma"]
    lo, hi = p["low"], p["high"]
    if p["kind"] == "uniformint":
        lo, hi = lo - 0.5, hi + 0.5
    return lo, hi, 0.5 * (lo + hi), hi - lo


def split(loss, ok, settings):
    """``(below, above)`` bool masks over the history rows."""
    n_ok = int(ok.sum())
    n_below = min(math.ceil(settings.gamma * math.sqrt(n_ok)),
                  min(settings.lf, n_ok))
    key = np.where(ok, loss.astype(np.float32), np.float32(np.inf))
    order = np.argsort(key, kind="stable")
    below = np.zeros(len(loss), bool)
    below[order[:n_below]] = True
    below &= ok
    return below, ok & ~below


def forgetting(n, lf):
    """Weights of ``n`` observations, oldest first."""
    rank = np.arange(n, dtype=np.float64)
    n_ramp = max(n - lf, 0)
    a = 1.0 / max(n, 1)
    ramp = a + (1.0 - a) * rank / max(n_ramp - 1, 1)
    return np.where(rank < n_ramp, ramp, 1.0)


def parzen(obs, w, prior_mu, prior_sigma, prior_weight):
    """An adaptive-Parzen mixture: ``(log_weights, mus, sigmas)``, float64
    numpy arrays sorted by mean, the prior among them."""
    n = len(obs)
    xs = np.append(np.asarray(obs, np.float64), prior_mu)
    ws = np.append(np.asarray(w, np.float64), prior_weight)
    is_prior = np.arange(n + 1) == n
    order = np.argsort(xs, kind="stable")
    s, sw, sp = xs[order], ws[order], is_prior[order]
    m = n + 1
    left = np.full(m, -np.inf)
    right = np.full(m, -np.inf)
    left[1:] = s[1:] - s[:-1]
    right[:-1] = s[1:] - s[:-1]
    sigma = np.maximum(left, right)
    if n == 1:
        sigma = np.where(sp, sigma, 0.5 * prior_sigma)
    sigma = np.clip(sigma, prior_sigma / min(n + 2.0, 100.0), prior_sigma)
    sigma = np.where(sp, prior_sigma, sigma)
    return np.log(sw / sw.sum()), s, sigma


def _log_ndtr_diff(a, b):
    """``log(Φ(b) − Φ(a))`` for ``a <= b``, stable in both tails."""
    flip = a > 0
    lo = torch.where(flip, -b, a)
    hi = torch.where(flip, -a, b)
    llo = torch.special.log_ndtr(lo)
    lhi = torch.special.log_ndtr(hi)
    d = torch.where(torch.isneginf(llo) & torch.isneginf(lhi),
                    torch.full_like(llo, -math.inf), llo - lhi)
    return lhi + torch.log1p(-torch.exp(torch.clamp_max(d, 0.0)))


class _Mixture:
    """One column's truncated mixture on the device, float64."""

    def __init__(self, fit, lo, hi, dev):
        lw, mu, sg = (torch.as_tensor(a, dtype=F64, device=dev) for a in fit)
        self.lw, self.mu, self.sg = lw, mu, sg
        self.lo, self.hi = lo, hi
        t = torch.as_tensor
        self.log_wmass = lw + _log_ndtr_diff(
            (t(lo, dtype=F64, device=dev) - mu) / sg,
            (t(hi, dtype=F64, device=dev) - mu) / sg)
        self.log_z = torch.logsumexp(self.log_wmass, 0)
        self.cb = lw - torch.log(sg)

    def draw(self, uc, u):
        """Fit-space draws from uniforms ``uc``, ``u`` (``[n]``)."""
        p = torch.exp(self.log_wmass - self.log_z)
        cdf = torch.cumsum(p, 0)
        live = torch.nonzero(self.log_wmass > -math.inf)[-1, 0]
        comp = torch.searchsorted(cdf[:-1].contiguous(),
                                  (uc * cdf[-1]).contiguous(), right=True)
        comp = torch.minimum(comp, live)
        m, s = self.mu[comp], self.sg[comp]
        lo = torch.as_tensor(self.lo, dtype=F64, device=u.device)
        hi = torch.as_tensor(self.hi, dtype=F64, device=u.device)
        pa = torch.special.ndtr((lo - m) / s)
        pb = torch.special.ndtr((hi - m) / s)
        uu = torch.clamp(pa + u * (pb - pa), TINY, U_MAX)
        return torch.special.ndtri(uu) * s + m

    def log_density(self, z):
        """``log Σ_k w_k N(z; μ_k, σ_k)`` up to a constant, at points
        ``z [n]``, in blocks."""
        k = self.mu.shape[0]
        step = max(1, BLOCK_ELEMS // k)
        out = []
        for i in range(0, z.shape[0], step):
            t = (z[i:i + step, None] - self.mu) / self.sg
            out.append(torch.logsumexp(self.cb - 0.5 * t * t, dim=1))
        return torch.cat(out)

    def log_mass(self, zl, zh):
        """Log probability mass of the truncated mixture on bins
        ``[zl, zh]`` (``[n]``)."""
        lo = torch.as_tensor(self.lo, dtype=F64, device=zl.device)
        hi = torch.as_tensor(self.hi, dtype=F64, device=zl.device)
        a = (torch.maximum(zl, lo)[:, None] - self.mu) / self.sg
        b = (torch.minimum(zh, hi)[:, None] - self.mu) / self.sg
        lm = _log_ndtr_diff(a, torch.maximum(a, b))
        return torch.logsumexp(lm + self.lw, dim=1) - self.log_z


class Column:
    """The reference's verdict on one column of one step: ``best`` is the
    highest score over its candidates, ``value`` the winning value, and
    :meth:`score` scores any value the program proposes (``-inf`` for one
    that is no candidate this column could draw)."""

    def __init__(self, p, best, value, score):
        self.param = p
        self.best = float(best)
        self.value = float(value)
        self.score = score


def _sets(h, label, below, above, lf):
    act = h["active"][label]
    out = []
    for mask in (below, above):
        sel = mask & act
        out.append((h["vals"][label][sel].astype(np.float64),
                    forgetting(int(sel.sum()), lf)))
    return out


def _fit_column(p, h, below, above, settings, dev):
    lo, hi, pmu, psg = _fit_bounds(p)
    log = p["kind"] in LOG_KINDS
    mix = []
    for obs, w in _sets(h, p["label"], below, above, settings.lf):
        if log:
            obs = np.log(np.maximum(obs, TINY))
        mix.append(_Mixture(parzen(obs, w, pmu, psg, settings.prior_weight),
                            lo, hi, dev))
    return mix


def _density(p, h, below, above, settings, uc, u, dev):
    mb, ma = _fit_column(p, h, below, above, settings, dev)
    log = p["kind"] in LOG_KINDS
    z = mb.draw(uc, u)
    ei = mb.log_density(z) - ma.log_density(z)
    i = int(torch.argmax(ei))
    best = float(ei[i])
    value = float(torch.exp(z[i]) if log else z[i])

    def score(v):
        if not np.isfinite(v) or (log and v <= 0):
            return -math.inf
        # A proposal's own value: no floor (the floor is the history's).
        zv = math.log(v) if log else float(v)
        if not mb.lo - 1e-6 <= zv <= mb.hi + 1e-6:
            return -math.inf
        zt = torch.tensor([zv], dtype=F64, device=dev)
        return float(mb.log_density(zt) - ma.log_density(zt))

    return Column(p, best, value, score)


def _lattice_column(p, h, below, above, settings, uc, u, dev):
    mb, ma = _fit_column(p, h, below, above, settings, dev)
    log = p["kind"] in LOG_KINDS
    q = p["q"]
    k0, n_lat = _lattice(p)
    clip_lo, clip_hi = ((p["low"], p["high"]) if p["kind"] == "uniformint"
                        else (-math.inf, math.inf))
    z = mb.draw(uc, u)
    x = torch.exp(z) if log else z
    v = torch.clamp(torch.round(x / q) * q, clip_lo, clip_hi)
    pts = (k0 + torch.arange(n_lat, device=dev, dtype=F64)) * q
    el, eh = pts - 0.5 * q, pts + 0.5 * q
    if log:
        zl = torch.where(el > 0, torch.log(torch.clamp_min(el, TINY)),
                         torch.full_like(el, -math.inf))
        zh = torch.log(torch.clamp_min(eh, TINY))
    else:
        zl, zh = el, eh
    table = mb.log_mass(zl, zh) - ma.log_mass(zl, zh)
    idx = torch.clamp(torch.round(v / q).long() - k0, 0, n_lat - 1)
    ei = table[idx]
    i = int(torch.argmax(ei))
    best, value = float(ei[i]), float(v[i])

    def score(val):
        k = val / q
        if not np.isfinite(val) or abs(k - round(k)) > 1e-4:
            return -math.inf
        j = int(round(k)) - k0
        if not 0 <= j < n_lat or not clip_lo <= val <= clip_hi:
            return -math.inf
        return float(table[j])

    return Column(p, best, value, score)


def _cat_column(p, h, below, above, settings, u, dev):
    k = p["n_options"]
    lps = []
    for obs, w in _sets(h, p["label"], below, above, settings.lf):
        counts = np.bincount(np.round(obs).astype(np.int64), weights=w,
                             minlength=k)[:k]
        strength = settings.prior_weight * math.sqrt(1.0 + len(obs))
        pseudo = counts + strength / k
        lps.append(torch.as_tensor(np.log(pseudo / pseudo.sum()), dtype=F64,
                                   device=dev))
    lpb, lpa = lps
    cdf = torch.cumsum(torch.exp(lpb), 0)
    cand = torch.searchsorted(cdf[:-1].contiguous(),
                              (u * cdf[-1]).contiguous(), right=True)
    cand = torch.clamp_max(cand, k - 1)
    diff = lpb - lpa
    ei = diff[cand]
    i = int(torch.argmax(ei))
    best, value = float(ei[i]), float(cand[i])

    def score(val):
        if not np.isfinite(val) or val != round(val) or not 0 <= val < k:
            return -math.inf
        return float(diff[int(val)])

    return Column(p, best, value, score)


def uniforms(ps, seed, n_cand, dev):
    """The step's uniform sheets, drawn as the program draws them (module
    doc): ``{"dens": (uc, u), "lat": (uc, u), "cat": u}`` float64
    ``[C, n_cand]`` tensors (None for an empty group)."""
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (2 ** 32))
    dens, lat, cat = groups(ps)

    def r(c):
        return torch.rand((c, n_cand), generator=g, device=dev,
                          dtype=torch.float32).to(F64)

    out = {}
    for name, grp in (("dens", dens), ("lat", lat)):
        out[name] = (r(len(grp)), r(len(grp))) if grp else None
    out["cat"] = r(len(cat)) if cat else None
    return out


def step(ps, h, seed, settings, dev):
    """The reference's proposal for one step: ``{label: Column}``.

    ``h`` is the history before the step: ``{"vals": {label: f32[N]},
    "active": {label: bool[N]}, "loss": f32[N], "ok": bool[N]}``, rows in
    trial order; ``seed`` the suggest seed; ``dev`` the device whose
    generator the program drew on."""
    if int(h["ok"].sum()) < settings.n_startup:
        raise ValueError("a startup step has no TPE proposal to compare")
    below, above = split(h["loss"], h["ok"], settings)
    dens, lat, cat = groups(ps)
    u = uniforms(ps, seed, settings.n_cand, dev)
    out = {}
    for j, p in enumerate(dens):
        out[p["label"]] = _density(p, h, below, above, settings,
                                   u["dens"][0][j], u["dens"][1][j], dev)
    for j, p in enumerate(lat):
        out[p["label"]] = _lattice_column(p, h, below, above, settings,
                                          u["lat"][0][j], u["lat"][1][j], dev)
    for j, p in enumerate(cat):
        out[p["label"]] = _cat_column(p, h, below, above, settings,
                                      u["cat"][j], dev)
    return out


def live_terms(ps, h, settings):
    """Live (candidate, component) terms the step's density scores need:
    ``n_cand · Σ_c (n_below(c) + 1 + n_above(c) + 1)`` over the density
    columns, each set's active observations plus its prior component."""
    below, above = split(h["loss"], h["ok"], settings)
    dens, _, _ = groups(ps)
    comps = 0
    for p in dens:
        act = h["active"][p["label"]]
        comps += int((below & act).sum()) + int((above & act).sum()) + 2
    return settings.n_cand * comps, len(dens), comps

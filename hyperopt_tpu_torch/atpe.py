"""Adaptive TPE: TPE that tunes its own hyperparameters.

Counterpart of ``hyperopt_tpu/atpe.py`` (reference: ``hyperopt/atpe.py``,
which predicts TPE's hyperparameters with pretrained LightGBM models).
The same capabilities, self-contained and inspectable:

* **portfolio bandit** — arms of TPE configurations spanning what the
  reference's models predict (γ and its schedule, ``n_EI_candidates``,
  ``prior_weight``, ``linear_forgetting`` as the age filter, the joint
  step), scaled by the space's features.  Each call picks an arm by
  Thompson sampling over its record of improvements (a Beta posterior per
  arm); the reward is "the suggested trial beat the best loss".
* **per-parameter lockout** (reference: secondary locking) — lockout arms
  freeze the least important parameters at the incumbent's values.
  Importance is the bias-adjusted between-group variance ratio (η²) of
  the loss (:func:`parameter_importance`).
* **transfer memory** — arm posteriors persist in a JSON file keyed by the
  space's structural fingerprint; an unseen space borrows from the most
  similar space on record (:func:`_space_features`).  The JAX package's
  environment switches are a setter here: :func:`set_transfer_store`
  (a path, e.g. a file the JAX package wrote, or None to turn it off);
  the default file is ``~/.cache/hyperopt_tpu_torch/atpe_transfer.json``.
* ``extra_algos`` adds whole heads (``"gp"``, ``"es"``, any registry name)
  as arms.

The arms' TPE steps are ``tpe.suggest_batch`` on the space's device (the
EI kernel runs once per TPE-arm pick past startup); the bandit, the
lockout and the store are host code.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading

import numpy as np

from . import base, tpe
from .base import JOB_STATE_DONE, JOB_STATE_ERROR, STATUS_OK
from .obs import metrics as _metrics
from .obs.events import EVENTS
from .space import CATEGORICAL, RANDINT, UNIFORMINT, resolve_device

logger = logging.getLogger(__name__)

#: Where the transfer memory lives: a file path (``~`` expanded at use),
#: or None for no memory.  :func:`set_transfer_store` sets it.
_transfer_path = os.path.join("~", ".cache", "hyperopt_tpu_torch",
                              "atpe_transfer.json")


def set_transfer_store(path):
    """Point ATPE's transfer memory at the JSON file ``path`` (the JAX
    package's format: a file it wrote loads as is), or turn the memory off
    with None.  Returns the previous setting.  Experiments whose bandit
    state already exists keep their store."""
    global _transfer_path
    old = _transfer_path
    _transfer_path = None if path is None else os.fspath(path)
    return old


def _tier(n: int) -> int:
    """A candidate count snapped UP to the next power of two (min 32)."""
    return max(32, 1 << (max(int(n), 1) - 1).bit_length())


def _portfolio(cs, tiers=True):
    """TPE-configuration arms, scaled by the space's features.

    ``tiers`` snaps every arm's ``n_EI_candidates`` up to a power of two
    (:func:`_tier`), so that spaces of similar width share kernel shapes;
    False keeps the continuous ``24·√P``."""
    n_params = max(cs.n_params, 1)
    cat_frac = (sum(1 for p in cs.params if p.kind == CATEGORICAL)
                / n_params)
    # Wider spaces get more EI candidates; categorical ones stronger
    # priors.
    base_cand = int(np.clip(24 * np.sqrt(n_params), 24, 512))
    if tiers:
        base_cand = _tier(base_cand)
    pw = 1.0 + cat_frac
    arms = [
        dict(gamma=0.25, split="sqrt", n_EI_candidates=base_cand,
             prior_weight=pw),
        dict(gamma=0.25, split="quantile", n_EI_candidates=base_cand,
             prior_weight=pw),
        dict(gamma=0.15, split="quantile", n_EI_candidates=base_cand * 2,
             prior_weight=pw),
        dict(gamma=0.5, split="sqrt", n_EI_candidates=base_cand,
             prior_weight=2.0 * pw),   # exploratory arm
        # Age filter: a short forgetting horizon fits recent trials only.
        dict(gamma=0.25, split="quantile", n_EI_candidates=base_cand,
             prior_weight=pw, linear_forgetting=10),
        # The joint step; the bandit learns whether it helps.
        dict(gamma=0.25, split="quantile", n_EI_candidates=max(base_cand, 128),
             prior_weight=pw, multivariate=True),
    ]
    if n_params >= 3:  # lockout means nothing on tiny spaces
        arms += [
            # Freeze the low-importance half / three-quarters at the
            # incumbent.
            dict(gamma=0.25, split="quantile", n_EI_candidates=base_cand,
                 prior_weight=pw, lockout=0.5),
            dict(gamma=0.15, split="quantile", n_EI_candidates=base_cand * 2,
                 prior_weight=pw, lockout=0.75),
        ]
    return arms


def parameter_importance(h, cs):
    """Per-parameter importance from the trial history ``h``
    (``trials.history(cs)``): ``imp[P]`` in [0, 1], the bias-adjusted
    between-group variance ratio (η², adjusted like R²) of the loss across
    value groups (discrete columns by value, numeric ones by quantile bin).
    A column with fewer than 8 active observations gets 1.0 (unknown:
    never lock)."""
    ok = h["ok"]
    loss = h["loss"]
    P = cs.n_params
    imp = np.ones(P, np.float64)

    def eta2_adj(y, gid, k, n):
        tot = y.var()
        if tot <= 0 or n <= k:
            return 0.0
        within = sum(float(y[gid == g].var()) * int((gid == g).sum())
                     for g in np.unique(gid)) / n
        # adjusted for the bias of k groups from n samples
        val = 1.0 - (within / max(n - k, 1)) / (tot / (n - 1))
        return float(np.clip(val, 0.0, 1.0))

    for spec in cs.params:
        m = h["active"][:, spec.pid] & ok
        n = int(m.sum())
        if n < 8:
            continue
        x = h["vals"][m, spec.pid].astype(np.float64)
        y = loss[m].astype(np.float64)
        uniq = np.unique(x)
        if spec.kind in (CATEGORICAL, RANDINT, UNIFORMINT) and \
                len(uniq) <= 32:
            gid = np.searchsorted(uniq, x)
            imp[spec.pid] = eta2_adj(y, gid, len(uniq), n)
        else:
            k = int(np.clip(n // 8, 2, 8))
            edges = np.quantile(x, np.linspace(0, 1, k + 1)[1:-1])
            gid = np.searchsorted(edges, x)
            imp[spec.pid] = eta2_adj(y, gid, k, n)
    return imp


def _apply_lockout(cs, rows, acts, trials, h, frac, rng):
    """Freeze the lowest-importance ``frac`` of the parameters the
    incumbent has values for at those values; the activity mask is
    recomputed (a locked choice column may switch branches)."""
    try:
        best_misc = trials.best_trial["misc"]
    except Exception:
        return rows, acts
    imp = parameter_importance(h, cs)
    lockable = []
    for spec in cs.params:
        v = best_misc["vals"].get(spec.label, [])
        if len(v):
            lockable.append((imp[spec.pid], spec.pid, float(v[0])))
    if len(lockable) < 2:
        return rows, acts
    lockable.sort()
    n_lock = int(round(frac * len(lockable)))
    if n_lock == 0:
        return rows, acts
    rows = np.array(rows, copy=True)
    for _, pid, v in lockable[:n_lock]:
        rows[:, pid] = v
    return rows, cs.active_mask_host(rows)


def _space_features(cs) -> list:
    """Structural features of a space for cross-space transfer: its size
    and family mix, not its labels or bounds.  ``log1p(P)/log(101)``, then
    the fractions of uniform-family, log-family, normal-family, quantized,
    categorical and conditional columns, and the mean categorical arity /
    32."""
    from .space import (LOGNORMAL, LOGUNIFORM, NORMAL, QLOGNORMAL,
                        QLOGUNIFORM, QNORMAL, QUNIFORM, UNIFORM)

    P = max(cs.n_params, 1)
    kinds = [p.kind for p in cs.params]

    def frac(ks):
        return sum(1 for k in kinds if k in ks) / P

    cat_arity = [p.n_options for p in cs.params
                 if p.kind == CATEGORICAL or (p.kind == RANDINT
                                              and p.probs is not None)]
    return [
        float(np.log1p(cs.n_params) / np.log(101.0)),
        frac((UNIFORM, QUNIFORM, UNIFORMINT, RANDINT)),
        frac((LOGUNIFORM, QLOGUNIFORM, LOGNORMAL, QLOGNORMAL)),
        frac((NORMAL, QNORMAL, LOGNORMAL, QLOGNORMAL)),
        sum(1 for p in cs.params if p.q) / P,
        frac((CATEGORICAL,)) + sum(
            1 for p in cs.params
            if p.kind == RANDINT and p.probs is not None) / P,
        sum(1 for p in cs.params if p.conditions) / P,
        float(np.mean(cat_arity) / 32.0) if cat_arity else 0.0,
    ]


def _fingerprint(cs) -> str:
    """Structural fingerprint of a compiled space, stable across processes
    and equal to the JAX package's for the same space: a short hash of the
    columns' label, kind, bounds, quantization, probabilities and
    conditions."""
    parts = []
    for p in cs.params:
        parts.append((p.label, p.kind, p.low, p.high, p.mu, p.sigma, p.q,
                      None if p.probs is None else tuple(p.probs),
                      tuple(p.conditions)))
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:24]


class _TransferStore:
    """Arm posteriors across experiments, in one JSON file mapping space
    fingerprints to cumulative arm win/loss counts (and the space's
    :func:`_space_features`).

    A new experiment seeds its posteriors from the stored counts, scaled so
    borrowed evidence never exceeds ``EVIDENCE_CAP`` pseudo-trials.  With
    no record for the fingerprint, the nearest stored space by feature
    distance seeds it when its similarity ``exp(-L1)`` reaches
    ``MIN_NEIGHBOR_SIM``, discounted by ``NEIGHBOR_DISCOUNT * sim``, arm
    counts mapped by index prefix.  Flushes are read-modify-write of
    deltas with an atomic replace."""

    EVIDENCE_CAP = 30.0
    MIN_NEIGHBOR_SIM = 0.5       # exp(-L1 distance) gate for borrowing
    NEIGHBOR_DISCOUNT = 0.5      # neighbour evidence is worth half exact

    def __init__(self, path):
        self.path = path
        self._lock = threading.Lock()

    @staticmethod
    def default():
        """The store :func:`set_transfer_store` names, or None."""
        if _transfer_path is None:
            return None
        return _TransferStore(os.path.expanduser(_transfer_path))

    def _read(self):
        try:
            with open(self.path) as f:
                data = json.load(f)
            return data if isinstance(data, dict) else {}
        except (OSError, ValueError):
            return {}

    @staticmethod
    def _counts(rec, n_arms=None):
        """Validated (wins, losses) float arrays of a record, or None;
        ``n_arms`` asks for that exact length."""
        if not isinstance(rec, dict):
            return None
        w, l = rec.get("wins", ()), rec.get("losses", ())
        if len(w) != len(l) or not len(w):
            return None
        if n_arms is not None and len(w) != n_arms:
            return None
        try:
            w = np.asarray(w, float)
            l = np.asarray(l, float)
        except (TypeError, ValueError):
            return None
        if not np.isfinite(w.sum() + l.sum()):
            return None
        return w, l

    def load(self, fp, n_arms, features=None):
        """Seed posteriors: Beta(1, 1) plus capped stored evidence (exact
        record at the full cap; else, given ``features``, the nearest
        space's at a discounted cap).  A malformed record gives the flat
        prior."""
        data = self._read()
        wins = np.ones(n_arms)
        losses = np.ones(n_arms)
        counts = self._counts(data.get(fp), n_arms)
        cap = self.EVIDENCE_CAP
        reg = _metrics.registry()
        if counts is not None:
            reg.counter("atpe.transfer.exact").inc()
            EVENTS.emit("transfer_borrow", name="exact", fp=fp)
        elif fp in data:
            reg.counter("atpe.transfer.dropped").inc()
            EVENTS.emit("transfer_drop", name="malformed", fp=fp)
        if counts is None and features is not None:
            counts, sim = self._nearest(data, fp, features)
            if counts is not None:
                cap *= self.NEIGHBOR_DISCOUNT * sim
                reg.counter("atpe.transfer.neighbor").inc()
                EVENTS.emit("transfer_borrow", name="neighbor", fp=fp,
                            sim=round(sim, 4))
        if counts is None:
            reg.counter("atpe.transfer.cold").inc()
            return wins, losses
        w, l = counts
        m = min(n_arms, len(w))       # prefix-map an evolved portfolio
        total = float(w[:m].sum() + l[:m].sum())
        if total > 0:
            s = min(1.0, cap / total)
            wins[:m] += s * w[:m]
            losses[:m] += s * l[:m]
        return wins, losses

    def _nearest(self, data, fp, features):
        """The most similar other record by feature distance, or
        ``(None, 0.0)``."""
        feats = np.asarray(features, float)
        best, best_sim = None, 0.0
        for key, rec in data.items():
            if key == fp or not isinstance(rec, dict):
                continue
            f = rec.get("features")
            if not isinstance(f, list) or len(f) != len(feats):
                continue
            counts = self._counts(rec)
            if counts is None:
                continue
            try:
                sim = float(np.exp(-np.abs(np.asarray(f, float)
                                           - feats).sum()))
            except (TypeError, ValueError):
                continue
            if sim > best_sim:
                best, best_sim = counts, sim
        if best is None or best_sim < self.MIN_NEIGHBOR_SIM:
            return None, 0.0
        return best, best_sim

    def flush(self, fp, d_wins, d_losses, n_new_exp=0, features=None):
        """Add this experiment's outcome deltas to the stored record."""
        if not (d_wins.any() or d_losses.any() or n_new_exp):
            return
        with self._lock:
            try:
                data = self._read()
                rec = data.get(fp)
                n = len(d_wins)
                try:
                    if (not isinstance(rec, dict)
                            or len(rec.get("wins", ())) != n
                            or len(rec.get("losses", ())) != n):
                        raise ValueError
                    old_w = np.asarray(rec["wins"], float)
                    old_l = np.asarray(rec["losses"], float)
                    if not np.isfinite(old_w.sum() + old_l.sum()):
                        raise ValueError
                except (TypeError, ValueError):   # schema drift → restart
                    rec = {"n_experiments": 0}
                    old_w = np.zeros(n)
                    old_l = np.zeros(n)
                rec["wins"] = (old_w + d_wins).tolist()
                rec["losses"] = (old_l + d_losses).tolist()
                rec["n_experiments"] = int(rec.get("n_experiments", 0)
                                           + n_new_exp)
                if features is not None:
                    rec["features"] = list(map(float, features))
                data[fp] = rec
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                tmp = f"{self.path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(data, f)
                os.replace(tmp, self.path)
                _metrics.registry().counter("atpe.transfer.flushes").inc()
                EVENTS.emit("store_flush", name="atpe_transfer", fp=fp)
            except OSError:   # unwritable directory: adapt in memory only
                _metrics.registry().counter(
                    "atpe.transfer.flush_failed").inc()
                logger.debug("atpe transfer flush failed", exc_info=True)


class _BanditState:
    """An experiment's Thompson-sampling state, attached to its Trials;
    ``store``/``fp`` wire the transfer memory (seeded from it, settled
    outcomes flushed back as deltas)."""

    # Outcomes kept in memory before a store flush (each flush rewrites
    # the file); an exit hook drains the rest.
    FLUSH_EVERY = 8

    def __init__(self, n_arms, store=None, fp=None, features=None):
        self.store = store
        self.fp = fp
        if store is not None and fp is not None:
            self.wins, self.losses = store.load(fp, n_arms,
                                                features=features)
            store.flush(fp, np.zeros(n_arms), np.zeros(n_arms), n_new_exp=1,
                        features=features)
        else:
            self.wins = np.ones(n_arms)    # Beta(1, 1) priors
            self.losses = np.ones(n_arms)
        self.pending = {}              # tid -> (arm, best_loss_at_suggest)
        self._d_wins = np.zeros(n_arms)     # un-flushed store deltas
        self._d_losses = np.zeros(n_arms)
        if store is not None and fp is not None:
            import atexit
            import weakref

            # A weak reference: a strong one would keep every Trials alive.
            ref = weakref.ref(self)
            atexit.register(lambda: (lambda s: s and s.flush_deltas())(ref()))

    def pick(self, rng):
        return int(np.argmax(rng.beta(self.wins, self.losses)))

    def flush_deltas(self):
        """Drain the accumulated outcome deltas to the store."""
        if self.store is None or self.fp is None:
            return
        d_w, d_l = self._d_wins, self._d_losses
        if not (d_w.any() or d_l.any()):
            return
        self._d_wins = np.zeros(len(self.wins))
        self._d_losses = np.zeros(len(self.losses))
        self.store.flush(self.fp, d_w, d_l)

    def settle(self, trials):
        """Score the resolved suggestions: did the trial beat the best loss
        recorded when it was proposed?"""
        n = len(self.wins)
        d_wins = np.zeros(n)
        d_losses = np.zeros(n)
        by_tid = {t["tid"]: t for t in trials}
        for tid in list(self.pending):
            t = by_tid.get(tid)
            if t is None or t["state"] not in (JOB_STATE_DONE,
                                               JOB_STATE_ERROR):
                continue
            arm, best_then = self.pending.pop(tid)
            r = t["result"]
            loss = r.get("loss") if r.get("status") == STATUS_OK else None
            if loss is not None and (best_then is None or loss < best_then):
                d_wins[arm] += 1.0
            else:
                d_losses[arm] += 1.0
        self.wins += d_wins
        self.losses += d_losses
        self._d_wins += d_wins
        self._d_losses += d_losses
        if self._d_wins.sum() + self._d_losses.sum() >= self.FLUSH_EVERY:
            self.flush_deltas()


def _prewarm_arms(cs, arms, st, n_trials, linear_forgetting):
    """Build every TPE arm's kernel for the current history bucket in a
    daemon thread, once per bucket, so that the bandit's first hop onto an
    arm does not pay its construction (column groups, tables and constants
    uploaded to the device).  ``tpe.wait_prewarm`` joins the thread.
    Best-effort."""
    bucket = tpe._bucket(n_trials)
    if getattr(st, "_prewarmed_bucket", 0) == bucket:
        return None
    st._prewarmed_bucket = bucket
    dev = resolve_device(cs.device)
    shapes = [(int(cfg["n_EI_candidates"]),
               int(cfg.get("linear_forgetting", linear_forgetting)),
               cfg.get("split", "sqrt"), bool(cfg.get("multivariate", False)))
              for cfg in arms if "algo" not in cfg]

    def go():
        for n_cand, lf, split, multivariate in shapes:
            try:
                # Keywords: get_kernel's sixth positional is cat_prior.
                tpe.get_kernel(cs, bucket, n_cand, lf, split=split,
                               multivariate=multivariate, device=dev)
            except Exception:
                logger.debug("atpe arm prewarm failed", exc_info=True)

    t = threading.Thread(target=go, daemon=True,
                         name=f"atpe-prewarm-{bucket}")
    with tpe._KERNELS_LOCK:
        t.start()
        tpe._PREWARMS[:] = [p for p in tpe._PREWARMS if p.is_alive()] + [t]
    return t


def _state(trials, cs, n_arms) -> _BanditState:
    st = getattr(trials, "_atpe_state", None)
    if st is None or len(st.wins) != n_arms:
        store = _TransferStore.default()
        fp = _fingerprint(cs) if store is not None else None
        feats = _space_features(cs) if store is not None else None
        st = trials._atpe_state = _BanditState(n_arms, store=store, fp=fp,
                                               features=feats)
    return st


def suggest(new_ids, domain, trials, seed,
            n_startup_jobs=tpe._default_n_startup_jobs,
            linear_forgetting=tpe._default_linear_forgetting,
            extra_algos=(), tiers=True):
    """Adaptive-TPE suggest (drop-in for ``hyperopt/atpe.py::suggest``).

    ``extra_algos`` adds backend-registry names (``"gp"``, ``"es"``, ...)
    as arms beside the TPE configurations; a delegated arm skips the
    lockout and the prewarm but shares the reward and the transfer memory.
    ``tiers`` as in :func:`_portfolio`."""
    cs = domain.cs
    arms = _portfolio(cs, tiers=tiers)
    arms += [dict(algo=str(name)) for name in extra_algos]
    st = _state(trials, cs, len(arms))
    st.settle(trials)
    rng = np.random.default_rng(int(seed) % (2 ** 32))
    arm = st.pick(rng)
    reg = _metrics.registry()
    reg.counter("atpe.suggest.calls").inc()
    reg.counter(f"atpe.arm.{arm}.picked").inc()
    cfg = dict(arms[arm])
    try:
        best = trials.best_trial["result"]["loss"]
    except Exception:
        best = None
    algo_name = cfg.pop("algo", None)
    if algo_name is not None:
        from .backends import contract as _backends

        docs = _backends.resolve(algo_name)(new_ids, domain, trials,
                                            int(seed))
        for d in docs:
            st.pending[d["tid"]] = (arm, best)
        return docs
    lockout = cfg.pop("lockout", None)
    cfg.setdefault("linear_forgetting", linear_forgetting)
    rows, acts = tpe.suggest_batch(new_ids, domain, trials, seed,
                                   n_startup_jobs=n_startup_jobs, **cfg)
    if best is not None and len(trials) >= n_startup_jobs:
        _prewarm_arms(cs, arms, st, len(trials), linear_forgetting)
    if lockout is not None and best is not None:
        h = trials.history(cs)
        if int(h["ok"].sum()) >= n_startup_jobs:
            rows, acts = _apply_lockout(cs, rows, acts, trials, h,
                                        lockout, rng)
    docs = base.docs_from_samples(cs, new_ids, np.asarray(rows),
                                  np.asarray(acts),
                                  exp_key=getattr(trials, "exp_key", None))
    for d in docs:
        st.pending[d["tid"]] = (arm, best)
    return docs


#: The name the backend registry resolves through.
BACKENDS = {"atpe": suggest}

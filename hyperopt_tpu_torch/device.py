"""Device mode: the suggest→evaluate→record loop on the GPU, one CUDA-graph
replay per trial.

Counterpart of ``hyperopt_tpu/device.py`` for solo runs (``fmin_device``
and the engine behind ``fmin(mode="device", sync_stride=S)``).  The hosted
loop pays ~730 eager kernel launches of the TPE step, a fetch and the
Trials bookkeeping per trial.  When the objective is a torch function, the
whole trial can stay on the card: draw, propose, evaluate, insert the row
into a device-resident history.  Here that trial is captured once as a
CUDA graph and replayed once per trial; the host only reseeds the graph's
generators before each replay and fetches the landed rows once per
``sync_stride`` trials.

**Objective contract.**  ``fn`` takes a flat dict ``{label: 0-d float32
tensor}`` covering every hyperparameter of the space (quantized and
integer kinds as their float values; parameters under an unchosen branch
are present too) and returns a 0-d tensor.  When ``fn`` has a second
positional parameter without a default, it also gets the activity dict
``{label: 0-d bool tensor}``.  On the card the objective runs inside the
capture, so it must be capture-safe: torch ops on those tensors only; no
``.item()``, ``.cpu()``, ``.numpy()``, no Python branching on values (use
``torch.where``), no tensors made from host data.  An objective that
breaks the capture raises :class:`CaptureError`.  On the CPU
(``device="cpu"``) the same step runs eagerly; on CUDA it is captured and
replayed, or it raises: no path runs eagerly on the card.

**The step graph.**  The history stays in one bucket for the whole run,
``n_cap = _bucket(max_evals)``, in static buffers with one spare row past
the bucket.  One graph per (``id(fn)``, bucket, tuning keywords, EI
lowering, device) captures one trial:

1. both arms of the proposal: a startup draw (``CompiledSpace.sample``)
   and a TPE step (``_TpeKernel._suggest_one_tel``, with its EI kernel),
   each from its own ``torch.Generator``, and ``torch.where`` on the
   device count of ok rows picks one (a graph cannot branch; the JAX
   package's ``lax.cond``);
2. the objective on the picked row;
3. the insert at the device index ``i`` (``tpe._insert_row``), ``i += 1``.

Before each replay the host seeds both generators with the trial's seed,
one ``rstate.integers(2**31 - 1)`` per trial as in the hosted loop, so
each arm draws exactly what the hosted ``rand.suggest_batch`` or
``tpe.suggest_dispatch`` draws from that seed.  The stride moves only the
fetch boundary, so the landed trials do not depend on it.  Losses land
with the hosted semantics: a non-finite loss is ``ok=False`` and ``+inf``
in the history, and goes raw into the Trials doc.

Each graph pins a memory pool (:attr:`_Segment.pool_bytes`, logged at
capture); at most
``_RUN_CACHE_CAP`` graphs are kept per space, least recently used first
out.  Before capture the step is run on a side stream (PyTorch's graph
rule), under ``torch.cuda.set_sync_debug_mode("error")``; this also
builds the EI kernels, so ``nvcc`` never runs inside a capture.

Counters (plain ints, like ``ei_scores.launches``): ``fetch_syncs``
(device→host fetches that wait on the card), ``segments``,
``trials_landed``, ``captures``, ``replays``, ``run_cache_hits``,
``run_cache_misses`` and ``eager_steps`` (trials run without a graph:
only on the CPU).  ``ei_scores.launches`` counts the EI kernel's eager
launches (the warm-up steps); a capture adds to ``ei_scores.recorded_by``
instead, and replays pass through neither.

Not in this slice: ``n_runs > 1`` and ``mesh=`` (the fleet slice,
``ROADMAP.md`` Queue 1), the telemetry slab (the obs slice).
"""

from __future__ import annotations

import inspect
import logging
import math
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from .base import JOB_STATE_DONE, STATUS_OK, coarse_utcnow, docs_from_samples
from .exceptions import AllTrialsFailed
from .space import CompiledSpace, compile_space, resolve_device
from .tpe import (
    _bucket,
    _default_gamma,
    _default_linear_forgetting,
    _default_n_EI_candidates,
    _default_n_startup_jobs,
    _default_prior_weight,
    _insert_row,
    get_kernel,
)
from .utils.progress import default_callback, no_progress_callback

logger = logging.getLogger(__name__)

# Captured runs kept per space (LRU): each pins its graph's memory pool
# and the objective it captured.
_RUN_CACHE_CAP = 8
# Eager runs of the step on a side stream before capture.
_WARMUP_STEPS = 2
# fmin_device with patience: replays between two polls of the stop flag,
# and how far the host may run ahead of the oldest poll it has not read
# (replays past the stop land nothing but take the card's time).
_POLL_EVERY = 8
_RUN_AHEAD = 4 * _POLL_EVERY
# "No patience": a count that is never reached.
_NO_PATIENCE = 1 << 62
_NOT_PORTED = ("{what} is not ported yet: it belongs to the fleet slice "
               "(fleet.py / fmin_fleet, ROADMAP.md Queue 1)")
_CONTRACT = (
    "device mode captures the objective inside a CUDA graph of the TPE "
    "step: it takes a dict {label: 0-d float32 tensor} (and the activity "
    "dict when it has a second positional parameter without a default) "
    "and must return a 0-d tensor computed with torch ops on those "
    "tensors only: no .item(), .cpu(), .numpy() or .tolist(), no Python "
    "branching on values (use torch.where), no tensors made from host "
    "data.")

# Guards each space's cache of captured runs.
_CACHE_LOCK = threading.Lock()

fetch_syncs = 0
segments = 0
trials_landed = 0
captures = 0
replays = 0
run_cache_hits = 0
run_cache_misses = 0
eager_steps = 0


def reset_counters():
    """Set every counter of this module to 0."""
    global fetch_syncs, segments, trials_landed, captures, replays
    global run_cache_hits, run_cache_misses, eager_steps
    fetch_syncs = segments = trials_landed = captures = replays = 0
    run_cache_hits = run_cache_misses = eager_steps = 0


class CaptureError(RuntimeError):
    """The TPE step with the objective could not be captured in a CUDA
    graph; the message states the objective contract."""


def _wrap_objective(fn, cs: CompiledSpace):
    """Adapt ``fn`` to ``(row f32[P], act bool[P]) -> f32[]``.

    The activity dict is passed only when ``fn`` declares a second
    positional parameter without a default: ``def obj(p, scale=1.0)`` is a
    one-argument objective with a knob, and feeding the dict into
    ``scale`` would corrupt every loss silently.  The parameters are views
    of a copy of the row, so an objective that updates them in place
    cannot change the proposal that lands."""
    try:
        n_pos = len([p for p in inspect.signature(fn).parameters.values()
                     if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                     and p.default is p.empty])
    except (TypeError, ValueError):   # builtins, callables without one
        n_pos = 1
    labels = [p.label for p in cs.params]

    def eval_one(row, act):
        params = dict(zip(labels, row.clone().unbind(0)))
        if n_pos >= 2:
            out = fn(params, dict(zip(labels, act.clone().unbind(0))))
        else:
            out = fn(params)
        return torch.as_tensor(out, dtype=torch.float32,
                               device=row.device).reshape(())

    return eval_one


class _Segment:
    """One trial of device mode, on static buffers: captured as a CUDA graph
    on the card, run eagerly on the CPU.  Built by :func:`_build_segment`.

    Buffers: the history ``hv, ha, hl, hok`` (``[n_cap + 1, ...]``; the
    TPE step reads the first ``n_cap`` rows, a trial that must not land
    writes the spare last one), the raw losses ``raw``, the row index
    ``i`` and ``limit`` (a trial lands while ``i < limit``), and the
    no-progress state of ``fmin_device`` (``patience``, ``since``,
    ``best``, ``min_improvement``).  :meth:`load` fills them in place, so
    the addresses the graph captured stay valid.  A run holds ``lock``
    from :meth:`load` to its last :meth:`fetch`: runs of one captured step
    from several threads take turns."""

    def __init__(self, cs, kern, eval_one, n_startup, gamma, prior_weight):
        self.cs = cs
        self.kern = kern
        self.eval_one = eval_one
        self.n_startup = int(n_startup)
        self.gamma = float(gamma)
        self.prior_weight = float(prior_weight)
        dev = self.device = kern.device
        self.n_cap = n_cap = kern.n_cap
        p = cs.n_params
        f32, i64 = torch.float32, torch.int64
        self.hv = torch.zeros((n_cap + 1, p), dtype=f32, device=dev)
        self.ha = torch.zeros((n_cap + 1, p), dtype=torch.bool, device=dev)
        self.hl = torch.full((n_cap + 1,), math.inf, dtype=f32, device=dev)
        self.hok = torch.zeros((n_cap + 1,), dtype=torch.bool, device=dev)
        self.raw = torch.full((n_cap + 1,), math.inf, dtype=f32, device=dev)
        self.i = torch.zeros((1,), dtype=i64, device=dev)
        self.limit = torch.zeros((1,), dtype=i64, device=dev)
        self.spare = torch.full((1,), n_cap, dtype=i64, device=dev)
        self.patience = torch.full((1,), _NO_PATIENCE, dtype=i64, device=dev)
        self.since = torch.zeros((1,), dtype=i64, device=dev)
        self.best = torch.full((1,), math.inf, dtype=f32, device=dev)
        self.min_improvement = torch.zeros((1,), dtype=f32, device=dev)
        self.gens = (torch.Generator(device=dev), torch.Generator(device=dev))
        self.lock = threading.Lock()
        self._patience = _NO_PATIENCE
        self.graph = None
        self.pool_bytes = 0
        if dev.type == "cuda":
            self._capture()

    def _step(self, noise=None):
        """One trial, in place on the buffers.  ``noise``: the TPE arm's
        uniforms (``_TpeKernel.draw_noise`` layout) instead of its
        generator's."""
        n = self.n_cap
        hist = (self.hv[:n], self.ha[:n], self.hl[:n], self.hok[:n])
        g_start, g_tpe = self.gens
        n_ok = torch.sum(hist[3])
        sv, sa = self.cs.sample(1, generator=g_start, device=self.device)
        tv, ta, _, _ = self.kern._suggest_one_tel(
            *hist, self.gamma, self.prior_weight, generator=g_tpe,
            noise=noise)
        startup = n_ok < self.n_startup
        row = torch.where(startup, sv[0], tv)
        act = torch.where(startup, sa[0], ta)
        loss = self.eval_one(row, act)
        lok = torch.isfinite(loss)
        live = (self.i < self.limit) & (self.since < self.patience)
        at = torch.where(live, self.i, self.spare)
        _insert_row(self.hv, self.ha, self.hl, self.hok, at, row, act,
                    torch.where(lok, loss, math.inf), lok)
        self.raw.index_copy_(0, at, loss.reshape(1))
        # No-progress count (fmin_device's patience): TPE trials only; a
        # NaN loss neither improves nor moves the best.
        best = self.best
        thresh = torch.where(torch.isfinite(best),
                             best - torch.abs(best) * self.min_improvement,
                             best)
        counted = live & ~startup
        self.since.copy_(torch.where(
            counted, torch.where(loss < thresh, 0, self.since + 1),
            self.since))
        self.best.copy_(torch.where(live & ~torch.isnan(loss),
                                    torch.minimum(best, loss), best))
        self.i.add_(live.to(torch.int64))

    def _capture(self):
        """Warm up on a side stream, then capture :meth:`_step`.  While
        ``limit`` is 0 every write goes to the spare row."""
        global captures
        dev = self.device
        with torch.cuda.device(dev):
            try:
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                mode = torch.cuda.get_sync_debug_mode()
                with torch.cuda.stream(side):
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        for _ in range(_WARMUP_STEPS):
                            self._step()
                    finally:
                        torch.cuda.set_sync_debug_mode(mode)
                torch.cuda.current_stream(dev).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                for g in self.gens:
                    graph.register_generator_state(g)
                with torch.cuda.graph(graph, capture_error_mode="global"):
                    self._step()
            except RuntimeError as e:
                raise CaptureError(f"{_CONTRACT} The capture failed: "
                                   f"{e}") from e
        self.graph = graph
        self.pool_bytes = _pool_bytes(graph)
        captures += 1
        logger.info("device mode: captured the TPE step (n_cap=%d); its "
                    "graph's memory pool holds %d bytes", self.n_cap,
                    self.pool_bytes)

    def load(self, vals, active, loss, ok, raw_loss, limit, patience=None,
             min_improvement=0.0):
        """Set the run's state in place: the first ``len(loss)`` history
        rows (host arrays; ``raw_loss`` what the docs hold), padding
        after them, ``i = len(loss)``, trials land while ``i < limit``;
        ``patience`` (None: never stop) and ``min_improvement`` for the
        no-progress stop, counted from the best ok loss loaded."""
        n, p = len(loss), self.cs.n_params
        if not n <= limit <= self.n_cap:
            raise ValueError(f"limit {limit} must lie in [{n}, {self.n_cap}] "
                             f"(rows loaded, bucket)")
        cap = self.n_cap + 1
        hv = np.zeros((cap, p), np.float32)
        ha = np.zeros((cap, p), bool)
        hl = np.full(cap, np.inf, np.float32)
        hok = np.zeros(cap, bool)
        raw = np.full(cap, np.inf, np.float32)
        hv[:n], ha[:n], hl[:n], hok[:n], raw[:n] = \
            vals, active, loss, ok, raw_loss
        for buf, host in zip((self.hv, self.ha, self.hl, self.hok, self.raw),
                             (hv, ha, hl, hok, raw)):
            buf.copy_(torch.from_numpy(host))
        okl = hl[:n][hok[:n]]
        self._patience = _NO_PATIENCE if patience is None else int(patience)
        self.i.fill_(n)
        self.limit.fill_(int(limit))
        self.patience.fill_(self._patience)
        self.since.fill_(0)
        self.best.fill_(float(okl.min()) if okl.size else math.inf)
        self.min_improvement.fill_(float(min_improvement))

    def run(self, seeds, noises=None):
        """Run one trial per seed from the current index.  ``noises[t]``
        replaces trial ``t``'s TPE uniforms (CPU only: a graph cannot take
        them).  With a patience loaded, stop replaying once the no-progress
        stop is seen.  On the card, every ``_POLL_EVERY`` replays the stop
        count is copied to pinned memory without a sync; a copy is read
        once it has landed, and the host waits on the oldest unread one
        only when it is ``_RUN_AHEAD`` replays ahead of it (the card has
        those queued meanwhile).  Replays past the stop land nothing."""
        global replays, eager_steps
        if noises is not None:
            if self.graph is not None:
                raise ValueError("noises= runs the step eagerly: CPU only")
            if len(noises) != len(seeds):
                raise ValueError(f"{len(noises)} noise dicts for "
                                 f"{len(seeds)} trials")
        polls = deque()
        stop_poll = self._patience != _NO_PATIENCE
        for t, seed in enumerate(seeds):
            s = int(seed) % (2 ** 32)
            for g in self.gens:
                g.manual_seed(s)
            if self.graph is not None:
                self.graph.replay()
                replays += 1
            else:
                self._step(None if noises is None else noises[t])
                eager_steps += 1
            if not stop_poll:
                continue
            if self.graph is None:
                if int(self.since) >= self._patience:
                    return
                continue
            if (t + 1) % _POLL_EVERY == 0:
                since = torch.empty((1,), dtype=torch.int64, pin_memory=True)
                since.copy_(self.since, non_blocking=True)
                landed = torch.cuda.Event()
                landed.record()
                polls.append((since, landed))
            while polls and (polls[0][1].query()
                             or len(polls) * _POLL_EVERY > _RUN_AHEAD):
                since, landed = polls.popleft()
                landed.synchronize()
                if int(since[0]) >= self._patience:
                    return

    def fetch(self, i0, i1):
        """Rows ``[i0, i1)`` and the row index, in ONE device→host copy
        (one fetch sync, the end of a segment): ``(vals f32[s, P], active
        bool[s, P], raw losses f32[s], i)``."""
        global fetch_syncs, segments
        fetch_syncs += 1
        segments += 1
        sl = slice(i0, i1)
        flat = torch.cat([self.hv[sl].reshape(-1),
                          self.ha[sl].reshape(-1).to(torch.float32),
                          self.raw[sl], self.i.to(torch.float32)])
        flat = flat.cpu().numpy()
        s, p = i1 - i0, self.cs.n_params
        vals = flat[:s * p].reshape(s, p)
        active = flat[s * p:2 * s * p].reshape(s, p) > 0.5
        return vals, active, flat[2 * s * p:-1], int(flat[-1])


def _pool_bytes(graph):
    """Bytes of the caching allocator's segments in ``graph``'s private
    memory pool.  (``torch.cuda.memory_reserved`` does not tell it: across
    a capture it can stay put, or drop when a cached graph is evicted.)"""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def _build_segment(cs, kern, eval_one, n_startup, gamma, prior_weight):
    """The per-trial step of device mode for one kernel (bucket, lowering,
    device) and objective: a :class:`_Segment`, captured on CUDA.  Its
    :meth:`_Segment.run` runs a segment of trials, one per seed."""
    return _Segment(cs, kern, eval_one, n_startup, gamma, prior_weight)


def _segment_for(fn, cs, max_evals, device, n_startup_jobs, n_EI_candidates,
                 gamma, prior_weight, linear_forgetting, split, cat_prior,
                 ei_impl, ei_precision, ei_topm):
    """The cached segment for this objective, bucket and tuning, built
    (and captured) on a miss."""
    global run_cache_hits, run_cache_misses
    n_cap = _bucket(max_evals)
    dev = torch.device(device)
    # id(fn) is the only safe key for the objective: closures with the same
    # code capture different values.  The entry holds fn, so the id is not
    # reused while the entry lives.
    key = (id(fn), n_cap, str(dev), int(n_startup_jobs), float(gamma),
           float(prior_weight), int(linear_forgetting),
           int(n_EI_candidates), split, cat_prior, ei_impl, ei_precision,
           int(ei_topm))
    with _CACHE_LOCK:
        cache = cs.__dict__.setdefault("_device_runs", OrderedDict())
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
            run_cache_hits += 1
            return hit[1]
        run_cache_misses += 1
        kern = get_kernel(cs, n_cap, int(n_EI_candidates),
                          int(linear_forgetting), split, cat_prior, dev,
                          ei_impl, ei_precision, int(ei_topm))
        seg = _build_segment(cs, kern, _wrap_objective(fn, cs),
                             n_startup_jobs, gamma, prior_weight)
        cache[key] = (fn, seg)
        while len(cache) > _RUN_CACHE_CAP:
            cache.popitem(last=False)
        return seg


def _seeds(rstate, n):
    """One seed per trial: the hosted loop's draw per suggest call."""
    return [int(rstate.integers(2 ** 31 - 1)) for _ in range(n)]


def fmin_device(fn, space, max_evals, seed=0,
                n_startup_jobs=_default_n_startup_jobs,
                n_EI_candidates=_default_n_EI_candidates,
                gamma=_default_gamma,
                prior_weight=_default_prior_weight,
                linear_forgetting=_default_linear_forgetting,
                split="sqrt", cat_prior="sqrt", ei_impl="vpu",
                ei_precision="f32", ei_topm=0, mesh=None, init=None,
                n_runs=1, patience=None, min_improvement=0.0, device=None):
    """Run ``max_evals`` trials of TPE on the device; see the module doc.

    Returns ``(best, info)``: ``best`` is the ``{label: value}`` dict of the
    best trial's active parameters; ``info`` holds host arrays in trial
    order, ``losses f32[max_evals]``, ``vals f32[max_evals, P]``, ``active
    bool[max_evals, P]``, and ``best_loss``, ``best_index``, ``n_trials``.

    ``seed`` seeds ``np.random.default_rng``, which draws one seed per
    trial as ``fmin`` does, so ``fmin_device(seed=s)`` lands the trials of
    ``fmin(mode="device", rstate=np.random.default_rng(s))``.  ``init``
    resumes from a prior run (a previous ``info``, or any ``{"vals",
    "active", "losses"}`` arrays): those trials seed the history and the
    run continues to ``max_evals`` trials in all; startup draws continue
    until ``n_startup_jobs`` ok trials exist.  ``patience`` stops once
    that many TPE trials in a row fail to improve the best loss by more
    than ``min_improvement`` (relative); trials never run land as ``inf``
    losses with zero rows, and ``info["n_trials"]`` is the index reached
    (resumed trials included).  A non-finite loss is not ok: it does not
    count toward startup and ranks last in the γ-split.

    ``n_runs > 1`` and ``mesh=`` raise ``NotImplementedError`` (the fleet
    slice).  ``device`` defaults to CUDA."""
    if mesh is not None:
        raise NotImplementedError(
            _NOT_PORTED.format(what="fmin_device(mesh=)"))
    if int(n_runs) != 1:
        raise NotImplementedError(
            _NOT_PORTED.format(what="fmin_device(n_runs > 1)"))
    cs = space if isinstance(space, CompiledSpace) else compile_space(space)
    dev = resolve_device(device)
    max_evals = int(max_evals)
    if max_evals < 1:
        raise ValueError("max_evals must be >= 1")
    p = cs.n_params
    if init is not None:
        pv = np.asarray(init["vals"], np.float32)
        pa = np.asarray(init["active"], bool)
        pl = np.asarray(init["losses"], np.float32)
        if pl.ndim != 1:
            raise ValueError(f"init['losses'] must be 1-D (trial order), "
                             f"got {pl.shape}")
        n_prev = pl.shape[0]
        if pv.shape != (n_prev, p) or pa.shape != pv.shape:
            raise ValueError(f"init arrays have inconsistent shapes for this "
                             f"space: vals {pv.shape}, active {pa.shape}, "
                             f"losses {pl.shape}")
        if max_evals <= n_prev:
            raise ValueError(f"max_evals={max_evals} must exceed the "
                             f"{n_prev} trials already in init (max_evals is "
                             f"the total, as in fmin)")
    else:
        n_prev = 0
        pv = np.zeros((0, p), np.float32)
        pa = np.zeros((0, p), bool)
        pl = np.zeros((0,), np.float32)
    if patience is not None and int(patience) < 1:
        raise ValueError(f"patience must be >= 1, got {patience}")
    seg = _segment_for(fn, cs, max_evals, dev, n_startup_jobs,
                       n_EI_candidates, gamma, prior_weight,
                       linear_forgetting, split, cat_prior, ei_impl,
                       ei_precision, ei_topm)
    ok = np.isfinite(pl)
    with seg.lock:
        seg.load(pv, pa, np.where(ok, pl, np.inf), ok, pl, limit=max_evals,
                 patience=patience, min_improvement=min_improvement)
        seg.run(_seeds(np.random.default_rng(seed), max_evals - n_prev))
        vals, active, losses, n_done = seg.fetch(0, max_evals)
    order = np.where(np.isnan(losses), np.inf, losses)
    bi = int(np.argmin(order))
    best = {q.label: cs._param_value(q, vals[bi, q.pid])
            for q in cs.params if active[bi, q.pid]}
    info = {"losses": losses, "vals": vals, "active": active,
            "best_loss": float(losses[bi]), "best_index": bi,
            "n_trials": n_done}
    return best, info


def fmin_trials(fn, space, max_evals, trials, rstate, sync_stride=None,
                early_stop_fn=None, timeout=None, loss_threshold=None,
                show_progressbar=True,
                n_startup_jobs=_default_n_startup_jobs,
                n_EI_candidates=_default_n_EI_candidates,
                gamma=_default_gamma,
                prior_weight=_default_prior_weight,
                linear_forgetting=_default_linear_forgetting,
                split="sqrt", cat_prior="sqrt", ei_impl="vpu",
                ei_precision="f32", ei_topm=0, device=None):
    """Run TPE on the device in segments of ``sync_stride`` trials, landing
    each segment's trials in ``trials`` (the engine of
    ``fmin(mode="device")``); returns ``trials``.

    ``sync_stride=None`` fetches once for the whole run.  Each segment is
    one bulk fetch of its rows, activity masks and losses, counted in
    ``fetch_syncs``; ``early_stop_fn`` is replayed once per landed trial,
    and ``timeout`` and ``loss_threshold`` are checked at the segment's
    end, so a stop lands at the first boundary at or after the trial
    that triggers it.  Completed trials already in ``trials`` seed the
    history (resume).  ``device`` defaults to CUDA."""
    global trials_landed
    t_start = time.time()
    cs = space if isinstance(space, CompiledSpace) else compile_space(space)
    dev = resolve_device(device)
    max_evals = int(max_evals)
    if max_evals < 1:
        raise ValueError("max_evals must be >= 1")
    if sync_stride is not None:
        sync_stride = int(sync_stride)
        if sync_stride < 1:
            raise ValueError(f"sync_stride must be >= 1 or None (∞), got "
                             f"{sync_stride}")
    trials.refresh()
    h = trials.history(cs)
    n_prev = int(h["loss"].shape[0])
    if n_prev >= max_evals:
        return trials
    seg = _segment_for(fn, cs, max_evals, dev, n_startup_jobs,
                       n_EI_candidates, gamma, prior_weight,
                       linear_forgetting, split, cat_prior, ei_impl,
                       ei_precision, ei_topm)
    exp_key = getattr(trials, "exp_key", None)
    early_stop_args: list = []
    i = n_prev
    progress_ctx = default_callback if show_progressbar \
        else no_progress_callback
    with seg.lock, progress_ctx(initial=n_prev, total=max_evals) as prog:
        seg.load(h["vals"], h["active"], h["loss"], h["ok"], h["loss"],
                 limit=max_evals)
        while i < max_evals:
            s = (max_evals - i if sync_stride is None
                 else min(sync_stride, max_evals - i))
            seg.run(_seeds(rstate, s))
            rows, acts, losses, _ = seg.fetch(i, i + s)
            new_ids = trials.new_trial_ids(s)
            docs = docs_from_samples(cs, new_ids, rows, acts,
                                     exp_key=exp_key)
            now = coarse_utcnow()
            for doc, loss in zip(docs, losses):
                doc["state"] = JOB_STATE_DONE
                doc["result"] = {"loss": float(loss), "status": STATUS_OK}
                doc["book_time"] = doc["refresh_time"] = now
            trials.insert_trial_docs(docs)
            trials.refresh()
            trials_landed += s
            i += s
            prog.update(s)
            fin = losses[np.isfinite(losses)]
            if len(fin):
                prog.postfix(float(fin.min()))
            # The hosted loop calls early_stop_fn after every trial, and
            # stateful helpers (no_progress_loss) count calls: replay it
            # once per landed trial.
            if early_stop_fn is not None:
                stop = False
                for _ in range(s):
                    stop, early_stop_args = early_stop_fn(trials,
                                                          *early_stop_args)
                    if stop:
                        break
                if stop:
                    logger.info("early stop triggered (device mode)")
                    break
            if timeout is not None and time.time() - t_start >= timeout:
                break
            if loss_threshold is not None:
                try:
                    if trials.best_trial["result"]["loss"] <= loss_threshold:
                        break
                except AllTrialsFailed:
                    pass
    return trials

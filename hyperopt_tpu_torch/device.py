"""Device mode: the suggest→evaluate→record loop on the GPU, one CUDA-graph
replay per trial.

Counterpart of ``hyperopt_tpu/device.py`` (``fmin_device``, with
``n_runs`` restarts, and the engine behind ``fmin(mode="device",
sync_stride=S)``); ``fleet.py::fmin_fleet`` runs on the same step.  The hosted
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
breaks the capture raises :class:`CaptureError`.  Over lanes it is
called once, under ``torch.func.vmap`` (JAX's ``vmap``), with ``[L]``
parameters.  On the CPU
(``device="cpu"``) the same step runs eagerly; on CUDA it is captured and
replayed, or it raises: no path runs eagerly on the card.

**The step graph.**  The history stays in one bucket for the whole run,
``n_cap = _bucket(max_evals)``, in static buffers with one spare row past
the bucket.  One graph per (``id(fn)``, bucket, tuning keywords, EI
lowering, device, lane count ``L``) captures one trial of each of ``L``
independent runs (the fleet's lanes; ``L = 1`` for a solo run), their
buffers stacked along a leading lane axis:

1. both arms of the proposal: a startup draw (``CompiledSpace.sample``)
   and a TPE step (``_TpeKernel._suggest_lanes``, factorized or joint
   (``multivariate``), with its EI kernel launched once for all lanes, on
   the sampler/split/fit lowering asked for), each lane's uniforms from
   its own pair
   of ``torch.Generator``s, and ``torch.where`` on the device count of
   ok rows picks one per lane (a graph cannot branch; the JAX package's
   ``lax.cond``);
2. the objective on the picked rows;
3. the insert at each lane's device index ``i`` (``tpe._insert_row``),
   ``i += 1``.

Before each replay the host seeds each lane's two generators with that
lane's trial seed (``2L`` ``manual_seed`` calls),
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

**The telemetry slab** (``obs/devtel.py``).  With telemetry armed
(``devtel.enabled()``, read once per run and keyed into the graph cache),
the step also writes two columns, the TPE arm's winning EI score
``ei_best`` (f32) and its candidate-argmax tie count ``ties``, into
``[L, n_cap + 1]`` buffers at the row its trial lands in: two
``index_copy_`` per replay, no other work in the graph.  They ride the
segment's one fetch (:meth:`_Segment.fetch_slab`); the host masks startup
trials and reduces the rest to the JAX package's slab, then backfills it
into events, metrics, costs, health and flight bundles at each boundary.
Armed and disarmed steps run the same proposal ops, so they land the same
trials bit for bit.

Counters (plain ints, like ``ei_scores.launches``): ``fetch_syncs``
(device→host fetches that wait on the card), ``segments``,
``trials_landed``, ``captures``, ``replays``, ``run_cache_hits``,
``run_cache_misses`` and ``eager_steps`` (trials run without a graph:
only on the CPU).  All but ``replays`` and ``eager_steps`` (per trial)
have registry twins (``device.fetch_syncs``, ``device.segments``,
``device.trials_landed``, ``device.captures``, ``device.run_cache.hits``
and ``.misses``), and an armed run adds the ``<mode>.<stride>`` twins of
the first two.  ``ei_scores.launches`` counts the EI kernel's eager
launches (the warm-up steps); a capture adds to ``ei_scores.recorded_by``
instead, and replays pass through neither.

Not in this slice: ``mesh=`` (the dispatch slice, ``ROADMAP.md``
Queue 1).
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
from .obs import costs as _costs
from .obs import devtel as _devtel
from .obs import metrics as _metrics
from .obs.events import EVENTS
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
    stack_noise,
    wait_prewarm,
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
_NOT_PORTED = ("{what} is not ported yet: it belongs to the dispatch "
               "slice (dispatch.py / parallel, ROADMAP.md Queue 1)")
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


# The counters' registry twins (per segment or per run, not per trial).
_TWINS = {"fetch_syncs": "device.fetch_syncs", "segments": "device.segments",
          "trials_landed": "device.trials_landed",
          "captures": "device.captures",
          "run_cache_hits": "device.run_cache.hits",
          "run_cache_misses": "device.run_cache.misses"}


def reset_counters():
    """Set every counter of this module to 0 (the registry twins keep
    counting)."""
    global fetch_syncs, segments, trials_landed, captures, replays
    global run_cache_hits, run_cache_misses, eager_steps
    fetch_syncs = segments = trials_landed = captures = replays = 0
    run_cache_hits = run_cache_misses = eager_steps = 0


def _bump(**deltas):
    """Add to counters of this module and to their registry twins."""
    reg = _metrics.registry()
    counters = globals()
    for name, n in deltas.items():
        counters[name] += n
        reg.counter(_TWINS[name]).inc(n)


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
    """One trial of device mode for ``n_lanes`` independent runs (the
    fleet's lanes; one lane for a solo run), on static buffers: captured as
    one CUDA graph on the card, run eagerly on the CPU.  Built by
    :func:`_build_segment`.

    Buffers, each with a leading lane axis: the history ``hv, ha, hl, hok``
    (``[L, n_cap + 1, ...]``; the TPE step reads the first ``n_cap`` rows,
    a trial that must not land writes its lane's spare last row), the raw
    losses ``raw``, the row index ``i`` and ``limit`` (lane ``j``'s trial
    lands while ``i[j] < limit[j]``), and the no-progress state of
    ``fmin_device`` (``patience``, ``since``, ``best``,
    ``min_improvement``), all ``[L]``.  :meth:`load` fills them in place,
    so the addresses the graph captured stay valid.  Lane ``j`` owns the
    generators ``gens[2j]`` (startup draws) and ``gens[2j + 1]`` (the TPE
    step's uniforms).  With ``telemetry``, the slab's columns ``eib``
    (f32) and ``ties`` (int64), ``[L, n_cap + 1]``, get each trial's TPE
    arm's winning EI score and tie count at its row.  A run holds ``lock``
    from :meth:`load` to its last :meth:`fetch`: runs of one captured step
    from several threads take turns.  ``build_s`` is the wall time of
    building the segment (on the card, its warm-up and capture), and
    ``fresh`` stays True until a run has recorded that build in the cost
    ledger."""

    def __init__(self, cs, kern, eval_one, n_startup, gamma, prior_weight,
                 n_lanes=1, telemetry=False):
        t0 = time.perf_counter()
        self.cs = cs
        self.kern = kern
        self.n_lanes = n_lanes = int(n_lanes)
        kern.check_lanes(n_lanes)
        # The objective over the lanes: one call with [L]-shaped
        # parameters (what JAX's vmap does).
        self.eval_lanes = torch.func.vmap(eval_one)
        self.n_startup = int(n_startup)
        self.gamma = float(gamma)
        self.prior_weight = float(prior_weight)
        dev = self.device = kern.device
        self.n_cap = n_cap = kern.n_cap
        cap, p, lanes = n_cap + 1, cs.n_params, (n_lanes,)
        f32, i64 = torch.float32, torch.int64
        self.hv = torch.zeros((n_lanes, cap, p), dtype=f32, device=dev)
        self.ha = torch.zeros((n_lanes, cap, p), dtype=torch.bool,
                              device=dev)
        self.hl = torch.full((n_lanes, cap), math.inf, dtype=f32, device=dev)
        self.hok = torch.zeros((n_lanes, cap), dtype=torch.bool, device=dev)
        self.raw = torch.full((n_lanes, cap), math.inf, dtype=f32,
                              device=dev)
        # Lane j's rows start at j·cap of the flattened buffers.
        self.base = torch.arange(n_lanes, dtype=i64, device=dev) * cap
        self.i = torch.zeros(lanes, dtype=i64, device=dev)
        self.limit = torch.zeros(lanes, dtype=i64, device=dev)
        self.spare = torch.full(lanes, n_cap, dtype=i64, device=dev)
        self.patience = torch.full(lanes, _NO_PATIENCE, dtype=i64,
                                   device=dev)
        self.since = torch.zeros(lanes, dtype=i64, device=dev)
        self.best = torch.full(lanes, math.inf, dtype=f32, device=dev)
        self.min_improvement = torch.zeros(lanes, dtype=f32, device=dev)
        self.telemetry = bool(telemetry)
        if self.telemetry:
            self.eib = torch.full((n_lanes, cap), -math.inf, dtype=f32,
                                  device=dev)
            self.ties = torch.zeros((n_lanes, cap), dtype=i64, device=dev)
        self.gens = [torch.Generator(device=dev) for _ in range(2 * n_lanes)]
        self.lock = threading.Lock()
        self._patience = _NO_PATIENCE
        self.graph = None
        self.pool_bytes = 0
        if dev.type == "cuda":
            self._capture()
        self.build_s = time.perf_counter() - t0
        self.fresh = True

    def _step(self, noises=None):
        """One trial of every lane, in place on the buffers.  ``noises``:
        the TPE arm's uniforms, one :meth:`_TpeKernel.draw_noise` dict per
        lane, instead of the lanes' generators'."""
        n, lanes = self.n_cap, self.n_lanes
        hist = (self.hv[:, :n], self.ha[:, :n], self.hl[:, :n],
                self.hok[:, :n])
        n_ok = torch.sum(hist[3], dim=-1)
        # Each lane draws what a solo run draws from its own generators;
        # the draws are stacked along the lane axis.
        starts = [self.cs.draw_uniforms(1, self.gens[2 * j], self.device)
                  for j in range(lanes)]
        su = starts[0] if lanes == 1 else {
            k: torch.cat([u[k] for u in starts]) for k in starts[0]}
        sv, sa = self.cs.sample(lanes, noise=su, device=self.device)
        if noises is None:
            noises = [self.kern.draw_noise(self.gens[2 * j + 1])
                      for j in range(lanes)]
        tv, ta, ei_best, ties = self.kern._suggest_lanes(
            *hist, self.gamma, self.prior_weight, noise=stack_noise(noises))
        startup = (n_ok < self.n_startup)[:, None]
        row = torch.where(startup, sv, tv)
        act = torch.where(startup, sa, ta)
        loss = self.eval_lanes(row, act)
        lok = torch.isfinite(loss)
        live = (self.i < self.limit) & (self.since < self.patience)
        at = torch.where(live, self.i, self.spare) + self.base
        flat = [b.view(-1, *b.shape[2:]) for b in
                (self.hv, self.ha, self.hl, self.hok)]
        _insert_row(*flat, at, row, act, torch.where(lok, loss, math.inf),
                    lok)
        self.raw.view(-1).index_copy_(0, at, loss)
        if self.telemetry:
            # The slab's columns: the TPE arm's stats, startup or not (the
            # host masks startup trials).
            self.eib.view(-1).index_copy_(0, at, ei_best)
            self.ties.view(-1).index_copy_(0, at, ties)
        # No-progress count (fmin_device's patience): TPE trials only; a
        # NaN loss neither improves nor moves the best.
        best = self.best
        thresh = torch.where(torch.isfinite(best),
                             best - torch.abs(best) * self.min_improvement,
                             best)
        counted = live & ~startup[:, 0]
        self.since.copy_(torch.where(
            counted, torch.where(loss < thresh, 0, self.since + 1),
            self.since))
        self.best.copy_(torch.where(live & ~torch.isnan(loss),
                                    torch.minimum(best, loss), best))
        self.i.add_(live.to(torch.int64))

    def _capture(self):
        """Warm up on a side stream, then capture :meth:`_step`.  While
        ``limit`` is 0 every write goes to the spare rows."""
        dev = self.device
        # The sampler's constants are uploaded once per device: before the
        # warm-up, whose sync check would take the upload for a round trip.
        self.cs._consts(dev)
        # A kernel being built ahead by a hosted run's bucket prewarm
        # uploads from its own thread: let it finish before the capture.
        wait_prewarm()
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
        _bump(captures=1)
        logger.info("device mode: captured the TPE step (n_cap=%d, %d "
                    "lanes); its graph's memory pool holds %d bytes",
                    self.n_cap, self.n_lanes, self.pool_bytes)

    def load(self, vals, active, loss, ok, raw_loss, limit, patience=None,
             min_improvement=0.0):
        """Set the run's state in place, the same for every lane: the first
        ``len(loss)`` history rows (host arrays; ``raw_loss`` what the docs
        hold), padding after them, ``i = len(loss)``, trials land while
        ``i < limit``; ``patience`` (None: never stop) and
        ``min_improvement`` for the no-progress stop, counted from the best
        ok loss loaded."""
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
            buf.copy_(torch.from_numpy(host).expand_as(buf))
        if self.telemetry:
            self.eib.fill_(-math.inf)
            self.ties.zero_()
        okl = hl[:n][hok[:n]]
        self._patience = _NO_PATIENCE if patience is None else int(patience)
        self.i.fill_(n)
        self.limit.fill_(int(limit))
        self.patience.fill_(self._patience)
        self.since.fill_(0)
        self.best.fill_(float(okl.min()) if okl.size else math.inf)
        self.min_improvement.fill_(float(min_improvement))

    def run(self, seeds, noises=None):
        """Run one trial of every lane per entry of ``seeds`` from the
        current index: ``seeds[t]`` is an int (one lane) or one seed per
        lane.  ``noises[t]`` replaces trial ``t``'s TPE uniforms: a
        :meth:`_TpeKernel.draw_noise` dict (one lane) or a list of one per
        lane (CPU only: a graph cannot take them).  With a patience loaded,
        stop replaying once every lane's no-progress stop is seen.  On the
        card, every ``_POLL_EVERY`` replays the stop counts are copied to
        pinned memory without a sync; a copy is read once it has landed,
        and the host waits on the oldest unread one only when it is
        ``_RUN_AHEAD`` replays ahead of it (the card has those queued
        meanwhile).  Replays past a lane's stop land nothing in it."""
        global replays, eager_steps
        seeds = np.asarray(seeds, np.int64).reshape(-1, self.n_lanes)
        if noises is not None:
            if self.graph is not None:
                raise ValueError("noises= runs the step eagerly: CPU only")
            if len(noises) != len(seeds):
                raise ValueError(f"{len(noises)} noise entries for "
                                 f"{len(seeds)} trials")
            noises = [[nz] if isinstance(nz, dict) else list(nz)
                      for nz in noises]
        polls = deque()
        stop_poll = self._patience != _NO_PATIENCE
        for t, lane_seeds in enumerate(seeds):
            for j, seed in enumerate(lane_seeds):
                s = int(seed) % (2 ** 32)
                self.gens[2 * j].manual_seed(s)
                self.gens[2 * j + 1].manual_seed(s)
            if self.graph is not None:
                self.graph.replay()
                replays += 1
            else:
                self._step(None if noises is None else noises[t])
                eager_steps += 1
            if not stop_poll:
                continue
            if self.graph is None:
                if self._stopped(self.since):
                    return
                continue
            if (t + 1) % _POLL_EVERY == 0:
                since = torch.empty((self.n_lanes,), dtype=torch.int64,
                                    pin_memory=True)
                since.copy_(self.since, non_blocking=True)
                landed = torch.cuda.Event()
                landed.record()
                polls.append((since, landed))
            while polls and (polls[0][1].query()
                             or len(polls) * _POLL_EVERY > _RUN_AHEAD):
                since, landed = polls.popleft()
                landed.synchronize()
                if self._stopped(since):
                    return

    def _stopped(self, since):
        """Whether every lane's no-progress count has reached the
        patience."""
        return bool((since.cpu() >= self._patience).all())

    def fetch(self, i0, i1):
        """Rows ``[i0, i1)`` of every lane and the row indices, in ONE
        device→host copy (one fetch sync, the end of a segment):
        ``(vals f32[L, s, P], active bool[L, s, P], raw losses f32[L, s],
        i int[L])``."""
        return self.fetch_slab(i0, i1)[:4]

    def fetch_slab(self, i0, i1):
        """:meth:`fetch` plus the slab's columns of those rows in the same
        copy: ``(vals, active, raw, i, tel)`` with ``tel = (ei_best
        f32[L, s], ties int64[L, s])``, or None without telemetry.  The
        tie counts cross as float32, exact below 2**24."""
        _bump(fetch_syncs=1, segments=1)
        sl = slice(i0, i1)
        lanes = self.n_lanes
        parts = [self.hv[:, sl].reshape(-1),
                 self.ha[:, sl].reshape(-1).to(torch.float32),
                 self.raw[:, sl].reshape(-1)]
        if self.telemetry:
            parts += [self.eib[:, sl].reshape(-1),
                      self.ties[:, sl].reshape(-1).to(torch.float32)]
        flat = torch.cat(parts + [self.i.to(torch.float32)]).cpu().numpy()
        s, p = i1 - i0, self.cs.n_params
        k, r = lanes * s * p, lanes * s
        vals = flat[:k].reshape(lanes, s, p)
        active = flat[k:2 * k].reshape(lanes, s, p) > 0.5
        raw = flat[2 * k:2 * k + r].reshape(lanes, s)
        tel = None
        if self.telemetry:
            o = 2 * k + r
            tel = (flat[o:o + r].reshape(lanes, s),
                   flat[o + r:o + 2 * r].reshape(lanes, s).astype(np.int64))
        return vals, active, raw, flat[-lanes:].astype(np.int64), tel


def _pool_bytes(graph):
    """Bytes of the caching allocator's segments in ``graph``'s private
    memory pool.  (``torch.cuda.memory_reserved`` does not tell it: across
    a capture it can stay put, or drop when a cached graph is evicted.)"""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def _build_segment(cs, kern, eval_one, n_startup, gamma, prior_weight,
                   n_lanes=1, telemetry=False):
    """The per-trial step of device mode for one kernel (bucket, lowering,
    device), objective, lane count and telemetry switch: a
    :class:`_Segment`, captured on CUDA.  Its :meth:`_Segment.run` runs a
    segment of trials, one per seed (per lane)."""
    return _Segment(cs, kern, eval_one, n_startup, gamma, prior_weight,
                    n_lanes, telemetry)


def _segment_for(fn, cs, max_evals, device, n_startup_jobs, n_EI_candidates,
                 gamma, prior_weight, linear_forgetting, split, cat_prior,
                 ei_impl, ei_precision, ei_topm, n_lanes=1, telemetry=False,
                 multivariate=False, comp_sampler="icdf", split_impl="topk",
                 fused_step=True):
    """The cached segment for this objective, bucket, tuning (the
    lowerings included), lane count and telemetry switch, built (and
    captured) on a miss."""
    n_cap = _bucket(max_evals)
    dev = torch.device(device)
    # id(fn) is the only safe key for the objective: closures with the same
    # code capture different values.  The entry holds fn, so the id is not
    # reused while the entry lives.
    key = (id(fn), n_cap, str(dev), int(n_startup_jobs), float(gamma),
           float(prior_weight), int(linear_forgetting),
           int(n_EI_candidates), split, cat_prior, ei_impl, ei_precision,
           int(ei_topm), int(n_lanes), bool(telemetry), bool(multivariate),
           comp_sampler, split_impl, bool(fused_step))
    with _CACHE_LOCK:
        cache = cs.__dict__.setdefault("_device_runs", OrderedDict())
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
            _bump(run_cache_hits=1)
            return hit[1]
        _bump(run_cache_misses=1)
        EVENTS.emit("compile", name="fmin_device_segment", n_cap=n_cap,
                    n_lanes=int(n_lanes), telemetry=bool(telemetry))
        kern = get_kernel(cs, n_cap, int(n_EI_candidates),
                          int(linear_forgetting), split, cat_prior, dev,
                          ei_impl, ei_precision, int(ei_topm), multivariate,
                          comp_sampler, split_impl, fused_step)
        seg = _build_segment(cs, kern, _wrap_objective(fn, cs),
                             n_startup_jobs, gamma, prior_weight, n_lanes,
                             telemetry)
        cache[key] = (fn, seg)
        while len(cache) > _RUN_CACHE_CAP:
            cache.popitem(last=False)
        return seg


def _seeds(rstate, n):
    """One seed per trial: the hosted loop's draw per suggest call."""
    return [int(rstate.integers(2 ** 31 - 1)) for _ in range(n)]


def _lane_seeds(rstates, n):
    """``[n, L]`` seeds: lane ``j`` draws :func:`_seeds` from
    ``rstates[j]``."""
    return np.asarray([_seeds(r, n) for r in rstates], np.int64).T


def fmin_device(fn, space, max_evals, seed=0,
                n_startup_jobs=_default_n_startup_jobs,
                n_EI_candidates=_default_n_EI_candidates,
                gamma=_default_gamma,
                prior_weight=_default_prior_weight,
                linear_forgetting=_default_linear_forgetting,
                split="sqrt", cat_prior="sqrt", ei_impl="vpu",
                ei_precision="f32", ei_topm=0, mesh=None, init=None,
                n_runs=1, patience=None, min_improvement=0.0, device=None,
                multivariate=False, comp_sampler="icdf", split_impl="topk",
                fused_step=True):
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

    ``n_runs > 1`` runs that many independent restarts as the lanes of one
    captured step (the fleet): run ``j`` is ``fmin_device(seed=seed + j)``
    bit for bit.  ``best``/``best_loss`` are the best over all runs;
    ``info["losses"/"vals"/"active"]`` gain a leading ``[n_runs]`` axis,
    ``best_index`` is ``(run, trial)`` and ``n_trials`` a list.  Patience
    is per run, and the replays stop once every run has stopped.  ``init``
    does not compose with ``n_runs > 1``.

    ``multivariate``, ``comp_sampler``, ``split_impl`` and ``fused_step``
    are ``tpe.suggest``'s.  ``mesh=`` raises ``NotImplementedError`` (the
    dispatch slice).  ``device`` defaults to CUDA."""
    if mesh is not None:
        raise NotImplementedError(
            _NOT_PORTED.format(what="fmin_device(mesh=)"))
    n_runs = int(n_runs)
    if n_runs < 1:
        raise ValueError(f"n_runs must be >= 1, got {n_runs}")
    if init is not None and n_runs > 1:
        raise ValueError("init= resumes one run: it does not compose with "
                         "n_runs > 1")
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
    # The telemetry switch keys the graph, so fmin_device shares the graphs
    # of fmin(mode="device") and fmin_fleet; it reads no slab itself.
    seg = _segment_for(fn, cs, max_evals, dev, n_startup_jobs,
                       n_EI_candidates, gamma, prior_weight,
                       linear_forgetting, split, cat_prior, ei_impl,
                       ei_precision, ei_topm, n_lanes=n_runs,
                       telemetry=_devtel.enabled(), multivariate=multivariate,
                       comp_sampler=comp_sampler, split_impl=split_impl,
                       fused_step=fused_step)
    ok = np.isfinite(pl)
    rstates = [np.random.default_rng(int(seed) + j) for j in range(n_runs)]
    with seg.lock:
        seg.fresh = False
        seg.load(pv, pa, np.where(ok, pl, np.inf), ok, pl, limit=max_evals,
                 patience=patience, min_improvement=min_improvement)
        seg.run(_lane_seeds(rstates, max_evals - n_prev))
        vals, active, losses, n_done = seg.fetch(0, max_evals)
    # NaN-safe best: a non-finite loss loses to any finite one.
    order = np.where(np.isnan(losses), np.inf, losses)
    bi = tuple(int(k) for k in
               np.unravel_index(int(np.argmin(order)), order.shape))
    best = {q.label: cs._param_value(q, vals[bi][q.pid])
            for q in cs.params if active[bi][q.pid]}
    if n_runs == 1:
        info = {"losses": losses[0], "vals": vals[0], "active": active[0],
                "best_loss": float(losses[bi]), "best_index": bi[1],
                "n_trials": int(n_done[0])}
    else:
        info = {"losses": losses, "vals": vals, "active": active,
                "best_loss": float(losses[bi]), "best_index": bi,
                "n_trials": [int(k) for k in n_done]}
    return best, info


def _land(trials, cs, rows, acts, losses):
    """Insert a segment's trials into ``trials`` as DONE docs: the rows, the
    activity masks and the raw losses fetched from the device.  Returns
    their trial ids."""
    new_ids = trials.new_trial_ids(len(losses))
    docs = docs_from_samples(cs, new_ids, rows, acts,
                             exp_key=getattr(trials, "exp_key", None))
    now = coarse_utcnow()
    for doc, loss in zip(docs, losses):
        doc["state"] = JOB_STATE_DONE
        doc["result"] = {"loss": float(loss), "status": STATUS_OK}
        doc["book_time"] = doc["refresh_time"] = now
    trials.insert_trial_docs(docs)
    trials.refresh()
    return new_ids


def fmin_trials(fn, space, max_evals, trials, rstate, sync_stride=None,
                early_stop_fn=None, timeout=None, loss_threshold=None,
                show_progressbar=True,
                n_startup_jobs=_default_n_startup_jobs,
                n_EI_candidates=_default_n_EI_candidates,
                gamma=_default_gamma,
                prior_weight=_default_prior_weight,
                linear_forgetting=_default_linear_forgetting,
                split="sqrt", cat_prior="sqrt", ei_impl="vpu",
                ei_precision="f32", ei_topm=0, device=None,
                multivariate=False, comp_sampler="icdf", split_impl="topk",
                fused_step=True):
    """Run TPE on the device in segments of ``sync_stride`` trials, landing
    each segment's trials in ``trials`` (the engine of
    ``fmin(mode="device")``); returns ``trials``.

    ``sync_stride=None`` fetches once for the whole run.  Each segment is
    one bulk fetch of its rows, activity masks and losses, counted in
    ``fetch_syncs``; ``early_stop_fn`` is replayed once per landed trial,
    and ``timeout`` and ``loss_threshold`` are checked at the segment's
    end, so a stop lands at the first boundary at or after the trial
    that triggers it.  Completed trials already in ``trials`` seed the
    history (resume).  ``device`` defaults to CUDA.

    With telemetry armed (``obs/devtel.py``), each segment's slab rides
    its fetch and is backfilled at the boundary, and the run ends with a
    health verdict under ``device:<exp_key or "solo">``."""
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
    telemetry = _devtel.enabled()
    seg = _segment_for(fn, cs, max_evals, dev, n_startup_jobs,
                       n_EI_candidates, gamma, prior_weight,
                       linear_forgetting, split, cat_prior, ei_impl,
                       ei_precision, ei_topm, telemetry=telemetry,
                       multivariate=multivariate, comp_sampler=comp_sampler,
                       split_impl=split_impl, fused_step=fused_step)
    reg = _metrics.registry()
    exp_key = getattr(trials, "exp_key", None)
    stride_label = "inf" if sync_stride is None else str(sync_stride)
    # The slab's host state: ok trials and best ok loss before a segment.
    okl = h["loss"][h["ok"]]
    n_ok = int(okl.size)
    best = np.float32(okl.min()) if okl.size else np.float32(np.inf)
    early_stop_args: list = []
    i = n_prev
    seg_index = 0
    progress_ctx = default_callback if show_progressbar \
        else no_progress_callback
    with seg.lock, progress_ctx(initial=n_prev, total=max_evals) as prog:
        fresh, seg.fresh = seg.fresh, False
        seg.load(h["vals"], h["active"], h["loss"], h["ok"], h["loss"],
                 limit=max_evals)
        while i < max_evals:
            s = (max_evals - i if sync_stride is None
                 else min(sync_stride, max_evals - i))
            t0 = time.perf_counter()
            seg.run(_seeds(rstate, s))
            (rows,), (acts,), (losses,), _, tel = seg.fetch_slab(i, i + s)
            t1 = time.perf_counter()
            new_ids = _land(trials, cs, rows, acts, losses)
            _bump(trials_landed=s)
            if telemetry:
                slab = _devtel.slab_host(losses[None], *tel, [n_ok], [best],
                                         seg.n_startup)
                n_ok += int(np.isfinite(losses).sum())
                best = slab["best_loss"][0]
                _devtel.bump_labeled(reg, "solo", stride_label)
                cost_key = ("device", "solo", s)
                if fresh:
                    fresh = False
                    _costs.record_compile(
                        "device", cost_key, n_cap=seg.n_cap, P=cs.n_params,
                        m=s, compile_s=seg.build_s,
                        memory_bytes=seg.pool_bytes)
                _devtel.backfill_segment(
                    reg, mode="solo", stride=stride_label, slab_h=slab,
                    n_trials=s, n_lanes=1, t0_mono=t0, t1_mono=t1,
                    seg_index=seg_index, cost_key=cost_key, tids=new_ids,
                    label=exp_key)
            seg_index += 1
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
    if telemetry:
        _devtel.finish_run(reg, trials, mode="solo", label=exp_key)
    return trials

"""Fleet mode: many experiments per dispatch on one GPU.

Counterpart of ``hyperopt_tpu/fleet.py``.  A solo TPE step leaves the card
mostly empty: on the 53-parameter flagship space nearly 1,000 small
kernels over ``[1024, 31]``-sized tensors, where one replay of the
fleet's step for 64 such lanes runs about 1,760 (the benchmark's
``fleet.kernels_per_replay`` in ``flagship50.fleet64``).  The fleet
stacks experiments of one search space along a leading lane axis of
the same step (``tpe._TpeKernel._suggest_lanes``): lanes fold into the
column axis of the ops, so one launch of each kernel serves them all, the
EI kernel included (``31·L`` columns on its ``grid.y``).  Two halves:

* :func:`fmin_fleet`: ``n_lanes`` independent device-mode runs in lockstep,
  one CUDA graph for all lanes (``device._Segment`` with lanes), one
  replay per trial of every lane and ``ceil(max_evals / sync_stride)``
  fetches for the whole fleet.  Lane ``j`` draws its per-trial seeds from
  ``default_rng(seed + j)`` at ``fmin``'s cadence and owns its two
  generators, so it lands what a solo ``fmin(mode="device",
  rstate=default_rng(seed + j))`` lands, bit for bit.
* :class:`CohortScheduler`: the hosted suggests of many experiments in
  one dispatch: requests that share a space's structure
  (:func:`space_signature`), history bucket and batch size form a cohort,
  padded to a power-of-two lane tier (:func:`cohort_tier`), fed by the
  stacked rings of ``history.device_history_batched`` and proposed by
  ``_TpeKernel.suggest_fleet_seeded``; a request that cannot batch
  (startup, an empty space, a singleton, a second request on the same
  trials, custom keywords) takes the solo ``tpe.suggest_dispatch``.  Every
  member gets the bits its solo suggest would give it.

Counters (plain ints, like ``ei_scores.launches``): ``dispatches``
(cohort dispatches), ``suggestions`` (proposals they served),
``cohort_size_last``, ``cohort_tier_last`` and ``padding_waste`` (the
share of padding lanes in the last cohort); their registry twins are
``fleet.dispatches``, ``fleet.suggestions``, the ``fleet.cohort_size``
histogram and the ``fleet.cohort_size_last``, ``fleet.cohort_tier_last``
and ``fleet.padding_waste`` gauges, and each cohort emits a
``fleet_dispatch`` event.  ``fmin_fleet`` carries device mode's telemetry
slab with a lane axis (``obs/devtel.py``): each lane's info gets its slab
reduced over the run, equal bit for bit to its solo run's.  Its host path
has spans of the span store (``obs/trace.py``; they record only while a
profiler or a Tracer with a trace dir records): one ``fleet.segment`` per
segment, holding ``fleet.run`` (the lanes' trial seeds drawn and the
segment's replays enqueued; a replay runs no Python), ``fleet.fetch``
(the segment's one fetch: the wait for the card and the copy, and with a
mesh the all-gather) and ``fleet.land`` (every lane's rows landed into
its ``Trials`` by ``device._land_lanes``, with the cyclic collector held
off across the segment).

Both halves take the TPE step's every keyword, ``multivariate`` and the
sampler/split/fit lowerings included.  Meshes (``dispatch.py``): a cohort
acquires its kernel through ``dispatch.get_kernel`` with the active mesh,
so its lanes score a slice of the candidates per ``sp`` rank;
``fmin_fleet(mesh=)`` splits the lanes over ``mesh["dp"]``.  The
service's cohort gate (``service/server.py::_CohortGate``) dispatches one
cohort per window.
"""

from __future__ import annotations

import threading
import time
import weakref

import numpy as np

from . import base, tpe
from . import device as _device
from . import dispatch as _dispatch
from . import history as _rhist
from .obs import costs as _costs
from .obs import devtel as _devtel
from .obs import trace as _trace
from .obs.events import EVENTS
from .obs.metrics import registry as _registry
from .space import CompiledSpace, compile_space, resolve_device

__all__ = ["CohortScheduler", "fmin_fleet", "fleet_report",
           "space_signature", "cohort_tier", "suggest_materialize",
           "reset_counters"]

dispatches = 0
suggestions = 0
cohort_size_last = 0
cohort_tier_last = 0
padding_waste = 0.0

#: Live schedulers, for :func:`fleet_report`.
_SCHEDULERS: "weakref.WeakSet" = weakref.WeakSet()
#: Lane stacks of running :func:`fmin_fleet` calls, for :func:`fleet_report`.
_LANE_STACKS: "weakref.WeakSet" = weakref.WeakSet()


def reset_counters():
    """Set every counter of this module to 0."""
    global dispatches, suggestions, cohort_size_last, cohort_tier_last
    global padding_waste
    dispatches = suggestions = cohort_size_last = cohort_tier_last = 0
    padding_waste = 0.0


class _LaneStackHandle:
    """Size of one running :func:`fmin_fleet`'s stacked buffers, alive for
    the call (the segment's buffers live on in the run cache)."""

    __slots__ = ("n_lanes", "n_cap", "nbytes", "__weakref__")

    def __init__(self, seg):
        self.n_lanes = seg.n_lanes
        self.n_cap = seg.n_cap
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in (seg.hv, seg.ha, seg.hl, seg.hok, seg.raw))


def fleet_report() -> dict:
    """The fleet's state: per scheduler, each cohort's bucket, batch size,
    lane tier, occupied lanes and resident bytes; and the lane stacks of
    running :func:`fmin_fleet` calls with their bytes."""
    scheds = []
    for s in list(_SCHEDULERS):
        with s._lock:
            cohorts = []
            for (_, n_cap, m, _), st in s._states.items():
                occ = sum(1 for w in st.lanes
                          if w is not None and w() is not None)
                cohorts.append({"n_cap": n_cap, "m": m,
                                "tier": len(st.lanes), "occupied": occ,
                                "resident_bytes": (st.store.nbytes()
                                                   if st.store is not None
                                                   else 0)})
        scheds.append({"cohorts": cohorts, "n_spaces": len(s._rep_cs)})
    stacks = [{"n_lanes": h.n_lanes, "n_cap": h.n_cap, "bytes": h.nbytes}
              for h in list(_LANE_STACKS)]
    return {"n_schedulers": len(scheds), "schedulers": scheds,
            "lane_stacks": stacks,
            "lane_stack_bytes": sum(h["bytes"] for h in stacks)}


def space_signature(cs) -> tuple:
    """Structural fingerprint of a compiled space: every field of its
    parameters that reaches the TPE step (family, bounds, priors, options,
    conditions), labels excluded: two experiments over the same structure
    under other names share a cohort and a kernel.  Cached on the space:
    threads that compute it together all return the first one stored."""
    sig = cs.__dict__.get("_fleet_sig")
    if sig is None:
        sig = cs.__dict__.setdefault("_fleet_sig", tuple(
            (p.pid, p.kind, p.low, p.high, p.mu, p.sigma, p.q,
             tuple(p.probs) if p.probs is not None else None,
             p.n_options, tuple(p.conditions))
            for p in cs.params))
    return sig


def cohort_tier(b: int) -> int:
    """Lane tier for ``b`` cohort members: the next power of two, so that
    cohorts of every size in ``(t/2, t]`` share one shape."""
    if b <= 1:
        return 1
    return 1 << (b - 1).bit_length()


class _CohortResult:
    """The device rows ``[B, m, P]`` of one cohort dispatch, shared by its
    members' handles: the first :func:`suggest_materialize` fetches them
    all (one sync for the cohort), the others read the host copy.  One
    pinned copy and one event serve the whole cohort
    (``tpe._PendingRows``): the first member's ``start_transfer`` starts
    it, the others find it started."""

    __slots__ = ("rows", "_host", "_lock")

    def __init__(self, rows_b):
        self.rows = tpe._PendingRows(rows_b)
        self._host = None
        self._lock = threading.Lock()

    def force(self):
        with self._lock:
            if self._host is None:
                self._host = self.rows.fetch()
                self.rows = None
            return self._host

    def start_transfer(self):
        with self._lock:
            if self._host is None:
                self.rows.start_transfer()

    def ready(self) -> bool:
        with self._lock:
            return self._host is not None or self.rows.ready()


class _CohortState:
    """A cohort's stacked rings and its experiment→lane assignment (a lane
    kept across dispatches keeps its ring's delta appends)."""

    __slots__ = ("store", "lanes")

    def __init__(self):
        self.store = None
        self.lanes: list = []       # lane -> weakref(trials) | None


class _Prep:
    """One planned cohort member: ``tpe.suggest_dispatch``'s decisions for
    the request, up to the device call."""

    __slots__ = ("idx", "new_ids", "cs", "trials", "seed32", "h", "fant",
                 "n_rows", "m", "exp_key")

    def __init__(self, idx, new_ids, cs, trials, seed32, h, fant, n_rows, m,
                 exp_key):
        self.idx = idx
        self.new_ids = new_ids
        self.cs = cs
        self.trials = trials
        self.seed32 = seed32
        self.h = h
        self.fant = fant
        self.n_rows = n_rows
        self.m = m
        self.exp_key = exp_key


class _DomainShim:
    """The domain a planned request goes down the solo path with (it reads
    ``domain.cs`` only)."""

    __slots__ = ("cs",)

    def __init__(self, cs):
        self.cs = cs


class CohortScheduler:
    """Batch concurrent hosted suggest requests into cohort dispatches.

    One scheduler serves one TPE configuration, the keywords of
    ``tpe.suggest`` (``resident=False`` uploads every cohort's rings whole
    instead of keeping them resident; ``startup`` serves the requests
    still in startup, which run solo).  Requests are ``(new_ids, domain,
    trials, seed)`` tuples, or with a fifth element, a dict of TPE keywords
    for that request: when they differ from the scheduler's, the request
    takes the solo path with them.  :meth:`suggest_dispatch` returns one
    handle per request and :func:`suggest_materialize` resolves either
    kind."""

    def __init__(self, prior_weight=tpe._default_prior_weight,
                 n_startup_jobs=tpe._default_n_startup_jobs,
                 n_EI_candidates=tpe._default_n_EI_candidates,
                 gamma=tpe._default_gamma,
                 linear_forgetting=tpe._default_linear_forgetting,
                 split="sqrt", cat_prior="sqrt", ei_impl="vpu",
                 ei_precision="f32", ei_topm=0, resident=True,
                 multivariate=False, startup=None, comp_sampler="icdf",
                 split_impl="topk", fused_step=True):
        tpe._check_ei_args(ei_impl, ei_precision, ei_topm)
        tpe._check_lowerings(comp_sampler, split_impl, fused_step)
        self._kwargs = dict(
            prior_weight=float(prior_weight),
            n_startup_jobs=int(n_startup_jobs),
            n_EI_candidates=int(n_EI_candidates), gamma=float(gamma),
            linear_forgetting=int(linear_forgetting), split=split,
            cat_prior=cat_prior, ei_impl=ei_impl, ei_precision=ei_precision,
            ei_topm=int(ei_topm), resident=bool(resident),
            multivariate=bool(multivariate), startup=startup,
            comp_sampler=comp_sampler, split_impl=split_impl,
            fused_step=bool(fused_step))
        self._lock = threading.Lock()
        self._states: dict = {}      # cohort key -> _CohortState
        self._rep_cs: dict = {}      # space signature -> representative
        _SCHEDULERS.add(self)

    # -- planning ------------------------------------------------------------

    def _plan(self, idx, new_ids, domain, trials, seed):
        """``tpe.suggest_dispatch``'s decisions for one request:
        ``(cohort key, _Prep)``, or None when the request runs solo (no
        ids, an empty space, startup draws)."""
        cs = domain.cs
        n = len(new_ids)
        if n == 0 or cs.n_params == 0:
            return None
        h = trials.history(cs)
        if int(h["ok"].sum()) < self._kwargs["n_startup_jobs"]:
            return None
        fant = tpe._inflight_fantasy_rows(h, trials, cs)
        n_rows = h["vals"].shape[0] + (len(fant[0]) if fant else 0)
        m = tpe._batch_size_for(n)
        n_cap = tpe._bucket(n_rows + (m if n > 1 else 0))
        dev = resolve_device(cs.device)
        key = (space_signature(cs), n_cap, m, str(dev))
        prep = _Prep(idx, list(new_ids), cs, trials, int(seed) % (2 ** 32),
                     h, fant, n_rows, m, getattr(trials, "exp_key", None))
        return key, prep

    def _rep(self, sig, cs):
        """The space a signature's cohorts compile against (the kernel
        cache is per space object).  Caller holds ``self._lock``."""
        return self._rep_cs.setdefault(sig, cs)

    # -- dispatch ------------------------------------------------------------

    def suggest_dispatch(self, requests):
        """Plan and dispatch every request; one handle per request, in
        order.  Cohorts of two or more members share one device call;
        everything else takes ``tpe.suggest_dispatch``."""
        handles = [None] * len(requests)
        groups: dict = {}
        seen: set = set()
        with self._lock:
            for idx, req in enumerate(requests):
                new_ids, domain, trials, seed = req[:4]
                kw = dict(self._kwargs, **(req[4] if len(req) > 4 else {}))
                planned = (self._plan(idx, new_ids, domain, trials, seed)
                           if kw == self._kwargs else None)
                # A second request on the same trials cannot share the
                # first's lane (one lane holds one history): it runs solo,
                # as it would without the scheduler.
                if planned is None or id(trials) in seen:
                    handles[idx] = tpe.suggest_dispatch(
                        new_ids, domain, trials, seed, **kw)
                    continue
                seen.add(id(trials))
                key, prep = planned
                groups.setdefault(key, []).append(prep)
            for key, members in groups.items():
                if len(members) < 2:
                    for prep in members:
                        handles[prep.idx] = tpe.suggest_dispatch(
                            prep.new_ids, _DomainShim(prep.cs), prep.trials,
                            prep.seed32, **self._kwargs)
                    continue
                self._dispatch_cohort(key, members, handles)
        return handles

    def _assign_lanes(self, state, members):
        """Lane of each member: a returning experiment keeps its lane, a
        dead lane frees up, a newcomer takes a free one; the lanes pad up
        to the tier, and a fleet that shrank past a power of two is
        compacted (its store dropped).  Returns ``{lane: _Prep}``."""
        lanes = state.lanes
        live = {}
        for i, w in enumerate(lanes):
            t = w() if w is not None else None
            if t is None:
                lanes[i] = None
            else:
                live[id(t)] = i
        assigned = {live[id(p.trials)]: p for p in members
                    if id(p.trials) in live}
        free = [i for i in range(len(lanes)) if lanes[i] is None]
        for prep in members:
            if id(prep.trials) in live:
                continue
            lane = free.pop(0) if free else len(lanes)
            if lane == len(lanes):
                lanes.append(None)
            lanes[lane] = weakref.ref(prep.trials)
            assigned[lane] = prep
        occupied = sum(1 for w in lanes if w is not None)
        tier = cohort_tier(occupied)
        if tier < cohort_tier(len(lanes)):
            by_trial = {id(p.trials): p for p in members}
            state.lanes = lanes = [w for w in lanes if w is not None]
            state.store = None
            assigned = {}
            for i, w in enumerate(lanes):
                t = w()
                prep = by_trial.get(id(t)) if t is not None else None
                if prep is not None:
                    assigned[i] = prep
        while len(lanes) < tier:
            lanes.append(None)
        return assigned

    def _dispatch_cohort(self, key, members, handles):
        """Caller holds ``self._lock``."""
        global dispatches, suggestions, cohort_size_last, cohort_tier_last
        global padding_waste
        sig, n_cap, m, dev = key
        kw = self._kwargs
        state = self._states.setdefault(key, _CohortState())
        rep = self._rep(sig, members[0].cs)
        # With a mesh active the lanes run against the sharded kernel;
        # non-strict: an indivisible candidate count takes the local one.
        kern = _dispatch.get_kernel(rep, n_cap, kw["n_EI_candidates"],
                                    kw["linear_forgetting"], kw["split"],
                                    kw["cat_prior"], dev, kw["ei_impl"],
                                    kw["ei_precision"], kw["ei_topm"],
                                    kw["multivariate"], kw["comp_sampler"],
                                    kw["split_impl"], kw["fused_step"],
                                    mesh=_dispatch.active_mesh())
        assigned = self._assign_lanes(state, members)
        b = len(state.lanes)
        kern.check_lanes(b)
        lane_hist = [None] * b
        fants = [None] * b
        gens = [0] * b
        seeds = [0] * b
        n_rows = [0] * b
        for i, w in enumerate(state.lanes):
            prep = assigned.get(i)
            if prep is not None:
                lane_hist[i] = prep.h
                fants[i] = prep.fant
                gens[i] = _rhist.generation(prep.trials)
                seeds[i] = prep.seed32
                n_rows[i] = prep.n_rows
            elif w is not None:
                # A live experiment sitting out this dispatch: its rows
                # stay resident, its output lane is ignored.
                lane_hist[i] = _rhist.KEEP
        resident = kw["resident"]
        store, bufs = _rhist.device_history_batched(
            state.store if resident else None, lane_hist, n_cap,
            fantasies=fants, gens=gens, device=dev)
        state.store = store if resident else None
        if resident and max(n_rows) >= 0.75 * n_cap:
            _rhist.pregrow_batched(state.store, n_cap * 2)
        rows_b, _ = kern.suggest_fleet_seeded(
            seeds, m, n_rows, *bufs, kw["gamma"], kw["prior_weight"])
        n_real = len(members)
        n_sugg = sum(len(p.new_ids) for p in members)
        dispatches += 1
        suggestions += n_sugg
        cohort_size_last = n_real
        cohort_tier_last = b
        padding_waste = (b - n_real) / b
        reg = _registry()
        reg.counter("fleet.dispatches").inc()
        reg.counter("fleet.suggestions").inc(n_sugg)
        reg.histogram("fleet.cohort_size").observe(n_real)
        reg.gauge("fleet.cohort_size_last").set(n_real)
        reg.gauge("fleet.cohort_tier_last").set(b)
        reg.gauge("fleet.padding_waste").set(padding_waste)
        EVENTS.emit("fleet_dispatch", name=f"cohort[{n_real}/{b}]",
                    n_cap=n_cap, m=m)
        result = _CohortResult(rows_b)
        for lane, prep in assigned.items():
            handles[prep.idx] = ("fleet", prep.cs, prep.new_ids,
                                 (result, lane), prep.exp_key)

    # -- convenience ---------------------------------------------------------

    def suggest(self, requests):
        """Dispatch and materialize: one list of trial docs per request."""
        return [suggest_materialize(hd)
                for hd in self.suggest_dispatch(requests)]

    def algo(self):
        """A ``tpe.suggest``-style algorithm bound to this scheduler, for
        ``fmin``'s ``algo=``: each call is a one-request batch (a lone loop
        gets exactly ``tpe.suggest``'s proposals; several loops sharing one
        scheduler each plan their own batch).  It carries the four halves
        of ``tpe.suggest`` (``dispatch``, ``materialize``,
        ``start_transfer``, ``handle_ready``), so that the pipelined loop
        (``pipeline.py``) drives cohorts as it drives solo TPE."""

        def _dispatch(new_ids, domain, trials, seed, **kw):
            return self.suggest_dispatch(
                [(new_ids, domain, trials, seed, kw)])[0]

        def _suggest(new_ids, domain, trials, seed, **kw):
            return suggest_materialize(
                _dispatch(new_ids, domain, trials, seed, **kw))

        _suggest.dispatch = _dispatch
        _suggest.materialize = suggest_materialize
        _suggest.start_transfer = suggest_start_transfer
        _suggest.handle_ready = suggest_handle_ready
        return _suggest


def suggest_materialize(handle):
    """Trial docs of a cohort or solo handle.  A cohort member reads the
    shared result (one fetch for the cohort) and rebuilds its activity
    mask on the host with its own space, so labels and ``exp_key`` are
    its own."""
    if handle[0] != "fleet":
        return tpe.suggest_materialize(handle)
    _, cs, new_ids, (result, lane), exp_key = handle
    rows = result.force()[lane][:len(new_ids)]
    return base.docs_from_samples(cs, new_ids, rows, cs.active_mask_host(rows),
                                  exp_key=exp_key)


def suggest_start_transfer(handle):
    """Start the copy of a cohort's rows to the host (once per cohort), or
    a solo handle's (``tpe.suggest_start_transfer``)."""
    if handle[0] != "fleet":
        return tpe.suggest_start_transfer(handle)
    handle[3][0].start_transfer()
    return handle


def suggest_handle_ready(handle) -> bool:
    """True when materializing the handle will not wait on the device."""
    if handle[0] != "fleet":
        return tpe.suggest_handle_ready(handle)
    return handle[3][0].ready()


# -- whole runs in lockstep ---------------------------------------------------


def fmin_fleet(fn, space, n_lanes, max_evals, seed=0, sync_stride=None,
               trials_list=None, mesh=None,
               n_startup_jobs=tpe._default_n_startup_jobs,
               n_EI_candidates=tpe._default_n_EI_candidates,
               gamma=tpe._default_gamma,
               prior_weight=tpe._default_prior_weight,
               linear_forgetting=tpe._default_linear_forgetting,
               split="sqrt", multivariate=False, cat_prior="sqrt",
               ei_impl="vpu", ei_precision="f32", ei_topm=0, device=None,
               comp_sampler="icdf", split_impl="topk", fused_step=True):
    """Run ``n_lanes`` independent device-mode TPE runs in lockstep, from
    empty histories, on one captured step (see the module doc).

    ``fn`` follows device mode's objective contract (``device.py``).  Each
    ``sync_stride``-trial segment (None: the whole run) is one replay per
    trial and ONE fetch for all lanes.  ``trials_list`` (one ``Trials``
    per lane) receives lane ``j``'s trials every segment, landed as
    ``fmin(mode="device")`` lands them.  The lane count must fit the EI
    kernel's column axis (``_TpeKernel.max_lanes``): a ``ValueError`` names
    the most this space takes.  ``device`` defaults to CUDA.

    Returns a list of per-lane ``info`` dicts (``best``, ``best_loss``,
    ``best_index``, ``losses f32[max_evals]``, ``vals``, ``active``) in
    lane order; with telemetry armed, each also holds ``telemetry``, the
    lane's slab over the run (``best_loss``, ``ei_max``, ``ei_mean``,
    ``tpe_steps``, ``nonfinite``, ``argmax_ties``, and the last segment's
    ``best_trajectory``).

    ``mesh`` (a ``dispatch`` mesh; every rank calls with the same
    arguments) splits the lanes over ``mesh["dp"]``, which must divide
    ``n_lanes``: each rank runs its share in its own graph, each segment's
    rows are all-gathered, and every rank lands and returns all lanes."""
    cs = space if isinstance(space, CompiledSpace) else compile_space(space)
    n_lanes = int(n_lanes)
    max_evals = int(max_evals)
    if n_lanes < 1:
        raise ValueError("n_lanes must be >= 1")
    if max_evals < 1:
        raise ValueError("max_evals must be >= 1")
    if trials_list is not None and len(trials_list) != n_lanes:
        raise ValueError(f"trials_list has {len(trials_list)} entries "
                         f"for {n_lanes} lanes")
    if sync_stride is not None:
        sync_stride = int(sync_stride)
        if sync_stride < 1:
            raise ValueError("sync_stride must be >= 1 or None")
    n_dp, r_dp = 1, 0
    if mesh is not None:
        _dispatch._check_axes(mesh)
        n_dp = _dispatch.axis_size(mesh, _dispatch.START_AXIS)
        r_dp = _dispatch.axis_rank(mesh, _dispatch.START_AXIS)
        if n_lanes % n_dp:
            raise ValueError(
                f"n_lanes={n_lanes} not divisible by the {n_dp}-way "
                f"'{_dispatch.START_AXIS}' mesh axis")
    n_local = n_lanes // n_dp
    dev = resolve_device(device)
    telemetry = _devtel.enabled()
    # Lanes split over dp; each lane's step uses the local kernel, so the
    # two partitionings do not fight (the JAX package's rule).
    seg = _device._segment_for(fn, cs, max_evals, dev, n_startup_jobs,
                              n_EI_candidates, gamma, prior_weight,
                              linear_forgetting, split, cat_prior, ei_impl,
                              ei_precision, ei_topm, n_lanes=n_local,
                              telemetry=telemetry, multivariate=multivariate,
                              comp_sampler=comp_sampler,
                              split_impl=split_impl, fused_step=fused_step)
    # Alive for this call: the weak set drops it when the call returns.
    stack = _LaneStackHandle(seg)
    _LANE_STACKS.add(stack)
    rstates = [np.random.default_rng(int(seed) + r_dp * n_local + j)
               for j in range(n_local)]
    p = cs.n_params
    reg = _registry()
    stride_label = "inf" if sync_stride is None else str(sync_stride)
    parts = []
    slabs = []
    with seg.lock:
        fresh, seg.fresh = seg.fresh, False
        seg.load(np.zeros((0, p), np.float32), np.zeros((0, p), bool),
                 np.zeros(0, np.float32), np.zeros(0, bool),
                 np.zeros(0, np.float32), limit=max_evals)
        # The slab's host state per lane: ok trials and best ok loss.
        n_ok = np.zeros(n_lanes, np.int64)
        best = np.full(n_lanes, np.inf, np.float32)
        i = 0
        while i < max_evals:
            s = (max_evals - i if sync_stride is None
                 else min(sync_stride, max_evals - i))
            with _trace.span("fleet.segment"):
                t0 = time.perf_counter()
                with _trace.span("fleet.run"):
                    seg.run(_device._lane_seeds(rstates, s))
                with _trace.span("fleet.fetch"):
                    vals, acts, losses, _, tel = seg.fetch_slab(i, i + s)
                    if n_dp > 1:
                        vals, acts, losses, *tel = _dispatch.gather_lanes(
                            mesh, [vals, acts, losses] + list(tel or ()))
                        tel = tel or None
                t1 = time.perf_counter()
                parts.append((vals, acts, losses))
                if telemetry:
                    slab = _devtel.slab_host(losses, *tel, n_ok, best,
                                             seg.n_startup)
                    slabs.append(slab)
                    n_ok += np.isfinite(losses).sum(axis=1)
                    best = slab["best_loss"]
                    _devtel.bump_labeled(reg, "fleet", stride_label)
                    cost_key = ("device", "fleet", s, n_lanes)
                    if fresh:
                        fresh = False
                        _costs.record_compile(
                            "device", cost_key, n_cap=seg.n_cap, P=p, m=s,
                            tier=n_lanes, compile_s=seg.build_s,
                            memory_bytes=seg.pool_bytes)
                    # Fleet segments backfill the span and the aggregates;
                    # the per-trial anchors are solo mode's (L·s instants
                    # per boundary would swamp the ring).
                    _devtel.backfill_segment(
                        reg, mode="fleet", stride=stride_label, slab_h=slab,
                        n_trials=s, n_lanes=n_lanes, t0_mono=t0, t1_mono=t1,
                        seg_index=len(parts) - 1, cost_key=cost_key)
                if trials_list is not None:
                    with _trace.span("fleet.land"):
                        _device._land_lanes(trials_list, cs, vals, acts,
                                            losses)
                        _device._bump(trials_landed=s * n_lanes)
            i += s
    vals, active, losses = (np.concatenate(a, axis=1) for a in zip(*parts))
    out = []
    for j in range(n_lanes):
        order = np.where(np.isnan(losses[j]), np.inf, losses[j])
        bi = int(np.argmin(order))
        best_j = {q.label: cs._param_value(q, vals[j, bi, q.pid])
                  for q in cs.params if active[j, bi, q.pid]}
        info = {"best": best_j, "best_loss": float(losses[j, bi]),
                "best_index": bi, "losses": losses[j], "vals": vals[j],
                "active": active[j]}
        if slabs:
            info["telemetry"] = _lane_telemetry(slabs, j)
        out.append(info)
    return out


def _lane_telemetry(slabs, j):
    """Lane ``j``'s slab over a run from its segments' slabs: min and max
    for the levels, sums for the counts, the last segment's trajectory
    (it already tracks the run's best-so-far)."""
    n_tpe = sum(int(sl["tpe_steps"][j]) for sl in slabs)
    ei_sum = sum(float(sl["ei_sum"][j]) for sl in slabs)
    return {
        "best_loss": min(float(sl["best_loss"][j]) for sl in slabs),
        "ei_max": max(float(sl["ei_max"][j]) for sl in slabs),
        "ei_mean": (ei_sum / n_tpe) if n_tpe else None,
        "tpe_steps": n_tpe,
        "nonfinite": sum(int(sl["nonfinite"][j]) for sl in slabs),
        "argmax_ties": sum(int(sl["argmax_ties"][j]) for sl in slabs),
        "best_trajectory": slabs[-1]["best_trajectory"][j],
    }

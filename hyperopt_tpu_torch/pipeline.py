"""Depth-D asynchronous suggest/evaluate pipeline: ``fmin``'s overlapped
loop.

Counterpart of ``hyperopt_tpu/pipeline.py``.  A ring of up to D in-flight
suggest dispatch handles feeds a concurrent evaluator stage through a
completion queue.  Stages per batch (one pipeline slot)::

    dispatch ─▶ device step / async copy ─▶ materialize + insert
             ─▶ evaluator workers ─▶ completion queue ─▶ record

* **Dispatch**: ``tpe.suggest_dispatch`` reads the history when it is
  called: real rows plus constant-liar fantasies for every inserted
  NEW/RUNNING trial (``Trials.inflight`` → ``history.device_history``).
  Trial ids are allocated here, so D handles can be in flight before any
  of them is inserted; a handle not yet materialized adds no fantasy rows
  (its proposals are still on the device), the extra staleness a deeper
  pipeline accepts.
* **Non-blocking materialization**: right after the dispatch the executor
  starts the device→host copy (``algo.start_transfer``: a pinned,
  ``non_blocking`` copy on the step's stream with an event after it,
  ``tpe._PendingRows``) and polls ``algo.handle_ready`` (the event) for
  stall attribution, so the fetch overlaps the objective.  Algos without
  those attributes degrade to a blocking materialize.  Handles are opaque
  here: ``fleet.CohortScheduler.algo()`` returns the same four halves over
  cohort handles.
* **Scheduling**: one completion is recorded per loop step; the evaluator
  is fed whenever ``open trials <= feed floor``, so a worker does not
  starve while the host glue (materialize, insert, record, dispatch) runs.
  At ``depth=1, evaluators=1`` the feed floor is 0, which reproduces the
  depth-1 ``overlap_suggest`` loop bit for bit: materialize batch k →
  insert → submit → dispatch batch k+1 → drain batch k → save and early
  stop, with the same ``rstate`` draws.
* **Determinism**: every ``Trials`` mutation happens on the calling
  thread; with one evaluator the completion queue is FIFO in submission
  order, so the recording order, and with it every dispatch's history, is
  a function of the seed.  ``evaluators > 1`` trades that for throughput
  (tids stay unique: allocation and insertion never leave the calling
  thread).  The evaluator threads share the interpreter lock with the
  dispatch (several hundred kernel launches of Python per TPE step): an
  objective that releases it overlaps, a pure-Python one does not.
* **Cancellation**: timeout, early stop and the loss threshold discard
  the un-materialized ring (those tids were never inserted) and cancel
  the evaluator cooperatively: started objectives run to completion and
  record, queued ones are marked ERROR ``("Cancelled", reason)``; no
  trial is left RUNNING.  An objective exception under
  ``catch_eval_exceptions=False`` reverts queued trials to NEW instead,
  the state the serial loop leaves them in, and re-raises after the
  drain.  A dropped handle's copy may still be in flight: its pinned
  buffer goes back to torch's allocator, which reuses it only after the
  copy's event.
* **Recovery**: a failed dispatch or materialize (the ``pipeline.dispatch``
  fault point, a copy that cannot start, a dead handle) is re-dispatched
  for the same tids;
  after ``_FALLBACK_AFTER`` consecutive failures the executor drains and
  hands the rest of the run to ``FMinIter``'s synchronous loop.

Metrics (``obs/metrics.py``): ``pipeline.occupancy`` (gauge and
histogram: handles in flight at each schedule point),
``pipeline.eval_backlog`` (gauge), ``pipeline.stall.suggest_bound`` and
``pipeline.stall.eval_bound`` (counters: the evaluator waited on a handle,
or a handle was ready while the evaluator was saturated),
``pipeline.stall.suggest_bound_ms`` (counter and histogram: time spent
forcing a head that was not ready), ``pipeline.slot.failed``,
``pipeline.redispatch`` and ``pipeline.fallbacks``.  Events: a
``span_begin``/``span_end`` pair per slot (``name="pipeline.slot"``) from
dispatch to materialize, and ``pipeline_dispatch``,
``pipeline_materialize``, ``pipeline_cancel`` and ``pipeline_fallback``.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from time import perf_counter

from . import faults as _faults
from .base import (
    Ctrl,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    coarse_utcnow,
)
from .exceptions import AllTrialsFailed, is_transient
from .obs import context as _context
from .obs import flight as _flight
from .obs import metrics as _metrics
from .obs.events import EVENTS
from .parallel.pool import CompletionQueueEvaluator
from .tpe import _MS_BUCKETS

logger = logging.getLogger(__name__)

#: Consecutive dispatch/materialize slot failures before the executor
#: gives up on the pipelined loop and hands the rest of the run back to
#: FMinIter's synchronous loop (``run`` returns ``"fallback"``).
_FALLBACK_AFTER = 3

#: Bucket bounds in milliseconds of the ``*_ms`` histograms (the
#: ``suggest.*_ms`` series'): 50 µs to ~26 s, two to a bucket.
MS_BUCKETS = _MS_BUCKETS

#: Seconds the drain waits for started evaluations to come back.
_DRAIN_TIMEOUT_S = 30.0


class _Slot:
    """One in-flight dispatch: pre-allocated tids + opaque algo handle."""

    __slots__ = ("ids", "handle", "span")

    def __init__(self, ids, handle, span):
        self.ids = ids
        self.handle = handle
        self.span = span


class _Batch:
    """Recording bookkeeping for one materialized batch."""

    __slots__ = ("pending", "pre")

    def __init__(self, n, pre=False):
        self.pending = n
        self.pre = pre


class PipelinedExecutor:
    """Drives one :class:`~hyperopt_tpu_torch.fmin.FMinIter` through the
    pipelined loop.  Constructed by FMinIter when ``overlap_depth >= 1``
    (or ``overlap_suggest=True``) and the algo is dispatch-capable;
    ``FMinIter._loop`` delegates here instead of ``run_one_batch``.
    ``execution`` ("thread" or "process") is handed to the evaluator,
    :class:`~hyperopt_tpu_torch.parallel.pool.CompletionQueueEvaluator`."""

    def __init__(self, it, depth, evaluators, dispatch, materialize,
                 handle_ready=None, start_transfer=None,
                 execution: str = "thread"):
        self.it = it
        self.depth = max(1, int(depth))
        self.evaluators = max(1, int(evaluators))
        self.execution = execution
        self._dispatch = dispatch
        self._materialize = materialize
        self._handle_ready = handle_ready
        self._start_transfer = start_transfer
        # Sequential-parity mode: feed only when the evaluator is fully
        # drained — the exact cadence of the old overlap_suggest loop.
        self.strict = self.depth == 1 and self.evaluators == 1
        self._ring: deque = deque()
        self._next_tid = None
        self._open = 0
        self._pre_open = 0
        self._seq = 0
        # One eval-bound count per wait episode (reset at each feed).
        self._eval_bound_counted = False
        # Slot-failure recovery: consecutive dispatch/materialize failures
        # (any success resets); at _FALLBACK_AFTER the run falls back to
        # the synchronous loop instead of crashing.
        self._slot_failures = 0
        self._fallback = False

    # -- id allocation ----------------------------------------------------
    def _alloc_ids(self, k):
        """Allocate k fresh tids, accounting for ids held by in-flight
        (dispatched, not yet inserted) handles that ``new_trial_ids``
        cannot see."""
        ids = self.it.trials.new_trial_ids(k)
        if self._next_tid is not None and self._next_tid > ids[0]:
            ids = list(range(self._next_tid, self._next_tid + k))
        self._next_tid = ids[-1] + 1
        return ids

    def _ready(self, handle) -> bool:
        """Whether materializing ``handle`` will not wait; an algo without
        ``handle_ready`` materializes blocking, and reads as ready."""
        return self._handle_ready is None or bool(self._handle_ready(handle))

    # -- main loop --------------------------------------------------------
    def run(self, prog):
        it = self.it
        trials = it.trials
        reg = _metrics.registry()
        ev = CompletionQueueEvaluator(it.domain, n_workers=self.evaluators,
                                      execution=self.execution)
        self._ring.clear()
        self._next_tid = None
        self._open = 0
        self._exhausted = False
        feed_floor = 0 if self.strict else self.evaluators
        poll = min(it.poll_interval_secs, 0.05)
        stop_exc = None
        reason = None
        try:
            trials.refresh()
            pre = [d for d in trials._dynamic_trials
                   if d["state"] == JOB_STATE_NEW]
            self._pre_open = len(pre)
            if pre:
                self._submit(pre, ev, reg, pre_batch=True)
            while True:
                # Strict mode checks stop conditions only at batch
                # boundaries (the replaced loop's cadence); the greedy
                # schedule checks every step.
                if (self._open == 0 or not self.strict) and \
                        it._stopped(it.n_done()):
                    reason = "stop condition"
                    break
                if not self._exhausted:
                    self._refill(reg)
                if self._fallback:
                    reason = "slot failures"
                    break
                while self._ring and self._open <= feed_floor:
                    if not self._consume_head(ev, reg):
                        # Algo returned no docs (or the budget is spent):
                        # stop dispatching, finish what's in flight —
                        # unless the slot-failure cap tripped, in which
                        # case the sync loop takes over.
                        if not self._fallback:
                            self._exhausted = True
                        break
                    self._refill(reg)
                    if self._fallback:
                        break
                if self._fallback:
                    reason = "slot failures"
                    break
                if self._open == 0:
                    if self._exhausted or not self._ring:
                        reason = "algo exhausted" if self._exhausted else None
                        break
                    continue  # pragma: no cover - ring feeds next pass
                if self._ring and not self._eval_bound_counted and \
                        self._ready(self._ring[0].handle):
                    # Head ready but the evaluator is saturated: the
                    # pipeline is eval-bound (counted once per episode).
                    reg.counter("pipeline.stall.eval_bound").inc()
                    self._eval_bound_counted = True
                rec = ev.get(timeout=poll)
                if rec is None:
                    continue  # poll tick: re-check timeout/threshold
                err, batch_done = self._record(rec, ev, prog, reg)
                if err is not None and not it.catch_eval_exceptions:
                    stop_exc = err
                    reason = "objective exception"
                    break
                if batch_done and self._early_stop():
                    reason = "early stop"
                    break
        finally:
            try:
                # On fallback (like on an objective exception) queued-but-
                # unstarted work reverts to NEW so the synchronous loop
                # picks it up instead of losing it to ERROR("Cancelled").
                self._drain(ev, prog, reg,
                            reason=reason or "shutdown",
                            revert_new=stop_exc is not None
                            or self._fallback)
            finally:
                ev.shutdown()
        if stop_exc is not None:
            _flight.on_crash("pipeline", stop_exc)
            raise stop_exc
        if self._fallback:
            return "fallback"
        return self

    # -- stages -----------------------------------------------------------
    def _refill(self, reg):
        """Dispatch until the ring holds ``depth`` handles or the eval
        budget is spoken for.  A freed slot re-dispatches here immediately
        after its batch is inserted (same call site), so the new handle
        conditions on the freshest pending set."""
        it = self.it
        trials = it.trials
        target = it.max_evals
        while len(self._ring) < self.depth:
            n_disp = it.n_enqueued() + sum(len(s.ids) for s in self._ring)
            k = it.max_queue_len - self._pre_open
            if target is not None:
                k = min(k, target - n_disp)
            if k <= 0:
                return
            seed = int(it.rstate.integers(2 ** 31 - 1))
            ids = self._alloc_ids(k)
            try:
                _faults.maybe_fail("pipeline.dispatch", n=k)
                with it.tracer.span("dispatch"):
                    handle = self._dispatch(ids, it.domain, trials, seed)
                    self._transfer(handle)
            except Exception as e:
                # Nothing was inserted: roll back the optimistic id
                # allocation so the retry (or the sync fallback) reuses
                # the same tids: no gaps, no lost ids.
                self._next_tid = ids[0]
                if not self._count_slot_failure(reg, "dispatch", e):
                    return
                continue
            self._slot_failures = 0
            if handle is None:
                return
            self._seq += 1
            span = f"ps{self._seq}"
            self._ring.append(_Slot(ids, handle, span))
            reg.gauge("pipeline.occupancy").set(len(self._ring))
            reg.histogram("pipeline.occupancy").observe(len(self._ring))
            EVENTS.emit("span_begin", name="pipeline.slot", span=span,
                        n=len(ids))
            EVENTS.emit("pipeline_dispatch", n=len(ids), slot=span,
                        depth=len(self._ring))

    def _transfer(self, handle):
        """Start the handle's copy to the host.  A copy that cannot start
        fails its slot like a failed dispatch: materializing the handle
        by a plain blocking fetch instead would hide the fault."""
        if handle is not None and self._start_transfer is not None:
            self._start_transfer(handle)

    def _count_slot_failure(self, reg, stage, exc) -> bool:
        """Charge one dispatch/materialize failure against the consecutive
        cap.  Returns False once the cap trips (fallback engaged)."""
        self._slot_failures += 1
        reg.counter("pipeline.slot.failed").inc()
        logger.warning("pipeline %s failed (%d consecutive): %s",
                       stage, self._slot_failures, exc)
        if self._slot_failures < _FALLBACK_AFTER:
            return True
        self._fallback = True
        reg.counter("pipeline.fallbacks").inc()
        EVENTS.emit("pipeline_fallback", reason=stage,
                    failures=self._slot_failures)
        return False

    def _redispatch(self, slot, reg, stage, exc) -> bool:
        """Replace a failed head slot: re-dispatch its tids with a fresh
        seed and push the new handle to the ring front.  Returns False
        when the consecutive-failure cap engages the fallback (or the
        algo refuses the re-dispatch)."""
        it = self.it
        while True:
            if not self._count_slot_failure(reg, stage, exc):
                return False
            seed = int(it.rstate.integers(2 ** 31 - 1))
            try:
                _faults.maybe_fail("pipeline.dispatch", n=len(slot.ids))
                with it.tracer.span("dispatch"):
                    handle = self._dispatch(slot.ids, it.domain,
                                            it.trials, seed)
                    self._transfer(handle)
                break
            except Exception as e:
                stage, exc = "re-dispatch", e
        if handle is None:
            return False         # algo refused: run() treats as exhausted
        self._seq += 1
        span = f"ps{self._seq}"
        self._ring.appendleft(_Slot(slot.ids, handle, span))
        reg.gauge("pipeline.occupancy").set(len(self._ring))
        reg.counter("pipeline.redispatch").inc()
        EVENTS.emit("span_begin", name="pipeline.slot", span=span,
                    n=len(slot.ids))
        EVENTS.emit("pipeline_dispatch", n=len(slot.ids), slot=span,
                    depth=len(self._ring), redispatch=True)
        return True

    def _consume_head(self, ev, reg) -> bool:
        """Materialize the oldest handle, insert its docs (clamped to the
        remaining eval budget) and submit them.  Returns False when the
        algo is exhausted (no docs), the budget is spent, or slot-failure
        recovery engaged the sync fallback."""
        it = self.it
        trials = it.trials
        slot = self._ring[0]
        ready = self._ready(slot.handle)
        if not ready:
            reg.counter("pipeline.stall.suggest_bound").inc()
        t0 = perf_counter()
        try:
            with it.tracer.span("suggest"):
                docs = self._materialize(slot.handle)
        except Exception as e:
            # Dead handle: drop the slot and dispatch a replacement for
            # the SAME tids at the ring head (order and id continuity
            # preserved — nothing of this slot was inserted).
            self._ring.popleft()
            self._eval_bound_counted = False
            reg.gauge("pipeline.occupancy").set(len(self._ring))
            EVENTS.emit("span_end", name="pipeline.slot", span=slot.span)
            return self._redispatch(slot, reg, "materialize", e)
        self._slot_failures = 0
        if not ready:
            wait_ms = (perf_counter() - t0) * 1e3
            reg.counter("pipeline.stall.suggest_bound_ms").inc(wait_ms)
            reg.histogram("pipeline.stall.suggest_bound_ms",
                          buckets=MS_BUCKETS).observe(wait_ms)
        self._ring.popleft()
        self._eval_bound_counted = False
        reg.gauge("pipeline.occupancy").set(len(self._ring))
        EVENTS.emit("span_end", name="pipeline.slot", span=slot.span)
        n_docs = 0 if docs is None else len(docs)
        EVENTS.emit("suggest", n=n_docs)
        if docs is not None and it.max_evals is not None:
            # A handle that outlived a budget shrink (run(N) resumed with a
            # smaller allowance) must not overshoot max_evals.
            docs = docs[:max(0, it.max_evals - it.n_enqueued())]
        EVENTS.emit("pipeline_materialize", n=0 if docs is None else len(docs),
                    slot=slot.span)
        if not docs:
            return False
        if _context.armed():
            # Stamp the run's trace context so workers that claim these
            # docs attach their spans to the originating trial.
            for doc in docs:
                _context.stamp_misc(doc["misc"], tid=doc["tid"],
                                    trace_id=it.tracer.trace_id)
        if EVENTS.enabled:
            for doc in docs:
                EVENTS.emit("trial_queued", trial=doc["tid"])
        with it.tracer.span("store"):
            trials.insert_trial_docs(docs)
            trials.refresh()
        self._submit(docs, ev, reg)
        return True

    def _submit(self, docs, ev, reg, pre_batch=False):
        it = self.it
        batch = _Batch(len(docs), pre=pre_batch)
        for doc in docs:
            doc["state"] = JOB_STATE_RUNNING
            doc["book_time"] = coarse_utcnow()
            ev.submit(doc, Ctrl(it.trials, current_trial=doc), token=batch)
        self._open += len(docs)
        reg.gauge("pipeline.eval_backlog").set(self._open)

    def _record(self, rec, ev, prog, reg, draining=False):
        """Apply one completion to the trials store (calling thread only).
        Returns ``(error_or_None, batch_done)``."""
        item, kind, payload = rec
        it = self.it
        trials = it.trials
        doc = item.doc
        err = None
        if kind == "ok":
            doc["state"] = JOB_STATE_DONE
            doc["result"] = payload
            doc["refresh_time"] = coarse_utcnow()
            EVENTS.emit("trial_end", trial=doc["tid"], state="done",
                        loss=payload.get("loss"))
            reg.counter("fmin.trials.done").inc()
        else:  # "error"
            e = payload
            fail_count = doc["misc"].get("fail_count", 0)
            if (not draining and is_transient(e)
                    and fail_count < it.max_trial_retries):
                # Transient: charge the budget and resubmit the SAME doc
                # to the evaluator — still RUNNING, same batch token, the
                # open-count unchanged (one completion consumed, one
                # evaluation re-queued).
                doc["misc"]["fail_count"] = fail_count + 1
                reg.counter("fmin.trials.retried").inc()
                EVENTS.emit("trial_retry", trial=doc["tid"],
                            attempt=fail_count + 1, error=type(e).__name__)
                ev.task_done(item)
                ev.submit(doc, item.ctrl, token=item.token)
                return None, False
            logger.error("job exception: %s", e)
            doc["state"] = JOB_STATE_ERROR
            doc["misc"]["error"] = (type(e).__name__, str(e))
            doc["refresh_time"] = coarse_utcnow()
            EVENTS.emit("trial_end", trial=doc["tid"], state="error",
                        error=type(e).__name__)
            reg.counter("fmin.trials.error").inc()
            err = e
        ev.task_done(item)
        self._open -= 1
        reg.gauge("pipeline.eval_backlog").set(self._open)
        batch = item.token
        batch_done = False
        if batch is not None:
            batch.pending -= 1
            batch_done = batch.pending == 0
            if batch.pre:
                self._pre_open -= 1
        prog.update(1)
        if err is not None and not it.catch_eval_exceptions:
            trials.refresh()
            return err, batch_done
        if batch_done and not draining:
            trials.refresh()
            with it.tracer.span("save"):
                it._save_trials()
            reg.counter("fmin.batches").inc()
            try:
                prog.postfix(trials.best_trial["result"]["loss"])
            except AllTrialsFailed:
                pass
        return err, batch_done

    def _early_stop(self) -> bool:
        it = self.it
        if it.early_stop_fn is None:
            return False
        with it.tracer.span("early_stop"):
            stop, kwargs = it.early_stop_fn(it.trials, *it.early_stop_args)
        it.early_stop_args = kwargs
        if stop:
            logger.info("early stop triggered")
        return stop

    # -- cancellation ------------------------------------------------------
    def _drain(self, ev, prog, reg, reason, revert_new=False):
        """Tear down in-flight work: discard un-materialized handles (their
        tids were never inserted), cancel queued evaluations, wait out the
        started ones.  Leaves no trial RUNNING."""
        it = self.it
        if self._ring:
            logger.info("discarding %d in-flight suggest handle(s): %s",
                        len(self._ring), reason)
        for slot in self._ring:
            EVENTS.emit("span_end", name="pipeline.slot", span=slot.span)
            EVENTS.emit("pipeline_cancel", slot=slot.span, n=len(slot.ids),
                        reason=reason)
        self._ring.clear()
        self._next_tid = None
        reg.gauge("pipeline.occupancy").set(0)
        if self._open == 0:
            return
        it._cancel_inflight(reason)
        ev.cancel_all()
        deadline = time.monotonic() + _DRAIN_TIMEOUT_S
        while self._open > 0:
            rec = ev.get(timeout=max(0.05, deadline - time.monotonic()))
            if rec is None:
                if time.monotonic() >= deadline:  # pragma: no cover
                    logger.warning("pipeline drain timed out with %d open "
                                   "trial(s)", self._open)
                    break
                continue  # pragma: no cover - spurious wake
            item, kind, _payload = rec
            if kind == "cancelled":
                doc = item.doc
                if revert_new:
                    # Objective exception path: leave queued work exactly
                    # where the serial loop would — still NEW.
                    doc["state"] = JOB_STATE_NEW
                    doc["book_time"] = None
                else:
                    doc["state"] = JOB_STATE_ERROR
                    doc["misc"]["error"] = ("Cancelled", reason)
                    doc["refresh_time"] = coarse_utcnow()
                    EVENTS.emit("trial_end", trial=doc["tid"],
                                state="error", error="Cancelled")
                ev.task_done(item)
                self._open -= 1
                if item.token is not None:
                    item.token.pending -= 1
            else:
                self._record(rec, ev, prog, reg, draining=True)
        it.trials.refresh()
        reg.gauge("pipeline.eval_backlog").set(self._open)

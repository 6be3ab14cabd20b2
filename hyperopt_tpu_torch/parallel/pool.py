"""Parallel trial evaluation on one host: ``PoolTrials`` and the
pipelined loop's evaluator stage.

Counterpart of ``hyperopt_tpu/parallel/pool.py``.  ``PoolTrials`` is an
asynchronous ``Trials`` (the reference's ``SparkTrials`` capability slot):
``fmin`` only enqueues documents, and up to ``parallelism`` trials run at
once, with a per-trial ``trial_timeout`` and real cancellation on
``fmin(timeout=)`` and early stop, in one of two execution modes:

* ``execution="process"``: each trial runs in a forked child process,
  SIGTERMed on timeout or cancellation and SIGKILLed when it ignores that
  for ``_TERM_GRACE_S`` seconds.  The child runs ``Domain.evaluate`` and
  the objective only, on the host: a child forked from a process whose
  CUDA context is live must not touch the card (any CUDA call raises
  there), so the objective must be host Python.  The child leaves with
  ``os._exit`` and runs none of the parent's teardown.
* ``execution="thread"`` (the default): trials run on a thread pool.
  Threads cannot be killed, so cancellation is cooperative: at the
  deadline the trial is marked ERROR (the loop moves on) and its
  ``Ctrl.should_stop()`` turns True.  Threads share the interpreter lock
  with the suggest dispatch: an objective that releases it (sleep, I/O,
  native or card work) overlaps, a pure-Python one does not.

A trial whose evaluation raises a transient error
(``exceptions.is_transient``) is run again on the same point up to
``fmin(max_trial_retries=)`` times, ``misc.fail_count`` counting the
retries (a process-mode child is forked anew).

:class:`CompletionQueueEvaluator` runs ``Domain.evaluate`` for the
pipelined ``fmin`` loop (``pipeline.py``) on ``n_workers`` threads (or a
forked child per trial) and hands back completions through a queue; every
``Trials`` mutation stays on the calling thread.

Counters (``obs/metrics.py``): ``pool.dispatched``, ``pool.trials.done``,
``pool.trials.error``, ``pool.trial_retries``, ``pool.trial_timeout``,
``pool.cancelled`` and ``pool.cancel.sigkill``.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import threading
from concurrent.futures import ThreadPoolExecutor

from .. import base
from ..base import (
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    Ctrl,
    Trials,
    coarse_utcnow,
)
from ..exceptions import TRANSIENT_ERROR_NAMES, is_transient
from ..obs import context as _context
from ..obs import metrics as _metrics
from ..obs.events import EVENTS

logger = logging.getLogger(__name__)

#: Evaluation children are forked: the objective need not be picklable,
#: and the child starts with the parent's state (fault schedules included).
_FORK = multiprocessing.get_context("fork")


class _ChildCtrl:
    """Minimal Ctrl stand-in inside a forked evaluation child: collects
    attachments locally; they travel back through the result pipe."""

    def __init__(self):
        self.attachments = {}
        self.current_trial = None
        self.workdir = None

    def should_stop(self):
        return False


def _child_eval(domain, spec, conn):
    """Forked-child entry: evaluate on the host, send the result, and exit
    with ``os._exit``, without the parent's teardown (its threads did not
    survive the fork, and its CUDA context must not be touched here)."""
    try:
        ctrl = _ChildCtrl()
        try:
            result = domain.evaluate(spec, ctrl)
            conn.send(("ok", result, ctrl.attachments))
        except Exception as e:  # noqa: BLE001 — marshalled to the parent
            conn.send(("err", type(e).__name__, str(e)))
        conn.close()
    finally:
        os._exit(0)


class PoolTrials(Trials):
    """Trials evaluated by a thread or process pool.

    ``parallelism``: the most objectives in flight; ``trial_timeout``:
    seconds, after which a trial is cancelled and marked ERROR;
    ``execution``: ``"thread"`` or ``"process"`` (see the module doc).
    """

    asynchronous = True

    #: Seconds a cancelled process-mode child gets to honour SIGTERM before
    #: the escalation to SIGKILL (a class attribute, so tests can shrink
    #: it).
    _TERM_GRACE_S = 5.0

    def __init__(self, parallelism: int = 4, trial_timeout=None,
                 execution: str = "thread", exp_key=None, refresh=True):
        if parallelism < 1:
            raise ValueError("parallelism must be >= 1")
        if execution not in ("thread", "process"):
            raise ValueError(
                f"execution must be 'thread' or 'process', got {execution!r}")
        self.parallelism = parallelism
        self.trial_timeout = trial_timeout
        self.execution = execution
        self.max_trial_retries = 0   # set per-run by fmin()
        self._pool = None
        self._inflight: set = set()
        self._cancel_events: dict = {}   # tid -> threading.Event
        self._procs: dict = {}           # tid -> multiprocessing.Process
        self._domain = None
        self._draining = False
        super().__init__(exp_key=exp_key, refresh=refresh)

    def __getstate__(self):
        state = super().__getstate__()
        state["_pool"] = None
        state["_inflight"] = set()
        state["_cancel_events"] = {}
        state["_procs"] = {}
        state["_domain"] = None
        state["_draining"] = False
        return state

    # -- fmin hands the pool its domain; refresh() then dispatches ---------

    def fmin(self, fn, space, algo, max_evals, **kwargs):
        self._domain = base.Domain(fn, space, pass_expr_memo_ctrl=kwargs.get(
            "pass_expr_memo_ctrl"))
        self._draining = False
        # The pool records results itself (the asynchronous contract), so
        # FMinIter's retry loop never sees its failures: the transient
        # retry budget applies here, per trial.
        self.max_trial_retries = max(0, int(
            kwargs.get("max_trial_retries") or 0))
        # Keep the queue as wide as the pool.
        kwargs.setdefault("max_queue_len", self.parallelism)
        try:
            return super().fmin(fn, space, algo, max_evals, **kwargs)
        finally:
            self.shutdown()

    def _ensure_pool(self):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.parallelism,
                thread_name_prefix="hyperopt-tpu-pool")
        return self._pool

    def shutdown(self):
        self.cancel_inflight("shutdown")
        if self._pool is not None:
            self._pool.shutdown(wait=self.execution == "process")
            self._pool = None
        # The run is over: free the device history rings this pool's
        # suggests fed (kept per Trials object; a long-lived process may
        # build many pools).
        from .. import history

        history.forget(self)

    # -- cancellation --------------------------------------------------------

    def cancel_inflight(self, reason: str = "cancelled") -> int:
        """Stop every in-flight trial and drain the queue.  Process-mode
        children are killed; thread-mode trials are marked ERROR and their
        ``Ctrl.should_stop()`` turns True; enqueued trials not yet started
        are cancelled too, and nothing more is dispatched until the next
        ``fmin``.  Returns the number cancelled."""
        with self._lock:
            self._draining = True
            tids = list(self._inflight)
            n = 0
            for doc in self._dynamic_trials:
                if doc["state"] == JOB_STATE_NEW:
                    doc["state"] = JOB_STATE_ERROR
                    doc["misc"]["error"] = ("Cancelled",
                                            f"{reason} (never started)")
                    doc["refresh_time"] = coarse_utcnow()
                    n += 1
        for tid in tids:
            if self._cancel_trial(tid, reason):
                n += 1
        return n

    def _cancel_trial(self, tid, reason) -> bool:
        with self._lock:
            if tid not in self._inflight:
                return False
            doc = next((d for d in self._dynamic_trials if d["tid"] == tid),
                       None)
            ev = self._cancel_events.get(tid)
            if ev is not None:
                ev.set()
            if doc is not None and doc["state"] == JOB_STATE_RUNNING:
                doc["state"] = JOB_STATE_ERROR
                doc["misc"]["error"] = ("Cancelled", reason)
                doc["refresh_time"] = coarse_utcnow()
            self._inflight.discard(tid)
            self._cancel_events.pop(tid, None)
            proc = self._procs.pop(tid, None)
        if proc is not None and proc.is_alive():
            proc.terminate()
            proc.join(timeout=self._TERM_GRACE_S)
            if proc.is_alive():
                # SIGTERM ignored/blocked by the child: escalate to
                # SIGKILL (tests shrink _TERM_GRACE_S to exercise this).
                _metrics.registry().counter("pool.cancel.sigkill").inc()
                proc.kill()
                proc.join(timeout=self._TERM_GRACE_S)
        _metrics.registry().counter("pool.cancelled").inc()
        EVENTS.emit("trial_end", trial=tid, state="cancelled", reason=reason)
        return True

    def _on_deadline(self, doc):
        tid = doc["tid"]
        with self._lock:
            still_running = (tid in self._inflight
                             and doc["state"] == JOB_STATE_RUNNING)
        if still_running:
            logger.warning("trial %s exceeded trial_timeout=%ss — cancelling",
                           tid, self.trial_timeout)
            _metrics.registry().counter("pool.trial_timeout").inc()
            self._cancel_trial(
                tid, f"exceeded trial_timeout={self.trial_timeout}s")

    # -- evaluation ----------------------------------------------------------

    def _run_guarded(self, run, doc, ev):
        """Pool-thread entry: the ``trial_timeout`` clock starts HERE — when
        execution actually begins — not at enqueue, so trials queued behind a
        zombie (cancelled-but-still-running) thread-mode objective are not
        spuriously timed out while waiting for a worker."""
        if ev.is_set():  # cancelled while still queued
            return
        EVENTS.emit("trial_start", trial=doc["tid"])
        timer = None
        if self.trial_timeout is not None:
            timer = threading.Timer(self.trial_timeout,
                                    self._on_deadline, (doc,))
            timer.daemon = True
            timer.start()
        run(doc, ev, timer)

    def _finish(self, doc, ev, timer, state, result=None, error=None,
                attachments=None):
        if timer is not None:
            timer.cancel()
        with self._lock:
            cancelled = ev.is_set() or doc["tid"] not in self._inflight
            if not cancelled:
                doc["state"] = state
                if result is not None:
                    doc["result"] = result
                if error is not None:
                    doc["misc"]["error"] = error
                doc["refresh_time"] = coarse_utcnow()
            self._inflight.discard(doc["tid"])
            self._cancel_events.pop(doc["tid"], None)
            self._procs.pop(doc["tid"], None)
        if not cancelled:
            EVENTS.emit("trial_end", trial=doc["tid"],
                        state="done" if state == JOB_STATE_DONE else "error")
            _metrics.registry().counter(
                "pool.trials.done" if state == JOB_STATE_DONE
                else "pool.trials.error").inc()
        if not cancelled and attachments:
            ta = self.trial_attachments(doc)
            for k, v in attachments.items():
                ta[k] = v

    def _run_trial_thread(self, doc, ev, timer):
        ctrl = Ctrl(self, current_trial=doc)
        ctrl.should_stop = ev.is_set  # cooperative-cancellation hook
        try:
            spec = base.spec_from_misc(doc["misc"])
            with _context.bind_doc(doc):
                while True:
                    try:
                        result = self._domain.evaluate(spec, ctrl)
                        break
                    except Exception as e:
                        if ev.is_set() or not self._charge_retry(doc, e):
                            raise
        except Exception as e:
            logger.error("pool job exception (tid %s): %s", doc["tid"], e)
            self._finish(doc, ev, timer, JOB_STATE_ERROR,
                         error=(type(e).__name__, str(e)))
        else:
            self._finish(doc, ev, timer, JOB_STATE_DONE, result=result)

    def _charge_retry(self, doc, exc) -> bool:
        """Consume one unit of the trial's transient-retry budget;
        False when the failure must become the trial's ERROR record
        (non-transient, or budget spent).  ``exc`` may be an exception
        object or the type *name* a forked child marshalled back."""
        transient = (exc in TRANSIENT_ERROR_NAMES
                     if isinstance(exc, str) else is_transient(exc))
        fail_count = doc["misc"].get("fail_count", 0)
        if not transient or fail_count >= self.max_trial_retries:
            return False
        doc["misc"]["fail_count"] = fail_count + 1
        _metrics.registry().counter("pool.trial_retries").inc()
        EVENTS.emit("trial_retry", trial=doc["tid"], attempt=fail_count + 1,
                    error=exc if isinstance(exc, str) else type(exc).__name__)
        return True

    def _run_trial_process(self, doc, ev, timer):
        """Watch one forked evaluation child from a pool thread."""
        ctx = _FORK
        spec = base.spec_from_misc(doc["misc"])
        # Outer loop: one iteration per fork.  A child that died on a
        # *transient* error (marshalled back by type name) is re-forked
        # against the trial's retry budget; anything else finishes the doc.
        while True:
            parent_conn, child_conn = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=_child_eval,
                               args=(self._domain, spec, child_conn),
                               daemon=True)
            with self._lock:
                if ev.is_set():  # cancelled before launch
                    parent_conn.close()
                    child_conn.close()
                    return
                self._procs[doc["tid"]] = proc
            proc.start()
            child_conn.close()
            try:
                msg = None
                while msg is None:
                    if parent_conn.poll(0.1):
                        msg = parent_conn.recv()
                        break
                    if ev.is_set():
                        return  # _cancel_trial reaps the child + marks doc
                    if not proc.is_alive() and not parent_conn.poll(0.0):
                        self._finish(doc, ev, timer, JOB_STATE_ERROR,
                                     error=("ChildDied",
                                            f"exitcode={proc.exitcode}"))
                        return
                if msg[0] == "ok":
                    self._finish(doc, ev, timer, JOB_STATE_DONE,
                                 result=msg[1], attachments=msg[2])
                    return
                if self._charge_retry(doc, msg[1]):
                    continue  # re-fork the same spec
                self._finish(doc, ev, timer, JOB_STATE_ERROR,
                             error=(msg[1], msg[2]))
                return
            except (EOFError, OSError) as e:  # pragma: no cover
                self._finish(doc, ev, timer, JOB_STATE_ERROR,
                             error=("PipeError", str(e)))
                return
            finally:
                parent_conn.close()
                proc.join(timeout=5.0)

    def refresh(self):
        # FMinIter polls refresh() in its asynchronous loop: NEW docs go to
        # the pool here.
        with self._lock:
            if self._domain is not None and not self._draining:
                for doc in self._dynamic_trials:
                    if doc["state"] == JOB_STATE_NEW \
                            and doc["tid"] not in self._inflight \
                            and len(self._inflight) < self.parallelism:
                        doc["state"] = JOB_STATE_RUNNING
                        doc["book_time"] = coarse_utcnow()
                        _metrics.registry().counter("pool.dispatched").inc()
                        self._inflight.add(doc["tid"])
                        ev = threading.Event()
                        self._cancel_events[doc["tid"]] = ev
                        run = (self._run_trial_process
                               if self.execution == "process"
                               else self._run_trial_thread)
                        self._ensure_pool().submit(self._run_guarded,
                                                   run, doc, ev)
        super().refresh()


# -- CompletionQueueEvaluator: the pipelined loop's evaluator stage -----------


class _EvalItem:
    """One submitted trial travelling worker-ward: the inserted doc, its
    pre-built Ctrl, and an opaque scheduling token (the executor's batch
    record).  ``started``/``cancelled`` are guarded by the evaluator lock
    so cooperative cancellation cannot race the worker's pickup."""

    __slots__ = ("doc", "ctrl", "token", "started", "cancelled")

    def __init__(self, doc, ctrl, token):
        self.doc = doc
        self.ctrl = ctrl
        self.token = token
        self.started = False
        self.cancelled = False


_EVAL_STOP = object()


class CompletionQueueEvaluator:
    """Concurrent evaluator stage feeding a completion queue.

    The adapter between ``pipeline.PipelinedExecutor`` and
    this module's execution machinery: the executor submits inserted
    trial docs; ``n_workers`` workers run ONLY ``domain.evaluate`` and
    push ``(item, kind, payload)`` onto the completion queue, where
    ``kind`` is ``"ok"`` (payload: result dict), ``"error"`` (payload:
    the exception) or ``"cancelled"`` (queued item skipped after
    :meth:`cancel_all`).  Every Trials mutation — state flips, result
    recording, ``refresh()`` — stays on the submitting thread, so the
    executor needs no cross-thread locking beyond the queues themselves
    and recording order with one worker is exactly submission order
    (the pipelined loop's determinism rests on it).

    ``execution="process"`` forks one child per trial (the
    :func:`_child_eval` entry ``PoolTrials`` uses) for objectives that
    must not share the parent's interpreter; cancellation then
    SIGTERMs children instead of waiting them out.
    """

    def __init__(self, domain, n_workers: int = 1, execution: str = "thread",
                 name: str = "fmin-eval"):
        if execution not in ("thread", "process"):
            raise ValueError(
                f"execution must be 'thread' or 'process', got {execution!r}")
        import queue as _queue

        self._domain = domain
        self.execution = execution
        self._work: "_queue.SimpleQueue" = _queue.SimpleQueue()
        self._done: "_queue.SimpleQueue" = _queue.SimpleQueue()
        self._empty_exc = _queue.Empty
        self._lock = threading.Lock()
        self._outstanding: list = []
        self._procs: dict = {}            # id(item) -> live child process
        self._threads = [
            threading.Thread(target=self._worker, name=f"{name}-{i}",
                             daemon=True)
            for i in range(max(1, int(n_workers)))
        ]
        for t in self._threads:
            t.start()

    # -- submit side -----------------------------------------------------
    def submit(self, doc, ctrl, token=None) -> None:
        item = _EvalItem(doc, ctrl, token)
        with self._lock:
            self._outstanding.append(item)
        self._work.put(item)

    def get(self, timeout=None):
        """Next completion ``(item, kind, payload)`` or None on timeout."""
        try:
            return self._done.get(timeout=timeout)
        except self._empty_exc:
            return None

    def task_done(self, item) -> None:
        with self._lock:
            try:
                self._outstanding.remove(item)
            except ValueError:
                pass

    def cancel_all(self) -> int:
        """Cooperatively cancel everything not yet started; returns how
        many queued items will come back ``"cancelled"``.  Started
        thread-mode objectives run to completion (threads cannot be
        killed, the PoolTrials caveat); process-mode children are
        SIGTERMed and surface as ``"error"`` completions."""
        n = 0
        with self._lock:
            for item in self._outstanding:
                if not item.started and not item.cancelled:
                    item.cancelled = True
                    n += 1
            procs = list(self._procs.values())
        for proc in procs:
            try:
                proc.terminate()
            except Exception:  # pragma: no cover - already dead
                pass
        return n

    def shutdown(self) -> None:
        for _ in self._threads:
            self._work.put(_EVAL_STOP)
        for t in self._threads:
            t.join(timeout=5.0)

    # -- worker side -----------------------------------------------------
    def _worker(self) -> None:
        while True:
            item = self._work.get()
            if item is _EVAL_STOP:
                return
            with self._lock:
                if item.cancelled:
                    self._done.put((item, "cancelled", None))
                    continue
                item.started = True
            EVENTS.emit("trial_start", trial=item.doc["tid"])
            try:
                spec = base.spec_from_misc(item.doc["misc"])
                with _context.bind_doc(item.doc):
                    if self.execution == "process":
                        result = self._eval_in_child(item, spec)
                    else:
                        result = self._domain.evaluate(spec, item.ctrl)
            except Exception as e:  # noqa: BLE001 — marshalled to recorder
                self._done.put((item, "error", e))
            else:
                self._done.put((item, "ok", result))

    def _eval_in_child(self, item, spec):
        parent_conn, child_conn = _FORK.Pipe(duplex=False)
        proc = _FORK.Process(
            target=_child_eval, args=(self._domain, spec, child_conn),
            daemon=True)
        with self._lock:
            self._procs[id(item)] = proc
        try:
            proc.start()
            child_conn.close()
            try:
                msg = parent_conn.recv()
            except (EOFError, OSError) as e:
                raise RuntimeError(f"evaluation child died: {e}") from None
            if msg[0] == "ok":
                return msg[1]
            raise RuntimeError(f"{msg[1]}: {msg[2]}")
        finally:
            with self._lock:
                self._procs.pop(id(item), None)
            parent_conn.close()
            proc.join(timeout=5.0)

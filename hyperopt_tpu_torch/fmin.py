"""``fmin``: the optimization loop and the public API.

Counterpart of ``hyperopt_tpu/fmin.py``.  The hosted loop suggests up to
``max_queue_len`` trials in one call of the algo (TPE proposes a batch by
its constant-liar scan), then evaluates and records them; the pipelined
loop (``overlap_depth=``, ``evaluators=``, ``pipeline.py``) keeps several
suggests in flight while objectives run; an asynchronous ``Trials``
(``parallel.PoolTrials``) evaluates the trials itself.  The
plugin boundaries are the same: ``algo`` is any
``suggest(new_ids, domain, trials, seed) -> docs`` callable (bind
hyperparameters with ``functools.partial``), ``trials`` a
:class:`~hyperopt_tpu_torch.base.Trials`.

``device`` selects where the suggest algorithms run.  It defaults to CUDA
and raises when there is none; pass ``device="cpu"`` to run on the CPU.

``mode="device"`` runs the whole loop on the device instead, for a torch
objective: one CUDA-graph replay per trial, the trials landed every
``sync_stride`` of them (``device.py``).

Observability (``obs/``): the loop emits ``trial_queued``/``trial_start``/
``trial_end``/``suggest`` events and the ``fmin.batches``,
``fmin.trials.done``/``error`` and ``fmin.trials_per_sec`` metrics;
``trace_dir=`` times the ``suggest``, ``store``, ``evaluate``, ``save``
and ``early_stop`` spans of each batch and the serial loop's ``progress``
span between batches (the stop check, the trial counts, the progress
bar; not in the event log) and writes ``loop_trace.json``,
``loop_events.jsonl``, ``chrome_trace.json`` and the ``torch.profiler``
export ``profiler_trace.json`` there; an exception escaping the loop
triggers the flight recorder when it is installed (``obs/flight.py``).
The loop's spans are spans of the program's span store
(``obs/trace.py``), which also records them without a trace dir while a
``torch.profiler`` session records; a batch's spans carry its first new
trial id as their request id.
"""

from __future__ import annotations

import json
import logging
import numbers
import os
import pickle
import time
from contextlib import contextmanager
from functools import partial

import numpy as np

from . import base
from .base import (
    Ctrl,
    Domain,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    Trials,
    coarse_utcnow,
)
from .exceptions import AllTrialsFailed, is_transient
from .obs import context as _context
from .obs import flight as _flight
from .obs import metrics as _metrics
from .obs import trace as _trace
from .obs.events import EVENTS
from .obs.trace import NullTracer, Tracer
from .space import compile_space, resolve_device
from .utils.progress import default_callback, no_progress_callback

logger = logging.getLogger(__name__)


def space_eval(space, hp_assignment: dict):
    """Substitute a ``{label: value}`` assignment (as returned by ``fmin``
    or ``trials.argmin``; choice values are branch indices) into a space."""
    return compile_space(space).eval_point(hp_assignment)


def fmin_pass_expr_memo_ctrl(f):
    """Mark an objective as taking ``(expr, memo, ctrl)`` instead of a
    realized config; ``Domain`` reads the mark when ``fmin(...,
    pass_expr_memo_ctrl=None)``."""
    f.fmin_pass_expr_memo_ctrl = True
    return f


def _json_scalar(o):
    """``json.dump``'s fallback for trial docs: numpy scalars and arrays as
    plain values; anything else raises."""
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(
        f"trial doc contains non-JSON-serializable {type(o).__name__}; use "
        f"a pickle trials_save_file (non-.json extension) for arbitrary "
        f"result payloads")


def generate_trials_to_calculate(points, exp_key=None):
    """A ``Trials`` seeded with ``{label: value}`` points to evaluate first."""
    trials = Trials(exp_key=exp_key)
    docs = []
    for tid, pt in enumerate(points):
        doc = base.new_trial_doc(tid, exp_key=exp_key)
        doc["misc"]["idxs"] = {k: [tid] for k in pt}
        doc["misc"]["vals"] = {k: [v] for k, v in pt.items()}
        docs.append(doc)
    trials.insert_trial_docs(docs)
    trials.refresh()
    return trials


class FMinIter:
    """The optimization loop.

    Each batch suggests up to ``max_queue_len`` trials in one call of the
    algo, then evaluates and records them, until ``max_evals`` trials are
    done or a stop condition fires.  Synchronous trials are evaluated
    here (``serial_evaluate``); an asynchronous ``Trials``
    (``parallel.PoolTrials``) is only given the docs and polled every
    ``poll_interval_secs``.  ``overlap_depth=D`` (``overlap_suggest=True``
    is ``D = 1``) with a dispatch-capable algo runs the pipelined loop of
    ``pipeline.py`` instead: up to D suggests in flight, ``evaluators``
    objectives at once; any other algo runs the synchronous loop.
    ``max_trial_retries`` re-runs a trial on the same point after a
    transient error (``exceptions.is_transient``).  Iterating yields the
    number of finished trials after each batch."""

    catch_eval_exceptions = False
    pickle_protocol = -1

    def __init__(self, algo, domain, trials, rstate=None,
                 early_stop_fn=None, trials_save_file="", max_evals=None,
                 timeout=None, loss_threshold=None, show_progressbar=True,
                 verbose=False, max_queue_len=1, trace_dir=None,
                 asynchronous=None,
                 poll_interval_secs=0.1, overlap_suggest=False,
                 overlap_depth=None, evaluators=None,
                 max_trial_retries=None):
        if int(max_queue_len) < 1:
            raise ValueError(f"max_queue_len must be >= 1, got "
                             f"{max_queue_len!r}")
        self.tracer = _tracer(trace_dir, domain.cs.device)
        self.algo = algo
        self.max_queue_len = int(max_queue_len)
        self.domain = domain
        self.trials = trials
        self.rstate = np.random.default_rng() if rstate is None else rstate
        self.early_stop_fn = early_stop_fn
        self.early_stop_args: list = []
        self.trials_save_file = trials_save_file
        if asynchronous is None:
            asynchronous = bool(getattr(trials, "asynchronous", False))
        self.asynchronous = asynchronous
        self.poll_interval_secs = poll_interval_secs
        self.max_evals = max_evals
        self.timeout = timeout
        self.loss_threshold = loss_threshold
        self.start_time = time.time()
        self.show_progressbar = show_progressbar
        self.verbose = verbose
        # A trial whose evaluation raises a transient error runs again on
        # the same point, up to this many times (misc.fail_count).
        self.max_trial_retries = max(0, int(max_trial_retries or 0))
        # serial_evaluate's scan cursor: _dynamic_trials only grows and a
        # settled trial never goes back to NEW, so each batch resumes the
        # scan for NEW trials where the last one stopped.
        self._serial_cursor = 0
        evaluators = 1 if evaluators is None else max(1, int(evaluators))
        if overlap_depth is None:
            depth = 1 if overlap_suggest else 0
        else:
            depth = max(0, int(overlap_depth))
        if depth == 0 and evaluators > 1:
            depth = 1       # concurrent evaluation needs the pipelined loop
        self.overlap_depth = depth
        self.evaluators = evaluators
        self._pipeline = None
        if depth > 0 and not self.asynchronous:
            fn, kw = algo, {}
            if isinstance(algo, partial) and not algo.args:
                fn = algo.func
                kw = dict(algo.keywords or {})
            d = getattr(fn, "dispatch", None)
            m = getattr(fn, "materialize", None)
            if d is not None and m is not None:
                from .pipeline import PipelinedExecutor

                self._pipeline = PipelinedExecutor(
                    self, depth=depth, evaluators=evaluators,
                    dispatch=lambda ids, dom, tr, seed: d(
                        ids, dom, tr, seed, **kw),
                    materialize=m,
                    handle_ready=getattr(fn, "handle_ready", None),
                    start_transfer=getattr(fn, "start_transfer", None))
        self.overlap_suggest = self._pipeline is not None

    def serial_evaluate(self, N=-1):
        reg = _metrics.registry()
        dyn = self.trials._dynamic_trials
        # Everything before the cursor is settled (DONE/ERROR); it stalls,
        # never reverses, on a RUNNING trial of an asynchronous store.
        # fmin.scan_skipped counts the trials the cursor spared a visit.
        cur = min(self._serial_cursor, len(dyn))
        reg.counter("fmin.scan_skipped").inc(cur)
        advance = True
        for i in range(cur, len(dyn)):
            trial = dyn[i]
            if trial["state"] != JOB_STATE_NEW:
                if advance and trial["state"] in (JOB_STATE_DONE,
                                                  JOB_STATE_ERROR):
                    self._serial_cursor = i + 1
                else:
                    advance = False
                continue
            trial["state"] = JOB_STATE_RUNNING
            trial["book_time"] = coarse_utcnow()
            EVENTS.emit("trial_start", trial=trial["tid"])
            ctrl = Ctrl(self.trials, current_trial=trial)
            try:
                spec = base.spec_from_misc(trial["misc"])
                # Events emitted inside the objective attach to this trial
                # through the ambient context (free when it is disarmed).
                with _context.bind_doc(trial):
                    while True:
                        try:
                            result = self.domain.evaluate(spec, ctrl)
                            break
                        except Exception as e:
                            fail_count = trial["misc"].get("fail_count", 0)
                            if not (is_transient(e)
                                    and fail_count < self.max_trial_retries):
                                raise
                            trial["misc"]["fail_count"] = fail_count + 1
                            reg.counter("fmin.trials.retried").inc()
                            EVENTS.emit("trial_retry", trial=trial["tid"],
                                        attempt=fail_count + 1,
                                        error=type(e).__name__)
            except Exception as e:
                logger.error("job exception: %s", e)
                trial["state"] = JOB_STATE_ERROR
                trial["misc"]["error"] = (type(e).__name__, str(e))
                trial["refresh_time"] = coarse_utcnow()
                EVENTS.emit("trial_end", trial=trial["tid"], state="error",
                            error=type(e).__name__)
                reg.counter("fmin.trials.error").inc()
                if not self.catch_eval_exceptions:
                    self.trials.refresh()
                    raise
            else:
                trial["state"] = JOB_STATE_DONE
                trial["result"] = result
                trial["refresh_time"] = coarse_utcnow()
                EVENTS.emit("trial_end", trial=trial["tid"], state="done",
                            loss=result.get("loss"))
                reg.counter("fmin.trials.done").inc()
            if advance:
                self._serial_cursor = i + 1
            N -= 1
            if N == 0:
                break
        self.trials.refresh()

    def block_until_done(self):
        """Evaluate what is still NEW, or, for an asynchronous store, poll
        until nothing is NEW or RUNNING.  Past ``timeout`` the store's
        in-flight trials are cancelled (``cancel_inflight``); a store that
        cannot cancel is left with its stragglers."""
        if not self.asynchronous:
            self.serial_evaluate()
            return
        unfinished = (JOB_STATE_NEW, JOB_STATE_RUNNING)
        cancelled = False
        while self.trials.count_by_state_unsynced(unfinished) > 0:
            if not cancelled and self.timeout is not None and \
                    time.time() - self.start_time >= self.timeout:
                self._cancel_inflight("fmin timeout")
                cancelled = True
            if cancelled and not callable(
                    getattr(self.trials, "cancel_inflight", None)):
                logger.warning(
                    "fmin timeout with %d unfinished trial(s) left in the "
                    "store", self.trials.count_by_state_unsynced(unfinished))
                break
            time.sleep(self.poll_interval_secs)
            self.trials.refresh()

    def _stopped(self, n_done):
        if self.max_evals is not None and n_done >= self.max_evals:
            return True
        if self.timeout is not None and \
                time.time() - self.start_time >= self.timeout:
            return True
        if self.loss_threshold is not None:
            try:
                if self.trials.best_trial["result"]["loss"] <= \
                        self.loss_threshold:
                    return True
            except AllTrialsFailed:
                pass
        return False

    def _n_to_enqueue(self):
        """New trials the next batch asks the algo for: the queue's room,
        within ``max_evals``."""
        qlen = self.trials.count_by_state_unsynced((JOB_STATE_NEW,
                                                    JOB_STATE_RUNNING))
        remaining = (self.max_evals - self.n_enqueued()
                     if self.max_evals is not None else self.max_queue_len)
        return min(self.max_queue_len - qlen, remaining)

    def run_one_batch(self, n_to_enqueue):
        """Enqueue ``n_to_enqueue`` new trials (:meth:`_n_to_enqueue`) from
        one call of the algo, then evaluate the queued ones (or poll an
        asynchronous store once).  Returns True when the algo is
        exhausted or early stop fired.  The pipelined loop
        (``pipeline.py``) replaces this when it is configured."""
        trials = self.trials
        stopped = False
        tracer = self.tracer
        request = None
        if n_to_enqueue > 0:
            with tracer.span("suggest"):
                seed = int(self.rstate.integers(2 ** 31 - 1))
                new_ids = trials.new_trial_ids(n_to_enqueue)
                # The batch's spans carry its first new trial id.
                request = new_ids[0] if len(new_ids) else None
                _trace.set_request(request)
                trials.refresh()
                new_trials = self.algo(new_ids, self.domain, trials, seed)
                EVENTS.emit("suggest",
                            n=0 if new_trials is None else len(new_trials))
            if new_trials is None or len(new_trials) == 0:
                stopped = True
            else:
                if _context.armed():
                    for doc in new_trials:
                        _context.stamp_misc(doc["misc"], tid=doc["tid"],
                                            trace_id=tracer.trace_id)
                if EVENTS.enabled:
                    for doc in new_trials:
                        EVENTS.emit("trial_queued", trial=doc["tid"])
                with tracer.span("store"):
                    trials.insert_trial_docs(new_trials)
                    trials.refresh()
        if self.asynchronous:
            with tracer.span("poll"):
                time.sleep(self.poll_interval_secs)
                trials.refresh()
        else:
            with tracer.span("evaluate", request=request):
                self.serial_evaluate()
        with tracer.span("save"):
            self._save_trials()
        if self.early_stop_fn is not None:
            with tracer.span("early_stop"):
                stop, kwargs = self.early_stop_fn(self.trials,
                                                  *self.early_stop_args)
            self.early_stop_args = kwargs
            if stop:
                logger.info("early stop triggered")
                self._cancel_inflight("early stop")
                stopped = True
        _metrics.registry().counter("fmin.batches").inc()
        return stopped

    def _cancel_inflight(self, reason):
        """Stop in-flight work on a store that can cancel it
        (``PoolTrials.cancel_inflight``)."""
        cancel = getattr(self.trials, "cancel_inflight", None)
        if callable(cancel):
            n = cancel(reason)
            if n:
                logger.info("cancelled %d in-flight trial(s): %s", n, reason)

    def n_done(self):
        return self.trials.count_by_state_unsynced(
            (JOB_STATE_DONE, JOB_STATE_ERROR))

    def n_enqueued(self):
        return self.trials.count_by_state_unsynced(
            (JOB_STATE_NEW, JOB_STATE_RUNNING, JOB_STATE_DONE,
             JOB_STATE_ERROR))

    def _save_trials(self):
        """Checkpoint the trials: a pickle, or with a ``.json`` file name
        the plain trial docs and ``exp_key`` (loadable without unpickling,
        but without attachments or a ``Trials`` subclass's state)."""
        if not self.trials_save_file:
            return
        tmp = f"{self.trials_save_file}.tmp.{os.getpid()}"
        try:
            if self.trials_save_file.endswith(".json"):
                with open(tmp, "w") as f:
                    json.dump({"exp_key": self.trials.exp_key,
                               "docs": list(self.trials)}, f,
                              default=_json_scalar)
            else:
                with open(tmp, "wb") as f:
                    pickle.dump(self.trials, f,
                                protocol=self.pickle_protocol)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        os.replace(tmp, self.trials_save_file)
        EVENTS.emit("store_flush", name="trials_save_file")

    def run(self, N, block_until_done=True):
        """Run about ``N`` more trials (within ``max_evals``)."""
        target = self.n_done() + N
        saved_max = self.max_evals
        self.max_evals = target if saved_max is None else min(saved_max,
                                                               target)
        try:
            self._loop()
        finally:
            self.max_evals = saved_max
        if block_until_done:
            self.block_until_done()

    def _loop(self):
        progress_ctx = default_callback if self.show_progressbar \
            else no_progress_callback
        with progress_ctx(initial=self.n_done(), total=self.max_evals) as prog:
            if self._pipeline is not None:
                if self._pipeline.run(prog) != "fallback":
                    return self
                # The executor hit its cap of consecutive slot failures,
                # drained, and hands the rest of the run to this loop.
                logger.warning("pipeline fell back to the synchronous loop")
            # The bookkeeping between two batches (the stop check, the
            # trial counts, the progress bar) is one span, kept out of the
            # event log.
            with self.tracer.span("progress", emit=False):
                before = self.n_done()
                stop = self._stopped(before)
                n_new = None if stop else self._n_to_enqueue()
            while not stop:
                stopped = self.run_one_batch(n_new)
                with self.tracer.span("progress", emit=False):
                    after = self.n_done()
                    prog.update(after - before)
                    try:
                        prog.postfix(self.trials.best_trial["result"]["loss"])
                    except AllTrialsFailed:
                        pass
                    # Stopped, or no progress possible.
                    stop = stopped or self._stopped(after) or (
                        after == before and not self.asynchronous)
                    before = after
                    n_new = None if stop else self._n_to_enqueue()
        return self

    def __iter__(self):
        """Step-wise iteration: yields the number of finished trials after
        each batch."""
        while not self._stopped(self.n_done()):
            before = self.n_done()
            stopped = self.run_one_batch(self._n_to_enqueue())
            yield self.n_done()
            if stopped or (self.n_done() == before
                           and not self.asynchronous):
                break

    def exhaust(self):
        """Run until ``max_evals`` complete or a stop condition fires."""
        with _traced(self.tracer):
            t0 = time.perf_counter()
            try:
                self._loop()
                self.block_until_done()
            except BaseException as e:
                _flight.on_crash("fmin", e)
                raise
            finally:
                wall = time.perf_counter() - t0
                if wall > 0:
                    _metrics.registry().gauge("fmin.trials_per_sec").set(
                        self.n_done() / wall)
        return self


def _tracer(trace_dir, device):
    """The run's tracer: one that writes ``trace_dir`` and profiles
    ``device``, or the no-op one."""
    if not trace_dir:
        return NullTracer()
    return Tracer(trace_dir, device_trace=True, device=device)


@contextmanager
def _traced(tracer):
    """Profile the block, and write the trace dir when it ends, however it
    ends; the profiler's start and export stay outside the wall time the
    spans are attributed against."""
    tracer.start_device_trace()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        tracer.set_wall(time.perf_counter() - t0)
        tracer.stop_device_trace()
        tracer.dump()


def fmin(fn, space, algo=None, max_evals=None,
         timeout=None, loss_threshold=None,
         trials=None, rstate=None, allow_trials_fmin=True,
         pass_expr_memo_ctrl=None,
         catch_eval_exceptions=False,
         verbose=True, return_argmin=True,
         points_to_evaluate=None,
         show_progressbar=True, early_stop_fn=None,
         trials_save_file="", device=None, max_queue_len=1, mode=None,
         sync_stride=None, trace_dir=None, overlap_suggest=False,
         overlap_depth=None, evaluators=None, max_trial_retries=None):
    """Minimize ``fn`` over ``space`` using ``algo`` (default TPE): a
    suggest callable, or a name the backend registry resolves
    (``backends.names()``: ``"tpe"``, ``"anneal"``, ``"gp"``, ...).

    ``fn`` returns a float loss or a result dict with ``loss``/``status``;
    ``max_evals`` bounds the trials, ``timeout`` the wall-clock seconds;
    ``loss_threshold`` stops at a good-enough loss; ``rstate`` is a
    ``np.random.Generator`` or an int seed; ``points_to_evaluate`` is a
    list of ``{label: value}`` dicts run first; ``trials_save_file`` is a
    checkpoint (a pickle, or the JSON trial docs for a ``.json`` name),
    resumed when it exists; ``early_stop_fn(trials,
    *args) -> (stop, args)``.  ``device`` is where the suggest algorithms
    run (default CUDA; ``"cpu"`` runs them on the CPU).  ``max_queue_len``
    is how many trials one call of the algo proposes (TPE: one batch of
    its constant-liar scan); 1 proposes one trial at a time.  Returns the
    best point (``return_argmin``) or the best loss.

    ``overlap_depth=D`` runs the pipelined loop (``pipeline.py``): up to D
    suggest dispatches in flight, each with its copy to the host started
    at once (a pinned ``non_blocking`` copy and a CUDA event), while
    ``evaluators=E`` threads run the objective and record through a
    completion queue.  ``overlap_suggest=True`` is ``overlap_depth=1,
    evaluators=1`` and lands the trials of the depth-1 overlapped loop.
    The in-flight posterior is up to D batches stale; constant-liar rows
    for pending trials make up for it.  It needs a dispatch-capable algo
    (``tpe.suggest``, ``CohortScheduler.algo()``, optionally
    ``functools.partial``-bound); any other runs the ordinary loop.  With
    one evaluator the run is a function of ``rstate``.  Evaluator threads
    share the interpreter lock with the dispatch: an objective that
    releases it (sleep, I/O, card work) overlaps, pure Python does not.

    ``max_trial_retries=N`` runs a trial again on the same point, up to N
    times, when its evaluation raises a transient error
    (``exceptions.is_transient``: an injected fault,
    ``TransientEvaluationError``); ``misc.fail_count`` counts the retries.
    Default 0.

    A ``trials`` whose class has its own ``fmin`` (``parallel.PoolTrials``)
    runs the call through it, unless ``allow_trials_fmin=False``.

    ``trace_dir`` traces the run into that directory: span totals
    (``loop_trace.json``), the event log (``loop_events.jsonl`` and its
    Chrome export ``chrome_trace.json``) and the ``torch.profiler`` trace
    (``profiler_trace.json``: on CUDA every kernel launch, the EI kernel's
    included, and the kernels replayed from CUDA graphs).  In device mode
    the event log holds the telemetry slab's back-dated ``device_segment``
    spans in place of the hosted loop's.

    ``mode="device"`` (``None`` and ``"host"`` are the hosted loop) runs
    TPE and a torch objective on the device (``device.py``: the objective
    takes ``{label: 0-d float32 tensor}`` and returns a 0-d tensor, with
    torch ops only), one CUDA-graph replay per trial, and lands the trials
    in ``trials`` every ``sync_stride`` trials (``None``: once); the
    early-stop, timeout and loss-threshold checks run at those
    boundaries.  ``algo`` is then only a carrier of TPE keywords
    (``functools.partial(tpe.suggest, ...)``).  Host-loop options raise
    there: ``points_to_evaluate``, ``pass_expr_memo_ctrl``,
    ``catch_eval_exceptions``, ``trials_save_file``, ``max_queue_len >
    1``, the pipeline's and the retries' arguments, an asynchronous
    ``trials``, and algo keywords the device loop cannot honour
    (``resident``).
    """
    if mode not in (None, "host", "device"):
        raise ValueError(f"mode must be None, 'host' or 'device', got "
                         f"{mode!r}")
    if sync_stride is not None and mode != "device":
        raise ValueError("sync_stride only applies to mode='device'")
    dev = resolve_device(device)
    if algo is None:
        algo = "tpe"
    if isinstance(algo, str):
        # Names resolve through the backend registry; the callable form
        # works as in the reference.
        from .backends import contract as _backends

        algo = _backends.resolve(algo)
    if rstate is None:
        env_seed = os.environ.get("HYPEROPT_FMIN_SEED", "")
        rstate = np.random.default_rng(int(env_seed) if env_seed else None)
    elif isinstance(rstate, (int, np.integer)):
        rstate = np.random.default_rng(int(rstate))

    validate_timeout(timeout)
    validate_loss_threshold(loss_threshold)

    if trials_save_file and os.path.exists(trials_save_file) and trials is None:
        if trials_save_file.endswith(".json"):
            with open(trials_save_file) as f:
                payload = json.load(f)
            trials = base.trials_from_docs(payload["docs"],
                                           exp_key=payload.get("exp_key"))
        else:
            with open(trials_save_file, "rb") as f:
                trials = pickle.load(f)

    if trials is None:
        if points_to_evaluate is None:
            trials = Trials()
        else:
            if not isinstance(points_to_evaluate, list):
                raise ValueError("points_to_evaluate must be a list of dicts")
            trials = generate_trials_to_calculate(points_to_evaluate)

    if mode == "device":
        unsupported = [name for name, v in (
            ("points_to_evaluate", points_to_evaluate),
            ("pass_expr_memo_ctrl", pass_expr_memo_ctrl),
            ("catch_eval_exceptions", catch_eval_exceptions or None),
            ("overlap_suggest", overlap_suggest or None),
            ("overlap_depth", overlap_depth),
            ("evaluators", evaluators),
            ("max_trial_retries", max_trial_retries),
            ("trials_save_file", trials_save_file or None),
            ("max_queue_len", max_queue_len if max_queue_len != 1 else None),
        ) if v is not None]
        if unsupported:
            raise ValueError(
                "mode='device' runs the whole loop on the device; "
                "host-loop option(s) do not apply: "
                + ", ".join(unsupported))
        if max_evals is None:
            raise ValueError("mode='device' requires max_evals (the "
                             "captured loop needs a trial budget)")
        if getattr(trials, "asynchronous", False):
            raise ValueError("mode='device' evaluates on the device; "
                             "asynchronous Trials do not apply")
        algo_kw = _device_algo_kwargs(algo)
        from .device import fmin_trials as _device_fmin_trials

        with _traced(_tracer(trace_dir, dev)):
            _device_fmin_trials(
                fn, space, max_evals=max_evals, trials=trials,
                rstate=rstate, sync_stride=sync_stride,
                early_stop_fn=early_stop_fn, timeout=timeout,
                loss_threshold=loss_threshold,
                show_progressbar=show_progressbar and verbose, device=dev,
                **algo_kw)
        return _result(trials, return_argmin)

    if allow_trials_fmin and type(trials).fmin is not Trials.fmin:
        return trials.fmin(
            fn, space, algo=algo, max_evals=max_evals, timeout=timeout,
            loss_threshold=loss_threshold, rstate=rstate,
            pass_expr_memo_ctrl=pass_expr_memo_ctrl,
            verbose=verbose, catch_eval_exceptions=catch_eval_exceptions,
            return_argmin=return_argmin, show_progressbar=show_progressbar,
            early_stop_fn=early_stop_fn, trials_save_file=trials_save_file,
            max_trial_retries=max_trial_retries, trace_dir=trace_dir,
            device=device)

    domain = Domain(fn, space, pass_expr_memo_ctrl=pass_expr_memo_ctrl)
    domain.cs.device = dev

    rval = FMinIter(algo, domain, trials, rstate=rstate,
                    early_stop_fn=early_stop_fn,
                    trials_save_file=trials_save_file,
                    max_evals=max_evals, timeout=timeout,
                    loss_threshold=loss_threshold,
                    show_progressbar=show_progressbar and verbose,
                    verbose=verbose, max_queue_len=max_queue_len,
                    trace_dir=trace_dir,
                    overlap_suggest=overlap_suggest,
                    overlap_depth=overlap_depth, evaluators=evaluators,
                    max_trial_retries=max_trial_retries)
    rval.catch_eval_exceptions = catch_eval_exceptions
    rval.exhaust()
    rval._save_trials()
    return _result(trials, return_argmin)


def _result(trials, return_argmin):
    """``fmin``'s return value: the best point, or the best loss."""
    if return_argmin:
        if len(trials.trials) == 0:
            raise AllTrialsFailed(
                "There are no evaluation tasks, cannot return argmin of "
                "task losses.")
        return trials.argmin
    if len(trials) > 0:
        return trials.best_trial["result"]["loss"]
    return None


#: TPE keywords the device loop captures: the JAX package's, with the
#: port's lowering arguments (the JAX device loop reads those from its
#: environment toggles).
_DEVICE_ALGO_KEYS = frozenset((
    "gamma", "prior_weight", "n_startup_jobs", "n_EI_candidates",
    "linear_forgetting", "split", "multivariate", "cat_prior", "ei_impl",
    "ei_precision", "ei_topm", "comp_sampler"))


def _device_algo_kwargs(algo):
    """The TPE keywords that ``algo`` carries, for ``mode='device'``.

    The device loop does not call ``algo``; ``functools.partial(
    tpe.suggest, gamma=...)`` unwraps to ``{'gamma': ...}``, and
    ``tpe.suggest_quantile`` sets ``split='quantile'``.  ``verbose`` is
    dropped.  Anything but those two, a ``startup`` sampler other than
    random search (the captured step warm-starts with it), or a keyword the
    captured step cannot honour, raises: running another algorithm than
    the one named would be worse than failing."""
    from . import tpe as _tpe

    kw = {}
    fn_ = algo
    while isinstance(fn_, partial):
        if fn_.args:
            raise ValueError("mode='device': partial-bound positional algo "
                             "arguments are not supported")
        for k, v in (fn_.keywords or {}).items():
            kw.setdefault(k, v)
        fn_ = fn_.func
    if fn_ is _tpe.suggest_quantile:
        kw.setdefault("split", "quantile")
    elif fn_ is not _tpe.suggest:
        name = getattr(fn_, "__name__", repr(fn_))
        raise ValueError(
            f"mode='device' supports TPE only (tpe.suggest or "
            f"tpe.suggest_quantile, optionally functools.partial-bound); "
            f"got {name}. Run mode=None for other algorithms.")
    kw.pop("verbose", None)
    startup = kw.pop("startup", None)
    if startup not in (None, "rand"):
        raise ValueError(
            f"mode='device': startup={startup!r} is host-only; the captured "
            f"step warm-starts with the random sampler")
    bad = sorted(set(kw) - _DEVICE_ALGO_KEYS)
    if bad:
        raise ValueError(f"mode='device' cannot honor algo keyword(s) {bad}; "
                         f"supported: {sorted(_DEVICE_ALGO_KEYS)}")
    return kw


def validate_timeout(timeout):
    if timeout is not None and (not isinstance(timeout, numbers.Real)
                                or timeout <= 0):
        raise Exception(f"The timeout argument should be None or a positive "
                        f"value. Given value: {timeout}")


def validate_loss_threshold(loss_threshold):
    if loss_threshold is not None and not isinstance(loss_threshold,
                                                     numbers.Real):
        raise Exception(f"The loss_threshold argument should be None or a "
                        f"numeric value. Given value: {loss_threshold}")

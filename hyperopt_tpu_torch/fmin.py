"""``fmin``: the serial optimization loop and the public API.

Counterpart of ``hyperopt_tpu/fmin.py`` for the hosted, serial loop: up
to ``max_queue_len`` trials are suggested in one call of the algo (TPE
proposes a batch by its constant-liar scan), then evaluated in-process
and recorded.  The
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
and ``early_stop`` spans of each batch and writes ``loop_trace.json``,
``loop_events.jsonl``, ``chrome_trace.json`` and the ``torch.profiler``
export ``profiler_trace.json`` there; an exception escaping the loop
triggers the flight recorder when it is installed (``obs/flight.py``).
"""

from __future__ import annotations

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
from .exceptions import AllTrialsFailed
from .obs import context as _context
from .obs import flight as _flight
from .obs import metrics as _metrics
from .obs.events import EVENTS
from .obs.trace import NullTracer, Tracer
from .space import compile_space, resolve_device
from .utils.progress import default_callback, no_progress_callback

logger = logging.getLogger(__name__)


def space_eval(space, hp_assignment: dict):
    """Substitute a ``{label: value}`` assignment (as returned by ``fmin``
    or ``trials.argmin``; choice values are branch indices) into a space."""
    return compile_space(space).eval_point(hp_assignment)


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
    """The serial loop: suggest up to ``max_queue_len`` trials, evaluate
    them, record them, until ``max_evals`` trials are done or a stop
    condition fires."""

    catch_eval_exceptions = False
    pickle_protocol = -1

    def __init__(self, algo, domain, trials, rstate=None,
                 early_stop_fn=None, trials_save_file="", max_evals=None,
                 timeout=None, loss_threshold=None, show_progressbar=True,
                 max_queue_len=1, trace_dir=None):
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
        self.max_evals = max_evals
        self.timeout = timeout
        self.loss_threshold = loss_threshold
        self.start_time = time.time()
        self.show_progressbar = show_progressbar

    def serial_evaluate(self):
        reg = _metrics.registry()
        for trial in self.trials._dynamic_trials:
            if trial["state"] != JOB_STATE_NEW:
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
                    result = self.domain.evaluate(spec, ctrl)
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

    def run_one_batch(self):
        """Enqueue up to ``max_queue_len`` new trials from one call of the
        algo, then evaluate and record the queued ones.  Returns True when
        the algo is exhausted or early stop fired."""
        trials = self.trials
        stopped = False
        qlen = trials.count_by_state_unsynced((JOB_STATE_NEW,
                                               JOB_STATE_RUNNING))
        remaining = (self.max_evals - self.n_enqueued()
                     if self.max_evals is not None else self.max_queue_len)
        n_to_enqueue = min(self.max_queue_len - qlen, remaining)
        tracer = self.tracer
        if n_to_enqueue > 0:
            with tracer.span("suggest"):
                seed = int(self.rstate.integers(2 ** 31 - 1))
                new_ids = trials.new_trial_ids(n_to_enqueue)
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
        with tracer.span("evaluate"):
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
                stopped = True
        _metrics.registry().counter("fmin.batches").inc()
        return stopped

    def n_done(self):
        return self.trials.count_by_state_unsynced(
            (JOB_STATE_DONE, JOB_STATE_ERROR))

    def n_enqueued(self):
        return self.trials.count_by_state_unsynced(
            (JOB_STATE_NEW, JOB_STATE_RUNNING, JOB_STATE_DONE,
             JOB_STATE_ERROR))

    def _save_trials(self):
        if not self.trials_save_file:
            return
        tmp = f"{self.trials_save_file}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(self.trials, f, protocol=self.pickle_protocol)
        os.replace(tmp, self.trials_save_file)
        EVENTS.emit("store_flush", name="trials_save_file")

    def _loop(self):
        progress_ctx = default_callback if self.show_progressbar \
            else no_progress_callback
        with progress_ctx(initial=self.n_done(), total=self.max_evals) as prog:
            while not self._stopped(self.n_done()):
                before = self.n_done()
                stopped = self.run_one_batch()
                after = self.n_done()
                prog.update(after - before)
                try:
                    prog.postfix(self.trials.best_trial["result"]["loss"])
                except AllTrialsFailed:
                    pass
                if stopped or after == before:
                    break

    def exhaust(self):
        """Run until ``max_evals`` complete or a stop condition fires."""
        with _traced(self.tracer):
            t0 = time.perf_counter()
            try:
                self._loop()
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
         trials=None, rstate=None, pass_expr_memo_ctrl=None,
         catch_eval_exceptions=False,
         verbose=True, return_argmin=True,
         points_to_evaluate=None,
         show_progressbar=True, early_stop_fn=None,
         trials_save_file="", device=None, max_queue_len=1, mode=None,
         sync_stride=None, trace_dir=None):
    """Minimize ``fn`` over ``space`` using ``algo`` (default TPE).

    ``fn`` returns a float loss or a result dict with ``loss``/``status``;
    ``max_evals`` bounds the trials, ``timeout`` the wall-clock seconds;
    ``loss_threshold`` stops at a good-enough loss; ``rstate`` is a
    ``np.random.Generator`` or an int seed; ``points_to_evaluate`` is a
    list of ``{label: value}`` dicts run first; ``trials_save_file`` is a
    pickle checkpoint, resumed when it exists; ``early_stop_fn(trials,
    *args) -> (stop, args)``.  ``device`` is where the suggest algorithms
    run (default CUDA; ``"cpu"`` runs them on the CPU).  ``max_queue_len``
    is how many trials one call of the algo proposes (TPE: one batch of
    its constant-liar scan); 1 proposes one trial at a time.  Returns the
    best point (``return_argmin``) or the best loss.

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
    1``, and algo keywords the device loop cannot honour (``resident``).
    """
    if mode not in (None, "host", "device"):
        raise ValueError(f"mode must be None, 'host' or 'device', got "
                         f"{mode!r}")
    if sync_stride is not None and mode != "device":
        raise ValueError("sync_stride only applies to mode='device'")
    dev = resolve_device(device)
    if algo is None:
        from . import tpe

        algo = tpe.suggest
    if rstate is None:
        env_seed = os.environ.get("HYPEROPT_FMIN_SEED", "")
        rstate = np.random.default_rng(int(env_seed) if env_seed else None)
    elif isinstance(rstate, (int, np.integer)):
        rstate = np.random.default_rng(int(rstate))

    validate_timeout(timeout)
    validate_loss_threshold(loss_threshold)

    if trials_save_file and os.path.exists(trials_save_file) and trials is None:
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

    domain = Domain(fn, space, pass_expr_memo_ctrl=pass_expr_memo_ctrl)
    domain.cs.device = dev

    rval = FMinIter(algo, domain, trials, rstate=rstate,
                    early_stop_fn=early_stop_fn,
                    trials_save_file=trials_save_file,
                    max_evals=max_evals, timeout=timeout,
                    loss_threshold=loss_threshold,
                    show_progressbar=show_progressbar and verbose,
                    max_queue_len=max_queue_len, trace_dir=trace_dir)
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


#: TPE keywords the device loop captures: the JAX package's, without
#: ``multivariate`` (not ported), with the port's EI lowering arguments
#: (the JAX device loop reads those from its environment toggles).
_DEVICE_ALGO_KEYS = frozenset((
    "gamma", "prior_weight", "n_startup_jobs", "n_EI_candidates",
    "linear_forgetting", "split", "cat_prior", "ei_impl", "ei_precision",
    "ei_topm"))


def _device_algo_kwargs(algo):
    """The TPE keywords that ``algo`` carries, for ``mode='device'``.

    The device loop does not call ``algo``; ``functools.partial(
    tpe.suggest, gamma=...)`` unwraps to ``{'gamma': ...}``.  Anything but
    ``tpe.suggest``, or a keyword the captured step cannot honour, raises:
    running another algorithm than the one named would be worse than
    failing."""
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
    if fn_ is not _tpe.suggest:
        name = getattr(fn_, "__name__", repr(fn_))
        raise ValueError(
            f"mode='device' supports TPE only (tpe.suggest, optionally "
            f"functools.partial-bound); got {name}. Run mode=None for "
            f"other algorithms.")
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

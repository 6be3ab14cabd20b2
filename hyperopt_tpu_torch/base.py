"""Core runtime: trial documents, ``Trials``, ``Ctrl``, ``Domain``.

Counterpart of ``hyperopt_tpu/base.py``.  The trial-doc schema (``tid``,
``spec``, ``result``, ``misc.idxs/vals``, ``state``) and the ``Trials`` API
are the same, so docs move between the two packages unchanged
(:mod:`hyperopt_tpu_torch.convert`).  ``Trials.history()`` keeps a dense
struct-of-arrays mirror of the completed trials (numpy, host side) that the
suggest algorithms copy to their device in one piece.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import faults
from .exceptions import (
    AllTrialsFailed,
    InvalidLoss,
    InvalidResultStatus,
    InvalidTrial,
)
from .obs import trace as _trace
from .obs.metrics import registry as _metrics_registry
from .space import CompiledSpace, compile_space

JOB_STATE_NEW = 0
JOB_STATE_RUNNING = 1
JOB_STATE_DONE = 2
JOB_STATE_ERROR = 3
JOB_STATE_CANCEL = 4
JOB_STATES = (JOB_STATE_NEW, JOB_STATE_RUNNING, JOB_STATE_DONE,
              JOB_STATE_ERROR, JOB_STATE_CANCEL)

STATUS_NEW = "new"
STATUS_RUNNING = "running"
STATUS_SUSPENDED = "suspended"
STATUS_OK = "ok"
STATUS_FAIL = "fail"
STATUS_STRINGS = (STATUS_NEW, STATUS_RUNNING, STATUS_SUSPENDED,
                  STATUS_OK, STATUS_FAIL)

_TRIAL_KEYS = ("state", "tid", "spec", "result", "misc", "exp_key",
               "owner", "version", "book_time", "refresh_time")
_MISC_KEYS = ("tid", "cmd", "idxs", "vals")


def coarse_utcnow() -> float:
    """Second-resolution wall-clock timestamp."""
    return float(int(time.time()))


#: Granularity of :func:`coarse_utcnow`: a staleness check that compares a
#: coarse ``book_time``/``refresh_time`` against a clock allows this much
#: slop, or a doc booked late in a wall second looks up to a second older
#: than it is.
COARSE_CLOCK_SLOP_S = 1.0


def validate_trial_docs(docs):
    for doc in docs:
        for k in _TRIAL_KEYS:
            if k not in doc:
                raise InvalidTrial(f"trial missing key {k!r}: {doc}")
        if doc["state"] not in JOB_STATES:
            raise InvalidTrial(f"invalid state {doc['state']!r}")
        misc = doc["misc"]
        for k in _MISC_KEYS:
            if k not in misc:
                raise InvalidTrial(f"trial misc missing key {k!r}")
        if misc["tid"] != doc["tid"]:
            raise InvalidTrial(
                f"tid mismatch: doc {doc['tid']} vs misc {misc['tid']}")
        for label, idxs in misc["idxs"].items():
            vals = misc["vals"].get(label)
            if vals is None or len(idxs) != len(vals):
                raise InvalidTrial(
                    f"idxs/vals length mismatch for label {label!r}")
    return docs


def new_trial_doc(tid, exp_key=None, cmd=None):
    """Blank NEW-state trial document."""
    return {
        "state": JOB_STATE_NEW,
        "tid": tid,
        "spec": None,
        "result": {"status": STATUS_NEW},
        "misc": {"tid": tid, "cmd": cmd, "idxs": {}, "vals": {}},
        "exp_key": exp_key,
        "owner": None,
        "version": 0,
        "book_time": None,
        "refresh_time": None,
    }


def miscs_to_idxs_vals(miscs, keys=None):
    """Convert per-trial ``misc['idxs']/['vals']`` into per-variable columns."""
    if keys is None:
        if len(miscs) == 0:
            return {}, {}
        keys = list(miscs[0]["idxs"].keys())
    idxs = {k: [] for k in keys}
    vals = {k: [] for k in keys}
    for misc in miscs:
        for k in keys:
            idxs[k].extend(misc["idxs"].get(k, []))
            vals[k].extend(misc["vals"].get(k, []))
    return idxs, vals


def miscs_update_idxs_vals(miscs, idxs, vals, assert_all_vals_used=True):
    """Scatter per-variable columns back into per-trial misc dicts."""
    by_tid = {m["tid"]: m for m in miscs}
    for m in miscs:
        m["idxs"] = {k: [] for k in idxs}
        m["vals"] = {k: [] for k in idxs}
    for k, k_idxs in idxs.items():
        for tid, v in zip(k_idxs, vals[k]):
            if tid in by_tid:
                by_tid[tid]["idxs"][k].append(tid)
                by_tid[tid]["vals"][k].append(v)
            elif assert_all_vals_used:
                raise ValueError(f"unknown tid {tid} for label {k!r}")
    return miscs


def spec_from_misc(misc):
    """{label: scalar} point from one trial's misc (active params only)."""
    spec = {}
    for k, v in misc["vals"].items():
        if len(v) == 0:
            continue
        elif len(v) == 1:
            spec[k] = v[0]
        else:
            raise NotImplementedError("multiple values per label in one trial")
    return spec


def _doc_columns(cs: CompiledSpace):
    """``(label, pid, is_int)`` of every parameter in order, the columns a
    trial doc is built from.  Cached on the space: threads that compute it
    together all return the first one stored."""
    cols = cs.__dict__.get("_doc_columns")
    if cols is None:
        cols = cs.__dict__.setdefault("_doc_columns", tuple(
            (p.label, p.pid, p.is_int) for p in cs.params))
    return cols


def docs_from_samples(cs: CompiledSpace, new_ids, vals, active,
                      exp_key=None, cmd=None):
    """Package sampled rows into trial docs.

    ``vals``/``active`` are [n, P] host arrays; inactive parameters get empty
    idxs/vals lists (unchosen conditional branches).  The rows are read as
    Python lists once per call, so every value lands as a plain ``int`` or
    ``float``."""
    cols = _doc_columns(cs)
    vals = np.asarray(vals).tolist()
    active = np.asarray(active).tolist()
    docs = []
    for i, tid in enumerate(new_ids):
        row, act = vals[i], active[i]
        doc = new_trial_doc(tid, exp_key=exp_key, cmd=cmd)
        idxs_d, vals_d = {}, {}
        for label, pid, is_int in cols:
            if act[pid]:
                idxs_d[label] = [tid]
                v = row[pid]
                # round() not int(): f32 integer values can sit a ulp below.
                vals_d[label] = [int(round(v)) if is_int else float(v)]
            else:
                idxs_d[label] = []
                vals_d[label] = []
        doc["misc"]["idxs"] = idxs_d
        doc["misc"]["vals"] = vals_d
        docs.append(doc)
    return docs


# Rows Trials.history parsed from documents; made at import so that it
# reads 0 where nothing was parsed.
_ROWS_PARSED = _metrics_registry().counter("trials.rows_parsed")


def _parse_doc_row(tvals, cs, vals, active, i):
    """Fill row ``i`` of dense ``vals``/``active`` from one doc's
    ``misc.vals`` (shared by ``history`` and ``inflight``)."""
    for spec in cs.params:
        v = tvals.get(spec.label, [])
        if len(v):
            vals[i, spec.pid] = v[0]
            active[i, spec.pid] = True


class Trials:
    """In-memory trial database; the objective runs in-process.

    Synchronous (``asynchronous = False``): ``FMinIter`` evaluates the
    objective itself.  A subclass with ``asynchronous = True``
    (``parallel.PoolTrials``) evaluates the docs ``fmin`` enqueues on its
    own and is polled until they finish.  ``_lock`` (re-entrant) guards
    insertion, ``refresh``, the state counts and the dense views, which
    evaluator threads and the loop call concurrently."""

    asynchronous = False

    def __init__(self, exp_key=None, refresh=True):
        self._ids = set()
        self._dynamic_trials: List[dict] = []
        self._trials: List[dict] = []
        self._exp_key = exp_key
        self.attachments: Dict[str, Any] = {}
        self._lock = threading.RLock()
        self._soa_cache = None
        self._best_cache = None
        if refresh:
            self.refresh()

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_lock", None)
        state["_soa_cache"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.RLock()

    def __len__(self):
        return len(self._trials)

    def __iter__(self):
        return iter(self._trials)

    def __getitem__(self, item):
        return self._trials[item]

    @property
    def trials(self):
        return self._trials

    @property
    def tids(self):
        return [t["tid"] for t in self._trials]

    @property
    def specs(self):
        return [t["spec"] for t in self._trials]

    @property
    def results(self):
        return [t["result"] for t in self._trials]

    @property
    def miscs(self):
        return [t["misc"] for t in self._trials]

    @property
    def idxs_vals(self):
        return miscs_to_idxs_vals(self.miscs)

    @property
    def idxs(self):
        return self.idxs_vals[0]

    @property
    def vals(self):
        return self.idxs_vals[1]

    def _insert_trial_docs(self, docs) -> List[int]:
        self._dynamic_trials.extend(docs)
        return [d["tid"] for d in docs]

    def refresh(self):
        with self._lock:
            if self._exp_key is None:
                self._trials = list(self._dynamic_trials)
            else:
                self._trials = [t for t in self._dynamic_trials
                                if t["exp_key"] == self._exp_key]
            # _soa_cache survives: history() revalidates it by tid prefix.
            # best_trial does not: state flips mutate docs in place.
            self._best_cache = None

    def delete_all(self):
        """Remove every trial, and the device rings that held them
        (``history.forget``, which moves the wipe generation on: a reused
        tid cannot pass for a stale resident row)."""
        with self._lock:
            self._dynamic_trials = []
            self._trials = []
            self._ids = set()
            self.attachments = {}
            self._soa_cache = None
            self._best_cache = None
        from . import history

        history.forget(self)

    def insert_trial_doc(self, doc):
        return self.insert_trial_docs([doc])[0]

    def insert_trial_docs(self, docs):
        with self._lock:
            docs = validate_trial_docs(docs)
            for d in docs:
                if d["tid"] in self._ids:
                    raise InvalidTrial(f"duplicate tid {d['tid']}")
                self._ids.add(d["tid"])
            return self._insert_trial_docs(docs)

    def new_trial_ids(self, n):
        with self._lock:
            start = max(
                [t["tid"] for t in self._dynamic_trials] + [len(self._ids) - 1, -1]
            ) + 1
            return list(range(start, start + n))

    def count_by_state_synced(self, job_state, trials=None):
        if trials is None:
            trials = self._trials
        if isinstance(job_state, (tuple, list)):
            states = set(job_state)
        else:
            states = {job_state}
        return sum(1 for t in trials if t["state"] in states)

    def count_by_state_unsynced(self, job_state):
        with self._lock:
            if self._exp_key is not None:
                docs = [t for t in self._dynamic_trials
                        if t["exp_key"] == self._exp_key]
            else:
                docs = self._dynamic_trials
            return self.count_by_state_synced(job_state, trials=docs)

    def losses(self, bandit=None):
        return [r.get("loss") for r in self.results]

    def statuses(self, bandit=None):
        return [r.get("status") for r in self.results]

    @property
    def exp_key(self):
        return self._exp_key

    @property
    def best_trial(self):
        cached = self._best_cache
        if cached is not None:
            return cached
        candidates = [
            t for t in self._trials
            if t["state"] == JOB_STATE_DONE
            and t["result"].get("status") == STATUS_OK
            and t["result"].get("loss") is not None
        ]
        if not candidates:
            raise AllTrialsFailed("no successful trials with a loss yet")
        best = min(candidates, key=lambda t: t["result"]["loss"])
        self._best_cache = best
        return best

    @property
    def argmin(self):
        return spec_from_misc(self.best_trial["misc"])

    def average_best_error(self, bandit=None):
        """Mean loss of the ok trials within one standard deviation of the
        best, weighted by inverse ``loss_variance`` (hyperopt's
        ``Trials.average_best_error``)."""
        results = [r for r in self.results if r.get("status") == STATUS_OK]
        if not results:
            raise AllTrialsFailed("no ok trials")
        losses = np.asarray([r["loss"] for r in results], dtype=np.float64)
        variances = np.asarray(
            [max(r.get("loss_variance", 0.0), 1e-12) for r in results])
        cutoff = losses.min() + np.sqrt(variances[losses.argmin()])
        keep = losses <= cutoff
        return float(np.average(losses[keep], weights=1.0 / variances[keep]))

    def trial_attachments(self, trial):
        tid = trial["tid"]
        trials_self = self

        class _TrialAttachments:
            def __contains__(self, name):
                return f"ATTACH::{tid}::{name}" in trials_self.attachments

            def __getitem__(self, name):
                return trials_self.attachments[f"ATTACH::{tid}::{name}"]

            def __setitem__(self, name, value):
                trials_self.attachments[f"ATTACH::{tid}::{name}"] = value

            def __delitem__(self, name):
                del trials_self.attachments[f"ATTACH::{tid}::{name}"]

        return _TrialAttachments()

    def history(self, cs: CompiledSpace):
        """Dense view of completed trials for the suggest algorithms.

        Returns a dict of host numpy arrays:
          vals   f32[N, P]  parameter matrix (0 where inactive)
          active bool[N, P] liveness mask
          loss   f32[N]     losses (+inf where not ok)
          ok     bool[N]    status ok with a finite loss
          tids   i64[N]
        Rebuilt incrementally: only trials completed since the last call
        are parsed while the cached tid prefix still matches.  That parse
        is the span ``trials.parse`` (``obs/trace.py``), and the registry
        counter ``trials.rows_parsed`` counts its rows.
        """
        with self._lock:
            done = [t for t in self._trials if t["state"] == JOB_STATE_DONE]
            n, p = len(done), cs.n_params
            new_tids = np.asarray([t["tid"] for t in done], dtype=np.int64)
            start = 0
            if (self._soa_cache is not None and self._soa_cache[0] is cs
                    and len(self._soa_cache[1]["tids"]) <= n
                    and np.array_equal(
                        self._soa_cache[1]["tids"],
                        new_tids[: len(self._soa_cache[1]["tids"])])):
                old = self._soa_cache[1]
                start = len(old["tids"])
                if start == n:
                    return old
            vals = np.zeros((n, p), dtype=np.float32)
            active = np.zeros((n, p), dtype=bool)
            loss = np.full((n,), np.inf, dtype=np.float32)
            ok = np.zeros((n,), dtype=bool)
            if start:
                vals[:start] = old["vals"]
                active[:start] = old["active"]
                loss[:start] = old["loss"]
                ok[:start] = old["ok"]
            if n > start:
                with _trace.span("trials.parse"):
                    for i in range(start, n):
                        t = done[i]
                        r = t["result"]
                        if r.get("status") == STATUS_OK \
                                and r.get("loss") is not None \
                                and np.isfinite(r["loss"]):
                            loss[i] = r["loss"]
                            ok[i] = True
                        _parse_doc_row(t["misc"]["vals"], cs, vals, active,
                                       i)
                _ROWS_PARSED.inc(n - start)
            out = dict(vals=vals, active=active, loss=loss, ok=ok,
                       tids=new_tids)
            self._soa_cache = (cs, out)
            return out

    def inflight(self, cs: CompiledSpace):
        """Dense ``(vals f32[M, P], active bool[M, P])`` of NEW/RUNNING
        trials; TPE adds them to its history as constant-liar rows."""
        with self._lock:
            live = [t for t in self._trials
                    if t["state"] in (JOB_STATE_NEW, JOB_STATE_RUNNING)]
            m, p = len(live), cs.n_params
            vals = np.zeros((m, p), dtype=np.float32)
            active = np.zeros((m, p), dtype=bool)
            for i, t in enumerate(live):
                _parse_doc_row(t["misc"]["vals"], cs, vals, active, i)
            return vals, active

    def fmin(self, fn, space, algo, max_evals, **kwargs):
        from .fmin import fmin as _fmin
        return _fmin(fn, space, algo, max_evals, trials=self,
                     allow_trials_fmin=False, **kwargs)


def trials_from_docs(docs, validate=True, **kwargs):
    """Build a Trials object from a list of trial documents."""
    rval = Trials(**kwargs)
    if validate:
        rval.insert_trial_docs(docs)
    else:
        rval._dynamic_trials.extend(docs)
        rval._ids.update(d["tid"] for d in docs)
    rval.refresh()
    return rval


class Ctrl:
    """Job-to-runtime control handle, passed to the objective when
    ``fmin(..., pass_expr_memo_ctrl=True)``."""

    def __init__(self, trials: Trials, current_trial=None, workdir=None):
        self.trials = trials
        self.current_trial = current_trial
        self.workdir = workdir

    @property
    def attachments(self):
        if self.current_trial is None:
            return self.trials.attachments
        return self.trials.trial_attachments(self.current_trial)

    def checkpoint(self, result=None):
        """Write a partial ``result`` into the current trial."""
        if self.current_trial is not None and result is not None:
            self.current_trial["result"] = result
            self.current_trial["refresh_time"] = coarse_utcnow()

    def should_stop(self) -> bool:
        """Cooperative cancellation: a long objective polls this and
        returns early when it turns True.  ``parallel.PoolTrials`` rebinds
        it per trial; by default it never does."""
        return False


class Domain:
    """The user objective plus its compiled search space."""

    rec_eval_print_node_on_error = False

    def __init__(self, fn: Callable, expr, workdir=None,
                 pass_expr_memo_ctrl=None, name=None, loss_target=None):
        self.fn = fn
        self.expr = expr
        self.cs = compile_space(expr)
        self.params = {p.label: p for p in self.cs.params}
        self.workdir = workdir
        self.name = name
        self.loss_target = loss_target
        if pass_expr_memo_ctrl is None:
            self.pass_expr_memo_ctrl = getattr(
                fn, "fmin_pass_expr_memo_ctrl", False)
        else:
            self.pass_expr_memo_ctrl = pass_expr_memo_ctrl

    def memo_from_config(self, config: dict):
        """{label: value} assignment → the nested structure the user fn sees."""
        return self.cs.eval_point(config)

    def evaluate(self, config: dict, ctrl: Optional[Ctrl],
                 attach_attachments=True):
        """Run the objective on one configuration; normalize the result.
        A float result becomes ``{'loss': x, 'status': 'ok'}``; a dict
        result is validated.  The ``objective.call`` fault point fires
        first (``faults.py``)."""
        faults.maybe_fail("objective.call")
        if self.pass_expr_memo_ctrl:
            rval = self.fn(expr=self.expr,
                           memo=self.memo_from_config(config), ctrl=ctrl)
        else:
            rval = self.fn(self.memo_from_config(config))

        if isinstance(rval, (float, int, np.floating, np.integer)):
            loss = float(rval)
            if not np.isfinite(loss):
                raise InvalidLoss(f"non-finite loss {loss}")
            dict_rval = {"loss": loss, "status": STATUS_OK}
        elif isinstance(rval, dict):
            dict_rval = dict(rval)
            status = dict_rval.get("status")
            if status not in STATUS_STRINGS:
                raise InvalidResultStatus(f"invalid status {status!r}")
            if status == STATUS_OK:
                try:
                    dict_rval["loss"] = float(dict_rval["loss"])
                except (KeyError, TypeError, ValueError) as exc:
                    raise InvalidLoss(
                        "status ok requires a float 'loss'") from exc
                if not np.isfinite(dict_rval["loss"]):
                    raise InvalidLoss(f"non-finite loss {dict_rval['loss']}")
        else:
            raise InvalidResultStatus(
                f"objective returned {type(rval).__name__}; expected float or dict")

        if attach_attachments and ctrl is not None:
            attachments = dict_rval.pop("attachments", {})
            for k, v in attachments.items():
                ctrl.attachments[k] = v
        return dict_rval

    def short_str(self):
        return f"Domain{{{self.cs!r}}}"

    # The name some of hyperopt's call sites use.
    true_loss = staticmethod(lambda result, config=None: result.get(
        "true_loss", result.get("loss")))

"""Durable, elastic, multi-process trial store and its worker daemon.

Counterpart of ``hyperopt_tpu/parallel/filestore.py`` (the reference's
``mongoexp.py`` contract rebuilt on a shared directory), with the same
on-disk layout and JSON documents, so a store written by either package
reads back through the other's ``FileTrials`` with the same tids, states,
results and misc; only the pickled ``Domain`` is package-specific:

* one JSON document per trial under ``<root>/<exp_key>/trials/<tid>.json``;
* atomic job reservation by exclusive creation of a ``<tid>.claim``
  owner-stamp file (the POSIX form of Mongo's ``find_and_modify``);
* tid allocation by exclusive-create marker files under ``tids/``;
* the ``Domain`` travels to workers as ``domain.pkl`` in the experiment
  directory (its compiled space drops every kernel cache and device
  tensor when pickled, so a worker without a card loads a domain saved by
  a driver on one);
* attachments as one pickle per key under ``attachments/``;
* workers are stateless and elastic (``reserve_timeout``,
  ``max_consecutive_failures``); :meth:`FileTrials.requeue_stale` requeues
  the RUNNING trials of dead workers.

The console script ``hyperopt-tpu-torch-worker`` (:func:`main`, also
``python -m hyperopt_tpu_torch.parallel.filestore``) runs a
:class:`FileWorker`.  Fault schedules are an argument (``FileWorker(
faults=)``, ``--faults``), never read from the environment.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import socket
import time
from collections.abc import MutableMapping
from typing import Optional
from urllib.parse import quote, unquote

try:  # objectives pickle by value (lambdas, __main__ closures)
    import cloudpickle as _pickler
except ImportError:  # pragma: no cover
    _pickler = pickle

from .. import base
from .. import faults as _faults
from ..exceptions import is_transient
from ..obs import context as _context
from ..obs import metrics as _metrics
from ..obs.events import EVENTS
from ..base import (
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    Ctrl,
    Trials,
    coarse_utcnow,
)

logger = logging.getLogger(__name__)

_DOMAIN_FILE = "domain.pkl"
#: Slop of ``coarse_utcnow``'s whole-second stamps in the staleness test:
#: a doc booked late in a wall second looks up to a second older than it
#: is.
COARSE_CLOCK_SLOP_S = 1.0


def _atomic_write_json(path: str, obj) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{time.monotonic_ns()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class _FileAttachments(MutableMapping):
    """Durable mapping over a directory: one pickled file per key.

    Plays GridFS's role for attachments (the reference's ``MongoTrials``
    keeps them in GridFS): values a
    worker's ``Ctrl`` writes become visible to the driver (and to every other
    worker) through the shared store, and survive re-opening the experiment.

    Key files are prefixed ``k_`` + URL-quoted key; writes go through a
    ``t_``-prefixed temp file + ``os.replace`` so readers never observe a
    partial value.
    """

    def __init__(self, root: str):
        self.root = root

    def _path(self, name) -> str:
        return os.path.join(self.root, "k_" + quote(str(name), safe=""))

    def __setitem__(self, name, value):
        # makedirs only on write: reads against an archived/read-only store
        # must not try to mutate it.
        os.makedirs(self.root, exist_ok=True)
        path = self._path(name)
        tmp = os.path.join(self.root,
                           f"t_{os.getpid()}.{time.monotonic_ns()}")
        with open(tmp, "wb") as f:
            _pickler.dump(value, f)
        os.replace(tmp, path)

    def __getitem__(self, name):
        try:
            with open(self._path(name), "rb") as f:
                return pickle.load(f)
        except FileNotFoundError:
            raise KeyError(name) from None

    def __delitem__(self, name):
        try:
            os.unlink(self._path(name))
        except FileNotFoundError:
            raise KeyError(name) from None

    def __contains__(self, name):
        return os.path.exists(self._path(name))

    def __iter__(self):
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return iter(())
        return (unquote(n[2:]) for n in sorted(names) if n.startswith("k_"))

    def __len__(self):
        return sum(1 for _ in self)

    def clear(self):
        for n in list(self):
            del self[n]


class FileTrials(Trials):
    """Durable ``Trials`` over a shared directory (MongoTrials analog).

    ``asynchronous = True``: ``fmin`` only enqueues documents; evaluation is
    done by :class:`FileWorker` processes watching the same directory.
    """

    asynchronous = True

    def __init__(self, root: str, exp_key: str = "default", refresh=True):
        self.root = os.path.abspath(root)
        self._exp_dir = os.path.join(self.root, exp_key)
        self._trials_dir = os.path.join(self._exp_dir, "trials")
        self._tids_dir = os.path.join(self._exp_dir, "tids")
        os.makedirs(self._trials_dir, exist_ok=True)
        os.makedirs(self._tids_dir, exist_ok=True)
        # Incremental-refresh cache: filename -> (mtime_ns, size, doc).
        # Re-parse only files that changed; idle polls cost one scandir.
        self._doc_cache: dict = {}
        super().__init__(exp_key=exp_key, refresh=refresh)
        # Durable attachments (GridFS analog): rebind AFTER the base init's
        # plain-dict default so worker Ctrl writes land in the shared store
        # and survive re-opening the experiment.  ``trial_attachments``
        # namespaces per-trial keys into this same mapping (base.py).
        self.attachments = _FileAttachments(
            os.path.join(self._exp_dir, "attachments"))

    def __getstate__(self):
        state = super().__getstate__()
        state["_doc_cache"] = {}
        return state

    # -- document IO ---------------------------------------------------------

    def _doc_path(self, tid: int) -> str:
        return os.path.join(self._trials_dir, f"{tid}.json")

    def _claim_path(self, tid: int) -> str:
        return os.path.join(self._trials_dir, f"{tid}.claim")

    def _write_doc(self, doc) -> None:
        _faults.maybe_fail("store.write", tid=doc["tid"])
        _atomic_write_json(self._doc_path(doc["tid"]), doc)

    def _insert_trial_docs(self, docs):
        for d in docs:
            self._write_doc(d)
        return [d["tid"] for d in docs]

    def refresh(self):
        with self._lock:
            docs = []
            seen = set()
            for entry in os.scandir(self._trials_dir):
                name = entry.name
                if not name.endswith(".json"):
                    continue
                seen.add(name)
                try:
                    st = entry.stat()
                    key = (st.st_mtime_ns, st.st_size)
                    cached = self._doc_cache.get(name)
                    if cached is not None and cached[0] == key:
                        docs.append(cached[1])
                        continue
                    with open(entry.path) as f:
                        doc = json.load(f)
                    self._doc_cache[name] = (key, doc)
                    docs.append(doc)
                except (json.JSONDecodeError, OSError):
                    continue  # mid-replace read; next refresh catches it
            for stale in set(self._doc_cache) - seen:
                del self._doc_cache[stale]
            docs.sort(key=lambda d: d["tid"])
            self._dynamic_trials = docs
            self._ids = {d["tid"] for d in docs}
            self._trials = [d for d in docs
                            if self._exp_key in (None, d.get("exp_key"))]
            # Docs were re-read: Trials' cached best may be stale.
            self._best_cache = None

    def delete_all(self):
        """Remove every trial document, tid marker, claim and attachment of
        this experiment from the store (reference: ``MongoTrials.delete_all``
        removes the experiment's docs server-side)."""
        import shutil

        with self._lock:
            shutil.rmtree(self._exp_dir, ignore_errors=True)
            os.makedirs(self._trials_dir, exist_ok=True)
            os.makedirs(self._tids_dir, exist_ok=True)
            self._doc_cache = {}
            super().delete_all()   # rebinds attachments to a plain dict …
            self.attachments = _FileAttachments(      # … restore durability
                os.path.join(self._exp_dir, "attachments"))

    def new_trial_ids(self, n):
        out = []
        i = max(self._ids, default=-1) + 1
        while len(out) < n:
            try:
                fd = os.open(os.path.join(self._tids_dir, str(i)),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                out.append(i)
            except FileExistsError:
                pass
            i += 1
        return out

    # -- domain shipping (GridFS-attachment analog) --------------------------

    def save_domain(self, domain) -> None:
        path = os.path.join(self._exp_dir, _DOMAIN_FILE)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            _pickler.dump(domain, f)
        os.replace(tmp, path)

    def load_domain(self):
        with open(os.path.join(self._exp_dir, _DOMAIN_FILE), "rb") as f:
            return pickle.load(f)

    def put_domain_blob(self, blob: bytes) -> None:
        """Store the already-pickled domain bytes (a network store's
        server relays them without unpickling)."""
        path = os.path.join(self._exp_dir, _DOMAIN_FILE)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)

    def get_domain_blob(self) -> Optional[bytes]:
        try:
            with open(os.path.join(self._exp_dir, _DOMAIN_FILE), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def fmin(self, fn, space, algo, max_evals, **kwargs):
        from ..base import Domain
        try:
            self.save_domain(Domain(fn, space,
                                    pass_expr_memo_ctrl=kwargs.get(
                                        "pass_expr_memo_ctrl")))
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            # Unpicklable objective (lambda/closure): cross-process workers
            # must then be constructed with an explicit domain=...;
            # same-process workers are unaffected.
            logger.warning("objective not picklable (%s); workers must be "
                           "given the domain explicitly", e)
        return super().fmin(fn, space, algo, max_evals, **kwargs)

    # -- reservation (the race-safety mechanism) -----------------------------

    def reserve(self, owner: str) -> Optional[dict]:
        """Atomically claim one NEW trial for ``owner``; None if none left.

        The exclusive-create of the ``.claim`` file is the commit point —
        exactly one process can win it (reference: ``MongoJobs.reserve``'s
        ``find_and_modify`` NEW→RUNNING with owner stamp).
        """
        self.refresh()
        for doc in self._trials:
            if doc["state"] != JOB_STATE_NEW:
                continue
            try:
                fd = os.open(self._claim_path(doc["tid"]),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                # Another worker holds (or just won) this trial's claim:
                # the contention signal for sizing worker fleets.
                _metrics.registry().counter("store.claim.contended").inc()
                continue
            with os.fdopen(fd, "w") as f:
                f.write(owner)
            doc["state"] = JOB_STATE_RUNNING
            doc["owner"] = owner
            doc["book_time"] = coarse_utcnow()
            doc["refresh_time"] = doc["book_time"]
            self._write_doc(doc)
            _metrics.registry().counter("store.claim.won").inc()
            EVENTS.emit("store_claim", trial=doc["tid"], owner=owner)
            return doc
        return None

    def heartbeat(self, doc, owner: Optional[str] = None) -> bool:
        """Stamp a RUNNING trial as alive (so ``requeue_stale`` spares it).

        Owner-fenced like :meth:`write_result`: a presumed-dead worker whose
        trial was requeued must not resurrect its stale doc over the new
        claimant's state.

        A beat is a liveness stamp ONLY: the stored doc is re-read and just
        ``refresh_time`` is rewritten.  Writing the caller's snapshot back
        (as this method once did) let a beat in flight while
        ``write_result`` landed resurrect the pre-result RUNNING doc — a
        lost update that left the driver waiting forever on a trial its
        worker had already finished."""
        if owner is not None and not self.owns(doc, owner):
            # Name the fenced worker: the requeue/attribution story needs
            # to show WHO tried to beat on a claim they no longer hold.
            _metrics.registry().counter("store.heartbeat.fenced").inc()
            EVENTS.emit("store_heartbeat", trial=doc["tid"], owner=owner,
                        ok=False)
            return False
        with self._lock:
            try:
                with open(self._doc_path(doc["tid"])) as f:
                    cur = json.load(f)
            except (OSError, json.JSONDecodeError):
                return False
            if cur["state"] != JOB_STATE_RUNNING:
                # Finished (or requeued) while this beat was in flight:
                # nothing to keep alive, and nothing to overwrite.
                return cur["state"] in (JOB_STATE_DONE, JOB_STATE_ERROR)
            cur["refresh_time"] = coarse_utcnow()
            self._write_doc(cur)
            doc["refresh_time"] = cur["refresh_time"]
            # The claim file's mtime is the fine-grained freshness
            # authority (refresh_time is whole-second): touch it so the
            # janitor's staleness math sees the beat at full resolution.
            try:
                os.utime(self._claim_path(doc["tid"]))
            except OSError:
                pass
        return True

    def owns(self, doc, owner: str) -> bool:
        """True iff ``owner`` still holds the claim on ``doc``'s trial.

        A stale worker loses its claim when ``requeue_stale`` deletes the
        claim file (and another worker may have re-created it)."""
        try:
            with open(self._claim_path(doc["tid"])) as f:
                return f.read() == owner
        except FileNotFoundError:
            return False

    def write_result(self, doc, owner: Optional[str] = None) -> bool:
        """Publish a result; refuses (returns False) if ``owner`` no longer
        holds the claim — a requeued-and-reassigned trial must not be
        overwritten by the original (presumed-dead) worker's late write."""
        if owner is not None and not self.owns(doc, owner):
            logger.warning("dropping result for tid %s: claim lost by %s",
                           doc["tid"], owner)
            _metrics.registry().counter("store.write.fenced").inc()
            return False
        with self._lock:
            # Serialized against heartbeat's read-modify-write so an
            # in-process beat can never interleave with the result write
            # (the StoreServer handles both on concurrent threads).
            doc["refresh_time"] = coarse_utcnow()
            self._write_doc(doc)
        _metrics.registry().counter("store.write.ok").inc()
        EVENTS.emit("store_write", trial=doc["tid"],
                    state=doc.get("state"))
        return True

    def requeue_stale(self, timeout: float) -> int:
        """Requeue trials whose owner went silent for ``timeout`` seconds
        (the reference leaves them to manual cleanup).

        Two stale shapes: (a) RUNNING docs with no heartbeat for ``timeout``
        (worker died mid-evaluation); (b) NEW docs shadowed by an old orphan
        claim file (worker died between winning the claim and persisting the
        RUNNING doc) — those claims are cleared so ``reserve`` sees the trial
        again."""
        now = time.time()
        n = 0
        # The whole sweep holds the store lock (RLock: refresh/_write_doc
        # re-enter fine) so a concurrent reader can never observe a
        # requeued doc before the ``store.requeued`` counter reflects it —
        # the StoreServer's lock-free read path refreshes this instance
        # without taking the dispatch lock.
        with self._lock:
            self.refresh()
            for doc in self._trials:
                claim = self._claim_path(doc["tid"])
                if doc["state"] == JOB_STATE_RUNNING:
                    last = doc.get("refresh_time") or doc.get("book_time") or 0
                    # ``last`` is coarse (whole seconds) while ``now`` is
                    # not, so on its own it needs a full tick of slop or a
                    # doc booked late in a wall second is "stale" the
                    # instant it is reserved.  The claim file's mtime
                    # (stamped by reserve and every heartbeat) restores
                    # full resolution: prefer it when present.
                    slop = COARSE_CLOCK_SLOP_S
                    try:
                        mtime = os.stat(claim).st_mtime
                        if mtime >= last:
                            # mtime kept up with the beats: exact, no slop.
                            last, slop = mtime, 0.0
                    except OSError:
                        pass
                    if now - last > timeout + slop:
                        # Capture the abandoned owner BEFORE clearing it: the
                        # janitor's event log must name who went silent, or a
                        # chaos run's requeues are unattributable.
                        owner = doc.get("owner")
                        try:
                            os.unlink(claim)
                        except FileNotFoundError:
                            pass
                        doc["state"] = JOB_STATE_NEW
                        doc["owner"] = None
                        self._write_doc(doc)
                        n += 1
                        EVENTS.emit("store_requeue", trial=doc["tid"],
                                    owner=owner, reason="stale_heartbeat")
                elif doc["state"] == JOB_STATE_NEW:
                    try:
                        if now - os.stat(claim).st_mtime > timeout:
                            # Orphan claim (worker died between winning the
                            # claim and persisting RUNNING): the claim file
                            # itself is the only record of the owner — read
                            # it before the unlink destroys it.
                            try:
                                with open(claim) as f:
                                    owner = f.read()
                            except OSError:
                                owner = None
                            os.unlink(claim)
                            n += 1
                            EVENTS.emit("store_requeue", trial=doc["tid"],
                                        owner=owner, reason="orphan_claim")
                    except (FileNotFoundError, OSError):
                        pass
            if n:
                _metrics.registry().counter("store.requeued").inc(n)
                self.refresh()
        return n


class FileWorker:
    """Stateless evaluation daemon (reference: ``mongoexp.py::MongoWorker``).

    ``run_one``: reserve a job → reconstruct the Domain → evaluate → write
    the result.  ``run``: loop with ``poll_interval`` until ``reserve_timeout``
    elapses with nothing to do, or ``max_consecutive_failures`` trips.
    """

    def __init__(self, root, exp_key="default", domain=None,
                 poll_interval=0.1, reserve_timeout=None,
                 max_consecutive_failures=4, workdir=None,
                 heartbeat_interval=15.0, max_trial_retries=0,
                 trace_dir=None, faults=None, faults_seed=0):
        self.trials = self._make_trials(root, exp_key)
        # A fault schedule (faults.configure's spec) armed for this
        # process when run() starts: separately launched workers take
        # theirs as an argument.
        self.faults = faults
        self.faults_seed = int(faults_seed)
        # Observability: when set, run() arms the event log via a Tracer
        # and dumps loop_events.jsonl (+ chrome trace) here on exit.
        self.trace_dir = trace_dir
        self._domain = domain
        self.poll_interval = poll_interval
        self.reserve_timeout = reserve_timeout
        self.max_consecutive_failures = max_consecutive_failures
        self.workdir = workdir
        self.heartbeat_interval = heartbeat_interval
        # In-place re-evaluations of a claimed trial after a *transient*
        # failure (exceptions.is_transient) before it is marked ERROR.
        # The claim and heartbeat stay alive across attempts, so no other
        # worker can double-evaluate the point meanwhile.
        self.max_trial_retries = max(0, int(max_trial_retries))
        # uuid suffix: same-process workers (threads) must not share an
        # identity, or owns() could confuse their claims.
        import uuid
        self.owner = (f"{socket.gethostname()}:{os.getpid()}:"
                      f"{uuid.uuid4().hex[:8]}")

    @staticmethod
    def _make_trials(root, exp_key):
        """Store-binding hook: a network store's worker overrides this to
        run the same reserve/heartbeat/evaluate/write loop over its
        transport."""
        return FileTrials(root, exp_key=exp_key)

    @property
    def domain(self):
        if self._domain is None:
            self._domain = self.trials.load_domain()
        return self._domain

    def run_one(self) -> bool:
        """Reserve and evaluate one trial; False if the queue was empty."""
        import threading

        doc = self.trials.reserve(self.owner)
        if doc is None:
            return False
        ctrl = Ctrl(self.trials, current_trial=doc)
        # Heartbeat while the (arbitrarily long) objective runs, so
        # requeue_stale can tell a live worker from a crashed one.
        stop_hb = threading.Event()

        def _one_beat():
            try:
                self.trials.heartbeat(doc, owner=self.owner)
            except Exception:
                # Never let one failed beat kill the thread: the main
                # thread mutates ``doc`` concurrently, so serialization
                # can raise RuntimeError mid-iteration (not just OSError);
                # a silently-dead heartbeat would get a live trial
                # requeued as stale and evaluated twice.
                logger.debug("heartbeat skipped (tid %s)", doc["tid"],
                             exc_info=True)

        def _beat():
            # One immediate beat at claim time: announces liveness (and,
            # over a network store, piggybacks this worker's metrics)
            # even when trials finish faster than heartbeat_interval.
            _one_beat()
            while not stop_hb.wait(self.heartbeat_interval):
                _one_beat()

        hb = threading.Thread(target=_beat, daemon=True)
        hb.start()
        # Adopt the trial's trace context (doc["misc"]["trace"], stamped
        # by a traced driver at insert; falls back to the bare tid) for
        # the whole evaluation: every event below — and every RPC this
        # worker makes while evaluating — attaches to the originating
        # trial.  No-op shared context manager when tracing is disarmed.
        trace_ctx = _context.bind_doc(doc)
        trace_ctx.__enter__()
        try:
            EVENTS.emit("trial_start", trial=doc["tid"], owner=self.owner)
            if self.workdir:
                # Per-trial scratch dir, exposed via ctrl (NOT os.chdir —
                # workers may share a process as threads, and chdir is
                # process-global; the reference could chdir because each
                # MongoWorker job ran in its own subprocess).
                wd = os.path.join(self.workdir, str(doc["tid"]))
                os.makedirs(wd, exist_ok=True)
                ctrl.workdir = wd
            spec = base.spec_from_misc(doc["misc"])
            with EVENTS.span("evaluate", trial=doc["tid"]):
                while True:
                    try:
                        _faults.maybe_fail("worker.evaluate",
                                           tid=doc["tid"])
                        result = self.domain.evaluate(spec, ctrl)
                        break
                    except Exception as e:
                        fail_count = doc["misc"].get("fail_count", 0)
                        if not (is_transient(e)
                                and fail_count < self.max_trial_retries):
                            raise
                        doc["misc"]["fail_count"] = fail_count + 1
                        _metrics.registry().counter(
                            "worker.trial_retries").inc()
                        EVENTS.emit("trial_retry", trial=doc["tid"],
                                    attempt=fail_count + 1,
                                    error=type(e).__name__)
        except Exception as e:
            logger.error("worker job exception (tid %s): %s", doc["tid"], e)
            doc["state"] = JOB_STATE_ERROR
            doc["misc"]["error"] = (type(e).__name__, str(e))
            self.trials.write_result(doc, owner=self.owner)
            EVENTS.emit("trial_end", trial=doc["tid"], state="error",
                        error=type(e).__name__, owner=self.owner)
            raise
        else:
            doc["state"] = JOB_STATE_DONE
            doc["result"] = result
            ok = self.trials.write_result(doc, owner=self.owner)
            EVENTS.emit("trial_end", trial=doc["tid"], state="done",
                        loss=result.get("loss"), owner=self.owner)
            return ok
        finally:
            stop_hb.set()
            trace_ctx.__exit__(None, None, None)

    def run(self) -> int:
        """Serve jobs until idle past ``reserve_timeout``; returns #done."""
        _reg = _metrics.registry()
        if self.faults:
            _faults.configure(self.faults, seed=self.faults_seed)
        tracer = None
        if self.trace_dir:
            # Arm the event log (and cross-process context) for the
            # worker's lifetime; dump one lane's worth of events on exit.
            from ..obs.trace import Tracer
            tracer = Tracer(self.trace_dir)
            EVENTS.set_meta(worker_id=self.owner, role="worker")
        _reg.counter("worker.up").inc()
        EVENTS.emit("worker_up", name=self.owner)
        n_done = 0
        failures = 0
        idle_since = time.time()
        try:
            while True:
                try:
                    worked = self.run_one()
                except Exception:
                    failures += 1
                    _reg.gauge("worker.consecutive_failures").set(failures)
                    if failures >= self.max_consecutive_failures:
                        logger.error("worker exiting after %d consecutive "
                                     "failures", failures)
                        return n_done
                    worked = True  # the queue wasn't empty
                else:
                    if worked:
                        failures = 0
                        _reg.gauge("worker.consecutive_failures").set(0)
                        n_done += 1
                        _reg.counter("worker.trials").inc()
                if worked:
                    idle_since = time.time()
                else:
                    if (self.reserve_timeout is not None
                            and time.time() - idle_since
                            > self.reserve_timeout):
                        return n_done
                    time.sleep(self.poll_interval)
        finally:
            _reg.counter("worker.down").inc()
            EVENTS.emit("worker_down", name=self.owner, n_done=n_done)
            if tracer is not None:
                tracer.dump()


def main(argv=None):
    """CLI of the console script ``hyperopt-tpu-torch-worker`` (also
    ``python -m hyperopt_tpu_torch.parallel.filestore --root DIR ...``;
    the reference's ``hyperopt-mongo-worker``)."""
    import argparse

    p = argparse.ArgumentParser(
        description="hyperopt_tpu_torch file-store worker daemon")
    p.add_argument("--root", required=True, help="shared experiment root dir")
    p.add_argument("--exp-key", default="default")
    p.add_argument("--poll-interval", type=float, default=0.1)
    p.add_argument("--reserve-timeout", type=float, default=None,
                   help="exit after this many idle seconds")
    p.add_argument("--max-consecutive-failures", type=int, default=4)
    p.add_argument("--max-trial-retries", type=int, default=0,
                   help="in-place re-evaluations of a trial after a "
                        "transient failure before it is marked ERROR "
                        "(default 0 = fail fast)")
    p.add_argument("--workdir", default=None)
    p.add_argument("--trace-dir", default=None,
                   help="write this worker's loop_events.jsonl (+ chrome "
                        "trace) here on exit")
    p.add_argument("--faults", default=None,
                   help="fault schedule 'point=prob[:times][@after],...' "
                        "armed for this worker (faults.configure)")
    p.add_argument("--faults-seed", type=int, default=0)
    args = p.parse_args(argv)
    worker = FileWorker(args.root, exp_key=args.exp_key,
                        poll_interval=args.poll_interval,
                        reserve_timeout=args.reserve_timeout,
                        max_consecutive_failures=args.max_consecutive_failures,
                        max_trial_retries=args.max_trial_retries,
                        workdir=args.workdir, trace_dir=args.trace_dir,
                        faults=args.faults, faults_seed=args.faults_seed)
    n = worker.run()
    logger.info("worker done: %d trials evaluated", n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

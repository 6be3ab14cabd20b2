"""Suggestion-as-a-service: the WAL-backed, multi-tenant store server.

Counterpart of ``hyperopt_tpu/service/server.py``.  :class:`ServiceServer`
is the netstore's :class:`~..parallel.netstore.StoreServer` with three
substitutions (transport, auth, idempotency, fleet metrics and the
janitor are inherited):

* **stores are RAM**: each (tenant, exp_key) pair owns a
  :class:`~.store.MemTrials`; a verb is a dict operation, not a JSON
  file rewrite;
* **durability is the WAL**: every mutating verb is appended to
  ``wal.jsonl`` before it executes, under the dispatch lock, carrying the
  second-resolution clock the verb then runs with
  (``MemTrials.now_override``).  Recovery loads the snapshot and
  re-executes the tail records with their logged clocks, which rebuilds a
  byte-identical store (:meth:`state_bytes`);
* **suggest is decomposed**: a server-side ``suggest`` with insert is
  logged as its physical outcome (a ``new_trial_ids`` allocation record
  and an ``insert_docs`` record holding the proposed docs verbatim),
  never as "run the head again": replay never touches the card.

Quota checks run before the WAL append: a refused verb leaves no trace in
durable state.  The idempotency key of the original client call rides in
each record, and replay refills the exactly-once reply cache.

The cohort gate (``cohort_window_ms``, :class:`_CohortGate`) holds
concurrent tenants' suggests for the window and serves them from one
``fleet.CohortScheduler`` dispatch: one EI launch over ``31·L`` columns.
Lock order is ``_lock`` then ``device_lock``: the gate dispatches under
both and forces its rows under ``device_lock`` alone, so other verbs flow
while the card computes.

The JAX package's environment switches are arguments here:
``ServiceServer(columns=, group_commit=, wal_crash=)`` and the CLI's
``--no-columns``, ``--no-group-commit``, ``--wal-crash``, ``--faults``
and ``--flight-dir``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from .. import faults as _faults
from ..base import JOB_STATE_RUNNING, coarse_utcnow
from ..exceptions import ShardFenced
from ..obs import bundle as _obs_bundle
from ..obs import flight as _flight
from ..obs import metrics as _metrics
from ..obs.events import EVENTS
from ..parallel.netstore import StoreServer
from .store import MemTrials
from .wal import Wal, read_wal

logger = logging.getLogger(__name__)

__all__ = ["ServiceServer", "main"]

# Millisecond-unit histogram bounds (50µs .. ~26s, x2 per bucket), the
# convention of tpe's suggest.*_ms series.
_MS_BUCKETS = tuple(0.05 * (2.0 ** i) for i in range(20))


#: Suggest keywords a gated request may carry: the TPE knobs
#: ``fleet.CohortScheduler`` takes.  Members with equal knobs share a
#: scheduler built with them; any other keyword sends the request solo.
_GATE_KW = frozenset({
    "prior_weight", "n_startup_jobs", "n_EI_candidates", "gamma",
    "linear_forgetting", "split", "multivariate", "startup", "cat_prior"})


class _GateEntry:
    """One suggest call waiting at the cohort gate."""

    __slots__ = ("tname", "exp_key", "n", "seed", "algo", "kw", "rows",
                 "done")

    def __init__(self, tname, exp_key, n, seed, algo, kw):
        self.tname = tname
        self.exp_key = exp_key
        self.n = n
        self.seed = seed
        self.algo = algo
        self.kw = kw            # canonical JSON of the request's knobs
        self.rows = None
        self.done = False


class _CohortGate:
    """Hold concurrent tenants' ``suggest`` verbs for up to
    ``window_ms`` and serve the whole window from ONE fleet dispatch.

    Leader/follower protocol: the first suggest to arrive becomes the
    window leader and sleeps out the window on the gate condvar (lock
    released while waiting, so followers enqueue freely); at the
    deadline it snapshots every member's store under the server lock,
    runs one :class:`~hyperopt_tpu_torch.fleet.CohortScheduler` dispatch
    (under ``device_lock`` too), and hands each member its proposal rows,
    forced under ``device_lock`` alone.  Members that cannot batch (a
    keyword outside the scheduler's TPE knobs, a second call against the
    same (tenant, exp_key) inside one window, a window with fewer than
    two members) get ``None`` back and run the ordinary solo verb, so the
    gate only adds batching and never changes semantics: injected rows
    are bit-identical to the solo computation on the same history.
    Members carrying TPE knobs (``n_EI_candidates=`` ...) share a cohort
    with the members of equal knobs only; the JAX package's gate sends
    every request with a knob solo.  A dispatch that raises is logged and
    sends the whole window down the solo path.

    Every gated suggest pays up to ``window_ms`` of queueing (the
    ``fleet.window_wait_ms`` histogram) to buy one device dispatch per
    window instead of one per tenant.
    """

    def __init__(self, server, window_ms: float):
        self.server = server
        self.window_s = max(float(window_ms), 0.0) / 1e3
        self._cv = threading.Condition()
        self._batch: list[_GateEntry] = []
        self._leader = False
        self._scheds: dict = {}

    def _scheduler(self, algo: str, kw: str):
        """The CohortScheduler of one (algo, knobs) group, built lazily.
        Its knobs are the solo verb's (the head's defaults overridden by
        the request's knobs): that is what makes injected rows
        bit-identical to the fallback path.  Caller holds the server
        lock (``_compute``'s snapshot section is the only call site)."""
        sched = self._scheds.get((algo, kw))
        if sched is None:
            from .. import fleet
            split = "quantile" if algo == "tpe_quantile" else "sqrt"
            sched = self._scheds[algo, kw] = fleet.CohortScheduler(
                **dict({"split": split}, **json.loads(kw)))
        return sched

    def submit(self, req: dict, tenant):
        """Queue one suggest verb; block until its window's dispatch
        resolves.  Returns host proposal rows ``[n, P]`` or ``None``
        (caller runs the solo path)."""
        algo = req.get("algo", "tpe")
        knobs = {k: req[k] for k in StoreServer._SUGGEST_KW if k in req}
        if (algo not in ("tpe", "tpe_quantile") or "seed" not in req
                or not _GATE_KW.issuperset(knobs)):
            return None
        tname = getattr(tenant, "name", tenant)
        exp_key = req.get("exp_key", "default")
        nid = req.get("new_ids")
        n = len(nid) if nid is not None else int(req.get("n", 1))
        entry = _GateEntry(tname, exp_key, n, int(req["seed"]), algo,
                           json.dumps(knobs, sort_keys=True))
        t0 = time.perf_counter()
        with self._cv:
            if any(e.tname == tname and e.exp_key == exp_key
                   for e in self._batch):
                # Same store twice in one window: one lane = one history
                # snapshot, so the duplicate runs solo.
                return None
            self._batch.append(entry)
            if self._leader:
                # Follower: the leader will resolve this entry.
                limit = self.window_s * 4 + 30.0
                deadline = time.monotonic() + limit
                while not entry.done:
                    if not self._cv.wait(deadline - time.monotonic()):
                        try:    # leader wedged — bail out to solo
                            self._batch.remove(entry)
                        except ValueError:
                            pass
                        entry.done = True
                        break
                self._observe_wait(t0)
                return entry.rows
            self._leader = True
            deadline = time.monotonic() + self.window_s
            while True:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                self._cv.wait(rem)
            batch, self._batch = self._batch, []
            self._leader = False
        try:
            if len(batch) >= 2:
                self._compute(batch)
        except Exception:           # pragma: no cover - defensive
            logger.exception("cohort gate dispatch failed; falling back "
                             "to solo suggests")
            for e in batch:
                e.rows = None
        finally:
            with self._cv:
                for e in batch:
                    e.done = True
                self._cv.notify_all()
        self._observe_wait(t0)
        return entry.rows

    @staticmethod
    def _observe_wait(t0):
        _metrics.registry().histogram(
            "fleet.window_wait_ms", buckets=_MS_BUCKETS).observe(
                (time.perf_counter() - t0) * 1e3)

    def _compute(self, batch):
        """Snapshot member stores under the server lock and dispatch one
        fleet cohort per (algo, knobs) group under ``device_lock`` inside
        it (lock order ``_lock`` then ``device_lock``).  Row forcing (the
        device sync) happens outside the server lock, under
        ``device_lock`` alone, so other verbs keep flowing while the card
        computes and no introspecting ``health`` verb touches the
        cohort's programs meanwhile."""
        server = self.server
        groups: dict = {}
        with server._lock:
            for e in batch:
                try:
                    ft = server._store(e.exp_key, tenant=e.tname)
                    domain = server._domain_for(ft)
                    ft.refresh()
                except Exception:
                    continue            # no domain yet etc. → solo
                # Placeholder ids: proposal rows depend only on the id
                # count (ids are packaged into docs later, by the verb).
                groups.setdefault((e.algo, e.kw), []).append(
                    (e, (list(range(e.n)), domain, ft, e.seed)))
            handles = {}
            with server.device_lock:
                for (algo, kw), members in groups.items():
                    hs = self._scheduler(algo, kw).suggest_dispatch(
                        [r for _, r in members])
                    for (e, _), hd in zip(members, hs):
                        handles[id(e)] = hd
        from .. import tpe
        with server.device_lock:
            for e in batch:
                hd = handles.get(id(e))
                if hd is None:
                    continue
                if hd[0] == "fleet":
                    result, lane = hd[3]
                    e.rows = result.force()[lane][: e.n]
                else:
                    e.rows = tpe._force_rows(hd)[0]


def _strip_req(req: dict) -> dict:
    """The request as logged: drop the verb echo and the heartbeat's
    piggybacked fleet-metrics payload (ephemeral, and enormous) — replay
    only needs what changes store state."""
    return {k: v for k, v in req.items()
            if k not in ("verb", "metrics", "worker")}


class ServiceServer(StoreServer):
    """Multi-tenant, WAL-durable suggestion service.

    ``wal_dir`` holds ``wal.jsonl`` + ``snapshot.json`` and is the only
    thing that must survive a crash: a new ServiceServer pointed at the
    same directory replays to the exact pre-crash store.

    ``columns`` gives every store the columnar history
    (``MemTrials(columns=)``); ``group_commit`` and ``wal_crash`` go to
    the :class:`~.wal.Wal` (``Wal(group_commit=, crash=)``).
    """

    #: Verbs whose execution changes store state → append-before-execute.
    #: Reads (docs, get_domain, att_get/att_keys, metrics) bypass the log.
    _WAL_VERBS = frozenset({
        "insert_docs", "new_trial_ids", "reserve", "heartbeat",
        "write_result", "requeue_stale", "delete_all", "put_domain",
        "att_set", "att_del", "suggest", "store_fence", "store_import"})

    def __init__(self, wal_dir: str, host: str = "127.0.0.1", port: int = 0,
                 token: str | None = None, tenants=None,
                 fsync: str = "always", snapshot_every: int | None = None,
                 requeue_stale_every: float | None = None,
                 stale_timeout: float = 60.0,
                 cohort_window_ms: float | None = None,
                 scrape_interval: float | None = None,
                 slos=None, columns: bool = True,
                 group_commit: bool = True, wal_crash: str | None = None):
        self.wal_root = os.path.abspath(wal_dir)
        self._replaying = False
        self._columns = bool(columns)
        self._wal = Wal(self.wal_root, fsync=fsync,
                        group_commit=group_commit, crash=wal_crash)
        self._snapshot_every = snapshot_every
        self._snap_seq = 0
        # Fleet mode: hold concurrent tenants' suggests up to this many
        # milliseconds and serve the window from one cohort dispatch.
        # The window is kept so a fenced replica can arm its gate at
        # promotion time (replica.ShardServer._promote_verb).
        self._cohort_window_ms = cohort_window_ms
        self._cohort_gate = (_CohortGate(self, cohort_window_ms)
                             if cohort_window_ms else None)
        super().__init__(self.wal_root, host=host, port=port, token=token,
                         requeue_stale_every=requeue_stale_every,
                         stale_timeout=stale_timeout, tenants=tenants,
                         scrape_interval=scrape_interval, slos=slos)
        self._recover()
        # Flight-bundle WAL section: tail offsets + a content hash of
        # the live store state, so a postmortem can be cross-checked
        # against (and replayed from) the durable log it froze with.
        _obs_bundle.register_provider("wal", self._wal_bundle_section)

    def _wal_bundle_section(self) -> dict:
        with self._lock:
            return {"seq": self._wal.seq, "snap_seq": self._snap_seq,
                    "state_hash": _obs_bundle.state_hash(self.state_bytes())}

    # -- stores are RAM ------------------------------------------------------

    def _store(self, exp_key: str, tenant=None) -> MemTrials:
        tname = getattr(tenant, "name", tenant)
        key = (tname, exp_key)
        ft = self._trials.get(key)
        if ft is None:
            ft = self._trials[key] = MemTrials(exp_key=exp_key,
                                               columns=self._columns)
        return ft

    # -- append-before-execute dispatch --------------------------------------

    def _dispatch_verb(self, verb: str, req: dict, tenant=None,
                       idem=None) -> dict:
        if self._replaying or verb not in self._WAL_VERBS:
            return super()._dispatch_verb(verb, req, tenant=tenant,
                                          idem=idem)
        if verb == "suggest" and self._cohort_gate is not None:
            # Coalesce with concurrent tenants BEFORE taking the server
            # lock (the gate blocks up to the window).  Injected rows
            # turn the pure-compute step of _suggest_walled into doc
            # packaging; the WAL decomposition is unchanged.
            rows = self._cohort_gate.submit(req, tenant)
            if rows is not None:
                req = dict(req, _fleet_rows=rows)
        tname = getattr(tenant, "name", tenant)
        exp_key = req.get("exp_key", "default")
        with self._lock:
            # Migration fence gate BEFORE the append (same discipline as
            # the quota gates): a fenced store's refusal must leave no
            # durable trace, or replay would re-raise mid-recovery.
            if (self._store(exp_key, tenant=tname).fenced
                    and verb not in ("store_fence", "store_import")):
                _metrics.registry().counter("store.fenced").inc()
                raise ShardFenced(
                    f"store {exp_key!r} is fenced (migrating): "
                    f"refusing {verb!r}")
            t = coarse_utcnow()
            seq0 = self._wal.seq
            if verb == "suggest":
                out = self._suggest_walled(req, tenant, tname, exp_key,
                                           idem, t)
            else:
                # Quota gates mirror the base dispatch but run BEFORE the
                # append — a refused verb must leave no durable trace.
                if verb == "insert_docs":
                    self._charge_admission(tenant, len(req["docs"]))
                if verb == "reserve" and self._claims_quota_hit(tenant):
                    return {"doc": None, "quota": "max_claims"}
                self._wal.append({"t": t, "verb": verb, "tenant": tname,
                                  "exp_key": exp_key, "req": _strip_req(req),
                                  "idem": idem})
                out = self._execute(verb, req, tenant, t)
                self._maybe_snapshot()
            seq = self._wal.seq
        # Group commit: the ack gate.  Outside the dispatch lock so other
        # verbs append while the leader's fsync covers this record; a
        # no-op when group commit is off or nothing was appended
        # (proposal-only suggest, quota refusals).
        if seq > seq0:
            self._wal.wait_durable(seq)
        return out

    def _execute(self, verb: str, req: dict, tenant, t: float) -> dict:
        """Run the verb with the WAL record's clock.  The tenant is
        passed down as its bare NAME: the store key resolves identically,
        and the duck-typed quota hooks (absent on a string) are skipped —
        quotas were already charged before the append, and replay has no
        quota context by design."""
        tname = getattr(tenant, "name", tenant)
        ft = self._store(req.get("exp_key", "default"), tenant=tname)
        ft.now_override = t
        try:
            return super()._dispatch_verb(verb, req, tenant=tname)
        finally:
            ft.now_override = None

    def _suggest_walled(self, req: dict, tenant, tname, exp_key,
                        idem, t: float) -> dict:
        """Server-side suggest, decomposed into physical records.

        The id allocation (when the server picks the ids) and the insert
        (when requested) each get their own WAL record; the TPE/algo
        computation itself is NOT logged — its outcome (the docs) is.
        The insert record carries the client call's idempotency key plus
        an ``orig: suggest`` marker so replay can reconstruct the
        original reply for the dedup cache.
        """
        req = dict(req)
        new_ids = req.get("new_ids")
        if new_ids is None:
            insert = bool(req.get("insert", True))
            alloc = {"exp_key": exp_key, "n": int(req.get("n", 1))}
            self._wal.append({"t": t, "verb": "new_trial_ids",
                              "tenant": tname, "exp_key": exp_key,
                              "req": alloc, "idem": None})
            new_ids = self._execute("new_trial_ids", alloc, tenant,
                                    t)["tids"]
            req["new_ids"] = new_ids
        else:
            insert = bool(req.get("insert", False))
            new_ids = [int(x) for x in new_ids]
        req["insert"] = False
        out = self._execute("suggest", req, tenant, t)   # pure compute
        docs, tids = out["docs"], list(new_ids)
        if insert and docs:
            self._charge_admission(tenant, len(docs))
            ins = {"exp_key": exp_key, "docs": docs}
            self._wal.append({"t": t, "verb": "insert_docs",
                              "tenant": tname, "exp_key": exp_key,
                              "req": ins, "idem": idem,
                              "orig": "suggest"})
            tids = self._execute("insert_docs", ins, tenant, t)["tids"]
        self._maybe_snapshot()
        return {"docs": docs, "tids": tids, "inserted": bool(insert)}

    # -- janitor through the log ---------------------------------------------

    def _janitor_pass(self):
        """Requeue stale claims *through the WAL dispatch* so replay
        reproduces the janitor's decisions (a peek avoids logging no-op
        passes every period)."""
        wakes = []
        with self._lock:
            for (tname, exp_key), ft in list(self._trials.items()):
                now = coarse_utcnow()
                stale = any(
                    d["state"] == JOB_STATE_RUNNING
                    and now - (d.get("refresh_time")
                               or d.get("book_time") or 0)
                    > self.stale_timeout
                    for d in ft._by_tid.values())
                if not stale:
                    continue
                out = self._dispatch_verb(
                    "requeue_stale",
                    {"exp_key": exp_key, "timeout": self.stale_timeout},
                    tenant=tname)
                if out["n"]:
                    logger.info("service janitor: requeued %d stale "
                                "trial(s) in %s/%r", out["n"],
                                tname or "-", exp_key)
                    wakes.append((tname, exp_key))
        for tname, exp_key in wakes:
            # Outside the dispatch lock: a woken long-poll reserve
            # re-dispatches immediately and must not contend with the
            # janitor still holding it.
            self._signal_claims(tname, exp_key)

    # -- snapshot / recovery -------------------------------------------------

    def state_payload(self) -> dict:
        """Everything a snapshot persists: each store's canonical state
        plus the idempotency reply cache (keys + payloads; ages restart
        fresh on load — a crash must not shorten a retry's dedup
        window)."""
        with self._lock:
            stores = []
            for key in sorted(self._trials,
                              key=lambda k: (k[0] or "", k[1])):
                tname, exp_key = key
                state = self._trials[key].state_dict()
                if not (state["docs"] or state["allocated"]
                        or state["claims"] or state["domain_blob"]
                        or state["attachments"] or state.get("fenced")):
                    # A store only ever touched by reads: semantically
                    # absent — replay of the (write-only) log would not
                    # recreate it, and it must not break byte-identity.
                    continue
                stores.append({"tenant": tname, "exp_key": exp_key,
                               "state": state})
            with self._idem_lock:
                idem = [[list(k), payload]
                        for k, (_, payload) in self._idem.items()]
            return {"stores": stores, "idem": idem}

    def state_bytes(self) -> bytes:
        """Canonical bytes of all store state (NOT the idem cache, whose
        eviction clock is wall-time-dependent): two servers are
        byte-identical iff these are equal — the replay acceptance bar.
        """
        payload = {"stores": self.state_payload()["stores"]}
        return json.dumps(payload, sort_keys=True).encode()

    def snapshot(self) -> None:
        """Persist current state and truncate the log (compaction)."""
        with self._lock:
            self._wal.snapshot(self.state_payload())
            self._snap_seq = self._wal.seq

    def _maybe_snapshot(self) -> None:
        if (self._snapshot_every
                and self._wal.seq - self._snap_seq >= self._snapshot_every):
            self.snapshot()

    def _load_state_payload(self, payload: dict) -> None:
        """Install a full state payload (stores + idem cache) — the
        snapshot half of recovery, and the replica's
        ``snapshot_install`` verb.  Caller holds the lock (or runs
        pre-start recovery, before any thread can race it)."""
        self._trials.clear()
        for s in payload.get("stores", []):
            ft = self._store(s["exp_key"], tenant=s.get("tenant"))
            ft.load_state(s["state"])
        with self._idem_lock:
            self._idem.clear()
            for k, reply in payload.get("idem", []):
                self._idem[tuple(k)] = (time.monotonic(), reply)

    def _apply_record(self, rec: dict) -> dict:
        """Re-execute one WAL record via the deterministic replay path:
        the record's logged clock, the tenant as its bare name (quota
        hooks absent by design), and the idempotency cache repopulated
        from the outcome.  Caller holds the lock and has set
        ``_replaying`` — recovery and the replica's ``wal_ship`` apply
        both funnel through here, which is what keeps a replayed store
        and a replicated store byte-identical."""
        tname = rec.get("tenant")
        req = dict(rec["req"], exp_key=rec["exp_key"])
        ft = self._store(rec["exp_key"], tenant=tname)
        ft.now_override = rec["t"]
        try:
            out = self._dispatch_verb(rec["verb"], req, tenant=tname)
        finally:
            ft.now_override = None
        if rec.get("idem"):
            if rec.get("orig") == "suggest":
                # Reconstruct the client-visible suggest reply from
                # the physical insert record.
                out = {"docs": rec["req"]["docs"],
                       "tids": out["tids"], "inserted": True}
            self._idem_put((tname, rec["exp_key"], rec["idem"]),
                           json.dumps(out))
        return out

    def _recover(self) -> None:
        snap, records, n_torn = read_wal(self.wal_root)
        if snap is None and not records:
            return
        reg = _metrics.registry()
        if snap is not None:
            self._load_state_payload(snap)
            self._wal.seq = snap["seq"]
        self._replaying = True
        try:
            for rec in records:
                _faults.maybe_fail("wal.replay", verb=rec["verb"])
                self._apply_record(rec)
                self._wal.seq = rec["seq"]
                reg.counter("wal.replayed").inc()
        finally:
            self._replaying = False
        self._snap_seq = self._wal.seq if snap is None else snap["seq"]
        logger.info("service: recovered %d store(s), replayed %d "
                    "record(s), %d torn tail line(s) dropped",
                    len(self._trials), len(records), n_torn)
        EVENTS.emit("wal_recover", replayed=len(records), torn=n_torn)

    def shutdown(self):
        super().shutdown()
        _obs_bundle.unregister_provider("wal")
        self._wal.close()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _add_durability_args(p) -> None:
    """The switches the server and shard CLIs share: the store columns,
    group commit, the WAL crash mode and a fault schedule."""
    p.add_argument("--no-columns", action="store_true",
                   help="stores walk their docs for history/inflight "
                        "instead of keeping columns")
    p.add_argument("--no-group-commit", action="store_true",
                   help="fsync=always fsyncs inside each append")
    p.add_argument("--wal-crash", default=None, choices=("kill",),
                   help="an injected wal.write/wal.fsync fault SIGKILLs "
                        "this process (chaos drills)")
    p.add_argument("--faults", default=None,
                   help="fault schedule 'point=prob[:times][@after],...' "
                        "armed in this process (faults.configure)")
    p.add_argument("--faults-seed", type=int, default=0)


def _arm_faults(args) -> None:
    if args.faults:
        _faults.configure(args.faults, seed=args.faults_seed)


def _durability_kwargs(args) -> dict:
    return {"columns": not args.no_columns,
            "group_commit": not args.no_group_commit,
            "wal_crash": args.wal_crash}


def main(argv=None):
    """``python -m hyperopt_tpu_torch.service.server --serve --wal-dir
    DIR``: host a WAL-durable multi-tenant suggestion service (recovers
    from DIR on start; SIGTERM-graceful like the plain netstore)."""
    import argparse

    p = argparse.ArgumentParser(
        description="hyperopt_tpu_torch suggestion service (WAL-durable, "
                    "multi-tenant netstore)")
    p.add_argument("--serve", action="store_true", required=True,
                   help="serve --wal-dir on --host:--port")
    p.add_argument("--wal-dir", required=True,
                   help="durability directory (wal.jsonl + snapshot.json); "
                        "the only state that must survive a crash")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8418)
    p.add_argument("--token", default=None,
                   help="single shared secret (ignored when "
                        "--tenants-file is given)")
    p.add_argument("--tenants-file", default=None,
                   help="JSON tenant table: [{name, token, max_claims, "
                        "trials_per_s, burst}, ...] — enables "
                        "multi-tenant auth + quotas")
    p.add_argument("--fsync", default="always",
                   choices=("always", "batch", "never"),
                   help="WAL durability/throughput knob")
    p.add_argument("--snapshot-every", type=int, default=None, metavar="N",
                   help="compact the WAL into a snapshot every N appends "
                        "(default: only on demand)")
    p.add_argument("--requeue-stale-every", type=float, default=None,
                   metavar="S")
    p.add_argument("--stale-timeout", type=float, default=60.0)
    p.add_argument("--cohort-window-ms", type=float, default=None,
                   metavar="MS",
                   help="fleet mode: hold concurrent tenants' suggest "
                        "verbs up to MS and serve each window from one "
                        "cohort dispatch (0/unset: off)")
    p.add_argument("--scrape-interval", type=float, default=None,
                   metavar="S",
                   help="observability: scrape the metrics registry "
                        "into the in-process time-series store every S "
                        "seconds and evaluate SLO burn-rate alerts + "
                        "health verdicts (unset: off, zero overhead)")
    p.add_argument("--flight-dir", default=None,
                   help="arm the flight recorder: freeze a postmortem "
                        "bundle here on SLO alert fire, unhandled verb "
                        "error or SIGTERM (default: off)")
    _add_durability_args(p)
    args = p.parse_args(argv)
    _arm_faults(args)

    tenants = None
    if args.tenants_file:
        from .tenancy import TenantTable
        tenants = TenantTable.from_file(args.tenants_file)

    server = ServiceServer(args.wal_dir, host=args.host, port=args.port,
                           token=args.token, tenants=tenants,
                           fsync=args.fsync,
                           snapshot_every=args.snapshot_every,
                           requeue_stale_every=args.requeue_stale_every,
                           stale_timeout=args.stale_timeout,
                           cohort_window_ms=args.cohort_window_ms,
                           scrape_interval=args.scrape_interval,
                           **_durability_kwargs(args))
    print(f"service: serving {args.wal_dir} at {server.url}", flush=True)

    import signal

    def _on_sigterm(signo, frame):
        raise SystemExit(0)

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:              # not the main thread (embedded use)
        pass
    # Arm AFTER the SIGTERM handler so the flight handler chains it:
    # a TERM first freezes the bundle, then the graceful exit runs.
    flight_dir = _flight.install(args.flight_dir)
    if flight_dir:
        print(f"service: flight recorder armed -> {flight_dir}", flush=True)
    try:
        server.serve_forever()
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        server.shutdown()
        print("service: shut down", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

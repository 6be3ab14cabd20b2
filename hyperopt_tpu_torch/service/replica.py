"""Warm replication for service shards: WAL shipping, scrub, promote.

Counterpart of ``hyperopt_tpu/service/replica.py``; the JAX package's
environment switches are arguments here: ``WalShipper(batch=,
scrub_interval=)``, ``ShardServer(ship_batch=, scrub_interval=)`` and the
CLI's ``--scrub-interval`` and ``--flight-dir``.

:class:`ShardServer` is a :class:`~.server.ServiceServer` with a fleet
**role**:

* ``primary`` — serves clients normally and, when a replica is
  attached, ships every WAL append (snapshot + tail, the same records
  ``wal.jsonl`` holds) to it over the ordinary token-gated verb RPC;
* ``replica`` — applies shipped records through the deterministic
  replay path (logged clocks, quota hooks absent, idempotency cache
  repopulated) and **fences** client mutating verbs until promoted, so
  a misdirected write can never fork the store.

Byte-identity is the correctness bar, same as recovery: a replica that
has applied the primary's log prefix up to seq S has *exactly* the
primary's ``state_bytes()`` at S.  The shipper continuously proves it —
every ``scrub_interval`` seconds it asks the replica for its
``(seq, state hash)`` via the ``scrub`` verb and compares against its
own at the same seq (divergence bumps ``replica.scrub.mismatch``,
emits an event, and freezes a flight bundle; agreement bumps
``replica.scrub.ok``).

Failover is the idempotency machinery doing its job end to end: the
router promotes the replica (``promote`` verb), a client's in-flight retry
lands there carrying its original idempotency key, and either the
shipped record already repopulated the reply cache (the verb executed
before the primary died → the retry dedupes) or it never reached the
log (→ the retry executes for the first time).  Both timelines contain
the verb exactly once.

**Chained replication**: a replica can itself ship onward — attach a
downstream target to it (``--replicate-to`` or the ``replica_attach``
verb) and every ``wal_ship`` batch it applies re-appends locally, which
fires the same WAL listener the primary uses and forwards the records
down the chain (P→R1→R2→…).  The primary's fan-out cost is O(1) in the
replication factor; gap detection and snapshot resync work hop-by-hop
(R2 missing records asks R1, never the primary), and the scrub verb
proves byte-identity at EVERY hop because each link runs the identical
apply path.

A whole-shard **fence** (the ``fence`` verb) quiesces a primary for a
bounded cutover: mutating client verbs get the typed retriable
:class:`~hyperopt_tpu_torch.exceptions.ShardFenced` redirect, parked
long-poll claimants are woken immediately (they must not doze out the
cutover window), and replication/control verbs keep flowing so the
handoff itself can finish.
"""

from __future__ import annotations

import json
import logging
import threading
import time

from collections import deque

from .. import faults as _faults
from ..exceptions import InjectedFault, NetstoreUnavailable, ShardFenced
from ..obs import bundle as _obs_bundle
from ..obs import flight as _flight
from ..obs import metrics as _metrics
from ..obs.events import EVENTS
from .server import ServiceServer

logger = logging.getLogger(__name__)

__all__ = ["ShardServer", "WalShipper", "main"]

#: Replication/cutover verbs a ShardServer answers itself; everything
#: else runs the inherited WAL dispatch (mutations fenced while
#: role=replica, or while a whole-shard ``fence`` is up).
_REPLICATION_VERBS = frozenset({
    "wal_ship", "snapshot_install", "scrub", "promote", "replica_attach",
    "fence"})


#: ``WalShipper`` defaults: records per ``wal_ship`` RPC, and the period
#: (s) of the byte-identity scrub (0 disables it).
DEFAULT_SHIP_BATCH = 256
DEFAULT_SCRUB_INTERVAL_S = 5.0


class WalShipper:
    """Primary-side shipping loop for ONE replica target.

    ``Wal.append`` hands every record (seq already stamped) to
    :meth:`enqueue` under the dispatch lock — O(1), no IO — and a
    daemon thread drains the queue in log order, batching up to
    ``batch`` records per ``wal_ship`` RPC.  First
    contact (and any gap the replica reports) re-ships a full state
    snapshot (``snapshot_install``) taken consistently with its seq
    under the server lock, then resumes the tail — the same
    snapshot+tail pair recovery reads from disk, sent over the wire.

    Transport failures keep the records queued and retry with backoff;
    the ``replica.ship`` fault point injects failures here for chaos
    drills.  ``flush()`` blocks until the replica has acked everything
    enqueued so far (tests and the rebalance cutover use it).
    """

    def __init__(self, server, url: str, token: str | None = None,
                 batch: int | None = None,
                 scrub_interval: float | None = None):
        from ..parallel.netstore import _Rpc
        self.server = server
        self.url = url.rstrip("/")
        self._rpc = _Rpc(self.url, "__replica__", token=token)
        self.batch = int(batch) if batch else DEFAULT_SHIP_BATCH
        self.scrub_interval = (DEFAULT_SCRUB_INTERVAL_S
                               if scrub_interval is None
                               else float(scrub_interval))
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._tail_seq = 0        # last seq enqueued
        self._acked_seq = 0       # last seq the replica acked
        self._need_snapshot = True
        self._stop = False
        self._last_scrub = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"wal-shipper-{self.url.rsplit(':', 1)[-1]}")
        # Started via start() once the server has published this shipper
        # into its fan-out list: starting from __init__ would let the
        # first snapshot ship race the attach critical section, and a
        # record appended between that snapshot and publication would be
        # neither snapshotted nor enqueued.

    def start(self) -> "WalShipper":
        self._thread.start()
        return self

    # -- producer side (dispatch thread) -------------------------------------

    def enqueue(self, rec: dict) -> None:
        """Queue one appended record.  Caller holds the server dispatch
        lock — this must stay O(1) with no IO."""
        with self._cv:
            self._queue.append(rec)
            self._tail_seq = max(self._tail_seq, int(rec["seq"]))
            self._cv.notify_all()

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until everything enqueued so far is acked (or timeout).
        Returns whether the replica is fully caught up."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while (self._need_snapshot
                   or self._acked_seq < self._tail_seq):
                rem = deadline - time.monotonic()
                if rem <= 0 or self._stop:
                    return False
                self._cv.wait(min(rem, 0.25))
            return True

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread.ident is not None:
            self._thread.join(timeout=5.0)

    # -- shipping thread -----------------------------------------------------

    def _run(self) -> None:
        reg = _metrics.registry()
        backoff = 0.05
        while True:
            with self._cv:
                while (not self._stop and not self._queue
                       and not self._need_snapshot
                       and not self._scrub_due()):
                    self._cv.wait(0.25)
                if self._stop:
                    return
                need_snap = self._need_snapshot
                batch = []
                while self._queue and len(batch) < self.batch:
                    batch.append(self._queue.popleft())
            try:
                if need_snap:
                    self._ship_snapshot()
                    with self._cv:
                        # Drop queued records the snapshot folded in.
                        batch = [r for r in batch
                                 if r["seq"] > self._acked_seq]
                if batch:
                    self._ship_batch(batch)
                backoff = 0.05
            except (InjectedFault, NetstoreUnavailable, OSError,
                    RuntimeError) as e:
                reg.counter("replica.ship_errors").inc()
                logger.warning("wal shipper %s: %s (retrying)",
                               self.url, e)
                with self._cv:
                    self._queue.extendleft(reversed(batch))
                    if self._stop:
                        return
                time.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
            reg.gauge("replica.lag").set(
                max(0, self.server._wal.seq - self._acked_seq))
            if self._scrub_due():
                self._scrub_once()

    def _ship_snapshot(self) -> None:
        srv = self.server
        with srv._lock:
            payload = srv.state_payload()
            seq = srv._wal.seq
        _faults.maybe_fail("replica.ship", snapshot=True)
        t0 = time.perf_counter()
        self._rpc("snapshot_install", snapshot=payload, seq=seq)
        reg = _metrics.registry()
        reg.histogram("replica.ship.s").observe(time.perf_counter() - t0)
        reg.counter("replica.resyncs").inc()
        with self._cv:
            self._need_snapshot = False
            self._acked_seq = max(self._acked_seq, seq)
            while self._queue and self._queue[0]["seq"] <= seq:
                self._queue.popleft()
            self._cv.notify_all()

    def _ship_batch(self, batch: list) -> None:
        _faults.maybe_fail("replica.ship", n=len(batch))
        t0 = time.perf_counter()
        out = self._rpc("wal_ship", records=batch,
                        from_seq=batch[0]["seq"])
        reg = _metrics.registry()
        reg.histogram("replica.ship.s").observe(time.perf_counter() - t0)
        if out.get("resync"):
            # The replica found a gap (it restarted, or we raced its
            # install): fall back to snapshot+tail from here.
            with self._cv:
                self._need_snapshot = True
                self._queue.extendleft(reversed(batch))
            return
        reg.counter("replica.shipped").inc(len(batch))
        with self._cv:
            self._acked_seq = max(self._acked_seq,
                                  int(out["applied_seq"]))
            self._cv.notify_all()

    # -- continuous byte-identity scrub --------------------------------------

    def _scrub_due(self) -> bool:
        return (self.scrub_interval > 0
                and time.monotonic() - self._last_scrub
                >= self.scrub_interval)

    def _scrub_once(self) -> None:
        self._last_scrub = time.monotonic()
        reg = _metrics.registry()
        try:
            rep = self._rpc("scrub")
        except (NetstoreUnavailable, RuntimeError, OSError):
            return                      # replica down: failover's problem
        srv = self.server
        with srv._lock:
            my_seq = srv._wal.seq
            my_hash = _obs_bundle.state_hash(srv.state_bytes())
        if rep["seq"] != my_seq:
            return                      # mid-catch-up: compare next pass
        if rep["hash"] == my_hash:
            reg.counter("replica.scrub.ok").inc()
            return
        reg.counter("replica.scrub.mismatch").inc()
        EVENTS.emit("replica_divergence", url=self.url, seq=my_seq)
        logger.error("replica %s DIVERGED from primary at seq %d "
                     "(%s != %s)", self.url, my_seq, rep["hash"], my_hash)
        _flight.dump("replica-divergence",
                     extra={"trigger": "scrub_mismatch", "url": self.url,
                            "seq": my_seq, "primary_hash": my_hash,
                            "replica_hash": rep["hash"]})


class ShardServer(ServiceServer):
    """One fleet shard: a WAL-durable ServiceServer with a replication
    role, the five ``_REPLICATION_VERBS``, and (as primary) WAL
    shipping to warm replicas."""

    def __init__(self, wal_dir: str, role: str = "primary",
                 replicate_to: str | None = None,
                 ship_token: str | None = None,
                 scrub_interval: float | None = None,
                 ship_batch: int | None = None, **kw):
        if role not in ("primary", "replica"):
            raise ValueError(f"role {role!r}: want primary|replica")
        self._role = role
        self._shippers: list = []
        # Whole-shard cutover fence (the ``fence`` verb): while set,
        # client mutating verbs get the typed ShardFenced redirect and
        # parked long-poll claimants are woken to surface it.  Ephemeral
        # by design — a restarted shard comes back unfenced and the
        # router re-fences if its cutover is still in flight.
        self._fence_all = False
        # Highest promotion epoch observed (a router passes its shard-map
        # version): a stale router whose map predates the last topology
        # change cannot promote this shard backwards.
        self._promote_epoch: int | None = None
        self._ship_token = (ship_token if ship_token is not None
                            else kw.get("token"))
        self._scrub_interval = scrub_interval
        self._ship_batch = ship_batch
        # A fenced replica refuses client suggests, so its cohort gate
        # stays disarmed until promotion: hold the configured window back
        # from the base constructor and arm in _promote_verb.
        _window = (kw.pop("cohort_window_ms", None)
                   if role == "replica" else None)
        super().__init__(wal_dir, **kw)
        if _window:
            self._cohort_window_ms = _window
        # Every durable append from here on fans out to the shippers
        # (recovery replay never appends, so the hook sees live traffic
        # only — the initial sync ships as one snapshot instead).
        self._wal.listener = self._on_wal_append
        self._wal.crash_hook = self._drain_shippers_before_crash
        _metrics.registry().gauge("shard.role").set(
            1.0 if role == "primary" else 0.0)
        if replicate_to:
            self.attach_replica(replicate_to)

    @property
    def role(self) -> str:
        return self._role

    def _drain_shippers_before_crash(self) -> None:
        """Bounded best-effort drain before a simulated WAL-crash
        SIGKILL: every record acked *before* the fatal append gets a
        chance to ship, so the chaos suite exercises failover
        exactly-once rather than async shipping lag.  A shipper blocked
        on the dispatch lock (held by the crashing thread) just times
        out — the kill proceeds regardless."""
        for sh in list(self._shippers):
            sh.flush(timeout=2.0)

    def _on_wal_append(self, rec: dict) -> None:
        if not self._shippers:
            return
        # Freeze the record here — under the dispatch lock, before the
        # verb executes.  ``rec["req"]`` holds live references to dicts
        # the store is about to mutate (insert_docs stores the request's
        # doc objects verbatim; reserve then sets state/owner on them),
        # while the shipper serializes its batch later on its own
        # thread.  Shipping the live dict would replicate post-execution
        # state under a pre-execution seq, diverging the replica.
        rec = json.loads(json.dumps(rec))
        for sh in list(self._shippers):
            sh.enqueue(rec)

    def attach_replica(self, url: str) -> WalShipper:
        """Start shipping snapshot+tail to ``url`` (idempotent per URL).
        Also how a rebalance target and a recovered old primary
        (failback) join: attach, catch up, promote."""
        url = url.rstrip("/")
        with self._lock:
            for sh in self._shippers:
                if sh.url == url:
                    return sh
        # Construct outside the lock (the ctor builds an RPC client and
        # a thread object), publish under it with a re-check, and only
        # then start the thread: every record appended after publication
        # is enqueued, and the first snapshot — taken by the thread
        # under the server lock — covers everything before it, so no
        # record can fall between snapshot and tail.
        sh = WalShipper(self, url, token=self._ship_token,
                        batch=self._ship_batch,
                        scrub_interval=self._scrub_interval)
        with self._lock:
            for existing in self._shippers:
                if existing.url == url:
                    return existing   # lost the race; sh never started
            self._shippers.append(sh)
        sh.start()
        logger.info("shard: shipping WAL to replica %s", url)
        return sh

    # -- replication verbs ---------------------------------------------------

    def _dispatch_verb(self, verb: str, req: dict, tenant=None,
                       idem=None) -> dict:
        if verb == "wal_ship":
            return self._wal_ship_verb(req)
        if verb == "snapshot_install":
            return self._snapshot_install_verb(req)
        if verb == "scrub":
            return self._scrub_verb()
        if verb == "promote":
            return self._promote_verb(req)
        if verb == "replica_attach":
            self.attach_replica(req["url"])
            return {"attached": req["url"],
                    "n_replicas": len(self._shippers)}
        if verb == "fence":
            return self._fence_verb(req)
        if (self._fence_all and not self._replaying
                and verb in ServiceServer._WAL_VERBS):
            # Whole-shard cutover fence: a typed retriable redirect —
            # the client refreshes its map and lands wherever the
            # cutover put the store.
            _metrics.registry().counter("shard.fenced").inc()
            raise ShardFenced(
                f"shard fenced for cutover: refusing {verb!r}")
        if (self._role == "replica" and not self._replaying
                and verb in ServiceServer._WAL_VERBS):
            # Fence: a write reaching an unpromoted replica would fork
            # the store the primary is still shipping to.
            _metrics.registry().counter("shard.fenced").inc()
            raise RuntimeError(
                f"shard is a replica (not promoted): refusing {verb!r}")
        return super()._dispatch_verb(verb, req, tenant=tenant, idem=idem)

    def _fence_verb(self, req: dict) -> dict:
        """Raise or drop the whole-shard cutover fence.  Raising it
        wakes EVERY parked long-poll claimant — a ``reserve(wait_s=W)``
        dozing on its claim gate must surface the typed redirect now,
        not after the cutover window has already expired."""
        up = bool(req.get("up", True))
        self._fence_all = up
        reg = _metrics.registry()
        reg.gauge("shard.fence_up").set(1.0 if up else 0.0)
        if up:
            reg.counter("shard.fences").inc()
            with self._claim_gates_lock:
                gates = list(self._claim_gates.values())
            for gate in gates:
                gate.signal()
            EVENTS.emit("shard_fence", up=True)
        return {"ok": True, "fenced": up}

    def _wal_ship_verb(self, req: dict) -> dict:
        """Apply a shipped tail batch in log order.  Records at or below
        our seq are re-sends (dropped); a gap means we missed records
        (restart, raced install) and the shipper must resync."""
        reg = _metrics.registry()
        applied = dups = 0
        with self._lock:
            for rec in req["records"]:
                seq = int(rec["seq"])
                if seq <= self._wal.seq:
                    dups += 1
                    continue
                if seq != self._wal.seq + 1:
                    reg.counter("replica.gaps").inc()
                    return {"applied_seq": self._wal.seq, "resync": True,
                            "applied": applied, "dup": dups}
                # Same discipline as the primary: durable append first,
                # then execute with the record's logged clock.
                self._wal.append(
                    {k: v for k, v in rec.items() if k != "seq"}, seq=seq)
                self._replaying = True
                try:
                    self._apply_record(rec)
                finally:
                    self._replaying = False
                applied += 1
            if applied:
                self._maybe_snapshot()
            out = {"applied_seq": self._wal.seq, "resync": False,
                   "applied": applied, "dup": dups}
        if applied:
            reg.counter("replica.applied").inc(applied)
        return out

    def _snapshot_install_verb(self, req: dict) -> dict:
        """Full-state resync: install the primary's state payload at its
        seq and persist it as our own on-disk snapshot, so a replica
        restart recovers from the installed point."""
        with self._lock:
            self._load_state_payload(req["snapshot"])
            self._wal.seq = int(req["seq"])
            self._wal.snapshot(self.state_payload())
            self._snap_seq = self._wal.seq
            out = {"applied_seq": self._wal.seq}
        _metrics.registry().counter("replica.installs").inc()
        EVENTS.emit("replica_install", seq=out["applied_seq"])
        return out

    def _scrub_verb(self) -> dict:
        """Read-only byte-identity probe: ``(seq, state hash, role)``,
        computed atomically under the dispatch lock."""
        with self._lock:
            return {"seq": self._wal.seq,
                    "hash": _obs_bundle.state_hash(self.state_bytes()),
                    "role": self._role}

    def _promote_verb(self, req: dict | None = None) -> dict:
        """Role flip to primary — idempotent (re-promoting a primary is
        a no-op; ``shard.promotions`` counts actual transitions only,
        which is what makes N routers racing one dead primary provably
        single-flight: total promotions across the fleet == 1).  An
        optional ``epoch`` (the caller's shard-map version) is a
        monotonic guard: a router whose map predates the last observed
        topology change is refused, so a laggard cannot re-promote after
        a newer cutover moved primacy elsewhere."""
        epoch = (req or {}).get("epoch")
        with self._lock:
            if epoch is not None:
                epoch = int(epoch)
                if (self._promote_epoch is not None
                        and epoch < self._promote_epoch):
                    _metrics.registry().counter(
                        "shard.promote.stale").inc()
                    return {"role": self._role, "was": self._role,
                            "seq": self._wal.seq, "stale": True,
                            "epoch": self._promote_epoch}
                self._promote_epoch = max(self._promote_epoch or 0, epoch)
            was = self._role
            self._role = "primary"
            self._fence_all = False
            seq = self._wal.seq
        reg = _metrics.registry()
        reg.gauge("shard.role").set(1.0)
        reg.gauge("shard.fence_up").set(0.0)
        if was != "primary":
            reg.counter("shard.promotions").inc()
            EVENTS.emit("shard_promote", seq=seq)
            logger.warning("shard PROMOTED to primary at seq %d", seq)
        if (self._cohort_gate is None
                and getattr(self, "_cohort_window_ms", None)):
            # The replica fenced client suggests pre-promotion, so its
            # gate was never armed; arm it NOW (outside the dispatch
            # lock — the gate takes the lock itself per window) so a
            # promoted shard resumes cohort batching instead of serving
            # solo suggests forever.
            from .server import _CohortGate

            self._cohort_gate = _CohortGate(self, self._cohort_window_ms)
            reg.counter("shard.cohort_gate_armed").inc()
        return {"role": "primary", "was": was, "seq": seq}

    def shutdown(self):
        for sh in list(self._shippers):
            sh.stop()
        super().shutdown()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None):
    """``python -m hyperopt_tpu_torch.service.replica --serve --wal-dir
    DIR``: host one fleet shard (primary or warm replica)."""
    import argparse

    from .server import _add_durability_args, _arm_faults, \
        _durability_kwargs

    p = argparse.ArgumentParser(
        description="hyperopt_tpu_torch fleet shard (WAL-durable service "
                    "with a replication role)")
    p.add_argument("--serve", action="store_true", required=True,
                   help="serve --wal-dir on --host:--port")
    p.add_argument("--wal-dir", required=True,
                   help="durability directory (wal.jsonl + snapshot.json)")
    p.add_argument("--role", default="primary",
                   choices=("primary", "replica"),
                   help="primary serves clients and ships its WAL; "
                        "replica applies shipped records and fences "
                        "client mutations until promoted")
    p.add_argument("--replicate-to", default=None, metavar="URL",
                   help="warm replica URL to ship snapshot+tail to "
                        "(primaries only)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--token", default=None,
                   help="single shared secret (also used for shipping)")
    p.add_argument("--tenants-file", default=None,
                   help="JSON tenant table enabling multi-tenant auth")
    p.add_argument("--fsync", default="always",
                   choices=("always", "batch", "never"))
    p.add_argument("--snapshot-every", type=int, default=None, metavar="N")
    p.add_argument("--requeue-stale-every", type=float, default=None,
                   metavar="S")
    p.add_argument("--stale-timeout", type=float, default=60.0)
    p.add_argument("--cohort-window-ms", type=float, default=None,
                   metavar="MS",
                   help="fleet-mode suggest coalescing window; a replica "
                        "holds it disarmed and arms the gate at promotion")
    p.add_argument("--scrub-interval", type=float, default=None,
                   metavar="S",
                   help="background byte-identity scrub period "
                        "(default 5 s; 0 disables)")
    p.add_argument("--ship-batch", type=int, default=None, metavar="N",
                   help="records per wal_ship RPC (default 256)")
    p.add_argument("--flight-dir", default=None,
                   help="arm the flight recorder so a crashed/killed "
                        "shard leaves a postmortem bundle (default: off)")
    _add_durability_args(p)
    args = p.parse_args(argv)
    _arm_faults(args)

    tenants = None
    if args.tenants_file:
        from .tenancy import TenantTable
        tenants = TenantTable.from_file(args.tenants_file)

    server = ShardServer(args.wal_dir, role=args.role,
                         replicate_to=args.replicate_to,
                         scrub_interval=args.scrub_interval,
                         ship_batch=args.ship_batch,
                         host=args.host, port=args.port, token=args.token,
                         tenants=tenants, fsync=args.fsync,
                         snapshot_every=args.snapshot_every,
                         requeue_stale_every=args.requeue_stale_every,
                         stale_timeout=args.stale_timeout,
                         cohort_window_ms=args.cohort_window_ms,
                         **_durability_kwargs(args))
    print(f"shard: serving {args.wal_dir} ({args.role}) at {server.url}",
          flush=True)

    import signal

    def _on_sigterm(signo, frame):
        raise SystemExit(0)

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:              # not the main thread (embedded use)
        pass
    # Arm AFTER the SIGTERM handler so the flight handler chains it.
    flight_dir = _flight.install(args.flight_dir)
    if flight_dir:
        print(f"shard: flight recorder armed -> {flight_dir}", flush=True)
    try:
        server.serve_forever()
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        server.shutdown()
        print("shard: shut down", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Stateless consistent-hash router: one URL in front of N shards.

Counterpart of ``hyperopt_tpu/service/router.py``.  The router owns no
trial state, only the :class:`~.cluster.ShardMap`.  Every verb POST is
hashed by its ``(tenant, exp_key)`` onto the ring (:mod:`~.cluster`,
pinned hash, virtual nodes) and forwarded raw to the owning shard's
primary: the body bytes are untouched, so the idempotency key and the
trace context ride through verbatim, and the client's
``X-Netstore-Token`` header is passed along for the shard to
authenticate (give the router a tenant table and it also rejects
unknown tokens at the edge, which is what makes per-tenant placement
possible).

**Failover** is the router's one write to the map: when a primary stops
answering transport (``retries`` attempts, first backoff ``backoff``),
the router promotes the shard's warm replica (``promote`` verb, fleet
token), swaps the map entry and re-forwards.  The retried body carries
the original idempotency key, and the replica either replays the
shipped record's cached reply or executes the verb for the first time.

**Rebalance** moves a shard to a new process with a bounded cutover:
attach the target as an extra replica of the current primary
(snapshot+tail catch-up), then gate the shard's forwards, wait for two
quiesced ``scrub`` agreements (seq and state hash), promote the target
and swap the map, all inside ``cutover_window_s``, or abort with the
old primary still serving.  ``shard_add``/``shard_remove`` grow and
shrink the ring with one bounded per-store migration at a time
(``store_fence`` → ``store_export`` → ``store_import`` → pin).

Fleet-internal calls (promote/scrub/replica_attach, shard metrics
pulls) authenticate with the router's own ``token``; in tenant-table
fleets, point it at a dedicated ops tenant's token.

``GET /metrics`` merges every shard's snapshot (plus the router's own
``router.*`` series) into one document with a ``router`` section.
"""

from __future__ import annotations

import json
import logging
import threading
import time

from urllib.error import URLError

from .. import faults as _faults
from ..exceptions import InjectedFault, NetstoreUnavailable
from ..obs import export as _obs_export
from ..obs import flight as _flight
from ..obs import metrics as _metrics
from ..obs.events import EVENTS
from ..parallel.netstore import _KeepAliveHTTPServer, _LeanRequestHandler
from .cluster import ShardMap

logger = logging.getLogger(__name__)

__all__ = ["Router", "main"]

#: Verbs the router answers itself; everything else is forwarded to the
#: shard owning the request's (tenant, exp_key).  ``map_sync`` is the
#: router-to-router gossip verb (HA peers reconcile shard maps by
#: version); ``shard_add``/``shard_remove`` are the elastic verbs the
#: autoscaler drives (grow/shrink the ring with per-store migration).
_ROUTER_VERBS = frozenset({"shard_map", "rebalance", "map_sync",
                           "shard_add", "shard_remove"})

#: Millisecond-bucket convention shared with the service layer.
_MS_BUCKETS = tuple(0.05 * (2.0 ** i) for i in range(20))


#: ``Router`` defaults: transport retries per forward, the first backoff
#: (s), and the bounded rebalance cutover window (s).
DEFAULT_RETRIES = 2
DEFAULT_BACKOFF_S = 0.05
DEFAULT_CUTOVER_WINDOW_S = 5.0


class Router:
    """Thin HTTP front: consistent-hash placement + failover + map serving.

    ``shards`` maps shard id -> ``{"primary": url, "replica": url|None}``
    (a :class:`~.cluster.ShardMap` is built from it).  ``tenants`` (a
    :class:`~.tenancy.TenantTable`) is optional: with it, placement uses
    the authenticated tenant name and unknown tokens are rejected at the
    edge; without it, placement hashes ``(None, exp_key)`` and shards
    keep sole authority over auth.  ``retries``/``backoff`` bound each
    forward's transport retries and ``cutover_window_s`` the rebalance
    cutover (defaults ``DEFAULT_RETRIES``, ``DEFAULT_BACKOFF_S``,
    ``DEFAULT_CUTOVER_WINDOW_S``).
    """

    def __init__(self, shards: dict, host: str = "127.0.0.1",
                 port: int = 0, token: str | None = None, tenants=None,
                 virtual_nodes: int | None = None,
                 timeout: float = 30.0,
                 retries: int | None = None,
                 backoff: float | None = None,
                 cutover_window_s: float | None = None,
                 peers=None):
        from ..parallel.netstore import _resolve_token
        self._map = ShardMap(shards, virtual_nodes=virtual_nodes)
        self._lock = threading.Lock()
        self._cutover: dict = {}        # shard id -> cutover gate Event
        # Serializes topology mutations (rebalance / shard_add /
        # shard_remove): migrations compose badly when interleaved, and
        # each one is already bounded, so a plain lock is the simplest
        # correct arbiter.
        self._topology_lock = threading.Lock()
        #: HA peer routers sharing this map.  Every map mutation is
        #: pushed best-effort (``map_sync``, adopt-iff-newer), so N
        #: stateless routers behind one address converge on the same
        #: versioned topology without a coordination service.
        self._peers = [str(u).rstrip("/") for u in (peers or [])]
        self._autoscaler = None         # attach_autoscaler() wires one
        self._token = _resolve_token(token)
        self._tenants = tenants
        self.timeout = float(timeout)
        self.retries = int(DEFAULT_RETRIES if retries is None else retries)
        self.backoff = float(DEFAULT_BACKOFF_S if backoff is None
                             else backoff)
        self.cutover_window_s = float(
            DEFAULT_CUTOVER_WINDOW_S if cutover_window_s is None
            else cutover_window_s)
        self._started = False
        self._closed = False
        self._lifecycle_lock = threading.Lock()
        server = self

        class Handler(_LeanRequestHandler):
            # Keep-alive edge: the same HTTP/1.1 + Content-Length +
            # lean-parse contract as the netstore handler, so client
            # pools hold their router sockets open across verbs; Nagle
            # off for the same small-reply delayed-ACK stall.
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):      # quiet by default
                logger.debug("router: " + fmt, *args)

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code, body: bytes):
                self._send(code, body, "application/json")

            def _reject(self):
                _metrics.registry().counter("router.auth.rejected").inc()
                self.rfile.read(
                    int(self.headers.get("Content-Length", "0")))
                self._send_json(401, json.dumps(
                    {"error": "AuthError: missing or bad "
                     "X-Netstore-Token"}).encode())

            def _resolve(self):
                """Edge auth: with a tenant table every request must
                resolve to a tenant (whose name drives placement); with
                a bare/absent token the router's own verbs compare
                constant-time and forwarded verbs defer to the shard."""
                import hmac
                self._tenant = None
                tok = self.headers.get("X-Netstore-Token", "")
                if server._tenants is not None:
                    tenant = server._tenants.resolve(tok)
                    if tenant is None:
                        self._reject()
                        return False
                    self._tenant = tenant
                    return True
                if server._token is None:
                    return True
                if hmac.compare_digest(tok.encode(),
                                       server._token.encode()):
                    return True
                self._reject()
                return False

            def do_POST(self):
                if not self._resolve():
                    return
                n = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(n) or b"{}"
                try:
                    req = json.loads(raw)
                    verb = req.get("verb")
                    if verb == "shard_map":
                        out = server._shard_map_verb(self._tenant)
                    elif verb == "rebalance":
                        out = server._rebalance_verb(req)
                    elif verb == "map_sync":
                        out = server._map_sync_verb(req)
                    elif verb == "shard_add":
                        out = server._shard_add_verb(req)
                    elif verb == "shard_remove":
                        out = server._shard_remove_verb(req)
                    else:
                        tname = getattr(self._tenant, "name",
                                        self._tenant)
                        code, body = server.forward(
                            raw, verb=verb, tenant=tname,
                            exp_key=req.get("exp_key", "default"),
                            token=self.headers.get("X-Netstore-Token"))
                        self._send_json(code, body)
                        return
                    body = json.dumps(out).encode()
                    code = 200
                except NetstoreUnavailable as e:
                    body = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode()
                    code = 503
                except Exception as e:
                    body = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode()
                    code = 500
                self._send_json(code, body)

            def do_GET(self):
                if not self._resolve():
                    return
                if self.path.split("?", 1)[0] == "/metrics":
                    payload = server.metrics_payload()
                    if _obs_export.wants_openmetrics(
                            self.headers.get("Accept", "")):
                        body = _obs_export.render_openmetrics(
                            payload).encode("utf-8")
                        self._send(200, body, _obs_export.CONTENT_TYPE)
                        return
                    self._send_json(200, json.dumps(payload).encode())
                    return
                self._send_json(404, json.dumps(
                    {"error": f"NotFound: {self.path}"}).encode())

        self._httpd = _KeepAliveHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]

    # -- lifecycle (mirrors StoreServer's idempotent shutdown) ---------------

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self):
        self._started = True
        t = threading.Thread(target=self._httpd.serve_forever,
                             daemon=True, name="service-router")
        t.start()
        return self.host, self.port

    def serve_forever(self):
        self._started = True
        self._httpd.serve_forever()

    def shutdown(self):
        with self._lifecycle_lock:
            if self._closed:
                return
            self._closed = True
        if self._started:
            self._httpd.shutdown()
        self._httpd.server_close()

    # -- shard-internal RPC ---------------------------------------------------

    def _fleet_rpc(self, url: str, retries: int = 1,
                   exp_key: str = "__router__"):
        """RPC bound to a shard with the router's fleet credential.
        ``exp_key`` matters for the per-store migration verbs
        (store_fence/store_export/store_import): ``_Rpc`` stamps its
        bound key into every call, so each migrated store gets its own
        binding."""
        from ..parallel.netstore import _Rpc
        return _Rpc(url, exp_key, timeout=self.timeout,
                    token=self._token, retries=retries)

    # -- forwarding + failover ------------------------------------------------

    def shard_for(self, tenant, exp_key: str):
        """Current owner ``(shard_id, entry)`` — a snapshot; the map can
        move under failover/rebalance."""
        with self._lock:
            sid, ent = self._map.owner(tenant, exp_key)
            return sid, dict(ent)

    def forward(self, raw: bytes, verb, tenant, exp_key: str,
                token: str | None):
        """Forward one verb body to the owning primary; on transport
        failure, promote the replica and retry there.  Returns
        ``(status, body bytes)`` exactly as the shard answered (HTTP
        application errors pass through un-retried, like ``_Rpc``)."""
        reg = _metrics.registry()
        err = None
        for _generation in range(3):
            with self._lock:
                sid, ent = self._map.owner(tenant, exp_key)
                version = self._map.version
                gate = self._cutover.get(sid)
            if gate is not None:
                # Mid-rebalance: hold the verb for the bounded cutover
                # window, then re-resolve the owner.
                gate.wait(self.cutover_window_s + 1.0)
                continue
            try:
                return self._post_shard(sid, ent["primary"], raw, verb,
                                        token)
            except NetstoreUnavailable as e:
                err = e
                with self._lock:
                    moved = self._map.version != version
                if moved:
                    continue            # another thread already failed over
                if not self._promote_replica(sid, version):
                    break
        reg.counter("router.errors").inc()
        raise err if err is not None else NetstoreUnavailable(
            f"router: no live shard for ({tenant!r}, {exp_key!r})")

    def _post_shard(self, sid: str, url: str, raw: bytes, verb,
                    token: str | None):
        """One shard POST with the router's transport-retry budget.
        Counts every attempt; observes per-shard forward latency."""
        from ..parallel.netstore import _rpc_pool
        reg = _metrics.registry()
        headers = {"Content-Type": "application/json"}
        if token:
            headers["X-Netstore-Token"] = token
        attempts = 0
        while True:
            t0 = time.perf_counter()
            try:
                _faults.maybe_fail("router.forward", verb=verb)
                # Pooled keep-alive upstream: non-2xx means the shard
                # DID answer (auth refusal, verb fault) — application-
                # level, passed through un-retried like _Rpc does.
                code, body = _rpc_pool().request(url, raw, headers,
                                                 self.timeout)
                dt = time.perf_counter() - t0
                reg.counter("router.forwarded").inc()
                reg.histogram("router.forward.s").observe(dt)
                reg.histogram(f"router.shard.{sid}.s").observe(dt)
                return code, body
            except (URLError, OSError, InjectedFault) as e:
                attempts += 1
                reg.counter("router.retries").inc()
                if attempts > self.retries:
                    raise NetstoreUnavailable(
                        f"shard {sid} primary {url} unreachable after "
                        f"{attempts} attempt(s) ({verb}): {e}",
                        attempts=attempts) from e
                time.sleep(min(self.backoff * (2 ** (attempts - 1)), 2.0))

    def _promote_replica(self, sid: str, seen_version: int) -> bool:
        """Failover: promote the shard's warm replica and swap the map.
        Single-flight via the version check; returns whether the shard
        has a live primary afterwards."""
        with self._lock:
            if self._map.version != seen_version:
                return True             # raced: someone else moved it
            replica = self._map.shards[sid]["replica"]
        if not replica:
            logger.error("shard %s primary is down and no replica is "
                         "attached — giving up", sid)
            return False
        try:
            # The epoch rides to the replica's promote guard: two
            # routers observing the same dead primary send the same
            # seen map version, the replica transitions exactly once,
            # and a *later* epoch always wins over a stale retry — the
            # single-flight half of multi-router HA.
            out = self._fleet_rpc(replica, retries=2)(
                "promote", epoch=seen_version)
        except (NetstoreUnavailable, RuntimeError, OSError) as e:
            logger.error("shard %s failover: replica %s also "
                         "unreachable: %s", sid, replica, e)
            return False
        with self._lock:
            if self._map.version == seen_version:
                self._map.promote(sid)
        self._push_map_to_peers()
        self._reconcile_fences(sid)
        _metrics.registry().counter("router.failovers").inc()
        EVENTS.emit("router_failover", name=sid, url=replica,
                    seq=out.get("seq"))
        logger.warning("shard %s: primary down, PROMOTED replica %s "
                       "(seq %s)", sid, replica, out.get("seq"))
        return True

    def _reconcile_fences(self, sid: str) -> None:
        """Lift fences the dead primary took to its grave.

        A migration fence is raised on the donor FIRST and WAL-ships to
        its replica; if the primary dies before the cutover's outcome
        records ship, the promoted replica serves the store fenced with
        nobody left to finish or roll back the move.  The map is the
        arbiter: a completed cutover repoints the pin away from the
        donor, so a fenced store that still has documents AND that the
        current map still routes here is a cutover that died mid-flight
        — lift it.  Tombstones (fenced, zero docs) and moved-away
        copies (map points elsewhere) are left exactly as they are."""
        try:
            with self._lock:
                url = self._map.shards[sid]["primary"]
            rows = self._fleet_rpc(url, retries=2)("stores")["stores"]
            for row in rows:
                if not row.get("fenced") or not row.get("docs"):
                    continue
                if row.get("tenant") is not None:
                    continue            # outside the fleet credential
                k = row["exp_key"]
                with self._lock:
                    owner = self._map.owner(None, k)[0]
                if owner != sid:
                    continue
                self._fleet_rpc(url, retries=2, exp_key=k)(
                    "store_fence", lift=True)
                _metrics.registry().counter(
                    "router.fences_reconciled").inc()
                logger.warning("shard %s: lifted stale migration fence "
                               "on store %r after promotion", sid, k)
        except (NetstoreUnavailable, RuntimeError, OSError) as e:
            logger.error("shard %s: post-promotion fence reconcile "
                         "failed: %s", sid, e)

    # -- router-local verbs ---------------------------------------------------

    def _shard_map_verb(self, tenant) -> dict:
        """The topology document + the caller's resolved tenant name —
        everything a router-aware client needs to place itself."""
        _metrics.registry().counter("router.map.fetches").inc()
        with self._lock:
            doc = self._map.to_dict()
        return {"map": doc, "tenant": getattr(tenant, "name", tenant)}

    # -- multi-router HA: shared version-guarded shard map --------------------

    def _map_sync_verb(self, req: dict) -> dict:
        """Peer gossip: adopt the incoming map iff strictly newer than
        ours, and always reply with our (possibly just-updated) map so
        the push is simultaneously a pull.  Version-guarded adoption is
        what makes N stateless routers behind one address safe: the map
        is the only shared state, and it only moves forward."""
        incoming = req.get("map")
        adopted = False
        if incoming:
            adopted = self._adopt_map(incoming)
        with self._lock:
            doc = self._map.to_dict()
        return {"map": doc, "adopted": adopted}

    def _adopt_map(self, doc: dict) -> bool:
        """Swap in ``doc`` iff its version is strictly newer.  Never
        adopts mid-cutover (our in-flight rebalance will republish a
        newer version when it lands or aborts)."""
        try:
            incoming = ShardMap.from_dict(doc)
        except (KeyError, TypeError, ValueError) as e:
            logger.warning("map_sync: refused malformed map: %s", e)
            return False
        with self._lock:
            if self._cutover or incoming.version <= self._map.version:
                return False
            self._map = incoming
        _metrics.registry().counter("router.map.adopted").inc()
        EVENTS.emit("router_map_adopt", name=str(incoming.version))
        return True

    def _push_map_to_peers(self) -> None:
        """Best-effort fan-out of our map to every HA peer, outside all
        locks.  A peer that is down simply misses this round — it
        converges on its next fetch/push (or when a client redirected
        by a fenced shard forces its refresh)."""
        if not self._peers:
            return
        with self._lock:
            doc = self._map.to_dict()
        reg = _metrics.registry()
        for peer in self._peers:
            try:
                out = self._fleet_rpc(peer, retries=1)("map_sync",
                                                       map=doc)
                reg.counter("router.map.pushes").inc()
                # Symmetric reconcile: the peer may answer with a newer
                # map than the one we pushed.
                peer_map = (out or {}).get("map")
                if peer_map and peer_map.get("version", 0) > doc["version"]:
                    self._adopt_map(peer_map)
            except (NetstoreUnavailable, RuntimeError, OSError) as e:
                reg.counter("router.map.push_errors").inc()
                logger.debug("map push to peer %s failed: %s", peer, e)

    def _rebalance_verb(self, req: dict) -> dict:
        """Move shard ``req["shard"]`` to the process at ``req["url"]``:
        snapshot+tail catch-up while the old primary keeps serving, then
        a bounded cutover (gate forwards, fence the old primary so even
        parked long-poll claims wake with the typed redirect, require
        two quiesced scrub agreements, promote, swap)."""
        if not self._topology_lock.acquire(blocking=False):
            raise RuntimeError("another topology change is in progress")
        try:
            return self._rebalance_locked(req)
        finally:
            self._topology_lock.release()

    def _rebalance_locked(self, req: dict) -> dict:
        sid = str(req["shard"])
        new_url = str(req["url"]).rstrip("/")
        catchup_timeout = float(req.get("timeout", 30.0))
        with self._lock:
            if sid not in self._map.shards:
                raise ValueError(f"unknown shard {sid!r}")
            if sid in self._cutover:
                raise RuntimeError(f"shard {sid!r} rebalance already "
                                   "in progress")
            ent = dict(self._map.shards[sid])
        old_rpc = self._fleet_rpc(ent["primary"], retries=2)
        new_rpc = self._fleet_rpc(new_url, retries=2)
        old_rpc("replica_attach", url=new_url)
        deadline = time.monotonic() + catchup_timeout
        while True:
            if new_rpc("scrub")["seq"] >= old_rpc("scrub")["seq"]:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"rebalance {sid}: catch-up to {new_url} timed out")
            time.sleep(0.05)
        # Cutover: gate this shard's forwards, then require two
        # consecutive quiesced agreements (seq stable AND hashes equal)
        # so verbs already in flight to the old primary are provably
        # shipped and applied before the swap.
        gate = threading.Event()
        with self._lock:
            self._cutover[sid] = gate
            epoch = self._map.version
        t0 = time.perf_counter()
        fenced = False
        try:
            # Fence the old primary for the cutover window: new WAL
            # verbs are refused with the typed ShardFenced redirect and
            # every PARKED long-poll claim wakes immediately — without
            # this, a claimant sleeping out its wait budget would pin
            # the old primary's seq forever and starve the quiesce
            # check below (and then reserve against a retired shard).
            old_rpc("fence")
            fenced = True
            wdeadline = time.monotonic() + self.cutover_window_s
            prev_seq = None
            while True:
                old_s = old_rpc("scrub")
                new_s = new_rpc("scrub")
                if (new_s["seq"] == old_s["seq"]
                        and new_s["hash"] == old_s["hash"]
                        and prev_seq == old_s["seq"]):
                    break
                prev_seq = old_s["seq"]
                if time.monotonic() > wdeadline:
                    raise RuntimeError(
                        f"rebalance {sid}: cutover window "
                        f"({self.cutover_window_s}s) exceeded; aborted "
                        "— the old primary keeps serving")
                time.sleep(0.02)
            new_rpc("promote", epoch=epoch)
            with self._lock:
                self._map.set_primary(sid, new_url,
                                      replica=ent["replica"])
                version = self._map.version
            # The old primary STAYS fenced: it is out of the map now,
            # and the fence is what redirects any client still holding
            # a direct connection to it (split-brain guard).
            fenced = False
        except BaseException:
            if fenced:
                # Abort path: lift the fence so the old primary resumes
                # serving exactly as before the attempt.
                try:
                    old_rpc("fence", up=False)
                except (NetstoreUnavailable, RuntimeError, OSError):
                    logger.error("rebalance %s: could not unfence the "
                                 "old primary after abort", sid)
            raise
        finally:
            with self._lock:
                self._cutover.pop(sid, None)
            gate.set()
        self._push_map_to_peers()
        if ent["replica"]:
            # Re-arm warm replication from the new primary (best
            # effort: the old replica keeps its state either way).
            try:
                new_rpc("replica_attach", url=ent["replica"])
            except (NetstoreUnavailable, RuntimeError, OSError):
                logger.warning("rebalance %s: could not re-attach "
                               "replica %s", sid, ent["replica"])
        cutover_ms = (time.perf_counter() - t0) * 1e3
        reg = _metrics.registry()
        reg.counter("router.rebalances").inc()
        reg.histogram("router.cutover_ms",
                      buckets=_MS_BUCKETS).observe(cutover_ms)
        EVENTS.emit("router_rebalance", name=sid, url=new_url)
        logger.warning("shard %s REBALANCED to %s (cutover %.1f ms)",
                       sid, new_url, cutover_ms)
        return {"shard": sid, "primary": new_url, "version": version,
                "cutover_ms": cutover_ms}

    # -- elastic topology: shard_add / shard_remove ---------------------------

    def _fleet_inventory(self) -> dict:
        """``shard id -> [store rows]`` from every primary's ``stores``
        verb — the migration planner's input."""
        with self._lock:
            doc = self._map.to_dict()
        inv = {}
        for sid, ent in doc["shards"].items():
            inv[sid] = self._fleet_rpc(
                ent["primary"], retries=2)("stores")["stores"]
        return inv

    def _migrate_store(self, sid: str, old_url: str, to_sid: str,
                       new_url: str, tenant, exp_key: str) -> None:
        """Move ONE store with a bounded per-store cutover: fence the
        source (parked claims wake with the typed redirect), export its
        now-final state, import it on the destination, repoint the
        placement pin (version bump + peer push — clients redirected by
        the fence land on the new owner), then drop the source copy
        (the fence stays set as a tombstone).  A failure before the
        import lands rolls the fence back instead — a half-cutover must
        never strand a live store behind a fence."""
        old = self._fleet_rpc(old_url, retries=2, exp_key=exp_key)
        old("store_fence")
        try:
            state = old("store_export")["state"]
            try:
                self._fleet_rpc(new_url, retries=2, exp_key=exp_key)(
                    "store_import", state=state)
            except NetstoreUnavailable:
                # The destination primary died under the move (a kill
                # landing mid-scale-down): fail over to its warm
                # replica — single-flight via the map version, exactly
                # like forward() — and land the import on the promoted
                # primary instead of stranding the cutover.
                with self._lock:
                    version = self._map.version
                    cur = self._map.shards[to_sid]["primary"]
                if cur == new_url and not self._promote_replica(
                        to_sid, version):
                    raise
                with self._lock:
                    new_url = self._map.shards[to_sid]["primary"]
                self._fleet_rpc(new_url, retries=2, exp_key=exp_key)(
                    "store_import", state=state)
        except Exception:
            # Bounded cutover => bounded failure: a fence must never
            # outlive a migration that moved nothing.  Lift it so the
            # donor store returns to service (documents and claims
            # intact); the caller's next tick retries the whole move.
            try:
                old("store_fence", lift=True)
            except Exception:
                logger.error(
                    "migration rollback: donor %s store %r unreachable"
                    " — fence stays up until the donor recovers",
                    old_url, exp_key)
            raise
        with self._lock:
            self._map.pin(tenant, exp_key, to_sid)
        self._push_map_to_peers()
        old("store_fence", drop=True)
        reg = _metrics.registry()
        reg.counter("router.migrated_stores").inc()
        EVENTS.emit("store_migrate", name=f"{sid}->{to_sid}",
                    exp_key=exp_key)
        logger.info("migrated store (%r, %r): shard %s -> %s",
                    tenant, exp_key, sid, to_sid)

    def _drop_agreeing_pins(self) -> None:
        """Remove every pin whose target now equals the ring owner —
        the migration's terminal cleanup (placement unchanged, map
        smaller).  Pins that still disagree (stores held in place
        because the fleet credential cannot migrate them) stay."""
        pushed = False
        with self._lock:
            keep = {}
            for key, sid in self._map.pins.items():
                t, _, k = key.partition("\x00")
                if self._map.ring.owner(t or None, k) != sid:
                    keep[key] = sid
            if keep != self._map.pins:
                self._map.pins = keep
                self._map.version += 1
                pushed = True
        if pushed:
            self._push_map_to_peers()

    def _plan_moves(self, inventory: dict, shadow_ring, target_sid=None):
        """``(moves, held)`` for a ring change: ``moves`` are stores the
        fleet credential can migrate (tenant-less namespace), ``held``
        are stores that must be pinned in place instead.  With
        ``target_sid`` only moves landing there count (shard_add);
        without, every store whose owner changes counts (shard_remove
        passes the donor's inventory only)."""
        moves, held = [], []
        for sid, rows in inventory.items():
            for row in rows:
                if row.get("fenced"):
                    t0, k0 = row.get("tenant"), row["exp_key"]
                    with self._lock:
                        live = bool(row.get("docs")) and (
                            self._map.owner(t0, k0)[0] == sid)
                    if not live:
                        continue        # tombstone or moved-away copy
                    # A fenced row the map still routes here is a
                    # half-migrated store (rollback could not reach
                    # the donor) — plan it like any other move;
                    # re-fencing is idempotent and the export path
                    # reads through the fence.
                t, k = row.get("tenant"), row["exp_key"]
                dest = shadow_ring.owner(t, k)
                if dest == sid or (target_sid is not None
                                   and dest != target_sid):
                    continue
                (moves if t is None else held).append(
                    {"from": sid, "to": dest, "tenant": t, "exp_key": k})
        return moves, held

    def _shard_add_verb(self, req: dict) -> dict:
        """Grow the fleet: add shard ``req["shard"]`` (primary
        ``req["url"]``, optional ``req["replica"]``) to the ring and
        migrate the stores the ring now places there, one bounded
        per-store cutover at a time.  Stores the fleet credential
        cannot address (other tenants' namespaces) are pinned to their
        current shard instead — placement never dangles."""
        sid = str(req["shard"])
        new_url = str(req["url"]).rstrip("/")
        if not self._topology_lock.acquire(blocking=False):
            raise RuntimeError("another topology change is in progress")
        try:
            with self._lock:
                if sid in self._map.shards:
                    raise ValueError(f"shard {sid!r} already in the map")
                shadow = ShardMap(
                    {**self._map.shards,
                     sid: {"primary": new_url,
                           "replica": req.get("replica")}},
                    virtual_nodes=self._map.ring.virtual_nodes)
            inventory = self._fleet_inventory()
            moves, held = self._plan_moves(inventory, shadow.ring,
                                           target_sid=sid)
            with self._lock:
                self._map.add_shard(sid, {"primary": new_url,
                                          "replica": req.get("replica")})
                # Hold EVERY affected store at its current owner before
                # the new ring placement becomes visible; migrations
                # below repoint the movable ones pin by pin.
                for mv in moves + held:
                    self._map.pin(mv["tenant"], mv["exp_key"],
                                  mv["from"])
            self._push_map_to_peers()
            for mv in moves:
                # Resolve the donor at move time: a failover landing
                # mid-loop repoints its primary under us.
                with self._lock:
                    from_url = self._map.shards[mv["from"]]["primary"]
                self._migrate_store(mv["from"], from_url, sid, new_url,
                                    mv["tenant"], mv["exp_key"])
            self._drop_agreeing_pins()
            reg = _metrics.registry()
            reg.counter("router.shard_adds").inc()
            if held:
                reg.counter("router.migrate.pinned").inc(len(held))
            with self._lock:
                version = self._map.version
            EVENTS.emit("router_shard_add", name=sid, url=new_url)
            logger.warning("shard %s ADDED at %s (%d store(s) migrated,"
                           " %d held in place)", sid, new_url,
                           len(moves), len(held))
            return {"shard": sid, "primary": new_url, "version": version,
                    "migrated": len(moves), "held": len(held)}
        finally:
            self._topology_lock.release()

    def _shard_remove_verb(self, req: dict) -> dict:
        """Shrink the fleet: migrate every store off shard
        ``req["shard"]``, then drop it from the ring.  Refused when the
        donor hosts stores the fleet credential cannot migrate — a
        shrink must never strand another tenant's data."""
        sid = str(req["shard"])
        if not self._topology_lock.acquire(blocking=False):
            raise RuntimeError("another topology change is in progress")
        try:
            with self._lock:
                if sid not in self._map.shards:
                    raise ValueError(f"unknown shard {sid!r}")
                if len(self._map.shards) == 1:
                    raise ValueError("cannot remove the last shard")
                donor_url = self._map.shards[sid]["primary"]
                shadow = ShardMap(
                    {s: e for s, e in self._map.shards.items()
                     if s != sid},
                    virtual_nodes=self._map.ring.virtual_nodes)
            rows = self._fleet_rpc(donor_url,
                                   retries=2)("stores")["stores"]
            moves, held = self._plan_moves({sid: rows}, shadow.ring)
            if held:
                raise RuntimeError(
                    f"shard {sid!r} hosts {len(held)} store(s) in other "
                    "tenants' namespaces; the fleet credential cannot "
                    "migrate them — refusing the shrink")
            for mv in moves:
                # Resolve the destination at move time: an earlier move
                # in this loop may have failed the destination over.
                with self._lock:
                    dest_url = self._map.shards[mv["to"]]["primary"]
                self._migrate_store(sid, donor_url, mv["to"], dest_url,
                                    mv["tenant"], mv["exp_key"])
            with self._lock:
                self._map.remove_shard(sid)
                version = self._map.version
            self._push_map_to_peers()
            self._drop_agreeing_pins()
            _metrics.registry().counter("router.shard_removes").inc()
            EVENTS.emit("router_shard_remove", name=sid)
            logger.warning("shard %s REMOVED (%d store(s) migrated off)",
                           sid, len(moves))
            return {"shard": sid, "version": version,
                    "migrated": len(moves)}
        finally:
            self._topology_lock.release()

    # -- autoscaler attachment ------------------------------------------------

    def attach_autoscaler(self, autoscaler) -> None:
        """Wire an :class:`~.autoscaler.Autoscaler`: its status (recent
        decisions, SLO burn, shed level) rides this router's
        ``/metrics`` payload, the control plane next to the data
        plane."""
        self._autoscaler = autoscaler

    # -- fleet-merged metrics -------------------------------------------------

    def _fetch_shard_metrics(self, url: str) -> dict:
        from ..parallel.netstore import _rpc_pool
        _faults.maybe_fail("rpc.send", verb="metrics", url=url)
        headers = ({"X-Netstore-Token": self._token}
                   if self._token else {})
        _status, body = _rpc_pool().request(f"{url}/metrics", None,
                                            headers,
                                            min(self.timeout, 5.0))
        return json.loads(body)

    def metrics_payload(self) -> dict:
        """``GET /metrics``: the router's own snapshot plus a ``router``
        section (per-shard liveness + summary) and ``merged`` (every
        live shard's snapshot exactly merged).  A shard that does not
        answer renders as degraded instead of failing the whole pull."""
        snap = _metrics.registry().snapshot(states=True)
        with self._lock:
            doc = self._map.to_dict()
        shards, members, n_workers = {}, [], 0
        for sid, ent in doc["shards"].items():
            info = {"url": ent["primary"], "replica": ent["replica"]}
            try:
                m = self._fetch_shard_metrics(ent["primary"])
                info["ok"] = True
                fleet = m.get("fleet") or {}
                info["n_workers"] = fleet.get("n_workers", 0)
                n_workers += info["n_workers"]
                info["verb_calls"] = sum(
                    v for k, v in (m.get("counters") or {}).items()
                    if k.startswith("netstore.verb.")
                    and k.endswith(".calls"))
                info["alerts_firing"] = sum(
                    1 for a in m.get("alerts", []) if a.get("firing"))
                members.append(m)
            except Exception as e:
                info["ok"] = False
                info["error"] = f"{type(e).__name__}: {e}"
            shards[sid] = info
        snap["router"] = {"version": doc["version"],
                          "virtual_nodes": doc["virtual_nodes"],
                          "n_shards": len(shards), "shards": shards,
                          "pins": len(doc.get("pins", {})),
                          "peers": list(self._peers)}
        if self._autoscaler is not None:
            try:
                snap["autoscale"] = self._autoscaler.status()
            except Exception as e:     # a sick autoscaler must not
                snap["autoscale"] = {  # take /metrics down with it
                    "error": f"{type(e).__name__}: {e}"}
        merged = _metrics.merge_snapshots(members) if members else {}
        snap["merged"] = merged
        snap["fleet"] = {"n_workers": n_workers, "workers": {},
                         "merged": merged}
        return snap


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _parse_shard_spec(spec: str):
    """``SID=PRIMARY_URL[,REPLICA_URL]`` -> (sid, entry)."""
    if "=" not in spec:
        raise ValueError(f"--shard {spec!r}: want "
                         "SID=PRIMARY_URL[,REPLICA_URL]")
    sid, _, urls = spec.partition("=")
    primary, _, replica = urls.partition(",")
    if not sid or not primary:
        raise ValueError(f"--shard {spec!r}: want "
                         "SID=PRIMARY_URL[,REPLICA_URL]")
    return sid, {"primary": primary, "replica": replica or None}


def main(argv=None):
    """``python -m hyperopt_tpu_torch.service.router --serve --shard
    s0=http://...:8418,http://...:8428 ...``: front a shard fleet."""
    import argparse

    p = argparse.ArgumentParser(
        description="hyperopt_tpu_torch fleet router (consistent-hash "
                    "front over ShardServer processes)")
    p.add_argument("--serve", action="store_true", required=True)
    p.add_argument("--shard", action="append", required=True,
                   metavar="SID=PRIMARY[,REPLICA]",
                   help="one shard's id, primary URL and optional warm "
                        "replica URL (repeat per shard)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8419)
    p.add_argument("--token", default=None,
                   help="fleet credential: gates the router's own "
                        "verbs/metrics and authenticates promote/scrub/"
                        "rebalance calls to shards (tenant fleets: use "
                        "a dedicated ops tenant's token)")
    p.add_argument("--tenants-file", default=None,
                   help="JSON tenant table: rejects unknown tokens at "
                        "the edge and keys placement by tenant name")
    p.add_argument("--peer", action="append", default=None,
                   metavar="URL",
                   help="HA peer router URL (repeat per peer): map "
                        "changes gossip via map_sync, adopt-iff-newer, "
                        "so N routers behind one address stay "
                        "consistent")
    p.add_argument("--virtual-nodes", type=int, default=None,
                   help="ring points per shard (default 64)")
    p.add_argument("--cutover-window", type=float, default=None,
                   metavar="S",
                   help="bounded rebalance cutover window (default 5 s)")
    p.add_argument("--retries", type=int, default=None,
                   help="transport retries per forward (default 2)")
    p.add_argument("--backoff", type=float, default=None, metavar="S",
                   help="first retry backoff (default 0.05 s)")
    p.add_argument("--flight-dir", default=None,
                   help="arm the flight recorder for router postmortems "
                        "(default: off)")
    args = p.parse_args(argv)

    shards = dict(_parse_shard_spec(s) for s in args.shard)
    tenants = None
    if args.tenants_file:
        from .tenancy import TenantTable
        tenants = TenantTable.from_file(args.tenants_file)

    server = Router(shards, host=args.host, port=args.port,
                    token=args.token, tenants=tenants,
                    virtual_nodes=args.virtual_nodes,
                    cutover_window_s=args.cutover_window,
                    retries=args.retries, backoff=args.backoff,
                    peers=args.peer)
    print(f"router: serving {len(shards)} shard(s) at {server.url}",
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
        print(f"router: flight recorder armed -> {flight_dir}",
              flush=True)
    try:
        server.serve_forever()
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        server.shutdown()
        print("router: shut down", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

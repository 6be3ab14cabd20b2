"""Network front-end for the file store: many hosts without a shared mount.

Counterpart of ``hyperopt_tpu/parallel/netstore.py`` (the reference's
MongoTrials tier: driver and workers need only TCP reachability), with
the same verbs, the same JSON documents and the same binary frames
(:mod:`..wire`), so that a client of either package talks to a server of
the other.  Only the pickled ``Domain`` is package-specific.

Design: serialize, don't re-implement.

* :class:`StoreServer` owns a store directory on its local disk and runs
  every verb against a real :class:`~.filestore.FileTrials` under one
  lock: the claim, heartbeat and requeue machinery is the file store's
  own code, and the server adds only transport.  Read-only verbs skip
  the write lock (``read_dispatch=True``).  The ``suggest`` verb runs a
  registered head (``backends.server_table()``) against the server's
  store on the device of the published domain (``domain.cs.device``;
  CUDA when the domain names none), so that a thin client needs neither
  a card nor the objective's code.
* :class:`NetTrials` is a :class:`~..base.Trials` whose document IO is
  RPC; ``fmin`` drives it like ``FileTrials`` (``asynchronous = True``).
  :func:`server_suggest` is an ``fmin`` algo that asks the server.
* :class:`NetWorker` is a :class:`~.filestore.FileWorker` bound to a
  ``NetTrials``.
* :class:`RouterTrials` is a ``NetTrials`` placed through a fleet router
  (``service/router.py``): it pulls the shard map and talks to the
  owning shard directly (:class:`_RoutedRpc`).

The server also keeps what the service tier's RAM store
(``service.store.MemTrials``) needs: the per-store migration verbs
(``store_fence``, ``store_import``, ``store_export``), the ``stores``
inventory, the typed ``ShardFenced`` refusal (HTTP 409), delta reads
through the store's ``export_docs``/``docs_since``, and the cohort gate's
``_fleet_rows`` on the ``suggest`` verb.

Wire: JSON verbs over HTTP POST, or the binary frame for the bulk-doc
verbs (``wire.set_mode``), over pooled keep-alive HTTP/1.1 sockets
(:class:`_ConnectionPool`, ``set_rpc_pool_size``).  The Domain travels
as base64 cloudpickle: only run a StoreServer for workers you trust
(unpickling is code execution).  Attachments go through a restricted
unpickler (:func:`safe_loads`).

Authentication: ``token=`` (``--token``) on server and clients makes every
verb require the shared secret in the ``X-Netstore-Token`` header,
compared in constant time before dispatch; a ``tenants=`` table
(:class:`~..service.tenancy.TenantTable`) gives each tenant its own token,
quotas and store subtree.  Without either the server is open.

The JAX package's environment switches are arguments here:
``StoreServer(token=, idem_cap=, idem_ttl_s=, read_dispatch=)``,
``NetTrials(token=, retries=, backoff=, backpressure_retries=,
reserve_wait_s=)``, ``RouterTrials(map_refresh_s=)``,
``NetWorker(faults=)``, :func:`set_rpc_pool_size`, ``costs.arm()`` and the
CLI's ``--token``, ``--flight-dir`` and ``--faults``.

CLI (the console script ``hyperopt-tpu-torch-netstore``, also
``python -m hyperopt_tpu_torch.parallel.netstore``): ``--serve --root D``
hosts a store directory, ``--worker URL`` evaluates from one.
"""

from __future__ import annotations

import base64
import hmac
import io
import json
import logging
import os
import pickle
import random
import socket
import threading
import time
import uuid
import zlib
from collections import OrderedDict
from collections.abc import MutableMapping
from http import client as _http_client
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.error import URLError
from urllib.parse import urlsplit

import numpy as np

from .filestore import FileTrials, FileWorker, _pickler
from ..base import JOB_STATE_RUNNING, Trials, docs_from_samples
from ..exceptions import (Backpressure, InjectedFault, NetstoreUnavailable,
                          QuotaExceeded, ShardFenced)
from ..obs import bundle as _obs_bundle
from ..obs import context as _context
from ..obs import costs as _obs_costs
from ..obs import device as _obs_device
from ..obs import export as _obs_export
from ..obs import flight as _flight
from ..obs import health as _obs_health
from ..obs import metrics as _metrics
from ..obs import slo as _obs_slo
from ..obs import timeseries as _obs_ts
from ..obs.events import EVENTS
from .. import faults as _faults
from .. import wire as _wire

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# restricted attachment codec
# ---------------------------------------------------------------------------

#: Globals the attachment unpickler will resolve — stdlib scalar/container
#: constructors plus the numpy ndarray/scalar reconstruction machinery
#: (both the pre-2.x ``numpy.core`` and 2.x ``numpy._core`` module paths).
#: Everything else — os.system reduce payloads, arbitrary class
#: construction — is refused before any object is built.
_SAFE_GLOBALS = frozenset({
    ("builtins", "complex"), ("builtins", "set"), ("builtins", "frozenset"),
    ("builtins", "bytearray"), ("builtins", "range"), ("builtins", "slice"),
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy._core.numeric", "_frombuffer"),
})


class _RestrictedUnpickler(pickle.Unpickler):
    """Allowlist unpickler for wire-crossing attachment blobs.

    ``pickle.loads`` on bytes a network peer controls is arbitrary code
    execution; attachments only need plain data (numbers, strings,
    containers, numpy arrays), so anything outside :data:`_SAFE_GLOBALS`
    is rejected with ``UnpicklingError``.  Scalars, strings, dicts,
    lists and tuples never hit ``find_class`` at all — they decode from
    dedicated opcodes."""

    def find_class(self, module, name):
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"attachment blob requested forbidden global "
            f"{module}.{name} — only plain data and numpy arrays "
            f"cross this boundary")


def safe_loads(blob: bytes):
    """Decode an attachment blob through the restricted unpickler."""
    return _RestrictedUnpickler(io.BytesIO(blob)).load()


# ---------------------------------------------------------------------------
# auth
# ---------------------------------------------------------------------------


def _resolve_token(token: str | None) -> str | None:
    """Effective shared secret: empty or None means no auth (an open
    server, the localhost-trusted default)."""
    return token or None


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class _KeepAliveHTTPServer(ThreadingHTTPServer):
    """:class:`ThreadingHTTPServer` that severs live keep-alive
    connections on close.  With HTTP/1.1 reuse, daemon handler threads
    would otherwise keep serving established sockets after the listener
    dies — a closed server must go dark, not half-alive (failover
    promotion and graceful SIGTERM both rely on it)."""

    def __init__(self, *args, **kwargs):
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def server_close(self):
        super().server_close()
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


class _LeanHeaders:
    """Just-enough stand-in for ``email.message.Message`` on the
    server's request hot path: the verb handlers only ever ``.get`` a
    handful of plain headers."""

    __slots__ = ("_d",)

    def __init__(self, d: dict):
        self._d = d

    def get(self, name, default=None):
        return self._d.get(name.lower(), default)

    def __contains__(self, name):
        return name.lower() in self._d


class _LeanRequestHandler(BaseHTTPRequestHandler):
    """``BaseHTTPRequestHandler`` with a fast request-parse path.

    The stock ``parse_request`` routes every request's header block
    through ``email.parser`` — ~100 µs per verb, comparable to a whole
    cached-read dispatch.  Verb traffic is uniform ("POST /path
    HTTP/1.1" plus a few plain headers), so the common case is parsed
    with a handful of ``partition`` calls; anything unusual (HTTP/1.0,
    other versions, oversized lines) falls back to the stock parser
    for strictness."""

    def handle_one_request(self):
        try:
            self.raw_requestline = self.rfile.readline(65537)
            if len(self.raw_requestline) > 65536:
                self.requestline = ""
                self.request_version = ""
                self.command = ""
                self.send_error(414)
                return
            if not self.raw_requestline:
                self.close_connection = True
                return
            words = self.raw_requestline.split()
            if len(words) == 3 and words[2] == b"HTTP/1.1":
                self.command = words[0].decode("latin-1")
                self.path = words[1].decode("latin-1")
                self.request_version = "HTTP/1.1"
                self.requestline = self.raw_requestline.decode(
                    "latin-1").rstrip("\r\n")
                hdrs: dict = {}
                while True:
                    line = self.rfile.readline(65537)
                    if line in (b"\r\n", b"\n", b""):
                        break
                    if len(line) >= 65536 or len(hdrs) >= 100:
                        self.send_error(431)
                        return
                    key, sep, val = line.partition(b":")
                    if not sep or key != key.strip():
                        # Folded (obs-fold) or malformed header — no
                        # client of ours emits these, and the lines are
                        # already consumed, so reject rather than guess.
                        self.send_error(400, "Bad header line")
                        return
                    hdrs[key.lower().decode("latin-1")] = (
                        val.strip().decode("latin-1"))
                self.headers = _LeanHeaders(hdrs)
                self.close_connection = (
                    hdrs.get("connection", "").lower() == "close")
            elif not self.parse_request():
                return
            mname = "do_" + self.command
            if not hasattr(self, mname):
                self.send_error(
                    501, "Unsupported method (%r)" % self.command)
                return
            getattr(self, mname)()
            self.wfile.flush()
        except TimeoutError as e:
            self.log_error("Request timed out: %r", e)
            self.close_connection = True


class _ClaimGate:
    """Wake-up channel for long-poll ``reserve``: one condition variable
    plus a generation counter per ``(tenant, exp_key)``.  A reserver
    snapshots the generation, attempts the claim, and parks only if the
    generation is unchanged — :meth:`signal`'s bump-then-notify makes a
    wakeup that lands between attempt and park impossible to lose."""

    __slots__ = ("_cv", "_gen")

    def __init__(self):
        self._cv = threading.Condition()
        self._gen = 0

    def snapshot(self) -> int:
        with self._cv:
            return self._gen

    def wait(self, gen0: int, timeout: float) -> bool:
        """Park until a signal newer than ``gen0`` (or ``timeout``);
        True iff (possibly) signaled."""
        with self._cv:
            if self._gen != gen0:
                return True
            return self._cv.wait(timeout)

    def signal(self) -> None:
        with self._cv:
            self._gen += 1
            self._cv.notify_all()


def _is_plain_json(x) -> bool:
    """True iff ``x`` is already canonical plain-JSON data: exactly the
    builtin container/scalar types (subclasses like ``np.float64`` fail
    the ``type`` check and force the normalizing roundtrip)."""
    t = type(x)
    if t is dict:
        return all(type(k) is str and _is_plain_json(v)
                   for k, v in x.items())
    if t is list:
        return all(_is_plain_json(v) for v in x)
    return t in (str, int, float, bool) or x is None


def _canon_docs(docs: list) -> list:
    """Canonical plain-JSON form of proposal docs.

    ``docs_from_samples`` already emits plain ``int``/``float``/``str``
    containers, so the ``json.loads(json.dumps(docs))`` round trip is
    skipped when the tree is verifiably canonical; it runs when a head
    hands back numpy scalars or tuples, so that stored docs are plain
    JSON like every other doc."""
    if _is_plain_json(docs):
        return docs
    return json.loads(json.dumps(docs))


class StoreServer:
    """Serve a local store directory to remote drivers/workers.

    ``serve_forever`` blocks; ``start()`` runs in a daemon thread and
    returns the bound ``(host, port)``; tests and same-process drivers use
    that.  One write lock serializes every mutating verb (each is
    microseconds of local file IO; the objective evaluations happen in
    the workers); read-only verbs skip it when ``read_dispatch`` is on.

    Device work (the ``suggest`` verb's head, and the introspection fit
    of the ``health`` verb) runs under :attr:`device_lock`, one lock for
    the server: the heads' cached programs and device tensors on the
    published domain are never used by two of its threads at once.

    ``idem_cap``/``idem_ttl_s`` bound the idempotency reply cache;
    ``read_dispatch=False`` makes the read verbs queue on the write lock
    too (the A/B arm of the lock-free read path).
    """

    #: Bounds on the idempotency dedup cache (completed mutating calls
    #: kept for replay): LRU capacity + TTL, the defaults of
    #: ``idem_cap``/``idem_ttl_s``.  Retries
    #: arrive within seconds of the original, so thousands of entries /
    #: minutes of TTL are generations of headroom — the bound exists so
    #: a long-running fleet's cache cannot grow without limit.
    _IDEM_CAP = 4096
    _IDEM_TTL_S = 900.0

    #: Server-side ceiling on one long-poll ``reserve`` park (seconds);
    #: clients asking for more are clamped — a parked claim must not
    #: outlive intermediary idle timeouts by much.
    _LONGPOLL_CAP_S = 30.0

    #: Verbs read-only by construction: no write lock, served by
    #: ``_dispatch_read`` so a poll-heavy fleet never queues behind a
    #: mutating verb.  The same catalog as the JAX package's.
    _READONLY_VERBS = frozenset({
        "metrics", "health", "bundle", "docs", "fetch_since",
        "get_domain", "att_get", "att_keys", "stores", "store_export"})

    #: Verbs whose success may make a claim (or a claims-quota slot)
    #: available: each wakes the exp_key's parked long-poll reserves.
    #: ``store_fence`` wakes them for the opposite reason: a parked
    #: claimant on a store that just fenced for migration must surface
    #: the typed redirect now, not doze out its wait budget.
    _LONGPOLL_WAKE = frozenset({
        "insert_docs", "suggest", "requeue_stale", "write_result",
        "store_fence"})

    #: Verbs that ADMIT new work into the system (docs inserted, ids
    #: allocated, proposals computed).  These — and only these — are
    #: refused with a typed retriable :class:`Backpressure` while a
    #: shed directive is active: producers are throttled, while
    #: consumers (reserve / write_result / heartbeat) keep running so
    #: the backlog drains instead of wedging.
    _ADMISSION_VERBS = frozenset({"insert_docs", "new_trial_ids",
                                  "suggest"})

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0,
                 token: str | None = None,
                 requeue_stale_every: float | None = None,
                 stale_timeout: float = 60.0,
                 tenants=None,
                 scrape_interval: float | None = None,
                 slos=None, idem_cap: int = _IDEM_CAP,
                 idem_ttl_s: float = _IDEM_TTL_S,
                 read_dispatch: bool = True):
        self.root = os.path.abspath(root)
        self._trials: dict = {}          # (tenant_name, exp_key) -> store
        self._lock = threading.RLock()
        #: Serializes the server's device work (see the class docstring).
        self.device_lock = threading.RLock()
        self._token = _resolve_token(token)
        # Multi-tenant mode: a service.tenancy.TenantTable (anything with
        # .resolve(token) -> tenant).  When set, every verb authenticates
        # as SOME tenant and the dispatch layer namespaces exp_keys into
        # the tenant's own store subtree — the store key derives from the
        # authenticated identity, never from the request body.
        self._tenants = tenants
        # Exactly-once under client retry: (tenant, exp_key, idem_key) ->
        # (t_monotonic, JSON reply) of the first execution.  Stored
        # serialized so a replay can never alias live server-side state;
        # LRU + TTL bounded (netstore.idem.evicted counts expulsions).
        self._idem: OrderedDict = OrderedDict()
        self._idem_lock = threading.Lock()
        # Keys whose first execution is still running: concurrent
        # duplicates park on the Event instead of running the verb again
        # (the check-then-act hole between cache probe and publish).
        self._idem_inflight: dict = {}
        self._idem_cap = int(idem_cap)
        self._idem_ttl = float(idem_ttl_s)
        # Fleet metrics: worker_id -> {"t": last push wall time, "metrics":
        # the worker's cumulative registry snapshot}.  Workers piggyback
        # snapshots on heartbeats (NetTrials.heartbeat); last-write-wins
        # per worker, merged on read by metrics_payload().  Deliberately
        # NOT part of the local registry, so registry().snapshot(
        # reset=True) by a bench/test never drops the per-worker labels.
        self._fleet: dict = {}
        self._fleet_lock = threading.Lock()
        # Janitor: requeue crashed-worker claims every S seconds so the
        # recovery path runs unprompted (``--requeue-stale-every``).
        self.requeue_stale_every = requeue_stale_every
        self.stale_timeout = stale_timeout
        self._janitor: threading.Thread | None = None
        self._janitor_stop = threading.Event()
        # Observability interpretation layer (obs/): every server owns a
        # time-series store + SLO monitor; the periodic scrape loop that
        # feeds them only runs when ``scrape_interval`` is set (the
        # disabled path costs nothing — no hot-path hooks exist).
        self.scrape_interval = scrape_interval
        self.timeseries = _obs_ts.TimeSeriesStore()
        self.slo_monitor = _obs_slo.SloMonitor(
            slos if slos is not None else _obs_slo.default_slos(),
            self.timeseries)
        self._health_cache: dict | None = None
        self._scraper: threading.Thread | None = None
        self._scraper_stop = threading.Event()
        # Bounded per-tenant label set (LRU): tenant churn would
        # otherwise grow the netstore.tenant.<name>.* families forever.
        self._tenant_labels = _metrics.LabelLru()
        # Read-path concurrency (A/B knob): when on (the default) the
        # verbs in _READONLY_VERBS bypass the write lock entirely and
        # rely on each store's own internal lock.
        self._read_dispatch = bool(read_dispatch)
        # Long-poll claim gates: (tenant, exp_key) -> _ClaimGate.  Grows
        # with the store table (same key space), never shrinks.
        self._claim_gates: dict = {}
        self._claim_gates_lock = threading.Lock()
        # Load-shed directive (autoscaler-driven graceful degradation):
        # {"level": 0..1, "retry_after_s": float, "until": monotonic
        # deadline} or None.  Ephemeral by design: a restarted server
        # comes back accepting traffic.
        self._shed: dict | None = None
        self._shed_rng = random.Random(0x5EED)
        # Flight-bundle sections owned by this server: the time-series
        # window, SLO alert states and cached health verdicts travel in
        # every postmortem dump while the server lives.
        _obs_bundle.register_provider("series", self.timeseries.export_series)
        _obs_bundle.register_provider("slo", self.slo_monitor.status)
        _obs_bundle.register_provider(
            "health", lambda: self._health_cache or {})
        self._started = False
        self._closed = False
        self._lifecycle_lock = threading.Lock()
        server = self

        class Handler(_LeanRequestHandler):
            # HTTP/1.1 so the client pool's sockets stay open between
            # verbs (the 1.0 default would close after every reply);
            # every response path sets Content-Length, which keep-alive
            # requires.
            protocol_version = "HTTP/1.1"
            # Nagle off: on a persistent connection a small reply would
            # otherwise sit in the kernel waiting for the client's
            # delayed ACK (~40 ms per verb — the classic small-write
            # stall; one-shot urlopen never saw it because close()
            # flushed).
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):   # quiet by default
                logger.debug("netstore: " + fmt, *args)

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code, body: bytes):
                self._send(code, body, "application/json")

            def _reject(self):
                _metrics.registry().counter("netstore.auth.rejected").inc()
                self.rfile.read(
                    int(self.headers.get("Content-Length", "0")))
                self._send_json(401, json.dumps(
                    {"error": "AuthError: missing or bad "
                     "X-Netstore-Token"}).encode())

            def _authed(self) -> bool:
                # Auth gate BEFORE the body is parsed or any verb runs:
                # constant-time compare so the secret can't be recovered
                # byte-by-byte from response timing.  The request body is
                # still drained (keep-alive correctness) but never
                # dispatched.  Multi-tenant mode resolves the token to a
                # Tenant (itself a full-table constant-time scan); the
                # tenant identity then namespaces every verb of this
                # request — it comes from the header, never the body.
                self._tenant = None
                if server._tenants is not None:
                    got = self.headers.get("X-Netstore-Token", "")
                    tenant = server._tenants.resolve(got)
                    if tenant is None:
                        self._reject()
                        return False
                    self._tenant = tenant
                    return True
                if server._token is None:
                    return True
                got = self.headers.get("X-Netstore-Token", "")
                if hmac.compare_digest(got.encode(),
                                       server._token.encode()):
                    return True
                self._reject()
                return False

            def do_POST(self):
                if not self._authed():
                    return
                framed = False
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    raw = self.rfile.read(n) or b"{}"
                    # Content negotiation by magic sniff (not by header):
                    # a shard router forwards opaque bodies with its own
                    # Content-Type, so the bytes themselves are the only
                    # trustworthy signal.  The reply is framed iff
                    # the request was — JSON peers never see a frame.
                    if _wire.is_frame(raw):
                        if _wire.mode() == "json":
                            raise _wire.WireError(
                                "binary frame refused (wire mode "
                                "json)")
                        framed = True
                        reg = _metrics.registry()
                        reg.counter("wire.frames").inc()
                        reg.counter("wire.bytes_rx").inc(len(raw))
                        req = _wire.decode(bytes(raw))
                    else:
                        req = json.loads(raw)
                    out = server._dispatch(req, tenant=self._tenant)
                    if framed:
                        body = _wire.encode(out)
                        _metrics.registry().counter(
                            "wire.bytes_tx").inc(len(body))
                        self._send(200, body, _wire.CONTENT_TYPE)
                        return
                    body = json.dumps(out).encode()
                    code = 200
                except Backpressure as e:
                    # Deliberate load shed, not a server fault: a typed
                    # retriable refusal with the server's own price
                    # attached.  503, never 500 — well-behaved clients
                    # sleep retry_after_s and try again without burning
                    # transport retry budget.
                    body = json.dumps(
                        {"error": f"Backpressure: {e}",
                         "retry_after_s": e.retry_after_s}).encode()
                    code = 503
                except ShardFenced as e:
                    # Typed retriable redirect: the store/shard is mid-
                    # cutover; the client should refresh its shard map
                    # and re-place itself, not retry here.
                    body = json.dumps(
                        {"error": f"ShardFenced: {e}"}).encode()
                    code = 409
                except Exception as e:  # surface server faults to the client
                    body = json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode()
                    code = 500
                self._send_json(code, body)

            def do_GET(self):
                # Read-only metrics surface, token-gated like every verb:
                # ``GET /metrics`` returns the process-global registry
                # snapshot (counters/gauges/histograms/kernel_cache) plus
                # the ``fleet`` view (per-worker labeled snapshots pushed
                # on heartbeats + exactly-merged histograms) so an
                # operator can curl the server a driver and workers feed.
                if not self._authed():
                    return
                if self.path.split("?", 1)[0] == "/metrics":
                    payload = server.metrics_payload()
                    # Content negotiation: a standard Prometheus/
                    # OpenMetrics scraper announces itself via Accept
                    # and gets the wire-correct text exposition
                    # (local + fleet-merged series); everything else
                    # keeps the historical JSON document.
                    if _obs_export.wants_openmetrics(
                            self.headers.get("Accept", "")):
                        body = _obs_export.render_openmetrics(
                            payload).encode("utf-8")
                        self._send(200, body, _obs_export.CONTENT_TYPE)
                        return
                    body = json.dumps(payload).encode()
                    self._send_json(200, body)
                    return
                self._send_json(404, json.dumps(
                    {"error": f"NotFound: {self.path}"}).encode())

        self._httpd = _KeepAliveHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        self._started = True
        self._start_janitor()
        self._start_scraper()
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                             name="netstore-server")
        t.start()
        return self.host, self.port

    def serve_forever(self):
        self._started = True
        self._start_janitor()
        self._start_scraper()
        self._httpd.serve_forever()

    def shutdown(self):
        """Stop serving and release the socket.

        Idempotent, and safe when ``start()``/``serve_forever()`` never
        ran (``ThreadingHTTPServer.shutdown`` would otherwise block
        forever waiting on a serve loop that does not exist).
        """
        with self._lifecycle_lock:
            if self._closed:
                return
            self._closed = True
        for section in ("series", "slo", "health"):
            _obs_bundle.unregister_provider(section)
        self._janitor_stop.set()
        self._scraper_stop.set()
        if self._janitor is not None:
            self._janitor.join(timeout=5.0)
        if self._scraper is not None:
            self._scraper.join(timeout=5.0)
        if self._started:
            self._httpd.shutdown()
        self._httpd.server_close()

    def _start_janitor(self):
        if not self.requeue_stale_every or self._janitor is not None:
            return
        self._janitor = threading.Thread(target=self._janitor_loop,
                                         daemon=True,
                                         name="netstore-janitor")
        self._janitor.start()

    def _start_scraper(self):
        if not self.scrape_interval or self._scraper is not None:
            return
        self._scraper = threading.Thread(target=self._scraper_loop,
                                         daemon=True,
                                         name="netstore-scraper")
        self._scraper.start()

    def _scraper_loop(self):
        while not self._scraper_stop.wait(self.scrape_interval):
            try:
                self.observe_pass()
            except Exception:    # scraper must outlive any bad series
                logger.exception("netstore scraper: observe pass failed")

    def observe_pass(self, now: float | None = None) -> list:
        """One interpretation tick (the scrape loop's body, callable
        directly by tests and benches): publish device-runtime and
        fleet-liveness gauges, scrape the registry into the time-series
        store, evaluate the SLO monitor, and refresh the cheap
        (history-only) health verdicts the live dashboard shows.
        Returns the SLO status list."""
        _obs_device.collect()
        self._fleet_liveness_gauge()
        self.timeseries.scrape(now=now)
        status = self.slo_monitor.evaluate(now=now)
        try:
            self._health_cache = self._assess_health(introspect=False)
        except Exception:
            logger.exception("netstore scraper: health pass failed")
        return status

    def _fleet_liveness_gauge(self) -> float:
        """Fraction of pushed workers whose last heartbeat is fresh
        (< 30 s, the dashboard's own STALE rule); 1.0 with no fleet.
        Feeds the ``worker_liveness`` SLO via the time-series store."""
        now = time.time()
        with self._fleet_lock:
            ages = [now - rec.get("t", now)
                    for rec in self._fleet.values()]
        live = sum(1 for a in ages if a < 30.0)
        frac = (live / len(ages)) if ages else 1.0
        _metrics.registry().gauge("fleet.live_fraction").set(frac)
        return frac

    def _janitor_loop(self):
        # wait() (not sleep) so shutdown() interrupts a long period
        # immediately; first pass only after one full period.
        while not self._janitor_stop.wait(self.requeue_stale_every):
            try:
                self._janitor_pass()
            except Exception:       # janitor must outlive any bad store
                logger.exception("netstore janitor: requeue_stale failed")

    def _janitor_pass(self):
        # Overridable: a write-ahead-logged server routes these requeues
        # through its log.
        with self._lock:
            stores = list(self._trials.items())
        for (tname, exp_key), ft in stores:
            with self._lock:
                n = ft.requeue_stale(self.stale_timeout)
            if n:
                logger.info("netstore janitor: requeued %d stale "
                            "trial(s) in %r", n, ft._exp_key)
                # Requeued claims are claimable again: wake this
                # store's parked long-poll reserves.
                self._signal_claims(tname, exp_key)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- verbs ---------------------------------------------------------------

    def _store(self, exp_key: str, tenant=None) -> FileTrials:
        """Caller holds ``self._lock``.

        Tenant namespacing happens HERE and only here: the store key
        pairs the authenticated tenant name with the client's exp_key,
        and each tenant's files live under their own subtree.  The
        exp_key inside the documents stays the client's own (the doc
        filter ``_exp_key in (None, d["exp_key"])`` must keep matching).
        """
        tname = getattr(tenant, "name", tenant)
        key = (tname, exp_key)
        ft = self._trials.get(key)
        if ft is None:
            root = os.path.join(self.root, tname) if tname else self.root
            ft = self._trials[key] = FileTrials(root, exp_key=exp_key)
        return ft

    def _idem_put(self, key, payload: str):
        evicted = 0
        with self._idem_lock:
            self._idem[key] = (time.monotonic(), payload)
            self._idem.move_to_end(key)
            # Expire from the cold end: TTL first, then LRU overflow.
            now = time.monotonic()
            while self._idem:
                k, (t, _) = next(iter(self._idem.items()))
                if now - t > self._idem_ttl or len(self._idem) > self._idem_cap:
                    self._idem.popitem(last=False)
                    evicted += 1
                else:
                    break
        if evicted:
            _metrics.registry().counter("netstore.idem.evicted").inc(evicted)

    def _idem_execute(self, key, run):
        """At-most-once execution of ``run()`` for idempotency ``key``.

        Returns ``(reply_dict, replayed)``.  The cache probe and the
        in-flight claim are one atomic step under ``_idem_lock``, so two
        concurrent retries of the same key cannot both miss and run the
        verb twice: the loser parks on the winner's Event and re-reads
        the cache once the winner publishes.  If the winner's verb
        raises, nothing is published and the waiter claims the key
        itself — ordinary retry semantics.
        """
        while True:
            with self._idem_lock:
                hit = self._idem.get(key)
                if hit is not None:
                    t, payload = hit
                    if time.monotonic() - t <= self._idem_ttl:
                        self._idem.move_to_end(key)      # LRU touch
                        return json.loads(payload), True
                    del self._idem[key]
                    _metrics.registry().counter("netstore.idem.evicted").inc()
                ev = self._idem_inflight.get(key)
                if ev is None:
                    ev = self._idem_inflight[key] = threading.Event()
                    break
            # A duplicate of an in-flight call: wait for its publish,
            # then loop — cache hit replays it, a failure re-claims.
            ev.wait()
        try:
            out = run()
            self._idem_put(key, json.dumps(out))
            return out, False
        finally:
            with self._idem_lock:
                self._idem_inflight.pop(key, None)
            ev.set()

    def _dispatch(self, req: dict, tenant=None) -> dict:
        verb = req["verb"]
        reg = _metrics.registry()
        t0 = time.perf_counter()
        # Trace context stamped by the client (obs/context.py wire form):
        # adopt it for the duration of the verb so every event this
        # dispatch emits — store_claim/store_write from the filestore,
        # fault injections, the rpc instant below — attaches to the
        # originating trial and trace.
        ctx = req.pop("ctx", None)
        tname = getattr(tenant, "name", None)
        try:
            with _context.adopt(ctx):
                EVENTS.emit("rpc", name=verb)
                if verb in self._ADMISSION_VERBS:
                    # Shed gate BEFORE the idempotency machinery: a
                    # refused admission must leave no durable trace and
                    # cache no reply.
                    self._shed_gate(verb)
                idem = req.pop("idem", None)
                wait_s = req.pop("wait_s", None)
                if verb == "reserve" and wait_s:
                    # Long-poll claim: the park/retry loop runs INSIDE
                    # the idempotent execution below, so only the final
                    # answer is cached for client retries.
                    def run():
                        return self._reserve_longpoll(
                            req, tenant=tenant, wait_s=float(wait_s),
                            idem=idem)
                else:
                    def run():
                        return self._dispatch_verb(verb, req,
                                                   tenant=tenant,
                                                   idem=idem)
                if idem is None:
                    out = run()
                else:
                    # Mutating verb with an idempotency key: a retry of
                    # a call the server already executed must return the
                    # original reply, not run the verb twice (the client
                    # retries blind — it cannot know whether the loss
                    # was on the way in or out).
                    key = (tname, req.get("exp_key", "default"), idem)
                    out, replayed = self._idem_execute(key, run)
                    if replayed:
                        reg.counter("netstore.idem.hits").inc()
                if verb in self._LONGPOLL_WAKE:
                    # Outside every lock: this verb may have made a
                    # claim (or a quota slot) available — wake parked
                    # long-poll reserves for the store.
                    self._signal_claims(tname,
                                        req.get("exp_key", "default"),
                                        verb=verb, out=out)
                return out
        except Exception as e:
            # Black-box the failing dispatch before the error surfaces
            # to the client (one boolean when the recorder is disarmed).
            # Typed control-plane refusals (shed, fence) are deliberate
            # steady-state answers under overload or cutover, not
            # crashes: a backpressure storm must not spam flight bundles.
            if not isinstance(e, (Backpressure, ShardFenced)):
                _flight.on_crash("dispatch", e)
            raise
        finally:
            # Per-verb call count + latency histogram: the contention
            # signal for the single-writer lock under many workers.
            reg.counter(f"netstore.verb.{verb}.calls").inc()
            reg.histogram(f"netstore.verb.{verb}.s").observe(
                time.perf_counter() - t0)
            if tname is not None:
                # Per-tenant labels for dashboards and quota forensics.
                # The live label set is LRU-bounded: an evicted tenant's
                # whole series family is dropped (recreated from zero on
                # its next call) and obs.series_evicted counts it.
                for old in self._tenant_labels.touch(tname):
                    reg.remove_prefix(f"netstore.tenant.{old}.")
                reg.counter(
                    f"netstore.tenant.{tname}.verb.{verb}.calls").inc()
                reg.histogram(
                    f"netstore.tenant.{tname}.verb.{verb}.s").observe(
                    time.perf_counter() - t0)

    def metrics_payload(self) -> dict:
        """The ``GET /metrics`` document: local snapshot + fleet view.

        Top level keeps the historical registry-snapshot schema
        (enabled/counters/gauges/kernel_cache/histograms — now with
        mergeable ``state`` per histogram, including the server-side
        per-verb latency histograms ``netstore.verb.<verb>.s`` with
        p50/p95/p99) and adds ``fleet``:

        * ``workers`` — per-worker labels: each worker's last pushed
          cumulative snapshot plus ``age_s`` staleness (a worker whose
          age greatly exceeds its heartbeat interval is presumed dead),
        * ``merged`` — counters/gauges summed and histograms
          exactly merged (``obs.metrics.merge_snapshots``) across the
          server's own registry and every pushed worker snapshot.
        """
        snap = _metrics.registry().snapshot(states=True)
        now = time.time()
        with self._fleet_lock:
            fleet = {w: dict(rec) for w, rec in self._fleet.items()}
        workers = {}
        members = [snap]
        for w in sorted(fleet):
            rec = fleet[w]
            m = rec.get("metrics") or {}
            workers[w] = {
                "age_s": round(now - rec.get("t", now), 3),
                "counters": m.get("counters") or {},
                "gauges": m.get("gauges") or {},
                "histograms": m.get("histograms") or {},
            }
            members.append(m)
        snap["fleet"] = {
            "n_workers": len(workers),
            "workers": workers,
            "merged": _metrics.merge_snapshots(members),
        }
        # Interpretation layer: last computed health verdicts (scraper
        # pass or health verb) and current SLO alert state, so that a
        # dashboard renders them from this one payload.
        if self._health_cache is not None:
            snap["health"] = self._health_cache
        status = self.slo_monitor.status()
        if status:
            snap["alerts"] = status
        # Cost-attribution ledger (armed by ``costs.arm()``): a server
        # that suggests builds its heads' programs in-process, so its
        # ledger rows ride along.
        costs = _obs_costs.ledger_report(reg=_metrics.registry())
        if costs.get("entries") or costs.get("armed"):
            snap["costs"] = costs
        return snap

    # -- optimizer health ----------------------------------------------------

    def _assess_health(self, tenant_name=..., exp_key=None,
                       introspect=True) -> dict:
        """Health reports keyed ``"tenant/exp_key"`` (bare ``exp_key``
        in single-tenant mode).  ``tenant_name=...`` means every
        tenant (the scraper's view); a concrete name (or None in
        single-tenant mode) restricts to that namespace.  Store state
        is snapshotted under the server lock; the assessments happen
        outside it, so a health probe never stalls serving verbs.  An
        assessment that runs a backend introspection fit (device work on
        the published domain) holds :attr:`device_lock`."""
        items = []
        with self._lock:
            for (tn, ek), ft in list(self._trials.items()):
                if tenant_name is not ... and tn != tenant_name:
                    continue
                if exp_key is not None and ek != exp_key:
                    continue
                export = getattr(ft, "export_docs", None)
                if export is not None:
                    docs = export()
                else:
                    ft.refresh()
                    docs = list(ft._dynamic_trials)
                items.append((tn, ek, ft, docs,
                              getattr(ft, "_srv_last_algo", None)))
        reports = {}
        for tn, ek, ft, docs, algo_name in items:
            label = f"{tn}/{ek}" if tn else ek
            domain = suggest_fn = None
            if introspect and algo_name:
                suggest_fn = self._server_algos().get(algo_name)
                try:
                    domain = self._domain_for(ft)
                except Exception:
                    logger.debug("health: domain introspection failed "
                                 "for %s; assessing without it",
                                 ek, exc_info=True)
                    domain = None
            if domain is not None and suggest_fn is not None:
                with self.device_lock:
                    rep = _obs_health.assess(
                        docs, domain=domain, trials=ft,
                        suggest_fn=suggest_fn, introspect=introspect)
            else:
                rep = _obs_health.assess(docs, introspect=introspect)
            rep["algo"] = algo_name
            _obs_health.publish(label, rep)
            reports[label] = rep
        return reports

    def _health_verb(self, req: dict, tenant=None) -> dict:
        """The read-only ``health`` verb body: fresh assessments
        (introspection included unless ``introspect: false``) for the
        caller's namespace — all of the tenant's experiments with
        ``all: true``, else just the request's ``exp_key``."""
        tname = getattr(tenant, "name", tenant)
        exp_key = None if req.get("all") else req.get("exp_key", "default")
        reports = self._assess_health(
            tenant_name=tname, exp_key=exp_key,
            introspect=bool(req.get("introspect", True)))
        self._health_cache = dict(self._health_cache or {}, **reports)
        return reports

    # -- tenant quotas -------------------------------------------------------

    def _charge_admission(self, tenant, n: int) -> None:
        """Charge ``n`` trial creations against the tenant's rate quota
        (token bucket); raises :class:`QuotaExceeded` on refusal.  Runs
        before any execution: a refused call leaves no trace in durable
        state."""
        admit = getattr(tenant, "admit_trials", None)
        if admit is None or admit(int(n)):
            return
        tname = getattr(tenant, "name", "?")
        _metrics.registry().counter(
            f"netstore.tenant.{tname}.quota.rate_rejected").inc()
        raise QuotaExceeded(
            f"tenant {tname!r}: trials/s admission quota exceeded "
            f"(rate={getattr(tenant, 'trials_per_s', None)}, asked {n})")

    def _claims_quota_hit(self, tenant) -> bool:
        """True when the tenant already holds ``max_claims`` RUNNING
        trials across all of its experiments (reserve must answer
        queue-empty so stock workers back off via their poll loop)."""
        limit = getattr(tenant, "max_claims", None)
        if limit is None:
            return False
        tname = getattr(tenant, "name", None)
        held = 0
        for (tn, _), ft in self._trials.items():
            if tn != tname:
                continue
            ft.refresh()
            held += sum(1 for d in ft._dynamic_trials
                        if d["state"] == JOB_STATE_RUNNING)
        reg = _metrics.registry()
        reg.gauge(f"netstore.tenant.{tname}.claims_held").set(held)
        if held >= limit:
            reg.counter(
                f"netstore.tenant.{tname}.quota.claims_rejected").inc()
            return True
        return False

    def _shed_gate(self, verb: str) -> None:
        """Refuse an admission verb while a shed directive is active.

        Probabilistic by ``level`` (1.0 sheds everything) so partial
        degradation is possible; the directive self-expires at its
        monotonic deadline — a dead autoscaler can throttle the fleet
        for at most one TTL."""
        shed = self._shed
        if not shed:
            return
        if time.monotonic() >= shed["until"]:
            self._shed = None
            return
        level = float(shed["level"])
        if level >= 1.0 or self._shed_rng.random() < level:
            _metrics.registry().counter("backpressure.shed").inc()
            raise Backpressure(
                f"admission shed active (level={level:.2f}): {verb} "
                "refused, retry later",
                retry_after_s=float(shed["retry_after_s"]))

    def _dispatch_verb(self, verb: str, req: dict, tenant=None,
                       idem=None) -> dict:
        if verb in self._READONLY_VERBS:
            return self._dispatch_read(verb, req, tenant=tenant)
        if verb == "shed":
            # Admission-control directive (autoscaler / operator):
            # level<=0 lifts the shed, anything else arms it for ttl_s.
            level = float(req.get("level", 1.0))
            ttl = float(req.get("ttl_s", 30.0))
            if level <= 0.0:
                self._shed = None
            else:
                self._shed = {"level": min(level, 1.0),
                              "retry_after_s": float(
                                  req.get("retry_after_s", 1.0)),
                              "until": time.monotonic() + ttl}
            _metrics.registry().gauge("backpressure.shed_level").set(
                max(0.0, min(level, 1.0)))
            return {"ok": True, "level": max(0.0, min(level, 1.0)),
                    "ttl_s": ttl}
        with self._lock:
            ft = self._store(req.get("exp_key", "default"), tenant=tenant)
            if getattr(ft, "fenced", False) and verb not in (
                    "store_fence", "store_import"):
                _metrics.registry().counter("store.fenced").inc()
                raise ShardFenced(
                    f"store {req.get('exp_key', 'default')!r} is fenced "
                    f"(migrating): refusing {verb!r}")
            if verb == "store_fence":
                ft.fence(drop=bool(req.get("drop")),
                         lift=bool(req.get("lift")))
                return {"ok": True, "dropped": bool(req.get("drop")),
                        "lifted": bool(req.get("lift"))}
            if verb == "store_import":
                state = dict(req["state"])
                state["fenced"] = False
                ft.load_state(state)
                return {"ok": True, "docs": len(state.get("docs", []))}
            if verb == "insert_docs":
                self._charge_admission(tenant, len(req["docs"]))
                return {"tids": ft._insert_trial_docs(req["docs"])}
            if verb == "new_trial_ids":
                ft.refresh()
                return {"tids": ft.new_trial_ids(int(req["n"]))}
            if verb == "reserve":
                if self._claims_quota_hit(tenant):
                    return {"doc": None, "quota": "max_claims"}
                return {"doc": ft.reserve(req["owner"])}
            if verb == "suggest":
                return self._suggest_verb(ft, req, tenant)
            if verb == "heartbeat":
                # Piggybacked fleet metrics: a worker may attach its
                # cumulative registry snapshot (last-write-wins per
                # worker id; merged on read by metrics_payload).  The
                # reply carries the server wall clock so clients can
                # estimate their skew for trace stitching.
                w = req.get("worker")
                if w is not None and req.get("metrics") is not None:
                    with self._fleet_lock:
                        self._fleet[w] = {"t": time.time(),
                                          "metrics": req["metrics"]}
                    _metrics.registry().counter(
                        "netstore.fleet.pushes").inc()
                return {"ok": ft.heartbeat(req["doc"],
                                           owner=req.get("owner")),
                        "t_wall": time.time()}
            if verb == "write_result":
                return {"ok": ft.write_result(req["doc"],
                                              owner=req.get("owner"))}
            if verb == "requeue_stale":
                return {"n": ft.requeue_stale(float(req["timeout"]))}
            if verb == "delete_all":
                ft.delete_all()
                return {"ok": True}
            if verb == "put_domain":
                ft.put_domain_blob(base64.b64decode(req["blob"]))
                return {"ok": True}
            if verb == "att_set":
                ft.attachments[req["key"]] = safe_loads(
                    base64.b64decode(req["blob"]))
                return {"ok": True}
            if verb == "att_del":
                try:
                    del ft.attachments[req["key"]]
                    return {"ok": True}
                except KeyError:
                    return {"ok": False}
            raise ValueError(f"unknown verb {verb!r}")

    # -- read dispatch (no write lock) ---------------------------------------

    def _dispatch_read(self, verb: str, req: dict, tenant=None) -> dict:
        """Read-only verbs (the ``_READONLY_VERBS`` catalog), served
        WITHOUT queuing on the write lock: a poll-heavy fleet's ``docs``
        calls never wait behind a mutating verb.  Safe because every
        store serializes its own state behind an internal lock and the
        store table is only probed, never mutated, on this path
        (:meth:`_store_ro`).  ``read_dispatch=False`` restores the
        classic reads-queue-on-the-write-lock behavior for A/B
        attribution."""
        if verb == "metrics":
            # Same payload as GET /metrics so RPC clients
            # (NetTrials.metrics) don't need a second transport.
            return {"metrics": self.metrics_payload()}
        if verb == "health":
            # Read-only interpretation verb: per-(tenant, exp_key)
            # optimizer-health verdicts; never mutates a store.
            return {"health": self._health_verb(req, tenant=tenant)}
        if verb == "bundle":
            # Read-only flight pull: the full postmortem payload (events
            # ring + meta anchor, metrics, provider sections, redacted
            # env) so an operator lands a remote shard's black box on
            # local disk (bundle.write_payload) without shelling in.
            # Never touches a store; token-gated like every verb.
            return {"bundle": _obs_bundle.collect_payload(
                "verb", extra={"trigger": "verb",
                               "tenant": getattr(tenant, "name", None)})}
        if verb == "stores":
            # Control-plane inventory: every (tenant, exp_key) this
            # server hosts with coarse sizes; the autoscaler's load
            # signal and the per-store migration planner read this.
            with self._lock:
                items = [
                    {"tenant": t, "exp_key": k,
                     "docs": len(getattr(ft, "_by_tid", ()) or ()),
                     "claims": len(getattr(ft, "_claims", ()) or ()),
                     "fenced": bool(getattr(ft, "fenced", False))}
                    for (t, k), ft in sorted(
                        self._trials.items(),
                        key=lambda kv: (kv[0][0] or "", kv[0][1]))]
            return {"stores": items}
        exp_key = req.get("exp_key", "default")
        if not self._read_dispatch:
            with self._lock:
                return self._dispatch_read_store(
                    verb, req, self._store(exp_key, tenant=tenant))
        return self._dispatch_read_store(
            verb, req, self._store_ro(exp_key, tenant=tenant))

    def _dispatch_read_store(self, verb: str, req: dict, ft) -> dict:
        """Store-backed read arms; ``ft`` resolves concurrency above
        (lock-free probe, or under the write lock in the A/B-off arm).
        """
        if verb == "store_export":
            # Migration read: the store's full canonical state, exactly
            # what the receiving shard's ``store_import`` replays.  The
            # one read a fenced store still answers: the fence is what
            # makes this snapshot final.
            fn = getattr(ft, "state_dict", None)
            if fn is None:
                raise ValueError("store_export requires a service store "
                                 "(MemTrials)")
            return {"state": fn()}
        if getattr(ft, "fenced", False):
            # A fenced store's documents are moving (or moved) away;
            # serving a read here would hand the client a stale or empty
            # view.  Same typed redirect as the mutating path.
            _metrics.registry().counter("store.fenced").inc()
            raise ShardFenced(
                f"store {req.get('exp_key', 'default')!r} is fenced "
                f"(migrating): refusing {verb!r}")
        if verb == "docs":
            export = getattr(ft, "export_docs", None)
            if export is not None:
                return {"docs": export()}
            ft.refresh()
            return {"docs": ft._dynamic_trials}
        if verb == "fetch_since":
            # Delta history pull: only rows touched since the client's
            # cursor.  A store without delta bookkeeping (FileTrials)
            # answers with the full list and a null cursor, and the
            # client keeps using full fetches against it.
            fn = getattr(ft, "docs_since", None)
            if fn is None:
                export = getattr(ft, "export_docs", None)
                if export is not None:
                    docs = export()
                else:
                    ft.refresh()
                    docs = ft._dynamic_trials
                return {"docs": docs, "cursor": None, "full": True}
            docs, cursor, full = fn(req.get("cursor"))
            return {"docs": docs, "cursor": cursor, "full": full}
        if verb == "get_domain":
            blob = ft.get_domain_blob()
            if blob is None:
                return {"blob": None}
            return {"blob": base64.b64encode(blob).decode()}
        if verb == "att_get":
            try:
                val = ft.attachments[req["key"]]
            except KeyError:
                return {"blob": None}
            return {"blob": base64.b64encode(
                _pickler.dumps(val)).decode()}
        if verb == "att_keys":
            return {"keys": list(ft.attachments)}
        raise ValueError(f"unknown verb {verb!r}")

    def _store_ro(self, exp_key: str, tenant=None):
        """Store lookup for the read path: a lock-free probe of the
        table (dict reads are atomic under the GIL; stores are created
        once and never replaced), taking the write lock only to create
        a store that does not exist yet — ``_store`` re-probes under
        the lock, so the race is benign."""
        tname = getattr(tenant, "name", tenant)
        ft = self._trials.get((tname, exp_key))
        if ft is not None:
            return ft
        with self._lock:
            return self._store(exp_key, tenant=tenant)

    # -- long-poll claims ----------------------------------------------------

    def _claim_gate(self, tname, exp_key) -> _ClaimGate:
        key = (tname, exp_key)
        with self._claim_gates_lock:
            gate = self._claim_gates.get(key)
            if gate is None:
                gate = self._claim_gates[key] = _ClaimGate()
            return gate

    def _signal_claims(self, tname, exp_key, verb=None, out=None):
        """Wake the store's parked long-poll reserves.  With ``verb``/
        ``out`` the wake is gated on the verb actually having produced
        something claimable (inserted docs, requeued claims, a freed
        claims-quota slot); the janitor calls with no verb
        (unconditional).  Never creates a gate — nobody parked means
        nothing to wake."""
        if verb is not None:
            if verb == "suggest" and not (out or {}).get("inserted"):
                return
            key = {"insert_docs": "tids", "suggest": "tids",
                   "requeue_stale": "n", "write_result": "ok",
                   "store_fence": "ok"}[verb]
            if not (out or {}).get(key):
                return
        with self._claim_gates_lock:
            gate = self._claim_gates.get((tname, exp_key))
        if gate is not None:
            gate.signal()

    def _reserve_longpoll(self, req: dict, tenant=None,
                          wait_s: float = 0.0, idem=None) -> dict:
        """Server-side parked claim: retry ``reserve`` on every gate
        signal until a doc lands or the wait budget expires, replacing
        the workers' client-side 100 ms poll loop.  Each attempt is a
        full ``_dispatch_verb`` pass, so quota checks re-run at every
        wake exactly as a fresh client poll would."""
        reg = _metrics.registry()
        tname = getattr(tenant, "name", tenant)
        gate = self._claim_gate(tname, req.get("exp_key", "default"))
        deadline = time.monotonic() + min(float(wait_s),
                                          self._LONGPOLL_CAP_S)
        parked = False
        while True:
            # Generation snapshot BEFORE the attempt: a signal that
            # lands between attempt and park bumps it, so the wait
            # below returns immediately instead of losing the wakeup.
            gen0 = gate.snapshot()
            out = self._dispatch_verb("reserve", req, tenant=tenant,
                                      idem=idem)
            if out.get("doc") is not None:
                if parked:
                    reg.counter("store.longpoll.woken").inc()
                return out
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                reg.counter("store.longpoll.timeouts").inc()
                return out
            if not parked:
                parked = True
                reg.counter("store.longpoll.parked").inc()
            gate.wait(gen0, remaining)

    # -- server-side suggest -------------------------------------------------

    #: Keyword arguments a suggest request may forward to the algorithm.
    #: A whitelist, not **kw passthrough: the wire is untrusted relative
    #: to the algorithm signatures, and an unknown key should 500 here
    #: with a clear message rather than TypeError deep inside TPE.
    _SUGGEST_KW = frozenset({
        "prior_weight", "n_startup_jobs", "n_EI_candidates", "gamma",
        "linear_forgetting", "split", "multivariate", "startup",
        "cat_prior", "popsize", "sigma0", "lr", "rank_shaping"})

    _ALGOS = None           # (registry names, server table)

    @classmethod
    def _server_algos(cls):
        """Algorithm table from the backend registry
        (``backends.contract.server_table``): every registered head,
        builtins and ``register_backend`` additions (a head registered
        after the server started included), is servable by name, with
        console verbosity suppressed where the head supports it.  The
        table is rebuilt when the registry's names change.

        Registry heads are dispatch + immediate materialize by the
        backend contract, so server and client proposals are
        bit-identical for the same (history, seed).
        """
        from ..backends import contract as _backends

        key = tuple(_backends.names())
        cached = cls._ALGOS
        if cached is None or cached[0] != key:
            cached = cls._ALGOS = (key, _backends.server_table())
        return cached[1]

    @staticmethod
    def _domain_for(ft):
        """Unpickle the store's published domain, cached on the store by
        (len, crc32) of the blob so repeated suggests don't re-unpickle —
        but a re-published domain (new blob) invalidates naturally."""
        blob = ft.get_domain_blob()
        if blob is None:
            raise FileNotFoundError(
                "suggest: no domain published for "
                f"exp_key={ft._exp_key!r} (driver must save_domain first)")
        sig = (len(blob), zlib.crc32(blob))
        cached = getattr(ft, "_srv_domain", None)
        if cached is not None and cached[0] == sig:
            return cached[1]
        domain = pickle.loads(blob)
        ft._srv_domain = (sig, domain)
        return domain

    def _suggest_verb(self, ft, req: dict, tenant=None) -> dict:
        """Server-side proposal: run the algorithm against the server's
        own store (which feeds the device-resident history ring exactly
        like a client-side Trials would) and optionally insert the docs.

        The head runs on the published domain's device
        (``domain.cs.device``, resolved by the head; CUDA when the domain
        names none, which raises on a server without a card), under
        :attr:`device_lock`.  Thin-client protocol: the driver only needs
        ``suggest`` (with insert), ``docs`` and the result verbs.

        ``_fleet_rows`` carries proposal rows that the service's cohort
        gate computed in one fleet dispatch, so this verb only packages
        docs and runs no head.  A wire client supplying it merely
        dictates its own proposals, the privilege ``insert_docs``
        already grants, so it needs no trust boundary beyond the auth
        gate.
        """
        fleet_rows = req.pop("_fleet_rows", None)
        algo_name = req.get("algo", "tpe")
        # Memo for the health verb: which head last served this store
        # (its introspection hook is the one worth running).
        ft._srv_last_algo = algo_name
        algo = self._server_algos().get(algo_name)
        if algo is None:
            from ..backends import UnknownBackend

            raise UnknownBackend(
                f"suggest: unknown algo {algo_name!r} "
                f"(have {sorted(self._server_algos())})")
        if "seed" not in req:
            raise ValueError("suggest: 'seed' is required — the server "
                             "must not invent entropy the driver cannot "
                             "reproduce")
        kw = {k: req[k] for k in self._SUGGEST_KW if k in req}
        bad = set(req) - self._SUGGEST_KW - {
            "verb", "exp_key", "algo", "seed", "n", "new_ids", "insert"}
        if bad:
            raise ValueError(f"suggest: unknown argument(s) {sorted(bad)}")
        new_ids = req.get("new_ids")
        if new_ids is None:
            # Server-allocated ids default to inserting (the enqueue
            # form); explicit ids default to proposal-only (the driver
            # owns the insert, e.g. fmin's algo adapter).
            insert = bool(req.get("insert", True))
            ft.refresh()
            new_ids = ft.new_trial_ids(int(req.get("n", 1)))
        else:
            insert = bool(req.get("insert", False))
            new_ids = [int(t) for t in new_ids]
        if insert:
            self._charge_admission(tenant, len(new_ids))
        domain = self._domain_for(ft)
        ft.refresh()
        if fleet_rows is not None:
            rows = np.asarray(fleet_rows, np.float32)[: len(new_ids)]
            acts = domain.cs.active_mask_host(rows)
            docs = docs_from_samples(domain.cs, new_ids, rows, acts,
                                     exp_key=getattr(ft, "exp_key", None))
        else:
            with self.device_lock:
                docs = algo(new_ids, domain, ft, int(req["seed"]), **kw)
        # Canonicalize now, inside the lock: the docs the server stores
        # and replies are plain JSON types like every other doc.  The
        # common case (docs_from_samples output) is already canonical
        # and skips the encode/decode deep-copy entirely.
        docs = _canon_docs(docs)
        tids = list(new_ids)
        if insert and docs:
            tids = ft._insert_trial_docs(docs)
        return {"docs": docs, "tids": tids, "inserted": bool(insert)}


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


#: Verbs that change server state: each call carries a fresh idempotency
#: key, reused verbatim across retries so the server executes it once.
_MUTATING_VERBS = frozenset(
    {"new_trial_ids", "insert_docs", "reserve", "write_result", "suggest"})

#: Mutating verbs that are retry-convergent without a key: re-executing
#: the request converges on the same durable state (heartbeat refreshes a
#: timestamp to the same pinned clock, requeue_stale is a fixpoint scan,
#: delete_all/put_domain/att_set/att_del overwrite or clear absolutely,
#: store_fence/store_import set a flag or install a state absolutely),
#: so retries need no idempotency cache entry.  Every mutating verb is
#: in exactly one of these two catalogs.  The same catalog as the JAX
#: package's.
_IDEMPOTENT_VERBS = frozenset(
    {"heartbeat", "requeue_stale", "delete_all", "put_domain",
     "att_set", "att_del", "store_fence", "store_import"})

#: Fleet control-plane verbs (autoscaler / operator surface): ephemeral
#: server directives that never touch durable store state.  ``shed``
#: arms admission control on a shard, ``fence`` quiesces a whole shard
#: for a bounded cutover.  Driven through ad-hoc RPC clients by the
#: router and the autoscaler.
_CONTROL_VERBS = frozenset({"shed", "fence"})

_BACKOFF_CAP_S = 2.0
#: Client defaults: transport retries per call, the first backoff (s),
#: and load-shed refusals honored per call.
DEFAULT_RETRIES = 5
DEFAULT_BACKOFF_S = 0.05
DEFAULT_BACKPRESSURE_RETRIES = 8

#: Peers (by URL) that refused a binary frame in ``auto`` wire mode:
#: pinned to JSON for the rest of the process so every later call skips
#: the doomed framed attempt.  ``binary`` mode never pins (strict).
_JSON_ONLY_PEERS: set = set()
_JSON_ONLY_LOCK = threading.Lock()

#: Error-name prefixes in a non-200 reply that mean "the peer could not
#: parse the frame" (old server: json.loads on magic bytes; new server
#: in json mode: explicit WireError refusal) — the only failures that
#: should trigger the JSON fallback.  Anything else (quota, auth, a
#: verb-level fault) is a real answer and must surface unchanged.
_FRAME_REFUSED = ("WireError", "JSONDecodeError", "UnicodeDecodeError")

#: Default per-host cap on idle keep-alive connections held by the
#: process-global pool (:func:`set_rpc_pool_size`).
DEFAULT_RPC_POOL = 8
_POOL_SIZE = DEFAULT_RPC_POOL


class _ConnectionPool:
    """Bounded per-host pool of keep-alive ``http.client`` connections.

    Every RPC used to pay a fresh TCP handshake (``urlopen`` closes its
    socket after one reply); at fleet scale connection setup dominated
    per-verb latency.  :meth:`request` checks a connection out of the
    per-``(host, port)`` idle list (``rpc.pool.hits``; a miss dials a
    new socket — ``rpc.pool.misses``), runs one HTTP round-trip, and
    checks it back in for the next call; returns beyond the per-host
    cap close the socket (``rpc.pool.evicted``).

    A reused socket may have died between calls (the server closed an
    idle keep-alive connection — a race inherent to HTTP/1.1).  That
    failure is retried ONCE, transparently, on a freshly dialed
    connection (``rpc.pool.stale_reconnects``): it is a pool artifact,
    not a server fault, so it burns neither the caller's retry budget
    nor a second ``rpc.send`` fault-point draw.  A failure on a fresh
    connection is a real transport error and propagates as
    ``URLError``/``OSError`` into :class:`_Rpc`'s retry loop."""

    # Distinct (host, port) entries allowed to hold idle sockets at
    # once, LRU-evicted.  Long-lived deployments talk to a handful of
    # endpoints and never feel this; without it, anything cycling many
    # short-lived servers (the test suite spawns hundreds, each on a
    # fresh port) accumulates one dead socket fd per server forever.
    _HOST_CAP = 32

    def __init__(self, size: int):
        self.size = max(0, int(size))
        self._lock = threading.Lock()
        # (host, port) -> [HTTPConnection]; dict order is the LRU order
        # (entries are re-inserted on every check-in, dropped when
        # their last idle socket is checked out).
        self._idle: dict = {}

    def request(self, url: str, data, headers: dict, timeout: float):
        """One HTTP round-trip → ``(status, body_bytes)``.  ``data`` is
        the POST body; ``None`` sends a GET (the router's upstream
        metrics scrape)."""
        parts = urlsplit(url)
        host = parts.hostname or "127.0.0.1"
        port = parts.port or 80
        path = parts.path or "/"
        if parts.query:
            path = f"{path}?{parts.query}"
        key = (host, port)
        reg = _metrics.registry()
        conn = None
        if self.size:
            with self._lock:
                idle = self._idle.get(key)
                if idle:
                    conn = idle.pop()
                    if not idle:
                        del self._idle[key]
        reused = conn is not None
        if reused:
            reg.counter("rpc.pool.hits").inc()
        else:
            reg.counter("rpc.pool.misses").inc()
        if conn is None:
            _faults.maybe_fail("rpc.connect", host=host, port=port)
            conn = _http_client.HTTPConnection(host, port, timeout=timeout)
        else:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
        try:
            status, body, keep = self._roundtrip(conn, path, data, headers)
        except BaseException as e:
            conn.close()
            if not reused or not isinstance(
                    e, (OSError, _http_client.HTTPException)):
                # Fresh-dial failure (a real transport error), or a
                # non-transport exception (injected fault, interrupt):
                # nothing to transparently retry — but never leak the
                # half-used socket either.
                if isinstance(e, (OSError, _http_client.HTTPException)):
                    raise self._transport_error(e) from e
                raise
            # Stale keep-alive socket: one transparent redial.  If the
            # redial itself fails — connect refused, or the rpc.connect
            # fault point firing — the host is unreachable, and every
            # OTHER idle socket for this key predates the failure, so
            # they are presumed just as dead: flush them all.  Leaving
            # them would poison the pool — each future call would check
            # out a corpse, fail, redial, fail, one per socket.
            reg.counter("rpc.pool.stale_reconnects").inc()
            try:
                _faults.maybe_fail("rpc.connect", host=host, port=port,
                                   redial=True)
                conn = _http_client.HTTPConnection(host, port,
                                                   timeout=timeout)
                status, body, keep = self._roundtrip(conn, path, data,
                                                     headers)
            except BaseException as e2:
                conn.close()
                self._flush_host(key)
                if isinstance(e2, (OSError, _http_client.HTTPException)):
                    raise self._transport_error(e2) from e2
                raise
        if keep:
            self._checkin(key, conn)
        else:
            conn.close()
        return status, body

    def _flush_host(self, key) -> None:
        """Drop every idle socket for ``key`` (host unreachable: a
        failed redial proves anything older is dead too)."""
        with self._lock:
            stale = self._idle.pop(key, [])
        if stale:
            _metrics.registry().counter("rpc.pool.flushed").inc(
                len(stale))
        for c in stale:
            c.close()

    @staticmethod
    def _roundtrip(conn, path, data, headers):
        """One hand-rolled HTTP/1.1 exchange over ``conn``'s socket.

        ``http.client``'s request/response machinery costs ~200 µs per
        call on this path: headers and body go out as two separate
        small ``sendall``s (two GIL handoffs — and, with Nagle on, a
        ~40 ms delayed-ACK stall), and the reply headers are parsed
        through ``email.parser``.  Both servers guarantee a
        ``Content-Length`` on every response path (a keep-alive
        invariant), so one coalesced write plus a line-oriented reply
        reader is sufficient — and roughly halves the per-verb
        client-side cost."""
        if conn.sock is None:
            conn.connect()
            # Nagle off before the first byte, else each small write
            # waits out the peer's delayed ACK.
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn._ht_rfile = conn.sock.makefile("rb")
        method = "POST" if data is not None else "GET"
        req = [f"{method} {path} HTTP/1.1",
               f"Host: {conn.host}:{conn.port}"]
        req += [f"{k}: {v}" for k, v in headers.items()]
        if data is not None:
            req.append(f"Content-Length: {len(data)}")
        buf = ("\r\n".join(req) + "\r\n\r\n").encode("latin-1")
        if data:
            buf += data
        conn.sock.sendall(buf)

        rfile = conn._ht_rfile
        status_line = rfile.readline(65537)
        if not status_line:
            raise _http_client.RemoteDisconnected(
                "Remote end closed connection without response")
        parts = status_line.split(None, 2)
        if len(parts) < 2 or not parts[0].startswith(b"HTTP/"):
            raise _http_client.BadStatusLine(
                status_line.decode("latin-1", "replace"))
        status = int(parts[1])
        keep = parts[0] == b"HTTP/1.1"
        length = None
        while True:
            line = rfile.readline(65537)
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.partition(b":")
            k = k.strip().lower()
            if k == b"content-length":
                length = int(v.strip())
            elif k == b"connection":
                keep = keep and v.strip().lower() != b"close"
        if length is None:
            # Both servers always frame with Content-Length; anything
            # else is a foreign endpoint we cannot safely keep alive.
            raise _http_client.BadStatusLine("response without Content-Length")
        body = rfile.read(length) if length else b""
        if length and len(body) < length:
            raise _http_client.IncompleteRead(body, length - len(body))
        return status, body, keep

    @staticmethod
    def _transport_error(e):
        # http.client's protocol errors (BadStatusLine,
        # CannotSendRequest, RemoteDisconnected-as-HTTPException
        # shapes) are not all OSError; fold them into URLError so the
        # caller's ``except (URLError, OSError, ...)`` clause sees one
        # shape, exactly like urlopen reported them.
        if isinstance(e, OSError):
            return e
        return URLError(e)

    def _checkin(self, key, conn):
        evicted = []
        if self.size:
            with self._lock:
                idle = self._idle.pop(key, [])
                self._idle[key] = idle      # re-insert: LRU touch
                if len(idle) < self.size:
                    idle.append(conn)
                    conn = None
                    while len(self._idle) > self._HOST_CAP:
                        oldest = next(iter(self._idle))
                        evicted.extend(self._idle.pop(oldest))
            if conn is not None:
                _metrics.registry().counter("rpc.pool.evicted").inc()
        for c in evicted:
            _metrics.registry().counter("rpc.pool.evicted").inc()
            c.close()
        if conn is not None:
            conn.close()

    def close_all(self):
        with self._lock:
            idle_lists, self._idle = list(self._idle.values()), {}
        for conns in idle_lists:
            for c in conns:
                c.close()


_POOL: _ConnectionPool | None = None
_POOL_LOCK = threading.Lock()


def set_rpc_pool_size(size: int) -> int:
    """Set the per-host cap on idle keep-alive connections of the
    process-global pool (0 disables pooling: every call dials and closes
    a fresh socket); the pool is rebuilt at its next use and the old
    one's idle sockets are closed.  Returns the previous cap."""
    global _POOL_SIZE
    size = int(size)
    if size < 0:
        raise ValueError(f"pool size must be >= 0, got {size}")
    with _POOL_LOCK:
        prev, _POOL_SIZE = _POOL_SIZE, size
    return prev


def _rpc_pool() -> _ConnectionPool:
    """Process-global pool, rebuilt when :func:`set_rpc_pool_size`
    changed its cap (the replaced pool's idle sockets are closed)."""
    global _POOL
    size = _POOL_SIZE
    pool = _POOL
    if pool is not None and pool.size == size:
        return pool
    with _POOL_LOCK:
        pool = _POOL
        size = _POOL_SIZE
        if pool is None or pool.size != size:
            if pool is not None:
                pool.close_all()
            pool = _POOL = _ConnectionPool(size)
    return pool


class _Rpc:
    """Pooled keep-alive JSON client (one logical POST per call; the
    socket persists across calls via :class:`_ConnectionPool`).

    Transport failures (socket refused/reset/timeout, i.e. ``URLError``
    without an HTTP reply) are retried up to ``retries`` times with
    exponential backoff (``backoff`` seconds, doubling) + deterministic
    jitter; exhaustion raises the typed
    :class:`~hyperopt_tpu_torch.exceptions.NetstoreUnavailable`.
    Server-reported errors (the server answered, with a fault) stay
    ``RuntimeError`` and are never retried: retrying a deliberate refusal
    (auth, bad verb) only hammers the server.  A server's load-shed
    refusal is honored (sleep its ``retry_after_s``, resend) up to
    ``backpressure_retries`` times without charging ``retries``.
    """

    def __init__(self, url: str, exp_key: str, timeout: float = 30.0,
                 token: str | None = None, retries: int | None = None,
                 backoff: float | None = None,
                 backpressure_retries: int | None = None):
        self.url = url.rstrip("/")
        self.exp_key = exp_key
        self.timeout = timeout
        self.token = _resolve_token(token)
        self.retries = max(0, int(DEFAULT_RETRIES if retries is None
                                  else retries))
        self.backoff = float(DEFAULT_BACKOFF_S if backoff is None
                             else backoff)
        self.backpressure_retries = int(
            DEFAULT_BACKPRESSURE_RETRIES if backpressure_retries is None
            else backpressure_retries)
        # Deterministic jitter stream per client identity: spreads thundering
        # retries across workers without making test runs irreproducible.
        self._jitter = random.Random(
            zlib.crc32(f"{self.url}|{exp_key}".encode()))

    def __call__(self, verb: str, _timeout: float | None = None,
                 **kw) -> dict:
        kw.update(verb=verb, exp_key=self.exp_key)
        if verb in _MUTATING_VERBS and "idem" not in kw:
            # One key per logical call, shared by every retry of it (a
            # caller may pre-pin one).
            kw["idem"] = uuid.uuid4().hex
        # Trace-context stamp (obs/context.py): when the caller runs
        # inside a bound context (a traced driver batch, a worker
        # evaluating a stamped doc), the compact wire string rides along
        # so the server's events attach to the same trial.  Disarmed
        # cost: one module-global boolean check.
        if _context.armed():
            ctx = _context.wire_current()
            if ctx is not None:
                kw["ctx"] = ctx
        wmode = _wire.mode()
        use_frames = (wmode != "json" and verb in _wire.FRAMED_VERBS
                      and (wmode == "binary"
                           or self.url not in _JSON_ONLY_PEERS))
        headers = {"Content-Type": (_wire.CONTENT_TYPE if use_frames
                                    else "application/json")}
        if self.token is not None:
            headers["X-Netstore-Token"] = self.token
        if use_frames:
            data = _wire.encode(kw)
            reg = _metrics.registry()
            reg.counter("wire.frames").inc()
            reg.counter("wire.bytes_tx").inc(len(data))
        else:
            data = json.dumps(kw).encode()
        timeout = self.timeout
        if _timeout is not None:
            # Long-poll verbs park server-side for their wait budget;
            # the HTTP read timeout must outlive it.
            timeout = max(timeout, float(_timeout))
        attempts = 0
        bp_honored = 0
        bp_budget = self.backpressure_retries
        t_start = time.perf_counter()
        while True:
            try:
                _faults.maybe_fail("rpc.send", verb=verb)
                status, raw = _rpc_pool().request(self.url, data,
                                                  headers, timeout)
                if status == 200:
                    _faults.maybe_fail("rpc.recv", verb=verb)
                    if _wire.is_frame(raw):
                        _metrics.registry().counter(
                            "wire.bytes_rx").inc(len(raw))
                        out = _wire.decode(bytes(raw))
                    else:
                        out = json.loads(raw)
                    break
                # Non-2xx (500 server fault, 401 auth) carries the JSON
                # error body; surface it as the RuntimeError the callers
                # expect.  The server DID answer — no retry.
                try:
                    out = json.loads(raw)
                except Exception:
                    out = {"error": f"HTTP {status}"}
                if (use_frames and wmode == "auto"
                        and str(out.get("error", "")).startswith(
                            _FRAME_REFUSED)):
                    # Old peer (or json-pinned server) could not parse
                    # the frame: pin this URL to JSON and re-send the
                    # SAME request (same idem key) as JSON — the
                    # fallback costs one extra round trip, once.
                    with _JSON_ONLY_LOCK:
                        _JSON_ONLY_PEERS.add(self.url)
                    _metrics.registry().counter(
                        "wire.json_fallbacks").inc()
                    use_frames = False
                    headers["Content-Type"] = "application/json"
                    data = json.dumps(kw).encode()
                    continue
                if (str(out.get("error", "")).startswith("Backpressure")
                        and bp_honored < bp_budget):
                    # The server is shedding load and named its own
                    # price.  Honor it: sleep a jittered fraction of
                    # retry_after_s and re-send the SAME request (same
                    # idem key) WITHOUT charging the transport retry
                    # budget — the bytes made it there and back, the
                    # server just said "not yet".
                    bp_honored += 1
                    try:
                        retry_after = float(out.get("retry_after_s", 1.0))
                    except (TypeError, ValueError):
                        retry_after = 1.0
                    reg = _metrics.registry()
                    reg.counter("backpressure.client.honored").inc()
                    reg.histogram("backpressure.client.retry_after.s"
                                  ).observe(retry_after)
                    time.sleep(retry_after
                               * (0.5 + self._jitter.random()))
                    continue
                break
            except (URLError, OSError, InjectedFault) as e:
                attempts += 1
                _metrics.registry().counter("netstore.rpc.retry").inc()
                if attempts > self.retries:
                    _metrics.registry().counter(
                        "netstore.rpc.unavailable").inc()
                    raise NetstoreUnavailable(
                        f"netstore {self.url} unreachable after "
                        f"{attempts} attempt(s) ({verb}): {e}",
                        attempts=attempts) from e
                delay = min(self.backoff * (2 ** (attempts - 1)),
                            _BACKOFF_CAP_S)
                time.sleep(delay * (0.5 + self._jitter.random()))
        # Client-observed RPC latency (retries and backoff included) —
        # the worker-side twin of the server's per-verb histograms;
        # piggybacked to the server with the fleet snapshots.
        _metrics.registry().histogram("netstore.client.rpc.s").observe(
            time.perf_counter() - t_start)
        if "error" in out:
            if out["error"].startswith("QuotaExceeded"):
                # Typed so drivers can back off deliberately; NOT in
                # TRANSIENT_ERRORS — blind retry of a rate refusal is
                # exactly the traffic the quota exists to shed.
                raise QuotaExceeded(f"netstore server: {out['error']}")
            if out["error"].startswith("Backpressure"):
                # The shed outlived the honor budget: surface the typed
                # error so the caller can decide (a routed client has
                # already been told N times to come back later).
                try:
                    _ra = float(out.get("retry_after_s", 1.0))
                except (TypeError, ValueError):
                    _ra = 1.0
                raise Backpressure(f"netstore server: {out['error']}",
                                   retry_after_s=_ra)
            if out["error"].startswith("ShardFenced"):
                # Typed retriable redirect from a shard of the service
                # tier mid-cutover: a routed client refreshes its shard
                # map and re-places itself.
                raise ShardFenced(f"netstore server: {out['error']}")
            raise RuntimeError(f"netstore server: {out['error']}")
        return out


class _NetAttachments(MutableMapping):
    """RPC-backed attachments mapping (GridFS-over-HTTP analog)."""

    def __init__(self, rpc: _Rpc):
        self._rpc = rpc

    def __setitem__(self, key, value):
        self._rpc("att_set", key=str(key),
                  blob=base64.b64encode(_pickler.dumps(value)).decode())

    def __getitem__(self, key):
        blob = self._rpc("att_get", key=str(key))["blob"]
        if blob is None:
            raise KeyError(key)
        return safe_loads(base64.b64decode(blob))

    def __delitem__(self, key):
        if not self._rpc("att_del", key=str(key))["ok"]:
            raise KeyError(key)

    def __iter__(self):
        return iter(self._rpc("att_keys")["keys"])

    def __len__(self):
        return len(self._rpc("att_keys")["keys"])


class NetTrials(Trials):
    """Async ``Trials`` over a :class:`StoreServer` URL (MongoTrials analog:
    same surface as :class:`~.filestore.FileTrials`, transport swapped from
    shared mount to HTTP).

    ``token`` authenticates every verb; ``retries``, ``backoff`` and
    ``backpressure_retries`` set the client's retry budgets (defaults
    ``DEFAULT_RETRIES``, ``DEFAULT_BACKOFF_S``,
    ``DEFAULT_BACKPRESSURE_RETRIES``); ``reserve_wait_s`` > 0 makes
    :meth:`reserve` long-poll by default."""

    asynchronous = True

    #: Minimum seconds between cumulative-snapshot piggybacks on heartbeat
    #: calls (the fleet-metrics push cadence; tests shrink it).  Snapshots
    #: are cumulative — the server keeps last-write-wins per worker — so
    #: a lost push costs staleness, never data.
    metrics_push_interval = 2.0

    def __init__(self, url: str, exp_key: str = "default", refresh=True,
                 timeout: float = 30.0, token: str | None = None,
                 retries: int | None = None, backoff: float | None = None,
                 backpressure_retries: int | None = None,
                 reserve_wait_s: float = 0.0):
        self._rpc = _Rpc(url, exp_key, timeout=timeout, token=token,
                         retries=retries, backoff=backoff,
                         backpressure_retries=backpressure_retries)
        self.reserve_wait_s = float(reserve_wait_s)
        self._last_metrics_push = float("-inf")
        # Delta-refresh state: server-issued [epoch, seq] cursor plus a
        # tid -> index map into _dynamic_trials so fetch_since rows merge
        # in place.  _delta_ok flips off permanently against peers that
        # don't speak the verb (the RuntimeError answer pins it).
        self._cursor = None
        self._net_pos: dict = {}
        self._delta_ok = True
        super().__init__(exp_key=exp_key, refresh=refresh)
        self.attachments = _NetAttachments(self._rpc)

    # -- document IO over RPC ------------------------------------------------

    def refresh(self):
        with self._lock:
            docs = None
            if self._delta_ok and _wire.mode() != "json":
                try:
                    out = self._rpc("fetch_since", cursor=self._cursor)
                except (NetstoreUnavailable, QuotaExceeded):
                    raise
                except RuntimeError:
                    # Old peer without the verb: classic full fetches
                    # from here on (one failed probe per process).
                    self._delta_ok = False
                else:
                    self._cursor = out.get("cursor")
                    if out.get("full", True) or self._cursor is None:
                        docs = out.get("docs", [])
                    else:
                        self._merge_delta(out.get("docs", []))
                        return
            if docs is None:
                docs = self._rpc("docs")["docs"]
            docs.sort(key=lambda d: d["tid"])
            self._dynamic_trials = docs
            self._net_pos = {d["tid"]: i for i, d in enumerate(docs)}
            self._ids = {d["tid"] for d in docs}
            self._trials = [d for d in docs
                            if self._exp_key in (None, d.get("exp_key"))]
            # Docs were re-read: Trials' cached best may be stale.
            self._best_cache = None

    def _merge_delta(self, delta: list) -> None:
        """Apply a fetch_since row set: replace known tids in place,
        append unknown ones (re-sorting only if an append lands out of
        tid order — servers allocate tids monotonically, so appends are
        ordered in practice)."""
        if not delta:
            return
        resort = False
        for d in sorted(delta, key=lambda d: d["tid"]):
            i = self._net_pos.get(d["tid"])
            if i is not None:
                self._dynamic_trials[i] = d
            else:
                if (self._dynamic_trials
                        and d["tid"] < self._dynamic_trials[-1]["tid"]):
                    resort = True
                self._net_pos[d["tid"]] = len(self._dynamic_trials)
                self._dynamic_trials.append(d)
                self._ids.add(d["tid"])
        if resort:
            self._dynamic_trials.sort(key=lambda d: d["tid"])
            self._net_pos = {d["tid"]: i
                             for i, d in enumerate(self._dynamic_trials)}
        self._trials = [d for d in self._dynamic_trials
                        if self._exp_key in (None, d.get("exp_key"))]
        self._best_cache = None

    def _insert_trial_docs(self, docs):
        return self._rpc("insert_docs", docs=list(docs))["tids"]

    def new_trial_ids(self, n):
        return self._rpc("new_trial_ids", n=int(n))["tids"]

    def delete_all(self):
        self._rpc("delete_all")
        self._cursor = None
        self._net_pos = {}
        super().delete_all()
        self.attachments = _NetAttachments(self._rpc)

    # -- worker/claim surface (server-side atomicity) ------------------------

    def reserve(self, owner: str, wait_s: float | None = None):
        """Claim one NEW trial; ``None`` if none is claimable.

        ``wait_s`` > 0 long-polls: the server parks the call on its
        claim condition variable and answers the moment an insert or
        requeue makes a doc claimable (or the wait expires), replacing
        the client-side 100 ms poll loop — one idle RPC per wait budget
        instead of ten per second.  Default: the client's
        ``reserve_wait_s`` (0 = classic immediate answer); the server
        clamps the park to its own ceiling."""
        if wait_s is None:
            wait_s = self.reserve_wait_s
        if wait_s and wait_s > 0:
            return self._rpc("reserve", owner=owner, wait_s=float(wait_s),
                             _timeout=float(wait_s) + 10.0)["doc"]
        return self._rpc("reserve", owner=owner)["doc"]

    def heartbeat(self, doc, owner=None) -> bool:
        kw = {"doc": doc, "owner": owner}
        now = time.monotonic()
        if (owner is not None
                and now - self._last_metrics_push
                >= self.metrics_push_interval):
            # Piggyback this process's cumulative metrics snapshot
            # (histograms in mergeable state form) on the beat — no
            # extra RPC, and the push cadence is bounded by the
            # heartbeat interval itself.
            self._last_metrics_push = now
            kw["worker"] = owner
            kw["metrics"] = _metrics.registry().snapshot(states=True)
        t0 = time.time()
        out = self._rpc("heartbeat", **kw)
        t_server = out.get("t_wall")
        if t_server is not None:
            # NTP-style midpoint estimate of this process's wall-clock
            # offset from the server (positive = we are ahead).  Stamped
            # into the event-log header so that a trace merge can
            # normalize this process's lane onto the server clock.
            skew = 0.5 * (t0 + time.time()) - t_server
            _metrics.registry().gauge("clock.skew_s").set(skew)
            EVENTS.set_meta(skew_s=skew)
        return out["ok"]

    def write_result(self, doc, owner=None) -> bool:
        return self._rpc("write_result", doc=doc, owner=owner)["ok"]

    def requeue_stale(self, timeout: float) -> int:
        return self._rpc("requeue_stale", timeout=float(timeout))["n"]

    def metrics(self) -> dict:
        """Server-side metrics registry snapshot (``GET /metrics`` twin)."""
        return self._rpc("metrics")["metrics"]

    def health(self, all: bool = False, introspect: bool = True) -> dict:
        """Per-experiment optimizer-health verdicts (read-only verb):
        ``{label: report}`` with ``report["verdict"]`` in
        ``obs.health.VERDICTS``.  ``all=True`` widens from this client's
        exp_key to every experiment in the caller's tenant namespace;
        ``introspect=False`` skips the backend surrogate diagnostics."""
        kw = {"introspect": introspect}
        if all:
            kw["all"] = True
        return self._rpc("health", **kw)["health"]

    def bundle(self, out_dir: str | None = None) -> dict:
        """Pull the server's flight-recorder payload (read-only verb).

        Returns the bundle payload dict; with ``out_dir`` also writes it
        as an on-disk bundle directory (the exact form a local flight
        dump produces)."""
        payload = self._rpc("bundle")["bundle"]
        if out_dir:
            _obs_bundle.write_payload(out_dir, payload)
        return payload

    # -- server-side suggest -------------------------------------------------

    def suggest(self, seed: int, n: int | None = None, new_ids=None,
                algo: str = "tpe", insert: bool | None = None, **kw):
        """Ask the SERVER to propose trials (thin-client protocol).

        The server runs the algorithm against its own store, on the
        published domain's device: for TPE, ``suggest_dispatch`` +
        materialize over the device-resident history ring, bit-identical
        to client-side ``tpe.suggest`` for the same (history, seed).
        ``algo`` is any name of the server's backend registry.  Two
        forms:

        * ``suggest(seed, n=8)`` — server allocates ids and INSERTS the
          proposals (one RPC enqueues a whole batch); returns the docs.
        * ``suggest(seed, new_ids=[...], insert=False)`` — proposal
          only, driver owns the insert (what :func:`server_suggest`
          uses to slot into ``fmin`` as an algo).
        """
        req = dict(seed=int(seed), algo=algo, **kw)
        if new_ids is not None:
            req["new_ids"] = [int(t) for t in new_ids]
        elif n is not None:
            req["n"] = int(n)
        if insert is not None:
            req["insert"] = bool(insert)
        return self._rpc("suggest", **req)["docs"]

    # -- domain shipping -----------------------------------------------------

    def save_domain(self, domain) -> None:
        self._rpc("put_domain",
                  blob=base64.b64encode(_pickler.dumps(domain)).decode())

    def load_domain(self):
        blob = self._rpc("get_domain")["blob"]
        if blob is None:
            raise FileNotFoundError("no domain published for "
                                    f"exp_key={self._exp_key!r}")
        return pickle.loads(base64.b64decode(blob))

    def fmin(self, fn, space, algo, max_evals, **kwargs):
        """Publish the domain (for the workers and a server-side
        suggest, on ``fmin``'s ``device``), then run ``fmin``."""
        from ..base import Domain
        try:
            domain = Domain(fn, space, pass_expr_memo_ctrl=kwargs.get(
                "pass_expr_memo_ctrl"))
            domain.cs.device = kwargs.get("device")
            self.save_domain(domain)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            logger.warning("objective not picklable (%s); workers must be "
                           "given the domain explicitly", e)
        return super().fmin(fn, space, algo, max_evals, **kwargs)


def server_suggest(new_ids, domain, trials, seed, algo: str = "tpe", **kw):
    """``fmin``-shaped algo that delegates the proposal to the server.

    Drop-in for ``algo=`` against a :class:`NetTrials`: the domain
    argument is ignored (the server uses the blob the driver published
    via ``save_domain``), ids and seed flow through unchanged, and the
    returned docs are exactly what the server computed — so a pinned
    seeded run matches client-side ``tpe.suggest`` document-for-document.
    """
    if not isinstance(trials, NetTrials):
        raise TypeError("server_suggest needs a NetTrials "
                        f"(got {type(trials).__name__})")
    return trials.suggest(seed, new_ids=new_ids, algo=algo, insert=False,
                          **kw)


class NetWorker(FileWorker):
    """`FileWorker` over the network store: the identical
    reserve→evaluate→heartbeat→write loop, claims arbitrated server-side.
    ``token`` authenticates every verb against a token-protected
    :class:`StoreServer`.  ``faults`` (a ``faults.configure`` spec, seeded
    by ``faults_seed``) arms this worker's fault schedule when it runs,
    as ``FileWorker`` does (the CLI's ``--faults``)."""

    def __init__(self, url, exp_key="default", token: str | None = None,
                 faults: str | None = None, faults_seed: int = 0,
                 **kwargs):
        # Resolved before super().__init__, which calls _make_trials.
        self._token = _resolve_token(token)
        super().__init__(url, exp_key=exp_key, faults=faults,
                         faults_seed=faults_seed, **kwargs)

    def _make_trials(self, url, exp_key):
        return NetTrials(url, exp_key=exp_key, token=self._token)


# ---------------------------------------------------------------------------
# Router-aware client (the sharded fleet, service/router.py)
# ---------------------------------------------------------------------------

#: Default period (s) after which a routed client re-fetches the shard map.
DEFAULT_MAP_REFRESH_S = 30.0


class _RoutedRpc:
    """:class:`_Rpc` facade that places itself through a router's shard map.

    Fetches the ``shard_map`` verb from the router at construction and
    again every ``map_refresh_s`` seconds (or on a transport failure),
    computes the owning shard of this client's ``(tenant, exp_key)`` with
    the pinned hash the router uses (``service/cluster.py``), and then
    speaks to the owning primary directly: the router serves topology,
    not the data path.

    Failover: a :class:`NetstoreUnavailable` from the shard pushes the
    verb through the router (whose forward path promotes the warm
    replica) with the same idempotency key pinned before the first
    attempt, so the promoted replica either replays the shipped record's
    cached reply or executes the verb for the first time.
    """

    def __init__(self, router_url: str, exp_key: str,
                 timeout: float = 30.0, token: str | None = None,
                 retries: int | None = None,
                 map_refresh_s: float | None = None):
        self._router = _Rpc(router_url, exp_key, timeout=timeout,
                            token=token, retries=retries)
        self.exp_key = exp_key
        self.timeout = timeout
        self.token = _resolve_token(token)
        self._retries = retries
        self.map_refresh_s = float(DEFAULT_MAP_REFRESH_S
                                   if map_refresh_s is None
                                   else map_refresh_s)
        self._lock = threading.Lock()
        self._shard_rpc = None
        self.shard_id = None
        self.tenant = None
        self.map_version = None
        self._map_t = float("-inf")
        self._refresh_map(force=True)

    @property
    def url(self) -> str:
        """The owning shard primary's URL (moves under failover)."""
        with self._lock:
            return self._shard_rpc.url

    def _refresh_map(self, force: bool = False) -> None:
        with self._lock:
            if (not force and time.monotonic() - self._map_t
                    < self.map_refresh_s):
                return
            out = self._router("shard_map")
            from ..service.cluster import ShardMap
            smap = ShardMap.from_dict(out["map"])
            self.tenant = out.get("tenant")
            sid, ent = smap.owner(self.tenant, self.exp_key)
            self._map_t = time.monotonic()
            self.map_version = smap.version
            if (self._shard_rpc is None or self.shard_id != sid
                    or self._shard_rpc.url != ent["primary"]):
                self._shard_rpc = _Rpc(ent["primary"], self.exp_key,
                                       timeout=self.timeout,
                                       token=self.token,
                                       retries=self._retries)
                self.shard_id = sid

    def __call__(self, verb: str, **kw) -> dict:
        self._refresh_map()
        if verb in _MUTATING_VERBS and "idem" not in kw:
            # Pinned here so that the post-failover retry reuses it.
            kw["idem"] = uuid.uuid4().hex
        with self._lock:
            rpc = self._shard_rpc
        try:
            return rpc(verb, **kw)
        except ShardFenced:
            return self._redirect(verb, kw)
        except NetstoreUnavailable:
            # The primary is gone, and since the data path is direct the
            # router may not know yet: push this very verb through the
            # router, whose forward path retries, promotes the warm
            # replica and answers from the new primary.  The idem key
            # pinned above rides both attempts.
            _metrics.registry().counter("netstore.client.reroutes").inc()
            out = self._router(verb, **kw)
            try:
                self._refresh_map(force=True)    # re-place future calls
            except (NetstoreUnavailable, RuntimeError, OSError):
                pass                 # best effort; the next call retries
            return out

    def _redirect(self, verb: str, kw: dict) -> dict:
        """Typed retriable redirect: the owning store (or its whole
        shard) is fenced for a bounded cutover (rebalance, promotion or
        a per-store migration).  Refresh the map and re-place: the fence
        lifts by the map changing, not by waiting it out.  Bounded by the
        client timeout, after which the typed error surfaces."""
        _metrics.registry().counter("netstore.client.redirects").inc()
        deadline = time.monotonic() + max(float(self.timeout), 5.0)
        delay = 0.05
        while True:
            try:
                self._refresh_map(force=True)
            except (NetstoreUnavailable, RuntimeError, OSError):
                pass             # router briefly busy: retry below
            with self._lock:
                rpc = self._shard_rpc
            try:
                return rpc(verb, **kw)
            except ShardFenced:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(delay * (0.5 + rpc._jitter.random()))
                delay = min(delay * 2.0, 0.5)


class RouterTrials(NetTrials):
    """:class:`NetTrials` behind the fleet router (``service/router.py``).

    Same surface, other placement: ``url`` is the router's URL; the
    client pulls the shard map from it, hashes its own ``(tenant,
    exp_key)`` onto the ring and talks to the owning shard primary
    directly, re-placing itself after a failover or a rebalance (see
    :class:`_RoutedRpc`).  ``token`` authenticates against both the
    router (the edge) and the shard (the authority); ``map_refresh_s``
    is the map's refresh period (default ``DEFAULT_MAP_REFRESH_S``).
    """

    def __init__(self, url: str, exp_key: str = "default", refresh=True,
                 timeout: float = 30.0, token: str | None = None,
                 retries: int | None = None,
                 map_refresh_s: float | None = None):
        self._rpc = _RoutedRpc(url, exp_key, timeout=timeout,
                               token=token, retries=retries,
                               map_refresh_s=map_refresh_s)
        self._last_metrics_push = float("-inf")
        # Delta-refresh state (see NetTrials.__init__).  Safe across a
        # failover or rebalance: the promoted or receiving shard mints a
        # fresh store epoch, so a cursor from the old placement gets a
        # full resend.
        self._cursor = None
        self._net_pos = {}
        self._delta_ok = True
        self.reserve_wait_s = 0.0
        Trials.__init__(self, exp_key=exp_key, refresh=refresh)
        self.attachments = _NetAttachments(self._rpc)

    @property
    def shard_id(self):
        """The shard currently owning this client's store."""
        return self._rpc.shard_id


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None):
    """CLI of the console script ``hyperopt-tpu-torch-netstore`` (also
    ``python -m hyperopt_tpu_torch.parallel.netstore``): ``--serve`` hosts
    a store directory; ``--worker URL`` evaluates jobs from a remote store
    (the reference's ``hyperopt-mongo-worker`` against a mongod URL)."""
    import argparse

    p = argparse.ArgumentParser(
        description="hyperopt_tpu_torch network store")
    sub = p.add_mutually_exclusive_group(required=True)
    sub.add_argument("--serve", action="store_true",
                     help="serve --root on --host:--port")
    sub.add_argument("--worker", metavar="URL",
                     help="run a worker against a StoreServer URL")
    p.add_argument("--root", default=None, help="store dir (server mode)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8417)
    p.add_argument("--exp-key", default="default")
    p.add_argument("--token", default=None,
                   help="shared secret for every verb (default: none, "
                        "an open server)")
    p.add_argument("--poll-interval", type=float, default=0.1)
    p.add_argument("--reserve-timeout", type=float, default=None)
    p.add_argument("--max-consecutive-failures", type=int, default=4)
    p.add_argument("--max-trial-retries", type=int, default=0,
                   help="worker mode: in-place re-evaluations of a trial "
                        "after a transient failure before it is marked "
                        "ERROR (default 0 = fail fast)")
    p.add_argument("--requeue-stale-every", type=float, default=None,
                   metavar="S",
                   help="server mode: janitor period — requeue claims whose "
                        "heartbeat went stale, every S seconds (default: "
                        "janitor off; clients may still call requeue_stale)")
    p.add_argument("--stale-timeout", type=float, default=60.0,
                   help="server mode: heartbeat age beyond which the "
                        "janitor treats a claim as crashed (default 60s; "
                        "keep well above the workers' heartbeat interval)")
    p.add_argument("--workdir", default=None)
    p.add_argument("--trace-dir", default=None,
                   help="arm the structured event log and write "
                        "loop_events.jsonl (+ chrome trace) here on exit")
    p.add_argument("--flight-dir", default=None,
                   help="arm the flight recorder: freeze a postmortem "
                        "bundle here on SLO alert fire, unhandled verb "
                        "error or SIGTERM (default: off)")
    p.add_argument("--faults", default=None,
                   help="worker mode: fault schedule "
                        "'point=prob[:times][@after],...' armed for this "
                        "worker (faults.configure)")
    p.add_argument("--faults-seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.serve:
        if not args.root:
            p.error("--serve requires --root")
        tracer = None
        if args.trace_dir:
            from ..obs.trace import Tracer
            tracer = Tracer(args.trace_dir)
            EVENTS.set_meta(role="server")
        server = StoreServer(args.root, host=args.host, port=args.port,
                             token=args.token,
                             requeue_stale_every=args.requeue_stale_every,
                             stale_timeout=args.stale_timeout)
        print(f"netstore: serving {args.root} at {server.url}", flush=True)

        # Graceful stop on SIGTERM (systemd/k8s default kill signal):
        # raise out of serve_forever on the main thread, then shut down in
        # the finally.  shutdown() must not run inside the handler — it
        # joins the serve loop that the handler interrupted.
        import signal

        def _on_sigterm(signo, frame):
            raise SystemExit(0)

        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:          # not the main thread (embedded use)
            pass
        # Arm AFTER the SIGTERM handler so the flight handler chains it:
        # a TERM first freezes the bundle, then the graceful exit runs.
        flight_dir = _flight.install(args.flight_dir)
        if flight_dir:
            print(f"netstore: flight recorder armed -> {flight_dir}",
                  flush=True)
        try:
            server.serve_forever()
        except (KeyboardInterrupt, SystemExit):
            pass
        finally:
            server.shutdown()
            if tracer is not None:
                tracer.dump()
            print("netstore: shut down", flush=True)
        return 0

    worker = NetWorker(args.worker, exp_key=args.exp_key, token=args.token,
                       poll_interval=args.poll_interval,
                       reserve_timeout=args.reserve_timeout,
                       max_consecutive_failures=args.max_consecutive_failures,
                       max_trial_retries=args.max_trial_retries,
                       workdir=args.workdir, trace_dir=args.trace_dir,
                       faults=args.faults, faults_seed=args.faults_seed)
    n = worker.run()
    logger.info("net worker done: %d trials evaluated", n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

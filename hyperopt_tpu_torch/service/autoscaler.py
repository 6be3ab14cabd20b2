"""Self-driving elastic fleet: the autoscaler control plane.

Counterpart of ``hyperopt_tpu/service/autoscaler.py``.  One control loop
closes the gap between the observability stack and the fleet's topology
verbs.  Each tick it reads the fleet's SLO burn (an
:class:`~hyperopt_tpu_torch.obs.slo.SloMonitor`) plus the per-shard store
inventory, and drives one bounded action through existing verbs:

* **scale_up**: spawn a shard (the pluggable spawner) and splice it into
  the ring with the router's ``shard_add`` (per-store bounded cutovers);
* **scale_down**: drain the least-loaded shard through ``shard_remove``
  and retire the process;
* **shed**: when capacity cannot grow (``max_shards``), arm admission
  control on every shard: producers get the typed retriable
  :class:`~hyperopt_tpu_torch.exceptions.Backpressure`, while the drain
  verbs (reserve/write_result/heartbeat) keep flowing.  The directive is
  TTL'd: a dead autoscaler fails open;
* **recover**: lift the shed once the burn subsides.

Flap damping: scale actions sit behind a cooldown (``cooldown_s``), and
scale_down also needs ``calm_ticks`` consecutive healthy ticks.  Sheds
carry no cooldown.

Decision log: every non-hold decision is appended to its own WAL
(``wal_dir``; an fsync per record, group commit off: a decision is
durable before it executes) and replayed on restart.

The loop is a daemon thread that counts and logs every failure and keeps
ticking.  ``tick(signals=...)`` takes a full signal override, so tests
drive the decision table deterministically.

The JAX package's environment switches are the arguments
``interval_s``, ``cooldown_s``, ``min_shards`` and ``max_shards``, with
the JAX defaults (``DEFAULT_INTERVAL_S``, ``DEFAULT_COOLDOWN_S``,
``DEFAULT_MIN_SHARDS``, ``DEFAULT_MAX_SHARDS``).
"""

from __future__ import annotations

import logging
import os
import threading
import time

from ..obs import metrics as _metrics
from ..obs.events import EVENTS
from .wal import Wal, read_wal

logger = logging.getLogger(__name__)

__all__ = ["Autoscaler", "LocalSpawner"]


DEFAULT_INTERVAL_S = 5.0
DEFAULT_COOLDOWN_S = 30.0
DEFAULT_MIN_SHARDS = 1
DEFAULT_MAX_SHARDS = 8


class LocalSpawner:
    """In-process :class:`Spawner`: each ``spawn()`` is a fresh
    ``ShardServer`` primary on its own WAL directory under ``root`` —
    what the tests and the elastic benchmark use, and the reference for
    a subprocess/k8s spawner (the protocol is two methods: ``spawn() ->
    {"shard", "url", "replica"}`` and ``retire(shard_id)``)."""

    def __init__(self, root: str, token: str | None = None,
                 fsync: str = "never", **server_kw):
        self.root = os.path.abspath(root)
        self._token = token
        self._fsync = fsync
        self._server_kw = server_kw
        self._n = 0
        self._live: dict = {}

    def spawn(self) -> dict:
        from .replica import ShardServer
        sid = f"auto{self._n}"
        self._n += 1
        srv = ShardServer(os.path.join(self.root, sid), role="primary",
                          token=self._token, fsync=self._fsync,
                          **self._server_kw)
        srv.start()
        self._live[sid] = srv
        return {"shard": sid, "url": srv.url, "replica": None}

    def retire(self, shard_id: str) -> None:
        srv = self._live.pop(shard_id, None)
        if srv is not None:
            srv.shutdown()

    def close(self) -> None:
        for sid in list(self._live):
            self.retire(sid)


class Autoscaler:
    """SLO-burn-driven elastic control loop over a :class:`~.router.Router`.

    ``router`` is the (local, in-process) router whose topology verbs
    this loop drives.  ``spawner`` provides/retires shard processes;
    without one the loop can still shed and recover (degradation-only
    mode).  ``slo`` is an optional
    :class:`~hyperopt_tpu_torch.obs.slo.SloMonitor` evaluated each tick;
    ``wal_dir`` arms the durable decision log.
    """

    #: Burn-rate thresholds on the SLO error budget: above ``up`` the
    #: fleet acts (grow or shed); below ``down`` it is healthy enough
    #: to consider recovering/shrinking.  The dead zone between them is
    #: hysteresis — the first layer of flap damping.
    up_threshold = 1.0
    down_threshold = 0.5

    def __init__(self, router, spawner=None, slo=None,
                 wal_dir: str | None = None,
                 interval_s: float | None = None,
                 cooldown_s: float | None = None,
                 min_shards: int | None = None,
                 max_shards: int | None = None,
                 calm_ticks: int = 3):
        self._router = router
        self._spawner = spawner
        self._slo = slo
        self.interval_s = float(DEFAULT_INTERVAL_S if interval_s is None
                                else interval_s)
        self.cooldown_s = float(DEFAULT_COOLDOWN_S if cooldown_s is None
                                else cooldown_s)
        self.min_shards = int(DEFAULT_MIN_SHARDS if min_shards is None
                              else min_shards)
        self.max_shards = int(DEFAULT_MAX_SHARDS if max_shards is None
                              else max_shards)
        self.calm_ticks = max(1, int(calm_ticks))
        self._lock = threading.Lock()
        self._decisions: list = []      # newest last, bounded below
        self._decision_cap = 256
        self._seq = 0
        self._calm = 0
        self._shed_level = 0.0
        self._last_scale_t = float("-inf")
        self._stop = threading.Event()
        self._thread = None
        self._wal = None
        if wal_dir:
            # Group commit off: a decision record is one fsync'd line
            # BEFORE the action runs — the log can never claim less
            # than the fleet did.
            self._wal = Wal(wal_dir, fsync="always", group_commit=False)
            _snap, records, _torn = read_wal(wal_dir)
            for rec in records:
                if rec.get("verb") != "autoscale":
                    continue
                self._decisions.append(rec.get("req") or {})
                self._seq = max(self._seq, rec.get("seq", 0))
            self._decisions = self._decisions[-self._decision_cap:]
            self._wal.seq = self._seq

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Start the control loop thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="service-autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(2.0, 2 * self.interval_s))
        self._thread = None
        if self._wal is not None:
            self._wal.close()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # Surfaced, counted, and the loop keeps breathing: the
                # control plane degrading to "do nothing" must be loud
                # but must never take the data plane's process down.
                _metrics.registry().counter("autoscale.errors").inc()
                logger.exception("autoscaler tick failed")

    # -- signal scrape -------------------------------------------------------

    def _scrape(self) -> dict:
        """Live signals: worst SLO burn across specs (a spec burns only
        when BOTH its fast and slow windows burn — the monitor's own
        anti-flap rule), which specs fire, and per-shard load from the
        fleet inventory."""
        burn, firing = 0.0, []
        if self._slo is not None:
            for s in self._slo.evaluate():
                fast = s.get("burn_fast")
                slow = s.get("burn_slow")
                if fast is not None and slow is not None:
                    burn = max(burn, min(fast, slow))
                if s.get("firing"):
                    firing.append(s["name"])
        loads, backlog = {}, 0
        for sid, rows in self._router._fleet_inventory().items():
            loads[sid] = sum(r.get("docs", 0) + r.get("claims", 0)
                             for r in rows)
            backlog += sum(r.get("claims", 0) for r in rows)
        return {"burn": burn, "firing": firing, "loads": loads,
                "backlog": backlog, "n_shards": len(loads)}

    # -- the decision table --------------------------------------------------

    def tick(self, signals: dict | None = None,
             now: float | None = None) -> dict:
        """One control-loop pass: scrape (unless ``signals`` overrides),
        decide, execute, log.  Returns the decision record."""
        with self._lock:
            return self._tick_locked(signals, now)

    def _tick_locked(self, signals, now) -> dict:
        reg = _metrics.registry()
        reg.counter("autoscale.ticks").inc()
        now = time.monotonic() if now is None else float(now)
        sig = signals if signals is not None else self._scrape()
        burn = float(sig.get("burn", 0.0))
        n = int(sig.get("n_shards")
                or len(self._router._map.shards))
        reg.gauge("autoscale.burn").set(burn)
        reg.gauge("autoscale.shards").set(float(n))
        cooled = now - self._last_scale_t >= self.cooldown_s
        action, reason, detail = "hold", "", {}
        if burn >= self.up_threshold:
            self._calm = 0
            can_grow = (self._spawner is not None
                        and n < self.max_shards)
            if can_grow and cooled:
                action = "scale_up"
                reason = (f"burn {burn:.2f} >= {self.up_threshold:.2f} "
                          f"with headroom ({n} < {self.max_shards})")
            elif can_grow:
                action, reason = "hold", "burning but inside cooldown"
            else:
                # Capacity wall: degrade gracefully.  Level scales with
                # burn (a 2x burn sheds more than a 1.01x), refreshed
                # every tick while the burn lasts, TTL'd so it expires
                # on its own if this loop dies.
                action = "shed"
                level = max(0.1, min(0.9, 0.25 * burn))
                detail = {"level": round(level, 3),
                          "ttl_s": max(10.0, 3 * self.interval_s),
                          "retry_after_s": max(0.5, self.interval_s)}
                reason = (f"burn {burn:.2f} and no headroom "
                          f"({n}/{self.max_shards} shards)")
        elif burn <= self.down_threshold:
            self._calm += 1
            if self._shed_level > 0.0:
                action = "recover"
                reason = f"burn {burn:.2f} subsided; lifting shed"
            elif (self._spawner is not None and n > self.min_shards
                    and self._calm >= self.calm_ticks and cooled):
                loads = sig.get("loads") or {}
                victim = min(
                    self._router._map.shards,
                    key=lambda s: (loads.get(s, 0), s))
                action = "scale_down"
                detail = {"shard": victim}
                reason = (f"calm for {self._calm} tick(s), "
                          f"{n} > {self.min_shards} shards; draining "
                          f"least-loaded {victim!r}")
        else:
            self._calm = 0              # dead zone: neither direction
        decision = {"seq": self._seq + 1, "t": time.time(),
                    "action": action, "reason": reason,
                    "burn": round(burn, 4), "shards": n,
                    "firing": list(sig.get("firing") or ()), **detail}
        if action == "hold":
            return decision
        self._seq += 1
        if self._wal is not None:
            self._wal.append({"verb": "autoscale", "t": int(time.time()),
                              "req": decision}, seq=self._seq)
        reg.counter("autoscale.decisions").inc()
        try:
            self._act(action, decision, now)
            decision["ok"] = True
        except Exception as e:
            decision["ok"] = False
            decision["error"] = f"{type(e).__name__}: {e}"
            reg.counter("autoscale.errors").inc()
            logger.exception("autoscale %s failed", action)
        self._decisions.append(decision)
        del self._decisions[:-self._decision_cap]
        EVENTS.emit("autoscale_decision", name=action,
                    burn=decision["burn"], shards=n,
                    ok=decision.get("ok"))
        logger.warning("autoscale: %s (%s)%s", action, reason,
                       "" if decision.get("ok") else " FAILED")
        return decision

    # -- actions (all through existing, individually proven verbs) -----------

    def _act(self, action: str, decision: dict, now: float) -> None:
        reg = _metrics.registry()
        if action == "scale_up":
            spec = self._spawner.spawn()
            out = self._router._shard_add_verb(
                {"shard": spec["shard"], "url": spec["url"],
                 "replica": spec.get("replica")})
            decision["shard"] = spec["shard"]
            decision["migrated"] = out.get("migrated")
            self._last_scale_t = now
            reg.counter("autoscale.scale_ups").inc()
        elif action == "scale_down":
            sid = decision["shard"]
            out = self._router._shard_remove_verb({"shard": sid})
            decision["migrated"] = out.get("migrated")
            self._spawner.retire(sid)
            self._last_scale_t = now
            reg.counter("autoscale.scale_downs").inc()
        elif action == "shed":
            self._broadcast_shed(decision["level"], decision["ttl_s"],
                                 decision["retry_after_s"])
            self._shed_level = decision["level"]
            reg.counter("autoscale.sheds").inc()
            reg.gauge("autoscale.shed_level").set(self._shed_level)
        elif action == "recover":
            self._broadcast_shed(0.0, 0.0, 0.0)
            self._shed_level = 0.0
            reg.counter("autoscale.recoveries").inc()
            reg.gauge("autoscale.shed_level").set(0.0)
        else:                           # pragma: no cover - decision
            raise ValueError(f"unknown action {action!r}")  # table bug

    def _broadcast_shed(self, level: float, ttl_s: float,
                        retry_after_s: float) -> None:
        """Arm (or lift) admission control on every primary.  Best
        effort per shard: one unreachable primary must not keep the
        rest of the fleet unprotected — it is probably the overloaded
        one, and its clients are already backing off on transport."""
        with self._router._lock:
            doc = self._router._map.to_dict()
        errs = 0
        for sid, ent in doc["shards"].items():
            try:
                self._router._fleet_rpc(ent["primary"], retries=1)(
                    "shed", level=level, ttl_s=ttl_s,
                    retry_after_s=retry_after_s)
            except Exception as e:
                errs += 1
                logger.warning("shed broadcast to shard %s failed: %s",
                               sid, e)
        if errs:
            _metrics.registry().counter(
                "autoscale.shed_broadcast_errors").inc(errs)

    # -- introspection (rides the router's /metrics payload) -----------------

    def status(self) -> dict:
        """JSON-safe control-plane snapshot: config, current damping
        state, and the tail of the decision log (it rides the router's
        ``/metrics`` payload)."""
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "cooldown_s": self.cooldown_s,
                "min_shards": self.min_shards,
                "max_shards": self.max_shards,
                "calm_ticks": self.calm_ticks,
                "calm": self._calm,
                "shed_level": self._shed_level,
                "running": bool(self._thread is not None
                                and self._thread.is_alive()),
                "decisions": list(self._decisions[-12:]),
            }

"""Declarative SLOs with multi-window burn-rate alerting.

Counterpart of ``hyperopt_tpu/obs/slo.py`` (host code, the same specs,
states and numbers).

An :class:`SloSpec` names an objective over one metric series:

* ``latency_p95`` — at most ``budget`` (default 5%) of observations in
  a window may exceed ``target`` seconds.  Evaluated from *windowed*
  histogram states (cumulative-state differencing in
  ``obs.timeseries``), so the tail fraction is exact at bucket
  resolution with no per-observation cost.
* ``gauge_min`` / ``gauge_max`` — at most ``budget`` of window samples
  may sit below/above ``target`` (worker-liveness fraction, WAL fsync
  lag).

Burn rate is the classic SRE ratio: ``violating fraction / budget`` —
1.0 means the error budget burns exactly as fast as it accrues.  The
monitor evaluates each spec over a **fast** and a **slow** window and

* **fires** when *both* burn rates reach ``burn_threshold`` (the slow
  window proves it's not a blip, the fast window proves it's still
  happening);
* **clears** when the fast-window burn drops back under the threshold
  (the standard asymmetry: recovery is visible in the fast window
  first; no evaluation data leaves the state untouched).

Transitions emit typed ``slo_alert`` events (``state: firing |
resolved``) into the event log — they ride the normal trace dump/merge
pipeline and render as instants in Perfetto — and bump ``slo.alerts.fired`` / ``slo.alerts.resolved``.
Continuous state is published as ``slo.<name>.firing`` /
``slo.<name>.burn_fast`` / ``slo.<name>.burn_slow`` /
``slo.<name>.value`` gauges.  A firing transition additionally pokes
the flight recorder (``obs.flight.on_slo_fired``) so an armed process
freezes a postmortem bundle the moment the budget burns.

The default specs (``default_slos``) are the JAX package's: their metrics
are written by the service, the fleet and the WAL, so in a process without
them they evaluate to no data and stay quiet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from . import events as _events
from . import flight as _flight
from . import metrics as _metrics

__all__ = ["SloSpec", "SloMonitor", "default_slos"]

_KINDS = ("latency_p95", "gauge_min", "gauge_max")


@dataclass(frozen=True)
class SloSpec:
    """One service-level objective over one metric series."""

    name: str                   #: catalog key
    metric: str                 #: registry series the objective reads
    kind: str = "latency_p95"   #: latency_p95 | gauge_min | gauge_max
    target: float = 1.0         #: threshold in the metric's units
    budget: float = 0.05        #: allowed violating fraction per window
    fast_window: float = 60.0   #: seconds; fires AND clears here
    slow_window: float = 300.0  #: seconds; must corroborate to fire
    burn_threshold: float = 1.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"SloSpec kind {self.kind!r}: want {_KINDS}")
        if not (0.0 < self.budget <= 1.0):
            raise ValueError("SloSpec budget must be in (0, 1]")


def default_slos() -> tuple:
    """The served defaults: suggest-verb tail latency, worker liveness,
    WAL fsync lag — one per failure plane (compute, fleet, durability)."""
    return (
        SloSpec("suggest_p95", metric="netstore.verb.suggest.s",
                kind="latency_p95", target=0.25, budget=0.05),
        SloSpec("worker_liveness", metric="fleet.live_fraction",
                kind="gauge_min", target=0.9, budget=0.1),
        SloSpec("wal_fsync_lag", metric="wal.fsync_lag_s",
                kind="gauge_max", target=1.0, budget=0.1),
    )


class SloMonitor:
    """Evaluates specs against a :class:`~.timeseries.TimeSeriesStore`
    and owns the per-spec alert state machine."""

    def __init__(self, specs, store, reg=None, events=None):
        self.specs = tuple(specs)
        self.store = store
        self._reg = reg
        self._events = events
        self._state = {s.name: {"firing": False, "since": None}
                       for s in self.specs}
        self._last: list = []

    def registry(self):
        return self._reg if self._reg is not None else _metrics.registry()

    def _events_log(self):
        return self._events if self._events is not None else _events.EVENTS

    def _frac_bad(self, spec, window, now):
        if spec.kind == "latency_p95":
            return self.store.window_frac_above(spec.metric, spec.target,
                                                window, now=now)
        samples = self.store.samples(spec.metric, window_s=window, now=now)
        if not samples:
            return None
        if spec.kind == "gauge_min":
            bad = sum(1 for _, v in samples if v < spec.target)
        else:
            bad = sum(1 for _, v in samples if v > spec.target)
        return bad / len(samples)

    def _value(self, spec, now):
        if spec.kind == "latency_p95":
            return self.store.window_quantile(spec.metric, 0.95,
                                              spec.fast_window, now=now)
        samples = self.store.samples(spec.metric,
                                     window_s=spec.fast_window, now=now)
        return samples[-1][1] if samples else None

    def evaluate(self, now: float | None = None) -> list:
        """One evaluation pass; returns the per-spec status list (also
        retrievable via :meth:`status`)."""
        now = time.time() if now is None else float(now)
        reg = self.registry()
        log = self._events_log()
        out = []
        for spec in self.specs:
            st = self._state[spec.name]
            frac_fast = self._frac_bad(spec, spec.fast_window, now)
            frac_slow = self._frac_bad(spec, spec.slow_window, now)
            burn_fast = (None if frac_fast is None
                         else frac_fast / spec.budget)
            burn_slow = (None if frac_slow is None
                         else frac_slow / spec.budget)
            if not st["firing"]:
                if burn_fast is not None and burn_slow is not None and \
                        burn_fast >= spec.burn_threshold and \
                        burn_slow >= spec.burn_threshold:
                    st["firing"] = True
                    st["since"] = now
                    reg.counter("slo.alerts.fired").inc()
                    log.emit("slo_alert", name=spec.name, state="firing",
                             metric=spec.metric, target=spec.target,
                             burn_fast=burn_fast, burn_slow=burn_slow)
                    _flight.on_slo_fired(spec.name, metric=spec.metric,
                                         burn_fast=burn_fast,
                                         burn_slow=burn_slow)
            else:
                if burn_fast is not None and \
                        burn_fast < spec.burn_threshold:
                    st["firing"] = False
                    st["since"] = None
                    reg.counter("slo.alerts.resolved").inc()
                    log.emit("slo_alert", name=spec.name, state="resolved",
                             metric=spec.metric, target=spec.target,
                             burn_fast=burn_fast, burn_slow=burn_slow)
            value = self._value(spec, now)
            reg.gauge(f"slo.{spec.name}.firing").set(
                1.0 if st["firing"] else 0.0)
            if burn_fast is not None:
                reg.gauge(f"slo.{spec.name}.burn_fast").set(burn_fast)
            if burn_slow is not None:
                reg.gauge(f"slo.{spec.name}.burn_slow").set(burn_slow)
            if value is not None:
                reg.gauge(f"slo.{spec.name}.value").set(value)
            out.append({
                "name": spec.name, "kind": spec.kind,
                "metric": spec.metric, "target": spec.target,
                "value": value, "burn_fast": burn_fast,
                "burn_slow": burn_slow, "firing": st["firing"],
                "since": st["since"],
            })
        self._last = out
        return out

    def status(self) -> list:
        """Most recent :meth:`evaluate` result (empty before the first
        pass)."""
        return list(self._last)

    def alerts(self) -> list:
        return [s for s in self._last if s["firing"]]

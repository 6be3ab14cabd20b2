"""Process-global metrics registry: counters, gauges, histograms.

Counterpart of ``hyperopt_tpu/obs/metrics.py``, with the same names and
functions.  One :class:`MetricsRegistry` (``registry()``) serves the
process; every update takes one registry lock.  Metrics are on by default
(:func:`set_enabled` turns them off; the JAX package reads the same switch
from its environment): disabled, every ``inc``/``set``/``observe``
returns after one attribute check.

Series the port feeds: ``fmin.batches``, ``fmin.trials.done``/``error``,
``fmin.trials_per_sec``; ``suggest.upload_ms``/``dispatch_ms``/
``fetch_sync_ms`` (each fed twice, the counter's running total of
milliseconds and a same-named millisecond histogram); the resident ring's
``history.upload_bytes``/``append_hits``/``rebuilds``/``evicted``/
``order_violations`` (registry twins of ``history.py``'s plain ints);
device mode's ``device.fetch_syncs``/``segments``/``trials_landed``/
``run_cache.hits``/``misses``, their ``<mode>.<stride>`` twins and the
telemetry slab's ``device.telemetry.*`` (``obs/devtel.py``); the fleet's
``fleet.*``; ``faults.injected.<point>``.

Also home to the TPE kernel-cache counters (:func:`kernel_cache_event` /
:func:`kernel_cache_stats`): always on, whatever the switch, and each miss
emits a ``compile`` event.
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional

from . import events as _events

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LabelLru",
    "MetricsRegistry",
    "registry",
    "metrics_enabled",
    "set_enabled",
    "kernel_cache_event",
    "kernel_cache_stats",
    "merge_histogram_states",
    "summarize_state",
    "merge_snapshots",
]

# Log-spaced latency bucket upper bounds (seconds): 100µs .. ~52s, ×2 per
# bucket, plus a catch-all.  Covers single calls through full fmin runs.
DEFAULT_BUCKETS = tuple(1e-4 * (2.0 ** i) for i in range(20))


class Counter:
    """Monotonic float counter."""

    __slots__ = ("name", "_reg", "_value")

    def __init__(self, name: str, reg: "MetricsRegistry"):
        self.name = name
        self._reg = reg
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not self._reg._enabled:
            return
        with self._reg._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._reg._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_reg", "_value")

    def __init__(self, name: str, reg: "MetricsRegistry"):
        self.name = name
        self._reg = reg
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._reg._enabled:
            return
        with self._reg._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._reg._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max.

    Buckets are upper bounds in the observed unit (default: log-spaced
    seconds for latencies).  Quantiles in ``summary()`` are bucket-upper-
    bound approximations — good enough for "p99 dispatch is 8ms",
    not for SLO math.
    """

    __slots__ = ("name", "_reg", "bounds", "_counts", "_count", "_sum", "_min", "_max")

    def __init__(self, name: str, reg: "MetricsRegistry", buckets=None):
        self.name = name
        self._reg = reg
        self.bounds = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
        self._counts = [0] * (len(self.bounds) + 1)  # +1 overflow bucket
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    def observe(self, v: float) -> None:
        if not self._reg._enabled:
            return
        with self._reg._lock:
            self._counts[bisect.bisect_left(self.bounds, v)] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def _quantile_locked(self, q: float):
        if self._count == 0:
            return None
        target = q * self._count
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= target:
                return self.bounds[i] if i < len(self.bounds) else self._max
        return self._max

    def summary(self) -> dict:
        with self._reg._lock:
            if self._count == 0:
                return {"count": 0}
            return {
                "count": self._count,
                "sum": self._sum,
                "mean": self._sum / self._count,
                "min": self._min,
                "max": self._max,
                "p50": self._quantile_locked(0.50),
                "p90": self._quantile_locked(0.90),
                "p95": self._quantile_locked(0.95),
                "p99": self._quantile_locked(0.99),
            }

    def state(self) -> dict:
        """Mergeable wire form: the full bucket vector plus the scalars.

        Two states with identical ``bounds`` merge losslessly by summing
        counts (:func:`merge_histogram_states`) — this is what workers
        piggyback on heartbeats and what the server aggregates into the
        fleet view.  JSON-serializable by construction.
        """
        with self._reg._lock:
            return {
                "bounds": list(self.bounds),
                "counts": list(self._counts),
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
            }


class MetricsRegistry:
    """Lock-protected name → metric table with one-call snapshot."""

    def __init__(self, enabled: Optional[bool] = None):
        self._lock = threading.Lock()
        self._enabled = True if enabled is None else bool(enabled)
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}
        # Kernel-cache compile-shape accounting (always-on; see module doc).
        self._kernel_cache: dict = {"requests": 0, "misses": 0, "by_key": {}}

    # -- arming ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, flag: bool) -> None:
        self._enabled = bool(flag)

    # -- get-or-create ---------------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._counters.get(name)
            if m is None:
                m = self._counters[name] = Counter(name, self)
            return m

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            m = self._gauges.get(name)
            if m is None:
                m = self._gauges[name] = Gauge(name, self)
            return m

    def histogram(self, name: str, buckets=None) -> Histogram:
        with self._lock:
            m = self._histograms.get(name)
            if m is None:
                m = self._histograms[name] = Histogram(name, self, buckets)
            return m

    # -- removal (label-cardinality control) -----------------------------
    def remove(self, name: str) -> int:
        """Drop a series by exact name from all three tables.  Returns
        how many metrics were removed (0..3).  Handles to a removed
        metric keep working but mutate an orphan no snapshot sees —
        the price of get-or-create handles staying lock-free."""
        with self._lock:
            n = 0
            for table in (self._counters, self._gauges, self._histograms):
                if table.pop(name, None) is not None:
                    n += 1
            return n

    def remove_prefix(self, prefix: str) -> int:
        """Drop every series whose name starts with ``prefix`` (evicting
        one tenant's whole per-verb family at once).  Returns the count."""
        with self._lock:
            n = 0
            for table in (self._counters, self._gauges, self._histograms):
                dead = [k for k in table if k.startswith(prefix)]
                for k in dead:
                    del table[k]
                n += len(dead)
            return n

    # -- kernel cache (always-on) ---------------------------------------
    def kernel_cache_event(self, key, hit: bool) -> None:
        ks = repr(key)
        with self._lock:
            kc = self._kernel_cache
            kc["requests"] += 1
            per = kc["by_key"].setdefault(ks, {"requests": 0, "misses": 0})
            per["requests"] += 1
            if not hit:
                kc["misses"] += 1
                per["misses"] += 1
        if not hit:
            _events.EVENTS.emit("compile", name="tpe_kernel", key=ks)

    def kernel_cache_stats(self, reset: bool = False) -> dict:
        with self._lock:
            kc = self._kernel_cache
            out = {
                "requests": kc["requests"],
                "misses": kc["misses"],
                "by_key": {k: dict(v) for k, v in kc["by_key"].items()},
            }
            if reset:
                kc["requests"] = 0
                kc["misses"] = 0
                kc["by_key"] = {}
        return out

    # -- readout ---------------------------------------------------------
    def snapshot(self, reset: bool = False, states: bool = False) -> dict:
        """One consistent read of everything, for /metrics and benches.

        ``states=True`` additionally embeds each histogram's mergeable
        :meth:`Histogram.state` under a ``"state"`` key — the wire form
        workers piggyback on heartbeats so the server can merge exact
        bucket counts instead of unmergeable quantile summaries.
        """
        with self._lock:
            out = {
                "enabled": self._enabled,
                "counters": {n: c._value for n, c in sorted(self._counters.items())},
                "gauges": {n: g._value for n, g in sorted(self._gauges.items())},
                "kernel_cache": {
                    "requests": self._kernel_cache["requests"],
                    "misses": self._kernel_cache["misses"],
                    "by_key": {
                        k: dict(v) for k, v in self._kernel_cache["by_key"].items()
                    },
                },
            }
        # Histogram.summary takes the same lock; collect outside the hold.
        if states:
            out["histograms"] = {
                n: {**h.summary(), "state": h.state()}
                for n, h in sorted(self._histograms.items())
            }
        else:
            out["histograms"] = {
                n: h.summary() for n, h in sorted(self._histograms.items())
            }
        if reset:
            self.reset()
        return out

    def reset(self) -> None:
        """Zero all metrics (kernel cache included). Mainly for tests/benches."""
        with self._lock:
            for c in self._counters.values():
                c._value = 0.0
            for g in self._gauges.values():
                g._value = 0.0
            for h in self._histograms.values():
                h._counts = [0] * (len(h.bounds) + 1)
                h._count = 0
                h._sum = 0.0
                h._min = None
                h._max = None
            self._kernel_cache = {"requests": 0, "misses": 0, "by_key": {}}


# ---------------------------------------------------------------------------
# cross-process aggregation (fleet /metrics)
# ---------------------------------------------------------------------------


def merge_histogram_states(states) -> Optional[dict]:
    """Merge :meth:`Histogram.state` dicts by summing bucket counts.

    The merge is **associative and commutative** (integer bucket sums,
    float sum accumulation, min/max of extrema — tests pin associativity
    in the JAX package's tests), so a server can fold worker snapshots
    in any arrival order.  All inputs must share identical ``bounds``;
    mismatched bucket layouts raise ``ValueError`` rather than silently
    mis-binning.  Falsy entries are skipped; merging nothing returns None.
    """
    states = [s for s in states if s]
    if not states:
        return None
    bounds = list(states[0]["bounds"])
    counts = [0] * (len(bounds) + 1)
    count = 0
    total = 0.0
    mn = None
    mx = None
    for s in states:
        if list(s["bounds"]) != bounds:
            raise ValueError(
                f"cannot merge histograms with different bucket bounds "
                f"({len(s['bounds'])} vs {len(bounds)} buckets)")
        for i, c in enumerate(s["counts"]):
            counts[i] += c
        count += s["count"]
        total += s["sum"]
        if s["min"] is not None and (mn is None or s["min"] < mn):
            mn = s["min"]
        if s["max"] is not None and (mx is None or s["max"] > mx):
            mx = s["max"]
    return {"bounds": bounds, "counts": counts, "count": count,
            "sum": total, "min": mn, "max": mx}


def _state_quantile(state: dict, q: float):
    # Same bucket-upper-bound approximation as Histogram._quantile_locked.
    count = state["count"]
    if count == 0:
        return None
    target = q * count
    seen = 0
    bounds = state["bounds"]
    for i, c in enumerate(state["counts"]):
        seen += c
        if seen >= target:
            return bounds[i] if i < len(bounds) else state["max"]
    return state["max"]


def summarize_state(state: dict) -> dict:
    """:meth:`Histogram.summary`-schema dict computed from a state
    (merged or single); same bucket-upper-bound quantile approximation,
    so a quantile of a merged state is bounded below by the largest
    member's same-quantile bucket lower bound and above by its upper
    bound — the invariant the quantile-bounds test pins."""
    if not state or state["count"] == 0:
        return {"count": 0}
    return {
        "count": state["count"],
        "sum": state["sum"],
        "mean": state["sum"] / state["count"],
        "min": state["min"],
        "max": state["max"],
        "p50": _state_quantile(state, 0.50),
        "p90": _state_quantile(state, 0.90),
        "p95": _state_quantile(state, 0.95),
        "p99": _state_quantile(state, 0.99),
    }


def merge_snapshots(snaps) -> dict:
    """Fold registry snapshots from several processes into one fleet view.

    Counters and gauges **sum** across members (fleet trials/s is the sum
    of worker rates; occupancy and backlog likewise aggregate by sum —
    last-write gauges that don't sum meaningfully, like clock skew, are
    read from the per-worker labels instead).  Histograms merge exactly
    when members carry ``"state"`` (``snapshot(states=True)``); entries
    without state are skipped — summaries alone are not mergeable.
    """
    counters: dict = {}
    gauges: dict = {}
    hstates: dict = {}
    for snap in snaps:
        if not snap:
            continue
        for k, v in (snap.get("counters") or {}).items():
            counters[k] = counters.get(k, 0.0) + v
        for k, v in (snap.get("gauges") or {}).items():
            gauges[k] = gauges.get(k, 0.0) + v
        for k, h in (snap.get("histograms") or {}).items():
            st = h.get("state") if isinstance(h, dict) else None
            if st:
                hstates.setdefault(k, []).append(st)
    histograms = {}
    for k in sorted(hstates):
        merged = merge_histogram_states(hstates[k])
        entry = summarize_state(merged)
        entry["state"] = merged
        histograms[k] = entry
    return {
        "counters": dict(sorted(counters.items())),
        "gauges": dict(sorted(gauges.items())),
        "histograms": histograms,
    }


class LabelLru:
    """Bounded set of live metric labels with LRU eviction.

    Dynamic-label series (``health.verdict.<store>``, per-tenant verb
    counters) grow without bound under experiment churn.  Each emitting
    site keeps one ``LabelLru``; :meth:`touch` marks a label live and
    returns the labels evicted to stay under ``cap``.  The caller
    removes the evicted labels' series (``remove`` / ``remove_prefix``)
    — this class tracks recency only, so it stays usable for both
    exact-name gauges and per-tenant name prefixes.  Each eviction
    bumps ``obs.series_evicted``.

    ``cap`` defaults to :attr:`DEFAULT_CAP` (256).
    """

    DEFAULT_CAP = 256

    def __init__(self, cap: Optional[int] = None,
                 reg: Optional[MetricsRegistry] = None):
        if cap is None:
            cap = self.DEFAULT_CAP
        self.cap = max(1, int(cap))
        self._reg = reg
        self._lock = threading.Lock()
        self._labels: dict = {}   # label -> None, insertion-ordered

    def touch(self, label: str) -> list:
        """Mark ``label`` most-recently-used; return evicted labels."""
        with self._lock:
            self._labels.pop(label, None)
            self._labels[label] = None
            evicted = []
            while len(self._labels) > self.cap:
                evicted.append(next(iter(self._labels)))
                del self._labels[evicted[-1]]
        if evicted:
            reg = self._reg if self._reg is not None else _REGISTRY
            reg.counter("obs.series_evicted").inc(len(evicted))
        return evicted

    def __len__(self) -> int:
        with self._lock:
            return len(self._labels)


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry."""
    return _REGISTRY


def metrics_enabled() -> bool:
    return _REGISTRY.enabled


def set_enabled(flag: bool) -> None:
    """Turn the process registry's metrics on or off (default on); the
    kernel-cache counters count either way."""
    _REGISTRY.set_enabled(flag)


def kernel_cache_event(key, hit: bool) -> None:
    """Record one ``tpe.get_kernel`` lookup. ``key``: the cache-key tuple.

    A miss means a fresh ``_TpeKernel`` was constructed for a new shape,
    so ``misses`` is the per-process count of kernel shapes built.
    """
    _REGISTRY.kernel_cache_event(key, hit)


def kernel_cache_stats(reset: bool = False) -> dict:
    """Snapshot (and optionally reset) the kernel-cache counters.

    Returns ``{"requests": int, "misses": int, "by_key": {repr(key):
    {"requests": int, "misses": int}}}``, the JAX package's schema.
    """
    return _REGISTRY.kernel_cache_stats(reset=reset)

"""Bounded in-process time-series store over the metrics registry.

Counterpart of ``hyperopt_tpu/obs/timeseries.py`` (host code, the same
names and numbers).  A registry snapshot and the fleet merge expose
*instantaneous* cumulative state; nothing in the stack retains it, so windowed
questions — "what was p95 suggest latency over the last minute", "is
the WAL fsync lag trending up" — were unanswerable without an external
scraper.  ``TimeSeriesStore`` closes that gap in-process:

* ``scrape()`` snapshots the registry (``snapshot(states=True)``) and
  appends one sample per counter/gauge/histogram to a bounded ring.
* Each series keeps a **raw** ring (every scrape) plus downsampled
  tiers at 1 s / 10 s / 60 s resolution.  All ring capacities are
  powers of two; a tier holds the *last* sample of each aligned period,
  which is exact for cumulative series (counters, cumulative histogram
  states) and last-write-wins for gauges.  Retention therefore grows
  geometrically per tier while memory stays O(sum of caps).
* Histogram samples store the full cumulative bucket-count state, so a
  *windowed* histogram is the elementwise difference of two cumulative
  states — exact windowed quantiles with no per-observation cost.
* Stores are mergeable across processes: ``export_series()`` /
  ``ingest()`` move raw samples between processes with timestamps
  normalized by a clock-skew estimate (``clock.skew_s`` convention:
  ``t_server ≈ t_client - skew_s``), and ``merged_window_state()``
  folds per-source windows with ``metrics.merge_histogram_states``.

Overhead: zero unless ``scrape()`` is called — nothing hooks the
metric hot paths.  A scrape is O(series) dict walks.  Device mode
scrapes a store registered with ``devtel.set_backfill_store`` once per
sync boundary, timestamped at the segment's end.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

from . import metrics as _metrics

__all__ = ["TimeSeriesStore", "TIERS", "RAW_CAP"]

#: (period_s, capacity) downsampling tiers — capacities are powers of
#: two; retention per tier = period × capacity.
TIERS = ((1.0, 512), (10.0, 256), (60.0, 128))

#: Raw ring capacity (one slot per scrape), power of two.
RAW_CAP = 1024

# Rough per-sample cost estimates for nbytes() — tuple + floats for a
# scalar sample, plus the interned counts tuple for histogram samples.
_SCALAR_SAMPLE_B = 120
_HIST_BASE_B = 160


class _Series:
    __slots__ = ("kind", "bounds", "raw", "tiers")

    def __init__(self, kind, raw_cap, tiers, bounds=None):
        self.kind = kind                 # "counter" | "gauge" | "hist"
        self.bounds = bounds             # shared bucket bounds (hist only)
        self.raw = deque(maxlen=raw_cap)         # (t, v)
        self.tiers = tuple(deque(maxlen=cap) for _, cap in tiers)
        # tier entries: (bucket_index, t, v)


def _hist_value(state):
    """Compact cumulative-histogram sample from a registry state dict."""
    return (tuple(state["counts"]), int(state["count"]),
            float(state["sum"]), state.get("min"), state.get("max"))


def _hist_state(bounds, value):
    counts, count, total, mn, mx = value
    return {"bounds": list(bounds), "counts": list(counts),
            "count": count, "sum": total, "min": mn, "max": mx}


def _diff_hist(bounds, end, start):
    """Windowed (non-cumulative-over-time) state: ``end - start``."""
    if start is None:
        return _hist_state(bounds, end)
    c_end, n_end, s_end = end[0], end[1], end[2]
    c_sta, n_sta, s_sta = start[0], start[1], start[2]
    counts = [max(0, a - b) for a, b in zip(c_end, c_sta)]
    # min/max are not differentiable over a window; report the
    # cumulative end extrema (documented approximation).
    return {"bounds": list(bounds), "counts": counts,
            "count": max(0, n_end - n_sta), "sum": s_end - s_sta,
            "min": end[3], "max": end[4]}


class TimeSeriesStore:
    """Bounded multi-tier sample store; see module docstring.

    ``reg`` pins the store to one :class:`~.metrics.MetricsRegistry`
    (tests use isolated registries); default is the process-global one,
    resolved at scrape time.
    """

    def __init__(self, reg=None, raw_cap: int = RAW_CAP, tiers=TIERS):
        self._reg = reg
        self._raw_cap = int(raw_cap)
        self._tiers = tuple((float(p), int(c)) for p, c in tiers)
        self._series: dict = {}
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.n_scrapes = 0

    # -- write side ----------------------------------------------------------

    def registry(self):
        return self._reg if self._reg is not None else _metrics.registry()

    def scrape(self, now: float | None = None) -> float:
        """Sample every registry series once; returns the scrape
        duration in seconds.  ``now`` overrides the sample timestamp so
        tests can drive synthetic clocks."""
        t0 = time.perf_counter()
        now = time.time() if now is None else float(now)
        reg = self.registry()
        snap = reg.snapshot(states=True)
        with self._lock:
            for name, v in snap.get("counters", {}).items():
                self._append(name, "counter", now, float(v))
            for name, v in snap.get("gauges", {}).items():
                self._append(name, "gauge", now, float(v))
            for name, h in snap.get("histograms", {}).items():
                st = h.get("state")
                if st and st.get("count"):
                    self._append_hist(name, now, st)
            self.n_scrapes += 1
        dur = time.perf_counter() - t0
        # Self-telemetry rides on the scraped registry (next scrape
        # picks it up) — emitted AFTER our lock is released so the only
        # lock edge is store-lock -> nothing.
        reg.gauge("obs.timeseries.series").set(self.n_series())
        reg.gauge("obs.timeseries.samples").set(self.n_samples())
        reg.gauge("obs.timeseries.bytes").set(self.nbytes())
        reg.histogram("obs.timeseries.scrape_s").observe(dur)
        return dur

    def _get_series(self, name, kind, bounds=None):
        """Get-or-create one series; caller holds ``self._lock``."""
        s = self._series.get(name)
        if s is None:
            s = self._series[name] = _Series(kind, self._raw_cap,
                                             self._tiers, bounds=bounds)
        return s

    def _append(self, name, kind, t, v):
        s = self._get_series(name, kind)
        self._push(s, t, v)

    def _append_hist(self, name, t, state):
        s = self._get_series(name, "hist", bounds=tuple(state["bounds"]))
        if s.bounds is None:
            s.bounds = tuple(state["bounds"])
        self._push(s, t, _hist_value(state))

    def _push(self, s, t, v):
        s.raw.append((t, v))
        for (period, _cap), ring in zip(self._tiers, s.tiers):
            bucket = int(t // period)
            if ring and ring[-1][0] == bucket:
                ring[-1] = (bucket, t, v)   # last sample of period wins
            else:
                ring.append((bucket, t, v))

    # -- read side -----------------------------------------------------------

    def n_series(self) -> int:
        with self._lock:
            return len(self._series)

    def n_samples(self) -> int:
        with self._lock:
            return sum(len(s.raw) + sum(len(r) for r in s.tiers)
                       for s in self._series.values())

    def nbytes(self) -> int:
        """Order-of-magnitude memory estimate (tracked as
        ``obs.timeseries.bytes``)."""
        total = 0
        with self._lock:
            for s in self._series.values():
                n = len(s.raw) + sum(len(r) for r in s.tiers)
                if s.kind == "hist":
                    per = _HIST_BASE_B + 8 * (len(s.bounds or ()) + 1)
                else:
                    per = _SCALAR_SAMPLE_B
                total += n * per
        return total

    def series_names(self) -> list:
        with self._lock:
            return sorted(self._series)

    def _pick_samples(self, s, start):
        """Finest ring whose retention covers ``start`` (best effort:
        the ring reaching furthest back otherwise), as [(t, v), ...]."""
        if s.raw and s.raw[0][0] <= start:
            return list(s.raw)
        best = list(s.raw)
        for ring in s.tiers:
            if ring:
                cand = [(t, v) for _, t, v in ring]
                if cand[0][0] <= start:
                    return cand
                if not best or cand[0][0] < best[0][0]:
                    best = cand
        return best

    def samples(self, name, window_s=None, now=None):
        """Scalar samples ``[(t, value), ...]`` within the window (all
        retained samples when ``window_s`` is None)."""
        now = time.time() if now is None else float(now)
        start = -float("inf") if window_s is None else now - float(window_s)
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return []
            out = self._pick_samples(s, start)
        return [(t, v) for t, v in out if start <= t <= now]

    def _sample_at(self, s, t):
        """Latest retained sample with timestamp <= t, or None."""
        best = None
        for t_i, v in s.raw:
            if t_i <= t:
                best = (t_i, v)
        if best is not None:
            return best
        for ring in reversed(s.tiers):      # coarse rings reach further back
            for _, t_i, v in ring:
                if t_i <= t:
                    best = (t_i, v)
            if best is not None:
                return best
        return None

    def delta(self, name, window_s, now=None):
        """Counter increase over the window (None when < 2 samples
        bracket it).  The baseline is the last sample at/before the
        window start, falling back to the earliest in-window sample."""
        now = time.time() if now is None else float(now)
        start = now - float(window_s)
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return None
            end = self._sample_at(s, now)
            base = self._sample_at(s, start)
            if base is None:
                inw = [(t, v) for t, v in self._pick_samples(s, start)
                       if start <= t <= now]
                base = inw[0] if inw else None
        if end is None or base is None or end[0] <= base[0]:
            return None
        return max(0.0, end[1] - base[1])

    def rate(self, name, window_s, now=None):
        d = self.delta(name, window_s, now=now)
        return None if d is None else d / float(window_s)

    def window_state(self, name, window_s, now=None):
        """Windowed histogram state (end-cumulative minus
        start-cumulative), or None if no sample covers the window end."""
        now = time.time() if now is None else float(now)
        start = now - float(window_s)
        with self._lock:
            s = self._series.get(name)
            if s is None or s.kind != "hist":
                return None
            end = self._sample_at(s, now)
            if end is None:
                return None
            base = self._sample_at(s, start)
            bounds = s.bounds
        return _diff_hist(bounds, end[1], None if base is None else base[1])

    def window_quantile(self, name, q, window_s, now=None):
        st = self.window_state(name, window_s, now=now)
        if not st or not st["count"]:
            return None
        return _metrics._state_quantile(st, q)

    def window_frac_above(self, name, threshold, window_s, now=None):
        """Fraction of window observations whose bucket upper bound
        exceeds ``threshold`` — the conservative (bucket-resolution)
        tail fraction SLO burn rates are computed from."""
        st = self.window_state(name, window_s, now=now)
        if not st or not st["count"]:
            return None
        bad = 0
        for i, c in enumerate(st["counts"]):
            upper = (st["bounds"][i] if i < len(st["bounds"])
                     else float("inf"))
            if upper > threshold:
                bad += c
        return bad / st["count"]

    # -- cross-process merge -------------------------------------------------

    def export_series(self) -> dict:
        """JSON-able raw-tier dump for cross-process merging."""
        out = {}
        with self._lock:
            for name, s in self._series.items():
                if s.kind == "hist":
                    raw = [[t, list(v[0]), v[1], v[2]] for t, v in s.raw]
                    out[name] = {"kind": "hist", "bounds": list(s.bounds),
                                 "raw": raw}
                else:
                    out[name] = {"kind": s.kind,
                                 "raw": [[t, v] for t, v in s.raw]}
        return out

    def ingest(self, src: str, series: dict, skew_s: float = 0.0) -> None:
        """Fold another process's ``export_series()`` dump in under
        ``<src>:<name>`` keys, timestamps skew-normalized onto this
        process's clock (``t_local = t_remote - skew_s``, matching the
        ``clock.skew_s`` gauge convention from the heartbeat RTT
        estimate)."""
        skew = float(skew_s or 0.0)
        with self._lock:
            for name, ser in series.items():
                key = f"{src}:{name}"
                if ser.get("kind") == "hist":
                    bounds = tuple(ser["bounds"])
                    s = self._get_series(key, "hist", bounds=bounds)
                    for t, counts, count, total in ser["raw"]:
                        self._push(s, t - skew,
                                   (tuple(counts), int(count),
                                    float(total), None, None))
                else:
                    s = self._get_series(key, ser.get("kind", "gauge"))
                    for t, v in ser["raw"]:
                        self._push(s, t - skew, float(v))

    def merged_window_state(self, names, window_s, now=None):
        """One windowed histogram state across several series (e.g. the
        same verb's latency ingested from N processes)."""
        states = [self.window_state(n, window_s, now=now) for n in names]
        return _metrics.merge_histogram_states(states)

    # -- background scraper --------------------------------------------------

    def start(self, interval_s: float = 2.0):
        """Daemon scrape loop; idempotent."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.scrape()
                except Exception:       # pragma: no cover - keep scraping
                    logging.getLogger(__name__).exception(
                        "timeseries scrape pass failed; continuing")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="obs-timeseries-scraper")
        self._thread.start()

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

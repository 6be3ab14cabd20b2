"""Per-kernel cost attribution: build wall time, memory, dispatch times.

Counterpart of ``hyperopt_tpu/obs/costs.py``.  Every kernel-cache site
(``tpe.get_kernel``, the fleet's cohort tiers, device mode's captured
steps) feeds :func:`~.metrics.kernel_cache_event`; this module adds the
cost side, keyed by the same ``repr(key)``, so :func:`ledger_report` can
join build costs with request counts and per-dispatch wall times.

XLA's ``cost_analysis`` has no PyTorch counterpart.  A compile row holds
the wall time of building the kernel (``_TpeKernel`` for a TPE shape; in
device mode the segment's build, which on the card is its warm-up and
CUDA-graph capture) and, in device mode, the graph's memory pool
(``_Segment.pool_bytes``) as ``peak_memory_bytes``.  Flops and bytes stay
``None``, as the JAX package leaves them on backends that report nothing.

Disarmed (the default; :func:`arm` arms) every hook is one module-global
boolean check.  Armed, a cache miss adds one dict entry and a dispatch one
dict update under a lock, from host clocks the caller already read.
"""

from __future__ import annotations

import threading

from . import metrics as _metrics

__all__ = [
    "arm",
    "armed",
    "clear",
    "disarm",
    "ledger_report",
    "observe_dispatch",
    "record_compile",
]

#: Module-global fast path: every hook starts with ``if not _armed``.
_armed = False

_LOCK = threading.Lock()
#: repr(cache key) -> compile-cost entry (see record_compile).
_LEDGER: dict = {}
#: repr(cache key) -> live per-dispatch accumulator (see observe_dispatch).
_LIVE: dict = {}

#: Which shared live histograms attribute to which kernel family.
_FAMILY_SERIES = {
    "tpe": ("suggest.upload_ms", "suggest.dispatch_ms",
            "suggest.fetch_sync_ms"),
    "fleet": ("suggest.upload_ms", "suggest.dispatch_ms",
              "suggest.fetch_sync_ms"),
    # Device-mode segments: one dispatch is one segment of replays
    # (obs.devtel backfills the histogram at each sync boundary).
    "device": ("device.telemetry.segment_ms",),
}


def armed() -> bool:
    return _armed


def arm() -> None:
    global _armed
    _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def clear() -> None:
    """Drop all recorded entries (tests/benches)."""
    with _LOCK:
        _LEDGER.clear()
        _LIVE.clear()


def record_compile(kernel: str, key, *, n_cap=None, P=None, m=None,
                   tier=None, compile_s=None, memory_bytes=None):
    """Record one kernel-cache **miss**'s build cost.

    ``kernel`` is the family (``tpe`` / ``fleet`` / ``device``); ``key`` the
    cache-key tuple the site also gave ``kernel_cache_event``.
    ``compile_s`` is the build's measured wall time and ``memory_bytes``
    the memory it pinned (device mode: the graph's pool).  Returns the
    ledger entry, or None when disarmed."""
    if not _armed:
        return None
    reg = _metrics.registry()
    entry = {"kernel": kernel, "key": repr(key), "n_cap": n_cap, "P": P,
             "m": m, "tier": tier, "compile_s": compile_s,
             "flops": None, "bytes_accessed": None,
             "peak_memory_bytes": memory_bytes, "argument_bytes": None,
             "output_bytes": None, "temp_bytes": None,
             "generated_code_bytes": None}
    with _LOCK:
        _LEDGER[entry["key"]] = entry
        n = len(_LEDGER)
    reg.counter("cost.compiles").inc()
    if compile_s is not None:
        reg.histogram("cost.compile_s").observe(compile_s)
    reg.gauge("cost.entries").set(n)
    return entry


def observe_dispatch(key, ms: float) -> None:
    """Attribute one live dispatch's wall time to its program (the same
    cache key the build site used)."""
    if not _armed:
        return
    ks = repr(key)
    with _LOCK:
        acc = _LIVE.get(ks)
        if acc is None:
            acc = _LIVE[ks] = {"calls": 0, "total_ms": 0.0,
                               "min_ms": None, "max_ms": None}
        acc["calls"] += 1
        acc["total_ms"] += ms
        if acc["min_ms"] is None or ms < acc["min_ms"]:
            acc["min_ms"] = ms
        if acc["max_ms"] is None or ms > acc["max_ms"]:
            acc["max_ms"] = ms


def ledger_report(reg=None) -> dict:
    """The joined per-kernel cost ledger: one row per recorded build,
    joined with the kernel-cache request counts (same ``repr(key)``), the
    per-key dispatch accumulator and the family's shared histogram
    summaries.  ``ms_per_suggestion`` is the mean dispatch ms over the
    proposals per call (``m``)."""
    reg = reg if reg is not None else _metrics.registry()
    kcs = _metrics.kernel_cache_stats()
    by_key = kcs.get("by_key", {})
    with _LOCK:
        entries = {k: dict(v) for k, v in _LEDGER.items()}
        live = {k: dict(v) for k, v in _LIVE.items()}
    hists = reg.snapshot().get("histograms", {})
    rows = []
    for ks in sorted(entries):
        e = entries[ks]
        cache = by_key.get(ks, {})
        e["requests"] = cache.get("requests", 0)
        e["misses"] = cache.get("misses", 0)
        acc = live.get(ks)
        if acc:
            e["dispatches"] = acc["calls"]
            e["dispatch_ms_mean"] = acc["total_ms"] / acc["calls"]
            e["dispatch_ms_min"] = acc["min_ms"]
            e["dispatch_ms_max"] = acc["max_ms"]
            e["ms_per_suggestion"] = e["dispatch_ms_mean"] / (e.get("m") or 1)
        rows.append(e)
    fams = sorted({e["kernel"] for e in rows} or _FAMILY_SERIES)
    live_series = {}
    for fam in fams:
        for name in _FAMILY_SERIES.get(fam, ()):
            h = hists.get(name)
            if h and h.get("count"):
                live_series[name] = {k: h.get(k) for k in
                                     ("count", "mean", "p50", "p95")}
    return {
        "entries": rows,
        "live_ms": live_series,
        "kernel_cache": {"requests": kcs.get("requests", 0),
                         "misses": kcs.get("misses", 0)},
        "armed": _armed,
    }

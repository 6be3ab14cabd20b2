"""Bounded-buffer structured event log with Chrome trace_event export.

Counterpart of ``hyperopt_tpu/obs/events.py``: one process-global
:class:`EventLog` (``EVENTS``) collects typed events (:data:`EVENT_TYPES`)
from the loop, the suggest algorithms and device mode.  It is disabled by
default (``emit()``/``span()`` reduce to one attribute check) and armed
explicitly or by a :class:`~.trace.Tracer` with a ``trace_dir``.

Each record carries ``t_mono`` (``time.perf_counter()``) and ``t_wall``
(derived from one wall/mono anchor pair, so the two clocks never disagree
about order), the emitting thread and the enclosing span id.  Storage is a
``deque(maxlen=capacity)`` ring: the capacity is the constructor's
argument (default :data:`DEFAULT_CAPACITY`), and a run that outlives it
keeps the newest events and counts the displaced ones in ``n_dropped``.

:func:`events_to_chrome` turns span pairs into ``"ph": "X"`` complete
events and everything else into ``"ph": "i"`` instants, microsecond
timestamps anchored to the epoch, which Perfetto and chrome://tracing
load beside the ``torch.profiler`` trace of the same run.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import threading
import time
from collections import deque
from contextlib import contextmanager

from . import context as _context

__all__ = ["EVENTS", "EventLog", "EVENT_TYPES", "DEFAULT_CAPACITY",
           "events_to_chrome"]

DEFAULT_CAPACITY = 65536

#: Advisory vocabulary for ``type`` — emit() accepts any string so new
#: subsystems can add events without touching this module, but everything
#: the core emits is listed here (tests pin the core set against it).
EVENT_TYPES = frozenset(
    {
        "trial_start",
        "trial_end",
        "suggest",
        "compile",
        "store_claim",
        "store_write",
        "store_flush",
        "store_requeue",
        "worker_up",
        "worker_down",
        "transfer_borrow",
        "transfer_drop",
        "span_begin",
        "span_end",
        "pipeline_dispatch",
        "pipeline_materialize",
        "pipeline_cancel",
        "pipeline_fallback",
        "fault_injected",
        "trial_retry",
        "trial_queued",
        "store_heartbeat",
        "rpc",
        "slo_alert",
        "flight_dump",
        "history_order_violation",
    }
)


class EventLog:
    """Thread-safe bounded ring buffer of typed telemetry events."""

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            capacity = DEFAULT_CAPACITY
        self.capacity = max(1, int(capacity))
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._span_ids = itertools.count(1)
        self._tls = threading.local()
        self._enabled = False
        self.n_emitted = 0  # total ever emitted (buffer may have dropped some)
        self.n_dropped = 0  # events the full ring displaced (overflow tally)
        # One wall/mono anchor pair: t_wall is always derived from t_mono so
        # the two clocks can never disagree about event ordering.
        self._wall0 = time.time()
        self._mono0 = time.perf_counter()
        # Process identity + clock anchor, exported as the first line of
        # dump_jsonl() so a cross-process merger can clock-normalize and
        # label each lane.  ``skew_s`` is this process's estimated
        # wall-clock offset from a shared server clock; a merger
        # subtracts it.
        self._meta = {
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "wall0": self._wall0,
            "mono0": self._mono0,
            "skew_s": 0.0,
        }

    # -- process metadata ------------------------------------------------
    def set_meta(self, **kw) -> None:
        """Attach/override header fields (worker_id, role, trace_id, skew_s)."""
        with self._lock:
            self._meta.update(kw)

    def meta(self) -> dict:
        with self._lock:
            return dict(self._meta)

    # -- arming ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.n_emitted = 0
            self.n_dropped = 0

    # -- emission --------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def emit(self, etype: str, name=None, trial=None, **fields):
        """Record one point event; returns the record (or None if disabled).

        ``span``/``parent`` are filled from the calling thread's span
        stack unless passed explicitly in ``fields``.
        """
        if not self._enabled:
            return None
        mono = time.perf_counter()
        stack = self._stack()
        rec = {
            "type": etype,
            "t_mono": mono,
            "t_wall": self._wall0 + (mono - self._mono0),
            "thread": threading.current_thread().name,
        }
        if name is not None:
            rec["name"] = name
        if trial is not None:
            rec["trial"] = trial
        if "span" not in fields and stack:
            rec["span"] = stack[-1]
        rec.update(fields)
        # Ambient trace context (obs.context): events recorded while a
        # cross-process context is bound attach to the originating trial
        # even when the call site doesn't know the tid (fault injections,
        # RPC dispatch, store writes on behalf of a remote caller).
        if _context._armed:
            ctx = getattr(_context._tls, "ctx", None)
            if ctx:
                tid = ctx.get("trace_id")
                if tid is not None and "trace_id" not in rec:
                    rec["trace_id"] = tid
                if rec.get("trial") is None and ctx.get("tid") is not None:
                    rec["trial"] = ctx["tid"]
        with self._lock:
            if len(self._buf) == self.capacity:
                # deque(maxlen=...) silently displaces the oldest record;
                # tally it so coverage claims ("the ring holds the whole
                # run") stay honest in bundles and `show trace`.
                self.n_dropped += 1
            self._buf.append(rec)
            self.n_emitted += 1
        return rec

    @contextmanager
    def span(self, name: str, trial=None, **fields):
        """Nested named span: emits span_begin/span_end with parent links."""
        if not self._enabled:
            yield None
            return
        sid = next(self._span_ids)
        stack = self._stack()
        parent = stack[-1] if stack else None
        self.emit("span_begin", name=name, trial=trial, span=sid, parent=parent, **fields)
        stack.append(sid)
        try:
            yield sid
        finally:
            stack.pop()
            self.emit("span_end", name=name, trial=trial, span=sid, parent=parent)

    # -- readout ---------------------------------------------------------
    def snapshot(self) -> list:
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def dump_jsonl(self, path) -> int:
        """Write one JSON object per line; returns the number of events.

        The first line is a ``{"type": "meta", ...}`` header carrying the
        process identity and wall/mono clock anchor (plus ``skew_s``, the
        heartbeat-estimated offset from the server clock) — the merger's
        clock-normalization input.  Readers that iterate records should
        skip ``type == "meta"``.
        """
        events = self.snapshot()
        with open(path, "w") as fh:
            fh.write(json.dumps({"type": "meta", **self.meta(),
                                 "n_emitted": self.n_emitted,
                                 "n_dropped": self.n_dropped}) + "\n")
            for rec in events:
                fh.write(json.dumps(rec) + "\n")
        return len(events)

    def to_chrome_trace(self, events: list | None = None) -> dict:
        """Render as Chrome ``trace_event`` JSON (Perfetto-loadable).

        Matched span_begin/span_end pairs become ``"ph": "X"`` complete
        events (ts/dur in µs, epoch-anchored); a begin whose end fell
        outside the ring buffer becomes a zero-duration ``"B"``-less
        instant rather than an unclosed nesting error; all other events
        become ``"ph": "i"`` instants.
        """
        if events is None:
            events = self.snapshot()
        out, _ = events_to_chrome(events, pid=os.getpid())
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path) -> int:
        trace = self.to_chrome_trace()
        with open(path, "w") as fh:
            json.dump(trace, fh)
        return len(trace["traceEvents"])


def events_to_chrome(events: list, pid: int | None = None, ts_fn=None):
    """Convert structured event records into Chrome ``trace_event`` dicts.

    The shared conversion core behind :meth:`EventLog.to_chrome_trace`
    (single process) and ``show.py``'s ``merge_traces`` (many processes):

    * ``pid`` — the lane the events render into (the merger assigns one
      per source process),
    * ``ts_fn`` — optional ``rec -> wall seconds`` override; the merger
      passes each file's own ``wall0 + (t_mono - mono0) - skew_s``
      normalization so lanes from different machines line up.

    Returns ``(trace_events, anchors)``: ``anchors`` is one
    ``(ts_us, pid, tid_lane, trial, type)`` tuple per converted record
    that carries a trial id — the attachment points for the merger's
    per-trial cross-lane flow arrows.  ``meta`` header records are
    skipped so a raw ``loop_events.jsonl`` can be fed directly.
    """
    if pid is None:
        pid = os.getpid()
    if ts_fn is None:
        ts_fn = lambda rec: rec["t_wall"]  # noqa: E731
    tids: dict = {}

    def _tid(thread_name):
        return tids.setdefault(thread_name, len(tids) + 1)

    open_spans: dict = {}
    out = []
    anchors = []

    def _anchor(rec, ts_us, lane):
        if rec.get("trial") is not None:
            anchors.append((ts_us, pid, lane, rec["trial"], rec["type"]))

    for rec in events:
        if rec.get("type") == "meta":
            continue
        ph_args = {
            k: v
            for k, v in rec.items()
            if k not in ("type", "name", "t_mono", "t_wall", "thread")
        }
        ts_us = ts_fn(rec) * 1e6
        if rec["type"] == "span_begin":
            open_spans[rec.get("span")] = rec
        elif rec["type"] == "span_end":
            begin = open_spans.pop(rec.get("span"), None)
            if begin is None:
                continue  # begin fell out of the ring buffer
            lane = _tid(begin["thread"])
            begin_us = ts_fn(begin) * 1e6
            out.append(
                {
                    "name": begin.get("name", "span"),
                    "ph": "X",
                    "ts": begin_us,
                    "dur": max(0.0, (rec["t_mono"] - begin["t_mono"]) * 1e6),
                    "pid": pid,
                    "tid": lane,
                    "cat": "hyperopt_tpu",
                    "args": {
                        k: v
                        for k, v in begin.items()
                        if k not in ("type", "name", "t_mono", "t_wall", "thread")
                    },
                }
            )
            _anchor(begin, begin_us, lane)
        else:
            lane = _tid(rec["thread"])
            out.append(
                {
                    "name": rec.get("name", rec["type"]),
                    "ph": "i",
                    "s": "t",
                    "ts": ts_us,
                    "pid": pid,
                    "tid": lane,
                    "cat": "hyperopt_tpu:" + rec["type"],
                    "args": ph_args,
                }
            )
            _anchor(rec, ts_us, lane)
    # Spans still open when the log was read: emit as zero-length marks
    # so the trace stays loadable.
    for begin in open_spans.values():
        out.append(
            {
                "name": begin.get("name", "span"),
                "ph": "i",
                "s": "t",
                "ts": ts_fn(begin) * 1e6,
                "pid": pid,
                "tid": _tid(begin["thread"]),
                "cat": "hyperopt_tpu:span_open",
                "args": {},
            }
        )
    out.sort(key=lambda e: e["ts"])
    return out, anchors


#: Process-global event log; disabled until a Tracer (or a test) arms it.
EVENTS = EventLog()

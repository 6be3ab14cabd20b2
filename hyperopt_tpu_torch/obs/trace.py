"""The port's spans: one process-wide span store, the per-run loop tracer,
the ``torch.profiler`` trace, and the trace-dir artifacts.

Counterpart of ``hyperopt_tpu/obs/trace.py``, with one span mechanism for
the whole program.  A span site is ``with span("tpe.step"): ...``.

**Armed only while someone traces.**  The store records while a
:class:`Tracer` with a ``trace_dir`` runs (from its construction to its
:meth:`Tracer.dump`) or while any ``torch.profiler`` session records.
Otherwise :func:`span` returns one shared no-op context manager: a site
then costs one call and one flag read, allocates nothing and reads no
clock.  There is no switch of its own.

**What a span records.**  Its name, start and end (``perf_counter_ns``,
the host's monotonic clock), the id of the span that was open on the same
thread when it began (its parent; a span opened on a fresh thread has
none), the thread, and the request id: the first new trial id of the
proposal it served (:func:`set_request`, or ``span(name, request=)``).
The store keeps, per span name, the count, the total nanoseconds and the
self nanoseconds (the duration less what the span's children cover), so
its size is bounded by the number of names, not by the run's length; and
a ring of the newest :data:`RING_CAPACITY` raw spans.
:func:`span_summary` reads the aggregates, :func:`recent_spans` the ring,
:func:`span_clear` empties both.

**The profiler's timeline.**  While a profiler records, each span is also
a host range on the profiler's own timeline (a ``RecordFunction`` that is
not a user annotation, so it has no mirror on the device timeline and
counts as no device operation), on the profiler's clock: in
``profiler_trace.json`` a span lies beside the kernels it enqueued, and
``show trace`` names the card's idle time by the innermost span open
then.  The event log is not touched: span sites emit no events.

**Under a CUDA graph.**  The step's phase spans (``tpe.step.*``) run
eagerly on the hosted path.  Under a capture (device mode, the graft
entry's ``capture``) they time only the capture; a replay runs no Python
and records nothing.

:class:`Tracer` keeps its own per-run totals on top of the store (under a
lock: spans may run on several threads), mirrors every span into the
process-global event log, and drives ``torch.profiler`` where the JAX
package drives ``jax.profiler``.  Constructing a Tracer with a
``trace_dir`` arms the store, the event log and the trace context for the
run; :meth:`Tracer.dump` then writes

* ``loop_trace.json``: per span name total_s/count/mean_ms/self_s and the
  name of its (most frequent) parent: the Tracer's own spans and the
  program's spans nested in them during the run; and ``_wall`` (the run's
  wall time, the seconds attributed to the Tracer's spans that have no
  parent, coverage);
* ``loop_events.jsonl``: the raw event log;
* ``chrome_trace.json``: the Chrome ``trace_event`` export of the events;

and :meth:`Tracer.stop_device_trace` writes the profiler's own Chrome
export, ``profiler_trace.json`` (:data:`PROFILER_TRACE`): every CUDA
kernel of the run with its launches, kernels replayed from CUDA graphs
included, when the run's device is CUDA; the CPU operators alone
otherwise; the spans among them.  A profiler that fails to start raises:
a run asked for a trace does not go on without one.

:class:`NullTracer` is the path ``fmin`` takes without a trace dir: its
``span`` is :func:`span` (the shared no-op context manager while nothing
traces).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Optional

import torch

from . import context as _context
from .events import EVENTS

__all__ = ["Tracer", "NullTracer", "PROFILER_TRACE", "RING_CAPACITY",
           "armed", "current_request", "recent_spans", "set_request",
           "span", "span_clear", "span_summary"]

#: File name of the profiler's Chrome export in the trace dir.
PROFILER_TRACE = "profiler_trace.json"
#: Raw spans the store's ring keeps (the newest).
RING_CAPACITY = 16384


class _NullSpan:
    """Reusable zero-cost context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


# ``_PROFILER._is_profiler_enabled`` is True while a profiler session
# records: a module global of torch's, read in tens of nanoseconds.
_PROFILER = torch.autograd.profiler
_RANGE = torch._C._profiler._RecordFunctionFast

# Tracers with a trace dir that are running; see :func:`armed`.
_TRACERS = 0
_LOCK = threading.Lock()
_TLS = threading.local()
_IDS = itertools.count(1)
# name -> [count, total_ns, self_ns, {parent name: count}]
_AGG: dict = {}
_RING: deque = deque(maxlen=RING_CAPACITY)


def armed() -> bool:
    """True while the store records: a :class:`Tracer` with a trace dir
    runs, or a ``torch.profiler`` session records."""
    return bool(_TRACERS or _PROFILER._is_profiler_enabled)


def _arm(delta):
    global _TRACERS
    with _LOCK:
        _TRACERS += delta


def _stack():
    try:
        return _TLS.stack
    except AttributeError:
        st = _TLS.stack = []
        return st


class _Span:
    """One open span of the store.  ``record=False`` keeps it on the
    thread's stack (a parent for what nests in it) without recording it:
    a Tracer's span while nothing traces."""

    __slots__ = ("name", "request", "record", "sid", "parent", "t0",
                 "dur_ns", "child_ns", "_range")

    def __init__(self, name, request=None, record=True):
        self.name = name
        self.request = request
        self.record = record
        self.sid = 0
        self.child_ns = 0
        self.dur_ns = 0
        self._range = None

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else None
        st.append(self)
        if self.request is not None:
            _TLS.request = self.request
        if self.record:
            self.sid = next(_IDS)
            if _PROFILER._is_profiler_enabled:
                self._range = _RANGE(self.name)
                self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)
        dur = self.dur_ns = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        if self.record:
            _record(self, t1, getattr(_TLS, "request", None))
        return False

    @property
    def self_ns(self):
        return self.dur_ns - self.child_ns


def _record(sp, t1, request):
    parent = sp.parent
    pname = None if parent is None else parent.name
    raw = (sp.sid, None if parent is None else parent.sid, sp.name,
           threading.get_ident(), request, sp.t0, t1)
    dur = t1 - sp.t0
    with _LOCK:
        agg = _AGG.get(sp.name)
        if agg is None:
            agg = _AGG[sp.name] = [0, 0, 0, {}]
        agg[0] += 1
        agg[1] += dur
        agg[2] += dur - sp.child_ns
        agg[3][pname] = agg[3].get(pname, 0) + 1
        _RING.append(raw)


def span(name: str, request=None):
    """A span of the store named ``name``; ``request`` (the first new
    trial id of a proposal) becomes the thread's request id from here on.
    While nothing traces (:func:`armed`), the shared no-op context
    manager."""
    if _TRACERS or _PROFILER._is_profiler_enabled:
        return _Span(name, request)
    return _NULL_SPAN


def set_request(request) -> None:
    """Make ``request`` the calling thread's request id: every span that
    ends on this thread from now on until the next call carries it.  A
    no-op while nothing traces."""
    if _TRACERS or _PROFILER._is_profiler_enabled:
        _TLS.request = request


def current_request():
    """The calling thread's request id (None: none set while armed)."""
    return getattr(_TLS, "request", None)


def span_summary() -> dict:
    """The store's aggregates: ``{name: {"count", "total_ns", "self_ns",
    "parent"}}``, ``parent`` the name of the span most often open around
    it on its thread (None: mostly none)."""
    with _LOCK:
        return {name: {"count": a[0], "total_ns": a[1], "self_ns": a[2],
                       "parent": max(a[3], key=a[3].get)}
                for name, a in _AGG.items()}


def recent_spans() -> list:
    """The ring's raw spans, oldest first: ``{"id", "parent", "name",
    "thread", "request", "start_ns", "end_ns"}`` (``perf_counter_ns``)."""
    with _LOCK:
        raw = list(_RING)
    keys = ("id", "parent", "name", "thread", "request", "start_ns",
            "end_ns")
    return [dict(zip(keys, r)) for r in raw]


def span_clear() -> None:
    """Empty the store's aggregates and ring."""
    with _LOCK:
        _AGG.clear()
        _RING.clear()


# Empty kernels and the idle wait that open a CUDA profiler session.
LEAD_IN_KERNELS = 8
LEAD_IN_S = 0.02
# The profiler's name for those kernels (``torch.cuda._sleep``).
LEAD_IN_KERNEL = "spin_kernel"


def profiler_lead_in(device):
    """Open a CUDA profiler session with ``LEAD_IN_KERNELS`` empty kernels
    and a ``LEAD_IN_S`` wait with the card idle.  Without them, on an
    H100, a session now and then lost the kernel records of its first
    moments (the first kernel, or milliseconds of replayed graphs, EI
    kernels among them); with them, none were lost."""
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        for _ in range(LEAD_IN_KERNELS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
    time.sleep(LEAD_IN_S)


class Tracer:
    """Accumulates named wall-clock spans of the store per run; optionally
    drives ``torch.profiler``.

    ``device_trace=True`` (with a ``trace_dir``) profiles the run between
    :meth:`start_device_trace` and :meth:`stop_device_trace`: the CPU and
    CUDA activities when ``device`` is a CUDA device, the CPU activity
    alone otherwise."""

    def __init__(self, trace_dir: Optional[str] = None,
                 device_trace: bool = False, events=EVENTS, device=None):
        self.trace_dir = trace_dir
        self.device_trace = device_trace and trace_dir is not None
        self.device = None if device is None else torch.device(device)
        self.events = events
        self._lock = threading.Lock()
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.selfs = defaultdict(float)
        self._root_s = 0.0  # this Tracer's spans with no parent
        self._profiler = None
        self._armed_events = False
        self._armed_context = False
        self._armed_store = False
        self._store0 = {}
        self.trace_id = None
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            if not self.events.enabled:
                self.events.enable()
                self._armed_events = True
            if not _context.armed():
                _context.enable()
                self._armed_context = True
            self.trace_id = _context.new_trace_id()
            self.events.set_meta(trace_id=self.trace_id)
            self._store0 = span_summary()
            _arm(1)
            self._armed_store = True
        self._t0 = time.perf_counter()
        self._wall_s = None

    # -- spans ---------------------------------------------------------------

    @contextmanager
    def span(self, name: str, trial=None, request=None):
        """A span of the store (recorded while it is armed, on the
        thread's stack either way) counted into this Tracer's totals."""
        sp = _Span(name, request, record=armed())
        sp.__enter__()
        try:
            with self.events.span(name, trial=trial):
                yield
        finally:
            sp.__exit__(None, None, None)
            dt, self_s = sp.dur_ns * 1e-9, sp.self_ns * 1e-9
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1
                self.selfs[name] += self_s
                if sp.parent is None:
                    self._root_s += dt

    # -- device traces -------------------------------------------------------

    def start_device_trace(self):
        """Start the profiler (no-op without ``device_trace`` or when it
        runs already)."""
        if not self.device_trace or self._profiler is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        cuda = self.device is not None and self.device.type == "cuda"
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        if cuda:
            profiler_lead_in(self.device)
        self._profiler = prof

    def stop_device_trace(self):
        """Stop the profiler and write its Chrome export into the trace
        dir as :data:`PROFILER_TRACE`."""
        if self._profiler is None:
            return
        prof, self._profiler = self._profiler, None
        prof.stop()
        prof.export_chrome_trace(os.path.join(self.trace_dir,
                                              PROFILER_TRACE))

    # -- summary -------------------------------------------------------------

    def summary(self) -> dict:
        """Per span name of this Tracer: total_s, count, mean_ms and
        self_s (the time no nested span covers)."""
        out = {}
        with self._lock:
            items = sorted(self.totals.items())
            counts = dict(self.counts)
            selfs = dict(self.selfs)
        for name, total in items:
            n = counts[name]
            out[name] = {"total_s": round(total, 6), "count": n,
                         "mean_ms": round(1e3 * total / max(n, 1), 3),
                         "self_s": round(selfs[name], 6)}
        return out

    def _nested(self) -> dict:
        """The store's spans of other names that ended since this Tracer
        was made (a Tracer with a trace dir), in :meth:`summary`'s form;
        every entry, this Tracer's own included, gains ``parent``."""
        now = span_summary()
        own = self.summary()
        out = {}
        for name, a in now.items():
            b = self._store0.get(name, {"count": 0, "total_ns": 0,
                                        "self_ns": 0})
            n = a["count"] - b["count"]
            if name in own:
                own[name]["parent"] = a["parent"]
            elif n > 0:
                total = (a["total_ns"] - b["total_ns"]) * 1e-9
                out[name] = {"total_s": round(total, 6), "count": n,
                             "mean_ms": round(1e3 * total / n, 3),
                             "self_s": round((a["self_ns"] - b["self_ns"])
                                             * 1e-9, 6),
                             "parent": a["parent"]}
        for rec in own.values():
            rec.setdefault("parent", None)
        return dict(sorted({**own, **out}.items()))

    def set_wall(self, wall_s: float) -> None:
        """Pin the attribution denominator to the measured loop window, so
        that the profiler's start and stop stay outside it."""
        self._wall_s = float(wall_s)

    def attribution(self) -> dict:
        """Wall-time coverage: the fraction attributed to this Tracer's
        spans that have no parent in the store (disjoint in the serial
        loop; nested spans are left out so nothing counts twice)."""
        wall = self._wall_s
        if wall is None:
            wall = time.perf_counter() - self._t0
        with self._lock:
            attributed = self._root_s
        return {
            "wall_s": round(wall, 6),
            "attributed_s": round(attributed, 6),
            "coverage": round(attributed / wall, 4) if wall > 0 else 0.0,
        }

    def dump(self) -> Optional[str]:
        if not self.trace_dir:
            return None
        doc = self._nested()
        doc["_wall"] = self.attribution()
        path = os.path.join(self.trace_dir, "loop_trace.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
        if self.events.enabled:
            self.events.dump_jsonl(
                os.path.join(self.trace_dir, "loop_events.jsonl"))
            self.events.export_chrome_trace(
                os.path.join(self.trace_dir, "chrome_trace.json"))
        if self._armed_events:
            self.events.disable()
            self.events.clear()
            self._armed_events = False
        if self._armed_context:
            _context.disable()
            self._armed_context = False
        if self._armed_store:
            _arm(-1)
            self._armed_store = False
        return path


class NullTracer(Tracer):
    """Tracer without a dir, a profiler or event mirroring: ``span`` is
    the store's :func:`span`, one preallocated no-op context manager while
    nothing traces, and keeps no totals."""

    def __init__(self):
        super().__init__(trace_dir=None, device_trace=False)

    def span(self, name: str, trial=None, request=None):
        return span(name, request)

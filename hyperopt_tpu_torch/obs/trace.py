"""Per-run loop tracer: named spans, the ``torch.profiler`` trace, and the
trace-dir artifacts.

Counterpart of ``hyperopt_tpu/obs/trace.py``.  :class:`Tracer` sums the
wall time per span name (under a lock: spans may run on several threads),
mirrors every span into the process-global event log, and drives
``torch.profiler`` where the JAX package drives ``jax.profiler``.
Constructing a Tracer with a ``trace_dir`` arms the event log and the
trace context for the run; :meth:`Tracer.dump` then writes

* ``loop_trace.json``: total_s/count/mean_ms per span, and ``_wall`` (the
  run's wall time, the seconds attributed to depth-0 spans, coverage);
* ``loop_events.jsonl``: the raw event log;
* ``chrome_trace.json``: the Chrome ``trace_event`` export of the events;

and :meth:`Tracer.stop_device_trace` writes the profiler's own Chrome
export, ``profiler_trace.json`` (:data:`PROFILER_TRACE`): every CUDA
kernel of the run with its launches, kernels replayed from CUDA graphs
included, when the run's device is CUDA; the CPU operators alone
otherwise.  A profiler that fails to start raises: a run asked for a
trace does not go on without one.

:class:`NullTracer` is the path ``fmin`` takes without a trace dir: its
``span`` returns one shared no-op context manager (no clock read, no lock,
no allocation).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Optional

import torch

from . import context as _context
from .events import EVENTS

__all__ = ["Tracer", "NullTracer", "PROFILER_TRACE"]

#: File name of the profiler's Chrome export in the trace dir.
PROFILER_TRACE = "profiler_trace.json"


class _NullSpan:
    """Reusable zero-cost context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


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
    """Accumulates named wall-clock spans; optionally drives
    ``torch.profiler``.

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
        self._top_totals = defaultdict(float)  # depth-0 spans only
        self._depth = threading.local()
        self._profiler = None
        self._armed_events = False
        self._armed_context = False
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
        self._t0 = time.perf_counter()
        self._wall_s = None

    # -- spans ---------------------------------------------------------------

    @contextmanager
    def span(self, name: str, trial=None):
        depth = getattr(self._depth, "n", 0)
        self._depth.n = depth + 1
        t0 = time.perf_counter()
        try:
            with self.events.span(name, trial=trial):
                yield
        finally:
            dt = time.perf_counter() - t0
            self._depth.n = depth
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1
                if depth == 0:
                    self._top_totals[name] += dt

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
        out = {}
        with self._lock:
            items = sorted(self.totals.items())
            counts = dict(self.counts)
        for name, total in items:
            n = counts[name]
            out[name] = {"total_s": round(total, 6), "count": n,
                         "mean_ms": round(1e3 * total / max(n, 1), 3)}
        return out

    def set_wall(self, wall_s: float) -> None:
        """Pin the attribution denominator to the measured loop window, so
        that the profiler's start and stop stay outside it."""
        self._wall_s = float(wall_s)

    def attribution(self) -> dict:
        """Wall-time coverage: the fraction attributed to depth-0 named
        spans (disjoint in the serial loop; nested spans are left out so
        nothing counts twice)."""
        wall = self._wall_s
        if wall is None:
            wall = time.perf_counter() - self._t0
        with self._lock:
            attributed = sum(self._top_totals.values())
        return {
            "wall_s": round(wall, 6),
            "attributed_s": round(attributed, 6),
            "coverage": round(attributed / wall, 4) if wall > 0 else 0.0,
        }

    def dump(self) -> Optional[str]:
        if not self.trace_dir:
            return None
        doc = self.summary()
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
        return path


class NullTracer(Tracer):
    """No-op tracer (no dir, no profiler, no event mirroring): ``span``
    returns one preallocated no-op context manager."""

    def __init__(self):
        super().__init__(trace_dir=None, device_trace=False)

    def span(self, name: str, trial=None):
        return _NULL_SPAN

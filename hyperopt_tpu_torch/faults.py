"""Deterministic, seeded fault injection.

Counterpart of ``hyperopt_tpu/faults.py``: a process-global registry of
named **fault points**.  Code calls :func:`maybe_fail` at each point; when
a schedule is armed for that point the call raises
:class:`~hyperopt_tpu_torch.exceptions.InjectedFault`, otherwise it
returns after one module-global boolean check.

The port instruments ``objective.call`` (the top of ``Domain.evaluate``),
``pipeline.dispatch`` (before each dispatch of the pipelined loop),
``flight.dump`` (inside a flight-recorder dump), and ``store.write`` and
``worker.evaluate`` (the file store, ``parallel/filestore.py``);
:data:`FAULT_POINTS` keeps the JAX package's whole catalog, whose other
points belong to slices not ported yet.

Configuration::

    from hyperopt_tpu_torch import faults
    faults.configure({"objective.call": {"prob": 0.5, "times": 3}}, seed=7)
    ...
    faults.clear()

    with faults.injected("objective.call", prob=1.0, times=2, seed=0):
        ...   # scoped: the previous schedule comes back on exit

``configure`` also takes the string form
``"point=prob[:times][@after],..."``.  Per point: fire with probability
``prob`` per call, at most ``times`` injections (default unlimited), after
skipping the first ``after`` calls.  Each point draws from its own
``random.Random`` seeded by ``seed`` and the point's name, so one point's
calls never perturb another's schedule and a seed replays the same faults
as the JAX package does.  A ``PoolTrials`` child is forked and inherits
the armed schedules in memory (each child its own copy of the tallies).
The JAX package also arms schedules from its environment, for its
separately launched file and network workers; the port's file worker
takes the spec as an argument (``FileWorker(faults=)``, ``--faults``).

Every injection increments ``faults.injected`` and
``faults.injected.<point>`` in :mod:`~hyperopt_tpu_torch.obs.metrics` and
emits a ``fault_injected`` event.
"""

from __future__ import annotations

import threading
import zlib

from .exceptions import InjectedFault
from .obs import events as _events
from .obs import metrics as _metrics

__all__ = [
    "FAULT_POINTS",
    "maybe_fail",
    "configure",
    "clear",
    "is_active",
    "injected",
    "injection_counts",
]

#: Advisory catalog of the JAX package's fault points.  ``configure``
#: accepts unknown names (a library user may instrument their own code).
FAULT_POINTS = frozenset(
    {
        "rpc.send",
        "rpc.recv",
        "rpc.connect",
        "store.write",
        "worker.evaluate",
        "objective.call",
        "pipeline.dispatch",
        "wal.write",
        "wal.fsync",
        "wal.replay",
        "flight.dump",
        "replica.ship",
        "router.forward",
    }
)


class _Point:
    """One armed fault point: seeded RNG + probability/schedule + tallies."""

    __slots__ = ("name", "prob", "times", "after", "calls", "fired", "_rng")

    def __init__(self, name, prob, times=None, after=0, seed=0):
        import random

        if not 0.0 <= float(prob) <= 1.0:
            raise ValueError(f"fault prob for {name!r} must be in [0,1], "
                             f"got {prob}")
        self.name = name
        self.prob = float(prob)
        self.times = None if times is None else int(times)
        self.after = int(after)
        self.calls = 0
        self.fired = 0
        # Per-point stream: the seed is mixed with a stable hash of the
        # name so schedules replay exactly regardless of which other
        # points are armed or how often they are hit.
        self._rng = random.Random(
            (int(seed) << 32) ^ zlib.crc32(name.encode()))

    def should_fire(self) -> bool:
        self.calls += 1
        if self.calls <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self._rng.random() >= self.prob:
            return False
        self.fired += 1
        return True


_lock = threading.Lock()
_points: dict = {}
_active = False          # fast-path gate: False ⇒ maybe_fail is a no-op


def maybe_fail(point: str, **ctx) -> None:
    """Raise :class:`InjectedFault` if a schedule armed for ``point`` fires.

    ``ctx`` (e.g. ``verb=``, ``tid=``) is attached to the telemetry event,
    never inspected for the firing decision — determinism depends only on
    the per-point call count and seeded RNG stream.
    """
    if not _active:
        return
    with _lock:
        p = _points.get(point)
        if p is None or not p.should_fire():
            return
        call_no = p.calls
    _metrics.registry().counter("faults.injected").inc()
    _metrics.registry().counter(f"faults.injected.{point}").inc()
    # Callers pass the trial id as ``tid=``; the event schema's trial key
    # is ``trial`` — normalize so fault events attach to trial lanes in
    # merged traces (obs/events.events_to_chrome anchors on "trial").
    tid = ctx.pop("tid", None)
    if tid is not None and "trial" not in ctx:
        ctx["trial"] = tid
    _events.EVENTS.emit("fault_injected", name=point, call_no=call_no, **ctx)
    raise InjectedFault(point, call_no=call_no)


def configure(spec, seed: int = 0) -> None:
    """Arm fault points from ``spec`` (replaces any previous schedule).

    ``spec`` is either the string form or a dict
    ``{point: {"prob": p[, "times": n][, "after": k]}}`` (a bare float is
    shorthand for ``{"prob": p}``).  An empty spec disarms everything.
    """
    global _active
    if isinstance(spec, str):
        spec = _parse(spec)
    new = {}
    for name, cfg in (spec or {}).items():
        if isinstance(cfg, (int, float)):
            cfg = {"prob": cfg}
        new[name] = _Point(name, seed=seed, **cfg)
    with _lock:
        _points.clear()
        _points.update(new)
        _active = bool(new)


def clear() -> None:
    """Disarm every fault point and reset tallies."""
    global _active
    with _lock:
        _points.clear()
        _active = False


def is_active() -> bool:
    """True when at least one fault point is armed."""
    return _active


def injection_counts() -> dict:
    """``{point: {"calls": n, "fired": m}}`` for every armed point."""
    with _lock:
        return {name: {"calls": p.calls, "fired": p.fired}
                for name, p in _points.items()}


class injected:
    """Context manager arming a single point for a ``with`` block.

    Restores the previously armed schedule (if any) on exit, so chaos
    tests can nest/scope without clobbering each other.
    """

    def __init__(self, point, prob=1.0, times=None, after=0, seed=0):
        self._spec = {point: {"prob": prob, "times": times, "after": after}}
        self._seed = seed
        self._saved = None

    def __enter__(self):
        with _lock:
            self._saved = dict(_points)
        configure(self._spec, seed=self._seed)
        return self

    def __exit__(self, *exc):
        global _active
        with _lock:
            _points.clear()
            _points.update(self._saved)
            _active = bool(_points)
        return False


def _parse(raw: str) -> dict:
    """Parse ``"point=prob[:times][@after],..."`` into a spec dict."""
    spec = {}
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        try:
            name, rhs = item.split("=", 1)
            after = 0
            if "@" in rhs:
                rhs, after_s = rhs.rsplit("@", 1)
                after = int(after_s)
            times = None
            if ":" in rhs:
                rhs, times_s = rhs.split(":", 1)
                times = int(times_s)
            spec[name.strip()] = {"prob": float(rhs), "times": times,
                                  "after": after}
        except (ValueError, TypeError) as e:
            raise ValueError(
                f"bad fault spec entry {item!r} "
                "(want point=prob[:times][@after])") from e
    return spec

"""Flight recorder: a black box with freeze-and-dump triggers.

Counterpart of ``hyperopt_tpu/obs/flight.py``.  :func:`install` arms a
dump directory, and a trigger freezes the current telemetry into a
postmortem bundle (``obs/bundle.py``):

* an unhandled exception escaping ``fmin`` (:func:`on_crash`),
* SIGTERM (the handler chains to the one installed before it),
* an explicit :func:`dump` (``force=True`` bypasses the rate limit),
* :func:`on_slo_fired`, called by the SLO monitor (``obs/slo.py``).

The directory and the rate limit (``min_interval_s``, default 30 s) are
:func:`install`'s arguments; suppressed dumps bump ``flight.suppressed``.
Each dump bumps ``flight.dumps``, emits a ``flight_dump`` event and passes
the ``flight.dump`` fault point.

Disarmed (the default) every trigger hook is one module-global boolean
check.
"""

from __future__ import annotations

import os
import signal
import threading
import time

from . import bundle as _bundle
from . import context as _context
from . import metrics as _metrics
from .events import EVENTS

__all__ = [
    "armed",
    "dump",
    "install",
    "on_crash",
    "on_slo_fired",
    "uninstall",
]

DEFAULT_MIN_INTERVAL_S = 30.0

#: Module-global fast path: every trigger hook starts with ``if not _armed``.
_armed = False

_LOCK = threading.Lock()
_STATE = {
    "dir": None,
    "min_interval_s": DEFAULT_MIN_INTERVAL_S,
    "last_mono": None,    # monotonic time of the last successful dump
    "seq": 0,             # per-process dump counter (directory naming)
    "prev_sigterm": None,
    "sigterm_installed": False,
}


def armed() -> bool:
    return _armed


def install(dump_dir: str | None = None, *, sigterm: bool = True,
            min_interval_s: float | None = None,
            arm_events: bool = True) -> str | None:
    """Arm the recorder to dump into ``dump_dir``; a no-op returning None
    when it is None (so callers can install unconditionally).

    ``arm_events=True`` enables the event ring if nothing else (a
    Tracer, a test) has — the black box records even in untraced
    processes.  ``sigterm=True`` chains a dump into the process's
    SIGTERM handling (best-effort: only possible from the main thread).
    Idempotent; re-installing updates the directory.
    """
    global _armed
    if not dump_dir:
        return None
    os.makedirs(dump_dir, exist_ok=True)
    with _LOCK:
        _STATE["dir"] = dump_dir
        _STATE["min_interval_s"] = (
            DEFAULT_MIN_INTERVAL_S if min_interval_s is None
            else float(min_interval_s))
    if arm_events and not EVENTS.enabled:
        EVENTS.enable()
    if arm_events and not _context.armed():
        # Adopt incoming trace contexts too: a postmortem bundle of an
        # untraced process still attributes its events to the trace id
        # of the caller it served.
        _context.enable()
    if sigterm:
        _install_sigterm()
    _armed = True
    _metrics.registry().gauge("flight.armed").set(1.0)
    return dump_dir


def uninstall() -> None:
    """Disarm and restore any chained SIGTERM handler (tests)."""
    global _armed
    _armed = False
    _metrics.registry().gauge("flight.armed").set(0.0)
    with _LOCK:
        _STATE["dir"] = None
        _STATE["last_mono"] = None
        prev = _STATE["prev_sigterm"]
        installed = _STATE["sigterm_installed"]
        _STATE["prev_sigterm"] = None
        _STATE["sigterm_installed"] = False
    if installed:
        try:
            signal.signal(signal.SIGTERM,
                          prev if prev is not None else signal.SIG_DFL)
        except ValueError:    # non-main thread
            pass


def _install_sigterm() -> None:
    with _LOCK:
        if _STATE["sigterm_installed"]:
            return
    try:
        prev = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:        # not the main thread — skip, stay armed
        return
    with _LOCK:
        _STATE["prev_sigterm"] = prev
        _STATE["sigterm_installed"] = True


def _on_sigterm(signum, frame):
    dump("sigterm")
    prev = _STATE["prev_sigterm"]
    if callable(prev):
        prev(signum, frame)
    elif prev == signal.SIG_DFL:
        raise SystemExit(128 + int(signum))
    # SIG_IGN / None: swallow, matching the pre-install behavior.


def dump(reason: str, *, force: bool = False, extra: dict | None = None):
    """Freeze-and-dump one bundle; returns its directory path.

    Automatic triggers pass ``force=False`` and are rate-limited to one
    dump per ``min_interval_s`` (suppressions return None and bump
    ``flight.suppressed``).  Never raises: a failed dump is counted
    (``flight.errors``) and swallowed — the recorder must not turn a
    crash into a different crash.
    """
    if not _armed:
        return None
    reg = _metrics.registry()
    now = time.monotonic()
    with _LOCK:
        out_dir = _STATE["dir"]
        if out_dir is None:
            return None
        last = _STATE["last_mono"]
        if not force and last is not None and \
                (now - last) < _STATE["min_interval_s"]:
            suppressed = True
        else:
            suppressed = False
            _STATE["last_mono"] = now
            _STATE["seq"] += 1
            seq = _STATE["seq"]
    if suppressed:
        reg.counter("flight.suppressed").inc()
        return None
    try:
        from .. import faults as _faults
        _faults.maybe_fail("flight.dump", reason=reason)
        slug = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)[:40] or "dump"
        path = os.path.join(out_dir,
                            f"bundle-{os.getpid()}-{seq:03d}-{slug}")
        EVENTS.emit("flight_dump", name=reason, path=path)
        _bundle.write_bundle(path, reason, extra=extra)
        reg.counter("flight.dumps").inc()
        return path
    except Exception:
        reg.counter("flight.errors").inc()
        return None


def on_slo_fired(name: str, **fields) -> None:
    """Trigger hook for an SLO monitor's firing transition."""
    if not _armed:
        return
    dump(f"slo-{name}", extra={"trigger": "slo_alert", "slo": name,
                               **fields})


def on_crash(site: str, exc: BaseException) -> None:
    """Trigger hook for unhandled exceptions escaping ``fmin``.
    ``KeyboardInterrupt`` and generator/system exits are operator intent,
    not crashes."""
    if not _armed:
        return
    if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit)):
        return
    dump(f"crash-{site}",
         extra={"trigger": "crash", "site": site,
                "error": f"{type(exc).__name__}: {exc}"})

"""Cross-process trace context: one trial, followed across processes.

Counterpart of ``hyperopt_tpu/obs/context.py``, unchanged: a run-scoped
``trace_id`` (16 hex chars, minted by the driver), the emitting side's
``span`` and the ``tid`` of the trial the work belongs to, bound
thread-locally.  While a context is bound, :meth:`EventLog.emit` attaches
``trace_id`` and ``trial`` to every event.  The wire form
(``"<trace_id>/<span>/<tid>"``, stamped into ``doc["misc"]["trace"]`` by
:func:`stamp_misc`) is the one the JAX package reads; the pool's children,
the file store's workers (:func:`bind_doc`) and the network store's
clients and server (:func:`wire_current`, :func:`adopt`) carry it across
processes.

Disarmed by default: every entry point returns after one module-global
boolean check.  A :class:`~.trace.Tracer` with a ``trace_dir`` arms it for
its run.
"""

from __future__ import annotations

import threading
import uuid

__all__ = [
    "armed",
    "enable",
    "disable",
    "new_trace_id",
    "current",
    "bind",
    "bind_doc",
    "adopt",
    "to_wire",
    "from_wire",
    "wire_current",
    "stamp_misc",
    "from_misc",
]

#: Module-global fast-path gate: False ⇒ every entry point is a no-op
#: after one boolean check.
_armed = False

_tls = threading.local()


def armed() -> bool:
    return _armed


def enable() -> None:
    global _armed
    _armed = True


def disable() -> None:
    global _armed
    _armed = False


def new_trace_id() -> str:
    """Mint a run-scoped trace id (16 hex chars; the driver calls this)."""
    return uuid.uuid4().hex[:16]


def current() -> dict | None:
    """The calling thread's bound context, or None (also None when disarmed)."""
    if not _armed:
        return None
    return getattr(_tls, "ctx", None)


class _NullBind:
    """Shared no-op context manager for the disarmed path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullBind()


class _Bind:
    """Swap the thread-local context in/out (restores the previous one)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: dict):
        self._ctx = ctx
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


def bind(trace_id=None, span=None, tid=None):
    """Context manager binding (and layering over) the thread's context.

    Fields left None inherit from the currently bound context; a no-op
    shared manager is returned when the subsystem is disarmed.
    """
    if not _armed:
        return _NULL
    ctx = dict(getattr(_tls, "ctx", None) or {})
    if trace_id is not None:
        ctx["trace_id"] = trace_id
    if span is not None:
        ctx["span"] = span
    if tid is not None:
        ctx["tid"] = tid
    return _Bind(ctx)


def bind_doc(doc):
    """Bind the context a trial document carries (worker side).

    Reads ``doc["misc"]["trace"]`` (stamped by the driver at insert) and
    falls back to the doc's own tid, so worker events attach to the
    originating trial even for docs inserted by an untraced driver.
    """
    if not _armed:
        return _NULL
    ctx = from_misc(doc.get("misc") or {}) or {}
    if ctx.get("tid") is None and doc.get("tid") is not None:
        ctx["tid"] = doc["tid"]
    return _Bind(ctx)


def adopt(wire):
    """Bind a context received off the wire (server side); no-op on junk."""
    if not _armed or not wire:
        return _NULL
    ctx = from_wire(wire)
    if not ctx:
        return _NULL
    return _Bind(ctx)


def to_wire(ctx: dict) -> str:
    """``{trace_id, span, tid}`` → ``"<trace_id>/<span>/<tid>"``."""
    span = ctx.get("span")
    tid = ctx.get("tid")
    return "%s/%s/%s" % (ctx.get("trace_id") or "",
                         "" if span is None else span,
                         "" if tid is None else tid)


def from_wire(wire) -> dict | None:
    """Inverse of :func:`to_wire`; None for malformed/empty strings."""
    if not wire:
        return None
    try:
        t, s, d = str(wire).split("/")
    except ValueError:
        return None
    ctx: dict = {}
    if t:
        ctx["trace_id"] = t
    for key, raw in (("span", s), ("tid", d)):
        if raw:
            try:
                ctx[key] = int(raw)
            except ValueError:
                pass
    return ctx or None


def wire_current() -> str | None:
    """The bound context as a wire string, or None (fast when disarmed)."""
    if not _armed:
        return None
    ctx = getattr(_tls, "ctx", None)
    if not ctx:
        return None
    return to_wire(ctx)


def stamp_misc(misc: dict, tid=None, trace_id=None) -> None:
    """Write the wire context into a trial doc's ``misc["trace"]``.

    Explicit ``tid``/``trace_id`` override the ambient context (the
    driver stamps each doc with its own tid).  No-op when disarmed —
    untraced runs produce byte-identical documents.
    """
    if not _armed:
        return
    ctx = dict(getattr(_tls, "ctx", None) or {})
    if trace_id is not None:
        ctx["trace_id"] = trace_id
    if tid is not None:
        ctx["tid"] = tid
    if ctx:
        misc["trace"] = to_wire(ctx)


def from_misc(misc) -> dict | None:
    """Parse a doc's ``misc["trace"]`` stamp; None if absent/malformed."""
    if not isinstance(misc, dict):
        return None
    return from_wire(misc.get("trace"))

"""What the benchmark reads of the program's own spans and setup counters
(``hyperopt_tpu_torch.obs.trace``'s span store, the registry counters
``tpe.kernel_build_ms`` and ``tpe.cold_step_ms``), for the per-layer
metrics.

The span store records only while a profiler session records; in a
``--trace 1`` run that is the traced segment alone, after the window, so
its summary holds exactly the segment's work.  A program without the
store or the counters reads as None here, and so does every metric that
reads them.
"""

from __future__ import annotations

from hyperopt_tpu_torch.obs import metrics as _metrics
from hyperopt_tpu_torch.obs import trace as _trace


def summary():
    """``{name: {"count", "total_ns", "self_ns", ...}}`` of the program's
    span store, or None when the program has none."""
    read = getattr(_trace, "span_summary", None)
    return None if read is None else read()


def counter(name):
    """The registry counter ``name`` now, or None when the program never
    made it."""
    return _metrics.registry().snapshot()["counters"].get(name)


def per(run, name, field, per_name):
    """Milliseconds of ``field`` (``"total"`` or ``"self"``) of the spans
    ``name`` (a name or a tuple of names) in the traced segment, per span
    ``per_name``; None without a traced segment, without the store, or
    when a name has no span there."""
    if run.traced is None:
        return None
    spans = summary()
    if not spans:
        return None
    names = (name,) if isinstance(name, str) else tuple(name)
    if per_name not in spans or not spans[per_name]["count"] \
            or any(n not in spans for n in names):
        return None
    ns = sum(spans[n][field + "_ns"] for n in names)
    return ns * 1e-6 / spans[per_name]["count"]


def seconds(name):
    """A millisecond counter's process total in seconds, or None."""
    ms = counter(name)
    return None if ms is None else ms * 1e-3

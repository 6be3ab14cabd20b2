"""Observability: structured events, metrics, loop tracing, health,
postmortem bundles and device-mode telemetry.

Counterpart of ``hyperopt_tpu/obs/``, with the same modules, names and
public functions; every switch the JAX package reads from its environment
is a setter or an argument here:

* :mod:`~.events`: the process-global event log ``EVENTS`` (a bounded
  ring; its capacity is ``EventLog``'s argument), exported as JSONL and as
  Chrome ``trace_event`` JSON;
* :mod:`~.metrics`: the process-global registry (``metrics.set_enabled``)
  and the always-on kernel-cache counters;
* :mod:`~.trace`: the per-run :class:`Tracer` behind ``fmin(trace_dir=)``,
  which arms the event log and drives ``torch.profiler``;
* :mod:`~.context`: the trace context carried across processes;
* :mod:`~.costs` (``costs.arm()``), :mod:`~.health`, :mod:`~.bundle`,
  :mod:`~.flight` (``flight.install(dump_dir)``), :mod:`~.device` and
  :mod:`~.devtel` (``devtel.set_enabled``): the cost ledger, health
  verdicts, postmortem bundles, the flight recorder, device memory and
  the device-mode telemetry slab;
* :mod:`~.timeseries`, :mod:`~.slo` and :mod:`~.export`: the windowed
  store over the registry (``TimeSeriesStore``, which
  ``devtel.set_backfill_store`` scrapes at every device-mode boundary),
  SLO burn-rate alerting and the OpenMetrics text exposition.

Everything here is host-side bookkeeping; the only work on the card is
device mode's two per-trial stores of the slab (``device._Segment``).
"""

from __future__ import annotations

from . import bundle  # noqa: F401
from . import context  # noqa: F401
from . import costs  # noqa: F401
from . import export  # noqa: F401
from . import flight  # noqa: F401
from . import slo  # noqa: F401
from . import timeseries  # noqa: F401
from .events import EVENTS, EventLog, events_to_chrome  # noqa: F401
from .metrics import (  # noqa: F401
    LabelLru,
    MetricsRegistry,
    kernel_cache_event,
    kernel_cache_stats,
    merge_histogram_states,
    merge_snapshots,
    metrics_enabled,
    registry,
    summarize_state,
)
from .trace import NullTracer, Tracer  # noqa: F401

"""Compatibility names: tracing lives in :mod:`hyperopt_tpu_torch.obs`.

Counterpart of ``hyperopt_tpu/utils/tracing.py``: :class:`Tracer`,
:class:`NullTracer`, :func:`kernel_cache_event` and
:func:`kernel_cache_stats`, re-exported unchanged; new code imports them
from ``hyperopt_tpu_torch.obs``.
"""

from __future__ import annotations

from ..obs.metrics import kernel_cache_event, kernel_cache_stats  # noqa: F401
from ..obs.trace import NullTracer, Tracer  # noqa: F401

__all__ = ["Tracer", "NullTracer", "kernel_cache_event", "kernel_cache_stats"]

"""What a driver's measured window hands the harness and the metrics."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Window:
    """One measured window.

    ``trials``: trials finished and recorded in ``elapsed_s``;
    ``attempted``/``failed``: trials begun and those that raised or were
    refused; ``latencies_ms``: one per proposal, from the call until the
    proposed row is on the host; ``suggest_ms``: their sum; ``counters``:
    the registry counters' growth over the window."""

    elapsed_s: float = 0.0
    trials: int = 0
    attempted: int = 0
    failed: int = 0
    latencies_ms: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)

    @property
    def suggests(self):
        return len(self.latencies_ms)

    @property
    def suggest_ms(self):
        return float(sum(self.latencies_ms))


@dataclass
class Traced:
    """The traced segment: the profiler's reduction (``trace.Segment.
    reduce``) and the work done in it: the proposals made, ``steps``, and
    the K1 bound of the TPE steps among them, ``k1_bound_s``."""

    reduced: dict
    steps: int = 0
    k1_bound_s: float = 0.0

"""Host-clock arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math
import os
import time


def percentile(samples, q):
    """The ``q``-th percentile (0-100) of every sample, linear between the
    two nearest ranks (numpy's default)."""
    xs = sorted(samples)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def since_process_start():
    """Seconds since this process started: its start time in ``/proc``
    (clock ticks since boot, Linux) against the boot-time clock now."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started

"""Median latency of a proposal over every proposal of the window: from
the call into the suggest entry until the proposed row is on the host."""

from portbench.timing import percentile


def read(run):
    return percentile(run.window.latencies_ms, 50) \
        if run.window.latencies_ms else None

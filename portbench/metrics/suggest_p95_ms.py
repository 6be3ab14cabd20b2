"""95th percentile of the proposal latencies: all of the window's
proposals, not medians of chunks."""

from portbench.timing import percentile


def read(run):
    return percentile(run.window.latencies_ms, 95) \
        if run.window.latencies_ms else None

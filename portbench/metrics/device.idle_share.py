"""The share of the traced segment's wall time in which no device operation
ran (one minus the union of their intervals over the segment)."""


def read(run):
    t = run.traced
    if t is None or not t.reduced["window_s"]:
        return None
    return 1.0 - t.reduced["busy_s"] / t.reduced["window_s"]

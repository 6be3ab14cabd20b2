"""Host milliseconds to enqueue one TPE step: the registry counter
``suggest.dispatch_ms``'s growth over the window, per proposal."""


def read(run):
    w = run.window
    if not w.suggests:
        return None
    return w.counters["suggest.dispatch_ms"] / w.suggests

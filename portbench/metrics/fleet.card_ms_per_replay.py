"""The card's busy time (the union of the device operations' intervals)
per replay of the fleet's step, in the traced segment."""


def read(run):
    t = run.traced
    if t is None or not t.steps:
        return None
    return t.reduced["busy_s"] * 1e3 / t.steps

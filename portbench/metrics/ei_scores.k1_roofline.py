"""K1's share of its roofline in the traced segment: the least time of
every K1 launch made there (``peaks.k1_bound_s``, from the live terms of
each step's history by the reference's split) over K1's device time."""


def read(run):
    t = run.traced
    if t is None or not t.reduced["k1_launches"] or not t.k1_bound_s:
        return None
    return 100.0 * t.k1_bound_s / t.reduced["k1_s"]

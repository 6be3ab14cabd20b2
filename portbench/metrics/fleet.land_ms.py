"""Time of the program's `fleet.land` span (every lane's rows landed into
its Trials) per replay, that is per landed row of each lane, in the
traced segment."""

from portbench import spans


def read(run):
    t = run.traced
    summary = spans.summary() if t is not None and t.steps else None
    if not summary or "fleet.land" not in summary:
        return None
    return summary["fleet.land"]["total_ns"] * 1e-6 / t.steps

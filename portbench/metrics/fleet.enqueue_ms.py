"""Time of the program's `fleet.run` span (the lanes' trial seeds drawn
and the segment's replays enqueued by the host) per replay, in the
traced segment."""

from portbench import spans


def read(run):
    t = run.traced
    summary = spans.summary() if t is not None and t.steps else None
    if not summary or "fleet.run" not in summary:
        return None
    return summary["fleet.run"]["total_ns"] * 1e-6 / t.steps

"""Time of the program's `fleet.fetch` span (the segment's one fetch of
every lane: the wait for the card and the copy) per replay, in the
traced segment."""

from portbench import spans


def read(run):
    t = run.traced
    summary = spans.summary() if t is not None and t.steps else None
    if not summary or "fleet.fetch" not in summary:
        return None
    return summary["fleet.fetch"]["total_ns"] * 1e-6 / t.steps

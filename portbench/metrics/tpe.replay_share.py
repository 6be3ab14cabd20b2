"""The share of TPE steps that replayed their kernel's CUDA graph: the
count of the program's `tpe.step.replay` spans over the count of its
`tpe.step` spans, in the traced segment.  0 when no step replayed on a
program that has hosted graphs (it makes the counter
`tpe.graph.replays`); None on a program without them."""

from portbench import spans


def read(run):
    if run.traced is None:
        return None
    summary = spans.summary()
    steps = (summary or {}).get("tpe.step", {}).get("count")
    if not steps:
        return None
    if "tpe.step.replay" not in summary:
        return None if spans.counter("tpe.graph.replays") is None else 0.0
    return summary["tpe.step.replay"]["count"] / steps

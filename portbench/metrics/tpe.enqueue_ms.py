"""Time of the program's `tpe.step` span (the host enqueueing one TPE
step: draw, split, the column groups, the pick) per TPE step, in the
traced segment."""

from portbench import spans


def read(run):
    return spans.per(run, "tpe.step", "total", "tpe.step")

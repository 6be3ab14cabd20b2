"""Time of the program's `tpe.fetch` span (the wait for the proposed
rows to reach the host) per TPE step, in the traced segment."""

from portbench import spans


def read(run):
    return spans.per(run, "tpe.fetch", "total", "tpe.step")

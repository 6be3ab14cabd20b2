"""Time of the program's `tpe.feed` span (the resident ring fed with the
new rows, and its pad-copy to the next bucket) per TPE step (count of
`tpe.step`), in the traced segment."""

from portbench import spans


def read(run):
    return spans.per(run, "tpe.feed", "total", "tpe.step")

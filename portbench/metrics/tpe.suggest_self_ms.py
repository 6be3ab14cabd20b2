"""Self time of the program's `tpe.suggest` span (what none of its
named parts covers) per proposal, in the traced segment."""

from portbench import spans


def read(run):
    return spans.per(run, "tpe.suggest", "self", "tpe.suggest")

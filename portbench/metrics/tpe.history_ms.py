"""Self time of the program's `tpe.history` span (reading the history
and the in-flight rows from the trial documents) per proposal (count of
`tpe.suggest`), in the traced segment."""

from portbench import spans


def read(run):
    return spans.per(run, "tpe.history", "self", "tpe.suggest")

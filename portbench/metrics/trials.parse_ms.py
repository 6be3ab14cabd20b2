"""Time of the program's `trials.parse` span (`Trials.history` parsing the
trial documents past its cached prefix: a resumed study's whole history
on its first proposal, the last finished trial after that) per proposal
(count of `tpe.suggest`), in the traced segment."""

from portbench import spans


def read(run):
    return spans.per(run, "trials.parse", "total", "tpe.suggest")

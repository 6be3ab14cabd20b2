"""Self time of the program's loop spans `suggest`, `store` and `save`
(the loop's own bookkeeping around the algorithm, the store's insert and
the save) per trial (count of `evaluate`), in the traced segment."""

from portbench import spans


def read(run):
    return spans.per(run, ("suggest", "store", "save"), "self", "evaluate")

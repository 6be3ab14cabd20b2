"""Seconds the process spent enqueueing each TPE kernel's first step
(less any EI library build it set off): the program's counter
`tpe.cold_step_ms`."""

from portbench import spans


def read(run):
    return spans.seconds("tpe.cold_step_ms")

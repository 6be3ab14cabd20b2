"""Seconds the process spent warming up and capturing device mode's and
the fleet's CUDA graphs of the TPE step: the program's counter
`device.capture_ms`."""

from portbench import spans


def read(run):
    return spans.seconds("device.capture_ms")

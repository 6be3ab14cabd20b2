"""Seconds the process spent warming up and capturing the hosted TPE
step's CUDA graphs (one per history bucket): the program's counter
`tpe.graph.capture_ms`."""

from portbench import spans


def read(run):
    return spans.seconds("tpe.graph.capture_ms")

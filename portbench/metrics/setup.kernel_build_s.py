"""Seconds the process spent building TPE kernels (every bucket's, on
the suggest path and on the prewarm thread) and building or loading the
EI library: the program's counter `tpe.kernel_build_ms`."""

from portbench import spans


def read(run):
    return spans.seconds("tpe.kernel_build_ms")

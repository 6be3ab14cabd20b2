"""CUDA kernels per replay of the fleet's step in the traced segment (the
profiler's kernel count over the replays made in it)."""


def read(run):
    t = run.traced
    if t is None or not t.steps:
        return None
    return t.reduced["kernels"] / t.steps

"""Process start to the first timed call: imports, the CUDA context, the
kernels' build or load, the seeded studies and the warm-up."""


def read(run):
    return run.setup_s

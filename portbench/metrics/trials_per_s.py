"""Trials finished (evaluated and recorded) over the window's whole elapsed
time."""


def read(run):
    w = run.window
    return w.trials / w.elapsed_s if w.elapsed_s > 0 else None

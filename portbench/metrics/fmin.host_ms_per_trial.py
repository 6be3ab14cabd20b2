"""The loop's own host time: window time per trial spent outside the timed
suggest call (the objective, the Trials bookkeeping, a study's resume)."""


def read(run):
    w = run.window
    if run.cell.traffic["driver"] != "hosted" or not w.trials:
        return None
    return (w.elapsed_s * 1e3 - w.suggest_ms) / w.trials

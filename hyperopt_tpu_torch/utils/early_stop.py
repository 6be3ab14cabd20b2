"""Early-stopping policies for ``fmin(early_stop_fn=...)``.

Counterpart of ``hyperopt_tpu/utils/early_stop.py``.
An early-stop fn has signature ``fn(trials, *args) -> (stop: bool, args)``;
the returned args are threaded into the next call.
"""

from __future__ import annotations

import numpy as np


def no_progress_loss(iteration_stop_count=20, percent_increase=0.0):
    """Stop when the best loss hasn't improved by more than
    ``percent_increase`` percent for ``iteration_stop_count`` iterations."""

    def stop_fn(trials, best_loss=None, iteration_no_progress=0):
        losses = [l for l, s in zip(trials.losses(), trials.statuses())
                  if s == "ok" and l is not None and np.isfinite(l)]
        if not losses:
            return False, [best_loss, iteration_no_progress]
        new_loss = min(losses)
        if best_loss is None:
            return False, [new_loss, 0]
        if percent_increase > 0:
            improved = new_loss < best_loss - abs(best_loss) * \
                (percent_increase / 100.0)
        else:
            improved = new_loss < best_loss
        if improved:
            return False, [new_loss, 0]
        iteration_no_progress += 1
        return (iteration_no_progress >= iteration_stop_count,
                [min(new_loss, best_loss), iteration_no_progress])

    return stop_fn

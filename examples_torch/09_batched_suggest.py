"""Batched suggestion: K proposals per device dispatch with constant-liar
fantasies.

``fmin(max_queue_len=K)`` with TPE proposes the K-proposal batch in one
dispatch (``tpe._TpeKernel._liar_scan``): each step proposes an
EI-argmax point, inserts it into the history with a fantasy loss (the mean
of observed losses), and refits before the next step.  The fantasies keep
the batch *diverse* — K independent draws from one frozen posterior would
all pile onto the same EI peak — while the whole chain still costs a
single copy back to the host.

Why you'd use it:

* **Host-bound loops**: one dispatch + one fetch per K trials instead of
  per trial.
* **Parallel evaluation**: a worker pool (example 03) or async store
  (example 05) wants K distinct configs at once; the liar gives each
  worker a genuinely different point to try.

Run: python3 examples_torch/09_batched_suggest.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

# Run from a checkout: the package sits beside this directory.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hyperopt_tpu_torch as ho
from hyperopt_tpu_torch import hp

p = argparse.ArgumentParser(description="constant-liar batches of 8")
p.add_argument("--device", default=None,
               help="where the suggest runs (default: the CUDA card)")
args = p.parse_args()


def objective(cfg):
    x, y = cfg["x"], cfg["y"]
    return (x - 2.0) ** 2 + (y + 1.0) ** 2


space = {"x": hp.uniform("x", -5, 5), "y": hp.uniform("y", -5, 5)}

# Sequential baseline: one proposal, one posterior refit per trial.
seq = ho.Trials()
ho.fmin(objective, space, algo=ho.tpe.suggest, max_evals=48, trials=seq,
        rstate=np.random.default_rng(0), show_progressbar=False,
        device=args.device)

# Batched: 8 proposals per dispatch; the posterior refits on fantasies
# within the batch and on real results between batches.
bat = ho.Trials()
ho.fmin(objective, space, algo=ho.tpe.suggest, max_evals=48, trials=bat,
        max_queue_len=8, rstate=np.random.default_rng(0),
        show_progressbar=False, device=args.device)

print(f"sequential best loss: {seq.best_trial['result']['loss']:.5f} "
      f"({len(seq)} trials, {len(seq)} suggest dispatches)")
print(f"batched    best loss: {bat.best_trial['result']['loss']:.5f} "
      f"({len(bat)} trials, ~{len(bat) // 8} suggest dispatches)")

# Each post-startup batch spans the space instead of collapsing onto one
# EI peak — inspect the spread of one batch:
xs = [d["misc"]["vals"]["x"][0] for d in bat.trials[24:32]]
print(f"one batch's x proposals: {np.round(sorted(xs), 2)}")

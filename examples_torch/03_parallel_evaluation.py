"""Parallel trial evaluation with real timeouts (the SparkTrials slot).

PoolTrials evaluates up to `parallelism` objectives concurrently; process
execution means an overrunning objective is actually killed at
trial_timeout, and fmin(timeout=...) cancels all in-flight work.  The
children are forked and only run the objective; the suggest stays in this
process, on the card.

Run: python3 examples_torch/03_parallel_evaluation.py [--device cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

# Run from a checkout: the package sits beside this directory.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hyperopt_tpu_torch as ho
from hyperopt_tpu_torch import hp
from hyperopt_tpu_torch.parallel import PoolTrials

p = argparse.ArgumentParser(description="PoolTrials with trial timeouts")
p.add_argument("--device", default=None,
               help="where the suggest runs (default: the CUDA card)")
args = p.parse_args()


def objective(cfg):
    time.sleep(0.1 + 0.2 * np.random.default_rng().random())  # "training"
    if cfg["x"] > 4.5:
        time.sleep(60)  # pathological region: would hang a naive runner
    return (cfg["x"] - 2.0) ** 2


space = {"x": hp.uniform("x", -5, 5)}

trials = PoolTrials(parallelism=4, trial_timeout=2.0, execution="process")
best = ho.fmin(objective, space, algo=ho.tpe.suggest, max_evals=32,
               trials=trials, rstate=np.random.default_rng(0),
               device=args.device)

states = [t["state"] for t in trials]
print("best:", best, "loss:", trials.best_trial["result"]["loss"])
print(f"done: {states.count(ho.JOB_STATE_DONE)}, "
      f"cancelled/error: {states.count(ho.JOB_STATE_ERROR)}")

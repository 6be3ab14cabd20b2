"""Minimize a 2-D function with TPE — the 60-second tour.

Run: python3 examples_torch/01_basics.py [--device cpu]
"""

import argparse
import math
import os
import sys

import numpy as np

# Run from a checkout: the package sits beside this directory.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hyperopt_tpu_torch as ho
from hyperopt_tpu_torch import hp

p = argparse.ArgumentParser(description="TPE on Branin")
p.add_argument("--device", default=None,
               help="where the suggest runs (default: the CUDA card)")
args = p.parse_args()


def branin(p):
    x, y = p["x"], p["y"]
    return ((y - 5.1 / (4 * math.pi ** 2) * x ** 2 + 5 / math.pi * x - 6) ** 2
            + 10 * (1 - 1 / (8 * math.pi)) * math.cos(x) + 10)


space = {"x": hp.uniform("x", -5, 10), "y": hp.uniform("y", 0, 15)}

trials = ho.Trials()
best = ho.fmin(branin, space, algo=ho.tpe.suggest, max_evals=150,
               trials=trials, rstate=np.random.default_rng(0),
               device=args.device)

print("best point:", best)
print("best loss :", trials.best_trial["result"]["loss"])
print("importance:", ho.parameter_importance(trials, space))

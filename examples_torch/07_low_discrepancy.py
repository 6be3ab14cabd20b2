"""Low-discrepancy (quasi-Monte-Carlo) search, standalone and as TPE's
warm-start.

16 random draws in 1-D leave some of 16 equal bins empty with ~63%
probability; 16 scrambled-Sobol draws hit every bin exactly once. The same
evenness in higher dimensions makes the first TPE posterior (fit to the
``n_startup_jobs`` warm-start trials) a better model of the space.

Run: python3 examples_torch/07_low_discrepancy.py [--device cpu]
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
from hyperopt_tpu_torch import hp, qmc

p = argparse.ArgumentParser(description="QMC search and Sobol-started TPE")
p.add_argument("--device", default=None,
               help="where the suggest runs (default: the CUDA card)")
args = p.parse_args()


def branin(p):
    x, y = p["x"], p["y"]
    return ((y - 5.1 / (4 * math.pi ** 2) * x ** 2 + 5 / math.pi * x - 6) ** 2
            + 10 * (1 - 1 / (8 * math.pi)) * math.cos(x) + 10)


space = {"x": hp.uniform("x", -5, 10), "y": hp.uniform("y", 0, 15)}

# 1) Standalone: a deterministic-coverage sweep (engine="halton" also works).
t = ho.Trials()
ho.fmin(branin, space, algo=qmc.suggest, max_evals=64, trials=t,
        rstate=np.random.default_rng(0), device=args.device)
print("qmc sweep best loss:", t.best_trial["result"]["loss"])

# 2) TPE with a Sobol-net warm-start instead of random draws.
t = ho.Trials()
ho.fmin(branin, space, algo=ho.partial(ho.tpe.suggest, startup="qmc"),
        max_evals=100, trials=t, rstate=np.random.default_rng(0),
        device=args.device)
print("tpe+sobol-startup best loss:", t.best_trial["result"]["loss"])

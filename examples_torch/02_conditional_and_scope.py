"""Conditional spaces + scope expressions: a model-selection sweep.

The space picks a model family (each with its own hyperparameters), casts
and transforms values with scope expressions, and the objective receives a
concrete nested config.

Run: python3 examples_torch/02_conditional_and_scope.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

# Run from a checkout: the package sits beside this directory.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hyperopt_tpu_torch as ho
from hyperopt_tpu_torch import hp, scope

p = argparse.ArgumentParser(description="a conditional model-selection sweep")
p.add_argument("--device", default=None,
               help="where the suggest runs (default: the CUDA card)")
args = p.parse_args()

space = {
    "model": hp.choice("model", [
        {"kind": "mlp",
         "n_layers": scope.int(hp.quniform("n_layers", 1, 8, 1)),
         "width": 2 ** scope.int(hp.quniform("log_width", 4, 9, 1)),
         "act": scope.switch(hp.randint("act", 3), "relu", "tanh", "gelu")},
        {"kind": "tree",
         "depth": hp.uniformint("depth", 2, 12),
         "lr": hp.loguniform("lr", -5, 0)},
    ]),
    "batch": 2 ** scope.int(hp.quniform("log_batch", 4, 10, 1)),
}


def objective(cfg):
    m = cfg["model"]
    if m["kind"] == "mlp":
        loss = abs(m["n_layers"] - 3) * 0.3 + abs(m["width"] - 128) / 256 \
            + (0.0 if m["act"] == "gelu" else 0.2)
    else:
        loss = abs(m["depth"] - 6) * 0.1 + abs(np.log(m["lr"]) + 2.5) * 0.2
    return loss + abs(cfg["batch"] - 256) / 1024


trials = ho.Trials()
best = ho.fmin(objective, space, algo=ho.tpe.suggest, max_evals=120,
               trials=trials, rstate=np.random.default_rng(0),
               device=args.device)
print("best assignment:", best)
print("best config    :", ho.space_eval(space, best))
print("best loss      :", trials.best_trial["result"]["loss"])

"""Real-model HPO: tune a random-forest classifier.

A mixed continuous/integer/categorical space over scikit-learn's
RandomForestClassifier, with scope casts feeding the estimator exactly the
types it expects.  Needs scikit-learn.

Run: python3 examples_torch/06_sklearn_hpo.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
from sklearn.datasets import make_classification
from sklearn.ensemble import RandomForestClassifier
from sklearn.model_selection import cross_val_score

# Run from a checkout: the package sits beside this directory.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hyperopt_tpu_torch as ho
from hyperopt_tpu_torch import hp, scope

p = argparse.ArgumentParser(description="tune a random forest")
p.add_argument("--device", default=None,
               help="where the suggest runs (default: the CUDA card)")
args = p.parse_args()

X, y = make_classification(n_samples=400, n_features=20, n_informative=8,
                           random_state=0)

space = {
    "n_estimators": scope.int(hp.quniform("n_estimators", 8, 64, 4)),
    "max_depth": scope.int(hp.quniform("max_depth", 2, 16, 1)),
    "max_features": hp.uniform("max_features", 0.1, 1.0),
    "min_samples_leaf": scope.int(hp.quniform("min_samples_leaf", 1, 8, 1)),
    "criterion": hp.choice("criterion", ["gini", "entropy"]),
}


def objective(cfg):
    clf = RandomForestClassifier(random_state=0, n_jobs=1, **cfg)
    acc = cross_val_score(clf, X, y, cv=3).mean()
    return 1.0 - acc           # minimize error


trials = ho.Trials()
best = ho.fmin(objective, space, algo=ho.tpe.suggest, max_evals=40,
               trials=trials, rstate=np.random.default_rng(0),
               device=args.device)

print("best error:", trials.best_trial["result"]["loss"])
print("best config:", ho.space_eval(space, best))
print("importance :", dict(sorted(
    ho.parameter_importance(trials, space).items(),
    key=lambda kv: -kv[1])))

"""Adaptive TPE: the self-tuning optimizer, and its cross-experiment memory.

``atpe.suggest`` (reference: ``hyperopt/atpe.py``) runs a Thompson-sampling
portfolio over TPE configurations — γ value and schedule, EI candidate
count, prior weight, history forgetting, and per-parameter lockout driven
by online η² importance — so you don't hand-tune TPE's knobs per problem.

Arm statistics persist per space fingerprint in a JSON file, by default
``~/.cache/hyperopt_tpu_torch/atpe_transfer.json``: re-running an
experiment over the same space starts from what earlier runs learned.
``atpe.set_transfer_store(path)`` moves the memory (``--transfer-store``
here), ``atpe.set_transfer_store(None)`` turns it off.

Run: python3 examples_torch/08_adaptive_tpe.py [--device cpu]
"""

import argparse
import json
import os
import sys

import numpy as np

# Run from a checkout: the package sits beside this directory.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hyperopt_tpu_torch as ho
from hyperopt_tpu_torch import atpe, hp
from hyperopt_tpu_torch.space import compile_space
from hyperopt_tpu_torch.utils import parameter_importance

p = argparse.ArgumentParser(description="ATPE and its transfer memory")
p.add_argument("--device", default=None,
               help="where the suggest runs (default: the CUDA card)")
p.add_argument("--transfer-store", default=None,
               help="the transfer memory's JSON file (default: the "
                    "package's, under ~/.cache)")
args = p.parse_args()
if args.transfer_store is not None:
    atpe.set_transfer_store(args.transfer_store)

# A 6-dim problem where only two parameters matter — the regime ATPE's
# importance-driven lockout arms are built for.
space = {
    "lr": hp.loguniform("lr", np.log(1e-4), np.log(1.0)),
    "depth": hp.uniformint("depth", 1, 8),
    **{f"noise{i}": hp.uniform(f"noise{i}", -1, 1) for i in range(4)},
}


def objective(cfg):
    return (np.log(cfg["lr"] / 1e-2) ** 2          # optimum at lr=1e-2
            + (cfg["depth"] - 5) ** 2 * 0.2        # ... and depth=5
            + 0.001 * sum(cfg[f"noise{i}"] for i in range(4)))


t = ho.Trials()
ho.fmin(objective, space, algo=atpe.suggest, max_evals=80, trials=t,
        rstate=np.random.default_rng(0), device=args.device)
print("atpe best loss:", round(t.best_trial["result"]["loss"], 4))

# The bandit state this experiment accumulated (wins/losses per arm):
st = t._atpe_state
print("arm outcomes  wins:", st.wins.round(1), " losses:",
      st.losses.round(1))

# Parameter importance as ATPE saw it (η² of loss across value groups).
# lr ranks top; expect noisy scores for the rest at this budget — η² over
# an adaptively-sampled 80-trial history is an online heuristic (it drives
# the lockout arms), not a final-analysis tool.
for label, score in parameter_importance(t, space).items():
    print(f"  importance[{label}] = {score:.2f}")

# A second experiment on the SAME space is seeded from the first one's arm
# posteriors (capped, so fresh evidence can override) — inspect the store:
if atpe._transfer_path is not None:
    path = os.path.expanduser(atpe._transfer_path)
    if os.path.exists(path):
        with open(path) as f:
            store = json.load(f)
        rec = store.get(atpe._fingerprint(compile_space(space)), {})
        print("transfer store:", {k: (np.round(v, 1).tolist()
                                      if isinstance(v, list) else v)
                                  for k, v in rec.items()})

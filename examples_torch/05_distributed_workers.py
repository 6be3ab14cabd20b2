"""Distributed, elastic trial evaluation over a shared directory (the
MongoTrials/worker topology on a filesystem store).

This script plays BOTH roles for demo purposes — driver (suggests +
enqueues) and a worker subprocess (evaluates).  In production, run the
driver once anywhere and `hyperopt-tpu-torch-worker --root ... --exp-key
...` on as many machines as you like (they may join/leave freely; crashed
workers' jobs are requeued automatically).  The driver runs the suggest on
its device; a worker only runs the objective, on its host.

Run: python3 examples_torch/05_distributed_workers.py [--device cpu]
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

# Run from a checkout: the package sits beside this directory.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hyperopt_tpu_torch as ho
from hyperopt_tpu_torch import hp
from hyperopt_tpu_torch.parallel import FileTrials

p = argparse.ArgumentParser(description="FileTrials and a worker process")
p.add_argument("--device", default=None,
               help="where the suggest runs (default: the CUDA card)")
args = p.parse_args()


def objective(cfg):
    return (cfg["x"] - 1.0) ** 2 + cfg["c"] * 0.1


space = {"x": hp.uniform("x", -5, 5), "c": hp.choice("c", [0, 1, 2])}

root = tempfile.mkdtemp(prefix="hyperopt-tpu-torch-exp-")
worker = subprocess.Popen([
    sys.executable, "-m", "hyperopt_tpu_torch.parallel.filestore",
    "--root", root, "--exp-key", "demo", "--reserve-timeout", "30",
], cwd=ROOT)
try:
    trials = FileTrials(root, exp_key="demo")
    best = ho.fmin(objective, space, algo=ho.tpe.suggest, max_evals=40,
                   trials=trials, rstate=np.random.default_rng(0),
                   device=args.device)
finally:
    # Every trial is DONE once fmin returns: the idle worker is let go.
    worker.terminate()
    worker.wait(timeout=60)

print("best:", best, "loss:", trials.best_trial["result"]["loss"])
print("evaluated by:", {t["owner"] for t in trials if t["owner"]})
print(f"resume later with: FileTrials({root!r}, exp_key='demo')")

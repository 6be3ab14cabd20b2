"""Distributed evaluation over TCP — no shared filesystem required (the
MongoTrials *wire protocol* topology: one store server, network clients).

`StoreServer` hosts the experiment directory on its local disk and speaks
HTTP; `NetTrials` (driver) and `NetWorker` (evaluators) need only a URL.
All the file store's guarantees — atomic claims, owner-fenced writes,
heartbeats, automatic stale-job requeue — are enforced server-side, so
racing workers still evaluate every trial exactly once.

This script plays all three roles for demo purposes.  In production:

    host A$ hyperopt-tpu-torch-netstore --serve --root /data/exp --host 0.0.0.0
    host B$ hyperopt-tpu-torch-netstore --worker http://hostA:8417 --exp-key demo
    host C$ python driver.py        # fmin(trials=NetTrials("http://hostA:8417"))

The server here binds a free port; the driver's suggest runs on its
device, the worker only runs the objective.

Run: python3 examples_torch/10_network_store.py [--device cpu]
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
from hyperopt_tpu_torch.parallel import NetTrials, StoreServer

p = argparse.ArgumentParser(description="a store server and a net worker")
p.add_argument("--device", default=None,
               help="where the suggest runs (default: the CUDA card)")
args = p.parse_args()


def objective(cfg):
    return (cfg["x"] - 1.0) ** 2 + cfg["c"] * 0.1


space = {"x": hp.uniform("x", -5, 5), "c": hp.choice("c", [0, 1, 2])}

server = StoreServer(tempfile.mkdtemp(prefix="hyperopt-tpu-torch-net-"),
                     port=0)
server.start()
worker = None
try:
    worker = subprocess.Popen([
        sys.executable, "-m", "hyperopt_tpu_torch.parallel.netstore",
        "--worker", server.url, "--exp-key", "demo",
        "--reserve-timeout", "30",
    ], cwd=ROOT)
    trials = NetTrials(server.url, exp_key="demo")
    best = ho.fmin(objective, space, algo=ho.tpe.suggest, max_evals=40,
                   trials=trials, rstate=np.random.default_rng(0),
                   device=args.device)
    print("best:", best, "loss:", trials.best_trial["result"]["loss"])
    print("evaluated by:", {t["owner"] for t in trials if t["owner"]})
finally:
    if worker is not None:
        # Every trial is DONE once fmin returns: the idle worker is let go.
        worker.terminate()
        worker.wait(timeout=60)
    server.shutdown()

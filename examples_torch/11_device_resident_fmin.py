"""Device-resident fmin: the whole optimize loop on the card.

The classic ``fmin`` loop is host-driven: every trial pays a host↔device
round trip (suggest fetch + result insert) and the TPE step's several
hundred kernel launches from Python.

When the objective is a torch function, ``fmin_device`` keeps the loop on
the card: startup sampling, every TPE suggest, every objective evaluation
and every history insert of one trial are captured once as a CUDA graph,
and the graph is replayed once per trial.  The host reseeds the graph's
generators and fetches the landed rows once at the end.  With ``--device
cpu`` the same step runs eagerly.

The objective receives a FLAT ``{label: 0-d float32 tensor}`` dict (a
second positional arg receives the activity mask for conditional spaces)
and must branch with ``torch.where``, not Python ``if``.

Run: python3 examples_torch/11_device_resident_fmin.py [--device cpu]
"""

import argparse
import math
import os
import sys
import time

import torch

# Run from a checkout: the package sits beside this directory.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hyperopt_tpu_torch as ho
from hyperopt_tpu_torch import hp

p = argparse.ArgumentParser(description="fmin_device on Branin")
p.add_argument("--device", default=None,
               help="where the loop runs (default: the CUDA card)")
args = p.parse_args()


def branin(p):
    x, y = p["x"], p["y"]
    return ((y - 5.1 / (4 * math.pi ** 2) * x ** 2 + 5 / math.pi * x - 6)
            ** 2 + 10 * (1 - 1 / (8 * math.pi)) * torch.cos(x) + 10)


space = {"x": hp.uniform("x", -5, 10), "y": hp.uniform("y", 0, 15)}

# The first call captures the step; the graph is cached on the space.
best, info = ho.fmin_device(branin, space, max_evals=150, seed=0,
                            n_EI_candidates=64, device=args.device)
t0 = time.perf_counter()
best, info = ho.fmin_device(branin, space, max_evals=150, seed=1,
                            n_EI_candidates=64, device=args.device)
dt = time.perf_counter() - t0
print(f"best loss {info['best_loss']:.4f} at "
      f"x={best['x']:.3f}, y={best['y']:.3f} "
      f"({150 / dt:.0f} trials/s steady-state)")

# Conditional space: the mask argument makes gating explicit.
cond_space = {"model": hp.choice("model", [
    {"kind": 0},                                  # plain
    {"kind": 1, "lr": hp.loguniform("lr", -6, 0)},  # tunable
])}


def cond_obj(p, active):
    tuned = torch.abs(torch.log(p["lr"]) + 3.0) * 0.3
    return torch.where(active["lr"], tuned, torch.ones_like(tuned))


best_c, info_c = ho.fmin_device(cond_obj, cond_space, max_evals=120,
                                seed=0, device=args.device)
print(f"conditional best loss {info_c['best_loss']:.4f}: {best_c}")

# On a mesh of several cards, the candidate axis of every suggest step
# shards over the mesh's "sp" ranks inside the same captured step:
#   from hyperopt_tpu_torch import dispatch
#   from hyperopt_tpu_torch.parallel import multihost
#   mesh = multihost.initialize(init_method, world_size, rank)
#   ho.fmin_device(branin, space, max_evals=500, mesh=mesh,
#                  n_EI_candidates=128 * dispatch.axis_size(mesh, "sp"))

"""Multi-device suggest: sharded EI sweeps + multi-start proposals.

The mesh is a ``torch.distributed`` device mesh over the process group's
ranks: ``parallel.multihost.initialize()`` brings the group up (NCCL on
the cards, gloo with ``--device cpu``) and registers its mesh.  Run alone
it is a world of one rank; launched as one process per card with
``init_method``, ``world_size`` and ``rank`` it spans them all.  The
group is destroyed at the end.

Run: python3 examples_torch/04_multi_device.py [--device cpu]
"""

import argparse
import os
import sys
from functools import partial

import numpy as np
import torch.distributed as dist

# Run from a checkout: the package sits beside this directory.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hyperopt_tpu_torch as ho
from hyperopt_tpu_torch import dispatch, hp
from hyperopt_tpu_torch.parallel import (
    default_mesh,
    multi_start_suggest,
    multihost,
    sharded_suggest,
)

p = argparse.ArgumentParser(description="sharded and multi-start TPE")
p.add_argument("--device", default=None,
               help="where the suggest runs (default: the CUDA card)")
args = p.parse_args()

space = {f"x{i}": hp.uniform(f"x{i}", -5, 5) for i in range(10)}


def sphere(cfg):
    return float(sum(cfg[f"x{i}"] ** 2 for i in range(10)))


mesh = multihost.initialize(device=args.device)
try:
    # 1) One proposal per step, EI candidate axis sharded over the mesh's
    #    "sp" ranks (the long axis: 4,096 candidates split across cards).
    algo = partial(sharded_suggest, mesh=mesh, n_EI_candidates=4096)
    t = ho.Trials()
    ho.fmin(sphere, space, algo=algo, max_evals=60, trials=t,
            rstate=np.random.default_rng(0), device=args.device)
    print("sharded  best:", t.best_trial["result"]["loss"])

    # 2) K diverse proposals per step (one independent posterior per
    #    rank along "dp"), evaluated K at a time.
    k = dist.get_world_size()
    algo = partial(multi_start_suggest,
                   mesh=default_mesh(n_starts=k,
                                     device_type=mesh.device_type))
    t = ho.Trials()
    ho.fmin(sphere, space, algo=algo, max_evals=24 + 4 * k, trials=t,
            max_queue_len=k, rstate=np.random.default_rng(0),
            device=args.device)
    print("multistart best:", t.best_trial["result"]["loss"])
finally:
    dispatch.clear_default_mesh()
    dist.destroy_process_group()

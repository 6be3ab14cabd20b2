"""The two bucket ladders of ``tests/torch_ladders.py`` on the card: hosted
TPE runs whose history crosses the 32 → 1,024 buckets (and, in batches of
8, the 32 → 512 buckets), K1 once per TPE step.  A one-proposal step
after its kernel's first replays the kernel's hosted step graph: K1's
eager launches, its recordings into graphs and the graphs' replays are
counted apart."""

import os
import sys

import pytest
import torch

from hyperopt_tpu_torch import tpe
from hyperopt_tpu_torch.obs.metrics import registry
from hyperopt_tpu_torch.ops import ei_scores as ek
from hyperopt_tpu_torch.space import compile_space

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))
from torch_ladders import (  # noqa: E402
    batched_bucket_ladder, ladder_space, thousand_trials_bucket_ladder)


def _graphs():
    snap = registry().snapshot()["counters"]
    return {k: snap.get(f"tpe.graph.{k}", 0.0)
            for k in ("captures", "replays", "eager_steps")}


def _kernels(cs):
    """The space's kernels on the card: the ids of those that have
    stepped, and the hosted graphs they hold."""
    ks = [k for k in getattr(cs, "_tpe_kernels", {}).values()
          if k.device.type == "cuda"]
    return {id(k) for k in ks if k.stepped}, sum(len(k.hosted) for k in ks)


@pytest.mark.cuda
def test_thousand_trials_bucket_ladder():
    cs = compile_space(ladder_space())
    stepped0, held0 = _kernels(cs)
    g0 = _graphs()
    ek.reset_launches()
    thousand_trials_bucket_ladder("cuda")
    stepped1, held1 = _kernels(cs)
    g = {k: _graphs()[k] - g0[k] for k in g0}
    steps = 1050 - tpe._default_n_startup_jobs
    # Each kernel's first step runs eagerly; every later one replays.
    first = len(stepped1 - stepped0)
    assert g["replays"] == steps - first
    # Each capture is a graph the kernels now hold, which recorded K1
    # once; its warm-up launched K1 once more.
    assert g["captures"] == held1 - held0 >= 1
    assert ek.ei_scores.recorded_by == {"f32": g["captures"], "bf16": 0,
                                        "mxu": 0}
    assert ek.ei_scores.launches_by == {"f32": first + g["captures"],
                                        "bf16": 0, "mxu": 0}
    assert g["eager_steps"] == 0


@pytest.mark.cuda
def test_batched_bucket_ladder(monkeypatch):
    ek.reset_launches()
    batches = batched_bucket_ladder("cuda", monkeypatch)
    # One K1 launch per liar step: 8 per batch past startup.
    assert ek.ei_scores.launches_by["f32"] == 8 * batches

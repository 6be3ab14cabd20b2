"""The obs layer on the card (the CPU half: ``tests/test_torch_obs.py`` and
``tests/test_torch_device_telemetry.py``)."""

import json
import os
from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import device, tpe
from hyperopt_tpu_torch.obs import devtel, trace
from hyperopt_tpu_torch.obs.metrics import registry
from hyperopt_tpu_torch.ops import ei_scores as ek
from hyperopt_tpu_torch.space import compile_space

SPACE = {"x": ht.hp.uniform("x", -5, 5), "c": ht.hp.choice("c", [0, 1, 2])}
ALGO = partial(tpe.suggest, n_startup_jobs=5)


def objective(p):
    d = p["x"] - 1.0
    return d * d + p["c"]


def _graphs():
    snap = registry().snapshot()["counters"]
    return {k: snap.get(f"tpe.graph.{k}", 0.0)
            for k in ("captures", "replays", "eager_steps")}


def _run(stride, n=24):
    t = ht.Trials()
    ht.fmin(objective, SPACE, algo=ALGO, max_evals=n, trials=t,
            rstate=np.random.default_rng(3), show_progressbar=False,
            mode="device", sync_stride=stride)
    return [(d["misc"]["vals"], d["result"]["loss"]) for d in t]


@pytest.mark.cuda
def test_slab_armed_and_disarmed_replays_land_the_same_trials():
    """The armed graph (two more stores) and the disarmed one land the same
    trials with the same fetch counts on the card."""
    out = {}
    try:
        for armed in (True, False):
            devtel.set_enabled(armed)
            f0, c0, r0 = device.fetch_syncs, device.captures, device.replays
            out[armed] = _run(8)
            assert device.fetch_syncs - f0 == 3
            assert device.captures - c0 == 1 and device.replays - r0 == 24
            assert device.eager_steps == 0
    finally:
        devtel.set_enabled(True)
    assert out[True] == out[False]


@pytest.mark.cuda
def test_trace_dir_profiles_the_card(tmp_path):
    """``fmin(trace_dir=)`` on the card writes the profiler's export with
    the CUDA kernels and the EI kernel once per TPE step.  On fresh
    kernels the first TPE step launches it eagerly, the second captures
    the hosted step graph (its warm-up launches K1 once and the graph
    records it once) and replays it, as do the later steps; the profiler
    sees the card run it once per step and once per warm-up."""
    compile_space(SPACE).__dict__.pop("_tpe_kernels", None)
    g0 = _graphs()
    ek.reset_launches()
    ht.fmin(lambda d: (d["x"] - 1.0) ** 2 + d["c"], SPACE, algo=ALGO,
            max_evals=12, trials=ht.Trials(),
            rstate=np.random.default_rng(0), show_progressbar=False,
            trace_dir=str(tmp_path))
    torch.cuda.synchronize()
    g = {k: _graphs()[k] - g0[k] for k in g0}
    steps = 12 - 5      # one history bucket, one kernel
    assert g == {"captures": 1, "replays": steps - 1, "eager_steps": 0}
    assert ek.ei_scores.launches_by == {"f32": 2, "bf16": 0, "mxu": 0}
    assert ek.ei_scores.recorded_by == {"f32": 1, "bf16": 0, "mxu": 0}
    assert {"loop_trace.json", "loop_events.jsonl", "chrome_trace.json",
            trace.PROFILER_TRACE} <= set(os.listdir(tmp_path))
    with open(tmp_path / trace.PROFILER_TRACE) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert sum("ei_scores_kernel<false>" in e.get("name", "")
               for e in kernels) == steps + g["captures"]

"""The span store on the card (the CPU half: ``tests/test_torch_obs_spans.py``):
the suggest path's spans are host ranges on the profiler's timeline, beside
the kernels they enqueue, and none of them becomes a device event."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import show, tpe
from hyperopt_tpu_torch.obs import trace

SPACE = {"xs": ht.hp.uniform("xs", -5.0, 10.0),
         "ys": ht.hp.uniform("ys", 0.0, 15.0)}


def objective(p):
    return (p["xs"] - 2.0) ** 2 + (p["ys"] - 3.0) ** 2


def _fmin(n, **kw):
    ht.fmin(objective, SPACE, algo=tpe.suggest, max_evals=n,
            trials=ht.Trials(), rstate=np.random.default_rng(5),
            show_progressbar=False, device="cuda", **kw)
    tpe.wait_prewarm()


@pytest.mark.cuda
def test_spans_leave_no_event_on_the_device_timeline():
    _fmin(24)  # warm: kernels built, CUDA modules loaded
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _fmin(26)
        torch.cuda.synchronize()
    evs = prof.events()
    names = {e.name for e in evs if e.name.startswith("tpe.")}
    assert {"tpe.suggest", "tpe.step", "tpe.step.groups", "tpe.fetch",
            "tpe.feed", "tpe.docs"} <= names
    spans = [e for e in evs if e.name.startswith("tpe.")
             or e.name in ("suggest", "store", "evaluate", "save")]
    assert spans
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               and not e.is_user_annotation for e in spans)
    assert any(e.device_type == torch.autograd.DeviceType.CUDA for e in evs)


@pytest.mark.cuda
def test_trace_dir_puts_each_step_beside_its_kernels(tmp_path):
    d = tmp_path / "trace"
    _fmin(40, trace_dir=str(d))
    with open(d / trace.PROFILER_TRACE) as fh:
        ev = json.load(fh)["traceEvents"]
    spans = [e for e in ev if e.get("ph") == "X"
             and e.get("name", "").startswith("tpe.")]
    assert {e["cat"] for e in spans} == {"cpu_op"}
    steps = [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in spans
             if e["name"] == "tpe.step"]
    assert len(steps) == 20
    kernels = {e["args"]["correlation"]: e for e in ev
               if e.get("cat") == "kernel" and "correlation" in
               e.get("args", {})}
    launched = 0
    for e in ev:
        if e.get("cat") != "cuda_runtime" or "Launch" not in e["name"]:
            continue
        step = next((s for s in steps if s[0] <= e["ts"] <= s[1]
                     and s[2] == e["tid"]), None)
        k = kernels.get(e.get("args", {}).get("correlation"))
        if step is None or k is None:
            continue
        # One clock: the kernel starts after its launch, inside or after
        # the span that launched it.
        assert k["ts"] >= e["ts"] >= step[0]
        launched += 1
    assert launched >= 20 * 50
    doc = json.loads((d / "loop_trace.json").read_text())
    idle = show.span_idle(ev, {k for k in doc if k != "_wall"})
    assert idle and sum(idle.values()) > 0.0

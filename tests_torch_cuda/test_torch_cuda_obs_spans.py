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
from hyperopt_tpu_torch.space import compile_space

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
    _fmin(24)  # warm: CUDA modules and the EI library loaded
    # Fresh kernels: the profiled run's first TPE step runs eagerly (the
    # step's phase spans), the later ones replay the hosted step graph.
    compile_space(SPACE).__dict__.pop("_tpe_kernels", None)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _fmin(26)
        torch.cuda.synchronize()
    evs = prof.events()
    names = {e.name for e in evs if e.name.startswith("tpe.")}
    assert {"tpe.suggest", "tpe.step", "tpe.step.draw", "tpe.step.split",
            "tpe.step.groups", "tpe.step.pick", "tpe.step.replay",
            "tpe.fetch", "tpe.feed", "tpe.docs"} <= names
    spans = [e for e in evs if e.name.startswith("tpe.")
             or e.name in ("suggest", "store", "evaluate", "save")]
    assert spans
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               and not e.is_user_annotation for e in spans)
    assert any(e.device_type == torch.autograd.DeviceType.CUDA for e in evs)


@pytest.mark.cuda
def test_trace_dir_puts_each_step_beside_its_kernels(tmp_path):
    """Each ``tpe.step`` span holds its step's launches, and the profiler's
    correlation ids tie each launch to the kernels it ran: one kernel per
    kernel launch (a bucket's first step and its capture's warm-up), the
    whole graph per ``cudaGraphLaunch`` (one per ``tpe.step.replay``).  On the card's clock the kernels of a stream
    start in the order of their launches.  Kernel-before-launch across
    the two clocks is not held: the profiler maps the card's clock onto
    the host's per session, and in 2 of 8 sessions on an H100 it put
    kernels 15 us to 2.3 ms before their launch, eager and replayed
    alike."""
    compile_space(SPACE).__dict__.pop("_tpe_kernels", None)
    d = tmp_path / "trace"
    _fmin(40, trace_dir=str(d))
    with open(d / trace.PROFILER_TRACE) as fh:
        ev = json.load(fh)["traceEvents"]
    spans = [e for e in ev if e.get("ph") == "X"
             and e.get("name", "").startswith("tpe.")]
    assert {e["cat"] for e in spans} == {"cpu_op"}

    def ranges(name):
        return [(e["ts"], e["ts"] + e["dur"], e["tid"]) for e in spans
                if e["name"] == name]

    steps, replays = ranges("tpe.step"), ranges("tpe.step.replay")
    # 20 TPE steps over buckets 32 and 64: each bucket's first runs
    # eagerly, the others replay (the second captures first).
    assert len(steps) == 20 and len(replays) == 18
    kernels = {}
    for e in ev:
        if e.get("cat") == "kernel" and "correlation" in e.get("args", {}):
            kernels.setdefault(e["args"]["correlation"], []).append(e)

    def inside(e, rs):
        return next((r for r in rs if r[0] <= e["ts"] <= r[1]
                     and r[2] == e["tid"]), None)

    launched, graph_launches, order = 0, [], []
    for e in ev:
        if e.get("cat") != "cuda_runtime" or "Launch" not in e["name"] \
                or inside(e, steps) is None:
            continue
        ks = kernels.get(e.get("args", {}).get("correlation"), [])
        if e["name"] == "cudaGraphLaunch":
            assert inside(e, replays) is not None
            graph_launches.append(len(ks))
        elif ks:
            assert len(ks) == 1, e
        launched += len(ks)
        order += [(e["ts"], k["args"]["stream"], k["ts"]) for k in ks]
    # One graph launch per replay, each running the whole step: one graph
    # per bucket (32 and 64), whose kernel counts may differ.
    assert len(graph_launches) == len(replays)
    assert min(graph_launches) >= 200 and len(set(graph_launches)) <= 2
    assert launched >= 20 * 50
    # On the card's clock, a stream's kernels run in launch order.
    for stream in {s for _, s, _ in order}:
        starts = [k for _, s, k in sorted(order) if s == stream]
        assert starts == sorted(starts), stream
    doc = json.loads((d / "loop_trace.json").read_text())
    idle = show.span_idle(ev, {k for k in doc if k != "_wall"})
    assert idle and sum(idle.values()) > 0.0

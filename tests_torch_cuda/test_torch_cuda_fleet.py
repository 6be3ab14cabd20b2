"""The fleet on the card (the CPU half: ``tests/test_torch_fleet.py`` and
``tests/test_torch_fleet_flagship.py``): each lane of one captured
``fmin_fleet`` graph lands, bit for bit, the trials of a solo
``fmin(mode="device")`` run under that lane's seed; the counter
``device.capture_ms`` grows on a capture and not on a replay, beside the
``device.replays`` twin and the ``device.pool_bytes`` gauge; and the
fleet's spans are host ranges that leave no device event."""

from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from torch.profiler import ProfilerActivity, profile

from hyperopt_tpu_torch import device, fleet, tpe
from hyperopt_tpu_torch.obs import metrics

hp = ht.hp
SPACE = {"x": hp.uniform("x", -5, 5),
         "lr": hp.loguniform("lr", -4, 0),
         "q": hp.quniform("q", 0, 10, 2),
         "c": hp.choice("c", [0, 1, 2, 3])}
ALGO = dict(n_EI_candidates=64)


def objective(p):
    d = p["x"] - 1.0
    return d * d + torch.abs(torch.log(p["lr"]) + 2.0) + p["q"] * 0.25 \
        + p["c"]


@pytest.mark.cuda
@pytest.mark.parametrize("lowering", [
    dict(), dict(ei_precision="bf16"), dict(ei_impl="mxu")],
    ids=["f32", "bf16", "mxu"])
def test_fmin_fleet_lanes_equal_solo_device_runs(lowering):
    n, lanes, seed = 48, 3, 7
    tl = [ht.Trials() for _ in range(lanes)]
    device.reset_counters()
    infos = fleet.fmin_fleet(objective, SPACE, n_lanes=lanes, max_evals=n,
                             seed=seed, sync_stride=16, trials_list=tl,
                             **ALGO, **lowering)
    assert (device.captures, device.replays, device.eager_steps,
            device.fetch_syncs) == (1, n, 0, n // 16)
    for j, info in enumerate(infos):
        t = ht.Trials()
        ht.fmin(objective, SPACE,
                algo=partial(tpe.suggest, **ALGO, **lowering), max_evals=n,
                trials=t, rstate=np.random.default_rng(seed + j),
                show_progressbar=False, mode="device", sync_stride=16)
        solo = [(d["misc"]["vals"], d["result"]["loss"])
                for d in t._dynamic_trials]
        landed = [(d["misc"]["vals"], d["result"]["loss"])
                  for d in tl[j]._dynamic_trials]
        assert landed == solo
        np.testing.assert_array_equal(
            info["losses"], np.asarray([s[1] for s in solo], np.float32))
    assert not np.array_equal(infos[0]["losses"], infos[1]["losses"])


def _registry(name):
    snap = metrics.registry().snapshot()
    return snap["counters"].get(name, snap["gauges"].get(name))


def _run_fleet(fn, n=24, lanes=2, stride=8):
    tl = [ht.Trials() for _ in range(lanes)]
    fleet.fmin_fleet(fn, SPACE, n_lanes=lanes, max_evals=n, seed=3,
                     sync_stride=stride, trials_list=tl, **ALGO)
    return tl


@pytest.mark.cuda
def test_capture_ms_grows_on_a_capture_and_not_on_a_replay():
    def fresh(p):  # an objective of its own: its first run captures
        return objective(p)

    device.reset_counters()
    ms0, r0 = _registry("device.capture_ms"), _registry("device.replays")
    _run_fleet(fresh)
    ms1, r1 = _registry("device.capture_ms"), _registry("device.replays")
    assert device.captures == 1 and ms1 > ms0
    assert r1 - r0 == device.replays == 24
    assert _registry("device.pool_bytes") > 0
    _run_fleet(fresh)
    assert device.captures == 1
    assert _registry("device.capture_ms") == ms1
    assert _registry("device.replays") - r1 == 24


@pytest.mark.cuda
def test_fleet_spans_leave_no_event_on_the_device_timeline():
    _run_fleet(objective)  # warm: captured before the profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_fleet(objective)
        torch.cuda.synchronize()
    evs = prof.events()
    spans = [e for e in evs if e.name.startswith("fleet.")]
    assert sorted({e.name for e in spans}) == [
        "fleet.fetch", "fleet.land", "fleet.run", "fleet.segment"]
    assert len([e for e in spans if e.name == "fleet.segment"]) == 3
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               and not e.is_user_annotation for e in spans)
    assert any(e.device_type == torch.autograd.DeviceType.CUDA for e in evs)

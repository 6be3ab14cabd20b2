"""The fleet on the card (the CPU half: ``tests/test_torch_fleet.py``):
each lane of one captured ``fmin_fleet`` graph lands, bit for bit, the
trials of a solo ``fmin(mode="device")`` run under that lane's seed."""

from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import device, fleet, tpe

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

"""The rest of TPE on the card (the CPU half:
``tests/test_torch_multivariate.py`` and ``test_torch_tpe_lowerings.py``):
joint (``multivariate=True``) fleet lanes land their solo device runs bit
for bit on each EI lowering, and a captured Gumbel step at stride 1 lands
the hosted Gumbel run's trials."""

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
         "c": hp.choice("c", [{"k": 0},
                              {"k": 1, "d": hp.uniformint("d", 1, 6)}])}
ALGO = dict(n_EI_candidates=64, multivariate=True)


def objective(p):
    d = p["x"] - 1.0
    return d * d + torch.abs(torch.log(p["lr"]) + 2.0) + p["q"] * 0.25 \
        + torch.where(p["c"] > 0, p["d"], 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("lowering", [
    dict(), dict(ei_precision="bf16"), dict(ei_impl="mxu")],
    ids=["f32", "bf16", "mxu"])
def test_joint_fleet_lanes_equal_solo_device_runs(lowering):
    n, lanes, seed = 48, 3, 9
    device.reset_counters()
    infos = fleet.fmin_fleet(objective, SPACE, n_lanes=lanes, max_evals=n,
                             seed=seed, sync_stride=16, **ALGO, **lowering)
    assert (device.captures, device.replays, device.eager_steps) == \
        (1, n, 0)
    for j, info in enumerate(infos):
        _, solo = ht.fmin_device(objective, SPACE, max_evals=n,
                                 seed=seed + j, **ALGO, **lowering)
        for k in ("losses", "vals", "active"):
            np.testing.assert_array_equal(info[k], solo[k])
    assert not np.array_equal(infos[0]["losses"], infos[1]["losses"])


SPACE_G = {"x": hp.uniform("x", -5, 5),
           "q": hp.quniform("q", 0, 10, 2),
           "c": hp.choice("c", [0, 1, 2, 3])}
GUMBEL = dict(n_EI_candidates=64, comp_sampler="gumbel")


def objective_g(p):
    d = p["x"] - 1.0
    return d * d + p["c"] + p["q"] * 0.25


def objective_g_host(cfg):
    """:func:`objective_g` in float32, one rounding per operation."""
    d = np.float32(cfg["x"]) - np.float32(1.0)
    return float(d * d + np.float32(cfg["c"])
                 + np.float32(cfg["q"]) * np.float32(0.25))


@pytest.mark.cuda
def test_gumbel_capture_at_stride_1_equals_the_hosted_run():
    n = 40
    hosted, captured = ht.Trials(), ht.Trials()
    ht.fmin(objective_g_host, SPACE_G, algo=partial(tpe.suggest, **GUMBEL),
            max_evals=n, trials=hosted, rstate=np.random.default_rng(3),
            show_progressbar=False)
    device.reset_counters()
    ht.fmin(objective_g, SPACE_G, algo=partial(tpe.suggest, **GUMBEL),
            max_evals=n, trials=captured, rstate=np.random.default_rng(3),
            show_progressbar=False, mode="device", sync_stride=1)
    assert (device.captures, device.replays, device.eager_steps) == \
        (1, n, 0)
    assert [(d["misc"]["vals"], d["result"]["loss"]) for d in captured] == \
        [(d["misc"]["vals"], d["result"]["loss"]) for d in hosted]

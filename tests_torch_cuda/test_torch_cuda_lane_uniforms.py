"""The one-launch draw of every lane's uniforms on the card (the CPU half:
``tests/test_torch_lane_uniforms.py``).

* The kernel writes, bit for bit, what ``torch.rand`` writes on a freshly
  seeded CUDA generator for every sheet a segment draws, in each
  generator's order: the startup sheets (``[1, k]`` per sampler family)
  and the TPE sheets of the flagship space at 10,000 candidates (the
  ``[31, 10000]`` density sheets use two lanes of each Philox block) and
  of Branin at 24, at 1, 8 and 64 lanes, seeds 0, 1, 2**31 - 2, 2**32 - 1
  and random ones.
* The plain twin writes the kernel's bits on the same plan and seeds.
* A 64-lane flagship fleet of 200 trials lands, in a sample of lanes and
  trials, the rows that the hosted ``tpe.suggest`` (its startup arm
  ``rand``'s sampler) proposes on the lane's landed history from the same
  trial seed; the segment holds no generator, draws once per replay
  (``device.lane_draws``) and recorded the draw once at its capture.
* A launch that CUDA refuses raises.
"""

import copy
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import device, fleet, tpe
from hyperopt_tpu_torch.obs.metrics import registry
from hyperopt_tpu_torch.ops import lane_uniforms as lu
from hyperopt_tpu_torch.space import compile_space

SPACES = Path(__file__).resolve().parent.parent / "portbench" / "spaces"
CUDA = torch.device("cuda", 0)
SEEDS = [0, 1, 2 ** 31 - 2, 2 ** 32 - 1]


def _space(name, n_dims):
    spec = importlib.util.spec_from_file_location(
        f"_lane_uniforms_{name}", SPACES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build(ht.hp, n_dims)


CELLS = {"flagship50": (("flagship", 50), 10_000),
         "branin2": (("branin", 2), 24)}


def _plan(cell, lanes):
    """A segment's sheets and plan for ``lanes`` lanes of the cell's space
    on the card, laid out by ``_Segment._plan_draws`` itself."""
    (name, n_dims), n_cand = CELLS[cell]
    cs = compile_space(_space(name, n_dims))
    kern = tpe.get_kernel(cs, 64, n_cand, 25, device=CUDA)
    seg = SimpleNamespace(cs=cs, kern=kern, n_lanes=lanes, device=CUDA)
    device._Segment._plan_draws(seg, *lu.card_shape(CUDA))
    return seg


def _seeds(lanes, salt):
    rng = np.random.default_rng(salt)
    extra = [int(s) for s in rng.integers(0, 2 ** 32, max(0, lanes - 4))]
    return (SEEDS + extra)[:lanes] if lanes > 1 else [SEEDS[salt % 4]]


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 8, 64])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_kernel_writes_torch_rands_bits(cell, lanes):
    salts = range(4) if lanes == 1 else range(2)
    for salt in salts:
        seg = _plan(cell, lanes)
        seeds = _seeds(lanes, salt)
        seg.seeds.copy_(torch.tensor(seeds, dtype=torch.int64))
        lu.draw(seg.plan, seg.seeds)
        g = torch.Generator(device=CUDA)
        for j, s in enumerate(seeds):
            g.manual_seed(s)
            want = seg.cs.draw_uniforms(1, g, CUDA)
            assert list(want) == list(seg.su)
            for name, u in want.items():
                assert _same_bits(seg.su[name][j], u[0]), (cell, j, name)
            g.manual_seed(s)
            want = seg.kern.draw_noise(g)
            for k, (uc, u) in enumerate(want["cont"]):
                assert _same_bits(seg.nz["cont"][k][0][j], uc), (cell, j, k)
                assert _same_bits(seg.nz["cont"][k][1][j], u), (cell, j, k)
            assert _same_bits(seg.nz["cat"][j], want["cat"]), (cell, j)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_twin_writes_the_kernels_bits(cell):
    seg = _plan(cell, 8)
    seeds = _seeds(8, 3)
    seg.seeds.copy_(torch.tensor(seeds, dtype=torch.int64))
    lu.draw(seg.plan, seg.seeds)
    for slot, offset, numel, grid, out in seg.plan.sheets:
        twin = lu.uniform_sheet_reference(seeds[slot], offset, numel, grid,
                                          device=CUDA)
        assert _same_bits(out.reshape(-1), twin), (slot, offset, numel)


def _squares(p):
    acc = p["u0"] * p["u0"]
    for i in range(1, 10):
        acc = acc + p[f"u{i}"] * p[f"u{i}"]
    return acc


@pytest.mark.cuda
def test_fleet_lands_the_hosted_proposals():
    space = _space("flagship", 50)
    lanes, n, seed, stride = 64, 200, 20260, 50
    algo = dict(n_EI_candidates=10_000)
    reg = registry()
    draws0 = reg.counter("device.lane_draws").value
    device.reset_counters()
    lu.reset_launches()
    objective = lambda p: _squares(p)  # noqa: E731 (a fresh capture)
    tl = [ht.Trials() for _ in range(lanes)]
    fleet.fmin_fleet(objective, space, n_lanes=lanes, max_evals=n,
                     seed=seed, sync_stride=stride, trials_list=tl, **algo)
    assert (device.captures, device.replays, device.lane_draws) == (1, n, n)
    assert reg.counter("device.lane_draws").value == draws0 + n
    assert (lu.draw.launches, lu.draw.recorded_by) == \
        (device._WARMUP_STEPS, 1)
    cs = compile_space(space)
    seg = next(s for f, s in cs._device_runs.values() if f is objective)
    assert seg.gens == [] and seg.plan is not None
    domain = ht.Domain(objective, space)
    domain.cs.device = CUDA
    for j in (0, 1, 37, 63):
        rng = np.random.default_rng(seed + j)
        trial_seeds = [int(rng.integers(2 ** 31 - 1)) for _ in range(n)]
        docs = tl[j]._dynamic_trials
        assert len(docs) == n
        for k in (0, 7, 19, 20, 21, 64, 129, 199):
            t = ht.Trials()
            t.insert_trial_docs(copy.deepcopy(docs[:k]))
            t.refresh()
            got = tpe.suggest(t.new_trial_ids(1), domain, t, trial_seeds[k],
                              **algo)
            assert got[0]["misc"]["vals"] == docs[k]["misc"]["vals"], (j, k)


@pytest.mark.cuda
def test_a_refused_launch_raises():
    seg = _plan("branin2", 1)
    with torch.cuda.device(CUDA):
        with pytest.raises(RuntimeError, match="CUDA error"):
            lu._launch(seg.plan.units, seg.plan.block_unit, seg.seeds, 0)
        # The error is the launch's own: the next launch runs.
        lu.draw(seg.plan, seg.seeds)
        torch.cuda.synchronize()

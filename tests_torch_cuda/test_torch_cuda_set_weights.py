"""The TPE step's per-column observation weights on the card (the CPU half:
``tests/test_torch_set_weights.py``).

* The kernel's ``m``, ``w`` and ``n_set`` are bitwise the twin's
  (``set_weights_reference``, ``torch.cumsum`` and the weights'
  arithmetic) on the same CUDA tensors: 1, 8 and 64 lanes; 32 to 2,048
  rows and 5,000 (not a power of two: several tiles of the block); 1, 2,
  11 and 31 columns; masks of density 0, 0.01, 0.3 and 1; horizons 1, 25
  and beyond the rows.  Each shape runs eagerly, then recorded into a
  CUDA graph and replayed on fresh masks; ``launches`` counts the eager
  calls and ``recorded_by`` the recordings.
* A flagship TPE step with the kernel proposes the bits it proposes with
  the twin in its place.
* Each lane of a captured fleet lands the trials of its solo device run,
  and the capture recorded one launch per column group.
* A launch that CUDA refuses raises.
"""

import importlib.util
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import device, fleet, tpe
from hyperopt_tpu_torch.ops import set_weights as sw
from hyperopt_tpu_torch.space import compile_space

CUDA = torch.device("cuda", 0)
DENSITIES = (0.0, 0.01, 0.3, 1.0)
COLUMNS = (1, 2, 11, 31)


def _fill(bufs, density, gen):
    """Fill ``(below, above, act)`` in place: below of ``density``, above
    the rest of the rows at 0.9, act at 0.8 (all rows at density 1)."""
    below, above, act = bufs
    below.copy_(torch.rand(below.shape, generator=gen, device=CUDA)
                < density)
    above.copy_(~below & (torch.rand(above.shape, generator=gen, device=CUDA)
                          < 0.9))
    act.copy_(torch.rand(act.shape, generator=gen, device=CUDA)
              < max(0.8, density))


def _same(got, want):
    for (gm, gw, gn), (wm, ww, wn) in zip(got, want):
        assert torch.equal(gm, wm)
        assert torch.equal(gn, wn)
        assert torch.equal(gw.view(torch.int32), ww.view(torch.int32))


def _twin(bufs, lf):
    below, above, act = bufs
    return [sw.set_weights_reference(s, act, lf) for s in (below, above)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 256, 1024, 2048, 5000])
@pytest.mark.parametrize("lanes", [1, 8, 64])
def test_kernel_writes_the_twins_bits_eager_and_replayed(lanes, rows):
    gen = torch.Generator(device=CUDA).manual_seed(lanes * 10_007 + rows)
    for cols in COLUMNS:
        bufs = (torch.zeros((lanes, rows), dtype=torch.bool, device=CUDA),
                torch.zeros((lanes, rows), dtype=torch.bool, device=CUDA),
                torch.zeros((lanes, rows, cols), dtype=torch.bool,
                            device=CUDA))
        for lf in (1, 25, rows + 7):
            sw.reset_launches()
            for density in DENSITIES:
                _fill(bufs, density, gen)
                _same(sw.set_weights(*bufs, lf), _twin(bufs, lf))
            assert (sw.set_weights.launches,
                    sw.set_weights.recorded_by) == (len(DENSITIES), 0)
            side = torch.cuda.Stream(CUDA)
            side.wait_stream(torch.cuda.current_stream(CUDA))
            with torch.cuda.stream(side):
                sw.set_weights(*bufs, lf)
            torch.cuda.current_stream(CUDA).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = sw.set_weights(*bufs, lf)
            assert (sw.set_weights.launches,
                    sw.set_weights.recorded_by) == (len(DENSITIES) + 1, 1)
            for density in DENSITIES:
                _fill(bufs, density, gen)
                graph.replay()
                _same(out, _twin(bufs, lf))
            assert (sw.set_weights.launches,
                    sw.set_weights.recorded_by) == (len(DENSITIES) + 1, 1)


@pytest.mark.cuda
def test_solo_rows_without_a_lane_axis():
    gen = torch.Generator(device=CUDA).manual_seed(5)
    bufs = (torch.zeros(1000, dtype=torch.bool, device=CUDA),
            torch.zeros(1000, dtype=torch.bool, device=CUDA),
            torch.zeros((1000, 31), dtype=torch.bool, device=CUDA))
    _fill(bufs, 0.3, gen)
    _same(sw.set_weights(*bufs, 25), _twin(bufs, 25))


def _flagship():
    path = (Path(__file__).resolve().parent.parent / "portbench" / "spaces"
            / "flagship.py")
    spec = importlib.util.spec_from_file_location("_sw_flagship", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build(ht.hp, 50)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 8])
def test_step_proposes_the_twins_bits(monkeypatch, lanes):
    cs = compile_space(_flagship())
    n_cap, n = 1024, 1000
    kern = tpe.get_kernel(cs, n_cap, 10_000, 25, device=CUDA)
    g = torch.Generator(device=CUDA).manual_seed(lanes)
    rows = [cs.sample(n, generator=g, device=CUDA) for _ in range(lanes)]
    vals = torch.zeros((lanes, n_cap, cs.n_params), device=CUDA)
    active = torch.zeros((lanes, n_cap, cs.n_params), dtype=torch.bool,
                         device=CUDA)
    for j, (v, a) in enumerate(rows):
        vals[j, :n], active[j, :n] = v, a
    loss = torch.full((lanes, n_cap), float("inf"), device=CUDA)
    loss[:, :n] = torch.rand((lanes, n), generator=g, device=CUDA)
    ok = torch.zeros((lanes, n_cap), dtype=torch.bool, device=CUDA)
    ok[:, :n] = True
    noise = tpe.stack_noise([kern.draw_noise(g) for _ in range(lanes)])
    sw.reset_launches()
    got = kern._suggest_lanes(vals, active, loss, ok, 0.25, 1.0,
                              noise=noise)
    assert sw.set_weights.launches == 3

    def twin(below, above, act, lf):
        return tuple(sw.set_weights_reference(s, act, lf)
                     for s in (below, above))

    monkeypatch.setattr(tpe, "set_weights", twin)
    want = kern._suggest_lanes(vals, active, loss, ok, 0.25, 1.0,
                               noise=noise)
    assert sw.set_weights.launches == 3
    for x, y in zip(got, want):
        assert torch.equal(x, y)


SPACE = {"x": ht.hp.uniform("x", -5, 5),
         "lr": ht.hp.loguniform("lr", -4, 0),
         "q": ht.hp.quniform("q", 0, 10, 2),
         "c": ht.hp.choice("c", [0, 1, 2, 3])}
ALGO = dict(n_EI_candidates=64)


def objective(p):
    d = p["x"] - 1.0
    return d * d + torch.abs(torch.log(p["lr"]) + 2.0) + p["q"] * 0.25 \
        + p["c"]


@pytest.mark.cuda
def test_fleet_lanes_equal_their_solo_runs():
    n, lanes, seed = 64, 4, 11
    tl = [ht.Trials() for _ in range(lanes)]
    sw.reset_launches()
    fleet.fmin_fleet(objective, SPACE, n_lanes=lanes, max_evals=n,
                     seed=seed, sync_stride=16, trials_list=tl, **ALGO)
    # One launch per column group (density, lattice, choices) recorded
    # into the lane step's graph; its warm-up steps ran eagerly.
    assert sw.set_weights.recorded_by == 3
    assert sw.set_weights.launches == 3 * device._WARMUP_STEPS
    for j in range(lanes):
        t = ht.Trials()
        ht.fmin(objective, SPACE, algo=partial(tpe.suggest, **ALGO),
                max_evals=n, trials=t, rstate=np.random.default_rng(seed + j),
                show_progressbar=False, mode="device", sync_stride=16)
        solo = [(d["misc"]["vals"], d["result"]["loss"])
                for d in t._dynamic_trials]
        landed = [(d["misc"]["vals"], d["result"]["loss"])
                  for d in tl[j]._dynamic_trials]
        assert landed == solo, j


@pytest.mark.cuda
def test_a_refused_launch_raises():
    bufs = [torch.zeros((1, 64), dtype=torch.bool, device=CUDA),
            torch.zeros((1, 64), dtype=torch.bool, device=CUDA),
            torch.zeros((1, 64, 3), dtype=torch.bool, device=CUDA)]
    m = torch.empty((2, 1, 64, 3), dtype=torch.bool, device=CUDA)
    w = torch.empty((2, 1, 64, 3), dtype=torch.float32, device=CUDA)
    n_set = torch.empty((2, 1, 3), dtype=torch.int64, device=CUDA)
    sw.set_weights(*bufs, 25)
    with torch.cuda.device(CUDA):
        # Zero blocks: a grid CUDA refuses.
        with pytest.raises(RuntimeError, match="CUDA error"):
            sw._launch(*bufs, m, w, n_set, 0, 64, 3, 25)
        # The error is the launch's own: the next launch runs.
        sw.set_weights(*bufs, 25)
        torch.cuda.synchronize()

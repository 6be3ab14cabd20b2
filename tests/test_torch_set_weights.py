"""The TPE step's per-column observation weights (``ops/set_weights.py``)
on the CPU.

The kernel runs on the card only (``tests_torch_cuda/
test_torch_cuda_set_weights.py`` holds it to the twin's bits); here:

* CPU tensors take the twin, set by set, and nothing builds or loads the
  kernel library; CUDA tensors never reach the twin;
* the twin's weights equal an element-by-element float32 evaluation of
  the linear-forgetting ramp, and the JAX step's ranks and weights
  (``hyperopt_tpu/tpe.py``'s ``jnp.cumsum`` path) on the same masks;
* the step's column groups call the op with both sets, so the step keeps
  its bits;
* the library declares the entry point, and the capture-purity analyzer
  finds ``set_weights`` among the port's captured entry points.
"""

import ctypes
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import tpe as jtpe
from hyperopt_tpu.space import compile_space as compile_j
from hyperopt_tpu_torch import tpe
from hyperopt_tpu_torch.ops import ei_scores as ei_mod
from hyperopt_tpu_torch.ops import set_weights as sw_mod
from hyperopt_tpu_torch.space import compile_space
from test_torch_analysis import ROOT, port
from test_torch_tpe import _history, flagship


def _masks(lanes, n, c, density, seed):
    rng = np.random.default_rng(seed)
    below = rng.random((lanes, n)) < density
    above = ~below & (rng.random((lanes, n)) < 0.9)
    act = rng.random((lanes, n, c)) < max(density, 0.5)
    return (torch.as_tensor(below), torch.as_tensor(above),
            torch.as_tensor(act))


def _ramp_by_element(set_mask, act, lf):
    """``(w, n_set)`` of one lane, row by row in numpy float32 scalars."""
    n, c = act.shape
    f = np.float32
    w = np.zeros((n, c), np.float32)
    n_set = np.zeros(c, np.int64)
    for j in range(c):
        rows = [i for i in range(n) if set_mask[i] and act[i, j]]
        n_obs = f(len(rows))
        n_ramp = max(n_obs - f(lf), f(0))
        a = f(1) / max(n_obs, f(1))
        denom = max(n_ramp - f(1), f(1))
        for rank, i in enumerate(rows):
            w[i, j] = (a + (f(1) - a) * f(rank) / denom
                       if f(rank) < n_ramp else f(1))
        n_set[j] = len(rows)
    return w, n_set


CASES = [(1, 32, 1, 0.3, 25), (3, 64, 11, 0.01, 1), (2, 100, 31, 0.3, 25),
         (1, 257, 2, 1.0, 25), (2, 48, 5, 0.0, 25), (1, 40, 3, 1.0, 1000),
         (2, 200, 4, 0.6, 7)]


@pytest.mark.parametrize("lanes, n, c, density, lf", CASES)
def test_twin_equals_the_elementwise_ramp(lanes, n, c, density, lf):
    below, above, act = _masks(lanes, n, c, density, seed=n + c)
    got = sw_mod.set_weights(below, above, act, lf)
    assert len(got) == 2
    for set_mask, (m, w, n_set) in zip((below, above), got):
        assert m.dtype == torch.bool and w.dtype == torch.float32
        assert n_set.dtype == torch.int64
        assert torch.equal(m, set_mask[..., None] & act)
        for j in range(lanes):
            want_w, want_n = _ramp_by_element(set_mask[j].numpy(),
                                              act[j].numpy(), lf)
            assert np.array_equal(w[j].numpy().view(np.int32),
                                  want_w.view(np.int32))
            assert np.array_equal(n_set[j].numpy(), want_n)


@pytest.mark.parametrize("lanes, n, c, density, lf", CASES)
def test_twin_equals_the_jax_steps_ranks_and_weights(lanes, n, c, density,
                                                     lf):
    below, above, act = _masks(lanes, n, c, density, seed=7 * n + c)
    got = sw_mod.set_weights(below, above, act, lf)
    jax_self = SimpleNamespace(lf=lf)
    for set_mask, (m, w, n_set) in zip((below, above), got):
        for j in range(lanes):
            jm, jw, jn = jtpe._TpeKernel._set_weights(
                jax_self, jnp.asarray(set_mask[j].numpy()),
                jnp.asarray(act[j].numpy()))
            assert np.array_equal(np.asarray(jm), m[j].numpy())
            assert np.array_equal(np.asarray(jn), n_set[j].numpy())
            assert np.array_equal(np.asarray(jw, np.float32).view(np.int32),
                                  w[j].numpy().view(np.int32))
            # The rank: the JAX step's inclusive cumsum less one, where the
            # set holds; the weights order the same way.
            rank = np.cumsum(np.asarray(jm), axis=0) - 1
            for col in range(c):
                rows = np.flatnonzero(np.asarray(jm)[:, col])
                assert list(rank[rows, col]) == list(range(len(rows)))


def test_twin_is_todays_composition():
    """The twin is ``torch.cumsum`` of the mask and ``forgetting_weights``:
    the same tensors whatever leading shape (no lane axis, one, two)."""
    below, above, act = _masks(4, 96, 6, 0.3, seed=3)
    whole = sw_mod.set_weights(below, above, act, 25)
    solo = sw_mod.set_weights(below[1], above[1], act[1], 25)
    nested = sw_mod.set_weights(below.view(2, 2, 96), above.view(2, 2, 96),
                                act.view(2, 2, 96, 6), 25)
    for s in range(2):
        for k in range(3):
            assert torch.equal(solo[s][k], whole[s][k][1])
            assert torch.equal(nested[s][k].flatten(0, 1), whole[s][k])


def test_cpu_takes_the_twin_and_loads_nothing(monkeypatch):
    def no_build():
        raise AssertionError("a CPU call built the kernel library")

    monkeypatch.setattr(ei_mod, "build", no_build)
    libs = dict(ei_mod._libs)
    calls = []
    twin = sw_mod.set_weights_reference
    monkeypatch.setattr(sw_mod, "set_weights_reference",
                        lambda *a: calls.append(a) or twin(*a))
    launches = (sw_mod.set_weights.launches, sw_mod.set_weights.recorded_by)
    below, above, act = _masks(2, 64, 3, 0.3, seed=1)
    sw_mod.set_weights(below, above, act, 25)
    assert len(calls) == 2
    assert calls[0][0] is below and calls[1][0] is above
    assert dict(ei_mod._libs) == libs
    assert (sw_mod.set_weights.launches,
            sw_mod.set_weights.recorded_by) == launches


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("available", [False, True])
def test_cuda_tensors_never_fall_back(monkeypatch, available, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(ei_mod, "_libs", {})
    monkeypatch.setattr(ei_mod, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(ei_mod, "_nvcc", lambda: "/nonexistent/nvcc")

    def _fallback(*a, **kw):
        raise AssertionError("a CUDA tensor reached the twin")

    monkeypatch.setattr(sw_mod, "set_weights_reference", _fallback)
    t = [torch.Tensor._make_subclass(_ClaimsCuda, x)
         for x in _masks(1, 32, 2, 0.3, seed=2)]
    launches = sw_mod.set_weights.launches
    with pytest.raises((RuntimeError, OSError)):
        sw_mod.set_weights(*t, 25)
    assert sw_mod.set_weights.launches == launches


@pytest.mark.parametrize("bad", ["lead", "rows", "device"])
def test_shapes_and_devices_are_checked(bad):
    below, above, act = _masks(2, 32, 3, 0.3, seed=4)
    if bad == "lead":
        below = below[:1]
    elif bad == "rows":
        above = above[:, :16]
    else:
        below = torch.Tensor._make_subclass(_ClaimsCuda, below)
    with pytest.raises(ValueError):
        sw_mod.set_weights(below, above, act, 25)


def test_the_step_calls_the_op(monkeypatch):
    """The step calls the op once per column group with both sets: the
    flagship space's continuous groups (31 density and 11 lattice columns)
    and its 12 choices make 3 calls a step, each on ``[L, N, C]`` masks."""
    csj, cst = compile_j(flagship(hj, 50)), compile_space(flagship(ht, 50))
    n_cap = 64
    hist = [torch.as_tensor(a) for a in tpe._padded_history(
        _history(csj, 40, 0), n_cap)]
    kern = tpe.get_kernel(cst, n_cap, 24, 25, device="cpu")
    calls = []
    op = tpe.set_weights

    def spy(below, above, act, lf):
        calls.append((tuple(below.shape), tuple(act.shape), lf))
        return op(below, above, act, lf)

    monkeypatch.setattr(tpe, "set_weights", spy)
    kern(*hist, 0.25, 1.0, generator=torch.Generator().manual_seed(1))
    assert sorted(shape[-1] for _, shape, _ in calls) == [11, 12, 31]
    assert all(b == (1, n_cap) and a[:2] == (1, n_cap) and lf == 25
               for b, a, lf in calls)


def test_the_library_declares_its_entry_point():
    assert ei_mod._SOURCES["set_weights"].name == "set_weights.cu"
    lib, args = ei_mod._ARGTYPES["set_weights_launch"]
    assert lib == "set_weights"
    assert args == [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    src = ei_mod._SOURCES["set_weights"].read_text()
    assert 'extern "C" int set_weights_launch(' in src
    # Every float operation of the weights is an explicit round-to-nearest
    # intrinsic: no bare float arithmetic for nvcc to contract.
    for op in ("__fsub_rn", "__fdiv_rn", "__fmul_rn", "__fadd_rn"):
        assert op in src


def test_capture_purity_finds_the_entry_point():
    analysis = port()
    cpm = analysis.CHECKERS["capture-purity"][0]
    project = analysis.Project.from_dir(str(ROOT))
    module = project.module("hyperopt_tpu_torch/ops/set_weights.py")
    index = cpm._ModuleIndex(module)
    assert [cpm._fn_name(n, c) for n, c, _k, _o in cpm._entry_points(index)
            ] == ["set_weights"]
    reached = {cpm._fn_name(n, c)
               for n, c, _k, outer in cpm._reachable(
                   index, cpm._entry_points(index)).values()
               if outer is None}
    assert {"set_weights", "_launch"} <= reached
    assert not [f for f in cpm.check(project)
                if f.file == "hyperopt_tpu_torch/ops/set_weights.py"]

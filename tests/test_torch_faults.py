"""Fault injection in the PyTorch port (``hyperopt_tpu_torch/faults.py``),
mirroring the registry half of ``tests/test_faults.py`` and held against
the JAX package's ``faults.py``:

* the same ``configure(spec, seed)`` fires at the same call indices for
  every fault point in both packages (the per-point seeded
  ``random.Random`` makes this exact; tolerance: none, equality), for the
  dict and the string form of the spec;
* ``injected`` scopes a schedule and restores the previous one on exit;
* each injection bumps ``faults.injected.<point>`` and emits a
  ``fault_injected`` event;
* ``objective.call`` raises ``InjectedFault`` from the port's
  ``Domain.evaluate``, and through ``fmin`` on the CPU.
"""

import numpy as np
import pytest
import torch

from hyperopt_tpu import faults as faults_j
import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import faults
from hyperopt_tpu_torch.base import Domain
from hyperopt_tpu_torch.exceptions import InjectedFault
from hyperopt_tpu_torch.obs import metrics
from hyperopt_tpu_torch.obs.events import EVENTS

hp = ht.hp


@pytest.fixture(autouse=True)
def _disarmed():
    """No schedule leaks in or out (both registries are process-global);
    the event ring is left as it was found."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    faults.clear()
    faults_j.clear()
    was = EVENTS.enabled
    yield
    faults.clear()
    faults_j.clear()
    if not was:
        EVENTS.disable()
    EVENTS.clear()
    torch.set_num_threads(n)


def _counter(name):
    return metrics.registry().snapshot()["counters"].get(name, 0.0)


def _fired(mod, error, point, n):
    """Call indices (1-based) at which ``mod.maybe_fail(point)`` raised."""
    out = []
    for k in range(1, n + 1):
        try:
            mod.maybe_fail(point)
        except error:
            out.append(k)
    return out


@pytest.mark.parametrize("point", sorted(faults_j.FAULT_POINTS))
@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_same_schedule_fires_at_same_calls_as_jax(point, seed):
    from hyperopt_tpu.exceptions import InjectedFault as InjectedFaultJ

    spec = {point: {"prob": 0.35, "times": 9, "after": 2}}
    faults.configure(spec, seed=seed)
    faults_j.configure(spec, seed=seed)
    got = _fired(faults, InjectedFault, point, 80)
    want = _fired(faults_j, InjectedFaultJ, point, 80)
    assert got == want and 0 < len(got) <= 9
    assert faults.injection_counts() == faults_j.injection_counts()


def test_string_spec_matches_jax():
    from hyperopt_tpu.exceptions import InjectedFault as InjectedFaultJ

    spec = "rpc.send=0.3, objective.call=0.5:4@3, flight.dump=1.0:2"
    faults.configure(spec, seed=11)
    faults_j.configure(spec, seed=11)
    assert set(faults.injection_counts()) == {"rpc.send", "objective.call",
                                              "flight.dump"}
    for point in ("objective.call", "rpc.send", "flight.dump"):
        assert _fired(faults, InjectedFault, point, 40) == \
            _fired(faults_j, InjectedFaultJ, point, 40)
    assert faults.injection_counts() == faults_j.injection_counts()
    faults.configure("")
    assert not faults.is_active()


@pytest.mark.parametrize("bad", ["rpc.send", "rpc.send=x", "a=0.5:z",
                                 "a=1.5"])
def test_bad_spec_rejected(bad):
    with pytest.raises(ValueError):
        faults.configure(bad)


def test_disabled_is_noop_and_catalog_matches_jax():
    assert faults.FAULT_POINTS == faults_j.FAULT_POINTS
    assert not faults.is_active()
    for p in faults.FAULT_POINTS:
        faults.maybe_fail(p)


def test_point_streams_independent():
    def pattern_b(extra_a_calls):
        faults.configure({"a": 0.5, "b": 0.5}, seed=7)
        for _ in range(extra_a_calls):
            try:
                faults.maybe_fail("a")
            except InjectedFault:
                pass
        return _fired(faults, InjectedFault, "b", 40)

    assert pattern_b(0) == pattern_b(25)


def test_injected_scopes_and_restores():
    faults.configure({"rpc.send": 1.0}, seed=0)
    with faults.injected("objective.call", prob=1.0):
        with pytest.raises(InjectedFault):
            faults.maybe_fail("objective.call")
        faults.maybe_fail("rpc.send")        # outer schedule suspended
    with pytest.raises(InjectedFault):
        faults.maybe_fail("rpc.send")        # outer schedule restored
    faults.maybe_fail("objective.call")      # inner schedule gone
    faults.clear()
    with faults.injected("objective.call", prob=1.0, times=1):
        assert faults.is_active()
    assert not faults.is_active()            # cleared on exit


def test_counter_and_event_on_injection():
    EVENTS.enable()
    before = _counter("faults.injected.store.write")
    total = _counter("faults.injected")
    n_ev = sum(e["type"] == "fault_injected" for e in EVENTS.snapshot())
    faults.configure({"store.write": 1.0})
    with pytest.raises(InjectedFault) as ei:
        faults.maybe_fail("store.write", tid=3)
    assert ei.value.point == "store.write" and ei.value.call_no == 1
    assert _counter("faults.injected.store.write") == before + 1
    assert _counter("faults.injected") == total + 1
    evs = [e for e in EVENTS.snapshot() if e["type"] == "fault_injected"]
    assert len(evs) == n_ev + 1
    assert evs[-1]["name"] == "store.write" and evs[-1]["trial"] == 3
    assert evs[-1]["call_no"] == 1


def test_objective_call_raises_from_domain_evaluate():
    calls = []

    def obj(p):
        calls.append(p)
        return float(p["x"])

    dom = Domain(obj, {"x": hp.uniform("x", 0, 1)})
    with faults.injected("objective.call", prob=1.0, times=1, after=1):
        assert dom.evaluate({"x": 0.5}, None)["loss"] == 0.5
        with pytest.raises(InjectedFault) as ei:
            dom.evaluate({"x": 0.25}, None)
        assert ei.value.point == "objective.call"
        assert dom.evaluate({"x": 0.75}, None)["loss"] == 0.75
    assert len(calls) == 2        # the fault fires before the objective


def test_objective_fault_through_fmin():
    t = ht.Trials()
    with faults.injected("objective.call", prob=1.0, after=3):
        with pytest.raises(InjectedFault):
            ht.fmin(lambda p: p["x"] ** 2, {"x": hp.uniform("x", -1, 1)},
                    algo=ht.rand.suggest, max_evals=8, trials=t,
                    rstate=np.random.default_rng(0), show_progressbar=False,
                    device="cpu")
    states = [d["state"] for d in t.trials]
    assert states[:3] == [ht.JOB_STATE_DONE] * 3
    assert states[3] == ht.JOB_STATE_ERROR
    assert t.trials[3]["misc"]["error"][0] == "InjectedFault"

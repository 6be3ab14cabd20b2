"""Landing of the PyTorch port: ``base.docs_from_samples`` and the fleet's
segment lander (``device._land_lanes``), on the CPU.

* ``docs_from_samples`` on the flagship space (``portbench/spaces/
  flagship.py`` at ``n_dims`` 50: lattice, choice, log, integer and a
  conditional branch with inactive parameters) gives, for float32 and
  float64 rows and with an ``exp_key``, the documents of a per-element
  reference written here: equal value for value, key order included, and
  every value a plain ``int`` (integer kinds) or ``float``, no numpy
  scalar.
* ``fmin_fleet(trials_list=...)`` leaves the cyclic collector as it found
  it: on stays on, off (the caller's) stays off and counts no held
  segment; an ``insert_trial_docs`` that raises still turns it back on.
  ``land_gc_held`` and its registry twin move once per landed segment.
"""

import gc
import os
import sys

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import base, device, fleet
from hyperopt_tpu_torch.obs import metrics
from hyperopt_tpu_torch.space import compile_space

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.spaces import flagship  # noqa: E402

CPU = "cpu"
FLEET_SPACE = {"x": ht.hp.uniform("x", -3.0, 3.0),
               "c": ht.hp.choice("c", [0.0, 1.0])}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def gc_restored():
    was = gc.isenabled()
    yield
    if was:
        gc.enable()
    else:
        gc.disable()


def _reference_docs(cs, new_ids, vals, active, exp_key):
    """The documents, one numpy element at a time."""
    docs = []
    for row, tid in enumerate(new_ids):
        idxs_d, vals_d = {}, {}
        for spec in cs.params:
            if active[row, spec.pid]:
                v = vals[row, spec.pid]
                idxs_d[spec.label] = [tid]
                vals_d[spec.label] = [int(round(float(v))) if spec.is_int
                                      else float(v)]
            else:
                idxs_d[spec.label] = []
                vals_d[spec.label] = []
        docs.append({
            "state": base.JOB_STATE_NEW, "tid": tid, "spec": None,
            "result": {"status": base.STATUS_NEW},
            "misc": {"tid": tid, "cmd": None, "idxs": idxs_d,
                     "vals": vals_d},
            "exp_key": exp_key, "owner": None, "version": 0,
            "book_time": None, "refresh_time": None})
    return docs


def _ordered(x):
    """``x`` with every dict as its list of items, so that ``==`` also
    compares key order."""
    if isinstance(x, dict):
        return [(k, _ordered(v)) for k, v in x.items()]
    if isinstance(x, list):
        return [_ordered(v) for v in x]
    return x


def _leaf_types(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaf_types(v)
    elif isinstance(x, list):
        for v in x:
            yield from _leaf_types(v)
    else:
        yield type(x)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_docs_match_per_element_reference(dtype):
    cs = compile_space(flagship.build(ht.hp, 50))
    assert cs.n_params == 53
    vals, active = cs.sample(40, generator=torch.Generator().manual_seed(5),
                            device=CPU)
    vals = np.asarray(vals.cpu(), dtype)
    active = np.asarray(active.cpu())
    # Integer values a ulp off the lattice still land on it.
    ints = [p.pid for p in cs.params if p.is_int]
    vals[:, ints] = np.nextafter(np.round(vals[:, ints]), -np.inf)
    assert 0 < active.sum() < active.size  # the branch leaves some off
    ids = list(range(100, 140))
    got = base.docs_from_samples(cs, ids, vals, active, exp_key="lane-3")
    want = _reference_docs(cs, ids, vals, active, "lane-3")
    assert _ordered(got) == _ordered(want)
    for doc in got:
        for label, (v,) in ((k, v) for k, v in doc["misc"]["vals"].items()
                            if v):
            assert type(v) is (int if cs.by_label[label].is_int else float)
        assert set(_leaf_types(doc["misc"])) <= {int, float, type(None)}
    # The columns are computed once per space.
    assert base._doc_columns(cs) is base._doc_columns(cs)


def _fleet_obj(p):
    return torch.abs(p["x"] - 1.0) + p["c"]


def _run_fleet(trials_list, n=12, stride=4):
    return fleet.fmin_fleet(_fleet_obj, FLEET_SPACE,
                            n_lanes=len(trials_list), max_evals=n, seed=7,
                            sync_stride=stride, trials_list=trials_list,
                            device=CPU, n_EI_candidates=16,
                            n_startup_jobs=4)


def _twin():
    return metrics.registry().counter("device.land_gc_held").value


@pytest.mark.parametrize("enabled", [True, False])
def test_fleet_landing_restores_the_collector(enabled, gc_restored):
    on = metrics.metrics_enabled()
    metrics.set_enabled(True)
    try:
        tl = [ht.Trials() for _ in range(3)]
        h0, t0 = device.land_gc_held, _twin()
        (gc.enable if enabled else gc.disable)()
        _run_fleet(tl)
        assert gc.isenabled() is enabled
        held = 3 if enabled else 0  # 12 trials in segments of 4
        assert device.land_gc_held - h0 == held
        assert _twin() - t0 == held
        assert [len(t.trials) for t in tl] == [12, 12, 12]
    finally:
        metrics.set_enabled(on)


class _RaisingTrials(ht.Trials):
    def insert_trial_docs(self, docs):
        raise RuntimeError("store refused the docs")


def test_collector_back_on_after_a_failed_landing(gc_restored):
    gc.enable()
    h0 = device.land_gc_held
    with pytest.raises(RuntimeError, match="store refused"):
        _run_fleet([ht.Trials(), _RaisingTrials()])
    assert gc.isenabled()
    assert device.land_gc_held == h0


def test_held_landing_lands_what_lane_by_lane_lands(gc_restored):
    cs = compile_space(flagship.build(ht.hp, 50))
    g = torch.Generator().manual_seed(11)
    rows = [cs.sample(8, generator=g, device=CPU) for _ in range(3)]
    vals = np.stack([np.asarray(v.cpu(), np.float32) for v, _ in rows])
    acts = np.stack([np.asarray(a.cpu()) for _, a in rows])
    losses = np.asarray([[0.5, np.inf, 2.0, np.nan, 1.0, 3.0, 4.0, 5.0]] * 3,
                        np.float32)
    held = [ht.Trials(exp_key=f"e{j}") for j in range(3)]
    plain = [ht.Trials(exp_key=f"e{j}") for j in range(3)]
    gc.enable()
    device._land_lanes(held, cs, vals, acts, losses)
    assert gc.isenabled()
    for j, t in enumerate(plain):
        device._land(t, cs, vals[j], acts[j], losses[j])
    for a, b in zip(held, plain):
        strip = ("book_time", "refresh_time")
        da = [{k: v for k, v in d.items() if k not in strip}
              for d in a._dynamic_trials]
        db = [{k: v for k, v in d.items() if k not in strip}
              for d in b._dynamic_trials]
        assert repr(_ordered(da)) == repr(_ordered(db))

"""Device-mode telemetry of the PyTorch port (``obs/devtel.py`` and the slab
columns of ``device._Segment``), mirroring ``tests/test_device_telemetry.py``,
on the CPU, where the captured step runs eagerly:

* armed and disarmed runs land bit-identical trials (tolerance: none,
  equality), with equal ``fetch_syncs`` and ``segments`` deltas: the slab
  rides the existing fetch; the switch keys the graph cache;
* the slab equals the JAX package's device-mode slab on the problem
  ``tests/test_torch_device.py`` runs against it (3 EI candidates, so the
  uniforms decide the rows), here with an objective that is non-finite on
  part of the space: ``best_loss``, ``best_trajectory``, ``tpe_steps``,
  ``nonfinite`` and ``argmax_ties`` equal, ``ei_max`` and ``ei_sum``
  within rtol 1e-4;
* ``fmin_fleet`` lanes' slabs equal their solo runs' slabs bit for bit,
  segment by segment, and their per-lane ``telemetry``;
* the slab's host reduction matches a direct count over the landed docs
  with startup trials and non-finite losses in the segments;
* one armed run reaches every layer (``test_solo_backfill_reaches_every_
  layer``); disarmed is a metrics and events no-op;
* lane stacks show in ``obs.device`` while ``fmin_fleet`` runs and are
  gone after; a history reorder emits its typed event;
  ``fmin(mode="device", trace_dir=)`` traces the segments;
* the armed step makes no host round trip (the capture's rule).
"""

import json
import math
import os
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import tpe as tpe_j
from hyperopt_tpu.obs import devtel as devtel_j
from hyperopt_tpu.space import compile_space as compile_j
from hyperopt_tpu.space import prng_key
from hyperopt_tpu_torch import convert, device, fleet, tpe
from hyperopt_tpu_torch import history as rhist
from hyperopt_tpu_torch.obs import bundle, costs, devtel, trace
from hyperopt_tpu_torch.obs import device as obs_device
from hyperopt_tpu_torch.obs.events import EVENTS
from hyperopt_tpu_torch.obs.metrics import registry
from hyperopt_tpu_torch.space import compile_space
from test_torch_device import (_flagship_objective, _no_host_round_trips,
                               qcat_host, qcat_space)
from test_torch_tpe import _jax_step_uniforms, flagship

hp = ht.hp
CPU = "cpu"
SLAB_KEYS = ("best_loss", "ei_max", "ei_sum", "tpe_steps", "nonfinite",
             "argmax_ties", "best_trajectory")


@pytest.fixture(autouse=True)
def _clean_state():
    """Two intra-op threads; the event ring, the ledger and the switch
    left as they were found."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    was = EVENTS.enabled
    yield
    devtel.set_enabled(True)
    devtel.set_backfill_store(None)
    costs.disarm()
    costs.clear()
    if not was:
        EVENTS.disable()
    EVENTS.clear()
    torch.set_num_threads(n)


SPACE = {"x": hp.uniform("x", -5, 5)}


def dev_obj(p):
    d = p["x"] - 3.0
    return d * d


N = 16
ALGO = partial(tpe.suggest, n_startup_jobs=5)


def _snap():
    return registry().snapshot()


def _counter(name):
    return _snap()["counters"].get(name, 0.0)


def _gauge(name):
    return _snap()["gauges"].get(name)


def _hist_count(name):
    return _snap()["histograms"].get(name, {}).get("count", 0)


def _run(seed, stride, n=N, fn=dev_obj, space=SPACE, algo=ALGO):
    t = ht.Trials()
    ht.fmin(fn, space, algo=algo, max_evals=n, trials=t,
            rstate=np.random.default_rng(seed), show_progressbar=False,
            device=CPU, mode="device", sync_stride=stride)
    return t


def _rows(t):
    return [(d["tid"], {k: tuple(map(float, v))
                        for k, v in sorted(d["misc"]["vals"].items())},
             float(d["result"]["loss"])) for d in t._dynamic_trials]


def _device_events():
    return [e for e in EVENTS.snapshot()
            if e.get("name") in ("device_segment", "device_trial")]


def _record_slabs(monkeypatch, mod):
    """Record every slab ``mod.backfill_segment`` receives, by mode."""
    seen = []
    orig = mod.backfill_segment

    def spy(reg, **kw):
        seen.append((kw["mode"], kw["slab_h"]))
        return orig(reg, **kw)

    monkeypatch.setattr(mod, "backfill_segment", spy)
    return seen


# ---------------------------------------------------------------------------
# armed against disarmed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride", [None, 4])
def test_armed_and_disarmed_land_identical_trials(stride):
    fn = lambda p: (p["x"] - 1.5) * (p["x"] - 1.5)  # noqa: E731
    rows, counts = {}, {}
    for armed in (True, False):
        devtel.set_enabled(armed)
        f0, s0, m0 = device.fetch_syncs, device.segments, \
            device.run_cache_misses
        rows[armed] = _rows(_run(7, stride, fn=fn))
        counts[armed] = (device.fetch_syncs - f0, device.segments - s0)
        # The switch keys the graph cache: each arm builds its own step.
        assert device.run_cache_misses - m0 == 1
    assert rows[True] == rows[False] and len(rows[True]) == N
    assert counts[True] == counts[False] == (N // (stride or N),) * 2
    segs = [seg for f, seg in compile_space(SPACE)._device_runs.values()
            if f is fn]
    assert sorted(seg.telemetry for seg in segs) == [False, True]


def test_fetch_slab_rides_one_fetch():
    cs = compile_space(SPACE)
    kern = tpe.get_kernel(cs, 32, 24, 25, device=CPU)
    seg = device._build_segment(cs, kern, device._wrap_objective(dev_obj, cs),
                                3, 0.25, 1.0, telemetry=True)
    z = np.zeros((0, 1), np.float32)
    seg.load(z, z.astype(bool), z[:, 0], z[:, 0].astype(bool), z[:, 0],
             limit=8)
    seg.run(np.arange(8))
    f0 = device.fetch_syncs
    vals, act, raw, i, (eib, ties) = seg.fetch_slab(0, 8)
    assert device.fetch_syncs - f0 == 1 and int(i[0]) == 8
    assert eib.shape == ties.shape == raw.shape == (1, 8)
    # Every replay's TPE arm ran, startup trials included (the host masks
    # them): on the empty history all 24 candidates score alike, 23 ties.
    assert np.isfinite(eib).all() and (ties >= 0).all()
    assert ties[0, 0] == 23 and ties.dtype == np.int64
    got = seg.fetch(0, 8)
    assert len(got) == 4 and np.array_equal(got[2], raw)


# ---------------------------------------------------------------------------
# against the JAX package's device mode
# ---------------------------------------------------------------------------


def qcat_inf_jax(p):
    return jnp.where(p["q"] >= 12.0, jnp.inf,
                     jnp.abs(p["q"] - 6.0) + jnp.where(p["c"] > 0,
                                                       p["depth"], 0.0))


def qcat_inf_dev(p):
    return torch.where(p["q"] >= 12.0, math.inf,
                       torch.abs(p["q"] - 6.0) + torch.where(
                           p["c"] > 0, p["depth"], 0.0))


def test_slab_matches_jax_device_mode(monkeypatch):
    """Both packages resume from the same 24 DONE trials of the qcat
    domain, then run 8 device-mode trials at ``sync_stride=4`` under one
    rstate, the port's with the uniforms of JAX's per-trial keys; the
    objective is ``inf`` for q ≥ 12.  The two segments' slabs agree."""
    n, n_cand, stride = 32, 3, 4
    jax_slabs = _record_slabs(monkeypatch, devtel_j)
    space_j = qcat_space(hj)
    tj = hj.Trials()
    # A random-search history: the segment is what is compared, and JAX's
    # hosted TPE step would add seconds of compiling to the test.
    hj.fmin(qcat_host, space_j, algo=hj.rand.suggest, max_evals=24,
            trials=tj, rstate=np.random.default_rng(3),
            show_progressbar=False)
    tt = convert.trials_from_jax_docs(tj)
    hj.fmin(qcat_inf_jax, space_j,
            algo=partial(tpe_j.suggest, n_EI_candidates=n_cand),
            max_evals=n, trials=tj, rstate=np.random.default_rng(11),
            show_progressbar=False, mode="device", sync_stride=stride)
    assert [m for m, _ in jax_slabs] == ["solo", "solo"]

    csj, cst = compile_j(space_j), compile_space(qcat_space(ht))
    kj = tpe_j.get_kernel(csj, 32, n_cand, 25)
    kt = tpe.get_kernel(cst, 32, n_cand, 25, device=CPU)
    rng = np.random.default_rng(11)
    seeds = [int(rng.integers(2 ** 31 - 1)) for _ in range(n - 24)]
    h = tt.history(cst)
    seg = device._build_segment(
        cst, kt, device._wrap_objective(qcat_inf_dev, cst), 20, 0.25, 1.0,
        telemetry=True)
    seg.load(h["vals"], h["active"], h["loss"], h["ok"], h["loss"], limit=n)
    n_ok, best = [int(h["ok"].sum())], [h["loss"][h["ok"]].min()]
    n_bad = 0
    for k, (i0, (_, want)) in enumerate(zip((24, 28), jax_slabs)):
        sl = seeds[4 * k:4 * k + 4]
        seg.run(sl, noises=[_jax_step_uniforms(prng_key(np.uint32(s)), kj)
                            for s in sl])
        _, _, losses, _, tel = seg.fetch_slab(i0, i0 + stride)
        got = devtel.slab_host(losses, *tel, n_ok, best, 20)
        n_ok = [n_ok[0] + int(np.isfinite(losses).sum())]
        best = got["best_loss"]
        for key in ("best_loss", "tpe_steps", "nonfinite", "argmax_ties"):
            assert got[key][0] == want[key], key
        np.testing.assert_array_equal(got["best_trajectory"][0],
                                      want["best_trajectory"])
        for key in ("ei_max", "ei_sum"):
            np.testing.assert_allclose(got[key][0], want[key], rtol=1e-4)
        n_bad += int(got["nonfinite"][0])
        assert got["tpe_steps"][0] == stride
    assert n_bad > 0, "the objective never went non-finite: a weak check"
    # The raw losses both packages landed are equal, infs included.
    np.testing.assert_array_equal(
        [d["result"]["loss"] for d in list(tj)[24:]],
        seg.fetch(24, n)[2][0])


def test_host_reduction_matches_the_landed_docs(monkeypatch):
    """Startup trials, then TPE; non-finite losses on part of the space.
    Per segment, the slab's counts and best-so-far follow from the docs:
    a trial is a TPE step when ``n_startup`` finite losses precede it."""
    slabs = _record_slabs(monkeypatch, devtel)
    fn = lambda p: torch.where(p["x"] > 2.0, math.nan,  # noqa: E731
                               (p["x"] + 1.0) * (p["x"] + 1.0))
    stride, n_startup, n = 8, 5, 40
    t = _run(2, stride, n=n, fn=fn,
             algo=partial(tpe.suggest, n_startup_jobs=n_startup))
    losses = np.asarray([d["result"]["loss"] for d in t], np.float32)
    fin = np.isfinite(losses)
    assert 0 < (~fin).sum() and fin.sum() > n_startup
    prior_ok = np.concatenate([[0], np.cumsum(fin)[:-1]])
    assert len(slabs) == n // stride
    for k, (mode, sl) in enumerate(slabs):
        seg = slice(k * stride, (k + 1) * stride)
        assert mode == "solo"
        assert sl["tpe_steps"][0] == (prior_ok[seg] >= n_startup).sum()
        assert sl["nonfinite"][0] == (~fin[seg]).sum()
        run_best = np.minimum.accumulate(np.where(fin, losses, np.inf))
        np.testing.assert_array_equal(sl["best_trajectory"][0][:stride],
                                      run_best[seg])
        assert np.isinf(sl["best_trajectory"][0][stride:]).all()
        assert sl["best_loss"][0] == run_best[seg][-1]
        if sl["tpe_steps"][0] == 0:
            assert sl["ei_max"][0] == -np.inf and sl["ei_sum"][0] == 0
            assert sl["argmax_ties"][0] == 0


def test_reservoir_downsamples_long_segments():
    s = 100
    losses = np.linspace(10, 1, s, dtype=np.float32)[None]
    losses[0, 50] = np.inf
    sl = devtel.slab_host(losses, np.zeros((1, s)), np.ones((1, s)), [0],
                          [np.inf], 0)
    traj = np.minimum.accumulate(np.where(np.isfinite(losses[0]),
                                          losses[0], np.inf))
    idx = ((np.arange(devtel.RESERVOIR) + 1) * s - 1) // devtel.RESERVOIR
    np.testing.assert_array_equal(sl["best_trajectory"][0], traj[idx])
    assert sl["tpe_steps"][0] == s and sl["argmax_ties"][0] == s
    assert sl["nonfinite"][0] == 1


# ---------------------------------------------------------------------------
# fleet lanes against solo runs
# ---------------------------------------------------------------------------


def test_fleet_lane_slabs_equal_solo_slabs(monkeypatch):
    slabs = _record_slabs(monkeypatch, devtel)
    lanes, n, stride, seed = 3, 24, 8, 4
    infos = fleet.fmin_fleet(dev_obj, SPACE, n_lanes=lanes, max_evals=n,
                             seed=seed, sync_stride=stride,
                             n_startup_jobs=5, device=CPU)
    fleet_slabs = [sl for m, sl in slabs if m == "fleet"]
    assert len(fleet_slabs) == n // stride
    for j in range(lanes):
        del slabs[:]
        t = _run(seed + j, stride, n=n)
        solo = [sl for m, sl in slabs if m == "solo"]
        assert len(solo) == len(fleet_slabs)
        for fs, ss in zip(fleet_slabs, solo):
            for key in SLAB_KEYS:
                assert np.array_equal(fs[key][j], ss[key][0]), key
        assert np.array_equal(
            infos[j]["losses"],
            np.asarray([d["result"]["loss"] for d in t], np.float32))
        tel = infos[j]["telemetry"]
        want = fleet._lane_telemetry(solo, 0)
        assert set(tel) == set(want)
        for key in want:
            assert np.array_equal(tel[key], want[key]), key
        assert tel["tpe_steps"] == n - 5
        assert tel["best_loss"] == infos[j]["best_loss"]


# ---------------------------------------------------------------------------
# one armed run reaches every layer
# ---------------------------------------------------------------------------


class _Store:
    """A stand-in for the service slice's time-series store."""

    def __init__(self):
        self.scrapes = []

    def scrape(self, now):
        self.scrapes.append(now)


def test_solo_backfill_reaches_every_layer():
    costs.arm()
    EVENTS.enable()
    store = _Store()
    devtel.set_backfill_store(store)
    stride, n_segs = 4, N // 4
    seg0 = _counter(f"device.segments.solo.{stride}")
    fs0 = _counter(f"device.fetch_syncs.solo.{stride}")
    u0 = _counter("device.fetch_syncs")
    h0 = _hist_count("device.telemetry.segment_ms")
    ev0 = len(_device_events())
    fn = lambda p: (p["x"] - 2.0) * (p["x"] - 2.0)  # noqa: E731
    t = _run(seed=21, stride=stride, fn=fn)

    assert _counter(f"device.segments.solo.{stride}") - seg0 == n_segs
    assert _counter(f"device.fetch_syncs.solo.{stride}") - fs0 == n_segs
    assert _counter("device.fetch_syncs") - u0 == n_segs

    best = _gauge("device.telemetry.best_loss")
    assert best == min(float(d["result"]["loss"]) for d in t)
    assert np.isfinite(_gauge("device.telemetry.ei_max"))
    assert np.isfinite(_gauge("device.telemetry.ei_mean"))
    assert _gauge("device.telemetry.trials_per_sec") > 0
    assert _hist_count("device.telemetry.segment_ms") - h0 == n_segs

    evs = _device_events()[ev0:]
    spans = [e for e in evs if e["type"] == "span_begin"]
    anchors = [e for e in evs if e["type"] == "trial_end"]
    assert len(spans) == n_segs and len(anchors) == N
    assert all(e.get("synthetic") is True for e in evs)
    assert all(e["mode"] == "solo" and e["stride"] == str(stride)
               for e in spans)
    assert {e["trial"] for e in anchors} == {d["tid"] for d in t}
    xs = [e for e in EVENTS.to_chrome_trace()["traceEvents"]
          if e.get("ph") == "X" and e.get("name") == "device_segment"]
    assert len(xs) >= n_segs and all(e["dur"] > 0 for e in xs)

    assert len(store.scrapes) == n_segs

    led = costs.ledger_report()
    key = repr(("device", "solo", stride))
    (row,) = [e for e in led["entries"]
              if e["kernel"] == "device" and e["key"] == key]
    assert row["compile_s"] > 0 and row["m"] == stride
    assert row["dispatches"] == n_segs
    assert "device.telemetry.segment_ms" in led["live_ms"]

    assert _gauge("health.verdict.device:solo") is not None

    sec = bundle.collect_payload("test")["device_telemetry"]
    assert sec["enabled"] is True and sec["reservoir"] == devtel.RESERVOIR
    run = [r for r in sec["runs"] if r["mode"] == "solo"][-1]
    assert run["n_trials"] == stride and run["n_lanes"] == 1
    traj = np.asarray(run["best_trajectory"], np.float64)
    filled = traj[np.isfinite(traj)]
    assert filled.size == stride and np.all(np.diff(filled) <= 0)


def test_disarmed_is_a_metrics_and_events_noop():
    devtel.set_enabled(False)
    EVENTS.enable()
    ev0 = len(_device_events())
    lab0 = _counter("device.segments.solo.8")
    u0 = _counter("device.segments")
    h0 = _hist_count("device.telemetry.segment_ms")
    _run(seed=22, stride=8)
    assert _counter("device.segments") - u0 == N // 8
    assert _counter("device.segments.solo.8") == lab0
    assert _hist_count("device.telemetry.segment_ms") == h0
    assert len(_device_events()) == ev0


# ---------------------------------------------------------------------------
# device memory, history events, capture safety
# ---------------------------------------------------------------------------


class _ProbeTrials(ht.Trials):
    """Samples the obs.device report at every landing, inside the run."""

    def __init__(self):
        self.samples = []
        super().__init__()
        self.samples.clear()

    def refresh(self):
        self.samples.append(obs_device.report())
        super().refresh()


def test_fleet_lane_stacks_visible_mid_run_then_freed():
    before = obs_device.report()
    tl = [_ProbeTrials(), _ProbeTrials()]
    seg0 = _counter("device.segments.fleet.4")
    infos = fleet.fmin_fleet(dev_obj, SPACE, n_lanes=2, max_evals=8, seed=4,
                             sync_stride=4, trials_list=tl,
                             n_startup_jobs=3, device=CPU)
    mid = [s for t in tl for s in t.samples]
    assert mid
    assert all(s["lane_stacks"] == before["lane_stacks"] + 1 for s in mid)
    assert all(s["lane_stack_bytes"] > before["lane_stack_bytes"]
               for s in mid)
    after = obs_device.report()
    assert after["lane_stacks"] == before["lane_stacks"]
    assert after["lane_stack_bytes"] == before["lane_stack_bytes"]
    assert _counter("device.segments.fleet.4") - seg0 == 2
    for info in infos:
        tel = info["telemetry"]
        assert tel["tpe_steps"] == 8 - 3 and np.isfinite(tel["ei_max"])
        assert tel["best_loss"] == pytest.approx(info["best_loss"])


def test_resident_rings_counted_and_registry_twins():
    before = obs_device.report()
    u0, r0 = rhist.upload_bytes, _counter("history.upload_bytes")
    t = ht.Trials()
    ht.fmin(lambda p: p["x"] ** 2, SPACE, algo=ALGO, max_evals=8, trials=t,
            rstate=np.random.default_rng(0), show_progressbar=False,
            device=CPU)
    rep = obs_device.collect()
    assert rep["resident_rings"] == before["resident_rings"] + 1
    assert rep["resident_bytes"] - before["resident_bytes"] == \
        32 * rhist._row_bytes(1)
    assert _gauge("device.hbm.resident_rings") == rep["resident_rings"]
    assert rhist.upload_bytes - u0 == \
        _counter("history.upload_bytes") - r0 > 0


def test_order_violation_emits_typed_event():
    EVENTS.enable()
    rng = np.random.default_rng(0)

    class _T:       # weakref-able stand-in for a Trials object
        pass

    def _h(n, tids):
        return dict(vals=rng.standard_normal((n, 3)).astype(np.float32),
                    active=np.ones((n, 3), bool),
                    loss=rng.standard_normal(n).astype(np.float32),
                    ok=np.ones(n, bool),
                    tids=np.asarray(list(tids), np.int64))

    trials, cs = _T(), object()
    h = _h(6, range(6))
    rhist.device_history(trials, cs, h, 16, device=CPU)
    swapped = {k: v.copy() for k, v in h.items()}
    swapped["tids"][2], swapped["tids"][4] = h["tids"][4], h["tids"][2]
    c0 = _counter("history.order_violations")
    with pytest.raises(rhist.HistoryOrderError):
        rhist.device_history(trials, cs, swapped, 16, device=CPU)
    assert _counter("history.order_violations") == c0 + 1
    rec = [e for e in EVENTS.snapshot()
           if e["type"] == "history_order_violation"][-1]
    assert rec["name"] == "resident_ring" and rec["n_resident"] == 6
    assert rec["positions"]


def test_armed_step_makes_no_host_round_trip():
    cs = compile_space(flagship(ht))
    kern = tpe.get_kernel(cs, 64, 128, 25, device=CPU)
    seg = device._build_segment(
        cs, kern, device._wrap_objective(_flagship_objective, cs), 20, 0.25,
        1.0, telemetry=True)
    vals, act = cs.sample(40, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    v = vals.numpy()
    loss = np.square(v[:, :2]).sum(1).astype(np.float32)
    seg.load(v, act.numpy(), loss, np.ones(40, bool), loss, limit=64)
    for g in seg.gens:
        g.manual_seed(3)
    with _no_host_round_trips():
        seg._step()
    assert int(seg.i) == 41
    assert math.isfinite(float(seg.eib[0, 40])) and int(seg.ties[0, 40]) >= 0


def test_device_mode_trace_dir_holds_the_segments(tmp_path):
    """``fmin(mode="device", trace_dir=)`` writes the trace dir, its event
    log holding one back-dated ``device_segment`` span per segment and a
    synthetic anchor per trial, and disarms the ring after."""
    ht.fmin(dev_obj, SPACE, algo=ALGO, max_evals=N, trials=ht.Trials(),
            rstate=np.random.default_rng(6), show_progressbar=False,
            device=CPU, mode="device", sync_stride=8, trace_dir=str(tmp_path))
    assert {"loop_trace.json", "loop_events.jsonl", "chrome_trace.json",
            trace.PROFILER_TRACE} <= set(os.listdir(tmp_path))
    evs = [json.loads(ln) for ln in open(tmp_path / "loop_events.jsonl")]
    assert sum(e["type"] == "span_begin" and e["name"] == "device_segment"
               for e in evs) == N // 8
    assert sum(e["type"] == "trial_end" and e.get("synthetic")
               for e in evs) == N
    assert not EVENTS.enabled

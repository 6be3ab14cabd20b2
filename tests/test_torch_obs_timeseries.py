"""The PyTorch port's windowed obs tier against hyperopt_tpu's.

Mirrors ``tests/test_obs_health.py::{TestTimeSeriesStore, TestOpenMetrics,
TestSloBurnRate}``: every scenario feeds the same synthetic samples (on a
synthetic clock) to both packages' registries, stores and monitors, checks
the JAX test's assertions on each, and asserts that the two give equal
windows, quantiles, burn rates, alert states and rendered OpenMetrics text
(the text to the byte: both packages export under the ``hyperopt_tpu_``
prefix).  Then the port's form of ``tests/test_device_telemetry.py::
test_solo_backfill_reaches_every_layer``: a device-mode run with a
``TimeSeriesStore`` registered leaves windowed series of every
backfilled layer.
"""

from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from hyperopt_tpu.obs import export as export_j
from hyperopt_tpu.obs.events import EventLog as EventLog_j
from hyperopt_tpu.obs.metrics import MetricsRegistry as Registry_j
from hyperopt_tpu.obs.slo import SloMonitor as SloMonitor_j
from hyperopt_tpu.obs.slo import SloSpec as SloSpec_j
from hyperopt_tpu.obs.slo import default_slos as default_slos_j
from hyperopt_tpu.obs.timeseries import TimeSeriesStore as Store_j
from hyperopt_tpu_torch import tpe
from hyperopt_tpu_torch.obs import devtel, export
from hyperopt_tpu_torch.obs.events import EVENTS, EventLog
from hyperopt_tpu_torch.obs.metrics import MetricsRegistry, registry
from hyperopt_tpu_torch.obs.slo import SloMonitor, SloSpec, default_slos
from hyperopt_tpu_torch.obs.timeseries import TimeSeriesStore

T0 = 1_000_000.0            # synthetic epoch, far from any real clock

JAX = SimpleNamespace(Store=Store_j, Registry=Registry_j, export=export_j,
                      SloMonitor=SloMonitor_j, SloSpec=SloSpec_j,
                      default_slos=default_slos_j, EventLog=EventLog_j)
TORCH = SimpleNamespace(Store=TimeSeriesStore, Registry=MetricsRegistry,
                        export=export, SloMonitor=SloMonitor,
                        SloSpec=SloSpec, default_slos=default_slos,
                        EventLog=EventLog)


def _reg(P):
    return P.Registry(enabled=True)


# -- time-series store --------------------------------------------------------


def counter_delta_and_rate(P):
    reg = _reg(P)
    ts = P.Store(reg)
    c = reg.counter("req")
    for i in range(5):
        c.inc(2)
        ts.scrape(now=T0 + i)
    out = (ts.n_scrapes, ts.delta("req", 4.0, now=T0 + 4),
           ts.rate("req", 4.0, now=T0 + 4), ts.delta("req", 4.0, now=T0),
           ts.delta("missing", 4.0, now=T0 + 4))
    assert out[:3] == (5, pytest.approx(8.0), pytest.approx(2.0))
    assert out[3] is None and out[4] is None
    return out


def tier_keeps_last_of_period(P):
    reg = _reg(P)
    ts = P.Store(reg, raw_cap=4, tiers=((10.0, 8),))
    g = reg.gauge("v")
    for i in range(30):
        g.set(float(i))
        ts.scrape(now=T0 + i)
    got = ts.samples("v", window_s=25.0, now=T0 + 29)
    assert [v for _, v in got] == [9.0, 19.0, 29.0]
    return got


def pick_samples_prefers_finest_ring(P):
    reg = _reg(P)
    ts = P.Store(reg, raw_cap=4, tiers=((1.0, 16), (10.0, 4)))
    g = reg.gauge("v")
    for i in range(12):
        g.set(float(i))
        ts.scrape(now=T0 + i)
    got = ts.samples("v", window_s=10.0, now=T0 + 11)
    assert len(got) == 11 and [v for _, v in got][:2] == [1.0, 2.0]
    return got


def windowed_histogram(P):
    reg = _reg(P)
    ts = P.Store(reg)
    h = reg.histogram("lat")
    for _ in range(8):
        h.observe(0.01)
    ts.scrape(now=T0)
    for _ in range(2):
        h.observe(0.5)
    ts.scrape(now=T0 + 10)
    win = ts.window_state("lat", 10.0, now=T0 + 10)
    full = ts.window_state("lat", 100.0, now=T0 + 10)
    out = (win, full,
           ts.window_frac_above("lat", 0.25, 10.0, now=T0 + 10),
           ts.window_quantile("lat", 0.5, 10.0, now=T0 + 10),
           ts.window_frac_above("lat", 0.25, 100.0, now=T0 + 10),
           ts.window_quantile("lat", 0.5, 100.0, now=T0 + 10))
    assert win["count"] == 2 and full["count"] == 10
    assert out[2] == pytest.approx(1.0) and 0.25 < out[3] <= 1.0
    assert out[4] == pytest.approx(0.2) and out[5] < 0.25
    return out


def scrape_self_telemetry(P):
    reg = _reg(P)
    ts = P.Store(reg)
    reg.counter("c").inc()
    ts.scrape(now=T0)
    snap = reg.snapshot(states=True)
    assert snap["gauges"]["obs.timeseries.series"] >= 1
    assert snap["gauges"]["obs.timeseries.bytes"] > 0
    assert snap["histograms"]["obs.timeseries.scrape_s"]["count"] == 1
    return (snap["gauges"]["obs.timeseries.series"],
            snap["gauges"]["obs.timeseries.samples"],
            snap["gauges"]["obs.timeseries.bytes"], ts.series_names())


def ingest_skew_and_merged_window(P):
    reg_r = _reg(P)
    ts_r = P.Store(reg_r)
    reg_r.histogram("netstore.verb.suggest.s").observe(0.1)
    reg_r.gauge("depth").set(3.0)
    ts_r.scrape(now=T0 + 5.0)
    dump = ts_r.export_series()
    reg_l = _reg(P)
    ts_l = P.Store(reg_l)
    for _ in range(3):
        reg_l.histogram("netstore.verb.suggest.s").observe(0.1)
    ts_l.scrape(now=T0)
    ts_l.ingest("w1", dump, skew_s=5.0)
    assert ts_l.samples("w1:depth", now=T0 + 1) == [(T0, 3.0)]
    merged = ts_l.merged_window_state(
        ["netstore.verb.suggest.s", "w1:netstore.verb.suggest.s"],
        60.0, now=T0 + 1)
    assert merged["count"] == 4
    return dump, merged


# -- OpenMetrics ---------------------------------------------------------------


def openmetrics_round_trip(P):
    reg = _reg(P)
    reg.counter("reqs").inc(3)
    reg.gauge("depth").set(2.5)
    h = reg.histogram("lat.s")
    for v in (0.01, 0.02, 0.3):
        h.observe(v)
    text = P.export.render_openmetrics(reg.snapshot(states=True))
    fams = P.export.parse_openmetrics(text)
    assert text.endswith("# EOF\n")
    assert fams["hyperopt_tpu_reqs"]["samples"] == [
        ("_total", {"scope": "local"}, 3.0)]
    assert fams["hyperopt_tpu_depth"]["samples"][0][2] == 2.5
    g = P.export.histogram_groups(
        fams["hyperopt_tpu_lat_s"])[(("scope", "local"),)]
    assert g["count"] == 3 and g["sum"] == pytest.approx(0.33)
    les, cums = zip(*sorted(g["buckets"]))
    assert les[-1] == float("inf") and cums[-1] == 3
    return text


def scraper_quantile_agrees_with_store(P):
    reg = _reg(P)
    ts = P.Store(reg)
    h = reg.histogram("lat.s")
    for v in (0.01, 0.02, 0.3, 0.5, 0.7):
        h.observe(v)
    ts.scrape(now=T0)
    fams = P.export.parse_openmetrics(
        P.export.render_openmetrics(reg.snapshot(states=True)))
    g = P.export.histogram_groups(
        fams["hyperopt_tpu_lat_s"])[(("scope", "local"),)]
    out = []
    for q in (0.5, 0.8, 0.95):
        out.append(P.export.histogram_quantile(g, q))
        assert out[-1] == ts.window_quantile("lat.s", q, 60.0, now=T0)
    return out


def fleet_scope_shares_the_family(P):
    reg = _reg(P)
    reg.counter("reqs").inc(1)
    reg.histogram("verb.s").observe(0.1)
    snap = reg.snapshot(states=True)
    merged_state = dict(snap["histograms"]["verb.s"]["state"])
    merged_state["counts"] = [c * 3 for c in merged_state["counts"]]
    merged_state["count"] *= 3
    merged_state["sum"] *= 3
    payload = dict(snap)
    payload["fleet"] = {"merged": {
        "counters": {"reqs": 7},
        "histograms": {"verb.s": {"state": merged_state}}}}
    text = P.export.render_openmetrics(payload)
    fams = P.export.parse_openmetrics(text)
    by_scope = {labels["scope"]: v for _, labels, v
                in fams["hyperopt_tpu_reqs"]["samples"]}
    assert by_scope == {"local": 1.0, "fleet": 7.0}
    groups = P.export.histogram_groups(fams["hyperopt_tpu_verb_s"])
    assert groups[(("scope", "local"),)]["count"] == 1
    assert groups[(("scope", "fleet"),)]["count"] == 3
    return text


def shared_names_disambiguate(P):
    reg = _reg(P)
    reg.counter("backend.es.dispatch_ms").inc(12.5)
    reg.histogram("backend.es.dispatch_ms").observe(12.5)
    reg.gauge("pipeline.occupancy").set(4.0)
    reg.histogram("pipeline.occupancy").observe(4.0)
    payload = dict(reg.snapshot(states=True))
    payload["fleet"] = {"merged": {
        "counters": {"backend.es.dispatch_ms": 25.0}}}
    text = P.export.render_openmetrics(payload)
    fams = P.export.parse_openmetrics(text)
    assert fams["hyperopt_tpu_backend_es_dispatch_ms"]["type"] == "histogram"
    cnt = fams["hyperopt_tpu_backend_es_dispatch_ms_cumulative"]
    assert {labels["scope"]: v for _, labels, v in cnt["samples"]} == \
        {"local": 12.5, "fleet": 25.0}
    assert fams["hyperopt_tpu_pipeline_occupancy_current"]["samples"] == \
        [("", {"scope": "local"}, 4.0)]
    return text


def strict_parser_rejections(P):
    bad = {"EOF": "# TYPE a counter\na_total 1\n",
           "no preceding TYPE": "orphan 1\n# EOF\n",
           "duplicate sample": "# TYPE a gauge\na 1\na 2\n# EOF\n",
           "cumulative": ("# TYPE h histogram\n"
                          'h_bucket{le="0.1"} 5\nh_bucket{le="+Inf"} 3\n'
                          "h_count 3\nh_sum 1\n# EOF\n"),
           "Inf": ("# TYPE h histogram\n"
                   'h_bucket{le="0.1"} 3\nh_count 3\nh_sum 1\n# EOF\n')}
    out = []
    for match, text in bad.items():
        with pytest.raises(ValueError, match=match) as ei:
            P.export.parse_openmetrics(text)
        out.append(str(ei.value))
    return out


def accept_negotiation(P):
    out = [P.export.wants_openmetrics(a) for a in
           ("application/openmetrics-text; version=1.0.0", "text/plain",
            "application/json", "", None)]
    assert out == [True, True, False, False, False]
    return out, P.export.CONTENT_TYPE


# -- SLO burn rates ------------------------------------------------------------


def spec_validation(P):
    out = []
    for kw, match in (({"kind": "availability"}, "kind"),
                      ({"budget": 0.0}, "budget")):
        with pytest.raises(ValueError, match=match) as ei:
            P.SloSpec("x", metric="m", **kw)
        out.append(str(ei.value))
    return out


def default_slo_names(P):
    specs = [(s.name, s.metric, s.kind, s.target, s.budget, s.fast_window,
              s.slow_window, s.burn_threshold) for s in P.default_slos()]
    assert [s[0] for s in specs] == \
        ["suggest_p95", "worker_liveness", "wal_fsync_lag"]
    return specs


def latency_slo_fires_then_clears(P):
    reg = _reg(P)
    ts = P.Store(reg)
    log = P.EventLog()
    log.enable()
    spec = P.SloSpec("suggest_p95", metric="netstore.verb.suggest.s",
                     kind="latency_p95", target=0.25, budget=0.25,
                     fast_window=10, slow_window=60)
    mon = P.SloMonitor((spec,), ts, reg=reg, events=log)
    h = reg.histogram("netstore.verb.suggest.s")
    out = []
    for i, (n, v) in enumerate(((4, 0.01), (8, 1.0), (6, 0.01))):
        for _ in range(n):
            h.observe(v)
        ts.scrape(now=T0 + 20 * i)
        (st,) = mon.evaluate(now=T0 + 20 * i)
        out.append(st)
    assert [s["firing"] for s in out] == [False, True, False]
    assert out[1]["burn_fast"] == pytest.approx(4.0)
    assert out[1]["burn_slow"] == pytest.approx((8 / 12) / 0.25)
    assert out[2]["burn_fast"] == pytest.approx(0.0)
    assert mon.alerts() == []
    snap = reg.snapshot()
    assert snap["counters"]["slo.alerts.fired"] == 1
    assert snap["counters"]["slo.alerts.resolved"] == 1
    assert snap["gauges"]["slo.suggest_p95.firing"] == 0.0
    states = [e["state"] for e in log.snapshot() if e["type"] == "slo_alert"]
    assert states == ["firing", "resolved"]
    return out, snap["gauges"]


def both_windows_must_corroborate(P):
    reg = _reg(P)
    ts = P.Store(reg)
    spec = P.SloSpec("suggest_p95", metric="m.s", kind="latency_p95",
                     target=0.25, budget=0.25, fast_window=10,
                     slow_window=60)
    mon = P.SloMonitor((spec,), ts, reg=reg, events=P.EventLog())
    h = reg.histogram("m.s")
    for _ in range(40):
        h.observe(0.01)
    ts.scrape(now=T0)
    for _ in range(4):
        h.observe(1.0)
    ts.scrape(now=T0 + 20)
    (st,) = mon.evaluate(now=T0 + 20)
    assert st["burn_fast"] >= 1.0 and st["burn_slow"] < 1.0
    assert st["firing"] is False
    return st


def gauge_min_slo(P):
    reg = _reg(P)
    ts = P.Store(reg)
    spec = P.SloSpec("worker_liveness", metric="fleet.live_fraction",
                     kind="gauge_min", target=0.9, budget=0.5,
                     fast_window=10, slow_window=40)
    mon = P.SloMonitor((spec,), ts, reg=reg, events=P.EventLog())
    g = reg.gauge("fleet.live_fraction")
    for t, v in ((0, 1.0), (1, 1.0), (15, 0.2), (16, 0.3)):
        g.set(v)
        ts.scrape(now=T0 + t)
    (fired,) = mon.evaluate(now=T0 + 16)
    assert fired["firing"] is True and fired["value"] == 0.3
    g.set(1.0)
    ts.scrape(now=T0 + 30)
    (cleared,) = mon.evaluate(now=T0 + 30)
    assert cleared["firing"] is False
    return fired, cleared


def empty_store_stays_quiet(P):
    mon = P.SloMonitor(P.default_slos(), P.Store(_reg(P)), reg=_reg(P),
                       events=P.EventLog())
    out = mon.evaluate(now=T0)
    for st in out:
        assert st["firing"] is False and st["burn_fast"] is None
    assert mon.alerts() == []
    return out


SCENARIOS = [counter_delta_and_rate, tier_keeps_last_of_period,
             pick_samples_prefers_finest_ring, windowed_histogram,
             scrape_self_telemetry, ingest_skew_and_merged_window,
             openmetrics_round_trip, scraper_quantile_agrees_with_store,
             fleet_scope_shares_the_family, shared_names_disambiguate,
             strict_parser_rejections, accept_negotiation, spec_validation,
             default_slo_names, latency_slo_fires_then_clears,
             both_windows_must_corroborate, gauge_min_slo,
             empty_store_stays_quiet]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_gives_the_jax_numbers(scenario):
    got = scenario(TORCH)
    want = scenario(JAX)
    assert got == want


# -- device-mode backfill -------------------------------------------------------


@pytest.fixture
def _clean_obs():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    was = EVENTS.enabled
    yield
    devtel.set_backfill_store(None)
    if not was:
        EVENTS.disable()
    EVENTS.clear()
    torch.set_num_threads(n)


def test_solo_backfill_reaches_every_layer(_clean_obs):
    """One armed device-mode run with a store registered: one back-dated
    scrape per sync boundary, and windowed series of the layers the
    boundary backfills (labeled counters, slab gauges, the segment
    histogram), readable over the run's window."""
    EVENTS.enable()
    reg = registry()
    ts = TimeSeriesStore(reg)
    devtel.set_backfill_store(ts)
    n, stride = 16, 4
    t = ht.Trials()
    ht.fmin(lambda p: (p["x"] - 3.0) ** 2, {"x": ht.hp.uniform("x", -5, 5)},
            algo=partial(tpe.suggest, n_startup_jobs=5), max_evals=n,
            trials=t, rstate=np.random.default_rng(21),
            show_progressbar=False, device="cpu", mode="device",
            sync_stride=stride)
    n_segs = n // stride
    assert ts.n_scrapes == n_segs
    names = set(ts.series_names())
    for name in (f"device.segments.solo.{stride}",
                 f"device.fetch_syncs.solo.{stride}",
                 "device.telemetry.best_loss", "device.telemetry.ei_max",
                 "device.telemetry.trials_per_sec",
                 "device.telemetry.segment_ms"):
        assert name in names, name
    samples = ts.samples(f"device.segments.solo.{stride}")
    assert len(samples) == n_segs
    end = samples[-1][0]
    span = end - samples[0][0] + 1.0
    assert ts.delta(f"device.segments.solo.{stride}", span, now=end) == \
        n_segs - 1
    win = ts.window_state("device.telemetry.segment_ms", 3600.0, now=end)
    assert win["count"] >= n_segs
    best = ts.samples("device.telemetry.best_loss")[-1][1]
    assert best == pytest.approx(
        min(float(d["result"]["loss"]) for d in t._dynamic_trials))
    # The store's windowed reads export as OpenMetrics that parse back.
    fams = export.parse_openmetrics(
        export.render_openmetrics(reg.snapshot(states=True)))
    assert "hyperopt_tpu_device_telemetry_segment_ms" in fams

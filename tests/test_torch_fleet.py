"""The fleet of the PyTorch port (``hyperopt_tpu_torch/fleet.py``, the lanes
of ``tpe._TpeKernel`` and ``device._Segment``, the fleet half of
``history.py``), on the CPU.

Against the JAX package (its Pallas EI kernel in interpret mode):

* the lane step and ``suggest_fleet_seeded`` (``m = 1`` and ``m = 4``), fed
  each lane's uniforms rebuilt from JAX's keys, propose the rows of
  ``hyperopt_tpu``'s ``suggest_fleet_seeded`` on the same stacked
  histories, for each EI lowering, at the tolerance of the solo step's
  JAX tests (categorical and integer columns equal, continuous ones to
  ``rtol=1e-5``: the two packages' samplers round differently); and every
  lane equals the port's own solo call bit for bit;
* a port fleet segment fed JAX's per-trial uniforms lands the rows and
  losses of JAX's ``fleet.fmin_fleet(n_lanes=2, sync_stride=8)``;
* ``device_history_batched`` holds JAX's buffers after a delta append, a
  growth, an overlay, a wipe, a cleared lane, ``KEEP`` and a pregrow.

Against the port's own solo path (bit for bit): ``fmin_fleet`` lanes and
their ``trials_list`` landing, ``fmin_device(n_runs=)``, cohort parity
through padding, delta rounds, liar scans and every solo fallback, the
resident LRU cap, the ``fmin`` adapter; and a lane step makes no host
round trip (capture safety).
"""

import math
from functools import partial

import jax
import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import fleet as fleet_j
from hyperopt_tpu import history as rhist_j
from hyperopt_tpu import tpe as tpe_j
from hyperopt_tpu.space import compile_space as compile_j
from hyperopt_tpu.space import prng_key
from hyperopt_tpu_torch import base, convert, device, fleet, rand, tpe
from hyperopt_tpu_torch import history as rhist
from hyperopt_tpu_torch.ops import fixed_order
from hyperopt_tpu_torch.space import compile_space
from test_torch_device import (SPACE_QCAT, _no_host_round_trips, qcat_dev,
                               qcat_jax, qcat_space)
from test_torch_liar import LOWERINGS
from test_torch_tpe import _history, _jax_step_uniforms, flagship

hp = ht.hp
CPU = "cpu"


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stack(hists):
    return [np.stack(a) for a in zip(*hists)]


def compile_t5():
    return compile_space(flagship(ht, 5))


# ---------------------------------------------------------------------------
# the lane step against JAX's suggest_fleet_seeded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("low", sorted(LOWERINGS))
def test_lane_step_matches_jax_fleet(monkeypatch, low, m):
    monkeypatch.setenv("HYPEROPT_TPU_PALLAS", "interpret")
    env, kw = LOWERINGS[low]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    csj, cst = compile_j(flagship(hj, 5)), compile_t5()
    n_cap, n_cand = 64, 24
    kj = tpe_j.get_kernel(csj, n_cap, n_cand, 25)
    kt = tpe.get_kernel(cst, n_cap, n_cand, 25, device=CPU, **kw)
    n_rows = [40, 52]
    seeds = [7, 1234]
    hists = [tpe_j._padded_history(_history(csj, n, s), n_cap)
             for n, s in zip(n_rows, seeds)]
    want, _ = kj.suggest_fleet_seeded(seeds, m, n_rows, *_stack(hists),
                                      [0.25] * 2, [1.0] * 2)
    want = np.asarray(want)
    noises = []
    for s in seeds:
        keys = ([prng_key(np.uint32(s))] if m == 1
                else jax.random.split(prng_key(np.uint32(s)), m))
        noises.append([_jax_step_uniforms(k, kj) for k in keys])
    stacked = [torch.as_tensor(a) for a in _stack(hists)]
    got, acts = kt.suggest_fleet_seeded(seeds, m, n_rows, *stacked, 0.25,
                                        1.0, noises=noises)
    assert tuple(got.shape) == (2, m, cst.n_params)
    cat = [p.pid for p in cst.params if p.is_int]
    got = got.numpy()
    np.testing.assert_array_equal(got[..., cat], want[..., cat])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for j, hist in enumerate(hists):
        np.testing.assert_array_equal(acts[j].numpy(),
                                      csj.active_mask_host(want[j]))
        # Lane j is the solo call on its own history, bit for bit.
        h = [torch.as_tensor(a) for a in hist]
        if m == 1:
            solo, _ = kt(*h, 0.25, 1.0, noise=noises[j][0])
            solo = solo[None]
        else:
            solo, _ = kt.suggest_many(m, n_rows[j], *h, 0.25, 1.0,
                                      noises=noises[j])
        np.testing.assert_array_equal(got[j], solo.numpy())


def test_lanes_from_generators_equal_solo_suggests():
    """Seeded lanes (no handed-in uniforms) with per-lane gamma and prior
    weight equal the solo seeded calls, for one step and for a batch."""
    cst = compile_t5()
    csj = compile_j(flagship(hj, 5))
    kt = tpe.get_kernel(cst, 64, 32, 25, device=CPU)
    n_rows, seeds = [33, 45], [5, 2 ** 33 + 5]
    gammas, pws = [0.25, 0.5], [1.0, 0.7]
    hists = [tpe._padded_history(_history(csj, n, 3 + n), 64)
             for n in n_rows]
    stacked = [torch.as_tensor(a) for a in _stack(hists)]
    for m in (1, 2):
        rows, _ = kt.suggest_fleet_seeded(seeds, m, n_rows, *stacked,
                                          gammas, pws)
        for j, hist in enumerate(hists):
            gen = ht.space.make_generator(CPU, seeds[j] % 2 ** 32)
            h = [torch.as_tensor(a) for a in hist]
            if m == 1:
                solo = kt(*h, gammas[j], pws[j], generator=gen)[0][None]
            else:
                solo = kt.suggest_many(m, n_rows[j], *h, gammas[j], pws[j],
                                       generator=gen)[0]
            np.testing.assert_array_equal(rows[j].numpy(), solo.numpy())


def test_lane_count_is_checked_up_front():
    space = {f"u{i}": hp.uniform(f"u{i}", 0, 1) for i in range(40)}
    cs = compile_space(space)
    kern = tpe.get_kernel(cs, 32, 8, 25, device=CPU)
    assert kern.max_lanes() == 65535 // 40
    with pytest.raises(ValueError, match="at most 1638 lanes"):
        fleet.fmin_fleet(lambda p: p["u0"], space, n_lanes=1639,
                         max_evals=4, device=CPU)
    with pytest.raises(ValueError, match="at most 1638 lanes"):
        ht.fmin_device(lambda p: p["u0"], space, max_evals=4, n_runs=1639,
                       device=CPU)


@pytest.mark.parametrize("n", [1, 26, 1025])
def test_fixed_order_sums(n):
    """The fixed-order sums equal torch's to rounding, keep its infinite
    cases, and give a row the same bits alone as in a batch."""
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.normal(0, 3, (7, n)).astype(np.float32))
    for fn, ref in ((fixed_order.tree_sum, partial(torch.sum, dim=-1)),
                    (fixed_order.tree_logsumexp,
                     partial(torch.logsumexp, dim=-1)),
                    (fixed_order.prefix_sum, partial(torch.cumsum, dim=-1))):
        got = fn(x)
        torch.testing.assert_close(got, ref(x), rtol=1e-5, atol=1e-4)
        for r in (0, 3, 6):
            assert torch.equal(fn(x[r:r + 1])[0], got[r])
    ninf = torch.full((2, n), -math.inf)
    assert torch.isneginf(fixed_order.tree_logsumexp(ninf)).all()
    ninf[1, 0] = math.inf
    assert fixed_order.tree_logsumexp(ninf)[1] == math.inf


# ---------------------------------------------------------------------------
# a fleet segment against JAX's fmin_fleet
# ---------------------------------------------------------------------------


def test_fleet_segment_matches_jax_fmin_fleet():
    """JAX runs ``fmin_fleet(n_lanes=2, max_evals=24, sync_stride=8)`` with
    no startup draws, so every trial is a TPE step keyed by its per-trial
    seed; the port's two-lane segment runs the same seeds with the
    uniforms of those keys.  Rows, masks and losses are equal
    (exact-integer objective; 3 EI candidates, so that the uniforms decide
    the rows)."""
    n, n_cand, seed = 24, 3, 11
    space_j = qcat_space(hj)
    infos = fleet_j.fmin_fleet(qcat_jax, space_j, n_lanes=2, max_evals=n,
                               seed=seed, sync_stride=8, n_startup_jobs=0,
                               n_EI_candidates=n_cand)
    csj, cst = compile_j(space_j), compile_space(SPACE_QCAT)
    n_cap = tpe._bucket(n)
    kj = tpe_j.get_kernel(csj, n_cap, n_cand, 25)
    kt = tpe.get_kernel(cst, n_cap, n_cand, 25, device=CPU)
    rstates = [np.random.default_rng(seed + j) for j in range(2)]
    seeds = device._lane_seeds(rstates, n)
    noises = [[_jax_step_uniforms(prng_key(np.uint32(s)), kj) for s in row]
              for row in seeds]
    seg = device._build_segment(
        cst, kt, device._wrap_objective(qcat_dev, cst), 0, 0.25, 1.0,
        n_lanes=2)
    p = cst.n_params
    seg.load(np.zeros((0, p), np.float32), np.zeros((0, p), bool),
             np.zeros(0, np.float32), np.zeros(0, bool),
             np.zeros(0, np.float32), limit=n)
    seg.run(seeds, noises=noises)
    vals, active, losses, n_done = seg.fetch(0, n)
    assert list(n_done) == [n, n]
    for j, info in enumerate(infos):
        np.testing.assert_array_equal(active[j], np.asarray(info["active"]))
        np.testing.assert_array_equal(vals[j] * active[j],
                                      np.asarray(info["vals"])
                                      * np.asarray(info["active"]))
        np.testing.assert_array_equal(losses[j], np.asarray(info["losses"]))
    assert not np.array_equal(losses[0], losses[1])


# ---------------------------------------------------------------------------
# the batched rings against JAX's
# ---------------------------------------------------------------------------


def _domains():
    def space(pkg):
        return {"x": pkg.hp.uniform("x", -5, 5),
                "lr": pkg.hp.loguniform("lr", -6, 0),
                "c": pkg.hp.choice("c", [{"a": pkg.hp.normal("a", 0, 1)},
                                         {"k": 2}])}
    dj = hj.base.Domain(lambda d: d["x"] ** 2, space(hj))
    dt = ht.Domain(lambda d: d["x"] ** 2, space(ht))
    dt.cs.device = CPU
    return dj, dt


def _grow_exp(dj, n, seed0, tj=None):
    """``n`` more DONE random trials in a JAX Trials (its rand.suggest)."""
    t = tj if tj is not None else hj.Trials()
    rng = np.random.default_rng(seed0)
    start = len(t._dynamic_trials)
    for i in range(n):
        t.insert_trial_docs(hj.rand.suggest([start + i], dj, t,
                                            int(rng.integers(2 ** 31))))
        t.refresh()
        d = t._dynamic_trials[-1]
        d["state"] = hj.base.JOB_STATE_DONE
        d["result"] = {"status": "ok", "loss": float(rng.normal())}
    t.refresh()
    return t


class _Pair:
    """One experiment in both packages: a JAX Trials and its port copy."""

    def __init__(self, dj, dt, n, seed):
        self.dj, self.dt = dj, dt
        self.tj = _grow_exp(dj, n, seed)
        self.tt = convert.trials_from_jax_docs(self.tj)

    def grow(self, n, seed):
        _grow_exp(self.dj, n, seed, self.tj)
        fresh = convert.trials_from_jax_docs(self.tj)
        new = [d for d in fresh._dynamic_trials
               if d["tid"] not in self.tt._ids]
        self.tt.insert_trial_docs(new)
        self.tt.refresh()

    def wipe_and_refill(self, n, seed):
        self.tj.delete_all()
        self.tt.delete_all()
        _grow_exp(self.dj, n, seed, self.tj)
        self.tt.insert_trial_docs(
            convert.trials_from_jax_docs(self.tj)._dynamic_trials)
        self.tt.refresh()

    def lanes(self):
        return (self.tj.history(self.dj.cs), self.tt.history(self.dt.cs))


def _feed(state, lanes, n_cap, fantasies=None, gens=None):
    """One call of both packages' batched feed; asserts equal buffers."""
    sj, st = state
    sj, bj = rhist_j.device_history_batched(sj, [lj for lj, _ in lanes],
                                            n_cap, fantasies=fantasies,
                                            gens=None if gens is None
                                            else gens[0])
    st, bt = rhist.device_history_batched(st, [lt for _, lt in lanes], n_cap,
                                          fantasies=fantasies,
                                          gens=None if gens is None
                                          else gens[1], device=CPU)
    for a, b in zip(bj, bt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    return sj, st


def test_batched_history_matches_jax():
    dj, dt = _domains()
    exps = [_Pair(dj, dt, n, s) for n, s in [(10, 1), (17, 2), (3, 3)]]
    pad = (None, None)

    def lanes():
        return [e.lanes() for e in exps] + [pad]

    state = _feed((None, None), lanes(), 32)
    # Delta append: only the new rows cross.
    exps[0].grow(4, 11)
    exps[1].grow(2, 12)
    up0, hits0 = rhist.upload_bytes, rhist.append_hits
    state = _feed(state, lanes(), 32)
    p = dt.cs.n_params
    assert rhist.upload_bytes - up0 == 6 * rhist._row_bytes(p)
    assert rhist.append_hits - hits0 == 3
    # Growth: a device pad-copy.
    exps[1].grow(20, 13)
    state = _feed(state, lanes(), 64)
    # Multi-slot overlay, then the clean rings again.
    rng = np.random.default_rng(0)
    pv1 = rng.normal(size=(3, p)).astype(np.float32)
    pv2 = rng.normal(size=(2, p)).astype(np.float32)
    ones = np.ones((3, p), bool)
    fant = [[(pv1, ones, 0.5), (pv2, ones[:2], 0.7)], None,
            (pv2, ones[:2], 1.5), None]
    state = _feed(state, lanes(), 64, fantasies=fant)
    state = _feed(state, lanes(), 64)
    # A wipe reuses tids 0..k: only the generation catches it.
    g0 = rhist.generation(exps[2].tt)
    exps[2].wipe_and_refill(5, 14)
    assert rhist.generation(exps[2].tt) == g0 + 1
    gens = ([rhist_j.generation(e.tj) for e in exps] + [0],
            [rhist.generation(e.tt) for e in exps] + [0])
    r0 = rhist.rebuilds
    state = _feed(state, lanes(), 64, gens=gens)
    assert rhist.rebuilds == r0 + 1
    # An occupied lane departs: it is cleared.
    ls = lanes()
    state = _feed(state, [ls[0], pad, ls[2], pad], 64, gens=gens)
    # Pregrow, then delta appends into it.
    assert rhist.pregrow_batched(state[1], 128).cap == 128
    rhist_j.pregrow_batched(state[0], 128)
    state = _feed(state, lanes(), 128, gens=gens)


def test_keep_lane_preserved():
    """``KEEP`` leaves an occupied lane's rows and cursor alone: when it
    comes back, it is a delta append, not a rebuild."""
    dj, dt = _domains()
    a, b = _Pair(dj, dt, 8, 21), _Pair(dj, dt, 6, 22)
    state = _feed((None, None), [a.lanes(), b.lanes()], 32)
    st, bufs = rhist.device_history_batched(
        state[1], [rhist.KEEP, b.lanes()[1]], 32, device=CPU)
    want = tpe._padded_history(a.lanes()[1], 32)
    np.testing.assert_array_equal(bufs[0][0].numpy(), want[0])
    a.grow(2, 23)
    r0 = rhist.rebuilds
    _feed((state[0], st), [a.lanes(), b.lanes()], 32)
    assert rhist.rebuilds == r0


# ---------------------------------------------------------------------------
# fmin_fleet and fmin_device(n_runs) against solo device runs
# ---------------------------------------------------------------------------

FLEET_SPACE = {"x": hp.uniform("x", -5, 5),
               "c": hp.choice("c", [0, 1, 2, 3])}


def fleet_obj(p):
    return torch.abs(p["x"] - 1.0) + p["c"]


ALGO = dict(n_EI_candidates=16)


def test_fmin_fleet_lane_parity_and_landing():
    n = 24
    tl = [ht.Trials() for _ in range(3)]
    f0 = device.fetch_syncs
    infos = fleet.fmin_fleet(fleet_obj, FLEET_SPACE, n_lanes=3, max_evals=n,
                             seed=3, sync_stride=8, trials_list=tl,
                             device=CPU, **ALGO)
    assert device.fetch_syncs - f0 == n // 8
    assert len(infos) == 3
    for j, info in enumerate(infos):
        t = ht.Trials()
        ht.fmin(fleet_obj, FLEET_SPACE, algo=partial(tpe.suggest, **ALGO),
                max_evals=n, trials=t, rstate=np.random.default_rng(3 + j),
                show_progressbar=False, device=CPU, mode="device",
                sync_stride=8)
        solo = [d["result"]["loss"] for d in t._dynamic_trials]
        np.testing.assert_array_equal(info["losses"],
                                      np.asarray(solo, np.float32))
        assert info["best_loss"] == min(solo)
        assert info["best_index"] == int(np.argmin(solo))
        assert [d["misc"]["vals"] for d in tl[j]._dynamic_trials] == \
            [d["misc"]["vals"] for d in t._dynamic_trials]
        assert [d["result"]["loss"] for d in tl[j]._dynamic_trials] == solo
    # Distinct per-lane seed streams, not one stream copied.
    assert not np.array_equal(infos[0]["losses"], infos[1]["losses"])


def test_fmin_fleet_validation():
    def obj(p):
        return p["x"]

    with pytest.raises(ValueError, match="n_lanes"):
        fleet.fmin_fleet(obj, FLEET_SPACE, n_lanes=0, max_evals=4,
                         device=CPU)
    with pytest.raises(ValueError, match="max_evals"):
        fleet.fmin_fleet(obj, FLEET_SPACE, n_lanes=2, max_evals=0,
                         device=CPU)
    with pytest.raises(ValueError, match="trials_list"):
        fleet.fmin_fleet(obj, FLEET_SPACE, n_lanes=2, max_evals=4,
                         trials_list=[ht.Trials()], device=CPU)
    with pytest.raises(ValueError, match="sync_stride"):
        fleet.fmin_fleet(obj, FLEET_SPACE, n_lanes=2, max_evals=4,
                         sync_stride=0, device=CPU)
    with pytest.raises(NotImplementedError, match="dispatch slice"):
        fleet.fmin_fleet(obj, FLEET_SPACE, n_lanes=2, max_evals=4,
                         mesh=object(), device=CPU)
    # multivariate=True runs since the joint step was ported
    # (tests/test_torch_multivariate.py); a lowering it does not know
    # raises.
    with pytest.raises(ValueError, match="comp_sampler"):
        fleet.fmin_fleet(obj, FLEET_SPACE, n_lanes=2, max_evals=4,
                         comp_sampler="bogus", device=CPU)


def test_fmin_device_n_runs_shapes_and_parity():
    n, runs = 30, 3
    best, info = ht.fmin_device(fleet_obj, FLEET_SPACE, max_evals=n, seed=5,
                                n_runs=runs, device=CPU, **ALGO)
    p = compile_space(FLEET_SPACE).n_params
    assert info["losses"].shape == (runs, n)
    assert info["vals"].shape == (runs, n, p)
    assert info["active"].shape == (runs, n, p)
    assert info["n_trials"] == [n] * runs
    r, i = info["best_index"]
    assert info["best_loss"] == info["losses"][r, i] == info["losses"].min()
    assert set(best) <= {"x", "c"}
    for j in range(runs):
        _, solo = ht.fmin_device(fleet_obj, FLEET_SPACE, max_evals=n,
                                 seed=5 + j, device=CPU, **ALGO)
        np.testing.assert_array_equal(info["losses"][j], solo["losses"])
        np.testing.assert_array_equal(info["vals"][j], solo["vals"])
        np.testing.assert_array_equal(info["active"][j], solo["active"])
    assert not np.array_equal(info["losses"][0], info["losses"][1])
    with pytest.raises(ValueError, match="init"):
        ht.fmin_device(fleet_obj, FLEET_SPACE, max_evals=40, seed=0,
                       n_runs=2, init=solo, device=CPU)


def test_fmin_device_n_runs_patience_is_per_run():
    """A flat lane stops after its patience; an improving lane runs on;
    the replays go on until both have stopped or the budget ends."""
    space = {"x": hp.uniform("x", -1, 1)}

    def obj(p):
        return p["x"] * 0.0 + 1.0

    _, info = ht.fmin_device(obj, space, max_evals=60, seed=0, n_runs=2,
                             n_startup_jobs=5, patience=6, device=CPU)
    assert info["n_trials"] == [11, 11]
    assert np.isinf(info["losses"][:, 11:]).all()
    _, solo = ht.fmin_device(quad_for_patience, space, max_evals=60, seed=1,
                             n_startup_jobs=5, patience=6, device=CPU)
    _, pair = ht.fmin_device(quad_for_patience, space, max_evals=60, seed=0,
                             n_runs=2, n_startup_jobs=5, patience=6,
                             device=CPU)
    assert pair["n_trials"][1] == solo["n_trials"]
    np.testing.assert_array_equal(pair["losses"][1], solo["losses"])


def quad_for_patience(p):
    d = p["x"] - 0.3
    return d * d


# ---------------------------------------------------------------------------
# signatures, tiers and cohorts against solo tpe.suggest
# ---------------------------------------------------------------------------


def _domain(labels=("x", "lr", "c", "a")):
    x, lr, c, a = labels
    space = {x: hp.uniform(x, -5, 5), lr: hp.loguniform(lr, -6, 0),
             c: hp.choice(c, [{a: hp.normal(a, 0, 1)}, {"k": 2}])}
    dom = ht.Domain(lambda d: d[x] ** 2, space)
    dom.cs.device = CPU
    return dom


def _run_exp(dom, n, seed0, trials=None):
    t = trials if trials is not None else ht.Trials()
    rng = np.random.default_rng(seed0)
    start = len(t._dynamic_trials)
    for i in range(n):
        t.insert_trial_docs(rand.suggest([start + i], dom, t,
                                         int(rng.integers(2 ** 31))))
        t.refresh()
        d = t._dynamic_trials[-1]
        d["state"] = base.JOB_STATE_DONE
        d["result"] = {"status": "ok", "loss": float(rng.normal())}
    t.refresh()
    return t


def _vals(docs):
    return [(d["tid"], {k: [float(x) for x in v]
                        for k, v in d["misc"]["vals"].items()})
            for d in docs]


def test_signature_ignores_labels_and_sees_structure():
    a = fleet.space_signature(_domain().cs)
    assert a == fleet.space_signature(_domain(("y", "mom", "arch", "w")).cs)
    other = ht.Domain(lambda d: 0.0, {"x": hp.uniform("x", -1, 1)})
    assert a != fleet.space_signature(other.cs)


def test_cohort_tier_pow2():
    assert [fleet.cohort_tier(b) for b in (1, 2, 3, 4, 5, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 16]


class TestCohortParity:
    B = 5   # pads to the tier of 8

    def _setup(self):
        doms = [_domain() for _ in range(self.B)]
        exps = [_run_exp(doms[i], 22 + i, 10 + i) for i in range(self.B)]
        seeds = [1000 + 7 * i for i in range(self.B)]
        return doms, exps, seeds

    @staticmethod
    def _ids(t, n):
        k = len(t._dynamic_trials)
        return list(range(k, k + n))

    def test_padded_cohort_and_evolution_and_liar_scan(self):
        doms, exps, seeds = self._setup()
        kw = dict(n_EI_candidates=32)

        def solo(n, bump):
            return [_vals(tpe.suggest(self._ids(exps[i], n), doms[i],
                                      exps[i], seeds[i] + bump, **kw))
                    for i in range(self.B)]

        def cohort(sched, n, bump):
            reqs = [(self._ids(exps[i], n), doms[i], exps[i],
                     seeds[i] + bump) for i in range(self.B)]
            return [_vals(d) for d in sched.suggest(reqs)]

        sched = fleet.CohortScheduler(**kw)
        d0 = fleet.dispatches
        assert cohort(sched, 1, 0) == solo(1, 0)
        assert fleet.dispatches == d0 + 1
        assert (fleet.cohort_size_last, fleet.cohort_tier_last) == (5, 8)
        assert fleet.padding_waste == pytest.approx((8 - self.B) / 8)
        # Evolve every history: the delta-append round.
        for i in range(self.B):
            _run_exp(doms[i], 1, 50 + i, trials=exps[i])
        r0 = rhist.rebuilds
        assert cohort(sched, 1, 1) == solo(1, 1)
        assert rhist.rebuilds == r0
        # n = 3 proposals: a liar scan of m = 4 inside each lane.
        assert cohort(sched, 3, 2) == solo(3, 2)
        report = fleet.fleet_report()
        assert any(c["tier"] == 8 and c["occupied"] == 5
                   for s in report["schedulers"] for c in s["cohorts"])

    def test_cohort_of_two(self):
        doms, exps, seeds = self._setup()
        want = [_vals(tpe.suggest(self._ids(exps[i], 1), doms[i], exps[i],
                                  seeds[i])) for i in range(2)]
        sched = fleet.CohortScheduler()
        reqs = [(self._ids(exps[i], 1), doms[i], exps[i], seeds[i])
                for i in range(2)]
        hd = sched.suggest_dispatch(reqs)
        assert [h[0] for h in hd] == ["fleet", "fleet"]
        assert [_vals(fleet.suggest_materialize(h)) for h in hd] == want

    def test_singleton_falls_back_solo(self):
        dom = _domain()
        t = _run_exp(dom, 25, 5)
        want = _vals(tpe.suggest(self._ids(t, 1), dom, t, 99))
        hd = fleet.CohortScheduler().suggest_dispatch(
            [(self._ids(t, 1), dom, t, 99)])
        assert hd[0][0] != "fleet"
        assert _vals(fleet.suggest_materialize(hd[0])) == want

    def test_startup_member_falls_back_to_rand(self):
        dom = _domain()
        t = _run_exp(dom, 3, 99)        # fewer than n_startup_jobs
        doms, exps, seeds = self._setup()
        reqs = [(self._ids(exps[i], 1), doms[i], exps[i], seeds[i])
                for i in range(2)] + [([3], dom, t, 7)]
        hd = fleet.CohortScheduler().suggest_dispatch(reqs)
        assert [h[0] == "fleet" for h in hd] == [True, True, False]
        assert _vals(fleet.suggest_materialize(hd[2])) == \
            _vals(rand.suggest([3], dom, t, 7))

    def test_duplicate_trials_in_batch_fall_back(self):
        dom = _domain()
        t = _run_exp(dom, 25, 6)
        nid = len(t._dynamic_trials)
        r1 = _vals(tpe.suggest([nid], dom, t, 31))
        r2 = _vals(tpe.suggest([nid + 1], dom, t, 32))
        out = fleet.CohortScheduler().suggest([([nid], dom, t, 31),
                                               ([nid + 1], dom, t, 32)])
        assert [_vals(d) for d in out] == [r1, r2]

    def test_custom_kwargs_fall_back(self):
        doms, exps, seeds = self._setup()
        want = _vals(tpe.suggest(self._ids(exps[1], 1), doms[1], exps[1],
                                 seeds[1], gamma=0.5))
        d0 = fleet.dispatches
        hd = fleet.CohortScheduler().suggest_dispatch(
            [(self._ids(exps[0], 1), doms[0], exps[0], seeds[0]),
             (self._ids(exps[1], 1), doms[1], exps[1], seeds[1],
              {"gamma": 0.5})])
        assert [h[0] == "fleet" for h in hd] == [False, False]
        assert fleet.dispatches == d0
        assert _vals(fleet.suggest_materialize(hd[1])) == want


def test_resident_lru_cap_evicts_coldest():
    dom = _domain()
    cs = dom.cs
    ts = [_run_exp(dom, 6, 40 + i) for i in range(3)]
    e0 = rhist.evicted
    for t in ts:
        rhist.device_history(t, cs, t.history(cs), 32, lru_cap=2)
    assert rhist.evicted == e0 + 1
    # The evicted (oldest) ring is rebuilt on return; the hottest appends.
    r0 = rhist.rebuilds
    rhist.device_history(ts[0], cs, ts[0].history(cs), 32, lru_cap=2)
    assert rhist.rebuilds == r0 + 1
    r0 = rhist.rebuilds
    rhist.device_history(ts[2], cs, ts[2].history(cs), 32, lru_cap=2)
    assert rhist.rebuilds == r0


def test_resident_lru_without_cap_keeps_every_ring():
    dom = _domain()
    cs = dom.cs
    ts = [_run_exp(dom, 6, 60 + i) for i in range(4)]
    e0 = rhist.evicted
    for t in ts + ts:
        rhist.device_history(t, cs, t.history(cs), 32)
    assert rhist.evicted == e0


def test_algo_adapter_fmin_parity():
    space = {"x": hp.uniform("x", -5, 5), "lr": hp.loguniform("lr", -6, 0)}

    def obj(d):
        return d["x"] ** 2 + d["lr"]

    t1, t2 = ht.Trials(), ht.Trials()
    ht.fmin(obj, space, algo=tpe.suggest, max_evals=30, trials=t1,
            rstate=np.random.default_rng(42), show_progressbar=False,
            device=CPU)
    sched = fleet.CohortScheduler()
    ht.fmin(obj, space, algo=sched.algo(), max_evals=30, trials=t2,
            rstate=np.random.default_rng(42), show_progressbar=False,
            device=CPU)
    assert [d["result"]["loss"] for d in t1] == \
        [d["result"]["loss"] for d in t2]


# ---------------------------------------------------------------------------
# capture safety
# ---------------------------------------------------------------------------


def test_lane_step_makes_no_host_round_trip():
    cs = compile_space(flagship(ht, 5))
    kern = tpe.get_kernel(cs, 64, 32, 25, device=CPU)
    seg = device._build_segment(
        cs, kern, device._wrap_objective(
            lambda p: p["u0"] * p["u0"] + torch.abs(p["n0"]), cs),
        20, 0.25, 1.0, n_lanes=3)
    vals, act = cs.sample(40, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    v = vals.numpy()
    loss = np.square(v[:, :2]).sum(1).astype(np.float32)
    seg.load(v, act.numpy(), loss, np.ones(40, bool), loss, limit=64)
    for k, g in enumerate(seg.gens):
        g.manual_seed(k)
    with _no_host_round_trips():
        seg._step()
    assert seg.i.tolist() == [41, 41, 41]
    assert bool(seg.hok[:, 40].all())
    assert not torch.equal(seg.hv[0, 40], seg.hv[1, 40])


def test_fleet_is_exported():
    assert ht.fmin_fleet is fleet.fmin_fleet
    assert "fleet" in ht.__all__ and "fmin_fleet" in ht.__all__

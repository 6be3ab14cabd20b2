"""Device mode of the PyTorch port: ``fmin(mode="device", sync_stride=S)``
and ``fmin_device``, on the CPU, where the captured step runs eagerly.

Mirrors ``tests/test_fmin_device_mode.py`` and ``tests/test_device.py``
(without their mesh cases; the ``n_runs`` ones are in
``tests/test_torch_fleet.py``), held against the port's own
hosted loop, plus one test against the JAX package:

* Stride-1 bit-parity with the hosted ``fmin`` on three domains: the
  same ``rstate`` lands byte-identical trial docs.  Objectives compute in
  per-op float32 on both sides (tolerance: none, equality).
* Stride invariance, fetch and segment accounting, resume, return value,
  algo keywords, early stop, loss threshold and validation.
* ``fmin_device``: convergence, determinism and the run cache, masks,
  objective signatures, startup, resume, patience, the flagship space.
* The JAX package's device mode and the port's segment, handed the
  uniforms of JAX's per-trial keys, land equal rows and losses.
* The step is capture-safe: no host round trip while it runs.

The card half, a capture that fails with the objective contract, is
``tests_torch_cuda/test_torch_cuda_device.py``.
"""

import contextlib
import math
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import tpe as tpe_j
from hyperopt_tpu.space import compile_space as compile_j
from hyperopt_tpu.space import prng_key
from hyperopt_tpu_torch import convert, device, rand, tpe
from hyperopt_tpu_torch.space import compile_space
from hyperopt_tpu_torch.utils.early_stop import no_progress_loss
from test_torch_tpe import _jax_step_uniforms, flagship, wide_q

hp = ht.hp
N = 32      # one history bucket for the hosted and the device loop
CPU = "cpu"


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# objective twins: torch for device mode, np.float32 per op for the host
# ---------------------------------------------------------------------------

SPACE_QUAD = {"x": hp.uniform("x", -5, 5)}


def quad_dev(p):
    d = p["x"] - 3.0
    return d * d


def quad_host(d):
    # A float32 multiply, as on the device: np.float32 ** 2 calls powf,
    # which may round the square differently.
    e = np.float32(d["x"]) - np.float32(3.0)
    return float(e * e)


SPACE_ARMS = {"arm": hp.choice("arm", list(range(6)))}


def arms_dev(p):
    return p["arm"] * 0.1


def arms_host(d):
    return float(np.float32(d["arm"]) * np.float32(0.1))


def qcat_space(pkg):
    """Quantized + categorical conditional space with exact-integer
    losses: parity cannot hinge on rounding."""
    return {"q": pkg.hp.quniform("q", 0, 20, 2),
            "c": pkg.hp.choice("c", [
                {"kind": 0},
                {"kind": 1, "depth": pkg.hp.quniform("depth", 1, 8, 1)}])}


SPACE_QCAT = qcat_space(ht)


def qcat_dev(p):
    return torch.abs(p["q"] - 6.0) + torch.where(p["c"] > 0, p["depth"], 0.0)


def qcat_host(d):
    base = abs(np.float32(d["q"]) - np.float32(6.0))
    extra = np.float32(d["c"]["depth"]) if d["c"]["kind"] == 1 \
        else np.float32(0.0)
    return float(base + extra)


DOMAINS = [
    ("quadratic1", SPACE_QUAD, quad_dev, quad_host),
    ("n_arms", SPACE_ARMS, arms_dev, arms_host),
    ("qcat", SPACE_QCAT, qcat_dev, qcat_host),
]


def _host(fn, space, seed, n=N, trials=None, algo=tpe.suggest, **kw):
    t = trials if trials is not None else ht.Trials()
    ht.fmin(fn, space, algo=algo, max_evals=n, trials=t,
            rstate=np.random.default_rng(seed), show_progressbar=False,
            device=CPU, **kw)
    return t


def _device(fn, space, seed, stride, n=N, trials=None, algo=tpe.suggest,
            **kw):
    t = trials if trials is not None else ht.Trials()
    ht.fmin(fn, space, algo=algo, max_evals=n, trials=t,
            rstate=np.random.default_rng(seed), show_progressbar=False,
            device=CPU, mode="device", sync_stride=stride, **kw)
    return t


def _rows(t):
    return [(d["tid"],
             {k: tuple(map(float, v))
              for k, v in sorted(d["misc"]["vals"].items())},
             float(d["result"]["loss"]), d["result"]["status"])
            for d in t._dynamic_trials]


# ---------------------------------------------------------------------------
# fmin(mode="device") against the hosted loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,space,fdev,fhost", DOMAINS,
                         ids=[d[0] for d in DOMAINS])
def test_stride1_bit_parity_vs_hosted_loop(name, space, fdev, fhost):
    a = _host(fhost, space, seed=5)
    b = _device(fdev, space, seed=5, stride=1)
    assert len(b) == N
    assert _rows(a) == _rows(b)


@pytest.mark.parametrize("name,space,fdev,fhost", DOMAINS,
                         ids=[d[0] for d in DOMAINS])
def test_stride1_bit_parity_across_history_buckets(name, space, fdev, fhost):
    """100 trials: the hosted step's bucket grows 32 → 64 → 128 with the
    history, device mode holds 128 from the first trial; the trials are
    equal all the same (tolerance: none, equality)."""
    assert tpe._bucket(20) == 32 and tpe._bucket(100) == 128
    a = _host(fhost, space, seed=13, n=100)
    b = _device(fdev, space, seed=13, stride=1, n=100)
    assert len(b) == 100
    assert _rows(a) == _rows(b)


def test_fmin_trials_defaults_to_cuda_after_a_hosted_cpu_run(monkeypatch):
    """A hosted CPU run sets the shared compiled space's device; device
    mode called without ``device`` still asks for CUDA (and raises when
    there is none) instead of running on the CPU."""
    _host(quad_host, SPACE_QUAD, seed=1, n=4)
    assert compile_space(SPACE_QUAD).device == torch.device(CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.fmin_trials(quad_dev, SPACE_QUAD, 4, ht.Trials(),
                           np.random.default_rng(0))


def test_stride_invariance_and_fetch_accounting():
    runs = {}
    for stride in (1, 8, None):
        f0 = device.fetch_syncs
        runs[stride] = _rows(_device(qcat_dev, SPACE_QCAT, seed=9,
                                     stride=stride))
        want = math.ceil(N / (stride or N))
        assert device.fetch_syncs - f0 == want
    assert runs[1] == runs[8] == runs[None]


def test_counters_segments_and_landings():
    s0, l0 = device.segments, device.trials_landed
    r0, e0 = device.replays, device.eager_steps
    _device(quad_dev, SPACE_QUAD, seed=3, stride=8)
    assert device.segments - s0 == N // 8
    assert device.trials_landed - l0 == N
    # On the CPU every trial runs eagerly; nothing is replayed.
    assert device.eager_steps - e0 == N
    assert device.replays == r0


def test_resume_from_existing_trials_matches_hosted_continuation():
    a = _host(quad_host, SPACE_QUAD, seed=7, n=10)
    _host(quad_host, SPACE_QUAD, seed=11, n=N, trials=a)
    b = _host(quad_host, SPACE_QUAD, seed=7, n=10)
    _device(quad_dev, SPACE_QUAD, seed=11, stride=1, n=N, trials=b)
    assert _rows(a) == _rows(b)


def test_return_value_matches_hosted():
    t1, t2 = ht.Trials(), ht.Trials()
    best_h = ht.fmin(quad_host, SPACE_QUAD, algo=tpe.suggest, max_evals=N,
                     trials=t1, rstate=np.random.default_rng(5),
                     show_progressbar=False, device=CPU)
    best_d = ht.fmin(quad_dev, SPACE_QUAD, algo=tpe.suggest, max_evals=N,
                     trials=t2, rstate=np.random.default_rng(5),
                     show_progressbar=False, device=CPU, mode="device",
                     sync_stride=1)
    assert best_h == best_d
    assert t1.best_trial["result"]["loss"] == t2.best_trial["result"]["loss"]
    loss_d = ht.fmin(quad_dev, SPACE_QUAD, algo=tpe.suggest, max_evals=N,
                     trials=ht.Trials(), rstate=np.random.default_rng(5),
                     show_progressbar=False, device=CPU, mode="device",
                     return_argmin=False)
    assert loss_d == t1.best_trial["result"]["loss"]


@pytest.mark.parametrize("lowering", [
    dict(),
    dict(ei_impl="vpu", ei_precision="bf16", ei_topm=4),
    dict(ei_impl="mxu"),
], ids=["f32", "bf16_topm", "mxu"])
def test_algo_config_flows_through_partial(lowering):
    # A non-default TPE config (and EI lowering) must give the same
    # non-default run on both paths: the device branch unwraps the partial.
    algo = partial(tpe.suggest, n_startup_jobs=5, gamma=0.5,
                   n_EI_candidates=13, **lowering)
    a = _host(quad_host, SPACE_QUAD, seed=2, algo=algo)
    b = _device(quad_dev, SPACE_QUAD, seed=2, stride=1, algo=algo)
    assert _rows(a) == _rows(b)


# ---------------------------------------------------------------------------
# stops at the stride boundary
# ---------------------------------------------------------------------------


def flat_dev(p):
    return p["x"] * 0.0 + 1.0


def flat_host(d):
    return 1.0


def test_early_stop_halts_within_one_stride():
    stride = 4
    a = _host(flat_host, SPACE_QUAD, seed=1, n=64,
              early_stop_fn=no_progress_loss(5))
    n_host = len(a)
    assert n_host < 64      # the trigger fired
    b = _device(flat_dev, SPACE_QUAD, seed=1, stride=stride, n=64,
                early_stop_fn=no_progress_loss(5))
    # The first sync boundary at or after the hosted stop.
    assert n_host <= len(b) == stride * math.ceil(n_host / stride)


def test_loss_threshold_stops_at_boundary():
    t = _device(quad_dev, SPACE_QUAD, seed=5, stride=4, n=64,
                loss_threshold=1.0)
    assert len(t) < 64
    assert len(t) % 4 == 0
    assert t.best_trial["result"]["loss"] < 1.0
    losses = [d["result"]["loss"] for d in t]
    assert min(losses[:-4]) >= 1.0      # not reached a boundary earlier


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def test_mode_and_stride_validation():
    with pytest.raises(ValueError, match="mode"):
        _host(quad_host, SPACE_QUAD, seed=0, n=4, mode="banana")
    with pytest.raises(ValueError, match="sync_stride"):
        _host(quad_host, SPACE_QUAD, seed=0, n=4, sync_stride=8)
    with pytest.raises(ValueError, match="sync_stride"):
        _device(quad_dev, SPACE_QUAD, seed=0, stride=0, n=4)


def test_non_tpe_algo_rejected():
    with pytest.raises(ValueError, match="device"):
        _device(quad_dev, SPACE_QUAD, seed=0, stride=None, n=4,
                algo=rand.suggest)
    # multivariate=True is captured since the joint step was ported
    # (tests/test_torch_multivariate.py); a misspelt keyword stays refused.
    for kw in (dict(n_EI_candidate=8), dict(resident=False)):
        with pytest.raises(ValueError, match="cannot honor"):
            _device(quad_dev, SPACE_QUAD, seed=0, stride=None, n=4,
                    algo=partial(tpe.suggest, **kw))


def test_host_loop_options_rejected():
    for kw in (dict(points_to_evaluate=[{"x": 0.0}]),
               dict(pass_expr_memo_ctrl=True),
               dict(catch_eval_exceptions=True),
               dict(trials_save_file="trials.pkl"),
               dict(max_queue_len=4)):
        with pytest.raises(ValueError, match="host-loop option"):
            ht.fmin(quad_dev, SPACE_QUAD, algo=tpe.suggest, max_evals=4,
                    trials=ht.Trials(), rstate=np.random.default_rng(0),
                    show_progressbar=False, device=CPU, mode="device", **kw)


def test_max_evals_required():
    with pytest.raises(ValueError, match="max_evals"):
        ht.fmin(quad_dev, SPACE_QUAD, algo=tpe.suggest, trials=ht.Trials(),
                rstate=np.random.default_rng(0), show_progressbar=False,
                device=CPU, mode="device")


def test_fleet_options_not_ported():
    """``mesh=`` came with the dispatch slice and takes a ``dispatch``
    mesh only (``tests/test_torch_dispatch.py``); ``n_runs > 1`` is ported
    (``tests/test_torch_fleet.py``)."""
    with pytest.raises(ValueError, match="dimensions"):
        ht.fmin_device(quad_dev, SPACE_QUAD, max_evals=8, mesh=object(),
                       device=CPU)


# ---------------------------------------------------------------------------
# fmin_device
# ---------------------------------------------------------------------------


def _branin(p):
    x, y = p["x"], p["y"]
    return ((y - 5.1 / (4 * math.pi ** 2) * x ** 2 + 5 / math.pi * x - 6)
            ** 2 + 10 * (1 - 1 / (8 * math.pi)) * torch.cos(x) + 10)


BRANIN_SPACE = {"x": hp.uniform("x", -5, 10), "y": hp.uniform("y", 0, 15)}


def test_fmin_device_converges_and_counts():
    best, info = ht.fmin_device(_branin, BRANIN_SPACE, max_evals=100,
                                seed=1, n_EI_candidates=64, device=CPU)
    assert info["losses"].shape == (100,)
    assert np.isfinite(info["losses"]).all()
    assert info["n_trials"] == 100
    assert set(best) == {"x", "y"}
    # Branin's minimum is 0.3979; TPE at 100 trials lands in low single
    # digits at worst.
    assert info["best_loss"] < 3.0
    assert info["best_loss"] == info["losses"][info["best_index"]]


def test_fmin_device_deterministic_and_cached():
    h0, m0 = device.run_cache_hits, device.run_cache_misses
    r1 = ht.fmin_device(_branin, BRANIN_SPACE, max_evals=40, seed=7,
                        device=CPU)
    r2 = ht.fmin_device(_branin, BRANIN_SPACE, max_evals=40, seed=7,
                        device=CPU)
    np.testing.assert_array_equal(r1[1]["losses"], r2[1]["losses"])
    np.testing.assert_array_equal(r1[1]["vals"], r2[1]["vals"])
    assert r1[0] == r2[0]
    r3 = ht.fmin_device(_branin, BRANIN_SPACE, max_evals=40, seed=8,
                        device=CPU)
    assert not np.array_equal(r1[1]["losses"], r3[1]["losses"])
    # One step per (objective, bucket, tuning): built once, reused twice.
    assert device.run_cache_hits - h0 >= 2
    assert device.run_cache_misses - m0 <= 1


def test_fmin_device_equals_fmin_device_mode():
    """fmin_device(seed=s) lands the trials of fmin(mode="device") with
    rstate default_rng(s)."""
    _, info = ht.fmin_device(quad_dev, SPACE_QUAD, max_evals=N, seed=4,
                             device=CPU)
    t = _device(quad_dev, SPACE_QUAD, seed=4, stride=None)
    np.testing.assert_array_equal(
        info["losses"], np.asarray(t.losses(), np.float32))


def test_run_cache_is_bounded():
    cs = compile_space(SPACE_QUAD)
    for k in range(device._RUN_CACHE_CAP + 3):
        ht.fmin_device(lambda p, k=k: (p["x"] - k) ** 2, SPACE_QUAD,
                       max_evals=4, seed=0, n_startup_jobs=4, device=CPU)
    assert len(cs._device_runs) == device._RUN_CACHE_CAP


def test_concurrent_runs_of_one_step_take_turns():
    """Threads running the same objective share one cached step and its
    buffers; each run must still land what a lone run lands."""
    import sys
    import threading

    def run(seed):
        return ht.fmin_device(quad_dev, SPACE_QUAD, max_evals=16, seed=seed,
                              n_startup_jobs=4, device=CPU)[1]["losses"]

    want = {seed: run(seed) for seed in range(6)}
    got, errors = [], []

    def worker(k):
        try:
            for r in range(3):
                seed = (k + r) % 6
                got.append((seed, run(seed)))
        except Exception as e:      # reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(got) == 18
    for seed, losses in got:
        np.testing.assert_array_equal(losses, want[seed])


def test_fmin_device_conditional_space_masks_inactive():
    space = {"branch": hp.choice("branch", [
        {"kind": 0},
        {"kind": 1, "lr": hp.loguniform("lr", -4, 0)},
    ])}

    def obj(p):
        # Branch 1 with lr near e^-2 is best; branch 0 is flat 1.0.
        return torch.where(p["branch"] > 0.5,
                           torch.abs(torch.log(p["lr"]) + 2.0) * 0.5, 1.0)

    best, info = ht.fmin_device(obj, space, max_evals=60, seed=3,
                                n_EI_candidates=32, device=CPU)
    assert info["best_loss"] < 0.4
    assert best["branch"] == 1 and "lr" in best
    cs = compile_space(space)
    lr_pid, br_pid = cs.by_label["lr"].pid, cs.by_label["branch"].pid
    b0 = info["vals"][:, br_pid] < 0.5
    assert b0.any()
    assert not info["active"][b0, lr_pid].any()


def test_fmin_device_two_arg_objective_gets_active_mask():
    space = {"branch": hp.choice("branch", [
        {"kind": 0},
        {"kind": 1, "z": hp.uniform("z", -1, 1)},
    ])}
    seen = {}

    def obj(p, active):
        seen["keys"] = sorted(active)
        seen["dtype"] = active["z"].dtype
        return torch.where(active["z"], p["z"] ** 2, 0.5)

    _, info = ht.fmin_device(obj, space, max_evals=40, seed=0, device=CPU)
    assert seen["keys"] == ["branch", "z"]
    assert seen["dtype"] == torch.bool
    assert info["best_loss"] < 0.1


def test_fmin_device_defaulted_keyword_not_mistaken_for_mask():
    seen = {}

    def obj(p, scale=2.0):
        seen["scale"] = scale
        return (p["x"] - 1.0) ** 2 * scale

    _, info = ht.fmin_device(obj, SPACE_QUAD, max_evals=24, seed=0,
                             device=CPU)
    assert seen["scale"] == 2.0
    assert np.isfinite(info["losses"]).all()


def test_fmin_device_startup_only_and_tpe_from_empty_history():
    _, info = ht.fmin_device(_branin, BRANIN_SPACE, max_evals=10, seed=0,
                             n_startup_jobs=25, device=CPU)
    assert info["losses"].shape == (10,)
    assert np.isfinite(info["losses"]).all()
    # n_startup_jobs=0: the TPE arm proposes from an empty history.
    _, info = ht.fmin_device(_branin, BRANIN_SPACE, max_evals=10, seed=0,
                             n_startup_jobs=0, device=CPU)
    assert np.isfinite(info["losses"]).all()
    assert np.isfinite(info["vals"]).all()


def test_fmin_device_resume_from_prior_info():
    _, info30 = ht.fmin_device(_branin, BRANIN_SPACE, max_evals=30, seed=5,
                               device=CPU)
    _, info60 = ht.fmin_device(_branin, BRANIN_SPACE, max_evals=60, seed=6,
                               init=info30, device=CPU)
    assert info60["losses"].shape == (60,)
    np.testing.assert_array_equal(info60["losses"][:30], info30["losses"])
    np.testing.assert_array_equal(info60["vals"][:30], info30["vals"])
    assert info60["best_loss"] <= info30["best_loss"]
    with pytest.raises(ValueError):
        ht.fmin_device(_branin, BRANIN_SPACE, max_evals=30, seed=0,
                       init=info30, device=CPU)


def test_fmin_device_resume_shorter_than_startup():
    """A resumed history shorter than n_startup_jobs owes only the
    remainder in startup draws: trial 5 + k is TPE exactly when the
    hosted gate (ok trials >= n_startup_jobs) says so."""
    _, info5 = ht.fmin_device(_branin, BRANIN_SPACE, max_evals=5, seed=0,
                              n_startup_jobs=5, device=CPU)
    _, info30 = ht.fmin_device(_branin, BRANIN_SPACE, max_evals=30, seed=1,
                               init=info5, n_startup_jobs=20, device=CPU)
    assert np.isfinite(info30["losses"]).all()
    np.testing.assert_array_equal(info30["losses"][:5], info5["losses"])
    # The same continuation through the hosted loop.
    t = ht.Trials()
    docs = ht.base.docs_from_samples(compile_space(BRANIN_SPACE),
                                     t.new_trial_ids(5), info5["vals"],
                                     info5["active"])
    for doc, loss in zip(docs, info5["losses"]):
        doc["state"] = ht.JOB_STATE_DONE
        doc["result"] = {"loss": float(loss), "status": "ok"}
    t.insert_trial_docs(docs)
    t.refresh()
    _host(lambda d: float(_branin({k: torch.tensor(np.float32(v))
                                   for k, v in d.items()})),
          BRANIN_SPACE, seed=1, n=30, trials=t,
          algo=partial(tpe.suggest, n_startup_jobs=20))
    hosted_vals = np.asarray([[d["misc"]["vals"]["x"][0],
                               d["misc"]["vals"]["y"][0]] for d in t],
                             np.float32)
    cs = compile_space(BRANIN_SPACE)
    order = [cs.by_label["x"].pid, cs.by_label["y"].pid]
    np.testing.assert_array_equal(info30["vals"][:, order], hosted_vals)


def test_fmin_device_patience_stops_on_flat_objective():
    space = {"x": hp.uniform("x", -1, 1)}
    _, info = ht.fmin_device(lambda p: p["x"] * 0.0 + 1.0, space,
                             max_evals=200, seed=0, n_startup_jobs=5,
                             patience=6, device=CPU)
    assert info["n_trials"] == 5 + 6
    assert np.isfinite(info["losses"][:11]).all()
    assert np.isinf(info["losses"][11:]).all()
    assert not info["active"][11:].any()
    assert (info["vals"][11:] == 0).all()
    assert info["best_loss"] == 1.0


def test_fmin_device_patience_runs_full_budget_when_improving():
    _, info = ht.fmin_device(quad_dev, SPACE_QUAD, max_evals=40, seed=1,
                             patience=40, device=CPU)
    assert info["n_trials"] == 40
    assert np.isfinite(info["losses"]).all()


def test_fmin_device_mixed_kind_flagship_space():
    """Every family (uniform, loguniform, quantized, normal, choice, a
    conditional branch, a pchoice) through the device step."""
    cs = compile_space(flagship(ht, 5))

    def obj(p):
        return p["u0"] ** 2 + torch.abs(p["n0"]) + p["c0"] * 0.1

    best, info = ht.fmin_device(obj, cs, max_evals=40, seed=0,
                                n_startup_jobs=10, n_EI_candidates=32,
                                device=CPU)
    assert info["losses"].shape == (40,)
    assert np.isfinite(info["losses"]).all()
    assert info["best_loss"] < 2.0
    assert isinstance(best["c0"], int)
    assert float(best["q0"]) % 2.0 == 0.0


# ---------------------------------------------------------------------------
# against the JAX package's device mode
# ---------------------------------------------------------------------------


def qcat_jax(p):
    return jnp.abs(p["q"] - 6.0) + jnp.where(p["c"] > 0, p["depth"], 0.0)


def test_segment_matches_jax_device_mode():
    """Both packages resume from the same 24 DONE trials on the qcat
    domain (no startup draw in the segment).  JAX runs ``fmin(mode=
    "device", sync_stride=4, max_evals=32)``; the port's segment runs the
    same 8 per-trial seeds with the uniforms of JAX's keys ``prng_key(
    seed_t)``.  Rows and losses are equal (exact-integer objective).
    Three EI candidates per column, so that the draws decide the rows: at
    24 the argmax over these small lattices lands on the same point
    whatever the uniforms are, and the test would not tell them apart."""
    n_cand = 3
    space_j = qcat_space(hj)
    tj = hj.Trials()
    hj.fmin(qcat_host, space_j, algo=tpe_j.suggest, max_evals=24,
            trials=tj, rstate=np.random.default_rng(3),
            show_progressbar=False)
    tt = convert.trials_from_jax_docs(tj)
    hj.fmin(qcat_jax, space_j,
            algo=partial(tpe_j.suggest, n_EI_candidates=n_cand),
            max_evals=N, trials=tj, rstate=np.random.default_rng(11),
            show_progressbar=False, mode="device", sync_stride=4)
    assert len(tj) == N
    want = tj.history(compile_j(space_j))

    csj, cst = compile_j(space_j), compile_space(SPACE_QCAT)
    n_cap = tpe._bucket(N)
    kj = tpe_j.get_kernel(csj, n_cap, n_cand, 25)
    kt = tpe.get_kernel(cst, n_cap, n_cand, 25, device=CPU)
    assert [list(g.pids) for g in kj.groups] == \
        [list(g.pids) for g in kt.groups]
    rng = np.random.default_rng(11)
    seeds = [int(rng.integers(2 ** 31 - 1)) for _ in range(N - 24)]
    h = tt.history(cst)
    assert int(h["ok"].sum()) == 24

    def port_segment(noises):
        seg = device._build_segment(
            cst, kt, device._wrap_objective(qcat_dev, cst), 20, 0.25, 1.0)
        seg.load(h["vals"], h["active"], h["loss"], h["ok"], h["loss"],
                 limit=N)
        seg.run(seeds, noises=noises)
        (vals, active, losses, n_done), = zip(*seg.fetch(24, N))
        return vals, active, losses, n_done

    vals, active, losses, n_done = port_segment(
        [_jax_step_uniforms(prng_key(np.uint32(s)), kj) for s in seeds])
    assert n_done == N
    np.testing.assert_array_equal(vals * active, want["vals"][24:])
    np.testing.assert_array_equal(active, want["active"][24:])
    np.testing.assert_array_equal(losses, want["loss"][24:])
    # The port's own draws from the same seeds land other rows.
    vals, active, _, _ = port_segment(None)
    assert not np.array_equal(vals * active, want["vals"][24:])


# ---------------------------------------------------------------------------
# capture safety, checked where there is no card
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _no_host_round_trips():
    """Make every host round trip a tensor op could take raise: reading
    a value back (``item``, ``cpu``, ``numpy``, ``tolist``, ``bool``,
    ``int``, ``float``) or making a tensor from host data (``torch.tensor``,
    ``torch.as_tensor`` of anything but a tensor).  On the card each of
    these breaks a CUDA-graph capture."""
    names = ("item", "cpu", "numpy", "tolist", "__bool__", "__int__",
             "__float__")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    tensor, as_tensor = torch.tensor, torch.as_tensor

    def refuse(what):
        def f(*args, **kwargs):
            raise AssertionError(f"host round trip in the step: {what}")
        return f

    def guarded_as_tensor(data, *args, **kwargs):
        if isinstance(data, torch.Tensor):
            return as_tensor(data, *args, **kwargs)
        raise AssertionError(f"host round trip in the step: torch.as_tensor "
                             f"of {type(data).__name__}")

    try:
        for n in names:
            setattr(torch.Tensor, n, refuse(f"Tensor.{n}"))
        torch.tensor = refuse("torch.tensor")
        torch.as_tensor = guarded_as_tensor
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
        torch.tensor, torch.as_tensor = tensor, as_tensor


def _flagship_objective(p):
    return p["u0"] * p["u0"] + torch.abs(p["n0"])


@pytest.mark.parametrize("lowering", [
    dict(), dict(ei_precision="bf16", ei_topm=8), dict(ei_impl="mxu")],
    ids=["f32", "bf16_topm", "mxu"])
@pytest.mark.parametrize("space_fn", [flagship, wide_q],
                         ids=["flagship", "wide_q"])
def test_steps_make_no_host_round_trip(space_fn, lowering):
    cs = compile_space(space_fn(ht))
    obj = (_flagship_objective if "u0" in cs.by_label
           else (lambda p: sum(p.values())))
    kw = dict(ei_impl="vpu", ei_precision="f32", ei_topm=0)
    kw.update(lowering)
    n_cap = 64
    kern = tpe.get_kernel(cs, n_cap, 128, 25, device=CPU, **kw)
    seg = device._build_segment(cs, kern, device._wrap_objective(obj, cs),
                                20, 0.25, 1.0)
    vals, act = cs.sample(40, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    v = vals.numpy()
    loss = np.square(v[:, :2]).sum(1).astype(np.float32)
    seg.load(v, act.numpy(), loss, np.ones(40, bool), loss, limit=n_cap)
    for g in seg.gens:
        g.manual_seed(3)
    # The device-mode step: both arms, the objective, the insert.
    with _no_host_round_trips():
        seg._step()
    assert int(seg.i) == 41
    assert bool(seg.hok[0, 40]) and math.isfinite(float(seg.hl[0, 40]))
    # The hosted step.
    hist = [b[0, :n_cap] for b in (seg.hv, seg.ha, seg.hl, seg.hok)]
    with _no_host_round_trips():
        row, _, _, _ = kern._suggest_one_tel(
            *hist, 0.25, 1.0, generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(row).all()


def test_round_trip_guard_catches_a_host_read():
    cs = compile_space(SPACE_QUAD)
    kern = tpe.get_kernel(cs, 32, 24, 25, device=CPU)
    seg = device._build_segment(
        cs, kern, device._wrap_objective(lambda p: p["x"] * p["x"].item(),
                                         cs), 20, 0.25, 1.0)
    with _no_host_round_trips(), pytest.raises(AssertionError,
                                               match="Tensor.item"):
        seg._step()


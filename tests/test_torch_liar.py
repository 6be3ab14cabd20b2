"""Constant-liar batches of the port (``n > 1`` proposals past startup,
``fmin(max_queue_len>1)``) against hyperopt_tpu, on each EI lowering.

* Step parity: JAX's ``suggest_many_seeded`` (its Pallas EI kernel in
  interpret mode, the lowering picked by its environment toggles) and the
  port's ``_liar_scan`` handed the same per-step uniforms (those of each
  split key) propose the same rows.
* ``fmin(max_queue_len)`` mirrors of ``tests/test_fmin.py`` and
  ``tests/test_pallas.py::test_batched_liar_composes_with_pallas`` on
  ``device="cpu"``, for each lowering.
* ``max_queue_len=1`` proposes exactly what the serial loop proposed
  before batches existed (pinned values under a fixed ``rstate``).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import tpe as tpe_j
from hyperopt_tpu.space import compile_space as compile_j
from hyperopt_tpu.space import prng_key
from hyperopt_tpu_torch import tpe as tpe_t
from hyperopt_tpu_torch.ops import ei_scores as ei_mod
from hyperopt_tpu_torch.space import compile_space as compile_t
from test_torch_tpe import _history, _jax_step_uniforms, flagship

# Lowering -> (the JAX package's environment toggles, the port's keywords).
LOWERINGS = {
    "f32": ({}, dict(ei_impl="vpu", ei_precision="f32")),
    "bf16": ({"HYPEROPT_TPU_EI_PRECISION": "bf16"},
             dict(ei_impl="vpu", ei_precision="bf16")),
    "mxu": ({"HYPEROPT_TPU_PALLAS_EI": "mxu"},
            dict(ei_impl="mxu", ei_precision="f32")),
}
SPACE1 = {"x": ht.hp.uniform("x", -5, 5)}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def q1(d):
    return (d["x"] - 3.0) ** 2


@pytest.mark.parametrize("low", sorted(LOWERINGS))
def test_liar_scan_with_jax_uniforms_proposes_jax_rows(monkeypatch, low):
    monkeypatch.setenv("HYPEROPT_TPU_PALLAS", "interpret")
    env, kw = LOWERINGS[low]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    csj, cst = compile_j(flagship(hj)), compile_t(flagship(ht))
    n_cap, n_cand, m = 64, 128, 4
    kj = tpe_j.get_kernel(csj, n_cap, n_cand, 25)
    assert (kj.pallas_ei, kj.ei_precision) == \
        (kw["ei_impl"], kw["ei_precision"])
    kt = tpe_t.get_kernel(cst, n_cap, n_cand, 25, device="cpu", **kw)
    cat = [p.pid for p in cst.params if p.is_int]
    for seed in range(3):
        n_rows = 40 + 3 * seed
        hist = tpe_j._padded_history(_history(csj, n_rows, seed), n_cap)
        want, _ = kj.suggest_many_seeded(seed, m, n_rows,
                                         *(jnp.asarray(a) for a in hist),
                                         0.25, 1.0)
        keys = jax.random.split(prng_key(np.uint32(seed)), m)
        got, acts = kt.suggest_many(
            m, n_rows, *(torch.as_tensor(a) for a in hist), 0.25, 1.0,
            noises=[_jax_step_uniforms(key, kj) for key in keys])
        want = np.asarray(want)
        np.testing.assert_array_equal(got.numpy()[:, cat], want[:, cat])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(acts.numpy(),
                                      csj.active_mask_host(want))


def test_liar_scan_leaves_its_inputs_alone():
    cst = compile_t(flagship(ht))
    h = _history(compile_j(flagship(hj)), 30, 0)
    hist = [torch.as_tensor(a) for a in tpe_t._padded_history(h, 64)]
    before = [t.clone() for t in hist]
    kt = tpe_t.get_kernel(cst, 64, 32, 25, device="cpu")
    kt.suggest_many(4, 30, *hist, 0.25, 1.0,
                    generator=torch.Generator().manual_seed(0))
    for a, b in zip(hist, before):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        kt.suggest_many(8, 60, *hist, 0.25, 1.0)


@pytest.mark.parametrize("n,m", [(1, 1), (2, 2), (3, 4), (5, 8), (8, 8),
                                 (9, 16), (32, 32)])
def test_batch_size_for_is_next_power_of_two(n, m):
    assert tpe_t._batch_size_for(n) == tpe_j._batch_size_for(n) == m


def _done_trials(n, seed=0):
    cst = compile_t(flagship(ht))
    cst.device = "cpu"
    h = _history(compile_j(flagship(hj)), n, seed)
    trials = ht.Trials()
    docs = ht.base.docs_from_samples(cst, trials.new_trial_ids(n), h["vals"],
                                     h["active"])
    for d, lv in zip(docs, h["loss"]):
        d["state"], d["result"] = ht.JOB_STATE_DONE, {"loss": float(lv),
                                                      "status": "ok"}
    trials.insert_trial_docs(docs)
    trials.refresh()
    return ht.Domain(lambda d: 0.0, cst), trials


def test_partial_batch_slices_the_surplus_rows():
    """Five proposals run eight liar steps; the first five rows are those
    of the eight-proposal batch with the same seed, and one fetch brings
    the whole batch."""
    domain, trials = _done_trials(30)
    h5 = tpe_t.suggest_dispatch(list(range(30, 35)), domain, trials, 7,
                                n_EI_candidates=32)
    assert h5[0] == "pending" and tuple(h5[3].rows.shape) == \
        (8, domain.cs.n_params)
    v5, a5 = tpe_t._force_rows(h5)
    v8, _ = tpe_t.suggest_batch(list(range(30, 38)), domain, trials, 7,
                                n_EI_candidates=32)
    assert v5.shape == (5, domain.cs.n_params)
    np.testing.assert_array_equal(v5, v8[:5])
    np.testing.assert_array_equal(a5, domain.cs.active_mask_host(v5))


def test_bad_lowering_arguments_raise():
    domain, trials = _done_trials(25)
    for bad in (dict(ei_impl="tpu"), dict(ei_precision="f16"),
                dict(ei_topm=-1), dict(ei_topm=2.5)):
        with pytest.raises(ValueError):
            tpe_t.suggest([25], domain, trials, 0, **bad)


def test_ei_topm_truncates_the_above_model(monkeypatch):
    """``ei_topm`` hands the kernel the top-M above components only."""
    domain, trials = _done_trials(30)
    widths = []
    real = tpe_t.ei_scores

    def spy(z, *mix, **kw):
        widths.append(mix[3].shape[1])
        return real(z, *mix, **kw)

    monkeypatch.setattr(tpe_t, "ei_scores", spy)
    tpe_t.suggest([30], domain, trials, 0, n_EI_candidates=16, ei_topm=5)
    assert widths and set(widths) == {5}


@pytest.mark.parametrize("low", sorted(LOWERINGS))
def test_max_queue_len_batched_tpe(low):
    """Mirror of tests/test_fmin.py::test_max_queue_len_batched_tpe: each
    post-startup batch of 8 spreads over the domain (the liar's fantasy
    refits), and the run still converges."""
    trials = ht.Trials()
    algo = partial(ht.tpe.suggest, n_startup_jobs=8, n_EI_candidates=32,
                   **LOWERINGS[low][1])
    best = ht.fmin(q1, SPACE1, algo=algo, max_evals=32, max_queue_len=8,
                   trials=trials, rstate=np.random.default_rng(0),
                   show_progressbar=False, device="cpu")
    assert len(trials) == 32
    xs_all = [d["misc"]["vals"]["x"][0] for d in trials.trials]
    assert len(set(xs_all[24:32])) == 8
    for lo in (8, 16, 24):
        batch = xs_all[lo:lo + 8]
        assert max(batch) - min(batch) > 2.0
    assert q1(best) < 1.0


@pytest.mark.parametrize("low", sorted(LOWERINGS))
def test_max_queue_len_deep_batch_q32(low):
    trials = ht.Trials()
    algo = partial(ht.tpe.suggest, n_startup_jobs=8, n_EI_candidates=32,
                   **LOWERINGS[low][1])
    ht.fmin(q1, SPACE1, algo=algo, max_evals=96, max_queue_len=32,
            trials=trials, rstate=np.random.default_rng(0),
            show_progressbar=False, device="cpu")
    assert len(trials) == 96
    xs_all = [d["misc"]["vals"]["x"][0] for d in trials.trials]
    for lo in (32, 64):
        batch = xs_all[lo:lo + 32]
        assert len(set(batch)) == 32
        assert max(batch) - min(batch) > 2.0


@pytest.mark.parametrize("low", sorted(LOWERINGS))
def test_max_queue_len_partial_final_batch(low):
    trials = ht.Trials()
    algo = partial(ht.tpe.suggest, n_startup_jobs=8, n_EI_candidates=32,
                   **LOWERINGS[low][1])
    ht.fmin(q1, SPACE1, algo=algo, max_evals=30, max_queue_len=8,
            trials=trials, rstate=np.random.default_rng(0),
            show_progressbar=False, device="cpu")
    assert len(trials) == 30
    assert all(len(d["misc"]["vals"]["x"]) == 1 for d in trials.trials)


@pytest.mark.parametrize("low", sorted(LOWERINGS))
def test_batched_liar_composes_with_each_lowering(low):
    """Mirror of tests/test_pallas.py::test_batched_liar_composes_with_pallas:
    each liar step calls the picked scorer once (one launch per step on
    the card; here its plain twin)."""
    calls = []
    real = ei_mod.ei_scores_reference

    def counted(*a, **kw):
        calls.append(ei_mod.lowering(**kw))
        return real(*a, **kw)

    t = ht.Trials()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ei_mod, "ei_scores_reference", counted)
        ht.fmin(q1, SPACE1,
                algo=partial(ht.tpe.suggest, n_startup_jobs=8,
                             n_EI_candidates=64, **LOWERINGS[low][1]),
                max_evals=24, max_queue_len=8, trials=t,
                rstate=np.random.default_rng(0), show_progressbar=False,
                device="cpu")
    assert len(t) == 24
    assert t.best_trial["result"]["loss"] < 1.0
    assert calls == [low] * 16        # two batches of 8 past startup


# Proposals of the serial loop before batched proposals existed, under
# rstate=default_rng(3) (the run of test_max_queue_len_one_is_unchanged).
_SERIAL_X = [
    -3.8727803230285645, 1.5110926628112793, -4.355318069458008,
    -2.1909666061401367, 1.7716798782348633, 4.587578773498535,
    1.6412181854248047, 3.930678367614746, -1.0548944473266602,
    2.1734132766723633, -0.27171874046325684, -2.724461555480957,
    3.4116830825805664, 0.5994628667831421, 3.0811069011688232,
    -1.2170870304107666, 0.5960569381713867, 0.6899442672729492,
    2.5444083213806152, 0.872367799282074, -0.25750166177749634,
    4.519169807434082, -1.1104202270507812, 1.1556528806686401]
_SERIAL_LR = [
    0.020373668521642685, 0.6198827028274536, 0.13793031871318817,
    0.9772056341171265, 0.026653354987502098, 0.9612132906913757,
    0.24027904868125916, 0.17178799211978912, 0.0519833080470562,
    0.33512723445892334, 0.0576581135392189, 0.3097648024559021,
    0.06616634875535965, 0.40550824999809265, 0.19711698591709137,
    0.09023954719305038, 0.03241598606109619, 0.44037505984306335,
    0.24927185475826263, 0.5741604566574097, 0.10586024075746536,
    0.6746571660041809, 0.4049944281578064, 0.23307573795318604]
_SERIAL_C = [0, 2, 0, 2, 1, 2, 2, 2, 2, 2, 1, 2, 2, 2, 1, 0, 2, 2, 2, 2,
             2, 2, 2, 2]


@pytest.mark.parametrize("resident", [True, False])
def test_max_queue_len_one_is_unchanged(resident):
    hp = ht.hp
    space = {"x": hp.uniform("x", -5, 5), "lr": hp.loguniform("lr", -4, 0),
             "c": hp.choice("c", [0, 1, 2])}
    t = ht.Trials()
    ht.fmin(lambda d: (d["x"] - 1) ** 2 + abs(np.log(d["lr"]) + 2)
            + 0.1 * d["c"], space,
            algo=partial(ht.tpe.suggest, n_startup_jobs=5, n_EI_candidates=32,
                         resident=resident),
            max_evals=24, trials=t, rstate=np.random.default_rng(3),
            show_progressbar=False, device="cpu", max_queue_len=1)
    for label, want in (("x", _SERIAL_X), ("lr", _SERIAL_LR),
                        ("c", _SERIAL_C)):
        got = [d["misc"]["vals"][label][0] for d in t.trials]
        np.testing.assert_array_equal(np.float32(got), np.float32(want))

"""The TPE step and the hosted loop of the PyTorch port against
hyperopt_tpu.

* ``_split``: ``tests/test_torch_tpe_lowerings.py``, against both of JAX's
  split lowerings.
* The whole step, handed the uniforms the JAX step draws from its key
  schedule, proposes the JAX step's row.  The JAX step runs its Pallas EI
  kernel in interpret mode (``HYPEROPT_TPU_PALLAS=interpret``), as
  ``tests/test_pallas.py`` does.
* ``fmin`` on two zoo domains reaches the JAX package's median best loss
  within a stated tolerance (the two use different random streams, so
  runs are compared as distributions, not trial by trial).
* ``convert`` carries a JAX ``Trials`` over with an identical history.
"""

import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import tpe as tpe_j
from hyperopt_tpu.space import compile_space as compile_j
from hyperopt_tpu_torch import convert
from hyperopt_tpu_torch import tpe as tpe_t
from hyperopt_tpu_torch.ops.gmm import truncate_mixture
from hyperopt_tpu_torch.space import compile_space as compile_t
from zoo import ZOO

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def flagship(pkg, n_dims=10):
    hp = pkg.hp
    space = {}
    for i in range(n_dims // 5):
        space[f"u{i}"] = hp.uniform(f"u{i}", -5.0, 5.0)
        space[f"lu{i}"] = hp.loguniform(f"lu{i}", -4.0, 2.0)
        space[f"q{i}"] = hp.quniform(f"q{i}", 0.0, 20.0, 2.0)
        space[f"n{i}"] = hp.normal(f"n{i}", 0.0, 2.0)
        space[f"c{i}"] = hp.choice(f"c{i}", [0, 1, 2, 3])
    space["branch"] = hp.choice("branch", [
        {"kind": "a", "lr": hp.loguniform("lr", -6.0, 0.0)},
        {"kind": "b", "depth": hp.uniformint("depth", 1, 8)},
    ])
    space["k"] = hp.pchoice("k", [(0.2, "x"), (0.8, "y")])
    return space


def wide_q(pkg):
    """Quantized columns without a small lattice: scored per candidate."""
    hp = pkg.hp
    return {"wq": hp.quniform("wq", 0.0, 1e5, 1.0),
            "nq": hp.qnormal("nq", 0.0, 20.0, 1.0),
            "lq": hp.qlognormal("lq", 1.0, 1.0, 0.5)}


def _history(csj, n, seed):
    vals = np.asarray(csj.sample(jax.random.key(seed), n)[0])
    rng = np.random.default_rng(seed)
    loss = (np.square(vals[:, :4]).sum(1)
            + rng.normal(0, 0.1, n)).astype(np.float32)
    return dict(vals=vals, active=csj.active_mask_host(vals), loss=loss,
                ok=np.ones(n, bool))


def _jax_step_uniforms(key, kern):
    """The uniforms the JAX step draws: split(key, 1+groups) (tpe.py:820),
    split(kg, len(g)) per group (tpe.py:610), kc, ku = split(k) and two
    uniforms per column (gmm.py:293-319), uniform(k_cat, (D, n_cand))
    (tpe.py:765)."""
    n = kern.n_cand
    k_cat, *k_cont = jax.random.split(key, 1 + len(kern.groups))
    cont = []
    for g, kg in zip(kern.groups, k_cont):
        ucs, us = [], []
        for k in jax.random.split(kg, len(g)):
            kc, ku = jax.random.split(k)
            ucs.append(np.asarray(jax.random.uniform(kc, (n,), jnp.float32)))
            us.append(np.asarray(jax.random.uniform(ku, (n,), jnp.float32)))
        cont.append((torch.as_tensor(np.stack(ucs)),
                     torch.as_tensor(np.stack(us))))
    cat = np.asarray(jax.random.uniform(
        k_cat, (len(kern.cat_pids), n), jnp.float32))
    return {"cont": cont, "cat": torch.as_tensor(cat)}


@pytest.mark.parametrize("seed", range(3))
def test_step_with_jax_uniforms_proposes_jax_row(monkeypatch, seed):
    monkeypatch.setenv("HYPEROPT_TPU_PALLAS", "interpret")
    csj, cst = compile_j(flagship(hj)), compile_t(flagship(ht))
    n_cap, n_cand = 64, 128
    hist = tpe_j._padded_history(_history(csj, 50, seed), n_cap)
    kj = tpe_j.get_kernel(csj, n_cap, n_cand, 25)
    kt = tpe_t.get_kernel(cst, n_cap, n_cand, 25, device="cpu")
    assert [list(g.pids) for g in kj.groups] == \
        [list(g.pids) for g in kt.groups]
    key = jax.random.key(100 + seed)
    # kj._fn is the kernel's jitted _suggest_one (its row is
    # _suggest_one_tel's), compiled once for all seeds.
    want, _ = kj._fn(key, *(jnp.asarray(a) for a in hist), np.float32(0.25),
                     np.float32(1.0))
    got, act = kt(*(torch.as_tensor(a) for a in hist), 0.25, 1.0,
                  noise=_jax_step_uniforms(key, kj))
    want = np.asarray(want)
    cat = [p.pid for p in cst.params if p.is_int]
    np.testing.assert_array_equal(got.numpy()[cat], want[cat])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(act.numpy(),
                                  csj.active_mask_host(want[None])[0])


def test_per_candidate_q_scores_match_jax(monkeypatch):
    """The per-candidate quantized path, on a 1e5-wide q=1 lattice.  Draws
    agree to f32 rounding, so a candidate whose unrounded value sits on a
    rounding edge may land one lattice step away (at most 3% of them
    here); every other candidate has the same value and a score within
    2e-2.  The scores are log(Φ(b) - Φ(a)) of bins far narrower than the
    mixture's sigmas, which cancels in f32 to ~1e-3 relative in either
    package, so near-equal candidates can swap places in the argmax
    (ROADMAP, Queue 3)."""
    monkeypatch.setenv("HYPEROPT_TPU_PALLAS", "interpret")
    csj, cst = compile_j(wide_q(hj)), compile_t(wide_q(ht))
    hist = tpe_j._padded_history(_history(csj, 40, 0), 64)
    kj = tpe_j.get_kernel(csj, 64, 128, 25)
    kt = tpe_t.get_kernel(cst, 64, 128, 25, device="cpu")
    (g,), (gt,) = kj.groups, kt._gt
    assert g.is_q and not getattr(g, "use_lattice", False)
    key = jax.random.key(5)
    noise = _jax_step_uniforms(key, kj)
    _, k_g = jax.random.split(key)

    @jax.jit
    def scores_j(vals, active, loss, ok):
        below, above = kj._split(loss, ok, np.float32(0.25))
        return kj._cont_scores(g, k_g, vals, active, below, above,
                               np.float32(1.0))

    vj, eij = scores_j(*(jnp.asarray(a) for a in hist))
    ht_ = [torch.as_tensor(a) for a in hist]
    below, above = kt._split(ht_[2], ht_[3], 0.25)
    vt, eit = kt._cont_scores(kt.groups[0], gt, ht_[0], ht_[1], below,
                              above, 1.0, *noise["cont"][0])
    vt, vj = vt.numpy(), np.asarray(vj)
    same = vt == vj
    assert same.mean() >= 0.97
    assert (np.abs(vt - vj) <= kt.groups[0].q[:, None]).all()
    np.testing.assert_allclose(eit.numpy()[same], np.asarray(eij)[same],
                               atol=2e-2)


def test_batched_proposals_past_startup_are_refused():
    """No longer refused: ``n > 1`` past startup runs the constant-liar
    scan (``tests/test_torch_liar.py``) and returns one doc per id, as a
    single proposal does."""
    cst = compile_t(flagship(ht))
    cst.device = "cpu"
    h = _history(compile_j(flagship(hj)), 30, 0)
    trials = ht.Trials()
    docs = ht.base.docs_from_samples(cst, trials.new_trial_ids(30), h["vals"],
                                     h["active"])
    for d, lv in zip(docs, h["loss"]):
        d["state"], d["result"] = ht.JOB_STATE_DONE, {"loss": float(lv),
                                                      "status": "ok"}
    trials.insert_trial_docs(docs)
    trials.refresh()
    domain = ht.Domain(lambda d: 0.0, cst)
    docs = tpe_t.suggest([30, 31], domain, trials, 0)
    assert [d["tid"] for d in docs] == [30, 31]
    assert docs[0]["misc"]["vals"] != docs[1]["misc"]["vals"]
    assert len(tpe_t.suggest([30], domain, trials, 0)) == 1


# The zoo domains' spaces, built with the port's hp (tests/zoo.py).
PORT_SPACES = {
    "quadratic1": lambda hp: {"x": hp.uniform("x", -5, 5)},
    "q1_lognormal": lambda hp: {"x": hp.qlognormal("x", 0.0, 1.0, 1.0)},
    "n_arms": lambda hp: {"arm": hp.choice("arm", list(range(6)))},
}


@pytest.mark.parametrize("name", sorted(PORT_SPACES))
def test_fmin_quality_parity(name):
    """Median best loss over seeds 0-2 within half the distance between
    the zoo's TPE threshold and the optimum of hyperopt_tpu's median, and
    both at or under the threshold."""
    z = ZOO[name]
    budget = min(z.budget, 60)
    algo_kw = dict(n_EI_candidates=64)
    best_j, best_t = [], []
    for seed in range(3):
        tj, tt = hj.Trials(), ht.Trials()
        hj.fmin(z.fn, z.space, algo=partial(hj.tpe.suggest, **algo_kw),
                max_evals=budget, trials=tj,
                rstate=np.random.default_rng(seed), show_progressbar=False)
        ht.fmin(z.fn, PORT_SPACES[name](ht.hp),
                algo=partial(ht.tpe.suggest, **algo_kw), max_evals=budget,
                trials=tt, rstate=np.random.default_rng(seed),
                show_progressbar=False, device="cpu")
        assert len(tt) == budget
        best_j.append(tj.best_trial["result"]["loss"])
        best_t.append(tt.best_trial["result"]["loss"])
    tol = 0.5 * abs(z.tpe_thresh - z.best_loss)
    mj, mt = np.median(best_j), np.median(best_t)
    assert mt <= z.tpe_thresh and mj <= z.tpe_thresh, (best_t, best_j)
    assert abs(mt - mj) <= tol, (best_t, best_j)


def test_trials_from_jax_docs_history_equal():
    space_j = flagship(hj)
    tj = hj.Trials()
    hj.fmin(lambda d: d["u0"] ** 2 + d["q0"], space_j, algo=hj.rand.suggest,
            max_evals=16, trials=tj, rstate=np.random.default_rng(0),
            show_progressbar=False)
    tt = convert.trials_from_jax_docs(tj)
    csj, cst = compile_j(space_j), compile_t(flagship(ht))
    hjx, htx = tj.history(csj), tt.history(cst)
    for k in ("vals", "active", "loss", "ok", "tids"):
        np.testing.assert_array_equal(htx[k], hjx[k])
    assert tt.argmin == tj.argmin
    ten = convert.history_from_numpy(hjx, "cpu")
    assert ten["vals"].dtype == torch.float32
    assert ten["ok"].dtype == torch.bool
    np.testing.assert_array_equal(ten["loss"].numpy(), hjx["loss"])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _is_prefix(lw):
    live = torch.isfinite(lw)
    return bool((live[..., 1:] <= live[..., :-1]).all())


@pytest.mark.parametrize("n,n_cap", [(50, 64), (100, 128)])
def test_fitted_mixtures_keep_live_components_first(n, n_cap):
    """The premise of the EI kernels' dead-tail stop: in every column of
    the fits the step scores, below and above, and of their top-m
    truncation, the finite log-weights form a prefix.  The space is
    chip_smoke's 10-dim flagship with the conditional ``lr`` and
    ``depth``, inactive in part of the history.  (The kernels stay right
    without it: a dead component anywhere adds exactly 0.)"""
    smoke = _chip_smoke()
    cs = compile_t(smoke.flagship_space(10))
    h = smoke.synthetic_trials(cs, n, 3, "cpu").history(cs)
    vals, active, loss, ok = (torch.as_tensor(a) for a in
                              tpe_t._padded_history(h, n_cap))
    cond = [p.pid for p in cs.params if p.label in ("lr", "depth")]
    assert len(cond) == 2
    assert not bool(active[:n, cond].all())         # inactive trials
    assert bool(active[:n, cond].any(dim=0).all())  # and active ones
    kern = tpe_t.get_kernel(cs, n_cap, 128, 25, device="cpu")
    below, above = kern._split(loss, ok, 0.25)
    n_fits = dead_tails = 0
    for gt in kern._gt:
        lwb, mub, sgb, lwa, mua, sga = kern._cont_fit(
            gt, vals, active, below, above, 1.0)
        for lw in (lwb, lwa):
            assert _is_prefix(lw)
            n_fits += lw.shape[0]
            dead_tails += int((~torch.isfinite(lw[:, -1])).sum())
        for m in (1, 8, 40, n_cap):
            assert _is_prefix(truncate_mixture(lwa, mua, sga, m)[0])
    assert n_fits == 2 * 10 and dead_tails == n_fits  # 10 fitted columns

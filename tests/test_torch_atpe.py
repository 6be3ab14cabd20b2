"""``atpe.py`` and ``utils.parameter_importance`` of the PyTorch port
against hyperopt_tpu.

* ``_portfolio`` (tiers on and off), ``_fingerprint`` and
  ``_space_features`` equal JAX's exactly; ``parameter_importance``
  within 1e-12 absolute (float64 numpy in both); ``_apply_lockout`` rows
  and masks exact.
* A transfer file the JAX package wrote loads to the same counts
  (exact), and seeds the same posteriors.
* Over a fixed history with fixed losses, the arms ATPE picks equal JAX's
  call for call (the Thompson draws are the same numpy stream; the losses
  do not depend on the rows the arms propose, which on JAX's side come
  from its random sampler to spare its TPE compiles).
* ``extra_algos`` arms, the arm prewarm's kernels, and ``tests/
  test_aux.py``'s transfer-store behaviours.
"""

import copy
import json

import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import atpe as atpe_j
from hyperopt_tpu import utils as utils_j
from hyperopt_tpu_torch import atpe, tpe, utils

CPU = "cpu"
IMP_ATOL = 1e-12


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("HYPEROPT_TPU_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("HYPEROPT_TPU_ATPE_TRANSFER", "0")
    old = atpe.set_transfer_store(None)
    yield
    atpe.set_transfer_store(old)
    torch.set_num_threads(n)


def mixed(pkg):
    hp = pkg.hp
    return {
        "x": hp.uniform("x", -5, 5),
        "noise": hp.uniform("noise", -5, 5),
        "lr": hp.loguniform("lr", -4, 0),
        "q": hp.quniform("q", 0, 10, 1),
        "n": hp.normal("n", 0, 2),
        "c": hp.choice("c", [0, 1, 2]),
        "ri": hp.randint("ri", 4),
        "br": hp.choice("br", [{"k": 0},
                               {"k": 1, "w": hp.uniformint("w", 1, 8)}]),
    }


def wide(pkg, n=60):
    return {f"p{i}": pkg.hp.uniform(f"p{i}", -1, 1) for i in range(n)}


def _loss(vals):
    return float(vals["x"][0] ** 2 + 3.0 * vals["c"][0]
                 + 0.1 * abs(vals["n"][0]))


def _pair(n, seed=0):
    dj = hj.base.Domain(lambda cfg: 0.0, mixed(hj))
    dt = ht.Domain(lambda cfg: 0.0, mixed(ht))
    dt.cs.device = CPU
    docs = hj.rand.suggest(list(range(n)), dj, hj.Trials(), seed)
    for d in docs:
        d["state"] = hj.JOB_STATE_DONE
        d["result"] = {"status": "ok", "loss": _loss(d["misc"]["vals"])}
    tj, tt = hj.Trials(), ht.Trials()
    for t in (tj, tt):
        t.insert_trial_docs(copy.deepcopy(docs))
        t.refresh()
    return dj, tj, dt, tt


@pytest.mark.parametrize("space_fn", [mixed, wide])
@pytest.mark.parametrize("tiers", [True, False])
def test_portfolio_features_fingerprint_equal_jax(monkeypatch, space_fn,
                                                  tiers):
    monkeypatch.setenv("HYPEROPT_TPU_ATPE_TIERS", "1" if tiers else "0")
    csj = hj.compile_space(space_fn(hj))
    cst = ht.compile_space(space_fn(ht))
    assert atpe._portfolio(cst, tiers=tiers) == atpe_j._portfolio(csj)
    assert atpe._space_features(cst) == atpe_j._space_features(csj)
    assert atpe._fingerprint(cst) == atpe_j._fingerprint(csj)
    assert atpe._tier(41) == atpe_j._tier(41) == 64


def test_flagship_width_tiers():
    """The 53-parameter flagship space: base tier 256 (``24·√53`` = 174.7
    snapped up), arms at 256 and 512 EI candidates."""
    hp = ht.hp
    space = {}
    for i in range(10):
        space.update({f"u{i}": hp.uniform(f"u{i}", -5, 5),
                      f"lu{i}": hp.loguniform(f"lu{i}", -4, 2),
                      f"q{i}": hp.quniform(f"q{i}", 0, 20, 2),
                      f"n{i}": hp.normal(f"n{i}", 0, 2),
                      f"c{i}": hp.choice(f"c{i}", [0, 1, 2, 3])})
    space["branch"] = hp.choice("branch", [
        {"lr": hp.loguniform("lr", -6, 0)},
        {"depth": hp.uniformint("depth", 1, 8)}])
    cs = ht.compile_space(space)
    assert cs.n_params == 53
    cands = sorted({a["n_EI_candidates"] for a in atpe._portfolio(cs)})
    assert cands == [256, 512]


@pytest.mark.parametrize("n", [5, 60])
def test_parameter_importance_equals_jax(n):
    dj, tj, dt, tt = _pair(n)
    want = atpe_j.parameter_importance(tj.history(dj.cs), dj.cs)
    got = atpe.parameter_importance(tt.history(dt.cs), dt.cs)
    np.testing.assert_allclose(got, want, rtol=0, atol=IMP_ATOL)
    assert (got < 1.0).any() == (n >= 8)


@pytest.mark.parametrize("frac", [0.34, 0.5, 0.75])
def test_apply_lockout_equals_jax(frac):
    dj, tj, dt, tt = _pair(60)
    rows = np.asarray(tj.history(dj.cs)["vals"][:8], np.float32) + 0.123
    acts = np.ones_like(rows, bool)
    want = atpe_j._apply_lockout(dj.cs, rows, acts, tj, tj.history(dj.cs),
                                 frac, np.random.default_rng(0))
    got = atpe._apply_lockout(dt.cs, rows, acts, tt, tt.history(dt.cs),
                              frac, np.random.default_rng(0))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert not np.array_equal(got[0], rows)


def test_utils_parameter_importance_equals_jax():
    dj, tj, dt, tt = _pair(60)
    want = utils_j.parameter_importance(tj, mixed(hj))
    got = utils.parameter_importance(tt, mixed(ht))
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= IMP_ATOL, k
    assert ht.parameter_importance is utils.parameter_importance


def test_jax_written_transfer_file_loads_the_same(tmp_path):
    path = tmp_path / "shared" / "atpe_transfer.json"
    csj = hj.compile_space(mixed(hj))
    cst = ht.compile_space(mixed(ht))
    n_arms = len(atpe._portfolio(cst))
    store_j = atpe_j._TransferStore(str(path))
    dw = np.arange(n_arms, dtype=float) * 7.0
    dl = np.full(n_arms, 3.0)
    store_j.flush(atpe_j._fingerprint(csj), dw, dl, n_new_exp=1,
                  features=atpe_j._space_features(csj))
    store_j.flush("other", np.ones(3) * 20, np.zeros(3), n_new_exp=1,
                  features=[0.5, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    atpe.set_transfer_store(path)
    store_t = atpe._TransferStore.default()
    assert store_t.path == str(path)
    fp = atpe._fingerprint(cst)
    for args in ((fp, n_arms), ("new-space", 5),
                 ("new-space", 5, [0.5, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])):
        feats = args[2] if len(args) > 2 else None
        w, l = store_t.load(args[0], args[1], features=feats)
        wj, lj = store_j.load(args[0], args[1], features=feats)
        np.testing.assert_array_equal(w, wj)
        np.testing.assert_array_equal(l, lj)
    st = atpe._state(ht.Trials(), cst, n_arms)
    w0, l0 = store_j.load(atpe_j._fingerprint(csj), n_arms)
    np.testing.assert_array_equal(st.wins, w0)
    rec = json.loads(path.read_text())[fp]
    assert rec["n_experiments"] == 2       # JAX's, then the port's


def test_arm_sequence_equals_jax(monkeypatch):
    """Eighteen suggests after a five-trial history, each trial then given
    the same loss in both packages: the arm picks agree call for call.
    The picks do not depend on the rows the arms propose, so JAX's side
    proposes by its random sampler in place of its TPE programs (their
    compiles would take most of a minute) and skips the arm prewarm; the
    port runs its real TPE arms."""
    def rand_rows(new_ids, domain, trials, seed, **kw):
        v, a = hj.rand.suggest_batch(new_ids, domain, trials, seed)
        return np.asarray(v), np.asarray(a)

    monkeypatch.setattr(atpe_j.tpe, "suggest_batch", rand_rows)
    monkeypatch.setattr(atpe_j, "_prewarm_arms", lambda *a, **k: None)
    dj, tj, dt, tt = _pair(5, seed=2)
    losses = np.random.default_rng(7).uniform(0, 10, 18)
    arms_j, arms_t = [], []
    for k, loss in enumerate(losses):
        tid, seed = 5 + k, 1000 + 31 * k
        docs = {"j": atpe_j.suggest([tid], dj, tj, seed, n_startup_jobs=5),
                "t": atpe.suggest([tid], dt, tt, seed, n_startup_jobs=5)}
        arms_j.append(tj._atpe_state.pending[tid][0])
        arms_t.append(tt._atpe_state.pending[tid][0])
        for key, t in (("j", tj), ("t", tt)):
            d = docs[key][0]
            d["state"] = hj.JOB_STATE_DONE
            d["result"] = {"status": "ok", "loss": float(loss)}
            t.insert_trial_docs([d])
            t.refresh()
    assert arms_t == arms_j
    assert len(set(arms_t)) >= 4
    np.testing.assert_array_equal(tt._atpe_state.wins, tj._atpe_state.wins)
    np.testing.assert_array_equal(tt._atpe_state.losses,
                                  tj._atpe_state.losses)


def test_prewarm_builds_each_arms_kernel():
    _, _, dt, tt = _pair(30)
    arms = atpe._portfolio(dt.cs)
    st = atpe._state(tt, dt.cs, len(arms))
    t = atpe._prewarm_arms(dt.cs, arms, st, len(tt), 25)
    t.join()
    assert atpe._prewarm_arms(dt.cs, arms, st, len(tt), 25) is None
    keys = set(dt.cs._tpe_kernels)
    for cfg in arms:
        k = (tpe._bucket(len(tt)), cfg["n_EI_candidates"],
             cfg.get("linear_forgetting", 25), CPU, cfg["split"], "sqrt",
             "vpu", "f32", 0, cfg.get("multivariate", False), "icdf")
        assert k in keys, cfg


def test_extra_algos_and_tiers_off():
    space = {"x": ht.hp.uniform("x", -2, 2)}
    t = ht.Trials()
    ht.fmin(lambda d: d["x"] ** 2, space, max_evals=24, trials=t,
            algo=ht.partial(atpe.suggest, extra_algos=("gp", "es"),
                            tiers=False, n_startup_jobs=6),
            rstate=np.random.default_rng(3), device=CPU,
            show_progressbar=False)
    st = t._atpe_state
    assert len(st.wins) == 6 + 2
    assert st.wins.sum() + st.losses.sum() > len(st.wins)
    assert t.best_trial["result"]["loss"] < 0.5


# -- tests/test_aux.py's transfer-store behaviours -----------------------------


def test_store_roundtrip_and_evidence_cap(tmp_path):
    atpe.set_transfer_store(tmp_path / "atpe_transfer.json")
    store = atpe._TransferStore.default()
    fp = "testfp"
    store.flush(fp, np.array([10.0, 0, 0]), np.array([0, 5.0, 0]),
                n_new_exp=1)
    store.flush(fp, np.array([30.0, 0, 0]), np.array([0, 15.0, 0]))
    rec = json.load(open(tmp_path / "atpe_transfer.json"))[fp]
    assert rec["wins"] == [40.0, 0, 0] and rec["n_experiments"] == 1
    w, l = store.load(fp, 3)
    assert np.allclose(w, [21.0, 1, 1]) and np.allclose(l, [1, 11.0, 1])
    w4, l4 = store.load(fp, 4)
    assert np.allclose(w4, 1.0) and np.allclose(l4, 1.0)
    (tmp_path / "atpe_transfer.json").write_text("{broken")
    w, l = store.load(fp, 3)
    assert np.allclose(w, 1.0)
    for bad in ('{"%s": {"wins": [1, 2, 3]}}' % fp,
                '{"%s": {"wins": [1, "x", 3], "losses": [1, 2, 3]}}' % fp,
                '{"%s": [1, 2]}' % fp):
        (tmp_path / "atpe_transfer.json").write_text(bad)
        w, l = store.load(fp, 3)
        assert np.allclose(w, 1.0) and np.allclose(l, 1.0), bad
        store.flush(fp, np.ones(3), np.zeros(3))
        assert json.load(open(tmp_path / "atpe_transfer.json"))[
            fp]["wins"] == [1.0, 1.0, 1.0]


def test_disabled_store_writes_nothing(tmp_path):
    assert atpe._TransferStore.default() is None
    ht.fmin(lambda d: d["x"] ** 2, {"x": ht.hp.uniform("x", -1, 1)},
            algo=atpe.suggest, max_evals=3, trials=ht.Trials(),
            rstate=np.random.default_rng(0), device=CPU,
            show_progressbar=False)
    assert not list(tmp_path.rglob("atpe_transfer.json"))


def test_seeded_posterior_and_neighbor_seeding(tmp_path):
    atpe.set_transfer_store(tmp_path / "t.json")
    hp = ht.hp
    trained = ht.compile_space({"x": hp.uniform("x", -3, 3),
                                "y": hp.normal("y", 0, 1),
                                "c": hp.choice("c", [0, 1, 2])})
    n_arms = len(atpe._portfolio(trained))
    k = 2
    dw, dl = np.zeros(n_arms), np.full(n_arms, 40.0)
    dw[k], dl[k] = 40.0, 0.0
    store = atpe._TransferStore.default()
    store.flush(atpe._fingerprint(trained), dw, dl, n_new_exp=1,
                features=atpe._space_features(trained))
    st = atpe._state(ht.Trials(), trained, n_arms)
    r = np.random.default_rng(0)
    assert np.mean([st.pick(r) == k for _ in range(60)]) > 0.6
    similar = ht.compile_space({"a": hp.uniform("a", -8, 8),
                                "b": hp.normal("b", 2, 5),
                                "d": hp.choice("d", [10, 20, 30])})
    assert atpe._fingerprint(similar) != atpe._fingerprint(trained)
    w, l = store.load(atpe._fingerprint(similar), n_arms,
                      features=atpe._space_features(similar))
    assert w.sum() + l.sum() > 2 * n_arms + 1
    different = ht.compile_space(
        {f"p{i}": hp.loguniform(f"p{i}", -6, 2) for i in range(30)})
    w2, l2 = store.load(atpe._fingerprint(different), n_arms,
                        features=atpe._space_features(different))
    assert np.allclose(w2, 1.0) and np.allclose(l2, 1.0)
    feats = [0.5, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    store.flush("other-space", np.array([20.0, 0.0, 0.0]),
                np.array([0.0, 20.0, 0.0]), n_new_exp=1, features=feats)
    w, l = store.load("new-space", 5, features=list(feats))
    assert w[0] > 1.0 and l[1] > 1.0
    assert np.allclose(w[3:], 1.0) and np.allclose(l[3:], 1.0)


def test_converges_with_lockout_arms():
    space = {f"x{i}": ht.hp.uniform(f"x{i}", -3, 3) for i in range(5)}
    t = ht.Trials()
    ht.fmin(lambda d: sum(d[f"x{i}"] ** 2 * (i + 1) for i in range(5)),
            space, algo=atpe.suggest, max_evals=50, trials=t,
            rstate=np.random.default_rng(2), device=CPU,
            show_progressbar=False)
    assert len(t) == 50 and t.best_trial["result"]["loss"] < 10.0
    st = t._atpe_state
    assert st.wins.sum() + st.losses.sum() > len(st.wins) * 2

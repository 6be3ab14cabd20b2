"""``backends/_codec.py``, ``gp.py`` and ``es.py`` of the PyTorch port
against hyperopt_tpu, on the same history and JAX's draws.

* ``encode``/``decode`` equal JAX's on a space with every family, both
  categorical encodings: exactly, except the log-scaled columns, where the
  two libraries' float32 ``log``/``exp`` differ by up to 2 ulps (encode
  atol 1.2e-7 in the unit cube, decode rtol 2.4e-7).
* GP: on JAX's candidate sweeps (``sample_traced(fold_in(PRNGKey(seed),
  i), n_cand)``) the proposals equal JAX's exactly, at 1 and 4 proposals,
  with and without the subset-of-data cap (``max_n`` 16 of a 64-row
  bucket).  The grid's pick is equal; its log marginal likelihoods agree
  within 1e-3 absolute and each liar step's standardized ``mu``, ``sigma``
  and EI within 1e-4 absolute (float32 Cholesky and reductions of the two
  libraries).  JAX's internals are read by spies inside its jitted
  program (ordered ``jax.debug.callback``).  A grid point that is not positive definite
  gives NaN factors in both and picks as JAX picks (NaN first).
* ES: on JAX's ``ε`` the proposals in the cube agree within 1e-5 and the
  replayed mean within 1e-5 (the generations' sums round in each
  library's order); decoded rows are equal in the discrete and quantized
  columns and within 2e-5 in the cube elsewhere.
* ``gp.introspect`` and ``obs.health.assess(suggest_fn=gp.suggest)`` on
  JAX's candidate draws: equal integers and verdicts, floats within
  rtol 1e-5 (float32 encode and erf, float64 numpy elsewhere).
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu.backends import _codec as codec_j
from hyperopt_tpu.backends import es as es_j
from hyperopt_tpu.backends import gp as gp_j
from hyperopt_tpu.obs import health as health_j
from hyperopt_tpu_torch.backends import _codec as codec_t
from hyperopt_tpu_torch.backends import es as es_t
from hyperopt_tpu_torch.backends import gp as gp_t
from hyperopt_tpu_torch.obs import health as health_t

CPU = "cpu"
GRID_ATOL = 1e-3     # log marginal likelihoods, O(10-100) in size
STEP_ATOL = 1e-4     # standardized mu, sigma, EI of a liar step
ES_ATOL = 1e-5       # ES proposals and mean in the unit cube
INTRO_RTOL = 1e-5    # introspect's floats
LOG_ENC_ATOL = 1.2e-7   # 2 float32 ulps of log in [0, 1]
LOG_DEC_RTOL = 2.4e-7   # 2 float32 ulps of exp


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def every_family(pkg):
    hp = pkg.hp
    return {
        "u": hp.uniform("u", -2.0, 3.0),
        "lu": hp.loguniform("lu", -3.0, 1.0),
        "qu": hp.quniform("qu", 0.0, 10.0, 2.5),
        "qlu": hp.qloguniform("qlu", 0.0, 4.0, 1.0),
        "n": hp.normal("n", 1.0, 2.0),
        "ln": hp.lognormal("ln", 0.0, 0.5),
        "qn": hp.qnormal("qn", 0.0, 3.0, 1.0),
        "ri": hp.randint("ri", 3, 9),
        "rw": hp.randint("rw", 0, 5000),
        "ui": hp.uniformint("ui", -2, 4),
        "pc": hp.pchoice("pc", [(0.2, "a"), (0.5, "b"), (0.3, "c")]),
        "br": hp.choice("br", [{"k": 0},
                               {"k": 1, "w": hp.uniform("w", 0.0, 1.0)}]),
    }


def _loss(vals):
    u = vals["u"][0]
    return float((u - 0.7) ** 2 + 0.1 * vals["pc"][0]
                 + 0.01 * abs(vals["n"][0]) + 0.001 * vals["rw"][0] / 50)


def _pair(n, seed=3, space_fn=every_family):
    """The same ``n`` finished trials in both packages."""
    dj = hj.base.Domain(lambda cfg: 0.0, space_fn(hj))
    dt = ht.Domain(lambda cfg: 0.0, space_fn(ht))
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


def _vals(docs):
    return [(d["tid"], d["misc"]["vals"]) for d in docs]


# -- codec ----------------------------------------------------------------------


@pytest.mark.parametrize("cat", ["index", "unit"])
def test_codec_equals_jax(cat):
    dj, tj, dt, _ = _pair(64)
    h = tj.history(dj.cs)
    mj = codec_j.unit_meta(dj.cs)
    mt = codec_t.unit_meta(dt.cs)
    for k in mj:
        np.testing.assert_array_equal(mt[k], mj[k], err_msg=k)
    meta = codec_t.meta_tensors(mt, CPU)
    log = mt["is_log"]
    want = np.asarray(codec_j.encode(mj, jnp.asarray(h["vals"]),
                                     jnp.asarray(h["active"]), cat=cat))
    got = codec_t.encode(meta, torch.as_tensor(h["vals"]),
                         torch.as_tensor(h["active"]), cat=cat).numpy()
    np.testing.assert_array_equal(got[:, ~log], want[:, ~log])
    np.testing.assert_allclose(got[:, log], want[:, log], rtol=0,
                               atol=LOG_ENC_ATOL)
    z = np.random.default_rng(0).uniform(-0.1, 1.1, (200, dt.cs.n_params))
    z = z.astype(np.float32)
    z[:4] = [[0.0], [1.0], [0.5], [0.999999]]
    want = np.asarray(codec_j.decode(mj, jnp.asarray(z)))
    got = codec_t.decode(meta, torch.as_tensor(z)).numpy()
    np.testing.assert_array_equal(got[:, ~log], want[:, ~log])
    np.testing.assert_allclose(got[:, log], want[:, log], rtol=LOG_DEC_RTOL)


# -- GP -------------------------------------------------------------------------


def jax_gp_cand(cs_j, seed, m, n_cand):
    """JAX's candidate sweeps of one GP dispatch."""
    # Jitted, as inside JAX's program: eager draws may round differently
    # (an unfused multiply-add).
    def draws(seed):
        key = jax.random.PRNGKey(seed)
        return [cs_j.sample_traced(jax.random.fold_in(key, i), n_cand)
                for i in range(m)]

    out = jax.jit(draws)(np.uint32(int(seed) % (2 ** 32)))
    return [tuple(np.asarray(a) for a in pair) for pair in out]


def _record(store):
    """A spy body: inside JAX's jitted program, hand the value out through
    an ordered ``jax.debug.callback``; values of a ``vmap`` (the grid's
    Cholesky fits) are skipped."""
    def record(x):
        if type(x).__name__ == "BatchTracer":
            return
        jax.debug.callback(lambda v: store.append(np.asarray(v)), x,
                           ordered=True)
    return record


class JaxGpSpy:
    """JAX's grid scores and each liar step's ``mu``, ``sigma`` and EI, read
    from the ``argmax``, ``cho_solve`` and ``solve_triangular`` calls of
    its jitted program."""

    def __init__(self, monkeypatch):
        self.argmax, self.alpha, self.kstar_t, self.v = [], [], [], []
        orig_argmax = jnp.argmax
        orig_cho = jax.scipy.linalg.cho_solve
        orig_tri = jax.scipy.linalg.solve_triangular
        rec_argmax, rec_alpha = _record(self.argmax), _record(self.alpha)
        rec_kt, rec_v = _record(self.kstar_t), _record(self.v)

        def argmax(x, *a, **k):
            # 1-D: the grid's scores and a step's EI (the categorical
            # draws of sample_traced are 3-D).
            if jnp.ndim(x) == 1:
                rec_argmax(x)
            return orig_argmax(x, *a, **k)

        def cho_solve(cf, b, *a, **k):
            out = orig_cho(cf, b, *a, **k)
            rec_alpha(out)
            return out

        def solve_triangular(a, b, *args, **k):
            out = orig_tri(a, b, *args, **k)
            rec_kt(b)
            rec_v(out)
            return out

        monkeypatch.setattr(jnp, "argmax", argmax)
        monkeypatch.setattr(jax.scipy.linalg, "cho_solve", cho_solve)
        monkeypatch.setattr(jax.scipy.linalg, "solve_triangular",
                            solve_triangular)

    def steps(self, noise):
        """``(mu, sigma, ei)`` per liar step."""
        out = []
        for alpha, kt, v, ei in zip(self.alpha, self.kstar_t, self.v,
                                    self.argmax[1:]):
            mu = kt.T.astype(np.float64) @ alpha
            var = np.clip(1.0 + noise - np.sum(v.astype(np.float64) ** 2, 0),
                          1e-9, None)
            out.append((mu, np.sqrt(var), ei))
        return out


def _run_jax(fn, seed, hist):
    out = np.asarray(fn(np.uint32(seed), *map(jnp.asarray, hist)))
    jax.effects_barrier()
    return out


@pytest.mark.parametrize("n,n_hist,max_n", [(1, 24, 256), (4, 40, 16)])
def test_gp_rows_equal_jax_on_jax_candidates(monkeypatch, n, n_hist, max_n):
    monkeypatch.setenv("HYPEROPT_TPU_GP_MAX_N", str(max_n))
    dj, tj, dt, tt = _pair(n_hist)
    ids = list(range(n_hist, n_hist + n))
    m = ht.tpe._batch_size_for(n)
    seed = 2 ** 32 + 7 * n
    cand = jax_gp_cand(dj.cs, seed, m, 32)
    want = gp_j.suggest(ids, dj, tj, seed, n_EI_candidates=32)
    got = gp_t.suggest(ids, dt, tt, seed, n_EI_candidates=32,
                       max_n=max_n, cand=cand)
    assert _vals(got) == _vals(want)


@pytest.mark.parametrize("n_hist,max_n", [(24, 256), (40, 16)])
def test_gp_grid_and_steps_agree_with_jax(monkeypatch, n_hist, max_n):
    monkeypatch.setenv("HYPEROPT_TPU_GP_MAX_N", str(max_n))
    dj, tj, dt, tt = _pair(n_hist)
    m, seed = 4, 5
    cand = jax_gp_cand(dj.cs, seed, m, 32)
    h = tj.history(dj.cs)
    n_cap = ht.tpe._bucket(len(h["loss"]))
    hist = ht.history._padded_history(h, n_cap)
    spy = JaxGpSpy(monkeypatch)
    fn = gp_j._build_suggest_fn(dj.cs, n_cap, 32, m, max_n)
    want_rows = _run_jax(fn, seed, hist)
    prog = gp_t._GpProgram(dt.cs, n_cap, 32, m, max_n, torch.device(CPU))
    trace = []
    rows = prog(*map(torch.as_tensor, hist), cand=cand, trace=trace)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    grid, steps = trace[0], trace[1:]
    assert int(grid["pick"]) == int(np.argmax(spy.argmax[0]))
    np.testing.assert_allclose(grid["scores"].numpy(), spy.argmax[0],
                               atol=GRID_ATOL)
    noise = float(prog.noise_grid[int(grid["pick"])])
    want_steps = spy.steps(noise)
    assert len(want_steps) == len(steps) == m
    for st, (mu, sigma, ei) in zip(steps, want_steps):
        np.testing.assert_allclose(st["mu"].numpy(), mu, atol=STEP_ATOL)
        np.testing.assert_allclose(st["sigma"].numpy(), sigma,
                                   atol=STEP_ATOL)
        np.testing.assert_allclose(st["ei"].numpy(), ei, atol=STEP_ATOL)
        assert int(st["pick"]) == int(np.argmax(ei))


def test_non_pd_grid_point_picks_as_jax(monkeypatch):
    """A grid point with negative noise is indefinite: JAX's Cholesky is
    NaN there, the port's factor is set to NaN, and both argmaxes take the
    NaN (first), so the picks and the rows agree."""
    bad = np.asarray([1e-4, -2.0], np.float32)
    monkeypatch.setattr(gp_j, "_NOISE_GRID", bad)
    monkeypatch.setattr(gp_t, "_NOISE_GRID", bad)
    dj, tj, dt, tt = _pair(24)
    h = tj.history(dj.cs)
    hist = ht.history._padded_history(h, 32)
    spy = JaxGpSpy(monkeypatch)
    fn = gp_j._build_suggest_fn(dj.cs, 32, 32, 2, 256)
    cand = jax_gp_cand(dj.cs, 1, 2, 32)
    want_rows = _run_jax(fn, 1, hist)
    prog = gp_t._GpProgram(dt.cs, 32, 32, 2, 256, torch.device(CPU))
    trace = []
    rows = prog(*map(torch.as_tensor, hist), cand=cand, trace=trace)
    scores = trace[0]["scores"].numpy()
    assert np.isnan(scores[4:]).all() and np.isnan(spy.argmax[0][4:]).all()
    assert int(trace[0]["pick"]) == int(np.argmax(spy.argmax[0])) == 4
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    chol = gp_t._cholesky(torch.tensor([[[1.0, 2.0], [2.0, 1.0]],
                                        [[2.0, 0.0], [0.0, 2.0]]]))
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(
        [[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.0], [0.0, 2.0]]])))
    assert np.isnan(chol[0].numpy()[np.tril_indices(2)]).all()
    assert np.isnan(want[0][np.tril_indices(2)]).all()
    np.testing.assert_allclose(chol[1].numpy(), want[1], rtol=1e-7)


def test_gp_startup_and_liar_rows_in_flight():
    dj, tj, dt, tt = _pair(6)
    docs = gp_t.suggest([6, 7], dt, tt, 3)       # startup: random search
    want = ht.rand.suggest([6, 7], dt, tt, 3)
    assert _vals(docs) == _vals(want)
    _, _, dt, tt = _pair(24)
    pending = ht.rand.suggest([24, 25], dt, tt, 9)
    tt.insert_trial_docs(pending)
    tt.refresh()
    a = gp_t.suggest([26, 27, 28], dt, tt, 4)
    b = gp_t.suggest([26, 27, 28], dt, tt, 4, resident=False)
    assert _vals(a) == _vals(b)


# -- ES -------------------------------------------------------------------------


def jax_es_eps(seed, m, p):
    key = jax.random.PRNGKey(np.uint32(int(seed) % (2 ** 32)))
    return np.asarray(jax.random.normal(key, ((m + 1) // 2, p), jnp.float32))


def assert_es_rows_close(got, want, cs):
    """Discrete and quantized columns equal; continuous ones equal within
    ``ES_ATOL`` once mapped back to the unit cube (the cube is where the
    two replays agree to float32 rounding)."""
    exact = np.asarray([p.is_int or bool(p.q) for p in cs.params])
    np.testing.assert_array_equal(got[:, exact], want[:, exact])
    meta = codec_t.meta_tensors(codec_t.unit_meta(cs), CPU)
    act = torch.ones(got.shape, dtype=torch.bool)
    zg, zw = (codec_t.encode(meta, torch.as_tensor(r), act, cat="unit")
              for r in (got, want))
    np.testing.assert_allclose(zg.numpy()[:, ~exact], zw.numpy()[:, ~exact],
                               atol=2 * ES_ATOL)


@pytest.mark.parametrize("rank_shaping", [True, False])
@pytest.mark.parametrize("n,n_hist", [(1, 20), (8, 61)])
def test_es_matches_jax_on_jax_eps(monkeypatch, rank_shaping, n, n_hist):
    dj, tj, dt, tt = _pair(n_hist)
    m, seed, popsize = ht.tpe._batch_size_for(n), 17, 4
    h = tj.history(dj.cs)
    n_cap = ht.tpe._bucket(len(h["loss"]))
    hist = ht.history._padded_history(h, n_cap)
    seen = []
    rec, orig = _record(seen), codec_j.decode

    def decode(meta, z):
        rec(z)
        return orig(meta, z)

    monkeypatch.setattr(codec_j, "decode", decode)
    fn = es_j._build_suggest_fn(dj.cs, n_cap, m, popsize, 0.25, 0.5,
                                rank_shaping)
    want_rows = _run_jax(fn, seed, hist)
    prog = es_t._EsProgram(dt.cs, n_cap, m, popsize, 0.25, 0.5,
                           rank_shaping, torch.device(CPU))
    trace = []
    rows = prog(*map(torch.as_tensor, hist),
                noise=jax_es_eps(seed, m, dt.cs.n_params), trace=trace)
    z_want = seen[-1]
    np.testing.assert_allclose(trace[0]["z"].numpy(), z_want, atol=ES_ATOL)
    assert_es_rows_close(rows.numpy(), want_rows, dt.cs)
    if m > 1:
        # An antithetic pair inside the cube averages to the mean.
        half = (m + 1) // 2
        a, b = z_want[:half], z_want[half:half * 2]
        free = (a > 0) & (a < 1) & (b > 0) & (b < 1)
        mean_want = ((a + b) / 2)[free]
        mean_got = np.broadcast_to(trace[0]["mean"].numpy(), a.shape)[free]
        assert free.any()
        np.testing.assert_allclose(mean_got, mean_want, atol=ES_ATOL)
    # Through the dispatch: JAX's suggest against the port's on JAX's eps.
    ids = list(range(n_hist, n_hist + n))
    want = es_j.suggest(ids, dj, tj, seed, popsize=popsize,
                        rank_shaping=rank_shaping)
    got = es_t.suggest(ids, dt, tt, seed, popsize=popsize,
                       rank_shaping=rank_shaping,
                       noise=jax_es_eps(seed, m, dt.cs.n_params))
    assert [d["tid"] for d in got] == ids

    def rows_of(docs):
        return np.stack([[d["misc"]["vals"].get(p.label, [0.0])[0]
                          if d["misc"]["vals"].get(p.label) else 0.0
                          for p in dt.cs.params] for d in docs])
    assert_es_rows_close(rows_of(got).astype(np.float32),
                         rows_of(want).astype(np.float32), dt.cs)


def test_es_startup_is_random_search():
    _, _, dt, tt = _pair(5)
    assert _vals(es_t.suggest([5], dt, tt, 2)) == \
        _vals(ht.rand.suggest([5], dt, tt, 2))


# -- introspection ----------------------------------------------------------------


def _jax_sampler(dj, n_candidates=64):
    """The port's space sampler replaced by JAX's introspect draws."""
    def sample(n, generator=None, device=None, noise=None):
        assert n == n_candidates
        seed = int(generator.initial_seed())
        v, a = dj.cs.sample_traced(jax.random.PRNGKey(seed), n)
        return (torch.as_tensor(np.asarray(v)),
                torch.as_tensor(np.asarray(a)))
    return sample


def _assert_report_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_report_close(got[k], w)
        elif isinstance(w, float) and not isinstance(w, bool):
            np.testing.assert_allclose(got[k], w, rtol=INTRO_RTOL, err_msg=k)
        else:
            assert got[k] == w, k


def two_uniform(pkg):
    return {"u": pkg.hp.uniform("u", -2.0, 3.0),
            "v": pkg.hp.uniform("v", 0.0, 1.0)}


@pytest.mark.parametrize("max_n", [8, 16])
def test_gp_introspect_fits_at_least_16_rows_as_jax(monkeypatch, max_n):
    """``max_n`` below 16 fits 16 rows, as ``suggest_dispatch`` and JAX's
    ``_max_fit_rows`` do: 24 random-search trials on two uniforms, against
    JAX with its row cap set to the same ``max_n``."""
    dj = hj.base.Domain(lambda cfg: 0.0, two_uniform(hj))
    dt = ht.Domain(lambda cfg: 0.0, two_uniform(ht))
    dt.cs.device = CPU
    docs = hj.rand.suggest(list(range(24)), dj, hj.Trials(), 11)
    for d in docs:
        v = d["misc"]["vals"]
        d["state"] = hj.JOB_STATE_DONE
        d["result"] = {"status": "ok",
                       "loss": float((v["u"][0] - 0.7) ** 2 + v["v"][0])}
    tj, tt = hj.Trials(), ht.Trials()
    for t in (tj, tt):
        t.insert_trial_docs(copy.deepcopy(docs))
        t.refresh()
    monkeypatch.setenv("HYPEROPT_TPU_GP_MAX_N", str(max_n))
    monkeypatch.setattr(dt.cs, "sample", _jax_sampler(dj))
    got = gp_t.introspect(dt, tt, seed=5, max_n=max_n)
    want = gp_j.introspect(dj, tj, seed=5)
    _assert_report_close(got, want)
    for k in ("logml", "ls", "noise"):
        assert k in got
    # The fit does not depend on a cap under 16.
    _assert_report_close(got, gp_t.introspect(dt, tt, seed=5, max_n=16))


@pytest.mark.parametrize("n_hist", [3, 30])
def test_gp_introspect_and_health_equal_jax(monkeypatch, n_hist):
    dj, tj, dt, tt = _pair(n_hist)
    monkeypatch.setattr(dt.cs, "sample", _jax_sampler(dj))
    for seed in (0, 4):
        _assert_report_close(gp_t.introspect(dt, tt, seed=seed),
                             gp_j.introspect(dj, tj, seed=seed))
    want = health_j.assess(list(tj), dj, tj, suggest_fn=gp_j.suggest,
                           seed=4)
    got = health_t.assess(list(tt), dt, tt, suggest_fn=gp_t.suggest, seed=4)
    _assert_report_close(got, want)
    if n_hist >= 4:
        assert got["introspection"]["ei_rel"] > 0
        assert math.isfinite(got["introspection"]["logml"])

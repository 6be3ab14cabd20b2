"""Step ops of the PyTorch port against hyperopt_tpu's on the same numpy
inputs.  The JAX ops take one column and are vmapped; the port's take
the column axis as a batch dimension.

Tolerances: exact where both sides do the same f32 operations in the same
order (weights, index picks, lookups); 1e-5 relative where sums may be
taken in another order (weight normalizers); 1e-4 where the two
libraries' special functions (log_ndtr, ndtr, ndtri) differ in the last
bits."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperopt_tpu.ops import gmm as gj
from hyperopt_tpu.ops import parzen as pj
from hyperopt_tpu.ops import step_ei as sj
from hyperopt_tpu_torch.ops import gmm as gt
from hyperopt_tpu_torch.ops import parzen as pt
from hyperopt_tpu_torch.ops import step_ei as stt

INF = np.inf


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.as_tensor(np.array(a))


def J(a):
    return jnp.asarray(np.array(a))


def close(got, want, rtol=0.0, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def test_forgetting_weights():
    rank = np.arange(40, dtype=np.float32)[:, None] * np.ones((1, 4), np.float32)
    n_obs = np.asarray([[0, 1, 30, 40]], np.float32)
    for lf in (1, 25, 100):
        close(pt.forgetting_weights(T(rank), T(n_obs), lf),
              pj.forgetting_weights(J(rank), J(n_obs), lf), rtol=1e-7)


def _parzen_case(rng, n, cols):
    """Padded observation columns: ties, a single observation, an empty
    column and a full one, all +inf padded."""
    x = np.full((cols, n), INF, np.float32)
    w = np.zeros((cols, n), np.float32)
    n_obs = np.zeros(cols, np.int32)
    counts = [0, 1, 2, 5, n // 2, n][:cols]
    for c, k in enumerate(counts):
        v = rng.normal(0, 2, k).astype(np.float32)
        if k >= 5:
            v[1:3] = v[0]                                   # ties
        x[c, :k] = v
        w[c, :k] = rng.uniform(0.1, 1, k)
        n_obs[c] = k
    prior_mu = rng.normal(0, 1, cols).astype(np.float32)
    prior_sg = rng.uniform(1, 4, cols).astype(np.float32)
    return x, w, n_obs, prior_mu, prior_sg


@pytest.mark.parametrize("out_cap", [6, 33])
def test_fit_parzen(rng, out_cap):
    x, w, n_obs, pmu, psg = _parzen_case(rng, 32, 5)
    got = pt.fit_parzen(T(x), T(w), T(n_obs), T(pmu), T(psg), 1.0, out_cap)
    for c in range(5):
        if n_obs[c] + 1 > out_cap:
            continue
        want = pj.fit_parzen(J(x[c]), J(w[c]), n_obs[c], pmu[c], psg[c],
                             np.float32(1.0), out_cap)
        for g, wv in zip(got, want):
            close(g[c], wv, rtol=1e-5)


def test_fused_parzen_fit(rng):
    n, c = 32, 6
    xb, wb, nb, pmu, psg = _parzen_case(rng, n, c)
    xa, wa, na, _, _ = _parzen_case(rng, n, c)
    nb = np.minimum(nb, 5)
    xb[:, 5:], wb[:, 5:] = INF, 0.0
    args_np = (xb.T, wb.T, nb, xa.T, wa.T, na, pmu, psg)
    got = stt.fused_parzen_fit(*map(T, args_np), 1.0, 6, n + 1)
    want = sj.fused_parzen_fit(*map(J, args_np), np.float32(1.0), 6, n + 1)
    for g, wv in zip(got, want):
        close(g, wv, rtol=1e-5)


def test_log_ndtr_diff_bounds():
    a = np.asarray([-INF, -INF, -3.0, 0.5, 4.0, 9.0, -40.0, 2.0, INF],
                   np.float32)
    b = np.asarray([INF, -INF, 1.0, 0.7, 6.0, 12.0, -39.0, 2.0, INF],
                   np.float32)
    got = gt.log_ndtr_diff(T(a), T(b)).numpy()
    want = np.asarray(gj.log_ndtr_diff(J(a), J(b)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    close(got[fin], want[fin], rtol=1e-4, atol=1e-5)


def _mixtures(rng, c, k, live):
    logw = np.full((c, k), -INF, np.float32)
    for i in range(c):
        p = rng.random(live) + 0.1
        logw[i, :live] = np.log(p / p.sum())
    mu = np.where(np.isfinite(logw), rng.normal(0, 2, (c, k)), 0.0)
    sg = np.where(np.isfinite(logw), rng.uniform(0.2, 2, (c, k)), 1.0)
    return logw, mu.astype(np.float32), sg.astype(np.float32)


BOUNDS = [(-INF, INF), (-2.0, 3.0), (0.0, INF)]


@pytest.mark.parametrize("lo,hi", BOUNDS)
def test_gmm_logpdf(rng, lo, hi):
    c, n = 3, 50
    logw, mu, sg = _mixtures(rng, c, 9, 6)               # -inf padding
    z = rng.uniform(-4, 4, (c, n)).astype(np.float32)
    los, his = np.full(c, lo, np.float32), np.full(c, hi, np.float32)
    got = gt.gmm_logpdf(T(z), T(logw), T(mu), T(sg), T(los), T(his))
    want = jax.jit(jax.vmap(gj.gmm_logpdf, in_axes=(0,) * 6))(
        J(z), J(logw), J(mu), J(sg), J(los), J(his))
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    close(got[fin], want[fin], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("lo,hi", BOUNDS)
def test_gmm_log_qmass(rng, lo, hi):
    c, n = 3, 40
    logw, mu, sg = _mixtures(rng, c, 7, 5)
    v = np.round(rng.uniform(-3, 3, (c, n)) / 0.5) * 0.5
    zl = (v - 0.25).astype(np.float32)
    zh = (v + 0.25).astype(np.float32)
    zl[:, 0] = -INF                       # a bin reaching the support edge
    los, his = np.full(c, lo, np.float32), np.full(c, hi, np.float32)
    got = gt.gmm_log_qmass(T(zl), T(zh), T(logw), T(mu), T(sg), T(los),
                           T(his))
    want = jax.jit(jax.vmap(gj.gmm_log_qmass, in_axes=(0,) * 7))(
        J(zl), J(zh), J(logw), J(mu), J(sg), J(los), J(his))
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    close(got[fin], want[fin], rtol=1e-4, atol=1e-4)


def test_icdf_pick(rng):
    p = rng.random((4, 6)).astype(np.float32)
    p[:, 4:] = 0.0                                          # zero-mass pads
    p[1, 2] = 0.0                                           # interior zero
    cdf = np.cumsum(p / p.sum(1, keepdims=True), axis=1, dtype=np.float32)
    u = rng.random((4, 300)).astype(np.float32)
    u[:, :3] = [0.0, 0.9999999, np.float32(1) - np.float32(2 ** -24)]
    last = np.asarray([[3]] * 4)
    got = gt.icdf_pick(T(u), T(cdf), T(last))
    want = gj.icdf_pick(J(u), J(cdf), J(last))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lo,hi", BOUNDS)
def test_gmm_sample_same_uniforms(lo, hi):
    """JAX draws its two uniforms from split(key); the port is handed the
    same two arrays and must land on the same components and values."""
    rng = np.random.default_rng(7)
    c, n = 4, 200
    logw, mu, sg = _mixtures(rng, c, 8, 6)
    logw[0, 2] = -INF                     # an interior dead component
    keys = jax.random.split(jax.random.key(3), c)
    sample = jax.jit(gj.gmm_sample, static_argnums=(6,),
                     static_argnames=("comp_sampler",))
    ucs, us, want = [], [], []
    for i in range(c):
        kc, ku = jax.random.split(keys[i])
        ucs.append(np.asarray(jax.random.uniform(kc, (n,), jnp.float32)))
        us.append(np.asarray(jax.random.uniform(ku, (n,), jnp.float32)))
        want.append(np.asarray(sample(
            keys[i], J(logw[i]), J(mu[i]), J(sg[i]), np.float32(lo),
            np.float32(hi), n, comp_sampler="icdf")))
    got = gt.gmm_sample(T(logw), T(mu), T(sg), T(np.full(c, lo, np.float32)),
                        T(np.full(c, hi, np.float32)), T(np.stack(ucs)),
                        T(np.stack(us)))
    close(got, np.stack(want), rtol=1e-4, atol=1e-4)
    assert ((got.numpy() >= lo) & (got.numpy() <= hi)).all()


@pytest.mark.parametrize("u0, mu_lo", [(0.0, 0.0), (1e-9, 0.0),
                                        (1.0 - 2.0 ** -24, 12.0)])
def test_gmm_sample_at_the_end_uniforms_stays_in_bounds(u0, mu_lo):
    """Uniforms at or next to the ends of [0, 1), which the card's
    ``torch.rand`` does return, on components near a bound: float32's
    tail mass read short would put ``ndtri`` outside [lo, hi]."""
    rng = np.random.default_rng(11)
    n = 20000
    mu = (mu_lo + 3.0 * rng.random((n, 1))).astype(np.float32)
    sg = np.exp(4.0 * rng.random((n, 1)) - 3.0).astype(np.float32)
    got = gt.gmm_sample(T(np.zeros((n, 1), np.float32)), T(mu), T(sg),
                        T(np.zeros(n, np.float32)),
                        T(np.full(n, 15.0, np.float32)),
                        T(rng.random((n, 1)).astype(np.float32)),
                        T(np.full((n, 1), u0, np.float32))).numpy()
    assert ((got >= 0.0) & (got <= 15.0)).all(), (got.min(), got.max())


@pytest.mark.parametrize("u0", [0.0, 1e-9, 1.0 - 2.0 ** -24])
@pytest.mark.parametrize("low, high", [(math.log(1e-3), math.log(10.0)),
                                       (-6.0, 0.0)])
def test_gmm_sample_log_column_stays_in_its_support_after_exp(u0, low,
                                                              high):
    """A log column draws in log space, clipped into the float32 bounds,
    and its value is the float32 exp of the draw: at the ends of [0, 1)
    it stays in the prior's support [exp(low), exp(high)] up to float32's
    rounding of the bounds and of exp (two ulps)."""
    rng = np.random.default_rng(12)
    n = 20000
    lo32, hi32 = np.float32(low), np.float32(high)
    mu = (low + (high - low) * rng.random((n, 1))).astype(np.float32)
    sg = np.exp(3.0 * rng.random((n, 1)) - 3.0).astype(np.float32)
    z = gt.gmm_sample(T(np.zeros((n, 1), np.float32)), T(mu), T(sg),
                      T(np.full(n, lo32)), T(np.full(n, hi32)),
                      T(rng.random((n, 1)).astype(np.float32)),
                      T(np.full((n, 1), u0, np.float32)))
    x = torch.exp(z).numpy().astype(np.float64)
    ulp2 = 2.0 ** -22
    assert (x >= math.exp(low) * (1.0 - ulp2)).all(), x.min()
    assert (x <= math.exp(high) * (1.0 + ulp2)).all(), x.max()


def test_onehot_lookup_contract():
    table = np.asarray([[1.0, -INF, 3.0, np.nan], [5.0, 6.0, INF, 8.0]],
                       np.float32)
    idx = np.asarray([[-2, 0, 1, 2, 3, 9], [0, 1, 2, 3, 4, -1]], np.int32)
    for fill in (0.0, -3e38):
        close(gt.onehot_lookup(T(idx), T(table), fill),
              gj.onehot_lookup(J(idx), J(table), fill))
        close(gt.onehot_lookup(T(idx[0]), T(table[1]), fill),
              gj.onehot_lookup(J(idx[0]), J(table[1]), fill))


def test_ei_argmax_stats_ties():
    scores = np.asarray([[1.0, 3.0, 3.0, 2.0], [0.0, 0.0, 0.0, 0.0],
                         [-INF, -1.0, -INF, -5.0]], np.float32)
    got = stt.ei_argmax_stats(T(scores))
    want = sj.ei_argmax_stats(J(scores))
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))

"""The bf16 and tensor-core lowerings of the port's EI scorer, and the
above-model truncation, against hyperopt_tpu.

On the CPU ``ei_scores(..., bf16=True)`` and ``ei_scores(..., mxu=True)``
are their plain twins.  They are held against the JAX package's Pallas
kernel run in interpret mode with the same flags, at the tolerance of
``tests/test_pallas.py`` (rtol/atol 2e-4), and the mxu twin against the
f32 twin at that file's mxu tolerance (2e-3, argmax equal).  The JAX bf16
kernel on the CPU rounds ``t = (z - mu)/sg`` to bf16 after the subtraction
and the division and computes the square in f32; the twin does the same.
The CUDA kernels run only on the card (``tests/test_torch_ei_scores.py``
has the ``cuda``-marked check; ``chip_smoke.py`` the full shapes)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperopt_tpu.ops.gmm import truncate_mixture as truncate_jax
from hyperopt_tpu.ops.pallas_gmm import ei_scores as ei_jax
from hyperopt_tpu_torch.ops import ei_scores as ei_mod
from hyperopt_tpu_torch.ops.gmm import truncate_mixture

SHAPES = [(3, 300, 8, 40), (2, 500, 26, 130), (31, 2000, 26, 1025)]
LOWERINGS = {"bf16": {"bf16": True}, "mxu": {"mxu": True}}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_mixture(rng, c, k, k_live):
    logw = np.full((c, k), -np.inf, np.float32)
    for i in range(c):
        w = rng.random(k_live) + 0.1
        logw[i, :k_live] = np.log(w / w.sum())
    mu = np.where(np.isfinite(logw), rng.normal(0, 3, (c, k)), 0.0)
    sg = np.where(np.isfinite(logw), rng.uniform(0.3, 3, (c, k)), 1.0)
    return logw, mu.astype(np.float32), sg.astype(np.float32)


def _case(c, n, kb, ka, seed=0):
    rng = np.random.default_rng(seed)
    below = _random_mixture(rng, c, kb, kb - 1)
    above = _random_mixture(rng, c, ka, ka - 3)
    z = rng.normal(0, 3, (c, n)).astype(np.float32)
    return z, below, above


def _port(z, below, above, **kw):
    return ei_mod.ei_scores(*(torch.as_tensor(a) for a in
                              (z, *below, *above)), **kw).numpy()


@pytest.mark.parametrize("low", sorted(LOWERINGS))
@pytest.mark.parametrize("c,n,kb,ka", SHAPES)
def test_twin_matches_pallas_interpret(low, c, n, kb, ka):
    z, below, above = _case(c, n, kb, ka)
    kw = LOWERINGS[low]
    got = _port(z, below, above, **kw)
    want = np.asarray(ei_jax(*(jnp.asarray(a) for a in (z, *below, *above)),
                             tile=128, interpret=True, **kw))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _bf16_grid():
    """Every bf16 significand (128) at exponents -3..3, both signs: 1,792
    values, as float32."""
    sign, exp, mant = np.meshgrid([0, 1], np.arange(-3, 4), np.arange(128),
                                  indexing="ij")
    bits = (sign << 15) | ((127 + exp) << 7) | mant
    return torch.as_tensor(bits.ravel().astype(np.int16)).view(
        torch.bfloat16).float()


def _bf16_bits(x):
    return x.bfloat16().view(torch.int16)


def _bf16_scores_with_reciprocal(z, below, above):
    """The bf16 twin's scores, computed here with the division by
    bf16(sigma) replaced by a multiply with its float32 reciprocal, as K2
    computes them."""
    def lse(logw, mu, sg):
        logw, mu, sg = (torch.as_tensor(a) for a in (logw, mu, sg))
        live = logw > -math.inf
        cb = torch.where(live, logw - torch.log(sg)
                         - 0.5 * math.log(2.0 * math.pi),
                         torch.full_like(logw, -math.inf))
        mu_h = torch.where(live, mu, torch.zeros_like(mu)).bfloat16()
        rcp = 1.0 / torch.where(live, sg,
                                torch.ones_like(sg)).bfloat16().float()
        d = (torch.as_tensor(z).bfloat16()[:, :, None]
             - mu_h[:, None, :]).float()
        t = (d * rcp[:, None, :]).bfloat16().float()
        return torch.logsumexp(cb[:, None, :] + (-0.5 * t * t), dim=-1)

    return (lse(*below) - lse(*above)).numpy()


def test_bf16_reciprocal_identity():
    """K2 multiplies by a float32 reciprocal of bf16(sigma), folded once
    per component, where the twin divides: for bf16 d and s,
    bf16(d * (1/s)) == bf16(d / s) in float32 round-to-nearest.  Every
    pair of significands at exponent offsets -3..3 of each operand and
    both signs: 1,792 x 1,792 pairs.  Then, on the test shapes, the bf16
    twin's scores with that multiply in place of its division have the
    twin's bits."""
    g = _bf16_grid()
    d, s = g[:, None], g[None, :]
    assert d.dtype == torch.float32
    quot = _bf16_bits(d / s)
    prod = _bf16_bits(d * (1.0 / s))
    assert quot.numel() == 1792 * 1792
    assert torch.equal(quot, prod)
    # The float32 values themselves do differ: the identity is about the
    # bf16 rounding, not the product.
    assert not torch.equal(d / s, d * (1.0 / s))
    for c, n, kb, ka in SHAPES:
        z, below, above = _case(c, n, kb, ka, seed=2)
        want = _port(z, below, above, bf16=True)
        got = _bf16_scores_with_reciprocal(z, below, above)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("c,n,kb,ka", SHAPES)
def test_mxu_twin_matches_f32_twin(c, n, kb, ka):
    z, below, above = _case(c, n, kb, ka, seed=1)
    f32 = _port(z, below, above)
    mxu = _port(z, below, above, mxu=True)
    np.testing.assert_allclose(mxu, f32, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(np.argmax(mxu, 1), np.argmax(f32, 1))


# K3's packed 3xTF32 product (csrc/ei_scores_mxu.cu): what each lane (g, t)
# of an m16n8k8 holds.  A fragment: columns t and t + 4 of a candidate's
# row (packed_cols); B fragment: the staged pair t of a component, its
# rows t and t + 4 (stage_component writes the pairs in this order).
_LANE_A = (("q_hi", "z_hi"), ("z_hi", "one"), ("one", "q_lo"),
           ("q_hi", "z_lo"))
_STAGED = ("a2_hi", "a1_lo", "a1_hi", "a0_lo", "a0_hi", "a2_hi", "a2_lo",
           "a1_hi")
_LOG2E = np.float32(math.log2(math.e))


def _tf32(x):
    """``cvt.rna.tf32.f32`` on float32 bit patterns: the 13 low bits of the
    significand rounded away, ties away from zero (finite values)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split_tf32(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)           # x - hi is exact in float32


def _packed_rows():
    """The A row and B column of the packed product, read off the lanes'
    fragments: column t of A and row t of B from element 0 of lane t's
    pair, column and row t + 4 from element 1."""
    a = [_LANE_A[t % 4][t // 4] for t in range(8)]
    b = [_STAGED[2 * (t % 4) + t // 4] for t in range(8)]
    return a, b


def _packed_terms(z, logw, mu, sg):
    """Natural-log terms ``[C, n, K]`` as K3 forms them: the coefficients
    of ``mxu_coefficients`` scaled to base 2 and split, the features
    split, the eight products of one m16n8k8 summed one by one in
    float32 (each product of two TF32 values is exact in float32)."""
    coef = [a.numpy()[:, None, :] * _LOG2E for a in ei_mod.mxu_coefficients(
        *(torch.as_tensor(x) for x in (logw, mu, sg)))]
    b_vals = {}
    for name, x in zip(("a2", "a1", "a0"), coef):
        b_vals[name + "_hi"], b_vals[name + "_lo"] = _split_tf32(x)
    zz = z[:, :, None]
    a_vals = {"one": np.float32(1.0)}
    a_vals["q_hi"], a_vals["q_lo"] = _split_tf32(zz * zz)
    a_vals["z_hi"], a_vals["z_lo"] = _split_tf32(zz)
    a_row, b_col = _packed_rows()
    acc = np.zeros(np.broadcast_shapes(zz.shape, coef[0].shape), np.float32)
    for fa, fb in zip(a_row, b_col):
        acc = acc + a_vals[fa] * b_vals[fb]
    return acc / _LOG2E, coef, zz


def _narrow_far_case():
    """Narrow (sigma 1e-3) and wide components, candidates near them and
    far out (|z| = 1e4)."""
    rng = np.random.default_rng(7)
    c, k = 2, 24
    logw, mu, sg = _random_mixture(rng, c, k, k - 2)
    sg[:, ::2] = 1e-3
    near = mu[:, :12] + rng.normal(0, 2e-3, (c, 12)).astype(np.float32)
    far = np.tile(np.asarray([1e4, -1e4, 9999.5, -1e4 + 0.25], np.float32),
                  (c, 1))
    z = np.concatenate([rng.normal(0, 3, (c, 40)).astype(np.float32), near,
                        far], axis=1)
    return z, logw, mu, sg


def test_packed_rows_are_3xtf32():
    """The eight products are hi*hi, hi*lo and lo*hi of z^2 a2 and z a1,
    and hi and lo of a0 times the feature 1."""
    a_row, b_col = _packed_rows()
    assert a_row == ["q_hi", "z_hi", "one", "q_hi", "z_hi", "one", "q_lo",
                     "z_lo"]
    assert b_col == ["a2_hi", "a1_hi", "a0_hi", "a2_lo", "a1_lo", "a0_lo",
                     "a2_hi", "a1_hi"]
    feat = {"q": "a2", "z": "a1", "one": "a0"}
    pairs = set()
    for fa, fb in zip(a_row, b_col):
        base = fa.split("_")[0]
        assert feat[base] == fb[:2]
        pairs.add((fa, fb))
    assert len(pairs) == 8
    want = {(f"{x}_{u}", f"{feat[x]}_{v}") for x in ("q", "z")
            for u, v in (("hi", "hi"), ("hi", "lo"), ("lo", "hi"))}
    want |= {("one", "a0_hi"), ("one", "a0_lo")}
    assert pairs == want


@pytest.mark.parametrize("case", [*SHAPES, "narrow_far"], ids=str)
def test_packed_3xtf32_products(case):
    """K3's one packed product per tile against the mxu twin's float32
    terms.  Each operand keeps ~22 bits in hi + lo (the lo's own TF32
    rounding and the dropped lo*lo product cost <= 3 * 2**-22 of each
    product), and float32 rounding of the eight-step sum and of the
    twin's three-term sum adds a few ulps of the largest product: about
    2**-20 of the sum of the products' magnitudes in all (measured: under
    2**-21).  The bound is 2**-18 of that sum, leaving room for the order
    in which the tensor core adds its products, which the card decides."""
    if case == "narrow_far":
        z, *mixture = _narrow_far_case()
        mixtures = [mixture]
    else:
        z, *mixtures = _case(*case, seed=1)
    for logw, mu, sg in mixtures:
        twin = ei_mod._terms_mxu(*(torch.as_tensor(a) for a in
                                   (logw, mu, sg)))
        step = max(1, (1 << 22) // (z.shape[0] * logw.shape[1]))
        for i in range(0, z.shape[1], step):
            zc = z[:, i:i + step]
            got, coef, zz = _packed_terms(zc, logw, mu, sg)
            want = twin(torch.as_tensor(zc)).numpy()
            a2, a1, a0 = (x.astype(np.float64) / float(_LOG2E) for x in coef)
            zz = zz.astype(np.float64)
            size = np.abs(a2) * zz * zz + np.abs(a1 * zz) + np.abs(a0)
            assert np.isfinite(got).all()
            err = np.abs(got.astype(np.float64) - want)
            assert (err <= 2.0 ** -18 * size).all(), \
                float((err / size).max())


def test_mxu_ignores_bf16():
    z, below, above = _case(2, 100, 5, 9)
    np.testing.assert_array_equal(_port(z, below, above, mxu=True, bf16=True),
                                  _port(z, below, above, mxu=True))


@pytest.mark.parametrize("low", sorted(LOWERINGS))
def test_extreme_values_stay_finite(rng, low):
    logw = np.log(np.asarray([[0.5, 0.5], [0.9, 0.1]], np.float32))
    mu = np.asarray([[-50.0, 50.0], [0.0, 1e4]], np.float32)
    sg = np.asarray([[1e-3, 1e3], [0.5, 10.0]], np.float32)
    z = rng.uniform(-1e4, 1e4, (2, 256)).astype(np.float32)
    out = _port(z, (logw, mu, sg), (logw, mu, sg), **LOWERINGS[low])
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, 0.0, atol=1e-3)


@pytest.mark.parametrize("low", ["f32", "bf16", "mxu"])
def test_dead_components_with_any_mu_sigma_add_nothing(low):
    """A -inf log-weight hides its component whatever its mu and sigma:
    sigma 0 and NaN mu give the scores of the mixture without it."""
    kw = LOWERINGS.get(low, {})
    z, below, above = _case(2, 100, 5, 9)
    lw, mu, sg = (np.concatenate([a, np.full((2, 3), f, np.float32)], 1)
                  for a, f in zip(above, (-np.inf, np.nan, 0.0)))
    got = _port(z, below, (lw, mu, sg), **kw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _port(z, below, above, **kw), rtol=1e-6,
                               atol=1e-6)


def test_mxu_coefficients_floor_and_dead():
    logw = torch.tensor([[0.0, float("-inf"), 0.0]])
    mu = torch.tensor([[1.0, float("nan"), 1e16]])
    sg = torch.tensor([[2.0, 0.0, 1e-3]])
    a2, a1, a0 = ei_mod.mxu_coefficients(logw, mu, sg)
    np.testing.assert_allclose(a2[0, 0].item(), -0.125)
    np.testing.assert_allclose(a1[0, 0].item(), 0.25)
    assert (a2[0, 1].item(), a1[0, 1].item(), a0[0, 1].item()) == \
        (0.0, 0.0, np.float32(-1e30))
    assert a0[0, 2].item() == np.float32(-1e30)      # floored live component


@pytest.mark.parametrize("m", [1, 3, 8, 40])
def test_truncate_mixture_matches_jax(m):
    rng = np.random.default_rng(m)
    logw, mu, sg = _random_mixture(rng, 4, 24, 10)
    logw[1, 3] = logw[1, 5]                           # a tie among live ones
    got = truncate_mixture(*(torch.as_tensor(a) for a in (logw, mu, sg)), m)
    want = truncate_jax(*(jnp.asarray(a) for a in (logw, mu, sg)), m)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_lowering_names():
    assert ei_mod.lowering() == "f32"
    assert ei_mod.lowering(bf16=True) == "bf16"
    assert ei_mod.lowering(mxu=True, bf16=True) == "mxu"
    assert set(ei_mod.ei_scores.launches_by) == set(ei_mod.LOWERINGS)

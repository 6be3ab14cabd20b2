"""The EI scorer of the PyTorch port.

On the CPU ``ei_scores`` is its plain version, held here against the JAX
package's Pallas kernel run in interpret mode and against the XLA
``gmm_logpdf`` difference (plus the truncation normalizers the kernel
leaves out), at the tolerance of ``tests/test_pallas.py`` (rtol/atol
2e-4), with identical argmax.  The CUDA kernels themselves (f32, bf16 and
tensor-core lowerings) run only on the card: their test is marked ``cuda``
and skips elsewhere; ``chip_smoke.py`` holds them against their plain
versions at the TPE step's full shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperopt_tpu.ops import gmm_logpdf
from hyperopt_tpu.ops.gmm import _log_trunc_mass
from hyperopt_tpu.ops.pallas_gmm import ei_scores as ei_jax
from hyperopt_tpu_torch.ops import ei_scores as ei_mod

SHAPES = [(3, 300, 8, 40), (1, 64, 2, 130), (8, 2048, 32, 128)]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mixture(rng, c, k, k_live):
    logw = np.full((c, k), -np.inf, np.float32)
    for i in range(c):
        w = rng.random(k_live) + 0.1
        logw[i, :k_live] = np.log(w / w.sum())
    mu = np.where(np.isfinite(logw), rng.normal(0, 3, (c, k)), 0.0)
    sg = np.where(np.isfinite(logw), rng.uniform(0.3, 3, (c, k)), 1.0)
    return logw, mu.astype(np.float32), sg.astype(np.float32)


def _case(c, n, kb, ka, seed=0):
    rng = np.random.default_rng(seed)
    below = _mixture(rng, c, kb, max(1, kb - 1))
    above = _mixture(rng, c, ka, max(1, ka - 3))
    z = rng.normal(0, 3, (c, n)).astype(np.float32)
    return z, below, above


def _port(z, below, above):
    return ei_mod.ei_scores(*(torch.as_tensor(a) for a in
                              (z, *below, *above))).numpy()


@pytest.mark.parametrize("c,n,kb,ka", SHAPES)
def test_reference_matches_pallas_interpret(c, n, kb, ka):
    z, below, above = _case(c, n, kb, ka)
    got = _port(z, below, above)
    want = np.asarray(ei_jax(*(jnp.asarray(a) for a in (z, *below, *above)),
                             tile=512 if n >= 512 else 128, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(np.argmax(got, 1), np.argmax(want, 1))


@pytest.mark.parametrize("c,n,kb,ka", SHAPES)
def test_reference_matches_xla_logpdf_difference(c, n, kb, ka):
    z, below, above = _case(c, n, kb, ka, seed=1)
    got = _port(z, below, above)
    lo = jnp.full((c,), -jnp.inf)
    hi = jnp.full((c,), jnp.inf)
    sb = jax.jit(jax.vmap(gmm_logpdf, in_axes=(0,) * 6))
    bj = [jnp.asarray(a) for a in below]
    aj = [jnp.asarray(a) for a in above]
    want = np.asarray(sb(jnp.asarray(z), *bj, lo, hi)
                      - sb(jnp.asarray(z), *aj, lo, hi))
    norm = jax.jit(jax.vmap(_log_trunc_mass, in_axes=(0, 0, 0, None, None)))
    _, zb = norm(*bj, -jnp.inf, jnp.inf)
    _, za = norm(*aj, -jnp.inf, jnp.inf)
    shift = np.asarray(za - zb)[:, None]
    np.testing.assert_allclose(got + shift, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(np.argmax(got, 1), np.argmax(want, 1))


def test_extreme_values_stay_finite(rng):
    logw = np.log(np.asarray([[0.5, 0.5], [0.9, 0.1]], np.float32))
    mu = np.asarray([[-50.0, 50.0], [0.0, 1e4]], np.float32)
    sg = np.asarray([[1e-3, 1e3], [0.5, 10.0]], np.float32)
    z = rng.uniform(-1e4, 1e4, (2, 256)).astype(np.float32)
    out = _port(z, (logw, mu, sg), (logw, mu, sg))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, 0.0, atol=1e-3)


def test_dead_components_contribute_nothing():
    z, below, above = _case(2, 100, 5, 9)
    lw, mu, sg = (np.concatenate([a, np.full((2, 3), f, np.float32)], 1)
                  for a, f in zip(above, (-np.inf, 7.0, 0.5)))
    np.testing.assert_allclose(_port(z, below, (lw, mu, sg)),
                               _port(z, below, above), rtol=1e-6, atol=1e-6)


def test_rejects_bad_shapes():
    z, below, above = _case(2, 10, 3, 4)
    t = [torch.as_tensor(a) for a in (z, *below, *above)]
    with pytest.raises(ValueError):
        ei_mod.ei_scores(t[0], t[1][:1], *t[2:])
    with pytest.raises(ValueError):
        ei_mod.ei_scores(t[0], *t[1:5], t[5][:, :2], t[6])


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("available", [False, True])
def test_cuda_tensor_never_falls_back(monkeypatch, available, tmp_path):
    """A tensor on a CUDA device launches the kernel or raises, on every
    lowering: it must not reach the plain version, with or without a
    usable card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(ei_mod, "_libs", {})
    monkeypatch.setattr(ei_mod, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(ei_mod, "_nvcc", lambda: "/nonexistent/nvcc")

    def _fallback(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ei_mod, "ei_scores_reference", _fallback)
    z, below, above = _case(2, 10, 3, 4)
    t = [torch.Tensor._make_subclass(_ClaimsCuda, torch.as_tensor(a))
         for a in (z, *below, *above)]
    launches = ei_mod.ei_scores.launches
    by = dict(ei_mod.ei_scores.launches_by)
    for kw in ({}, {"bf16": True}, {"mxu": True}):
        with pytest.raises((RuntimeError, OSError)):
            ei_mod.ei_scores(*t, **kw)
    assert ei_mod.ei_scores.launches == launches
    assert ei_mod.ei_scores.launches_by == by


@pytest.mark.cuda
def test_kernel_matches_reference_on_card():
    """Each lowering's kernel against its plain version on the card: 2e-4
    for f32 and bf16, and for the tensor-core form the JAX package's
    tolerance of mxu against vpu, 2e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    z, below, above = _case(31, 3000, 26, 1025)
    t = [torch.as_tensor(a, device="cuda") for a in (z, *below, *above)]
    for low, kw, tol in (("f32", {}, 2e-4), ("bf16", {"bf16": True}, 2e-4),
                         ("mxu", {"mxu": True}, 2e-3)):
        launches = ei_mod.ei_scores.launches
        by = ei_mod.ei_scores.launches_by[low]
        got = ei_mod.ei_scores(*t, **kw)
        torch.cuda.synchronize()
        assert ei_mod.ei_scores.launches == launches + 1
        assert ei_mod.ei_scores.launches_by[low] == by + 1
        want = ei_mod.ei_scores_reference(*t, **kw)
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)

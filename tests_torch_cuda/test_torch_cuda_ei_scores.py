"""The EI kernels on the card (the CPU half, the plain versions against
the JAX package: ``tests/test_torch_ei_scores.py``)."""

import numpy as np
import pytest
import torch

from hyperopt_tpu_torch.ops import ei_scores as ei_mod


def _mixture(rng, c, k, k_live):
    logw = np.full((c, k), -np.inf, np.float32)
    for i in range(c):
        w = rng.random(k_live) + 0.1
        logw[i, :k_live] = np.log(w / w.sum())
    mu = np.where(np.isfinite(logw), rng.normal(0, 3, (c, k)), 0.0)
    sg = np.where(np.isfinite(logw), rng.uniform(0.3, 3, (c, k)), 1.0)
    return [a.astype(np.float32) for a in (logw, mu, sg)]


def _case(c, n, kb, ka, seed=0):
    rng = np.random.default_rng(seed)
    below = _mixture(rng, c, kb, max(1, kb - 1))
    above = _mixture(rng, c, ka, max(1, ka - 3))
    z = rng.normal(0, 3, (c, n)).astype(np.float32)
    return z, below, above


@pytest.mark.cuda
def test_kernel_matches_reference_on_card():
    """Each lowering's kernel against its plain version on the card: 2e-4
    for f32 and bf16, and for the tensor-core form the JAX package's
    tolerance of mxu against vpu, 2e-3."""
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

"""The dispatch substrate on the card (the CPU half:
``tests/test_torch_dispatch.py``): a world-1 NCCL mesh, sharded rows
equal to local ones, the EI kernel's independence of how the candidates
are split, and ``fmin_device(mesh=)`` with the collective inside the
captured graph."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import base, device, dispatch, rand, tpe
from hyperopt_tpu_torch.ops import ei_scores as ek
from hyperopt_tpu_torch.parallel import multihost

SPACE = {"x": ht.hp.uniform("x", -5, 5), "lr": ht.hp.loguniform("lr", -6, 0),
         "q": ht.hp.quniform("q", 0, 20, 2),
         "c": ht.hp.choice("c", [0, 1, 2])}


@pytest.fixture(scope="module")
def mesh():
    m = multihost.initialize()
    yield m
    dispatch.clear_default_mesh()
    dist.destroy_process_group()


def _trials(dom, n=40):
    t = ht.Trials()
    rng = np.random.default_rng(0)
    docs = rand.suggest(list(range(n)), dom, t, 3)
    for d in docs:
        d["state"] = base.JOB_STATE_DONE
        d["result"] = {"status": "ok", "loss": float(rng.normal())}
    t.insert_trial_docs(docs)
    t.refresh()
    return t


@pytest.mark.cuda
def test_nccl_mesh_rows_equal_local(mesh):
    assert dist.get_backend() == "nccl"
    assert mesh.device_type == "cuda" and tuple(mesh.shape) == (1, 1)
    dom = ht.Domain(lambda d: 0.0, SPACE)
    t = _trials(dom)
    for ids in ([40], [40, 41, 42]):
        want = tpe.suggest_batch(ids, dom, t, 5, n_EI_candidates=1024)
        got = tpe._force_rows(dispatch.suggest_dispatch(
            ids, dom, t, 5, mesh=mesh, strict=True, n_EI_candidates=1024))
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("lowering", ek.LOWERINGS)
@pytest.mark.parametrize("shards", [2, 4])
def test_kernel_scores_do_not_depend_on_the_split(lowering, shards):
    g = torch.Generator(device="cuda").manual_seed(1)
    c, n, kb, ka = 31, 4000, 26, 257

    def r(*s):
        return torch.rand(s, generator=g, device="cuda")

    z = r(c, n) * 4 - 2
    mix = [r(c, kb).log(), r(c, kb) * 4 - 2, r(c, kb) + 0.1,
           r(c, ka).log(), r(c, ka) * 4 - 2, r(c, ka) + 0.1]
    kw = dict(mxu=lowering == "mxu", bf16=lowering == "bf16")
    full = ek.ei_scores(z, *mix, **kw)
    w = n // shards
    parts = [ek.ei_scores(z[:, i * w:(i + 1) * w].contiguous(), *mix, **kw)
             for i in range(shards)]
    assert torch.equal(torch.cat(parts, dim=1), full)


@pytest.mark.cuda
def test_fmin_device_mesh_captures_the_collective(mesh):
    def obj(p):
        return (p["x"] - 1.0) ** 2 + 0.01 * p["q"]

    _, want = ht.fmin_device(obj, SPACE, 64, seed=2, n_EI_candidates=512)
    device.reset_counters()
    _, got = ht.fmin_device(obj, SPACE, 64, seed=2, n_EI_candidates=512,
                            mesh=mesh)
    assert device.eager_steps == 0 and device.captures == 1
    np.testing.assert_array_equal(got["vals"], want["vals"])
    np.testing.assert_array_equal(got["losses"], want["losses"])

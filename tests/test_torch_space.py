"""Search spaces in the PyTorch port against hyperopt_tpu: the same spaces
compile to the same tables, masks and decodes, and the two samplers draw
from the same distributions."""

import dataclasses

import jax
import numpy as np
import pytest
import scipy.stats as st
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu.space import compile_space as compile_j
from hyperopt_tpu_torch.space import compile_space as compile_t


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def flagship(pkg, n_dims=20):
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
    return space


def many_dists(pkg):
    hp = pkg.hp
    return {
        "a": hp.choice("a", [0, 1, 2]),
        "b": hp.randint("b", 10),
        "bb": hp.randint("bb", 5, 25),
        "c": hp.uniform("c", 0, 1),
        "d": hp.loguniform("d", -3, 2),
        "e": hp.quniform("e", 1, 10, 2),
        "f": hp.qloguniform("f", 0, 3, 1),
        "g": hp.normal("g", 4, 2),
        "h": hp.lognormal("h", 0, 1),
        "i": hp.qnormal("i", 0, 5, 1),
        "j": hp.qlognormal("j", 0, 2, 1),
        "k": hp.pchoice("k", [(0.1, 0), (0.9, 1)]),
        "l": hp.uniformint("l", 1, 8),
        "w": hp.randint("w", 3000),
        "z": hp.choice("z", [
            {"zz": hp.uniform("zz", 0, 1)},
            {"zw": hp.normal("zw", 0, 1), "zc": hp.choice("zc", ["p", "q"])},
        ]),
    }


def nested_exprs(pkg):
    hp, scope = pkg.hp, pkg.scope
    return {
        "layers": scope.int(hp.quniform("layers", 1, 6, 1)),
        "act": scope.switch(hp.randint("act", 3), "relu", "tanh", "gelu"),
        "width": hp.uniform("width", 0, 1) * 10 + 1,
        "opt": hp.choice("opt", [
            ("sgd", hp.loguniform("lr_sgd", -5, 0)),
            ("adam", hp.choice("beta", [0.9, 0.99]),
             [hp.normal("wd", 0, 1)]),
        ]),
    }


SPACES = {"flagship": flagship, "many_dists": many_dists,
          "nested_exprs": nested_exprs}


@pytest.fixture(params=sorted(SPACES))
def pair(request):
    build = SPACES[request.param]
    return compile_j(build(hj)), compile_t(build(ht))


def jax_rows(csj, n, seed=0):
    vals, _ = csj.sample(jax.random.key(seed), n)
    return np.asarray(vals)


def test_param_tables_equal(pair):
    csj, cst = pair
    assert [dataclasses.asdict(p) for p in csj.params] == \
        [dataclasses.asdict(p) for p in cst.params]
    np.testing.assert_array_equal(csj._inv_perm, cst._inv_perm)
    assert csj._cond_by_pid == cst._cond_by_pid


def test_active_mask_and_decode_equal(pair):
    csj, cst = pair
    vals = jax_rows(csj, 64)
    want = np.asarray(csj.active_mask(vals))
    np.testing.assert_array_equal(cst.active_mask_host(vals), want)
    np.testing.assert_array_equal(
        cst.active_mask(torch.as_tensor(vals)).numpy(), want)
    for row, act in zip(vals[:16], want[:16]):
        assert cst.decode_row(row) == csj.decode_row(row)
        point = {p.label: [row[p.pid].item()] for p in cst.params
                 if act[p.pid]}
        assert cst.eval_point(point) == csj.eval_point(point)


def test_space_eval_equal():
    space_j, space_t = many_dists(hj), many_dists(ht)
    vals = jax_rows(compile_j(space_j), 8, seed=3)
    cst = compile_t(space_t)
    for row in vals:
        point = {p.label: row[p.pid].item() for p in cst.params}
        assert ht.space_eval(space_t, point) == hj.space_eval(space_j, point)


def _discrete(kind):
    return kind in ("categorical", "randint", "quniform", "qloguniform",
                    "qnormal", "qlognormal", "uniformint")


@pytest.mark.parametrize("name", ["flagship", "many_dists"])
def test_sampler_matches_jax_distributions(name):
    """KS (continuous columns) and χ² (discrete columns) two-sample tests
    of 4096 port draws against 4096 JAX draws, column by column."""
    n = 4096
    csj, cst = compile_j(SPACES[name](hj)), compile_t(SPACES[name](ht))
    vj = jax_rows(csj, n, seed=1)
    vt, at = cst.sample(n, generator=torch.Generator().manual_seed(1),
                        device="cpu")
    vt = vt.numpy()
    np.testing.assert_array_equal(at.numpy(), cst.active_mask_host(vt))
    for p in cst.params:
        a, b = vj[:, p.pid], vt[:, p.pid]
        assert np.isfinite(b).all(), p.label
        if not _discrete(p.kind):
            assert st.ks_2samp(a, b).pvalue > 1e-4, p.label
            continue
        values = np.union1d(a, b)
        if len(values) > 64:      # wide integer ranges: compare as numbers
            assert st.ks_2samp(a, b).pvalue > 1e-4, p.label
            continue
        table = np.stack([[np.sum(a == v) for v in values],
                          [np.sum(b == v) for v in values]])
        table = table[:, table.sum(0) >= 10]
        if table.shape[1] > 1:
            assert st.chi2_contingency(table).pvalue > 1e-4, p.label


def test_injected_uniforms_drive_the_sampler():
    cst = compile_t(many_dists(ht))
    shapes = cst.noise_shapes(5)
    rng = np.random.default_rng(0)
    noise = {k: rng.random(s, dtype=np.float32) for k, s in shapes.items()}
    a, _ = cst.sample(5, noise=noise, device="cpu")
    b, _ = cst.sample(5, noise=noise, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    u = cst.by_label["c"]
    col = cst._uf.index(u)
    np.testing.assert_allclose(a[:, u.pid].numpy(), noise["uf"][:, col],
                               rtol=1e-6)


def test_cuda_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cst = compile_t(many_dists(ht))
    with pytest.raises(RuntimeError, match="CUDA"):
        cst.sample(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.fmin(lambda d: 0.0, many_dists(ht), max_evals=1)

"""The backend registry and the conformance suite of the PyTorch port
(``hyperopt_tpu_torch/backends/contract.py``), mirroring
``tests/test_backends.py``: the registry's cases against the JAX package's
names, and the four conformance checks parametrized over the port's
eleven unique heads, on the CPU.  No tolerance: these are behaviours.
"""

import pickle
from functools import partial

import numpy as np
import pytest
import torch

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import backends as backends_j
from hyperopt_tpu_torch import atpe, base, hp, mix
from hyperopt_tpu_torch.backends import (UnknownBackend, contract, names,
                                         register_backend, resolve)
from hyperopt_tpu_torch.obs import metrics

CPU = "cpu"
# Aliases (random, sobol) resolve to their head's callable: covered by
# test_aliases_share_callable, not run through the suite again.
UNIQUE_HEADS = ["rand", "tpe", "tpe_quantile", "tpe_sobol", "tpe_mv",
                "qmc", "halton", "anneal", "atpe", "gp", "es"]
DISPATCH_CAPABLE = {"tpe", "tpe_quantile", "tpe_sobol", "tpe_mv", "gp",
                    "es"}


@pytest.fixture(autouse=True)
def _few_threads_no_transfer():
    # ATPE's transfer memory would couple runs through a file; off here.
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    old = atpe.set_transfer_store(None)
    yield
    atpe.set_transfer_store(old)
    torch.set_num_threads(n)


def _fmin(fn, space, algo, max_evals, seed, **kw):
    t = base.Trials()
    ht.fmin(fn, space, algo=algo, max_evals=max_evals, trials=t,
            rstate=np.random.default_rng(seed), device=CPU,
            show_progressbar=False, verbose=False, **kw)
    return t


# -- registry -------------------------------------------------------------------


def test_names_equal_jax():
    assert names() == backends_j.names()
    assert set(contract._BUILTIN_SPECS) == set(
        backends_j.contract._BUILTIN_SPECS)
    for name, module in contract._BUILTIN_SPECS.items():
        assert module == backends_j.contract._BUILTIN_SPECS[name].replace(
            "hyperopt_tpu.", "hyperopt_tpu_torch.")


def test_builtins_resolvable():
    got = names()
    for name in UNIQUE_HEADS + ["random", "sobol"]:
        assert name in got, name
        assert callable(resolve(name))
    before = metrics.registry().counter("backend.gp.resolved").value
    resolve("gp")
    assert metrics.registry().counter("backend.gp.resolved").value == \
        before + 1


def test_unknown_name_typed_error():
    with pytest.raises(UnknownBackend, match="unknown algo"):
        resolve("cma_es_9000")
    with pytest.raises(ValueError):
        resolve("cma_es_9000")
    with pytest.raises(UnknownBackend):
        _fmin(lambda d: 0.0, {"x": hp.uniform("x", 0, 1)}, "cma_es_9000", 2,
              0)


def test_aliases_share_callable():
    assert resolve("random") is resolve("rand")
    assert resolve("sobol") is resolve("qmc")
    assert resolve("tpe") is ht.tpe.suggest
    assert resolve("tpe_quantile") is ht.tpe.suggest_quantile
    assert resolve("anneal") is ht.anneal.suggest
    assert resolve("atpe") is atpe.suggest
    mv = resolve("tpe_mv")
    assert isinstance(mv, partial) and mv.keywords == dict(
        split="quantile", multivariate=True, n_EI_candidates=128)
    assert resolve("tpe_sobol").keywords == dict(startup="qmc")


def test_register_and_resolve_roundtrip():
    calls = []

    def my_head(new_ids, domain, trials, seed):
        calls.append(list(new_ids))
        return ht.rand.suggest(new_ids, domain, trials, seed)

    register_backend("my_head_rt", my_head)
    try:
        assert resolve("my_head_rt") is my_head
        assert "my_head_rt" in names()
        t = _fmin(lambda d: d["x"] ** 2, {"x": hp.uniform("x", -1, 1)},
                  "my_head_rt", 3, 0)
        assert len(t.trials) == 3 and calls
        register_backend("my_head_rt", ht.rand.suggest, replace=True)
        assert resolve("my_head_rt") is ht.rand.suggest
    finally:
        with contract._REGISTRY_LOCK:
            contract._REGISTRY.pop("my_head_rt", None)
    assert "my_head_rt" not in names()


def test_register_rejects_collisions_and_noncallables():
    with pytest.raises(ValueError, match="already registered"):
        register_backend("tpe", lambda *a: [])
    with pytest.raises(TypeError):
        register_backend("not_callable", 42)


def test_fmin_resolves_names_and_defaults_to_tpe():
    space = {"x": hp.uniform("x", -2, 2)}
    for name in ("gp", "es", "tpe_mv"):
        t = _fmin(lambda d: d["x"] ** 2, space, name, 6, 1)
        assert len(t.trials) == 6, name
    a = _fmin(lambda d: d["x"] ** 2, space, None, 24, 2)
    b = _fmin(lambda d: d["x"] ** 2, space, ht.tpe.suggest, 24, 2)
    assert [d["misc"]["vals"] for d in a] == [d["misc"]["vals"] for d in b]


def test_fmin_device_mode_takes_tpe_names():
    space = {"x": hp.uniform("x", -2, 2)}

    def obj(p):
        return p["x"] * p["x"]

    a = _fmin(obj, space, "tpe_quantile", 24, 3, mode="device")
    b = _fmin(obj, space, ht.tpe.suggest_quantile, 24, 3, mode="device")
    assert [d["misc"]["vals"] for d in a] == [d["misc"]["vals"] for d in b]
    with pytest.raises(ValueError, match="TPE only"):
        _fmin(obj, space, "gp", 4, 3, mode="device")


def test_server_table_covers_all_heads():
    table = contract.server_table()
    for name in UNIQUE_HEADS:
        assert name in table, name
    assert table["tpe"].keywords == {"verbose": False}
    assert table["gp"] is resolve("gp")


def test_halves_and_introspect_of():
    d, m, s, r = contract.halves_of(resolve("tpe_mv"))
    assert d.keywords == resolve("tpe_mv").keywords
    assert m is ht.tpe.suggest_materialize
    assert contract.halves_of(resolve("anneal")) == (None,) * 4
    assert contract.introspect_of(resolve("tpe_mv")) is ht.tpe.introspect
    assert contract.introspect_of(resolve("gp")) is \
        ht.backends.gp.introspect
    assert contract.introspect_of(resolve("es")) is None


# -- conformance suite over every head ------------------------------------------


@pytest.mark.parametrize("check", contract.CONFORMANCE_CHECKS)
@pytest.mark.parametrize("name", UNIQUE_HEADS)
def test_conformance(name, check):
    out = getattr(contract, f"check_{check}")(resolve(name), device=CPU)
    if check == "handle_protocol":
        want = ("dispatch-capable" if name in DISPATCH_CAPABLE
                else "sync-only")
        assert out == want, name


def test_run_conformance_and_its_domain():
    out = contract.run_conformance(resolve("gp"), device=CPU)
    assert out == {"sync_parity": "ok", "handle_protocol": "dispatch-capable",
                   "pipeline_depth2": "ok", "transient_retry": "ok"}
    dom = contract.conformance_domain(CPU)
    a = contract.seeded_trials(dom, seed=4)
    b = contract.seeded_trials(dom, seed=4)
    assert [d["misc"]["vals"] for d in a] == [d["misc"]["vals"] for d in b]
    assert str(dom.cs.device) == CPU


# -- composition: mix / atpe arms by name ---------------------------------------


def test_mix_resolves_registry_names():
    t = _fmin(lambda d: d["x"] ** 2, {"x": hp.uniform("x", -2, 2)},
              partial(mix.suggest, p_suggest=[(0.5, "rand"), (0.5, "es")]),
              10, 2)
    assert len(t.trials) == 10
    dom = base.Domain(lambda d: 0.0, {"x": hp.uniform("x", 0, 1)})
    with pytest.raises(UnknownBackend):
        mix.suggest([0], dom, base.Trials(), 0, p_suggest=[(1.0, "nope")])


def test_atpe_extra_algo_arms():
    t = _fmin(lambda d: d["x"] ** 2, {"x": hp.uniform("x", -2, 2)},
              partial(atpe.suggest, extra_algos=("gp", "es")), 18, 3)
    assert len(t.trials) == 18
    assert all(d["state"] == base.JOB_STATE_DONE for d in t.trials)
    assert len(t._atpe_state.wins) == len(atpe._portfolio(
        ht.compile_space({"x": hp.uniform("x", -2, 2)}))) + 2


# -- substrate invariants -------------------------------------------------------


def test_head_program_caches_are_not_pickled():
    domain = contract.conformance_domain(CPU)
    trials = contract.seeded_trials(domain, n=24, seed=0)
    for name in ("gp", "es", "anneal"):
        resolve(name)(list(range(24, 26)), domain, trials, 7)
    cs = domain.cs
    for key in ("_gp_kernels", "_es_kernels", "_anneal_kernels"):
        assert getattr(cs, key, None), key
        assert key not in pickle.loads(pickle.dumps(cs)).__dict__


def test_gp_beats_rand_smoke():
    space = {"x": hp.uniform("x", -5, 5)}

    def run(algo):
        t = _fmin(lambda d: (d["x"] - 3.0) ** 2, space, algo, 25, 4)
        return min(d["result"]["loss"] for d in t.trials)

    assert run("gp") <= run("rand")


def test_jax_names_resolve_in_both():
    # The same strings name the same kind of head in both packages.
    for name in UNIQUE_HEADS:
        fj, ft = backends_j.resolve(name), resolve(name)
        assert (contract.halves_of(ft)[0] is None) == \
            (backends_j.contract.halves_of(fj)[0] is None), name
    assert hj.tpe.BACKENDS.keys() == ht.tpe.BACKENDS.keys()

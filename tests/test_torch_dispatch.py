"""The dispatch substrate of the PyTorch port against hyperopt_tpu's.

Mirrors ``tests/test_dispatch.py``:

* **routing**: ``set_mode`` (the port's form of the JAX package's
  environment switch), auto without a mesh stays local, a registered mesh
  routes, ``"sharded"`` builds and memoizes, an indivisible candidate
  count raises when strict and falls back (counted) when ambient;
* **bit parity** on a world-1 gloo mesh in this process: local against
  substrate, single and batch of 4, ``sharded_suggest`` against both, the
  joint step, cohorts and depth-2 handles under a mesh;
* **bit parity with 2 and 4 ranks**: one pool of gloo processes per world
  size runs every check of :data:`WORKER` (sharded single, liar batch and
  joint rows; ``fmin_device(mesh=)`` at ``n_runs`` 1 and 4;
  ``fmin_fleet(mesh=)``; a cohort; multi-start over ``dp``; the kernel
  cache) against the port's local rows in the same process;
* **against JAX**: the sharded rows equal JAX's ``sharded_suggest`` on its
  8-device CPU mesh given JAX's uniforms, ``multi_start_suggest`` with
  K = 4 equals JAX's on JAX's per-start keys, and ``_gamma_spread`` is
  JAX's bit for bit;
* **compile discipline** and **pickles**.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import hyperopt_tpu as hj
import hyperopt_tpu_torch as ht
from hyperopt_tpu import dispatch as dispatch_j
from hyperopt_tpu import tpe as tpe_j
from hyperopt_tpu.parallel import sharded as sharded_j
from hyperopt_tpu.space import prng_key
from hyperopt_tpu_torch import base, dispatch, fleet, rand, tpe
from hyperopt_tpu_torch.obs import kernel_cache_stats
from hyperopt_tpu_torch.obs.metrics import registry
from hyperopt_tpu_torch.parallel import multi_start_suggest, sharded_suggest
from test_torch_tpe import _history, _jax_step_uniforms, flagship

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
RTOL = 1e-5    # continuous columns against JAX (test_torch_liar.py's)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    """A world-1 gloo process group in this process and its (1, 1) mesh."""
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield dispatch.default_mesh(device_type=CPU)
    dispatch.clear_default_mesh()
    dispatch.set_mode("auto")
    if own:
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _routing_hygiene():
    yield
    dispatch.clear_default_mesh()
    dispatch.set_mode("auto")


def _counter(name):
    return registry().snapshot()["counters"].get(name, 0.0)


def _domain(labels=("x", "lr", "c", "a")):
    x, lr, c, a = labels
    hp = ht.hp
    space = {x: hp.uniform(x, -5, 5), lr: hp.loguniform(lr, -6, 0),
             c: hp.choice(c, [{a: hp.normal(a, 0, 1)}, {"k": 2}]),
             "q" + x: hp.quniform("q" + x, 0, 20, 2)}
    dom = ht.Domain(lambda d: 0.0, space)
    dom.cs.device = CPU
    return dom


def _hist_trials(n=24, seed0=50, exp_key="e0", dom=None):
    dom = dom or _domain()
    t = ht.Trials(exp_key=exp_key)
    rng = np.random.default_rng(seed0)
    docs = rand.suggest(list(range(n)), dom, t, int(rng.integers(2 ** 31)))
    for d in docs:
        d["state"] = base.JOB_STATE_DONE
        d["result"] = {"status": "ok", "loss": float(rng.normal())}
    t.insert_trial_docs(docs)
    t.refresh()
    return dom, t


def _docs(docs):
    return json.loads(json.dumps(docs))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


class TestRouting:
    def test_set_mode(self):
        assert dispatch.mode() == "auto"
        for raw, want in (("local", "local"), ("SHARDED ", "sharded"),
                          ("auto", "auto")):
            dispatch.set_mode(raw)
            assert dispatch.mode() == want
        assert dispatch.set_mode("local") == "auto"
        for bad in ("bogus", ""):
            with pytest.raises(ValueError, match="dispatch mode"):
                dispatch.set_mode(bad)
        assert dispatch.mode() == "local"

    def test_auto_without_mesh_stays_local(self):
        assert dispatch.active_mesh() is None

    def test_registered_mesh_routes_auto(self, mesh):
        dispatch.set_default_mesh(mesh)
        assert dispatch.active_mesh() is mesh
        # local mode vetoes even a registered or explicit mesh
        dispatch.set_mode("local")
        assert dispatch.active_mesh() is None
        assert dispatch.active_mesh(mesh) is None

    def test_sharded_mode_builds_and_memoizes(self, mesh):
        dispatch.set_mode("sharded")
        m1 = dispatch.active_mesh()
        assert m1 is not None and m1 is dispatch.active_mesh()
        assert m1.mesh_dim_names == (dispatch.START_AXIS, dispatch.CAND_AXIS)
        assert m1.device_type == "cpu"          # the gloo group's devices
        assert dispatch.axis_size(m1, dispatch.CAND_AXIS) == \
            dist.get_world_size()

    def test_default_mesh_needs_a_group(self, monkeypatch):
        monkeypatch.setattr(dist, "is_initialized", lambda: False)
        with pytest.raises(RuntimeError, match="process group"):
            dispatch.default_mesh(device_type=CPU)

    def test_default_mesh_rejects_indivisible_starts(self, mesh):
        with pytest.raises(ValueError, match="not divisible by n_starts=2"):
            dispatch.default_mesh(n_starts=2, device_type=CPU)

    def test_mesh_key_is_the_layout(self, mesh):
        again = dispatch.default_mesh(device_type=CPU)
        assert dispatch._mesh_key(again) == dispatch._mesh_key(mesh) == (
            ("dp", "sp"), (1, 1), (0,), "cpu")

    def test_indivisible_candidates(self, monkeypatch):
        dom, _ = _hist_trials()
        # A stand-in 8-way candidate axis: the checks run before any
        # collective.
        monkeypatch.setattr(dispatch, "axis_size",
                            lambda m, axis: 8 if axis == "sp" else 1)
        fake = type("M", (), {"mesh_dim_names": ("dp", "sp")})()
        with pytest.raises(ValueError, match="divisible"):
            dispatch.get_kernel(dom.cs, 32, 100, 25, device=CPU, mesh=fake,
                                strict=True)
        c0 = _counter("dispatch.fallback_indivisible")
        kern = dispatch.get_kernel(dom.cs, 32, 100, 25, device=CPU,
                                   mesh=fake)
        assert not isinstance(kern, dispatch.ShardedTpeKernel)
        assert kern is tpe.get_kernel(dom.cs, 32, 100, 25, device=CPU)
        assert _counter("dispatch.fallback_indivisible") == c0 + 1


# ---------------------------------------------------------------------------
# bit parity on a world-1 mesh
# ---------------------------------------------------------------------------


class TestBitParity:
    def test_local_vs_substrate_single_and_batch(self, mesh):
        dom, t = _hist_trials()
        ref1 = tpe.suggest_batch([24], dom, t, 777)
        ref4 = tpe.suggest_batch([25, 26, 27, 28], dom, t, 778)
        dispatch.set_mode("sharded")
        c0 = _counter("dispatch.sharded")
        got1 = tpe.suggest_batch([24], dom, t, 777)
        got4 = tpe.suggest_batch([25, 26, 27, 28], dom, t, 778)
        assert _counter("dispatch.sharded") == c0 + 2
        for ref, got in ((ref1, got1), (ref4, got4)):
            np.testing.assert_array_equal(ref[0], got[0])
            np.testing.assert_array_equal(ref[1], got[1])

    def test_sharded_shim_matches_local_and_substrate(self, mesh):
        dom, t = _hist_trials()
        ref = _docs(tpe.suggest([30], dom, t, 4242, n_EI_candidates=64))
        assert _docs(sharded_suggest([30], dom, t, 4242, mesh=mesh,
                                     n_EI_candidates=64)) == ref
        dispatch.set_default_mesh(mesh)
        assert _docs(tpe.suggest([30], dom, t, 4242,
                                 n_EI_candidates=64)) == ref

    @pytest.mark.parametrize("kw", [{"multivariate": True},
                                    {"split": "quantile"},
                                    {"ei_precision": "bf16"},
                                    {"ei_impl": "mxu"}],
                             ids=["joint", "quantile", "bf16", "mxu"])
    def test_every_head_and_lowering_inherits_the_mesh(self, mesh, kw):
        dom, t = _hist_trials()
        ref = tpe.suggest_batch([30, 31], dom, t, 99, **kw)
        dispatch.set_default_mesh(mesh)
        c0 = _counter("dispatch.sharded")
        got = tpe.suggest_batch([30, 31], dom, t, 99, **kw)
        assert _counter("dispatch.sharded") == c0 + 1
        np.testing.assert_array_equal(ref[0], got[0])

    def test_fleet_cohort_under_mesh_matches_solo_local(self, mesh):
        doms, trials, seeds = [], [], []
        for e in range(3):
            dom, t = _hist_trials(n=22 + e, seed0=60 + e, exp_key=f"e{e}")
            doms.append(dom)
            trials.append(t)
            seeds.append(5000 + 17 * e)
        solo = [_docs(tpe.suggest([50 + e], doms[e], trials[e], seeds[e]))
                for e in range(3)]
        dispatch.set_default_mesh(mesh)
        sched = fleet.CohortScheduler()
        d0, s0 = _counter("fleet.dispatches"), _counter("dispatch.sharded")
        kernel_cache_stats(reset=True)
        out = sched.suggest(
            [([50 + e], doms[e], trials[e], seeds[e]) for e in range(3)])
        assert _counter("fleet.dispatches") == d0 + 1   # one cohort
        assert any(isinstance(k, dispatch.ShardedTpeKernel) for k in
                   doms[0].cs.__dict__.get("_dispatch_kernels", {}).values())
        assert _counter("dispatch.sharded") == s0       # no solo fallback
        assert [_docs(o) for o in out] == solo

    def test_depth2_pipeline_fleet_lane_parity(self, mesh):
        pairs = [_hist_trials(n=22 + e, seed0=70 + e, exp_key=f"p{e}")
                 for e in range(2)]
        reqs_a = [([60], pairs[0][0], pairs[0][1], 111),
                  ([61], pairs[1][0], pairs[1][1], 222)]
        reqs_b = [([62], pairs[0][0], pairs[0][1], 333),
                  ([63], pairs[1][0], pairs[1][1], 444)]
        ref = [_docs(tpe.suggest(ids, d, t, s))
               for ids, d, t, s in reqs_a + reqs_b]
        dispatch.set_mode("sharded")
        sched = fleet.CohortScheduler()
        ha = sched.suggest_dispatch(reqs_a)
        hb = sched.suggest_dispatch(reqs_b)     # A still in flight
        for h in ha + hb:
            fleet.suggest_start_transfer(h)
        assert [_docs(fleet.suggest_materialize(h)) for h in ha + hb] == ref

    def test_device_mode_under_a_mesh_equals_local(self, mesh):
        def obj(p):
            return (p["x"] - 1.0) ** 2 + p["qx"] * 0.01
        dom = _domain()
        _, want = ht.fmin_device(obj, dom.expr, 40, seed=3, device=CPU,
                                 n_EI_candidates=32)
        _, got = ht.fmin_device(obj, dom.expr, 40, seed=3, device=CPU,
                                n_EI_candidates=32, mesh=mesh)
        np.testing.assert_array_equal(got["vals"], want["vals"])
        np.testing.assert_array_equal(got["losses"], want["losses"])
        # fmin(mode="device") with a registered mesh: the same trials.
        t_ref, t_got = ht.Trials(), ht.Trials()
        ht.fmin(obj, dom.expr, algo=tpe.suggest, max_evals=30, trials=t_ref,
                mode="device", rstate=np.random.default_rng(1), device=CPU,
                show_progressbar=False)
        dispatch.set_default_mesh(mesh)
        ht.fmin(obj, dom.expr, algo=tpe.suggest, max_evals=30, trials=t_got,
                mode="device", rstate=np.random.default_rng(1), device=CPU,
                show_progressbar=False)
        assert t_got.losses() == t_ref.losses()

    def test_fmin_device_checks_the_mesh_at_the_boundary(self, mesh,
                                                          monkeypatch,
                                                          caplog):
        dom = _domain()
        real = dispatch.axis_size
        monkeypatch.setattr(dispatch, "axis_size",
                            lambda m, axis: 8 if axis == "sp"
                            else real(m, axis))
        with pytest.raises(ValueError,
                           match="pass n_EI_candidates=32 .next multiple"):
            ht.fmin_device(lambda p: p["x"], dom.expr, 8, device=CPU,
                           n_EI_candidates=30, mesh=mesh)
        monkeypatch.setattr(dispatch, "axis_size",
                            lambda m, axis: 3 if axis == "dp"
                            else real(m, axis))
        with pytest.raises(ValueError, match="n_runs=4 not divisible"):
            ht.fmin_device(lambda p: p["x"], dom.expr, 8, device=CPU,
                           n_runs=4, mesh=mesh)
        with pytest.raises(ValueError, match="n_lanes=4 not divisible"):
            ht.fmin_fleet(lambda p: p["x"], dom.expr, 4, 8, device=CPU,
                          mesh=mesh)
        monkeypatch.setattr(dispatch, "axis_size", real)
        with caplog.at_level("WARNING"):
            ht.fmin_device(lambda p: p["x"], dom.expr, 4, device=CPU,
                           n_runs=2, mesh=mesh)
        assert "mesh has dp=1" in caplog.text

    def test_multi_start_lanes_are_solo_steps(self, mesh):
        """Start ``k`` is the solo step on the same history with its own
        generator and its own γ; the mesh (dp = 1) changes nothing."""
        dom, t = _hist_trials(n=30)
        ids = [30, 31, 32]
        got = multi_start_suggest(ids, dom, t, 909, n_EI_candidates=64)
        assert _docs(multi_start_suggest(ids, dom, t, 909, mesh=mesh,
                                         n_EI_candidates=64)) == _docs(got)
        h = t.history(dom.cs)
        kern = tpe.get_kernel(dom.cs, tpe._bucket(30), 64, 25, device=CPU)
        hist = [torch.as_tensor(a) for a in tpe._padded_history(h, 32)]
        gammas = dispatch._gamma_spread(0.25, 3)
        seeds = dispatch._start_seeds(909, 3)
        rows = np.stack([kern(*hist, float(gammas[k]), 1.0,
                              generator=torch.Generator().manual_seed(
                                  seeds[k]))[0].numpy()
                         for k in range(3)])
        want = base.docs_from_samples(dom.cs, ids, rows,
                                      dom.cs.active_mask_host(rows),
                                      exp_key=t.exp_key)
        assert _docs(got) == _docs(want)
        assert len({json.dumps(d["misc"]["vals"]) for d in got}) == 3


# ---------------------------------------------------------------------------
# bit parity with 2 and 4 gloo ranks, one pool of processes per world size
# ---------------------------------------------------------------------------

#: Run by every rank: each check compares the sharded path with the port's
#: local rows computed in the same process, and writes ``"ok"`` or the
#: traceback.
WORKER = textwrap.dedent('''
    import json, sys, traceback
    from datetime import timedelta
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=90))
    import hyperopt_tpu_torch as ht
    from hyperopt_tpu_torch import base, dispatch, fleet, rand, tpe
    from hyperopt_tpu_torch.obs import kernel_cache_stats
    from hyperopt_tpu_torch.parallel import multihost, sharded_suggest
    hp = ht.hp

    def space():
        return {"u": hp.uniform("u", -5, 5), "lu": hp.loguniform("lu", -4, 2),
                "q": hp.quniform("q", 0, 20, 2),
                "wq": hp.quniform("wq", 0, 1e5, 1.0),
                "n": hp.normal("n", 0, 2), "c": hp.choice("c", [0, 1, 2]),
                "br": hp.choice("br", [{"k": 0},
                                       {"k": 1, "d": hp.uniformint("d", 1, 8)}])}

    def domain():
        dom = ht.Domain(lambda d: 0.0, space())
        dom.cs.device = "cpu"
        return dom

    def trials(dom, n, seed, exp_key=None):
        t = ht.Trials(exp_key=exp_key)
        rng = np.random.default_rng(seed)
        docs = rand.suggest(list(range(n)), dom, t, seed)
        for d in docs:
            d["state"] = base.JOB_STATE_DONE
            d["result"] = {"status": "ok", "loss": float(rng.normal())}
        t.insert_trial_docs(docs)
        t.refresh()
        return t

    def obj(p):
        return (p["u"] - 1.0) ** 2 + 0.01 * p["q"] + 0.1 * p["c"]

    def rows(h):
        return tpe._force_rows(h)[0]

    res = {}

    def check(f):
        try:
            f()
            res[f.__name__] = "ok"
        except Exception:
            res[f.__name__] = traceback.format_exc()[-3000:]
        return f

    mesh_sp = dispatch.default_mesh(device_type="cpu")
    mesh_dp = dispatch.default_mesh(n_starts=2, device_type="cpu")
    dom = domain()
    t30 = trials(dom, 30, 5)
    KW = dict(n_EI_candidates=64)

    def same(ids, mesh, **kw):
        a = rows(dispatch.suggest_dispatch(ids, dom, t30, 7, **KW, **kw))
        b = rows(dispatch.suggest_dispatch(ids, dom, t30, 7, mesh=mesh,
                                           strict=True, **KW, **kw))
        assert np.array_equal(a, b), (a, b)

    @check
    def single():
        same([30], mesh_sp)

    @check
    def liar_batch():
        same([30, 31, 32, 33], mesh_sp)

    @check
    def joint():
        same([30], mesh_sp, multivariate=True)
        same([30, 31], mesh_sp, multivariate=True)

    @check
    def sp_within_dp_rows():
        same([30], mesh_dp)
        same([30, 31, 32], mesh_dp, multivariate=True)

    @check
    def sharded_shim():
        want = tpe.suggest([30], dom, t30, 11, **KW)
        got = sharded_suggest([30], dom, t30, 11, mesh=mesh_sp, **KW)
        assert json.dumps(got) == json.dumps(want)

    @check
    def fmin_device_sp():
        _, a = ht.fmin_device(obj, space(), 40, seed=3, device="cpu", **KW)
        _, b = ht.fmin_device(obj, space(), 40, seed=3, device="cpu",
                              mesh=mesh_sp, **KW)
        assert np.array_equal(a["vals"], b["vals"])
        assert np.array_equal(a["losses"], b["losses"], equal_nan=True)

    @check
    def fmin_device_dp():
        _, a = ht.fmin_device(obj, space(), 30, seed=4, device="cpu",
                              n_runs=4, **KW)
        _, b = ht.fmin_device(obj, space(), 30, seed=4, device="cpu",
                              n_runs=4, mesh=mesh_dp, **KW)
        for k in ("vals", "active", "losses"):
            assert np.array_equal(a[k], b[k]), k
        assert a["n_trials"] == b["n_trials"]
        assert a["best_index"] == b["best_index"]

    @check
    def fmin_fleet_dp():
        a = ht.fmin_fleet(obj, space(), 4, 30, seed=8, device="cpu",
                          sync_stride=16, **KW)
        tl = [ht.Trials() for _ in range(4)]
        b = ht.fmin_fleet(obj, space(), 4, 30, seed=8, device="cpu",
                          sync_stride=16, mesh=mesh_dp, trials_list=tl, **KW)
        for x, y, t in zip(a, b, tl):
            assert np.array_equal(x["vals"], y["vals"])
            assert np.array_equal(x["losses"], y["losses"])
            assert x["best"] == y["best"]
            assert [float(l) for l in x["losses"]] == t.losses()

    @check
    def cohort():
        doms = [domain() for _ in range(3)]
        ts = [trials(doms[e], 22 + e, 60 + e, exp_key=f"e{e}")
              for e in range(3)]
        solo = [tpe.suggest([50 + e], doms[e], ts[e], 500 + e)
                for e in range(3)]
        dispatch.set_default_mesh(mesh_sp)
        try:
            out = fleet.CohortScheduler().suggest(
                [([50 + e], doms[e], ts[e], 500 + e) for e in range(3)])
        finally:
            dispatch.clear_default_mesh()
        assert json.dumps(out) == json.dumps(solo)

    @check
    def multi_start_dp():
        ids = [40, 41, 42, 43]
        a = dispatch.multi_start_suggest(ids, dom, t30, 9, **KW)
        b = dispatch.multi_start_suggest(ids, dom, t30, 9, mesh=mesh_dp,
                                         **KW)
        assert json.dumps(a) == json.dumps(b)

    @check
    def compile_discipline():
        # Spaces compile once per structure and labels: private labels
        # keep the earlier checks' kernels out of this count.
        cs = ht.Domain(lambda d: 0.0, {"kd": hp.uniform("kd", 0, 1)}).cs
        kernel_cache_stats(reset=True)
        for m in (mesh_sp, mesh_dp):
            for n_cap in (64, 128):
                dispatch.get_kernel(cs, n_cap, 64, 25, device="cpu", mesh=m)
        assert kernel_cache_stats()["misses"] == 4
        kernel_cache_stats(reset=True)
        for m in (mesh_sp, mesh_dp):
            for n_cap in (64, 128):
                dispatch.get_kernel(cs, n_cap, 64, 25, device="cpu", mesh=m)
        assert kernel_cache_stats()["misses"] == 0

    @check
    def run_driver_refuses_many_ranks():
        try:
            multihost.run_driver(obj, space(), store_root="unused",
                                 max_evals=4, mesh=mesh_sp)
        except ValueError as e:
            assert "mesh of one rank" in str(e)
        else:
            raise AssertionError("no ValueError")

    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
''')

CHECKS = ["single", "liar_batch", "joint", "sp_within_dp_rows",
          "sharded_shim", "fmin_device_sp", "fmin_device_dp", "fmin_fleet_dp",
          "cohort", "multi_start_dp", "compile_discipline",
          "run_driver_refuses_many_ranks"]
_POOLS: dict = {}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_gloo(world, script, tmp_dir, timeout=240):
    """Run ``script`` in ``world`` gloo ranks (argv: rank, world, port,
    output prefix); returns each rank's JSON output."""
    out = os.path.join(tmp_dir, "rank")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), port, out],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    results = []
    for r in range(world):
        with open(f"{out}.{r}") as f:
            results.append(json.load(f))
    return results


def _pool(world, tmp_path_factory):
    if world not in _POOLS:
        _POOLS[world] = spawn_gloo(
            world, WORKER, str(tmp_path_factory.mktemp(f"gloo{world}")))
    return _POOLS[world]


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("world", [2, 4])
def test_ranks_land_the_local_rows(world, check, tmp_path_factory):
    for r, res in enumerate(_pool(world, tmp_path_factory)):
        assert res[check] == "ok", f"rank {r} of {world}:\n{res[check]}"


# ---------------------------------------------------------------------------
# against JAX (level 2: the same uniforms give the same rows)
# ---------------------------------------------------------------------------


def _pair(n, seed):
    """The same ``n`` finished trials of the flagship space in both
    packages."""
    csj = hj.space.compile_space(flagship(hj))
    h = _history(csj, n, seed)
    dj = hj.base.Domain(lambda d: 0.0, flagship(hj))
    dt = ht.Domain(lambda d: 0.0, flagship(ht))
    dt.cs.device = CPU
    out = []
    for pkg, dom in ((hj, dj), (ht, dt)):
        t = pkg.Trials()
        docs = pkg.base.docs_from_samples(dom.cs, list(range(n)), h["vals"],
                                          h["active"])
        for d, lv in zip(docs, h["loss"]):
            d["state"] = pkg.JOB_STATE_DONE
            d["result"] = {"status": "ok", "loss": float(lv)}
        t.insert_trial_docs(docs)
        t.refresh()
        out += [dom, t]
    return out


def _assert_rows_close(got, want, cs):
    cat = [p.pid for p in cs.params if p.is_int]
    np.testing.assert_array_equal(got[..., cat], want[..., cat])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


def _rows(docs, cs):
    return np.stack([[d["misc"]["vals"][p.label][0]
                      if d["misc"]["vals"][p.label] else 0.0
                      for p in cs.params] for d in docs]).astype(np.float32)


@pytest.mark.parametrize("seed", [3, 2 ** 32 + 17])
def test_sharded_rows_equal_jax_sharded_suggest(mesh, seed):
    dj, tj, dt, tt = _pair(30, 1)
    want = sharded_j.sharded_suggest([30], dj, tj, seed,
                                     mesh=dispatch_j.default_mesh(),
                                     n_EI_candidates=64)
    kj = tpe_j.get_kernel(dj.cs, 32, 64, 25)
    noise = _jax_step_uniforms(prng_key(np.uint32(seed % 2 ** 32)), kj)
    got = tpe.suggest_materialize(dispatch.suggest_dispatch(
        [30], dt, tt, seed, mesh=mesh, strict=True, n_EI_candidates=64,
        noise=noise))
    _assert_rows_close(_rows(got, dt.cs), _rows(want, dj.cs), dt.cs)


def test_multi_start_equals_jax_on_its_keys():
    dj, tj, dt, tt = _pair(30, 2)
    ids, seed = [30, 31, 32, 33], 909
    devs = np.asarray(jax.devices()[:4])
    want = sharded_j.multi_start_suggest(
        ids, dj, tj, seed, mesh=jax.sharding.Mesh(devs, ("dp",)),
        n_EI_candidates=64)
    kj = tpe_j.get_kernel(dj.cs, 32, 64, 25)
    keys = jax.random.split(prng_key(np.uint32(seed)), 4)
    got = multi_start_suggest(ids, dt, tt, seed, n_EI_candidates=64,
                              noise=[_jax_step_uniforms(k, kj)
                                     for k in keys])
    _assert_rows_close(_rows(got, dt.cs), _rows(want, dj.cs), dt.cs)


def test_gamma_spread_is_jax_bitwise():
    for k in range(1, 10):
        for g in (0.05, 0.25, 0.3, 0.6, 1.0):
            np.testing.assert_array_equal(dispatch._gamma_spread(g, k),
                                          dispatch_j._gamma_spread(g, k))


# ---------------------------------------------------------------------------
# compile discipline and pickles
# ---------------------------------------------------------------------------


class TestCompileDiscipline:
    def test_one_kernel_per_tier_and_mesh_layout(self, mesh):
        cs = _domain(labels=("kd_x", "kd_lr", "kd_c", "kd_a")).cs
        tiers = [64, 128]
        kernel_cache_stats(reset=True)
        for n_cap in tiers:
            dispatch.get_kernel(cs, n_cap, 24, 25, device=CPU, mesh=mesh)
        assert kernel_cache_stats()["misses"] == len(tiers)
        # The same layout in a new mesh object: hits, rebound to it.
        again = dispatch.default_mesh(device_type=CPU)
        kernel_cache_stats(reset=True)
        for n_cap in tiers:
            kern = dispatch.get_kernel(cs, n_cap, 24, 25, device=CPU,
                                       mesh=again)
            assert kern.mesh is again
        stats = kernel_cache_stats()
        assert stats["misses"] == 0 and stats["requests"] >= len(tiers)
        assert len(cs._dispatch_kernels) == len(tiers)

    def test_suggest_path_reuses_kernel_across_steps(self, mesh):
        dom, t = _hist_trials()
        dispatch.set_default_mesh(mesh)
        tpe.suggest_batch([90], dom, t, 1)          # warm the tier
        kernel_cache_stats(reset=True)
        for s in range(2, 6):
            tpe.suggest_batch([90 + s], dom, t, s)
        assert kernel_cache_stats()["misses"] == 0

    def test_prewarm_builds_the_sharded_next_bucket(self, mesh):
        dom, t = _hist_trials(n=25)               # 25 >= 0.75 * 32
        dispatch.set_default_mesh(mesh)
        tpe.suggest_batch([25], dom, t, 1)
        tpe.wait_prewarm()
        caps = {k.n_cap for k in dom.cs._dispatch_kernels.values()}
        assert {32, 64} <= caps


@pytest.mark.parametrize("sharded", [False, True], ids=["tpe", "tpe_sharded"])
def test_both_kernel_caches_keep_the_same_books(mesh, sharded):
    """Local and sharded kernels: one build per key, under
    ``(n_cap, n_cand, lf, device) + tpe._lowering(...)`` (plus the mesh),
    timed into ``tpe.kernel_build_ms`` and recorded in the cost ledger
    under its kind; every lookup feeds ``kernel_cache_stats``."""
    from hyperopt_tpu_torch.obs import costs

    dom, _ = _hist_trials()
    for cache in ("_tpe_kernels", "_dispatch_kernels"):
        dom.cs.__dict__.pop(cache, None)
    m = mesh if sharded else None
    lowering = tpe._lowering("sqrt", "sqrt", "vpu", "f32", 0, False, "icdf")
    key = (64, 24, 25, CPU) + lowering
    if sharded:
        key += (("mesh",) + dispatch._mesh_key(mesh),)
    built0 = _counter("tpe.kernel_build_ms")
    was_armed = costs.armed()
    costs.arm()
    try:
        kerns = [dispatch.get_kernel(dom.cs, 64, 24, 25, device=CPU, mesh=m)
                 for _ in range(2)]
        report = costs.ledger_report()
    finally:
        if not was_armed:
            costs.disarm()
    assert kerns[0] is kerns[1] and kerns[0].cost_key == key
    assert isinstance(kerns[0], dispatch.ShardedTpeKernel) == sharded
    assert _counter("tpe.kernel_build_ms") > built0
    rows = [e for e in report["entries"] if e["key"] == repr(key)]
    assert len(rows) == 1 and rows[0]["n_cap"] == 64
    assert rows[0]["kernel"] == ("tpe_sharded" if sharded else "tpe")
    assert rows[0]["requests"] >= 2 and rows[0]["misses"] >= 1


class TestVolatileCache:
    def test_dispatch_kernels_dropped_from_pickles(self, mesh):
        import pickle

        dom, _ = _hist_trials()
        dispatch.get_kernel(dom.cs, 64, 24, 25, device=CPU, mesh=mesh)
        assert dom.cs._dispatch_kernels
        cs2 = pickle.loads(pickle.dumps(dom.cs))
        assert not getattr(cs2, "_dispatch_kernels", None)

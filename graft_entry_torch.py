"""The port's entry points: one TPE step, and one optimization step on a mesh.

Twin of ``__graft_entry__.py`` for the PyTorch port.  It imports only
``torch``, ``numpy``, the standard library and ``hyperopt_tpu_torch``.

* ``entry(device=None)`` -> ``(fn, example_args)``: one full TPE suggest
  step on the 50-dim flagship space (53 parameters) over a 100-trial
  history in the 128 bucket, 1,024 candidates: γ-split, batched Parzen
  fits, candidate draws, EI scoring (on the card, the CUDA kernel K1 of
  ``ops/ei_scores.py``) and the winner.  ``fn(noise, vals, active, loss,
  ok)`` returns ``(row f32[53], act bool[53])``.  The step's uniforms are
  an argument (``noise``, drawn from a seeded CPU generator), so the same
  ``fn(*example_args)`` runs eagerly and can be captured in a
  ``torch.cuda.CUDAGraph`` and replayed, and the CPU and the card step
  from the same uniforms.
* ``dryrun_multichip(n, device=None)``: one full optimization step over a
  ``(dp, sp)`` mesh of ``n`` ranks, in the order of the JAX twin: seeded
  history, a sharded constant-liar batch, multi-start over ``dp``,
  ``fmin_device(mesh=)`` (one run, then ``n_runs`` restarts), host
  evaluation, the steady scaling readout, and the global-mesh segment.
  Every sharded proposal is held against the local kernel's on the same
  history.  On the CPU (``device="cpu"``) the ranks are ``n`` gloo
  processes; on CUDA, ``n`` NCCL ranks, one per card (``n`` may not
  exceed the visible cards).  ``n = 1`` runs in this process.

Both run on CUDA unless given ``device="cpu"``, and raise where there is
no card (``space.resolve_device``).  From the command line::

    python3 graft_entry_torch.py --entry [--device cpu]   # one step
    python3 graft_entry_torch.py N [--device cpu]         # dryrun_multichip(N)
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GAMMA = 0.25
PRIOR_WEIGHT = 1.0
#: Eager calls on a side stream before a capture.
_CAPTURE_WARMUP = 2
#: Seconds the rank processes of :func:`dryrun_multichip` may take.
_RANK_TIMEOUT_S = 600


def _flagship_space(n_dims=50):
    """The 50-dim mixed space: uniform, loguniform, quantized, normal and
    choice columns and a conditional branch (53 parameters)."""
    from hyperopt_tpu_torch import hp

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


def _history(cs, n_trials, seed=0):
    """A synthetic finished-trial history (numpy): prior draws from a
    seeded CPU generator, loss = sum of squares of the first four columns
    plus noise."""
    vals, active = cs.sample(n_trials,
                             generator=torch.Generator().manual_seed(seed),
                             device="cpu")
    vals, active = vals.numpy(), active.numpy()
    rng = np.random.default_rng(seed)
    loss = (np.square(vals[:, :4]).sum(axis=1)
            + rng.normal(0, 0.1, n_trials)).astype(np.float32)
    return dict(vals=vals, active=active, loss=loss,
                ok=np.ones(n_trials, bool),
                tids=np.arange(n_trials, dtype=np.int64))


def _seed_completed_trials(trials, domain, n, seed=0):
    """Insert ``n`` synthetic DONE trials (one batched draw, the loss of
    :func:`_history`) in place of a warm-start ``fmin`` loop."""
    from hyperopt_tpu_torch import base

    h = _history(domain.cs, n, seed=seed)
    ids = trials.new_trial_ids(n)
    docs = base.docs_from_samples(domain.cs, ids, h["vals"], h["active"],
                                  exp_key=getattr(trials, "exp_key", None))
    now = base.coarse_utcnow()
    for doc, loss in zip(docs, h["loss"]):
        doc["state"] = base.JOB_STATE_DONE
        doc["result"] = {"loss": float(loss), "status": base.STATUS_OK}
        doc["book_time"] = now
        doc["refresh_time"] = now
    trials.insert_trial_docs(docs)
    trials.refresh()


def _step_noise(kern, seed):
    """One step's uniforms (:meth:`~tpe._TpeKernel.draw_noise`) from a
    seeded CPU generator, on ``kern``'s device: the same values whichever
    device the kernel runs on."""
    from hyperopt_tpu_torch import tpe

    cpu = tpe.get_kernel(kern.cs, kern.n_cap, kern.n_cand, kern.lf,
                         device="cpu")
    noise = cpu.draw_noise(torch.Generator().manual_seed(seed))
    dev = kern.device
    return {"cont": [(uc.to(dev), u.to(dev)) for uc, u in noise["cont"]],
            "cat": noise["cat"].to(dev)}


def entry(device=None):
    """Return ``(fn, example_args)``: one TPE suggest step (module doc).
    ``fn(*example_args)`` is ``(row f32[53], act bool[53])``."""
    from hyperopt_tpu_torch import tpe
    from hyperopt_tpu_torch.history import _padded_history
    from hyperopt_tpu_torch.space import compile_space, resolve_device

    dev = resolve_device(device)
    cs = compile_space(_flagship_space())
    n_cap, n_cand = 128, 1024
    kern = tpe.get_kernel(cs, n_cap=n_cap, n_cand=n_cand, lf=25, device=dev)
    hist = tuple(torch.as_tensor(a, device=dev)
                 for a in _padded_history(_history(cs, 100), n_cap))

    def fn(noise, vals, active, loss, ok):
        row, act, _, _ = kern._suggest_one_tel(vals, active, loss, ok, GAMMA,
                                               PRIOR_WEIGHT, noise=noise)
        return row, act

    return fn, (_step_noise(kern, 0),) + hist


def capture(fn, args):
    """``fn(*args)`` captured in a ``torch.cuda.CUDAGraph`` after
    ``_CAPTURE_WARMUP`` eager calls on a side stream (PyTorch's rule for a
    capture).  Returns ``(graph, outputs)``: each ``graph.replay()``
    rewrites ``outputs`` in place."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(_CAPTURE_WARMUP):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    return graph, out


# ---------------------------------------------------------------------------
# dryrun_multichip
# ---------------------------------------------------------------------------


def _objective(cfg):
    loss = cfg["u0"] ** 2 + abs(cfg["n0"]) + cfg["c0"] * 0.1
    if cfg["branch"]["kind"] == "a":
        loss += cfg["branch"]["lr"]
    return float(loss)


def _device_objective(p):
    return p["u0"] ** 2 + torch.abs(p["n0"]) + p["c0"] * 0.1


def _global_history():
    """The global-mesh segment's space and padded history: 24 finished
    trials of one uniform column in the 32 bucket."""
    from hyperopt_tpu_torch import hp
    from hyperopt_tpu_torch.space import compile_space

    cs = compile_space({"x": hp.uniform("x", -2.0, 2.0)})
    rng = np.random.default_rng(0)
    n, cap = 24, 32
    vals = np.zeros((cap, 1), np.float32)
    vals[:n] = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
    act = np.zeros((cap, 1), bool)
    act[:n] = True
    loss = np.full(cap, np.inf, np.float32)
    loss[:n] = (vals[:n, 0] - 1.0) ** 2
    ok = np.zeros(cap, bool)
    ok[:n] = True
    return cs, (vals, act, loss, ok)


def global_proposal(n_ranks, device, mesh=None):
    """The global-mesh segment's proposal for ``x``: from the sharded
    kernel over ``mesh["sp"]`` (every rank calls), or from the local
    kernel with ``mesh=None``; 8 candidates per rank, seed 7."""
    from hyperopt_tpu_torch import tpe
    from hyperopt_tpu_torch.parallel.sharded import _get_sharded_kernel
    from hyperopt_tpu_torch.space import make_generator

    cs, hist = _global_history()
    dev = torch.device(device)
    if mesh is None:
        kern = tpe.get_kernel(cs, 32, n_ranks * 8, 25, device=dev)
    else:
        kern = _get_sharded_kernel(cs, 32, n_ranks * 8, 25, mesh, "sqrt",
                                   device=dev)
    row, _ = kern(*(torch.as_tensor(a, device=dev) for a in hist), GAMMA,
                  PRIOR_WEIGHT, generator=make_generator(dev, 7))
    return float(row[0])


def _rows(docs, cs):
    return [[d["misc"]["vals"][p.label][0] if d["misc"]["vals"][p.label]
             else None for p in cs.params] for d in docs]


def _same(what, got, want):
    if got != want:
        raise RuntimeError(f"dryrun_multichip: the {what} differs from the "
                           f"local kernel's:\n{got}\n{want}")


def run_rank(n_ranks, rank=0, init_method=None, device=None):
    """One rank of :func:`dryrun_multichip`: every step, in order, on the
    world this call brings up (or the one that is up), which it tears down
    at the end if it brought it up."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from hyperopt_tpu_torch import Trials, dispatch, fmin_device, rand, tpe
    from hyperopt_tpu_torch.base import Domain
    from hyperopt_tpu_torch.fmin import FMinIter
    from hyperopt_tpu_torch.obs import kernel_cache_stats
    from hyperopt_tpu_torch.ops import ei_scores
    from hyperopt_tpu_torch.parallel import (multi_start_suggest, multihost,
                                             sharded_suggest)
    from hyperopt_tpu_torch.space import resolve_device

    dev = resolve_device(device)
    owned = not dist.is_initialized()
    multihost.initialize(init_method, world_size=n_ranks, rank=rank,
                         device=dev)
    # Only an explicit mesh= shards here; the plain calls are the local
    # kernel's, which the sharded proposals are held against.
    dispatch.clear_default_mesh()
    try:
        dt = dev.type
        if dt == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        name = f"dryrun_multichip({n_ranks})"
        print(f"{name}: rank {rank} of {dist.get_world_size()}, "
              f"{dist.get_backend()} on {dev}", flush=True)
        n_starts = 2 if n_ranks % 2 == 0 and n_ranks >= 2 else 1
        mesh = dispatch.default_mesh(n_starts=n_starts, device_type=dt)
        shape = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
        domain = Domain(_objective, _flagship_space(n_dims=5))
        domain.cs.device = dev
        cs = domain.cs
        trials = Trials()
        _seed_completed_trials(trials, domain, 24, seed=0)
        print(f"{name}: warm-start seeded, running sharded suggest",
              flush=True)

        # The constant-liar batch (2 ids) through the sharded kernel.
        n_cand = 64 * shape["sp"]
        ids = trials.new_trial_ids(2)
        kw = dict(n_EI_candidates=n_cand, n_startup_jobs=8)
        docs = sharded_suggest(ids, domain, trials, 1, mesh=mesh, **kw)
        _same("sharded liar batch", _rows(docs, cs),
              _rows(tpe.suggest(ids, domain, trials, 1, **kw), cs))
        trials.insert_trial_docs(docs)
        trials.refresh()
        print(f"{name}: sharded batched suggest done ({n_cand} candidates "
              f"over sp={shape['sp']}, the local kernel's rows), running "
              f"multi-start", flush=True)

        # Multi-start: one posterior per rank along a 1-D dp mesh.
        ms_mesh = init_device_mesh(dt, (n_ranks,),
                                   mesh_dim_names=(dispatch.START_AXIS,))
        ids = trials.new_trial_ids(n_ranks)
        docs = multi_start_suggest(ids, domain, trials, 2, mesh=ms_mesh,
                                   n_startup_jobs=8)
        _same("multi-start batch", _rows(docs, cs),
              _rows(multi_start_suggest(ids, domain, trials, 2,
                                        n_startup_jobs=8), cs))
        trials.insert_trial_docs(docs)
        trials.refresh()
        print(f"{name}: multi-start over dp={n_ranks} done ({n_ranks} "
              f"starts, the local lanes' rows)", flush=True)

        # The whole TPE loop on the device, candidates over sp.
        dkw = dict(n_startup_jobs=8, device=dev)
        _, dinfo = fmin_device(_device_objective, cs, max_evals=24, seed=3,
                               n_EI_candidates=n_cand, mesh=mesh, **dkw)
        _, local = fmin_device(_device_objective, cs, max_evals=24, seed=3,
                               n_EI_candidates=n_cand, **dkw)
        if dinfo["losses"].shape != (24,) \
                or not np.isfinite(dinfo["losses"]).all():
            raise RuntimeError(f"{name}: fmin_device(mesh=) losses "
                               f"{dinfo['losses']}")
        _same("fmin_device(mesh=) run", dinfo["vals"].tolist(),
              local["vals"].tolist())
        print(f"{name}: sharded device-resident fmin done "
              f"(best={dinfo['best_loss']:.4f}, the local run's trials)",
              flush=True)

        # n_starts restarts, the runs over dp.
        if n_starts > 1:
            _, minfo = fmin_device(_device_objective, cs, max_evals=16,
                                   seed=4, n_EI_candidates=64, mesh=mesh,
                                   n_runs=n_starts, **dkw)
            _, local = fmin_device(_device_objective, cs, max_evals=16,
                                   seed=4, n_EI_candidates=64,
                                   n_runs=n_starts, **dkw)
            if minfo["losses"].shape != (n_starts, 16) \
                    or not np.isfinite(minfo["losses"]).all():
                raise RuntimeError(f"{name}: n_runs losses "
                                   f"{minfo['losses']}")
            _same("fmin_device(n_runs=, mesh=) runs",
                  minfo["vals"].tolist(), local["vals"].tolist())
            print(f"{name}: {n_starts}-restart device fmin done "
                  f"(best={minfo['best_loss']:.4f}, the local runs' trials)",
                  flush=True)

        # Evaluate the proposals on the host and fold them back in.
        it = FMinIter(rand.suggest, domain, trials, max_evals=len(trials))
        it.serial_evaluate()
        if trials.count_by_state_unsynced(2) != len(trials):
            raise RuntimeError(f"{name}: trials left unevaluated")
        print(f"{name}: mesh={shape}, {len(trials)} trials evaluated, "
              f"best={trials.best_trial['result']['loss']:.4f}", flush=True)

        # Steady scaling readout: the same sharded suggest with the
        # candidates over sp = n against sp = 1.  Steady state builds no
        # kernel: no new _TpeKernel, no kernel-cache miss, no library.
        if n_ranks >= 2:
            def built():
                return (len(cs.__dict__.get("_tpe_kernels", {})),
                        len(cs.__dict__.get("_dispatch_kernels", {})),
                        len(ei_scores._libs))

            def steady_ms(m, reps=3):
                sharded_suggest([10_000], domain, trials, 5, mesh=m, **kw)
                tpe.wait_prewarm()
                before = built()
                kernel_cache_stats(reset=True)
                t0 = time.perf_counter()
                for r in range(reps):
                    sharded_suggest([10_000], domain, trials, 6 + r, mesh=m,
                                    **kw)
                dt_ms = (time.perf_counter() - t0) * 1e3 / reps
                misses = kernel_cache_stats()["misses"]
                if misses or built() != before:
                    raise RuntimeError(
                        f"{name}: steady state built kernels: {misses} "
                        f"cache misses, {before} -> {built()}")
                return dt_ms

            tn = steady_ms(dispatch.default_mesh(n_starts=1, device_type=dt))
            t1 = steady_ms(dispatch.default_mesh(n_starts=n_ranks,
                                                 device_type=dt))
            eff = t1 / (n_ranks * tn)
            print(f"{name}: scaling sp={n_ranks} {tn:.1f}ms vs sp=1 "
                  f"{t1:.1f}ms per suggest at {n_cand} candidates -> "
                  f"efficiency={eff:.2f}, kernels_built_steady=0",
                  flush=True)

        # The global mesh: every rank's rank all-gathered, then one sharded
        # suggest over every rank, equal to the local kernel's.
        world = dispatch.default_mesh(n_starts=1, device_type=dt)
        got = dispatch._all_gather(
            torch.tensor([rank], dtype=torch.int64,
                         device=dispatch.mesh_device(world)),
            world.get_group(dispatch.CAND_AXIS), n_ranks)
        if got.reshape(-1).tolist() != list(range(n_ranks)):
            raise RuntimeError(f"{name}: all-gather of ranks gave "
                               f"{got.reshape(-1).tolist()}")
        prop = global_proposal(n_ranks, dev, world)
        props = dispatch._all_gather(
            torch.tensor([prop], dtype=torch.float64,
                         device=dispatch.mesh_device(world)),
            world.get_group(dispatch.CAND_AXIS), n_ranks).reshape(-1)
        local = global_proposal(n_ranks, dev)
        if props.tolist() != [local] * n_ranks:
            raise RuntimeError(f"{name}: global-mesh proposals "
                               f"{props.tolist()}, local {local!r}")
        print(f"{name}: global mesh OK — {n_ranks} ranks over "
              f"{dist.get_backend()}, all-gather {list(range(n_ranks))}, "
              f"identical proposal {prop!r} on every rank, the local "
              f"kernel's", flush=True)
    finally:
        dispatch.clear_default_mesh()
        if owned:
            dist.destroy_process_group()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_RANK_SCRIPT = (
    "import sys\n"
    "sys.path.insert(0, {root!r})\n"
    "import torch\n"
    "torch.set_num_threads(1)\n"
    "import graft_entry_torch as g\n"
    "g.run_rank({n}, {rank}, {init!r}, {device!r})\n")


def _spawn_ranks(n, device):
    """Run :func:`run_rank` in ``n`` processes; returns each rank's output.
    A rank that fails ends them all and raises with its output."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as tmp:
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(n)]
        procs = []
        try:
            for r in range(n):
                with open(logs[r], "w") as out:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c", _RANK_SCRIPT.format(
                            root=ROOT, n=n, rank=r, init=init,
                            device=device)],
                        cwd=ROOT, env=env, stdout=out,
                        stderr=subprocess.STDOUT))
            deadline = time.monotonic() + _RANK_TIMEOUT_S
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for path in logs:
            with open(path) as f:
                texts.append(f.read())
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun_multichip({n}): rank {r} exited "
                               f"{p.returncode}:\n{text[-4000:]}")
    return texts


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One full sharded optimization step on a mesh of ``n_devices``
    ranks (module doc).  Rank 0's lines are printed here; every rank must
    end with the same global-mesh line, else this raises."""
    from hyperopt_tpu_torch.space import resolve_device

    n = int(n_devices)
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"dryrun_multichip needs at least one rank, got {n}")
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(
            f"dryrun_multichip({n}) on CUDA needs {n} cards, one NCCL rank "
            f"each; {torch.cuda.device_count()} visible")
    if n == 1:
        run_rank(1, 0, None, str(dev))
        return
    texts = _spawn_ranks(n, dev.type)
    print(texts[0], end="", flush=True)
    lines = [[ln for ln in t.splitlines() if "global mesh OK" in ln]
             for t in texts]
    if any(len(ln) != 1 for ln in lines) or len({ln[0] for ln in lines}) != 1:
        raise RuntimeError(f"dryrun_multichip({n}): the ranks' global-mesh "
                           f"lines differ: {lines}")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1,
                    help="ranks of dryrun_multichip (default 1)")
    ap.add_argument("--entry", action="store_true",
                    help="run entry()'s step once and print its shapes")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    if args.entry:
        fn, ex = entry(args.device)
        out = fn(*ex)
        print("entry(): suggest step ->", [tuple(o.shape) for o in out])
    else:
        dryrun_multichip(args.n, device=args.device)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it does.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build       compile the CUDA EI kernel from ``hyperopt_tpu_torch/csrc``.
2. ei_kernel   hold the kernel against its plain PyTorch version on the
               card at the TPE step's shape (31 columns x 10,000 candidates
               x (26 + 1025) components) and at edge shapes; time both.
3. suggest_step  one TPE step at full width (50-dim space, 1,000-trial
               history, 10,000 candidates), a few times, then three more
               under ``torch.profiler`` (device-busy share, launches and
               device time by kernel); the same step on the card and on
               the CPU at a small size, with the same uniforms, must
               propose the same row.
4. fmin        a hosted ``fmin`` run on the card from 1,000 finished trials,
               20 more evaluations of a host objective.  The kernel's launch
               count is zeroed just before and read just after: it must
               equal the number of TPE steps.

Prints the card's name and power limit first, one ``{"kernels": [...]}``
JSON line before the last, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result, when
there is no CUDA device or the package is missing.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import hyperopt_tpu_torch as ho  # noqa: E402
from hyperopt_tpu_torch import base, hp, tpe  # noqa: E402
from hyperopt_tpu_torch.ops import ei_scores as ei_mod  # noqa: E402
from hyperopt_tpu_torch.space import (  # noqa: E402
    CATEGORICAL, LOGNORMAL, LOGUNIFORM, NORMAL, QLOGNORMAL, QNORMAL,
    QLOGUNIFORM, RANDINT, compile_space, make_generator)

TOL = 2e-4             # kernel vs plain version, abs and rel (as the TPU test)
MARGIN = 1e-3          # argmax must agree where the winner leads by more
N_HISTORY = 1000
N_CAND = 10_000
N_MORE = 20
# H100 SXM peaks: 132 SMs x 16 special-function results per clock (exp)
# at the 1.98 GHz boost clock; 67 TFLOP/s float32 outside the tensor
# cores; 3.35 TB/s HBM3.
EXP_PER_S = 132 * 16 * 1.98e9
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# Float32 operations per (candidate, component) term besides its exp:
# z - mu, * 1/sigma, fma for cb - t*t (2), - max, + sum.
FLOP_PER_TERM = 6


def fail(msg):
    raise RuntimeError(msg)


def flagship_space(n_dims=50):
    """The 50-dim mixed space of the TPU package's north-star benchmark:
    uniform/loguniform/quantized/normal/choice columns and a conditional
    branch (53 parameters at n_dims=50)."""
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


def synthetic_trials(cs, n, seed, device):
    """A Trials holding ``n`` finished trials: prior draws on ``device``,
    loss = sum of squares of the first four columns plus noise."""
    vals, _ = cs.sample(n, generator=make_generator(device, seed),
                        device=device)
    vals = vals.cpu().numpy()
    active = cs.active_mask_host(vals)
    rng = np.random.default_rng(seed)
    loss = (np.square(vals[:, :4]).sum(axis=1)
            + rng.normal(0, 0.1, n)).astype(np.float32)
    trials = ho.Trials()
    docs = base.docs_from_samples(cs, trials.new_trial_ids(n), vals, active)
    now = base.coarse_utcnow()
    for doc, lv in zip(docs, loss):
        doc["state"] = base.JOB_STATE_DONE
        doc["result"] = {"loss": float(lv), "status": base.STATUS_OK}
        doc["book_time"] = doc["refresh_time"] = now
    trials.insert_trial_docs(docs)
    trials.refresh()
    return trials


def objective(cfg):
    return float(sum(v * v for k, v in cfg.items()
                     if k.startswith("u") and isinstance(v, float)))


def in_bounds(cs, row):
    """Names of parameters whose proposed value lies outside its prior's
    support (empty when the row is valid)."""
    bad = []
    for p in cs.params:
        v = float(row[p.pid])
        if not math.isfinite(v):
            bad.append(p.label)
        elif p.kind in (CATEGORICAL, RANDINT):
            lo = p.low if p.kind == RANDINT else 0
            if v != round(v) or not lo <= v < lo + p.n_options:
                bad.append(p.label)
        elif p.kind in (NORMAL, QNORMAL, LOGNORMAL, QLOGNORMAL):
            if p.kind in (LOGNORMAL, QLOGNORMAL) and v < 0:
                bad.append(p.label)
        else:
            lo, hi = p.low, p.high
            if p.kind in (LOGUNIFORM, QLOGUNIFORM):
                lo, hi = math.exp(lo), math.exp(hi)
            if p.q:
                lo = round(lo / p.q) * p.q
                hi = round(hi / p.q) * p.q
            if not lo * (1 - 1e-6) - 1e-6 <= v <= hi * (1 + 1e-6) + 1e-6:
                bad.append(p.label)
    return bad


def cuda_ms(fn, reps=25, warmup=3):
    """Median milliseconds of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def random_mixture(rng, c, k, k_live, device):
    logw = np.full((c, k), -np.inf, np.float32)
    for i in range(c):
        w = rng.random(k_live) + 0.1
        logw[i, :k_live] = np.log(w / w.sum())
    mu = np.where(np.isfinite(logw), rng.normal(0, 3, (c, k)), 0.0)
    sg = np.where(np.isfinite(logw), rng.uniform(0.3, 3, (c, k)), 1.0)
    return [torch.as_tensor(a.astype(np.float32), device=device)
            for a in (logw, mu, sg)]


def compare(got, ref, what):
    """Elementwise |got - ref| <= TOL + TOL*|ref|; argmax equal on every
    column whose winner leads by more than MARGIN.  Returns
    ``(max_abs_err, tol_used, near_tie_columns)``, ``tol_used`` being the
    largest |got - ref| / (TOL + TOL*|ref|) (at most 1)."""
    got, ref = got.double().cpu(), ref.double().cpu()
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        fail(f"{what}: non-finite scores")
    d = (got - ref).abs()
    if not bool((d <= TOL + TOL * ref.abs()).all()):
        fail(f"{what}: kernel and plain version differ by {d.max():.3g}")
    used = (d / (TOL + TOL * ref.abs())).max().item()
    top2 = torch.topk(ref, 2, dim=1).values if ref.shape[1] > 1 else None
    near = 0
    if top2 is not None:
        clear = (top2[:, 0] - top2[:, 1]) > MARGIN
        near = int((~clear).sum())
        if bool((got.argmax(1) != ref.argmax(1))[clear].any()):
            fail(f"{what}: argmax differs on a column with a clear winner")
    return d.max().item(), used, near


def ei_bound_ms(z, logw_b, logw_a):
    """Least time the card needs for one EI launch on these inputs: exps
    of the live (finite-weight) terms on the special-function units, the
    float32 arithmetic around them, or the bytes moved, whichever is
    largest.  Returns ``(ms, "operations" | "bytes")``."""
    c, n = z.shape
    live = int(torch.isfinite(logw_b).sum() + torch.isfinite(logw_a).sum())
    terms = n * live
    op_ms = max(terms / EXP_PER_S, terms * FLOP_PER_TERM / F32_FLOP_PER_S)
    nbytes = 4 * (2 * c * n + 3 * (logw_b.numel() + logw_a.numel()))
    byte_ms = nbytes / HBM_BYTES_PER_S
    if op_ms >= byte_ms:
        return op_ms * 1e3, "operations"
    return byte_ms * 1e3, "bytes"


def phase_build():
    path, seconds = ei_mod.build()
    print(f"build: {path.name} compiled in {seconds:.2f} s")
    for line in ei_mod.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}")


def phase_ei_kernel(dev):
    rng = np.random.default_rng(0)
    out = {}
    launches0 = ei_mod.ei_scores.launches
    shapes = [("slice", 31, N_CAND, 26, 1025), ("edge", 3, 1000, 26, 1500),
              ("tiny", 1, 64, 2, 130)]
    for name, c, n, kb, ka in shapes:
        below = random_mixture(rng, c, kb, kb - 1, dev)
        above = random_mixture(rng, c, ka, ka - 3, dev)
        z = torch.as_tensor(rng.normal(0, 3, (c, n)).astype(np.float32),
                            device=dev)
        got = ei_mod.ei_scores(z, *below, *above)
        torch.cuda.synchronize()
        ref = ei_mod.ei_scores_reference(z, *below, *above)
        err, used, near = compare(got, ref, f"ei_kernel {name}")
        print(f"ei_kernel {name}: C={c} n={n} K_b={kb} K_a={ka} "
              f"max_abs_err={err:.3g} tol_used={used:.3g} "
              f"near_tie_columns={near}")
        if name == "slice":
            kernel_ms = cuda_ms(lambda: ei_mod.ei_scores(z, *below, *above))
            reference_ms = cuda_ms(
                lambda: ei_mod.ei_scores_reference(z, *below, *above))
            bound_ms, bound_by = ei_bound_ms(z, below[0], above[0])
            print(f"ei_kernel slice: kernel_ms={kernel_ms:.4f} "
                  f"reference_ms={reference_ms:.4f} bound_ms={bound_ms:.4f} "
                  f"({bound_by})")
            out = dict(max_abs_err=err, ms=kernel_ms, plain_ms=reference_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
    # Far-tail candidates against narrow and wide components: finite, and
    # identical below/above mixtures score 0.
    logw = torch.log(torch.tensor([[0.5, 0.5], [0.9, 0.1]], device=dev))
    mu = torch.tensor([[-50.0, 50.0], [0.0, 1e4]], device=dev)
    sg = torch.tensor([[1e-3, 1e3], [0.5, 10.0]], device=dev)
    z = torch.as_tensor(rng.uniform(-1e4, 1e4, (2, 256)).astype(np.float32),
                        device=dev)
    got = ei_mod.ei_scores(z, logw, mu, sg, logw, mu, sg)
    if not bool(torch.isfinite(got).all()) or got.abs().max().item() > 1e-3:
        fail("ei_kernel extreme: scores of equal mixtures are not ~0")
    print(f"ei_kernel extreme: max |ei| = {got.abs().max().item():.3g}")
    print(f"ei_kernel: {ei_mod.ei_scores.launches - launches0} kernel "
          f"launches in this phase (checks, warm-up and timing)")
    return out


def phase_suggest_step(dev):
    space = flagship_space()
    domain = base.Domain(objective, space)
    domain.cs.device = dev
    trials = synthetic_trials(domain.cs, N_HISTORY, 0, dev)
    algo = partial(tpe.suggest_batch, n_EI_candidates=N_CAND)
    tid = trials.new_trial_ids(1)
    times = []
    for step in range(6):
        before = ei_mod.ei_scores.launches
        t0 = time.perf_counter()
        vals, _ = algo(tid, domain, trials, seed=step)
        times.append((time.perf_counter() - t0) * 1e3)
        if ei_mod.ei_scores.launches - before != 1:
            fail("suggest_step: the step did not launch the kernel once")
        bad = in_bounds(domain.cs, vals[0])
        if bad:
            fail(f"suggest_step: proposal outside the space: {bad}")
    print(f"suggest_step: P={domain.cs.n_params} history={N_HISTORY} "
          f"n_cand={N_CAND} first_ms={times[0]:.2f} "
          f"steady_ms_median={np.median(times[1:]):.2f}")
    profile_steps(lambda s: algo(tid, domain, trials, seed=100 + s))

    # The same small step on the card and on the CPU, same uniforms.
    cs = compile_space(flagship_space(10))
    h = synthetic_trials(cs, 50, 1, "cpu").history(cs)
    hist = tpe._padded_history(h, 64)
    rows = []
    noise = None
    for d in (torch.device("cpu"), dev):
        kern = tpe.get_kernel(cs, 64, 128, 25, device=d)
        if noise is None:
            noise = kern.draw_noise(torch.Generator().manual_seed(0))
        nz = {"cont": [(a.to(d), b.to(d)) for a, b in noise["cont"]],
              "cat": noise["cat"].to(d)}
        row, _ = kern(*[torch.as_tensor(a, device=d) for a in hist],
                      0.25, 1.0, noise=nz)
        rows.append(row.cpu())
    if not torch.allclose(rows[0], rows[1], rtol=1e-5, atol=1e-5):
        fail(f"suggest_step: card and CPU propose different rows:\n"
             f"{rows[1]}\n{rows[0]}")
    print("suggest_step: card and CPU rows agree on the small step")


def profile_steps(step, n=3):
    """Where a step's time goes: ``torch.profiler`` over ``n`` steps;
    prints the device-busy share of the wall time, CUDA kernel launches
    per step, and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for s in range(n):
            step(s)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = [(getattr(e, "self_device_time_total", None)
               or getattr(e, "self_cuda_time_total", 0)) / 1e3 for e in kernels]
    busy = sum(dev_ms)
    launches = sum(e.count for e in kernels)
    print(f"suggest_step profile: wall_ms_per_step={wall_ms / n:.3f} "
          f"device_busy_ms_per_step={busy / n:.3f} "
          f"device_busy_share={busy / wall_ms:.3f} "
          f"cuda_kernels_per_step={launches / n:.1f}")
    for ms, e in sorted(zip(dev_ms, kernels), key=lambda p: -p[0])[:8]:
        print(f"suggest_step profile: {ms / n:8.4f} ms/step "
              f"{e.count / n:6.1f} launches/step  {e.key[:90]}")


def phase_fmin(dev):
    space = flagship_space()
    cs = compile_space(space)
    trials = synthetic_trials(cs, N_HISTORY, 1, dev)
    ei_mod.ei_scores.launches = 0
    t0 = time.perf_counter()
    ho.fmin(objective, space,
            algo=partial(tpe.suggest, n_EI_candidates=N_CAND),
            max_evals=N_HISTORY + N_MORE, trials=trials,
            rstate=np.random.default_rng(0), device=dev,
            show_progressbar=False)
    wall = time.perf_counter() - t0
    launches = ei_mod.ei_scores.launches
    if len(trials) != N_HISTORY + N_MORE:
        fail(f"fmin: {len(trials)} trials, wanted {N_HISTORY + N_MORE}")
    for t in trials:
        if t["state"] != base.JOB_STATE_DONE or \
                not math.isfinite(t["result"]["loss"]):
            fail(f"fmin: trial {t['tid']} is not DONE with a finite loss")
    if launches != N_MORE:
        fail(f"fmin: {launches} kernel launches for {N_MORE} TPE steps")
    print(f"fmin: {N_MORE} trials in {wall:.3f} s = {N_MORE / wall:.2f} "
          f"trials/s, best loss {trials.best_trial['result']['loss']:.4g}, "
          f"ei_scores launches {launches}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    kernel = phase_ei_kernel(dev)
    phase_suggest_step(dev)
    launches = phase_fmin(dev)
    print(f"total seconds {time.perf_counter() - t0:.1f}")
    print("kernels: ei_scores")
    print(json.dumps({"kernels": [{
        "name": "ei_scores", "route": "cuda",
        "source": "hyperopt_tpu_torch/csrc/ei_scores.cu",
        "replaces": "hyperopt_tpu/ops/pallas_gmm.py:38",
        "launches": launches, "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

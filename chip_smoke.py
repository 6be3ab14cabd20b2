#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it does.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build       compile the CUDA EI kernels from ``hyperopt_tpu_torch/csrc``
               (one ``nvcc`` per source, started together): K1 (f32) and
               K2 (bf16) in ``ei_scores.cu``, K3 (tensor cores) in
               ``ei_scores_mxu.cu``.
2. ei_kernel   hold each kernel against its plain PyTorch version on the
               card at the TPE step's shape (31 columns x 10,000 candidates
               x (26 + 1025) components), at the 2,048 bucket's shape
               (26 + 2049, a live prefix of 1,030 above) and at edge
               shapes, with extreme values, a dead tail and dead
               components scattered through the staged chunks; time the
               kernels at both step shapes and the plain version at the
               first.
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
5. liar_batch  three hosted ``fmin`` runs at full width from 1,000
               finished trials, 32 more trials each at ``max_queue_len=8``
               (constant-liar batches of 8), one per EI lowering: the
               picked kernel must launch exactly 32 times and the others
               never, and the resident history ring must upload only the
               new rows after the first batch.  Then a small liar batch on
               the card and on the CPU, with the same uniforms, for each
               lowering: the rows must agree.
6. device_mode ``fmin(mode="device")`` at full width with a torch twin of
               the objective (each product rounded to float32 before it is
               added, on both sides): (a) 16 trials after the 1,000-trial
               history at ``sync_stride=1`` land exactly the hosted run's
               trials; (b) fresh 256-trial runs at strides 1, 8 and None
               land identical trials with 256, 32 and 1 fetches and one
               capture each; (c) per EI lowering, a replayed 64-trial run
               under ``torch.profiler`` runs the picked kernel once per
               replay and the others never; (d) fresh 1,000-trial runs at
               strides None, 8 and 1, and a 32-trial run: trials/s, and the device-busy share
               and kernels per trial of a profiled replayed segment, beside
               the hosted step's; (e) ``fmin_device`` lands (b)'s trials,
               its ``patience`` stops the replays, and an objective that
               calls ``.item()`` raises ``CaptureError``.  Each run's
               counts are set to 0 just before it; each capture launches
               the picked EI kernel once per warm-up step and records it
               into its graph once, and the profiler counts one run per
               replay in (c) and (d).
7. fleet       the fleet at the same width: (a) per EI lowering,
               ``fmin_fleet`` over 4 lanes (64 trials, stride 16) lands in
               each lane the trials of the solo ``fmin(mode="device")`` run
               under that lane's seed, bit for bit, and
               ``fmin_device(n_runs=4)`` run j equals ``fmin_device(seed=
               s + j)``; (b) ``fmin_fleet`` at 1, 8 and 64 lanes, 1,000
               trials from empty at stride None, twice each: trials/s
               summed over lanes, card and host ms per replay of a
               replayed segment, pool bytes, and lanes that agree across
               fleet sizes; (c) per lowering and lane count, a profiled
               replayed segment: busy share, kernels per replay, the
               picked EI kernel once per replay and the others never; and
               the kernels through their wrapper at 31·L x 10,000 (L = 8,
               64) against their bound; (d) per lowering, a
               ``CohortScheduler`` serves 8 experiments in one dispatch
               with one launch of the picked kernel, each row equal to the
               experiment's solo ``tpe.suggest``.
8. card_tests  ``python -m pytest tests_torch_cuda`` in a subprocess: exit 0
               and every collected test passed.

Prints the card's name and power limit first, one ``{"kernels": [...]}``
JSON line before the last, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result, when
there is no CUDA device or the package is missing.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time
from functools import partial
from xml.etree import ElementTree

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import hyperopt_tpu_torch as ho  # noqa: E402
from hyperopt_tpu_torch import (  # noqa: E402
    base, device, fleet, history, hp, tpe)
from hyperopt_tpu_torch.ops import ei_scores as ei_mod  # noqa: E402
from hyperopt_tpu_torch.space import (  # noqa: E402
    CATEGORICAL, LOGNORMAL, LOGUNIFORM, NORMAL, QLOGNORMAL, QNORMAL,
    QLOGUNIFORM, RANDINT, compile_space, make_generator)

# Kernel vs plain version, abs and rel, per lowering: the TPU package's
# tolerance for its kernel (tests/test_pallas.py), and for the tensor-core
# form its tolerance of mxu against vpu.
TOL = {"f32": 2e-4, "bf16": 2e-4, "mxu": 2e-3}
MARGIN = 1e-3          # argmax must agree where the winner leads by more
N_HISTORY = 1000
N_CAND = 10_000
N_MORE = 20
N_LIAR = 32            # trials per liar_batch run
QUEUE = 8              # max_queue_len of the liar_batch runs
# Per lowering: the kernel's name, source, the TPU kernel it replaces,
# ei_scores' keywords and the TPE keywords that pick it.
KERNELS = {
    "f32": ("ei_scores", "hyperopt_tpu_torch/csrc/ei_scores.cu",
            "hyperopt_tpu/ops/pallas_gmm.py:38", {},
            dict(ei_impl="vpu", ei_precision="f32")),
    "bf16": ("ei_scores_bf16", "hyperopt_tpu_torch/csrc/ei_scores.cu",
             "hyperopt_tpu/ops/pallas_gmm.py:38 (bf16)", {"bf16": True},
             dict(ei_impl="vpu", ei_precision="bf16")),
    "mxu": ("ei_scores_mxu", "hyperopt_tpu_torch/csrc/ei_scores_mxu.cu",
            "hyperopt_tpu/ops/pallas_gmm.py:68", {"mxu": True},
            dict(ei_impl="mxu", ei_precision="f32")),
}
# H100 SXM peaks: 132 SMs x 16 special-function results per clock (exp)
# at the 1.98 GHz boost clock; 67 TFLOP/s float32 outside the tensor
# cores; 3.35 TB/s HBM3.
EXP_PER_S = 132 * 16 * 1.98e9
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
HBM_BYTES_PER_S = 3.35e12
# Float32 operations per (candidate, component) term besides its exp.
# f32: z - mu, * 1/sigma, fma for cb - t*t (2), - max, + sum.  bf16: the
# same plus two roundings to bf16 (2 each); its division is a multiply by
# a reciprocal folded once per component, so it adds nothing per term.
# mxu: the stepped update (max, - max, + sum); the term itself comes from
# the tensor cores.
FLOP_PER_TERM = {"f32": 6, "bf16": 10, "mxu": 3}
# Back-to-back calls inside one pair of CUDA events when a kernel is timed.
LAUNCHES_PER_WINDOW = 10
# device_mode: trials after the history (a), per stride run (b), per
# lowering run (c), per throughput run (d), and in its profiled segment.
DEVICE_MORE = 16
DEVICE_STRIDE_RUN = 256
DEVICE_LOWERING_RUN = 64
DEVICE_THROUGHPUT_RUN = 1000
DEVICE_PROFILED = 16
# fleet: lanes and trials per lane of each parity run (a), its stride; lane
# counts and trials per lane of the throughput runs (b); lane counts of the
# wrapper-timed kernels (c); experiments in the hosted cohort (d).
FLEET_LANES = 4
FLEET_PARITY_RUN = 64
FLEET_STRIDE = 16
FLEET_THROUGHPUT_LANES = (1, 8, 64)
FLEET_THROUGHPUT_RUN = 1000
FLEET_KERNEL_LANES = (8, 64)
COHORT = 8
# Kernel symbol of each lowering, as the profiler names it.
KERNEL_SYMBOLS = {"f32": "ei_scores_kernel<false>",
                  "bf16": "ei_scores_kernel<true>",
                  "mxu": "ei_scores_mxu_kernel"}
# The columns the objective sums: the flagship space's uniform ones.
U_LABELS = [f"u{i}" for i in range(10)]


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


def objective_f32(cfg):
    """:func:`objective` in float32, one rounding per operation."""
    acc = np.float32(0.0)
    for k in U_LABELS:
        v = np.float32(cfg[k])
        acc = acc + v * v
    return float(acc)


def make_objective_torch():
    """A new torch twin of :func:`objective_f32` for device mode (a new
    function object: device mode keys its captured graphs by it).  Each
    product is its own operation, rounded to float32 before it is added,
    so no multiply-add is fused and the host twin's bits come out."""

    def objective_torch(p):
        acc = p[U_LABELS[0]] * p[U_LABELS[0]]
        for k in U_LABELS[1:]:
            acc = acc + p[k] * p[k]
        return acc

    return objective_torch


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


def cuda_ms(fn, reps=25, warmup=3, inner=LAUNCHES_PER_WINDOW):
    """Median milliseconds per call of ``fn`` on the card: CUDA events
    around ``inner`` back-to-back calls, ``reps`` times, after warm-up.
    Back to back, the card runs one launch while the host prepares the
    next, so the host's time per call stays out of the number unless it
    is longer than the kernel's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
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


def compare(got, ref, what, tol):
    """Elementwise |got - ref| <= tol + tol*|ref|; argmax equal on every
    column whose winner leads by more than MARGIN.  Returns
    ``(max_abs_err, tol_used, near_tie_columns)``, ``tol_used`` being the
    largest |got - ref| / (tol + tol*|ref|) (at most 1)."""
    got, ref = got.double().cpu(), ref.double().cpu()
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        fail(f"{what}: non-finite scores")
    d = (got - ref).abs()
    if not bool((d <= tol + tol * ref.abs()).all()):
        fail(f"{what}: kernel and plain version differ by {d.max():.3g}")
    used = (d / (tol + tol * ref.abs())).max().item()
    top2 = torch.topk(ref, 2, dim=1).values if ref.shape[1] > 1 else None
    near = 0
    if top2 is not None:
        clear = (top2[:, 0] - top2[:, 1]) > MARGIN
        near = int((~clear).sum())
        if bool((got.argmax(1) != ref.argmax(1))[clear].any()):
            fail(f"{what}: argmax differs on a column with a clear winner")
    return d.max().item(), used, near


def ei_bound_ms(z, logw_b, logw_a, low):
    """Least time the card needs for one EI launch of lowering ``low`` on
    these inputs: the exps of the live (finite-weight) terms on the
    special-function units, the float32 arithmetic around them, the
    tensor-core work of the mxu form (one packed 3xTF32 m16n8k8 product
    per 16 x 8 tile that holds a live component), or the bytes moved,
    whichever is largest.  Returns ``(ms, "operations" | "bytes")``."""
    c, n = z.shape
    live = int(torch.isfinite(logw_b).sum() + torch.isfinite(logw_a).sum())
    terms = n * live
    op_s = max(terms / EXP_PER_S,
               terms * FLOP_PER_TERM[low] / F32_FLOP_PER_S)
    if low == "mxu":
        live_tiles = 0
        for w in (logw_b, logw_a):
            pad = torch.nn.functional.pad(torch.isfinite(w).int(),
                                          (0, -w.shape[1] % 8))
            live_tiles += int(pad.view(c, -1, 8).amax(dim=2).sum())
        tiles = -(-n // 16) * live_tiles
        op_s = max(op_s, tiles * 2 * 16 * 8 * 8 / TF32_FLOP_PER_S)
    nbytes = 4 * (2 * c * n + 3 * (logw_b.numel() + logw_a.numel()))
    byte_s = nbytes / HBM_BYTES_PER_S
    if op_s >= byte_s:
        return op_s * 1e3, "operations"
    return byte_s * 1e3, "bytes"


def phase_build():
    for name, (path, seconds) in ei_mod.build().items():
        print(f"build: {path.name} compiled in {seconds:.2f} s")
        for line in ei_mod.build_log.get(name, "").splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "entry function")):
                print(f"build: {name}: {line.strip()}")


def with_dead(mixture, n_dead, dev):
    """The mixture with ``n_dead`` more components of weight 0 whose
    sigma is 0 and mu NaN."""
    logw, mu, sg = mixture
    c = logw.shape[0]
    pad = [torch.full((c, n_dead), v, device=dev)
           for v in (-math.inf, math.nan, 0.0)]
    return [torch.cat([a, b], dim=1).contiguous()
            for a, b in zip((logw, mu, sg), pad)]


def scattered_dead(rng, c, k, dev, dead):
    """A mixture of ``k`` components whose dead ones (weight 0, sigma 0, NaN
    mu) are where the bool mask ``dead[k]`` says, the same in every
    column."""
    live = ~dead
    logw = np.full((c, k), -np.inf, np.float32)
    w = rng.random((c, int(live.sum()))) + 0.1
    logw[:, live] = np.log(w / w.sum(axis=1, keepdims=True))
    mu = np.where(live, rng.normal(0, 3, (c, k)), np.nan)
    sg = np.where(live, rng.uniform(0.3, 3, (c, k)), 0.0)
    return [torch.as_tensor(a.astype(np.float32), device=dev)
            for a in (logw, mu, sg)]


def scattered_masks():
    """Dead masks of the scattered-dead case, laid over chunks of 512
    staged components (the chunk of every kernel): below, 40 components,
    every sixth dead from the second, the last live; above, 2,600
    components: in chunk 0 every fifth dead from the third; chunk 1 all
    dead; chunk 2 dead but for its last component; chunk 3 dead in its
    first half and every seventh of its second; past 2,048 every other
    one dead, the last one too."""
    jb = np.arange(40)
    ja = np.arange(2600)
    dead_b = jb % 6 == 1
    dead_a = np.select(
        [ja < 512, ja < 1024, ja < 1536, ja < 2048],
        [ja % 5 == 2, True, ja != 1535, (ja < 1792) | (ja % 7 == 0)],
        ja % 2 == 1)
    return dead_b, dead_a


def phase_ei_kernel(dev):
    """Each lowering's kernel against its plain version.  Returns
    ``{lowering: {max_abs_err, ms, plain_ms, bound_ms, bound_by, ms_2048,
    bound_ms_2048}}``."""
    rng = np.random.default_rng(0)
    out = {low: {"max_abs_err": 0.0} for low in KERNELS}
    launches0 = ei_mod.ei_scores.launches
    # (name, C, n, K_b, K_a, live above); the live components lead.
    shapes = [("slice", 31, N_CAND, 26, 1025, 1022),
              ("b2048", 31, N_CAND, 26, 2049, 1030),
              ("edge", 3, 1000, 26, 1500, 1497),
              ("tiny", 1, 64, 2, 130, 127)]
    for name, c, n, kb, ka, live_a in shapes:
        below = random_mixture(rng, c, kb, kb - 1, dev)
        above = random_mixture(rng, c, ka, live_a, dev)
        z = torch.as_tensor(rng.normal(0, 3, (c, n)).astype(np.float32),
                            device=dev)
        for low, (_, _, _, kw, _) in KERNELS.items():
            got = ei_mod.ei_scores(z, *below, *above, **kw)
            torch.cuda.synchronize()
            ref = ei_mod.ei_scores_reference(z, *below, *above, **kw)
            err, used, near = compare(got, ref, f"ei_kernel {low} {name}",
                                      TOL[low])
            out[low]["max_abs_err"] = max(out[low]["max_abs_err"], err)
            print(f"ei_kernel {low} {name}: C={c} n={n} K_b={kb} K_a={ka} "
                  f"live_a={live_a} max_abs_err={err:.3g} tol={TOL[low]:g} "
                  f"tol_used={used:.3g} near_tie_columns={near}")
            if name not in ("slice", "b2048"):
                continue
            kernel_ms = cuda_ms(lambda: ei_mod.ei_scores(z, *below, *above,
                                                         **kw))
            bound_ms, bound_by = ei_bound_ms(z, below[0], above[0], low)
            if name == "b2048":
                print(f"ei_kernel {low} b2048: kernel_ms={kernel_ms:.4f} "
                      f"bound_ms={bound_ms:.4f} ({bound_by})")
                out[low].update(ms_2048=kernel_ms, bound_ms_2048=bound_ms)
                continue
            reference_ms = cuda_ms(
                lambda: ei_mod.ei_scores_reference(z, *below, *above, **kw))
            print(f"ei_kernel {low} slice: kernel_ms={kernel_ms:.4f} "
                  f"reference_ms={reference_ms:.4f} bound_ms={bound_ms:.4f} "
                  f"({bound_by})")
            out[low].update(ms=kernel_ms, plain_ms=reference_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
        if name == "edge":
            # Dead components with sigma 0 and NaN mu add exactly nothing:
            # kernel against plain version with them, and the plain
            # version with them against the plain version without.
            dead_b = with_dead(below, 4, dev)
            dead_a = with_dead(above, 7, dev)
            for low, (_, _, _, kw, _) in KERNELS.items():
                got = ei_mod.ei_scores(z, *dead_b, *dead_a, **kw)
                torch.cuda.synchronize()
                ref = ei_mod.ei_scores_reference(z, *dead_b, *dead_a, **kw)
                err, _, _ = compare(got, ref, f"ei_kernel {low} dead",
                                    TOL[low])
                clean = ei_mod.ei_scores_reference(z, *below, *above, **kw)
                err2, _, _ = compare(ref, clean, f"ei_kernel {low} dead "
                                     f"(plain version)", TOL[low])
                print(f"ei_kernel {low} dead: K_b={kb}+4 K_a={ka}+7 "
                      f"(sigma 0, mu NaN) max_abs_err={err:.3g}, plain "
                      f"version vs without them {err2:.3g}")
    # Dead components inside chunks, whole dead chunks between live ones
    # and a chunk whose only live component is its last: a kernel that
    # stops at a chunk's last live component must still add every one.
    dead_b, dead_a = scattered_masks()
    below = scattered_dead(rng, 3, dead_b.size, dev, dead_b)
    above = scattered_dead(rng, 3, dead_a.size, dev, dead_a)
    z = torch.as_tensor(rng.normal(0, 3, (3, 1000)).astype(np.float32),
                        device=dev)
    for low, (_, _, _, kw, _) in KERNELS.items():
        got = ei_mod.ei_scores(z, *below, *above, **kw)
        torch.cuda.synchronize()
        ref = ei_mod.ei_scores_reference(z, *below, *above, **kw)
        err, _, _ = compare(got, ref, f"ei_kernel {low} scattered_dead",
                            TOL[low])
        out[low]["max_abs_err"] = max(out[low]["max_abs_err"], err)
        print(f"ei_kernel {low} scattered_dead: K_b={dead_b.size} "
              f"({int((~dead_b).sum())} live) K_a={dead_a.size} "
              f"({int((~dead_a).sum())} live) max_abs_err={err:.3g}")
    # Far-tail candidates against narrow and wide components: finite, and
    # identical below/above mixtures score exactly 0.
    logw = torch.log(torch.tensor([[0.5, 0.5], [0.9, 0.1]], device=dev))
    mu = torch.tensor([[-50.0, 50.0], [0.0, 1e4]], device=dev)
    sg = torch.tensor([[1e-3, 1e3], [0.5, 10.0]], device=dev)
    z = torch.as_tensor(rng.uniform(-1e4, 1e4, (2, 256)).astype(np.float32),
                        device=dev)
    for low, (_, _, _, kw, _) in KERNELS.items():
        got = ei_mod.ei_scores(z, logw, mu, sg, logw, mu, sg, **kw)
        worst = got.abs().max().item()
        if not bool(torch.isfinite(got).all()) or worst != 0.0:
            fail(f"ei_kernel {low} extreme: scores of equal mixtures are "
                 f"not 0 (max |ei| = {worst:.3g})")
        print(f"ei_kernel {low} extreme: max |ei| = {worst:.3g}")
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
    steady_ms = float(np.median(times[1:]))
    print(f"suggest_step: P={domain.cs.n_params} history={N_HISTORY} "
          f"n_cand={N_CAND} first_ms={times[0]:.2f} "
          f"steady_ms_median={steady_ms:.2f}")
    hosted = profile_steps(lambda s: algo(tid, domain, trials, seed=100 + s))
    hosted["steady_ms"] = steady_ms

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
    return hosted


def profiled(fn):
    """Run ``fn()`` under ``torch.profiler`` and synchronize.  Returns
    ``(wall_ms, [(kernel name, launches, device ms)])`` for every CUDA
    kernel the profiler saw, replayed graphs' kernels included."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.count,
                (getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0)) / 1e3)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall_ms, kernels


def profile_steps(step, n=3, label="suggest_step"):
    """Where a step's time goes: ``torch.profiler`` over ``n`` steps;
    prints the device-busy share of the wall time, CUDA kernel launches
    per step, and the kernels with the most device time.  Returns
    ``{wall_ms, busy_ms, share, kernels}`` per step."""
    wall_ms, kernels = profiled(lambda: [step(s) for s in range(n)])
    busy = sum(ms for _, _, ms in kernels)
    launches = sum(count for _, count, _ in kernels)
    print(f"{label} profile: wall_ms_per_step={wall_ms / n:.3f} "
          f"device_busy_ms_per_step={busy / n:.3f} "
          f"device_busy_share={busy / wall_ms:.3f} "
          f"cuda_kernels_per_step={launches / n:.1f}")
    for key, count, ms in sorted(kernels, key=lambda k: -k[2])[:8]:
        print(f"{label} profile: {ms / n:8.4f} ms/step "
              f"{count / n:6.1f} launches/step  {key[:90]}")
    return {"wall_ms": wall_ms / n, "busy_ms": busy / n,
            "share": busy / wall_ms, "kernels": launches / n}


def phase_fmin(dev):
    space = flagship_space()
    cs = compile_space(space)
    trials = synthetic_trials(cs, N_HISTORY, 1, dev)
    ei_mod.reset_launches()
    t0 = time.perf_counter()
    ho.fmin(objective, space,
            algo=partial(tpe.suggest, n_EI_candidates=N_CAND),
            max_evals=N_HISTORY + N_MORE, trials=trials,
            rstate=np.random.default_rng(0), device=dev,
            show_progressbar=False)
    wall = time.perf_counter() - t0
    launches = ei_mod.ei_scores.launches
    if ei_mod.ei_scores.launches_by["f32"] != launches:
        fail(f"fmin: launches of other lowerings than f32: "
             f"{ei_mod.ei_scores.launches_by}")
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


def phase_liar_batch(dev):
    """Full-width hosted ``fmin`` with constant-liar batches, once per
    lowering.  Returns ``{lowering: launches of its kernel}``."""
    space = flagship_space()
    cs = compile_space(space)
    row_bytes = history._row_bytes(cs.n_params)
    launches = {}
    for low, (_, _, _, _, tpe_kw) in KERNELS.items():
        trials = synthetic_trials(cs, N_HISTORY, 2, dev)
        batch_ms, uploads, rows = [], [], []

        def algo(new_ids, domain, trials, seed, tpe_kw=tpe_kw):
            b0 = history.upload_bytes
            t0 = time.perf_counter()
            vals, act = tpe.suggest_batch(new_ids, domain, trials, seed,
                                          n_EI_candidates=N_CAND, **tpe_kw)
            batch_ms.append((time.perf_counter() - t0) * 1e3)
            uploads.append(history.upload_bytes - b0)
            rows.extend(vals)
            return base.docs_from_samples(domain.cs, new_ids, vals, act)

        ei_mod.reset_launches()
        t0 = time.perf_counter()
        ho.fmin(objective, space, algo=algo, max_evals=N_HISTORY + N_LIAR,
                max_queue_len=QUEUE, trials=trials,
                rstate=np.random.default_rng(3), device=dev,
                show_progressbar=False)
        wall = time.perf_counter() - t0
        by = dict(ei_mod.ei_scores.launches_by)
        if len(trials) != N_HISTORY + N_LIAR or len(rows) != N_LIAR:
            fail(f"liar_batch {low}: {len(trials)} trials, {len(rows)} "
                 f"proposals")
        for t in trials:
            if t["state"] != base.JOB_STATE_DONE or \
                    not math.isfinite(t["result"]["loss"]):
                fail(f"liar_batch {low}: trial {t['tid']} is not DONE with "
                     f"a finite loss")
        for row in rows:
            bad = in_bounds(cs, row)
            if bad:
                fail(f"liar_batch {low}: proposal outside the space: {bad}")
        want = {k: (N_LIAR if k == low else 0) for k in by}
        if by != want or ei_mod.ei_scores.launches != N_LIAR:
            fail(f"liar_batch {low}: launches {by}, wanted {want}")
        if len(batch_ms) != N_LIAR // QUEUE:
            fail(f"liar_batch {low}: {len(batch_ms)} batches")
        limit = QUEUE * row_bytes
        if any(u > limit for u in uploads[1:]):
            fail(f"liar_batch {low}: ring uploads {uploads} B per batch; "
                 f"after the first at most {limit}")
        launches[low] = by[low]
        if low == "f32":
            # Where a batch's time goes (outside the counted run): two
            # more batches of 8 on the grown history, profiled.
            domain = base.Domain(objective, space)
            domain.cs.device = dev
            tid = trials.new_trial_ids(QUEUE)
            profile_steps(lambda s: tpe.suggest_batch(
                tid, domain, trials, 100 + s, n_EI_candidates=N_CAND), n=2,
                label="liar_batch f32 (per batch of 8)")
        print(f"liar_batch {low}: {N_LIAR} trials in batches of {QUEUE}, "
              f"{wall:.3f} s = {N_LIAR / wall:.2f} trials/s, "
              f"median_batch_ms={np.median(batch_ms):.2f} "
              f"(batches: {', '.join(f'{b:.2f}' for b in batch_ms)}), "
              f"ring upload bytes per batch {uploads} "
              f"({row_bytes} B per row), launches {by}, best loss "
              f"{trials.best_trial['result']['loss']:.4g}")

    # The same small liar batch on the card and on the CPU, same uniforms.
    cs = compile_space(flagship_space(10))
    h = synthetic_trials(cs, 50, 1, "cpu").history(cs)
    hist = tpe._padded_history(h, 64)
    for low, (_, _, _, _, tpe_kw) in KERNELS.items():
        out = []
        noises = None
        for d in (torch.device("cpu"), dev):
            kern = tpe.get_kernel(cs, 64, 128, 25, device=d, **tpe_kw)
            if noises is None:
                gen = torch.Generator().manual_seed(0)
                noises = [kern.draw_noise(gen) for _ in range(4)]
            nz = [{"cont": [(a.to(d), b.to(d)) for a, b in nzi["cont"]],
                   "cat": nzi["cat"].to(d)} for nzi in noises]
            r, _ = kern.suggest_many(
                4, 50, *[torch.as_tensor(a, device=d) for a in hist], 0.25,
                1.0, noises=nz)
            out.append(r.cpu())
        if not torch.allclose(out[0], out[1], rtol=1e-5, atol=1e-5):
            fail(f"liar_batch {low}: card and CPU propose different rows:\n"
                 f"{out[1]}\n{out[0]}")
        print(f"liar_batch {low}: card and CPU rows agree on the small "
              f"batch (m=4)")
    return launches


def landed(trials, first):
    """``(tid, misc.vals, loss)`` of the trials from index ``first`` on."""
    return [(d["tid"], d["misc"]["vals"], d["result"]["loss"])
            for d in list(trials)[first:]]


def column_diffs(got, want):
    """How many trials differ, per column (and in the loss)."""
    diffs = {}
    for (_, gv, gl), (_, wv, wl) in zip(got, want):
        for k in sorted(set(gv) | set(wv)):
            if gv.get(k) != wv.get(k):
                diffs[k] = diffs.get(k, 0) + 1
        if gl != wl:
            diffs["loss"] = diffs.get("loss", 0) + 1
    return diffs


class Tally:
    """A phase's EI kernel counts per lowering, summed over its runs: eager
    launches, launches recorded into graphs, and replays of graphs that
    hold the kernel (one kernel run per replay, whatever the lanes)."""

    def __init__(self):
        self.launches = dict.fromkeys(KERNELS, 0)
        self.recorded = dict.fromkeys(KERNELS, 0)
        self.replayed = dict.fromkeys(KERNELS, 0)

    def counted(self, low, run):
        """``run()`` with the device counters and the wrapper's counts set
        to 0 just before it; adds what it launched, recorded into graphs
        and replayed (graphs of lowering ``low``) to the tallies."""
        device.reset_counters()
        ei_mod.reset_launches()
        try:
            return run()
        finally:
            for k in KERNELS:
                self.launches[k] += ei_mod.ei_scores.launches_by[k]
                self.recorded[k] += ei_mod.ei_scores.recorded_by[k]
            self.replayed[low] += device.replays

    def rows(self):
        return {k: (self.launches[k], self.recorded[k], self.replayed[k])
                for k in KERNELS}


def check_captures(what, low):
    """Each capture launches the picked kernel once per warm-up step and
    records it into the graph once; the other kernels not at all."""
    n = device.captures
    want = ({k: n * device._WARMUP_STEPS * (k == low) for k in KERNELS},
            {k: n * (k == low) for k in KERNELS})
    got = (ei_mod.ei_scores.launches_by, ei_mod.ei_scores.recorded_by)
    if got != want:
        fail(f"{what}: wrapper launches and records {got}, wanted {want} "
             f"for {n} captures")


def check_counters(what, **want):
    got = {k: getattr(device, k) for k in want}
    if got != want:
        fail(f"device_mode {what}: counters {got}, wanted {want}")


def kernel_counts(kernels):
    """Launches of each lowering's EI kernel in a profile."""
    return {low: sum(c for key, c, _ in kernels if sym in key)
            for low, sym in KERNEL_SYMBOLS.items()}


def device_fmin(obj, space, algo, trials, max_evals, stride, dev, seed):
    ho.fmin(obj, space, algo=algo, max_evals=max_evals, trials=trials,
            rstate=np.random.default_rng(seed), device=dev, mode="device",
            sync_stride=stride, show_progressbar=False)
    return trials


def load(seg, h, rows):
    """Load the first ``rows`` of history ``h`` into a device-mode segment,
    with room for ``DEVICE_PROFILED`` trials after them."""
    seg.load(h["vals"][:rows], h["active"][:rows], h["loss"][:rows],
             h["ok"][:rows], h["loss"][:rows], limit=rows + DEVICE_PROFILED)
    torch.cuda.synchronize()


def replay_seeds(seg, n=DEVICE_PROFILED):
    """Seeds for ``n`` replays of a segment: ``[n, lanes]``."""
    return np.arange(n * seg.n_lanes).reshape(n, seg.n_lanes)


def replay_ms(seg, h, rows):
    """``DEVICE_PROFILED`` replays after ``rows`` history rows (in every
    lane): the host's enqueue time and the card's time (CUDA events), ms
    per replay."""
    load(seg, h, rows)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    seg.run(replay_seeds(seg))
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    return (enqueue_ms / DEVICE_PROFILED,
            start.elapsed_time(end) / DEVICE_PROFILED)


def host_split_ms(seg, h, rows):
    """The host's own time for one replay, with the card idle when it
    starts (``replay_ms``'s enqueue time also holds the waits of a full
    launch queue): reseeding every generator of the segment (``2·lanes``
    ``manual_seed`` calls), then ``graph.replay()`` (with the
    generator-state fills of its prologue); ms, averaged over
    ``DEVICE_PROFILED`` replays."""
    load(seg, h, rows)
    seed_s = replay_s = 0.0
    for t in range(DEVICE_PROFILED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for g in seg.gens:
            g.manual_seed(t)
        t1 = time.perf_counter()
        seg.graph.replay()
        t2 = time.perf_counter()
        seed_s += t1 - t0
        replay_s += t2 - t1
    torch.cuda.synchronize()
    return (seed_s * 1e3 / DEVICE_PROFILED, replay_s * 1e3 / DEVICE_PROFILED)


def segment_of(cs, fn, n_cap, lanes=1):
    """The cached device-mode segment of objective ``fn`` at bucket
    ``n_cap`` with ``lanes`` lanes (built by an ``fmin(mode="device")``,
    ``fmin_device`` or ``fmin_fleet`` run)."""
    return next(seg for f, seg in cs._device_runs.values()
                if f is fn and seg.n_cap == n_cap and seg.n_lanes == lanes)


def phase_device_mode(dev, hosted):
    """``fmin(mode="device")`` at full width, checks (a) to (e).  Returns
    ``{lowering: (eager launches, launches recorded into graphs, replays
    of graphs that hold the kernel)}`` over its runs."""
    space = flagship_space()
    cs = compile_space(space)
    algo = partial(tpe.suggest, n_EI_candidates=N_CAND)
    history0 = synthetic_trials(cs, N_HISTORY, 1, dev)
    tally = Tally()
    counted = tally.counted

    def copy_history():
        return base.trials_from_docs(copy.deepcopy(list(history0)))

    def check_wrapper(what, low):
        check_captures(f"device_mode {what}", low)

    # (a) device against hosted, 16 trials after the 1,000-trial history,
    # both in the 1,024 bucket.
    n_total = N_HISTORY + DEVICE_MORE
    th = copy_history()
    t0 = time.perf_counter()
    ho.fmin(objective_f32, space, algo=algo, max_evals=n_total, trials=th,
            rstate=np.random.default_rng(4), device=dev,
            show_progressbar=False)
    hosted_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    td = counted("f32", lambda: device_fmin(
        make_objective_torch(), space, algo, copy_history(), n_total, 1,
        dev, 4))
    device_s = time.perf_counter() - t0
    check_counters("(a)", captures=1, replays=DEVICE_MORE, eager_steps=0,
                   fetch_syncs=DEVICE_MORE, trials_landed=DEVICE_MORE)
    check_wrapper("(a)", "f32")
    got, want = landed(td, N_HISTORY), landed(th, N_HISTORY)
    diffs = column_diffs(got, want)
    if len(got) != DEVICE_MORE or len(want) != DEVICE_MORE or diffs:
        fail(f"device_mode (a): device and hosted trials differ, trials "
             f"per column: {diffs}")
    print(f"device_mode (a): {DEVICE_MORE} trials after {N_HISTORY}, "
          f"sync_stride=1: identical to the hosted run (misc.vals and "
          f"losses); device {device_s:.3f} s (capture included), hosted "
          f"{hosted_s:.3f} s; best loss {td.best_trial['result']['loss']:.6g}")

    # (b) stride invariance: fresh runs, one capture each.
    runs = {}
    for stride in (1, 8, None):
        t0 = time.perf_counter()
        t = counted("f32", lambda: device_fmin(
            make_objective_torch(), space, algo, ho.Trials(),
            DEVICE_STRIDE_RUN, stride, dev, 5))
        wall = time.perf_counter() - t0
        fetches = -(-DEVICE_STRIDE_RUN // (stride or DEVICE_STRIDE_RUN))
        check_counters(f"(b) stride {stride}", captures=1,
                       replays=DEVICE_STRIDE_RUN, eager_steps=0,
                       fetch_syncs=fetches, segments=fetches)
        check_wrapper(f"(b) stride {stride}", "f32")
        runs[stride] = landed(t, 0)
        print(f"device_mode (b): stride {stride}: {DEVICE_STRIDE_RUN} "
              f"trials, {fetches} fetches, 1 capture, {wall:.3f} s")
    for stride in (8, None):
        diffs = column_diffs(runs[stride], runs[1])
        if diffs or len(runs[stride]) != DEVICE_STRIDE_RUN:
            fail(f"device_mode (b): stride {stride} differs from stride 1: "
                 f"{diffs}")
    print("device_mode (b): strides 1, 8 and None land identical trials")

    # (e) fmin_device: seed s lands fmin(mode="device")'s trials under
    # rstate default_rng(s); patience stops the replays on a flat loss.
    _, info = counted("f32", lambda: ho.fmin_device(
        make_objective_torch(), space, DEVICE_STRIDE_RUN, seed=5,
        n_EI_candidates=N_CAND, device=dev))
    want_losses = np.asarray([loss for _, _, loss in runs[None]], np.float32)
    if not np.array_equal(info["losses"], want_losses):
        fail("device_mode (e): fmin_device(seed=5) and fmin(mode='device', "
             "rstate=default_rng(5)) land different losses")
    check_counters("(e)", captures=1, replays=DEVICE_STRIDE_RUN,
                   fetch_syncs=1, eager_steps=0)
    check_wrapper("(e)", "f32")
    _, info = counted("f32", lambda: ho.fmin_device(
        lambda p: p["u0"] * 0.0 + 1.0, space, DEVICE_THROUGHPUT_RUN,
        seed=0, n_EI_candidates=N_CAND, patience=10, device=dev))
    ran = info["n_trials"]
    limit = ran + device._RUN_AHEAD + device._POLL_EVERY
    if ran != 20 + 10 or not np.isinf(info["losses"][ran:]).all() \
            or device.replays > limit or device.fetch_syncs != 1:
        fail(f"device_mode (e): patience run: n_trials {ran} (wanted 30), "
             f"{device.replays} replays (at most {limit}), "
             f"{device.fetch_syncs} fetches")
    check_wrapper("(e) patience", "f32")
    patience_replays = device.replays
    # An objective that reads a value back breaks the capture: it raises
    # with the contract, and nothing runs on eagerly.
    try:
        counted("f32", lambda: device_fmin(
            lambda p: p["u0"] * float(p["u0"].item()), space, algo,
            ho.Trials(), 32, None, dev, 9))
    except device.CaptureError as e:
        if "no .item()" not in str(e):
            fail(f"device_mode (e): CaptureError without the contract: {e}")
    else:
        fail("device_mode (e): an objective calling .item() was captured")
    check_counters("(e) failed capture", captures=0, replays=0,
                   eager_steps=0, trials_landed=0)
    print(f"device_mode (e): fmin_device(seed=5) lands (b)'s trials; "
          f"patience=10 on a flat loss stopped at {ran} trials after "
          f"{patience_replays} replays (the stop count polled every "
          f"{device._POLL_EVERY}, the host at most {device._RUN_AHEAD} "
          f"ahead), one fetch; an objective calling .item() "
          f"raises CaptureError naming the contract")

    # (c) each lowering inside a replayed graph, counted by the profiler.
    n_total = N_HISTORY + DEVICE_LOWERING_RUN
    for low, (name, _, _, _, tpe_kw) in KERNELS.items():
        algo_l = partial(tpe.suggest, n_EI_candidates=N_CAND, **tpe_kw)
        obj = make_objective_torch()
        counted(low, lambda: device_fmin(obj, space, algo_l, copy_history(),
                                         n_total, None, dev, 6))
        check_counters(f"(c) {low} capture run", captures=1,
                       replays=DEVICE_LOWERING_RUN, eager_steps=0)
        check_wrapper(f"(c) {low} capture run", low)
        wall_ms, kernels = counted(low, lambda: profiled(
            lambda: device_fmin(obj, space, algo_l, copy_history(), n_total,
                                None, dev, 7)))
        check_counters(f"(c) {low} replay run", captures=0,
                       run_cache_hits=1, replays=DEVICE_LOWERING_RUN,
                       eager_steps=0)
        check_wrapper(f"(c) {low} replay run", low)
        seen = kernel_counts(kernels)
        want = {k: (DEVICE_LOWERING_RUN if k == low else 0) for k in seen}
        if seen != want:
            top = sorted(kernels, key=lambda k: -k[2])[:6]
            fail(f"device_mode (c) {low}: the profiler counted {seen} EI "
                 f"kernel runs in {DEVICE_LOWERING_RUN} replays, wanted "
                 f"{want}; top kernels {[k[0][:60] for k in top]}")
        ms = sum(m for key, _, m in kernels if KERNEL_SYMBOLS[low] in key)
        print(f"device_mode (c) {low}: {name} ran {seen[low]} times in "
              f"{DEVICE_LOWERING_RUN} replays (the others 0), "
              f"{ms / max(seen[low], 1):.4f} ms per run by the profiler "
              f"(bucket {tpe._bucket(n_total)}); the wrapper launched it "
              f"{device._WARMUP_STEPS} times (warm-up) and recorded it once "
              f"in the capture run, neither in the replay run")

    # (d) throughput from an empty history: one graph for the four runs,
    # captured in the first.
    n = DEVICE_THROUGHPUT_RUN
    obj = make_objective_torch()
    runs = []
    rates = []
    for stride in (None, 8, 1, None):
        t0 = time.perf_counter()
        t = counted("f32", lambda: device_fmin(obj, space, algo, ho.Trials(),
                                               n, stride, dev, 8))
        wall = time.perf_counter() - t0
        fetches = -(-n // (stride or n))
        check_counters(f"(d) stride {stride}", captures=int(not runs),
                       replays=n, eager_steps=0, fetch_syncs=fetches)
        check_wrapper(f"(d) stride {stride}", "f32")
        note = " (capture included)" if not runs else (
            " again" if len(runs) == 3 else "")
        runs.append(t)
        rates.append((stride, n / wall))
        print(f"device_mode (d): stride {stride}{note}: {n} trials in "
              f"{wall:.3f} s = {n / wall:.1f} trials/s, "
              f"{wall / n * 1e3:.3f} ms per trial, best loss "
              f"{t.best_trial['result']['loss']:.6g}")
    for t in runs[1:]:
        diffs = column_diffs(landed(t, 0), landed(runs[0], 0))
        if diffs:
            fail(f"device_mode (d): strides land different trials: {diffs}")
    for d in runs[0]:
        if not math.isfinite(d["result"]["loss"]):
            fail(f"device_mode (d): trial {d['tid']} has a non-finite loss")
    h = runs[0].history(cs)
    for row, act in zip(h["vals"], h["active"]):
        # The history holds 0 for inactive parameters.
        bad = [lab for lab in in_bounds(cs, row)
               if act[cs.by_label[lab].pid]]
        if bad:
            fail(f"device_mode (d): proposal outside the space: {bad}")
    # The same objective at max_evals=32: a graph of the 32-row bucket.
    t0 = time.perf_counter()
    counted("f32", lambda: device_fmin(obj, space, algo, ho.Trials(), 32,
                                       None, dev, 8))
    wall = time.perf_counter() - t0
    check_counters("(d) 32 trials", captures=1, replays=32, eager_steps=0)
    check_wrapper("(d) 32 trials", "f32")
    print(f"device_mode (d): stride None, 32 trials (bucket 32, capture "
          f"included) in {wall:.3f} s")
    seg = segment_of(cs, obj, tpe._bucket(n))
    seg32 = segment_of(cs, obj, 32)
    # Replayed segments of 16 trials, timed on the card: after 1,000 rows
    # and after 16 in the 1,024 bucket, and after 16 in the 32 bucket
    # (the fixed bucket's cost); then after 1,000 under the profiler.
    for label, sg, rows in (("1,024 bucket, 1,000 rows", seg, n),
                            ("1,024 bucket, 16 rows", seg, DEVICE_PROFILED),
                            ("32 bucket, 16 rows", seg32, DEVICE_PROFILED)):
        enqueue_ms, card_ms = counted("f32", lambda: replay_ms(sg, h, rows))
        check_counters(f"(d) {label}", replays=DEVICE_PROFILED, captures=0)
        print(f"device_mode (d): replayed segment of {DEVICE_PROFILED} "
              f"trials, {label}: {card_ms:.3f} ms per trial on the card "
              f"(CUDA events), host enqueue {enqueue_ms:.3f} ms per trial")
    load(seg, h, n)
    wall_ms, kernels = counted("f32", lambda: profiled(
        lambda: seg.run(replay_seeds(seg))))
    check_counters("(d) profiled segment", replays=DEVICE_PROFILED,
                   captures=0)
    seen = kernel_counts(kernels)
    want = {k: (DEVICE_PROFILED if k == "f32" else 0) for k in seen}
    if seen != want:
        fail(f"device_mode (d): the profiler counted {seen} EI kernel runs "
             f"in {DEVICE_PROFILED} replays at bucket {seg.n_cap}, wanted "
             f"{want}")
    busy = sum(m for _, _, m in kernels)
    n_kernels = sum(c for _, c, _ in kernels)
    k1_ms = sum(m for key, _, m in kernels
                if KERNEL_SYMBOLS["f32"] in key) / DEVICE_PROFILED
    print(f"device_mode (d): profiled replayed segment of {DEVICE_PROFILED} "
          f"trials: wall_ms_per_trial={wall_ms / DEVICE_PROFILED:.3f} "
          f"device_busy_ms_per_trial={busy / DEVICE_PROFILED:.3f} "
          f"device_busy_share={busy / wall_ms:.3f} "
          f"cuda_kernels_per_trial={n_kernels / DEVICE_PROFILED:.1f} "
          f"K1_runs={seen['f32']} K1_ms_per_run={k1_ms:.4f}")
    for key, c, m in sorted(kernels, key=lambda k: -k[2])[:8]:
        print(f"device_mode (d) profile: {m / DEVICE_PROFILED:8.4f} ms/trial"
              f" {c / DEVICE_PROFILED:6.1f} runs/trial  {key[:90]}")
    for _, graph_seg in cs._device_runs.values():
        print(f"device_mode: graph of bucket {graph_seg.n_cap} "
              f"({graph_seg.kern.ei_impl}/{graph_seg.kern.ei_precision}): "
              f"its pool holds {graph_seg.pool_bytes} bytes")
    print(f"device_mode (d): hosted step in this run (suggest_step phase): "
          f"steady {hosted['steady_ms']:.3f} ms, profiled "
          f"{hosted['wall_ms']:.3f} ms wall, busy share "
          f"{hosted['share']:.3f}, {hosted['kernels']:.1f} kernels per step")
    print(f"device_mode: EI wrapper over the phase: eager launches "
          f"{tally.launches}, recorded into graphs {tally.recorded}, graph "
          f"replays {tally.replayed}")
    return tally.rows(), rates


def lane_infos_equal(a, b):
    """Whether two ``fmin_fleet`` lane infos hold the same trials."""
    return all(np.array_equal(a[k], b[k]) for k in ("losses", "vals",
                                                     "active"))


def phase_fleet(dev, solo_rates):
    """The fleet at full width, checks (a) to (d).  Returns ``(counts,
    kernel_times)``: ``{lowering: (eager launches, launches recorded into
    graphs, replays of graphs that hold the kernel)}`` over its runs, and
    ``{lowering: {lanes: (ms, bound_ms)}}`` of the wrapper-timed kernels at
    ``31·lanes`` columns."""
    space = flagship_space()
    cs = compile_space(space)
    tally = Tally()
    counted = tally.counted

    # (a) lane parity, per lowering: fmin_fleet against solo
    # fmin(mode="device") runs and fmin_device(n_runs) against solo
    # fmin_device runs (bucket 64).
    n, lanes, stride = FLEET_PARITY_RUN, FLEET_LANES, FLEET_STRIDE
    for low, (name, _, _, _, tpe_kw) in KERNELS.items():
        kw = dict(n_EI_candidates=N_CAND, **tpe_kw)
        obj = make_objective_torch()
        tl = [ho.Trials() for _ in range(lanes)]
        infos = counted(low, lambda: fleet.fmin_fleet(
            obj, cs, lanes, n, seed=21, sync_stride=stride, trials_list=tl,
            device=dev, **kw))
        check_counters(f"(a) {low} fmin_fleet", captures=1, replays=n,
                       eager_steps=0, fetch_syncs=n // stride,
                       trials_landed=lanes * n)
        check_captures(f"fleet (a) {low} fmin_fleet", low)
        for j in range(lanes):
            t = counted(low, lambda: device_fmin(
                obj, space, partial(tpe.suggest, **kw), ho.Trials(), n,
                stride, dev, 21 + j))
            if device.eager_steps:
                fail(f"fleet (a) {low}: a solo run stepped eagerly")
            diffs = column_diffs(landed(tl[j], 0), landed(t, 0))
            solo_losses = np.asarray([d["result"]["loss"] for d in t],
                                     np.float32)
            if diffs or len(t) != n or len(tl[j]) != n \
                    or not np.array_equal(infos[j]["losses"], solo_losses):
                fail(f"fleet (a) {low}: lane {j} differs from the solo "
                     f"device run under seed {21 + j}: {diffs}")
        _, info = counted(low, lambda: ho.fmin_device(
            obj, cs, n, seed=31, n_runs=lanes, device=dev, **kw))
        check_counters(f"(a) {low} fmin_device(n_runs)", captures=0,
                       run_cache_hits=1, replays=n, eager_steps=0,
                       fetch_syncs=1)
        for j in range(lanes):
            _, solo = counted(low, lambda: ho.fmin_device(
                obj, cs, n, seed=31 + j, device=dev, **kw))
            for k in ("losses", "vals", "active"):
                if not np.array_equal(info[k][j], solo[k]):
                    fail(f"fleet (a) {low}: fmin_device(n_runs={lanes}) run "
                         f"{j} differs from fmin_device(seed={31 + j}) in "
                         f"{k}")
        print(f"fleet (a) {low}: fmin_fleet({lanes} lanes, {n} trials, "
              f"sync_stride={stride}) lands each lane's misc.vals and losses "
              f"bit for bit as the solo fmin(mode='device') run under seed "
              f"21 + j, one capture, {n // stride} fetches; "
              f"fmin_device(n_runs={lanes}) run j equals fmin_device(seed="
              f"31 + j); best losses "
              f"{[round(i['best_loss'], 4) for i in infos]}")

    # (b) throughput from empty histories, stride None, and (c) the
    # kernels inside the lane graphs: every lowering's kernel once per
    # replay at every lane count, by the profiler.
    h = synthetic_trials(cs, N_HISTORY, 1, dev).history(cs)
    obj = make_objective_torch()
    n = FLEET_THROUGHPUT_RUN
    first = {}
    for lanes in FLEET_THROUGHPUT_LANES:
        rates = []
        for rep in range(2):
            t0 = time.perf_counter()
            infos = counted("f32", lambda: fleet.fmin_fleet(
                obj, cs, lanes, n, seed=40, device=dev,
                n_EI_candidates=N_CAND))
            wall = time.perf_counter() - t0
            check_counters(f"(b) {lanes} lanes", captures=int(rep == 0),
                           replays=n, eager_steps=0, fetch_syncs=1)
            check_captures(f"fleet (b) {lanes} lanes", "f32")
            rates.append(lanes * n / wall)
        for j, info in enumerate(infos):
            if not np.isfinite(info["losses"]).all():
                fail(f"fleet (b): {lanes} lanes: lane {j} has a non-finite "
                     f"loss")
        for j, info in first.items():
            if j < lanes and not lane_infos_equal(info, infos[j]):
                fail(f"fleet (b): lane {j} of {lanes} lanes differs from "
                     f"lane {j} of a smaller fleet")
        first.update({j: infos[j] for j in (0, lanes - 1)})
        seg = segment_of(cs, obj, tpe._bucket(n), lanes)
        enqueue_ms, card_ms = counted("f32", lambda: replay_ms(seg, h, n))
        seed_ms, bare_ms = host_split_ms(seg, h, n)
        print(f"fleet (b): {lanes} lanes x {n} trials, stride None: "
              f"{rates[0]:.1f} trials/s summed over lanes (capture "
              f"included), {rates[1]:.1f} again; replayed segment of "
              f"{DEVICE_PROFILED} after {n} rows: {card_ms:.3f} ms per "
              f"replay on the card (CUDA events), host enqueue "
              f"{enqueue_ms:.3f} ms per replay; one replay alone on the "
              f"host: reseeding {seed_ms:.3f} ms, graph.replay() "
              f"{bare_ms:.3f} ms; pool {seg.pool_bytes} bytes")
    print(f"fleet (b): the solo device-mode runs of this process "
          f"(device_mode (d), 1,000 trials): "
          + ", ".join(f"stride {st} {r:.1f} trials/s" for st, r in solo_rates))
    for low, (name, _, _, _, tpe_kw) in KERNELS.items():
        for lanes in FLEET_THROUGHPUT_LANES:
            if low == "f32":
                seg = segment_of(cs, obj, tpe._bucket(n), lanes)
            else:
                seg = counted(low, lambda: device._segment_for(
                    obj, cs, n, dev, tpe._default_n_startup_jobs, N_CAND,
                    tpe._default_gamma, tpe._default_prior_weight,
                    tpe._default_linear_forgetting, "sqrt", "sqrt",
                    tpe_kw["ei_impl"], tpe_kw["ei_precision"], 0,
                    n_lanes=lanes))
                check_captures(f"fleet (c) {low} {lanes} lanes", low)
            load(seg, h, n)
            wall_ms, kernels = counted(low, lambda: profiled(
                lambda: seg.run(replay_seeds(seg))))
            check_counters(f"(c) {low} {lanes} lanes",
                           replays=DEVICE_PROFILED, captures=0)
            seen = kernel_counts(kernels)
            want = {k: DEVICE_PROFILED * (k == low) for k in seen}
            if seen != want:
                fail(f"fleet (c): {lanes} lanes, {low}: the profiler counted "
                     f"{seen} EI kernel runs in {DEVICE_PROFILED} replays, "
                     f"wanted {want}")
            busy = sum(m for _, _, m in kernels)
            n_kernels = sum(c for _, c, _ in kernels)
            k_ms = sum(m for key, _, m in kernels
                       if KERNEL_SYMBOLS[low] in key) / DEVICE_PROFILED
            print(f"fleet (c) {low}: {lanes} lanes, profiled replayed "
                  f"segment of {DEVICE_PROFILED}: "
                  f"wall_ms_per_replay={wall_ms / DEVICE_PROFILED:.3f} "
                  f"device_busy_ms_per_replay={busy / DEVICE_PROFILED:.3f} "
                  f"device_busy_share={busy / wall_ms:.3f} "
                  f"cuda_kernels_per_replay={n_kernels / DEVICE_PROFILED:.1f}"
                  f" {name}_runs={seen[low]} {name}_ms_per_run={k_ms:.4f} "
                  f"pool {seg.pool_bytes} bytes")
            if low == "f32" and lanes == FLEET_THROUGHPUT_LANES[-1]:
                for key, c, m in sorted(kernels, key=lambda k: -k[2])[:8]:
                    print(f"fleet (c) profile, {lanes} lanes: "
                          f"{m / DEVICE_PROFILED:8.4f} ms/replay "
                          f"{c / DEVICE_PROFILED:6.1f} runs/replay  "
                          f"{key[:80]}")

    # (c) the kernels through the wrapper at 31·L columns.
    rng = np.random.default_rng(5)
    kernel_times = {low: {} for low in KERNELS}
    for lanes in FLEET_KERNEL_LANES:
        c = 31 * lanes
        below = random_mixture(rng, c, 26, 25, dev)
        above = random_mixture(rng, c, 1025, 1022, dev)
        z = torch.as_tensor(rng.normal(0, 3, (c, N_CAND)).astype(np.float32),
                            device=dev)
        for low, (name, _, _, kw, _) in KERNELS.items():
            got = ei_mod.ei_scores(z, *below, *above, **kw)
            for sl in (slice(0, 31), slice(c - 31, c)):
                ref = ei_mod.ei_scores_reference(
                    z[sl], *(t[sl] for t in below + above), **kw)
                compare(got[sl], ref, f"fleet (c) {low} {c} columns",
                        TOL[low])
            ms = cuda_ms(lambda: ei_mod.ei_scores(z, *below, *above, **kw),
                         reps=10)
            bound, bound_by = ei_bound_ms(z, below[0], above[0], low)
            kernel_times[low][lanes] = (ms, bound)
            print(f"fleet (c) {low}: {name} at [{c}, {N_CAND}] ({lanes} "
                  f"lanes): {ms:.4f} ms, {ms / c * 1e3:.3f} us per column, "
                  f"bound {bound:.4f} ms ({bound_by}), {ms / bound:.2f}x "
                  f"the bound")

    # (d) the hosted cohort: 8 experiments, one dispatch, one launch.
    domain = base.Domain(objective, space)
    domain.cs.device = dev
    exps = [synthetic_trials(cs, 200 + 7 * j, 50 + j, dev)
            for j in range(COHORT)]
    seeds = [900 + 13 * j for j in range(COHORT)]
    ids = [t.new_trial_ids(1) for t in exps]
    for low, (name, _, _, _, tpe_kw) in KERNELS.items():
        kw = dict(n_EI_candidates=N_CAND, **tpe_kw)
        want = [tpe.suggest(ids[j], domain, exps[j], seeds[j], **kw)
                for j in range(COHORT)]
        sched = fleet.CohortScheduler(**kw)
        fleet.reset_counters()
        handles = counted(low, lambda: sched.suggest_dispatch(
            [(ids[j], domain, exps[j], seeds[j]) for j in range(COHORT)]))
        by = dict(ei_mod.ei_scores.launches_by)
        if by != {k: int(k == low) for k in by} or fleet.dispatches != 1:
            fail(f"fleet (d) {low}: {fleet.dispatches} cohort dispatches, "
                 f"EI launches {by}; wanted one of {name}")
        got = [fleet.suggest_materialize(hd) for hd in handles]
        for j in range(COHORT):
            if got[j][0]["misc"]["vals"] != want[j][0]["misc"]["vals"]:
                fail(f"fleet (d) {low}: experiment {j}'s cohort row differs "
                     f"from its solo tpe.suggest")
        print(f"fleet (d) {low}: a CohortScheduler served {COHORT} "
              f"experiments (histories of 200-249 trials, bucket 256) in "
              f"one dispatch with one launch of {name} (tier "
              f"{fleet.cohort_tier_last}); each row equals its solo "
              f"tpe.suggest")
    print(f"fleet: EI wrapper over the phase: eager launches "
          f"{tally.launches}, recorded into graphs {tally.recorded}, graph "
          f"replays {tally.replayed}")
    return tally.rows(), kernel_times


def phase_card_tests():
    """``python -m pytest tests_torch_cuda`` in a subprocess: it must exit
    0 with every collected test passed."""
    root = os.path.dirname(os.path.abspath(__file__))
    xml = os.path.join(root, "build", "tests_torch_cuda.xml")
    os.makedirs(os.path.dirname(xml), exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests_torch_cuda", "-q",
         "-p", "no:cacheprovider", f"--junitxml={xml}"],
        cwd=root, capture_output=True, text=True, timeout=600)
    suite = ElementTree.parse(xml).getroot()
    if suite.tag != "testsuite":
        suite = suite.find("testsuite")
    tests, failures, errors, skipped = (int(suite.get(k)) for k in (
        "tests", "failures", "errors", "skipped"))
    passed = tests - failures - errors - skipped
    if proc.returncode != 0 or tests == 0 or passed < tests:
        fail(f"card_tests: pytest exited {proc.returncode}, {passed} of "
             f"{tests} passed:\n{proc.stdout[-4000:]}\n{proc.stderr[-2000:]}")
    print(f"card_tests: python -m pytest tests_torch_cuda: {passed} of "
          f"{tests} passed in {time.perf_counter() - t0:.1f} s")


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
    kernels = phase_ei_kernel(dev)
    hosted = phase_suggest_step(dev)
    fmin_launches = phase_fmin(dev)
    liar_launches = phase_liar_batch(dev)
    device_launches, solo_rates = phase_device_mode(dev, hosted)
    fleet_launches, fleet_times = phase_fleet(dev, solo_rates)
    phase_card_tests()
    print(f"total seconds {time.perf_counter() - t0:.1f}")
    rows = []
    for low, (name, source, replaces, _, _) in KERNELS.items():
        # Launches on the main paths, each counted from zero just before
        # its run: the fmin phase (f32), this lowering's liar_batch run,
        # device_mode's and the fleet's eager warm-up steps and the fleet's
        # cohort dispatch.  A capture records the launch into its graph
        # without running it (graph_recorded); graph_replays counts replays
        # of graphs that hold the kernel, one kernel run each (for all
        # lanes) by the profiler's count in device_mode (c), (d) and fleet
        # (c).  fleet_ms: the kernel through its wrapper at 31·L columns.
        dev_launches, dev_recorded, dev_replays = (
            a + b for a, b in zip(device_launches[low], fleet_launches[low]))
        n = (liar_launches[low] + (fmin_launches if low == "f32" else 0)
             + dev_launches)
        k = kernels[low]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": n,
                     "graph_recorded": dev_recorded,
                     "graph_replays": dev_replays,
                     "fleet_ms": {f"31x{lanes}": ms for lanes, (ms, _)
                                  in fleet_times[low].items()},
                     "fleet_bound_ms": {f"31x{lanes}": b for lanes, (_, b)
                                        in fleet_times[low].items()},
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": None,
                     "ms_2048": k["ms_2048"],
                     "bound_ms_2048": k["bound_ms_2048"],
                     "launches_per_window": LAUNCHES_PER_WINDOW})
    print("kernels: " + ", ".join(r["name"] for r in rows))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
